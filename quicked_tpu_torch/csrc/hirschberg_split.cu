// Hirschberg split epilogue: the midpoint of each task from its forward and
// reverse half-pass band states.
//
// Replaces the XLA programs quicked_tpu/ops/hirschberg_split_jax.py:
// hirschberg_split_batch / hsplit_epilogue_interleaved /
// hsplit_epilogue_tiled (the device twin of
// myers_np.hirschberg_split_fast, i.e. the reference's
// hirschberg_compute_score_row and split search, bpm_hirschberg.c:149-200).
// Per task: (pattern_len_left, score_l, score_r, feasible).
//
// Input: the score fill's outputs in place on the card, for a batch whose
// lanes interleave the halves (lane 2j the forward pass of task j, lane
// 2j+1 the reverse one): scores (K+1, 2n), Pv/Mv (EBB, 2n), first/last.
//
// Design: one CTA per task. The NC = EBB*64 + 64 cells of each half are
// walked in chunks of blockDim: each thread reads one cell's Pv/Mv bit
// (+1/-1 step; words outside the band read as reset, Pv=1 Mv=0), a
// block-wide inclusive scan (warp shuffles, then the warp sums through
// shared memory) gives the running score, and the two running scores go
// to a per-task scratch row in device memory. A second pass forms
// joint[i] = csr[n_cells-1-i] + cs[i] and keeps the first minimum by a
// block-wide (value, index) reduction; one thread then reads the score
// rows and writes the four results. Rows outside the score window use the
// init formula (row+1)*64, as the XLA version does.
//
// What bounds it on the H100: ~2*NC cells of scan and reduction per task,
// a few microseconds; it replaces a device-to-host copy of the band planes
// (16*EBB bytes per lane) and a host loop over the tasks.

#include <climits>

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr int THREADS = 256;
constexpr int MASKED = 1 << 30;    // joint value past n_cells

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// +1/-1 score step of cell idx of a band: bit idx%64 of word idx/64
__device__ __forceinline__ int cell_step(const uint64_t* __restrict__ pv,
                                         const uint64_t* __restrict__ mv,
                                         int lane, int B2, int EBB, int idx) {
  const int blk = idx >> 6, cell = idx & 63;
  if (blk < 0 || blk >= EBB) return 1;
  const size_t at = (size_t)blk * B2 + lane;
  return (int)((pv[at] >> cell) & 1ull) - (int)((mv[at] >> cell) & 1ull);
}

// block-wide inclusive sum of x; returns it and the block total
__device__ __forceinline__ int block_scan(int x, int* warp_sum, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < warp) before += warp_sum[w];
    total += warp_sum[w];
  }
  __syncthreads();
  return x + before;
}

__global__ void __launch_bounds__(THREADS) hsplit_kernel(
    const int32_t* __restrict__ scores,   // (K1, 2n)
    const uint64_t* __restrict__ pv,      // (EBB, 2n)
    const uint64_t* __restrict__ mv,
    const int32_t* __restrict__ first, const int32_t* __restrict__ last,
    const int32_t* __restrict__ prolog,   // (n,) of the forward lanes
    const int32_t* __restrict__ plen, const int32_t* __restrict__ tlen,
    int32_t* __restrict__ scratch,        // (n, 2, NC+1)
    int32_t* __restrict__ pll_out, int32_t* __restrict__ score_l_out,
    int32_t* __restrict__ score_r_out, int32_t* __restrict__ feasible_out,
    int n, int EBB, int K1) {
  __shared__ int warp_sum[2][THREADS / 32];
  __shared__ int best_v[THREADS / 32], best_i[THREADS / 32];
  const int task = blockIdx.x, tid = threadIdx.x;
  const int B2 = 2 * n, lf = 2 * task, lr = 2 * task + 1;
  const int NC = EBB * W + W;
  const int pro = prolog[task], pl = plen[task], tl = tlen[task];
  const int f_first = first[lf], f_last = last[lf];
  const int r_first = first[lr], r_last = last[lr];

  const int text_mid = (tl + 1) / 2, text_mid_r = tl - text_mid;
  const int fb = text_mid < pro * W ? 0 : text_mid / W - pro;
  const int fb_r = text_mid_r < pro * W ? 0 : text_mid_r / W - pro;
  const int bottom_pos = f_first * W + 63 + fb * W;
  const int bottom_pos_r = (pl - 1) - (r_last * W + 63 + fb_r * W);
  const int higher_pos = f_last * W + 63 + fb * W;
  const int higher_pos_r = (pl - 1) - (r_first * W + 63 + fb_r * W);
  const bool feasible =
      !((bottom_pos > higher_pos_r) || (bottom_pos_r > higher_pos));
  const bool use_f_bottom = bottom_pos > bottom_pos_r;
  const int bottom_cell =
      use_f_bottom ? f_first * W + 63 : bottom_pos_r - fb * W;
  const int starting_pos = use_f_bottom ? bottom_pos : bottom_pos_r;
  const bool use_f_high = higher_pos < higher_pos_r;
  const int higher_cell =
      use_f_high ? f_last * W + 63 : higher_pos_r - fb * W;
  const int higher_cell_r =
      use_f_high ? (pl - 1) - higher_pos - fb_r * W : r_first * W + 63;
  const int n_cells = higher_cell - bottom_cell + 2;

  // pass 1: running scores of both halves
  int32_t* cs = scratch + (size_t)task * 2 * (NC + 1);
  int32_t* csr = cs + NC + 1;
  if (tid == 0) {
    cs[0] = 0;
    csr[0] = 0;
  }
  int carry_f = 0, carry_r = 0;
  for (int c0 = 0; c0 < NC; c0 += THREADS) {
    const int i = c0 + tid;
    const int sf = i < NC ? cell_step(pv, mv, lf, B2, EBB, bottom_cell + i)
                          : 0;
    const int sr = i < NC ? cell_step(pv, mv, lr, B2, EBB, higher_cell_r + i)
                          : 0;
    int tot_f, tot_r;
    const int inc_f = block_scan(sf, warp_sum[0], tot_f);
    const int inc_r = block_scan(sr, warp_sum[1], tot_r);
    if (i < NC) {
      cs[i + 1] = carry_f + inc_f;
      csr[i + 1] = carry_r + inc_r;
    }
    carry_f += tot_f;
    carry_r += tot_r;
  }
  __syncthreads();

  // pass 2: first argmin of joint[i] = csr[n_cells-1-i] + cs[i]
  int bv = INT_MAX, bi = INT_MAX;
  for (int i = tid; i < NC; i += THREADS) {
    int v = MASKED;
    if (i < n_cells)
      v = csr[min(max(n_cells - 1 - i, 0), NC)] + cs[i];
    if (v < bv) {          // i grows per thread: the first one wins ties
      bv = v;
      bi = i;
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, bv, d);
    const int oi = __shfl_down_sync(0xffffffffu, bi, d);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((tid & 31) == 0) {
    best_v[tid >> 5] = bv;
    best_i[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < THREADS / 32; ++w) {
    if (best_v[w] < bv || (best_v[w] == bv && best_i[w] < bi)) {
      bv = best_v[w];
      bi = best_i[w];
    }
  }
  const int smaller_pos = bi;
  const int pll = starting_pos + smaller_pos;
  auto cs_at = [&](const int32_t* a, int idx) {
    return a[min(max(min(max(idx, 0), n_cells), 0), NC)];
  };
  auto score_row = [&](int lane, int row) {
    const int r = row + pro;
    if (r >= 0 && r < K1) return scores[(size_t)r * B2 + lane];
    return (row + 1) * W;
  };
  const int block_ref =
      floordiv(pll + W - 1, W) - (n_cells < smaller_pos + W ? 1 : 0);
  const int score_pos_l = block_ref * W - (bottom_cell + fb * W);
  const int score_l = cs_at(cs, smaller_pos) - cs_at(cs, score_pos_l) +
                      score_row(lf, block_ref - 1);
  const int plr = pl - pll;
  const int block_ref_r =
      floordiv(plr + W - 1, W) - (smaller_pos < W ? 1 : 0);
  const int score_pos_r = block_ref_r * W - (higher_cell_r + fb_r * W);
  const int score_r = cs_at(csr, n_cells - 1 - smaller_pos) -
                      cs_at(csr, score_pos_r) + score_row(lr, block_ref_r - 1);
  pll_out[task] = pll;
  score_l_out[task] = score_l;
  score_r_out[task] = score_r;
  feasible_out[task] = feasible ? 1 : 0;
}

}  // namespace

extern "C" int qtt_hirschberg_split(const void* scores, const void* pv,
                                    const void* mv, const void* first,
                                    const void* last, const void* prolog,
                                    const void* plen, const void* tlen,
                                    void* scratch, void* pll, void* score_l,
                                    void* score_r, void* feasible, int n,
                                    int EBB, int K1, void* stream) {
  if (n <= 0) return 0;
  hsplit_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)scores, (const uint64_t*)pv, (const uint64_t*)mv,
      (const int32_t*)first, (const int32_t*)last, (const int32_t*)prolog,
      (const int32_t*)plen, (const int32_t*)tlen, (int32_t*)scratch,
      (int32_t*)pll, (int32_t*)score_l, (int32_t*)score_r,
      (int32_t*)feasible, n, EBB, K1);
  return (int)cudaGetLastError();
}
