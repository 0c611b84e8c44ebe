// Hirschberg split epilogue: the midpoint of each task from its forward and
// reverse half-pass band states.
//
// Replaces the XLA programs quicked_tpu/ops/hirschberg_split_jax.py:
// hirschberg_split_batch / hsplit_epilogue_interleaved /
// hsplit_epilogue_tiled (the device twin of
// myers_np.hirschberg_split_fast, i.e. the reference's
// hirschberg_compute_score_row and split search, bpm_hirschberg.c:149-200).
// Per task: (pattern_len_left, score_l, score_r, feasible); an infeasible
// task's three split values are 0.
//
// Input: a score pass's outputs in place on the card, for a batch whose
// lanes interleave the halves (lane 2j the forward pass of task j, lane
// 2j+1 the reverse one): scores (K+1, 2n), Pv/Mv (EBB, 2n), first/last.
//
// The function. cs[i] is the running score of the forward band from cell
// bottom_cell over i cells (a cell steps +1 where Pv is set, -1 where Mv
// is, +1 outside the band's words), csr[k] that of the reverse band from
// higher_cell_r; the midpoint is the first argmin over i < n_cells of
// joint[i] = csr[n_cells-1-i] + cs[i]. With G(m) the sum of the reverse
// steps over the m cells walked DOWN from R0 = higher_cell_r + n_cells - 1,
// csr[n_cells-1-i] = csr[n_cells] - G(i+1), so the argmin is that of
// cs[i] - G(i+1): a forward walk up from bottom_cell and a reverse walk down
// from R0, in step. Every value the split reads lies in blocks
// [first, last] of its half (cs over cells bottom_cell..higher_cell, csr
// over higher_cell_r..R0), so the deep-band kernels' contract (pv/mv exact
// on [first, last] only) is enough.
//
// What bounds it on the H100: nothing but latency. Per task it reads the
// words of both spans (about 2 * 16 * n_cells / 64 bytes, at most
// 32 * (EBB + 1)) and does ~1k operations a word; a level of 200 tasks at
// EBB 244 is at most ~1.6 MB and ~5e7 operations, microseconds either way.
//
// Design (a CTA a task walking NC = EBB*64 + 64 cells a half whatever the
// task's span, one cell a thread, with block-wide scans and the running
// sums in a device-memory scratch, spent its time on cells no task reads):
// - A warp walks a task's span only, one forward band word a lane, 32
//   words a chunk. The lane's reverse word is the 64 reverse cells the
//   reverse walk meets beside the lane's forward cells: two neighbouring
//   words of the reverse lane, bit-reversed and funnel-shifted into line.
// - Each lane sums its word's steps (masked popcounts, forward minus
//   reverse), a warp scan gives every lane the walk's value at its word's
//   first cell, and the lane walks its 64 cells in registers, keeping the
//   first minimum as a key (value << 32 | index): the smaller key is the
//   smaller value, then the lower index. A warp shuffle reduction keeps the
//   least key. No running sum leaves the registers.
// - Deep spans split into `wpt` warps a task (contiguous chunk ranges, each
//   warp's values relative to its start); one lane adds the warps' totals
//   in order and keeps the least key. Tasks pack `tpc` to a CTA; the
//   wrapper picks both so a level spreads over the SMs.
// - The two scores are differences of running sums within ~64 cells of the
//   midpoint: one lane reads those few words again (L1/L2-hot) and sums
//   them with masked popcounts.
// Loads are direct: a task's words are 16 * n bytes apart (lane-minor
// planes), but a level reads at most a few MB in all, once, and the time
// is the walk's latency and the launch, not bytes.

#include <climits>

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;          // warps a CTA
constexpr long long NO_KEY = LLONG_MAX;

struct HsplitArgs {
  const int32_t* scores;               // (K1, 2n)
  const uint64_t *pv, *mv;             // (EBB, 2n)
  const int32_t *first, *last;         // (2n,)
  const int32_t *prolog, *plen, *tlen; // (n,), prolog of the forward lanes
  int32_t *pll_out, *score_l_out, *score_r_out, *feasible_out;   // (n,)
  int n, EBB, K1, wpt;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Bits lo..hi of a word (0 <= lo, hi <= 63); 0 if hi < lo.
__device__ __forceinline__ uint64_t bits(int lo, int hi) {
  return hi < lo ? 0ull : qtt::mask_le(hi) & ~((1ull << lo) - 1ull);
}

// Word `blk` of a band lane; a block outside the band steps +1 (Pv set,
// Mv clear), as the reset value the XLA version reads there.
__device__ __forceinline__ uint64_t word(const uint64_t* __restrict__ p,
                                         bool is_pv, int lane, int B2,
                                         int EBB, int blk) {
  if (blk < 0 || blk >= EBB) return is_pv ? qtt::ONES : 0ull;
  return __ldg(p + (size_t)blk * B2 + lane);
}

// Bit p: cell top - p, where top = 64 * (block of `hi`) + u and `lo` is the
// word below `hi`.
__device__ __forceinline__ uint64_t mirrored(uint64_t hi, uint64_t lo,
                                             int u) {
  const uint64_t h = __brevll(hi);
  return u == 63 ? h : (h >> (63 - u)) | (__brevll(lo) << (u + 1));
}

// The sum of the steps of cells [c_lo, c_hi) of a band lane.
__device__ int range_sum(const HsplitArgs& a, int lane, int c_lo, int c_hi) {
  const int B2 = 2 * a.n;
  int s = 0;
  for (int c = c_lo; c < c_hi;) {
    const int blk = c >> 6;              // floor, also below 0
    const int end = min(c_hi, (blk + 1) * W);
    const uint64_t m = bits(c & 63, end - 1 - blk * W);
    s += __popcll(word(a.pv, true, lane, B2, a.EBB, blk) & m) -
         __popcll(word(a.mv, false, lane, B2, a.EBB, blk) & m);
    c = end;
  }
  return s;
}

// cs[x] - cs[y] of the running sum that starts at cell `base`.
__device__ int cs_diff(const HsplitArgs& a, int lane, int base, int x,
                       int y) {
  return x >= y ? range_sum(a, lane, base + y, base + x)
                : -range_sum(a, lane, base + x, base + y);
}

__global__ void __launch_bounds__(32 * MAX_WARPS) hsplit_kernel(
    const HsplitArgs a) {
  __shared__ long long s_key[MAX_WARPS];
  __shared__ int s_total[MAX_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpt = a.wpt;
  const int task = blockIdx.x * (blockDim.x / (32 * wpt)) + warp / wpt;
  const int w = warp % wpt;
  const bool live = task < a.n;
  const int t = live ? task : 0;
  const int B2 = 2 * a.n, lf = 2 * t, lr = 2 * t + 1;
  const int pro = a.prolog[t], pl = a.plen[t], tl = a.tlen[t];
  const int f_first = a.first[lf], f_last = a.last[lf];
  const int r_first = a.first[lr], r_last = a.last[lr];

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
  const int R0 = higher_cell_r + n_cells - 1;

  // the walk: this warp's chunks of 32 forward words
  long long key = NO_KEY;
  int carry = 0;
  if (live && feasible && n_cells > 0) {
    const int bf_lo = bottom_cell >> 6;
    const int nch = ((((bottom_cell + n_cells - 1) >> 6) - bf_lo) >> 5) + 1;
    const int per = (nch + wpt - 1) / wpt;
    const int ch_end = min(nch, (w + 1) * per);
    for (int ch = w * per; ch < ch_end; ++ch) {
      const int bf = bf_lo + 32 * ch + lane;
      const int i_lo = W * bf - bottom_cell;     // walk index of bit 0
      const int lo = max(0, -i_lo);
      const int hi_j = min(63, n_cells - 1 - i_lo);   // joint candidates
      const uint64_t fmask = bits(lo, min(63, n_cells - 2 - i_lo));
      const uint64_t jmask = bits(lo, hi_j);
      const uint64_t fp = word(a.pv, true, lf, B2, a.EBB, bf) & fmask;
      const uint64_t fm = word(a.mv, false, lf, B2, a.EBB, bf) & fmask;
      const int top = R0 - i_lo, rb = top >> 6, u = top & 63;
      const uint64_t rp =
          mirrored(word(a.pv, true, lr, B2, a.EBB, rb),
                   word(a.pv, true, lr, B2, a.EBB, rb - 1), u) & jmask;
      const uint64_t rm =
          mirrored(word(a.mv, false, lr, B2, a.EBB, rb),
                   word(a.mv, false, lr, B2, a.EBB, rb - 1), u) & jmask;
      const int d = __popcll(fp) - __popcll(fm) - __popcll(rp) +
                    __popcll(rm);
      int incl = d;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, k);
        if (lane >= k) incl += y;
      }
      if (jmask) {
        int acc = carry + incl - d;       // the walk's value before bit 0
        int bv = INT_MAX, bp = 0;
#pragma unroll
        for (int p = 0; p < 64; ++p) {
          acc += (int)((rm >> p) & 1ull) - (int)((rp >> p) & 1ull);
          if (p >= lo && p <= hi_j && acc < bv) {
            bv = acc;
            bp = p;
          }
          acc += (int)((fp >> p) & 1ull) - (int)((fm >> p) & 1ull);
        }
        // a later chunk's index is higher: min keeps the first minimum
        key = min(key, (long long)bv * 4294967296ll + (i_lo + bp));
      }
      carry += __shfl_sync(FULL, incl, 31);
    }
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    key = min(key, __shfl_xor_sync(FULL, key, k));

  if (wpt > 1) {
    // the task's warps in order: each one's values are relative to its
    // first cell, so add the totals of the warps before it
    if (lane == 0) {
      s_key[warp] = key;
      s_total[warp] = carry;
    }
    __syncthreads();
    if (w != 0) return;
    int off = 0;
    key = NO_KEY;
    for (int v = 0; v < wpt; ++v) {
      const long long k = s_key[warp + v];
      if (k != NO_KEY) key = min(key, k + (long long)off * 4294967296ll);
      off += s_total[warp + v];
    }
  }
  if (!live || lane != 0) return;

  if (!feasible) {
    a.pll_out[task] = a.score_l_out[task] = a.score_r_out[task] = 0;
    a.feasible_out[task] = 0;
    return;
  }
  // no candidate (n_cells <= 0): the first of all-masked values, index 0
  const int sp = key == NO_KEY ? 0 : (int)(key & 0xffffffffll);
  const int pll = starting_pos + sp;
  auto clamp_cells = [&](int idx) { return min(max(idx, 0), n_cells); };
  auto score_row = [&](int ln, int row) {
    const int r = row + pro;
    if (r >= 0 && r < a.K1) return a.scores[(size_t)r * B2 + ln];
    return (row + 1) * W;
  };
  const int block_ref =
      floordiv(pll + W - 1, W) - (n_cells < sp + W ? 1 : 0);
  const int score_pos_l = block_ref * W - (bottom_cell + fb * W);
  const int score_l = cs_diff(a, lf, bottom_cell, sp,
                              clamp_cells(score_pos_l)) +
                      score_row(lf, block_ref - 1);
  const int plr = pl - pll;
  const int block_ref_r = floordiv(plr + W - 1, W) - (sp < W ? 1 : 0);
  const int score_pos_r = block_ref_r * W - (higher_cell_r + fb_r * W);
  const int score_r = cs_diff(a, lr, higher_cell_r, n_cells - 1 - sp,
                              clamp_cells(score_pos_r)) +
                      score_row(lr, block_ref_r - 1);
  a.pll_out[task] = pll;
  a.score_l_out[task] = score_l;
  a.score_r_out[task] = score_r;
  a.feasible_out[task] = 1;
}

}  // namespace

// wpt: warps a task (1, 2, 4 or 8); tpc: tasks a CTA, wpt * tpc <= 8.
extern "C" int qtt_hirschberg_split(const void* scores, const void* pv,
                                    const void* mv, const void* first,
                                    const void* last, const void* prolog,
                                    const void* plen, const void* tlen,
                                    void* pll, void* score_l, void* score_r,
                                    void* feasible, int n, int EBB, int K1,
                                    int wpt, int tpc, void* stream) {
  if (n <= 0) return 0;
  if (wpt < 1 || wpt > MAX_WARPS || (wpt & (wpt - 1)) || tpc < 1 ||
      wpt * tpc > MAX_WARPS || EBB < 1 || K1 < 1)
    return (int)cudaErrorInvalidValue;
  HsplitArgs a{(const int32_t*)scores, (const uint64_t*)pv,
               (const uint64_t*)mv, (const int32_t*)first,
               (const int32_t*)last, (const int32_t*)prolog,
               (const int32_t*)plen, (const int32_t*)tlen, (int32_t*)pll,
               (int32_t*)score_l, (int32_t*)score_r, (int32_t*)feasible,
               n, EBB, K1, wpt};
  hsplit_kernel<<<(n + tpc - 1) / tpc, 32 * wpt * tpc, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
