// Banded traceback over the full fill's band snapshots.
//
// Replaces quicked_tpu/ops/banded_traceback_jax.py:traceback_records_impl
// (an XLA column scan on the TPU), and with it the reference's
// banded_backtrace_matrix_cutoff (bpm_banded.c:967-1036), cell for cell:
// tie-break D, I, M, X with the M test on raw characters. Output is one
// (d_run, op) record per column, (T, B) lane-minor as before.
//
// What bounds it on the H100: the walk is sequential per pair: per column
// one D-run from the highest ZERO Pv bit at or below the cursor (native
// 64-bit __clzll over the band words), then one I/M/X step from the
// previous column's Mv bit and a raw-byte compare. The bytes it needs are
// small (two words, two characters and a 5-byte record per column); the
// cost is the latency of those dependent reads. Read straight from the
// (T, EBB, B) planes in device memory they took ~2000 cycles a column,
// and one thread per pair put a 32-lane chunk on one warp of one SM.
//
// Design: one warp (one CTA) per pair, so a 32-lane chunk covers 32 SMs.
// The warp copies, for the next K = 64 columns, the NWIN = 8 band words
// around the cursor of each column's Pv plane and of the Mv plane before
// it into shared memory with cp.async, double-buffered: while lane 0 walks
// chunk k from shared memory, the copies of chunk k+1 are in flight.
// Along a diagonal the cursor's place in the band frame only saws within
// one word (the frame moves 64 rows every 64 columns), so the window is
// centred on the cursor where chunk k starts; a word outside it (a D-run
// past it, a large indel) is read from device memory, so the walk is exact
// on any planes. Staging the whole band (EBB words a column) cost more in
// copy instructions than the walk itself. The walk loads a column's Pv
// word, the Mv word and the pattern character of the no-D-run case
// together. The raw characters are read pair-major (the wrapper
// transposes both frames), so the walk's descending reads stay in one L1
// line for 128 rows. Columns the walk does not reach (past the text, below
// its end) get their zero records from all 32 lanes at once.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr unsigned FULL = 0xffffffffu;
constexpr int K = 64;       // columns a staged chunk covers
constexpr int NWIN = 8;     // band words staged per column and plane

using qtt::cp_async8;
using qtt::cp_async_commit;
using qtt::cp_async_wait;

struct TracebackArgs {
  const uint64_t *mat_pv, *mat_mv;       // (T, EBB, B)
  const uint8_t *praw, *traw;            // (B, PP), (B, T): pair-major
  const int32_t *plen, *tlen, *prolog;   // (B,)
  int32_t* runs;                         // (T, B)
  int8_t* opcs;                          // (T, B)
  int32_t *v_fin, *h_fin;                // (B,)
  int B, T, EBB, PP;
};

// Word w of the Pv plane of column hc (the band frame of hc + 1), and of
// the Mv plane of column hc - 1 (the band frame of hc): from the staged
// window [lo, lo + nw) of chunk columns c0.., else from device memory.
struct Planes {
  const TracebackArgs& a;
  const uint64_t *pv, *mv;
  int c0, lo, nw, b;
  __device__ uint64_t P(int hc, int w) const {
    const unsigned d = (unsigned)(w - lo);
    return d < (unsigned)nw
               ? pv[(hc - c0) * NWIN + d]
               : a.mat_pv[((size_t)hc * a.EBB + w) * a.B + b];
  }
  __device__ uint64_t M(int hc, int w) const {
    const unsigned d = (unsigned)(w - lo);
    return d < (unsigned)nw
               ? mv[(hc - c0) * NWIN + d]
               : a.mat_mv[((size_t)(hc - 1) * a.EBB + w) * a.B + b];
  }
};

// One column's step in full: the D-run from any band word, the I/M/X
// step; returns the record (run, opcode) and moves v, h.
__device__ __forceinline__ void column_step(const Planes& pl,
                                            const uint8_t* praw, int nbits,
                                            int pro, int hc, uint8_t tc,
                                            int& v, int& h, int& run,
                                            int& opc) {
  run = 0;
  opc = 0;
  // D-run in the band frame of column hc + 1 (plane hc)
  const int bp = v - W * ((hc + 1) / W) + W * pro;
  if (bp >= 0 && bp < nbits) {
    int w = bp >> 6;
    uint64_t y = ~pl.P(hc, w) & qtt::mask_le(bp & 63);
    while (!y && w > 0) {
      --w;
      y = ~pl.P(hc, w);
    }
    const int hz = y ? W * w + 63 - __clzll((long long)y) : -1;
    run = min(bp - hz, v + 1);
  }
  const int v1 = v - run;
  if (v1 < 0) {
    v = v1;
    return;
  }
  // one column-consuming step at (v1, hc): I, M or X
  const int ev = v1 - W * (hc / W) + W * pro;   // band frame of hc
  const int ibit = hc > 0 && ev >= 0 && ev < nbits
                       ? (int)((pl.M(hc, ev >> 6) >> (ev & 63)) & 1ull)
                       : 0;
  opc = ibit ? 3 : (praw[v1] == tc ? 1 : 4);
  v = v1 - (ibit ? 0 : 1);
  h -= 1;
}

// Walk columns hc down to c0 while v >= 0 (then h == hc at every column
// walked); leaves hc at the first column not walked. The common column
// (the cursor's Pv and Mv words in the staged window, no D-run) loads its
// two words and two characters together and takes one step; any other
// takes column_step. pv_s, mv_s: the shared addresses of pl.pv, pl.mv.
__device__ void walk_columns(const TracebackArgs& a, const Planes& pl,
                             unsigned pv_s, unsigned mv_s,
                             const uint8_t* praw, const uint8_t* traw,
                             int pro, int c0, int& v, int& h, int& hc) {
  const size_t Bs = (size_t)a.B;
  const int nbits = a.EBB * W, b = pl.b;
  for (; hc >= c0 && v >= 0; --hc) {
    const uint8_t tc = __ldg(traw + hc);
    const uint8_t pc = __ldg(praw + v);
    // hc >= 0: the frames of planes hc (column hc + 1) and hc - 1
    const int bp = v - ((hc + 1) & ~(W - 1)) + W * pro;
    const int ev = v - (hc & ~(W - 1)) + W * pro;
    const unsigned wp = (unsigned)((bp >> 6) - pl.lo);
    const unsigned wm = (unsigned)((ev >> 6) - pl.lo);
    int run, opc;
    uint64_t pw = ~0ull, mw = 0;
    const bool staged = hc > 0 && wp < (unsigned)pl.nw && wm < (unsigned)pl.nw;
    if (staged) {
      const unsigned j = (unsigned)(hc - c0) * NWIN;
      pw = qtt::lds_u64(pv_s + 8 * (j + wp));
      mw = qtt::lds_u64(mv_s + 8 * (j + wm));
    }
    if (staged && !((pw >> (bp & 63)) & 1ull)) {
      const int ibit = (int)((mw >> (ev & 63)) & 1ull);
      run = 0;
      opc = ibit ? 3 : (pc == tc ? 1 : 4);
      v -= ibit ? 0 : 1;
      h -= 1;
    } else {
      column_step(pl, praw, nbits, pro, hc, tc, v, h, run, opc);
    }
    a.runs[(size_t)hc * Bs + b] = run;
    a.opcs[(size_t)hc * Bs + b] = (int8_t)opc;
  }
}

__global__ void __launch_bounds__(32) banded_traceback_kernel(
    const TracebackArgs a) {
  __shared__ __align__(16) uint64_t stage[2][2][K * NWIN];   // [buf][Pv, Mv]
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t Bs = (size_t)a.B;
  const int EBB = a.EBB;
  const int pro = a.prolog[b];
  const int tl = a.tlen[b];
  const uint8_t* praw = a.praw + (size_t)b * a.PP;
  const uint8_t* traw = a.traw + (size_t)b * a.T;
  int v = a.plen[b] - 1, h = tl - 1, hc = tl - 1;

  // the columns past the text hold idle records
  for (int c = tl + lane; c < a.T; c += 32) {
    a.runs[(size_t)c * Bs + b] = 0;
    a.opcs[(size_t)c * Bs + b] = 0;
  }

  // lane -> (column, word) of a copy pass: 32 / nw columns a pass
  const int nw = min(NWIN, EBB);
  const int per_pass = 32 / nw;
  const int my_col = lane / nw, my_w = lane - my_col * nw;
  // the staged window's first word: centred on the cursor's word at
  // column hc + 1's frame, inside the band
  auto window_lo = [&]() {
    const int bp = v - W * ((hc + 1) / W) + W * pro;
    const int wc = min(max(bp, 0), EBB * W - 1) >> 6;
    return min(max(wc - NWIN / 2, 0), EBB - nw);
  };
  // copy the window of columns [c1 - K + 1, c1] (from 0) into buffer buf
  auto issue = [&](int c1, int lo, int buf) {
    const int c0 = max(c1 - K + 1, 0);
    const int w = lo + my_w;
    for (int col = c0 + my_col; my_col < per_pass && col <= c1;
         col += per_pass) {
      const int x = (col - c0) * NWIN + my_w;
      cp_async8(&stage[buf][0][x],
                a.mat_pv + ((size_t)col * EBB + w) * Bs + b);
      if (col > 0)
        cp_async8(&stage[buf][1][x],
                  a.mat_mv + ((size_t)(col - 1) * EBB + w) * Bs + b);
    }
    cp_async_commit();
  };

  const unsigned stage_s = qtt::shared_addr(stage);
  bool done = v < 0 || hc < 0;
  int lo = 0, lo_next = 0;    // the windows of the current and next chunk
  if (!done) {
    lo = window_lo();
    issue(hc, lo, 0);
  }
  for (int k = 0; !done; ++k, lo = lo_next) {
    const int c1 = hc, c0 = max(c1 - K + 1, 0), cur = k & 1;
    if (c0 > 0) {
      lo_next = window_lo();
      issue(c0 - 1, lo_next, cur ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (lane == 0)
      walk_columns(a, Planes{a, stage[cur][0], stage[cur][1], c0, lo, nw, b},
                   stage_s + sizeof(stage[0]) * cur,
                   stage_s + sizeof(stage[0]) * cur + sizeof(stage[0][0]),
                   praw, traw, pro, c0, v, h, hc);
    v = __shfl_sync(FULL, v, 0);
    hc = __shfl_sync(FULL, hc, 0);
    done = v < 0 || hc < 0;
    __syncwarp();
  }
  cp_async_wait<0>();

  // the columns below the walk's end hold idle records
  for (int c = lane; c <= hc; c += 32) {
    a.runs[(size_t)c * Bs + b] = 0;
    a.opcs[(size_t)c * Bs + b] = 0;
  }
  if (lane == 0) {
    a.v_fin[b] = v;
    a.h_fin[b] = h;
  }
}

}  // namespace

// praw (B, PP) and traw (B, T) pair-major.
extern "C" int qtt_banded_traceback(const void* mat_pv, const void* mat_mv,
                                    const void* praw, const void* traw,
                                    const void* plen, const void* tlen,
                                    const void* prolog, void* runs,
                                    void* opcs, void* v_fin, void* h_fin,
                                    int B, int T, int EBB, int PP,
                                    void* stream) {
  if (B <= 0) return 0;
  if (EBB < 1) return (int)cudaErrorInvalidValue;
  TracebackArgs a{(const uint64_t*)mat_pv, (const uint64_t*)mat_mv,
                  (const uint8_t*)praw, (const uint8_t*)traw,
                  (const int32_t*)plen, (const int32_t*)tlen,
                  (const int32_t*)prolog, (int32_t*)runs, (int8_t*)opcs,
                  (int32_t*)v_fin, (int32_t*)h_fin, B, T, EBB, PP};
  banded_traceback_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
