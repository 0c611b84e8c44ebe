// Windowed score bound (score-only mode) with the high-error-window count.
//
// Replaces quicked_tpu/ops/windowed_jax.py:windowed_scan_impl in score
// mode (an XLA while-loop on the TPU), i.e. the reference's
// windowed_compute + windowed_backtrace_score_only
// (bpm_windowed.c:504-628): tie-break D, I, M, X with raw-character M
// tests; pattern pad -2 and text pad -1 never match.
//
// Design: one thread per pair walks its own diagonal one window of
// (64*ws) x (64*ws) cells at a time. Per window it builds the shifted PEQ
// window (a 64-bit funnel shift per word), fills 64*ws columns with the
// unmasked Myers advance, then backtraces greedily column by column,
// taking each whole D-run from the highest zero Pv bit below the cursor.
// The per-window state (Pv after and Mv before each column, 16*ws bytes
// per column) goes to a scratch buffer in device memory, lane-minor so a
// warp's stores coalesce: 576 * 9 * 16 B = 83 KB per pair at ws = 9.
// Up to ws = 16 the shifted PEQ window and the ws band words of the
// column being filled live in the thread (RegWindow); a wider window
// keeps them in a second lane-minor scratch buffer (ScratchWindow,
// 56 * ws bytes per pair), so every window size runs.
//
// What bounds it on the H100: a lane is a long sequential walk (fill and
// backtrace of ~len/(64*(ws-ovl)) windows), so the kernel is latency-bound
// with B threads in flight; the scratch traffic (two 8-byte stores per
// block per column, then reads back on the walk) mostly stays in L2.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr int MAX_REG_WS = 16;

struct RegWindow {
  uint64_t peqw[MAX_REG_WS * 5], pv[MAX_REG_WS], mv[MAX_REG_WS];
  __device__ uint64_t &eq(int i, int c) { return peqw[i * 5 + c]; }
  __device__ uint64_t &P(int i) { return pv[i]; }
  __device__ uint64_t &M(int i) { return mv[i]; }
};

struct ScratchWindow {     // lane-minor: word w of lane b at w * B + b
  uint64_t *peqw, *pv, *mv;
  size_t Bs;
  __device__ uint64_t &eq(int i, int c) {
    return peqw[(size_t)(i * 5 + c) * Bs];
  }
  __device__ uint64_t &P(int i) { return pv[(size_t)i * Bs]; }
  __device__ uint64_t &M(int i) { return mv[(size_t)i * Bs]; }
};

template <class Window>
__device__ void windowed_lane(
    const uint64_t* __restrict__ peq,      // (KP, 5, B)
    const int32_t* __restrict__ text_enc,  // (T, B)
    const int32_t* __restrict__ text_raw,  // (T, B)
    const int32_t* __restrict__ pat_raw,   // (P, B)
    const int32_t* __restrict__ plen, const int32_t* __restrict__ tlen,
    const int32_t* __restrict__ num_words,
    uint64_t* __restrict__ pv_after,       // scratch (64*WS, WS, B)
    uint64_t* __restrict__ mv_before,      // scratch (64*WS, WS, B)
    int32_t* __restrict__ score_out, int32_t* __restrict__ hew_out,
    int B, int KP, int T, int P, int WS, int OVL, int hew_cells, int b,
    Window &win) {
  const size_t Bs = (size_t)B;
  const int COLS = W * WS;
  const int nw = num_words[b];
  // window-count bound: every window but the last moves pos_v + pos_h by
  // at least 64 * (ws - ovl)
  const int max_windows = (P + T + W * max(WS - OVL, 1) - 1) /
                              (W * max(WS - OVL, 1)) + 2;
  int pos_v = plen[b] - 1, pos_h = tlen[b] - 1;
  int score = 0, hew = 0;

  for (int it = 0; it < max_windows && pos_v >= 0 && pos_h >= 0; ++it) {
    const int v_min = max(pos_v - COLS + 1, 0);
    const int h_min = max(pos_h - COLS + 1, 0);
    const int shift = v_min % W, v_block = v_min / W;

    // shifted PEQ window (bpm_windowed.c:237-244)
    for (int i = 0; i < WS; ++i) {
      const int row = v_block + i;
      const int rc = min(row, KP - 1), rc1 = min(row + 1, KP - 1);
      for (int c = 0; c < 5; ++c) {
        const uint64_t lo =
            row < nw ? peq[((size_t)rc * 5 + c) * Bs + b] : qtt::ONES;
        const uint64_t hi =
            row + 1 < nw ? peq[((size_t)rc1 * 5 + c) * Bs + b] : 0ull;
        win.eq(i, c) =
            shift == 0 ? lo : (lo >> shift) | (hi << (W - shift));
      }
    }

    // window fill (bpm_windowed.c:202-280), no level masks
    for (int i = 0; i < WS; ++i) {
      win.P(i) = h_min == 0 ? qtt::ONES : 0ull;
      win.M(i) = 0;
    }
    const uint32_t ph_first = v_min == 0 ? 1u : 0u;
    for (int tp = 0; tp < COLS; ++tp) {
      const int c = text_enc[(size_t)(h_min + tp) * Bs + b];
      uint32_t ph = ph_first, mh = 0;
      for (int i = 0; i < WS; ++i) {
        mv_before[((size_t)tp * WS + i) * Bs + b] = win.M(i);
        qtt::advance_block(win.eq(i, c), qtt::TOPBIT, win.P(i), win.M(i),
                           ph, mh);
        pv_after[((size_t)tp * WS + i) * Bs + b] = win.P(i);
      }
    }

    // greedy backtrace, score-only tie-break D, I, M, X
    const int v_ovl_rel = max(pos_v - W * (WS - OVL) + 1, 0) - v_min;
    const int h_ovl_rel = max(pos_h - W * (WS - OVL) + 1, 0) - h_min;
    int vr = pos_v - v_min, hr = pos_h - h_min, sc = 0;
    while (hr >= 0 && vr >= v_ovl_rel && hr >= h_ovl_rel) {
      const int tp = hr;       // column hr + 1 of the window
      const int vru = min(max(vr, 0), COLS - 1);
      int hz = -1;
      for (int w = vru / W; w >= 0; --w) {
        uint64_t y = ~pv_after[((size_t)tp * WS + w) * Bs + b];
        if (w == vru / W) y &= qtt::mask_le(vru % W);
        if (y) {
          hz = W * w + 63 - __clzll((long long)y);
          break;
        }
      }
      const int max_run = vru - v_ovl_rel + 1;
      const int run = min(vru - hz, max_run);
      const int v1 = vru - run;
      if (run == max_run) {    // the window's exit, mid-run
        sc += run;
        vr = v1;
        break;
      }
      const int v1u = min(max(v1, 0), COLS - 1);
      const uint64_t m = mv_before[((size_t)tp * WS + v1u / W) * Bs + b];
      const bool is_i = (m >> (v1u % W)) & 1ull;
      const bool match = pat_raw[(size_t)(v_min + v1u) * Bs + b] ==
                         text_raw[(size_t)(h_min + tp) * Bs + b];
      sc += run + ((is_i || !match) ? 1 : 0);
      vr = v1 - (is_i ? 0 : 1);
      hr -= 1;
    }
    hew += sc > hew_cells ? 1 : 0;
    score += sc;
    pos_v = v_min + vr;
    pos_h = h_min + hr;
  }
  // boundary fill (bpm_windowed.c:599-627, score-only accounting)
  if (pos_h >= 0) score += pos_h + 1;
  if (pos_v >= 0) score += pos_v + 1;
  score_out[b] = score;
  hew_out[b] = hew;
}

#define QTT_WINDOWED_PARAMS                                                 \
  const uint64_t *__restrict__ peq, const int32_t *__restrict__ text_enc,  \
      const int32_t *__restrict__ text_raw,                                \
      const int32_t *__restrict__ pat_raw,                                 \
      const int32_t *__restrict__ plen, const int32_t *__restrict__ tlen,  \
      const int32_t *__restrict__ num_words,                               \
      uint64_t *__restrict__ pv_after, uint64_t *__restrict__ mv_before,   \
      int32_t *__restrict__ score_out, int32_t *__restrict__ hew_out,      \
      int B, int KP, int T, int P, int WS, int OVL, int hew_cells
#define QTT_WINDOWED_ARGS                                                    \
  peq, text_enc, text_raw, pat_raw, plen, tlen, num_words, pv_after,        \
      mv_before, score_out, hew_out, B, KP, T, P, WS, OVL, hew_cells

__global__ void windowed_score_reg(QTT_WINDOWED_PARAMS) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  RegWindow win;
  windowed_lane(QTT_WINDOWED_ARGS, b, win);
}

__global__ void windowed_score_scratch(QTT_WINDOWED_PARAMS,
                                       uint64_t *__restrict__ win_peq,
                                       uint64_t *__restrict__ win_pv,
                                       uint64_t *__restrict__ win_mv) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ScratchWindow win{win_peq + b, win_pv + b, win_mv + b, (size_t)B};
  windowed_lane(QTT_WINDOWED_ARGS, b, win);
}

#undef QTT_WINDOWED_PARAMS
#undef QTT_WINDOWED_ARGS

}  // namespace

// win_peq (ws*5, B), win_pv and win_mv (ws, B): the scratch window, used
// when ws > 16 (null otherwise).
extern "C" int qtt_windowed_score(const void* peq, const void* text_enc,
                                  const void* text_raw, const void* pat_raw,
                                  const void* plen, const void* tlen,
                                  const void* num_words, void* pv_after,
                                  void* mv_before, void* score, void* hew,
                                  void* win_peq, void* win_pv, void* win_mv,
                                  int B, int KP, int T, int P, int WS,
                                  int OVL, int hew_cells, void* stream) {
  if (B <= 0) return 0;
  if (WS < 1 || (WS > MAX_REG_WS && !(win_peq && win_pv && win_mv)))
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_WINDOWED_CAST                                                    \
  (const uint64_t*)peq, (const int32_t*)text_enc, (const int32_t*)text_raw, \
      (const int32_t*)pat_raw, (const int32_t*)plen, (const int32_t*)tlen,  \
      (const int32_t*)num_words, (uint64_t*)pv_after, (uint64_t*)mv_before, \
      (int32_t*)score, (int32_t*)hew, B, KP, T, P, WS, OVL, hew_cells
  if (WS <= MAX_REG_WS)
    windowed_score_reg<<<blocks, threads, 0, s>>>(QTT_WINDOWED_CAST);
  else
    windowed_score_scratch<<<blocks, threads, 0, s>>>(
        QTT_WINDOWED_CAST, (uint64_t*)win_peq, (uint64_t*)win_pv,
        (uint64_t*)win_mv);
#undef QTT_WINDOWED_CAST
  return (int)cudaGetLastError();
}
