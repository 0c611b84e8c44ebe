// Windowed score bound (score-only mode) with the high-error-window count,
// and the windowed full-CIGAR mode.
//
// Replaces quicked_tpu/ops/windowed_jax.py:windowed_scan_impl (an XLA
// while-loop on the TPU) in both modes, i.e. the reference's
// windowed_compute with windowed_backtrace_score_only
// (bpm_windowed.c:504-628: tie-break D, I, M, X) or windowed_backtrace
// (bpm_windowed.c:448-502: tie-break M, D, I, X, a D step only where the
// cell does not match); raw-character M tests, pattern pad -2 and text pad
// -1 never match.
//
// What bounds it on the H100: each pair is a long chain of dependent
// steps (per window 64*ws columns of ws Myers advances, then a greedy
// walk of up to 64*ws columns), ~195 windows per 100 kbp pair at ws 9.
// The operations (~30 per advance) would take microseconds over the card;
// what costs is the latency of each dependent step and how many chains
// run at once. One thread per pair (the first port) ran a 100-pair batch
// as one CTA on one SM, with every window word in device memory.
//
// Design:
// - A pair owns a segment of `span` lanes of a warp (span a power of 2,
//   at least min(ws, 32)); a warp holds 32 / span pairs, and the wrapper
//   narrows that packing until the batch spans the card's SMs. One warp
//   per CTA.
// - The window fills in parallel as a systolic skew: lane i of the
//   segment owns block i (rows 64i..64i+63) and fills U = 8 columns of it
//   a step, columns 8(s - i).. at step s, so a window takes 8*ws + ws - 1
//   steps; the 8 columns' ph/mh carries leaving block i reach lane i + 1
//   one step later, packed in one segmented __shfl_up_sync. Eight columns
//   a step put eight dependent advances between two shuffles and spread a
//   step's fixed cost (the shuffle, the character load, the stores); at
//   ws 9 the skew idles a lane for 8 of 80 steps. The fill's
//   carry-map ballots (qtt_common.cuh) would give every block's carry-in
//   in one step, but cost three ballots and a map composition per column
//   for ws <= 16 blocks, where the skew costs ws - 1 extra steps per
//   8*ws. Past 32 blocks the lanes take the window in groups of 32
//   blocks, one group after another, the carries between groups kept per
//   column.
// - Each lane builds its block's shifted PEQ words once per window into a
//   shared table it indexes by the text character.
// - The window (Pv after and Mv before every column, 16 * 64 * ws * ws
//   bytes), the window's text (encoded and raw) and raw pattern
//   characters sit in shared memory, block-major so that the skewed
//   stores of a step hit distinct banks. Where one pair's window does not
//   fit a CTA's 227 KB (ws >= 15), the same body keeps the window in a
//   pair-major device-memory scratch and reads the characters straight
//   from the inputs.
// - The greedy backtrace is one lane per pair over that window: the whole
//   D-run from the highest zero Pv bit at or below the cursor, then one
//   I/M/X step. A column's Pv word, its Mv word and pattern character for
//   the case of no D-run (the common one) are loaded together, so a
//   column costs one shared-memory latency unless a D-run moves the
//   cursor.
// - Full mode (FULLM) runs the same fill; its walk steps a D-run row by
//   row (a D needs Pv set and no match, so the run is not one word's
//   highest zero bit) and writes one (d_run int16, opcode int8) record
//   per walked column, pair-major (B, MW, COLS) into buffers the wrapper
//   zeroes, and each pair's final cursor.
// The inputs arrive pair-major (the wrapper transposes the staged
// lane-minor batch), so a segment's staging loads are contiguous.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr unsigned FULL = 0xffffffffu;
constexpr int U = 8;                 // columns a lane fills per skew step

struct WindowedArgs {
  const uint64_t* peq;       // (B, KP, 5)
  const uint8_t* text_enc;   // (B, T)
  const int32_t* text_raw;   // (B, T)
  const int32_t* pat_raw;    // (B, P)
  const int32_t *plen, *tlen, *num_words;   // (B,)
  uint8_t* scratch;          // (B, pair_bytes) in scratch mode, else null
  int32_t *score_out, *hew_out;             // (B,), score mode
  int B, KP, T, P, WS, OVL, hew_cells, span;
  size_t pair_bytes;         // a pair's shared (or scratch) region
  int16_t* rec_run;          // (B, MW, COLS), full mode
  int8_t* rec_op;            // (B, MW, COLS), full mode
  int32_t *pos_v_out, *pos_h_out;           // (B,), full mode
};

// Per pair, shared mode: Pv after and Mv before each column (u64,
// block-major: word i of column tp at i * COLS + tp), the raw text and
// pattern characters (i32) and the encoded text (u8) of the window.
// Scratch mode: the two planes, then two carry buffers of COLS bytes.
__host__ __device__ inline size_t shared_pair_bytes(int ws) {
  const size_t cols = (size_t)W * ws;
  return cols * (16 * (size_t)ws + 9);
}
__host__ __device__ inline size_t scratch_pair_bytes(int ws) {
  const size_t cols = (size_t)W * ws;
  return cols * (16 * (size_t)ws + 2);
}

// U encoded text characters from byte offset k (a multiple of U): one
// load from the staged shared window, byte loads from an unaligned input.
template <bool SMEM>
__device__ __forceinline__ uint64_t load_chars(const uint8_t* te, int k) {
  if (SMEM) return *reinterpret_cast<const uint64_t*>(te + k);
  uint64_t c = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) c |= (uint64_t)te[k + u] << (8 * u);
  return c;
}

template <bool SMEM, bool FULLM>
__global__ void __launch_bounds__(32) windowed_kernel(const WindowedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  // each lane's block's shifted PEQ words, indexed by the character: a
  // load, where a select over five registers branches, and the lanes of a
  // skew read different characters
  __shared__ uint64_t peq_s[32][5];
  const int lane = threadIdx.x;
  const int span = a.span;
  const int seg = lane / span, sl = lane % span;
  const int b = blockIdx.x * (32 / span) + seg;
  const bool live = b < a.B;
  const int bb = live ? b : 0;
  const int WS = a.WS, COLS = W * WS, NQ = COLS / U;
  const int NG = (WS + span - 1) / span;    // groups of span blocks

  uint8_t* base = SMEM ? smem + (size_t)seg * a.pair_bytes
                       : a.scratch + (size_t)bb * a.pair_bytes;
  uint64_t* pv = reinterpret_cast<uint64_t*>(base);
  uint64_t* mv = pv + WS * COLS;
  uint8_t* tail = reinterpret_cast<uint8_t*>(mv + WS * COLS);
  const size_t bT = (size_t)bb * a.T, bP = (size_t)bb * a.P;
  const uint64_t* peq = a.peq + (size_t)bb * a.KP * 5;

  const int nw = live ? a.num_words[b] : 1;
  // window-count bound: every window but the last moves pos_v + pos_h by
  // at least 64 * (ws - ovl)
  const int stride = W * max(WS - a.OVL, 1);
  const int max_windows = (a.P + a.T + stride - 1) / stride + 2;
  int pos_v = live ? a.plen[b] - 1 : -1;
  int pos_h = live ? a.tlen[b] - 1 : -1;
  int score = 0, hew = 0;

  for (int it = 0; it < max_windows; ++it) {
    const bool act = pos_v >= 0 && pos_h >= 0;
    if (!__any_sync(FULL, act)) break;
    const int v_min = max(pos_v - COLS + 1, 0);
    const int h_min = max(pos_h - COLS + 1, 0);
    const int shift = v_min % W, v_block = v_min / W;

    // the window's characters
    const uint8_t* te;
    const int32_t *tr, *pr;
    if (SMEM) {
      int32_t* s_tr = reinterpret_cast<int32_t*>(tail);
      int32_t* s_pr = s_tr + COLS;
      uint8_t* s_te = reinterpret_cast<uint8_t*>(s_pr + COLS);
      if (act) {
#pragma unroll 4
        for (int tp = sl; tp < COLS; tp += span) {
          s_te[tp] = __ldg(a.text_enc + bT + h_min + tp);
          s_tr[tp] = __ldg(a.text_raw + bT + h_min + tp);
          s_pr[tp] = __ldg(a.pat_raw + bP + v_min + tp);
        }
      }
      te = s_te;
      tr = s_tr;
      pr = s_pr;
      __syncwarp();
    } else {
      te = a.text_enc + bT + h_min;
      tr = a.text_raw + bT + h_min;
      pr = a.pat_raw + bP + v_min;
    }

    // window fill (bpm_windowed.c:202-280), no level masks, as a skew of
    // U columns per step
    const uint64_t p_init = h_min == 0 ? qtt::ONES : 0ull;
    const uint32_t first = v_min == 0 ? 0x5555u : 0u;   // ph = 1, U columns
    for (int g = 0; g < NG; ++g) {
      const int i = g * span + sl;                 // this lane's block
      const int nvalid = min(span, WS - g * span);
      const bool mine = act && sl < nvalid;
      // carries between groups, U columns a 16-bit word (scratch mode
      // only: ws > 32 > 14)
      const uint16_t* carry_in =
          reinterpret_cast<const uint16_t*>(tail + ((g + 1) & 1) * COLS);
      uint16_t* carry_out = reinterpret_cast<uint16_t*>(tail + (g & 1) * COLS);

      // the shifted PEQ window of block i (bpm_windowed.c:237-244)
      const uint64_t* eqs = peq_s[lane];
      if (mine) {
        const int row = v_block + i;
        const int rc = min(row, a.KP - 1), rc1 = min(row + 1, a.KP - 1);
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const uint64_t lo = row < nw ? peq[(size_t)rc * 5 + c] : qtt::ONES;
          const uint64_t hi = row + 1 < nw ? peq[(size_t)rc1 * 5 + c] : 0ull;
          peq_s[lane][c] =
              shift == 0 ? lo : (lo >> shift) | (hi << (W - shift));
        }
      }
      ulonglong2* pvi = reinterpret_cast<ulonglong2*>(pv + i * COLS);
      ulonglong2* mvi = reinterpret_cast<ulonglong2*>(mv + i * COLS);
      uint64_t P = p_init, M = 0;
      uint32_t cout = 0;            // carries out: ph | mh << 1, U columns
      const int steps = NQ + nvalid - 1;
      for (int s = 0; s < steps; ++s) {
        uint32_t cin = __shfl_up_sync(FULL, cout, 1, span);
        const int q = s - sl;       // columns U*q .. U*q + U-1
        if (mine && q >= 0 && q < NQ) {
          if (sl == 0) cin = g == 0 ? first : carry_in[q];
          const uint64_t cs = load_chars<SMEM>(te, U * q);
          uint64_t pw[U], mw[U];
          cout = 0;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const uint64_t eq = eqs[(cs >> (8 * u)) & 0xffu];
            uint32_t ph = (cin >> (2 * u)) & 1u;
            uint32_t mh = (cin >> (2 * u + 1)) & 1u;
            mw[u] = M;
            qtt::advance_block(eq, qtt::TOPBIT, P, M, ph, mh);
            pw[u] = P;
            cout |= (ph | (mh << 1)) << (2 * u);
          }
#pragma unroll
          for (int k = 0; k < U / 2; ++k) {
            pvi[U / 2 * q + k] = make_ulonglong2(pw[2 * k], pw[2 * k + 1]);
            mvi[U / 2 * q + k] = make_ulonglong2(mw[2 * k], mw[2 * k + 1]);
          }
          if (sl == nvalid - 1 && g + 1 < NG) carry_out[q] = (uint16_t)cout;
        }
      }
      __syncwarp();
    }

    // full mode: greedy backtrace, tie-break M, D, I, X, one record per
    // walked column (the loop's bounds as below)
    if (FULLM && act && sl == 0) {
      const int v_ovl_rel = max(pos_v - W * (WS - a.OVL) + 1, 0) - v_min;
      const int h_ovl_rel = max(pos_h - W * (WS - a.OVL) + 1, 0) - h_min;
      const size_t rec = ((size_t)b * max_windows + it) * COLS;
      int16_t* rr = a.rec_run + rec;
      int8_t* ro = a.rec_op + rec;
      int vr = pos_v - v_min, hr = pos_h - h_min;
      while (hr >= 0 && vr >= v_ovl_rel && hr >= h_ovl_rel) {
        const int tp = hr;
        const int tc = tr[tp];
        const int max_run = vr - v_ovl_rel + 1;
        int run = 0, v = vr;
        uint64_t pw = pv[(v >> 6) * COLS + tp];
        // the D-run: Pv set and no match, from the cursor down
        while (run < max_run && ((pw >> (v & 63)) & 1ull) && pr[v] != tc) {
          ++run;
          --v;
          if ((v & 63) == 63 && run < max_run) pw = pv[(v >> 6) * COLS + tp];
        }
        rr[tp] = (int16_t)run;
        if (run == max_run) {      // the window's exit, mid-run
          vr = v;
          break;
        }
        const bool is_m = pr[v] == tc;
        const bool is_i =
            !is_m && ((mv[(v >> 6) * COLS + tp] >> (v & 63)) & 1ull);
        ro[tp] = is_m ? 1 : (is_i ? 3 : 4);
        vr = v - (is_i ? 0 : 1);
        hr -= 1;
      }
      pos_v = v_min + vr;
      pos_h = h_min + hr;
    }

    // greedy backtrace, score-only tie-break D, I, M, X. In the loop
    // 0 <= v_ovl_rel <= vr < COLS, and a D-run that does not exit the
    // window stops above v_ovl_rel, so no index needs clamping.
    if (!FULLM && act && sl == 0) {
      const int v_ovl_rel = max(pos_v - W * (WS - a.OVL) + 1, 0) - v_min;
      const int h_ovl_rel = max(pos_h - W * (WS - a.OVL) + 1, 0) - h_min;
      int vr = pos_v - v_min, hr = pos_h - h_min, sc = 0;
      // shared addresses of the window (unused in the scratch mode)
      const unsigned pv_s = SMEM ? qtt::shared_addr(pv) : 0;
      const unsigned mv_s = SMEM ? qtt::shared_addr(mv) : 0;
      const unsigned pr_s = SMEM ? qtt::shared_addr(pr) : 0;
      const unsigned tr_s = SMEM ? qtt::shared_addr(tr) : 0;
      while (hr >= 0 && vr >= v_ovl_rel && hr >= h_ovl_rel) {
        const int tp = hr;       // column hr + 1 of the window
        const int bit = vr & 63;
        // the column's words, the Mv word and pattern character loaded
        // ahead on the guess that no D-run moves the cursor
        const int wo = (vr >> 6) * COLS + tp;
        uint64_t pw, mw;
        int pc, tc;
        if (SMEM) {
          pw = qtt::lds_u64(pv_s + 8 * wo);
          mw = qtt::lds_u64(mv_s + 8 * wo);
          pc = qtt::lds_s32(pr_s + 4 * vr);
          tc = qtt::lds_s32(tr_s + 4 * tp);
        } else {
          pw = pv[wo];
          mw = mv[wo];
          pc = pr[vr];
          tc = tr[tp];
        }
        if ((pw >> bit) & 1ull) {
          // a D-run from the highest zero Pv bit below the cursor
          uint64_t y = ~pw & qtt::mask_le(bit);
          int w = vr >> 6;
          while (!y && w > 0) {
            --w;
            y = ~pv[w * COLS + tp];
          }
          const int hz = y ? W * w + 63 - __clzll((long long)y) : -1;
          const int max_run = vr - v_ovl_rel + 1;
          const int run = min(vr - hz, max_run);
          sc += run;
          vr -= run;
          if (run == max_run) break;   // the window's exit, mid-run
          mw = mv[(vr >> 6) * COLS + tp];
          pc = pr[vr];
        }
        const bool is_i = (mw >> (vr & 63)) & 1ull;
        sc += (is_i || pc != tc) ? 1 : 0;
        vr -= is_i ? 0 : 1;
        hr -= 1;
      }
      hew += sc > a.hew_cells ? 1 : 0;
      score += sc;
      pos_v = v_min + vr;
      pos_h = h_min + hr;
    }
    pos_v = __shfl_sync(FULL, pos_v, seg * span);
    pos_h = __shfl_sync(FULL, pos_h, seg * span);
    __syncwarp();
  }
  if (FULLM && live && sl == 0) {
    // the boundary runs are the host's (expand_window_records)
    a.pos_v_out[b] = pos_v;
    a.pos_h_out[b] = pos_h;
  }
  if (!FULLM && live && sl == 0) {
    // boundary fill (bpm_windowed.c:599-627, score-only accounting)
    if (pos_h >= 0) score += pos_h + 1;
    if (pos_v >= 0) score += pos_v + 1;
    a.score_out[b] = score;
    a.hew_out[b] = hew;
  }
}

template <bool FULLM>
int launch_windowed(WindowedArgs a, int shared_bytes, cudaStream_t s) {
  const int span = a.span, WS = a.WS;
  const bool pow2 = span >= 1 && span <= 32 && (span & (span - 1)) == 0;
  if (WS < 1 || !pow2 || span < (WS < 32 ? WS : 32) || a.T < W * WS ||
      a.P < W * WS)
    return (int)cudaErrorInvalidValue;
  const int ppw = 32 / span;
  const int blocks = (a.B + ppw - 1) / ppw;
  if (shared_bytes > 0) {
    a.pair_bytes = shared_pair_bytes(WS);
    if ((size_t)shared_bytes != ppw * a.pair_bytes)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        windowed_kernel<true, FULLM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e != cudaSuccess) return (int)e;
    windowed_kernel<true, FULLM><<<blocks, 32, shared_bytes, s>>>(a);
  } else {
    if (!a.scratch) return (int)cudaErrorInvalidValue;
    a.pair_bytes = scratch_pair_bytes(WS);
    windowed_kernel<false, FULLM><<<blocks, 32, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// span: lanes per pair (a power of 2, 1..32, at least min(ws, 32));
// shared_bytes: the CTA's dynamic shared memory, (32 / span) pairs of
// shared_pair_bytes(ws), or 0 for the scratch mode, where `scratch` holds
// scratch_pair_bytes(ws) bytes per pair.
extern "C" int qtt_windowed_score(const void* peq, const void* text_enc,
                                  const void* text_raw, const void* pat_raw,
                                  const void* plen, const void* tlen,
                                  const void* num_words, void* scratch,
                                  void* score, void* hew, int B, int KP,
                                  int T, int P, int WS, int OVL,
                                  int hew_cells, int span, int shared_bytes,
                                  void* stream) {
  if (B <= 0) return 0;
  WindowedArgs a{(const uint64_t*)peq, (const uint8_t*)text_enc,
                 (const int32_t*)text_raw, (const int32_t*)pat_raw,
                 (const int32_t*)plen, (const int32_t*)tlen,
                 (const int32_t*)num_words, (uint8_t*)scratch,
                 (int32_t*)score, (int32_t*)hew, B, KP, T, P, WS, OVL,
                 hew_cells, span, 0, nullptr, nullptr, nullptr, nullptr};
  return launch_windowed<false>(a, shared_bytes, (cudaStream_t)stream);
}

// The full mode: the same launch geometry; rec_run (int16) and rec_op
// (int8) are (B, MW, 64 * WS), zeroed by the caller, with MW =
// ceil((P + T) / (64 * max(WS - OVL, 1))) + 2; pos_v and pos_h (B,).
extern "C" int qtt_windowed_full(const void* peq, const void* text_enc,
                                 const void* text_raw, const void* pat_raw,
                                 const void* plen, const void* tlen,
                                 const void* num_words, void* scratch,
                                 void* rec_run, void* rec_op, void* pos_v,
                                 void* pos_h, int B, int KP, int T, int P,
                                 int WS, int OVL, int span, int shared_bytes,
                                 void* stream) {
  if (B <= 0) return 0;
  WindowedArgs a{(const uint64_t*)peq, (const uint8_t*)text_enc,
                 (const int32_t*)text_raw, (const int32_t*)pat_raw,
                 (const int32_t*)plen, (const int32_t*)tlen,
                 (const int32_t*)num_words, (uint8_t*)scratch, nullptr,
                 nullptr, B, KP, T, P, WS, OVL, 0, span, 0,
                 (int16_t*)rec_run, (int8_t*)rec_op, (int32_t*)pos_v,
                 (int32_t*)pos_h};
  return launch_windowed<true>(a, shared_bytes, (cudaStream_t)stream);
}

// The most dynamic shared memory a CTA of the shared-mode kernel may take
// on `device`: the card's opt-in limit less the kernel's static PEQ table.
extern "C" int qtt_windowed_max_shared(int device, int* bytes) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, windowed_kernel<true, false>);
  if (e != cudaSuccess) return (int)e;
  *bytes = optin - (int)fa.sharedSizeBytes;
  return 0;
}
