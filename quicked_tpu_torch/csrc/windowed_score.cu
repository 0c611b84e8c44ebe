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
// Design of the window fill (both modes):
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
//
// Score mode: the greedy backtrace is one lane per pair over that window:
// the whole D-run from the highest zero Pv bit at or below the cursor,
// then one I/M/X step. A column's Pv word, its Mv word and pattern
// character for the case of no D-run (the common one) are loaded
// together, so a column costs one shared-memory latency unless a D-run
// moves the cursor.
//
// Full mode (windowed_full_kernel): the output the caller needs, each
// pair's op bytes in final forward order, written by the kernel.
// - What bounded its first port (9.4 ms at 1,000 x 10 kbp, ws 9, 1.9% of
//   its bound): one warp per SM (two pairs' shared windows fill a CTA's
//   227 KB), a walk on one lane stepping a D-run row by row, and a dense
//   (B, MW, 64 ws) array of 3-byte column records, zeroed, permuted and
//   expanded to strings on the host (most of the call's wall).
// - A pair owns a whole warp (one warp per CTA). At ws 9 and up to 14
//   its window can sit in shared memory (one pair a CTA, two CTAs an
//   SM), or in the pair-major device-memory scratch, which the L2 mostly
//   holds, with every pair of a 1,000-pair batch resident at once (~8
//   warps an SM) to hide its latency; the wrapper picks (windowed_cuda.
//   windowed_full_geometry).
// - The walk: the warp stages a chunk of 32 columns at the cursor's
//   64-row block, lane l column c0 - l: its D word (Pv set, no match), M
//   word and I word (Mv set, no match) into shared memory, the match
//   words by two ballots a column over the block's raw pattern
//   characters, which the lanes hold two each. Lane 0 then walks the
//   chunk: a column with no D at the cursor is one M, I or X step taken
//   from three bits (M, D, I, X in that order), its words loaded a column
//   ahead; a D-run is the highest zero of the D word at or below the
//   cursor (one __clzll), and only a run that leaves the block goes back
//   to the warp, which builds the blocks below it the same way. The warp
//   stages again after 32 columns, when the cursor leaves the block, or to
//   flush the ring. (A walk on all 32 lanes in lockstep, every column's
//   words taken by shuffles, took more cycles a column: each column paid
//   the shuffles' latency and a reconvergence of the warp.)
// - The ops go into a 2 KB ring in shared memory from its end (the
//   reference's right-to-left buffer: a column's D-run, then its op; a
//   mid-run exit at the window's overlap edge writes only D's); the
//   leading boundary runs come last, 'I' * (pos_h + 1) then 'D' *
//   (pos_v + 1). Every 512 bytes the warp stores them to the pair's row
//   of the (B, LD) uint8 output, 16 bytes a lane, in final forward order;
//   the row's start offset goes to start[b]. LD >= P + T bounds every
//   pair (each op consumes a row or a column), so nothing is zeroed, and
//   a D-run has no length limit.
// The inputs arrive pair-major (the wrapper transposes the staged
// lane-minor batch), so a segment's staging loads are contiguous.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr unsigned FULL = 0xffffffffu;
constexpr int U = 8;                 // columns a lane fills per skew step
constexpr int RING = 2048;           // full mode: a pair's op ring, bytes
constexpr int FLUSH = 512;           // bytes stored at once: 16 a lane
constexpr int CHUNK = 33;            // a staged chunk's words a kind (+1)
constexpr int STAGE = RING + 1024;   // the ring and the chunk's 3 x 33 words

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
  uint8_t* ops;              // (B, LD), full mode
  int32_t* start;            // (B,), full mode
  int LD;
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

// A pair's window: the planes, the tail after them (characters in the
// shared mode, group carries in the scratch mode) and the characters'
// pointers for this window.
struct Window {
  uint64_t *pv, *mv;
  uint8_t* tail;
  const uint8_t* te;
  const int32_t *tr, *pr;
};

__device__ __forceinline__ Window window_at(const WindowedArgs& a,
                                            uint8_t* base, int bb) {
  Window w;
  const int COLS = W * a.WS;
  w.pv = reinterpret_cast<uint64_t*>(base);
  w.mv = w.pv + a.WS * COLS;
  w.tail = reinterpret_cast<uint8_t*>(w.mv + a.WS * COLS);
  w.te = a.text_enc + (size_t)bb * a.T;
  w.tr = a.text_raw + (size_t)bb * a.T;
  w.pr = a.pat_raw + (size_t)bb * a.P;
  return w;
}

// The window's characters from corner (v_min, h_min): staged into the
// shared tail by the segment's lanes, or pointers into the inputs.
template <bool SMEM>
__device__ __forceinline__ void window_chars(const WindowedArgs& a,
                                             const Window& w, Window& cur,
                                             bool act, int sl, int span,
                                             int v_min, int h_min) {
  const int COLS = W * a.WS;
  if (SMEM) {
    int32_t* s_tr = reinterpret_cast<int32_t*>(w.tail);
    int32_t* s_pr = s_tr + COLS;
    uint8_t* s_te = reinterpret_cast<uint8_t*>(s_pr + COLS);
    if (act) {
#pragma unroll 4
      for (int tp = sl; tp < COLS; tp += span) {
        s_te[tp] = __ldg(w.te + h_min + tp);
        s_tr[tp] = __ldg(w.tr + h_min + tp);
        s_pr[tp] = __ldg(w.pr + v_min + tp);
      }
    }
    cur.te = s_te;
    cur.tr = s_tr;
    cur.pr = s_pr;
    __syncwarp();
  } else {
    cur.te = w.te + h_min;
    cur.tr = w.tr + h_min;
    cur.pr = w.pr + v_min;
  }
}

// Window fill (bpm_windowed.c:202-280), no level masks, as a skew of U
// columns per step: Pv after and Mv before every column into the planes.
template <bool SMEM>
__device__ __forceinline__ void fill_window(const WindowedArgs& a,
                                            const Window& w,
                                            uint64_t (*peq_s)[5], int lane,
                                            int sl, int span, bool act,
                                            int nw, const uint64_t* peq,
                                            int v_min, int h_min) {
  const int WS = a.WS, COLS = W * WS, NQ = COLS / U;
  const int NG = (WS + span - 1) / span;    // groups of span blocks
  const int shift = v_min % W, v_block = v_min / W;
  const uint64_t p_init = h_min == 0 ? qtt::ONES : 0ull;
  const uint32_t first = v_min == 0 ? 0x5555u : 0u;   // ph = 1, U columns
  for (int g = 0; g < NG; ++g) {
    const int i = g * span + sl;                 // this lane's block
    const int nvalid = min(span, WS - g * span);
    const bool mine = act && sl < nvalid;
    // carries between groups, U columns a 16-bit word (scratch mode
    // only: ws > 32 > 14)
    const uint16_t* carry_in =
        reinterpret_cast<const uint16_t*>(w.tail + ((g + 1) & 1) * COLS);
    uint16_t* carry_out = reinterpret_cast<uint16_t*>(w.tail + (g & 1) * COLS);

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
    ulonglong2* pvi = reinterpret_cast<ulonglong2*>(w.pv + i * COLS);
    ulonglong2* mvi = reinterpret_cast<ulonglong2*>(w.mv + i * COLS);
    uint64_t P = p_init, M = 0;
    uint32_t cout = 0;            // carries out: ph | mh << 1, U columns
    const int steps = NQ + nvalid - 1;
    for (int s = 0; s < steps; ++s) {
      uint32_t cin = __shfl_up_sync(FULL, cout, 1, span);
      const int q = s - sl;       // columns U*q .. U*q + U-1
      if (mine && q >= 0 && q < NQ) {
        if (sl == 0) cin = g == 0 ? first : carry_in[q];
        const uint64_t cs = load_chars<SMEM>(w.te, U * q);
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
}

template <bool SMEM>
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
  const int WS = a.WS, COLS = W * WS;

  const Window win = window_at(
      a, SMEM ? smem + (size_t)seg * a.pair_bytes
              : a.scratch + (size_t)bb * a.pair_bytes, bb);
  const uint64_t *pv = win.pv, *mv = win.mv;
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
    Window cur = win;
    window_chars<SMEM>(a, win, cur, act, sl, span, v_min, h_min);
    fill_window<SMEM>(a, cur, peq_s, lane, sl, span, act, nw, peq, v_min,
                      h_min);
    const int32_t *tr = cur.tr, *pr = cur.pr;

    // greedy backtrace, score-only tie-break D, I, M, X. In the loop
    // 0 <= v_ovl_rel <= vr < COLS, and a D-run that does not exit the
    // window stops above v_ovl_rel, so no index needs clamping.
    if (act && sl == 0) {
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
  if (live && sl == 0) {
    // boundary fill (bpm_windowed.c:599-627, score-only accounting)
    if (pos_h >= 0) score += pos_h + 1;
    if (pos_v >= 0) score += pos_v + 1;
    a.score_out[b] = score;
    a.hew_out[b] = hew;
  }
}

// Full mode: a pair's op bytes, staged in a shared ring and stored to its
// output row from the end. Every member is the same on all 32 lanes.
struct OpRing {
  uint8_t* ring;   // RING bytes of shared memory, 16-byte aligned
  uint8_t* out;    // the pair's output row, 16-byte aligned
  int lo, hi;      // the row's bytes [lo, hi) wait in the ring; hi % 16 == 0
};

// Store the ring's top FLUSH bytes while FLUSH or more wait.
__device__ __forceinline__ void ring_flush(OpRing& r, int lane) {
  while (r.hi - r.lo >= FLUSH) {
    __syncwarp();
    const int p = r.hi - FLUSH + 16 * lane;
    *reinterpret_cast<uint4*>(r.out + p) =
        *reinterpret_cast<const uint4*>(r.ring + (p & (RING - 1)));
    r.hi -= FLUSH;
  }
}

// n copies of byte ch below the ring's lowest byte, the lanes in turn.
__device__ __forceinline__ void emit_run(OpRing& r, int lane, uint8_t ch,
                                         int n) {
  while (n > 0) {
    const int k = min(n, RING - FLUSH);
    for (int i = lane; i < k; i += 32) r.ring[(r.lo - 1 - i) & (RING - 1)] = ch;
    r.lo -= k;
    n -= k;
    ring_flush(r, lane);
  }
}

// One op byte below the ring's lowest byte.
__device__ __forceinline__ void emit_op(OpRing& r, int lane, uint8_t ch) {
  if (lane == 0) r.ring[(r.lo - 1) & (RING - 1)] = ch;
  r.lo -= 1;
  ring_flush(r, lane);
}

// The 64-bit match word of a column against one 64-row block: bit k is
// set where the block's raw pattern row k (p0 on lane k, p1 on lane k - 32)
// equals the column's raw text character tc (the same on every lane).
__device__ __forceinline__ uint64_t match_word(int p0, int p1, int tc) {
  const uint32_t lo = __ballot_sync(FULL, p0 == tc);
  const uint32_t hi = __ballot_sync(FULL, p1 == tc);
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

template <bool SMEM>
__global__ void __launch_bounds__(32) windowed_full_kernel(
    const WindowedArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint64_t peq_s[32][5];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int WS = a.WS, COLS = W * WS;
  const Window win = window_at(
      a, SMEM ? smem + STAGE : a.scratch + (size_t)b * a.pair_bytes, b);
  uint64_t* chunk = reinterpret_cast<uint64_t*>(smem + RING);
  const uint64_t* peq = a.peq + (size_t)b * a.KP * 5;
  const int nw = a.num_words[b];
  const int stride = W * max(WS - a.OVL, 1);
  const int max_windows = (a.P + a.T + stride - 1) / stride + 2;
  int pos_v = a.plen[b] - 1, pos_h = a.tlen[b] - 1;
  OpRing r{smem, a.ops + (size_t)b * a.LD, a.LD, a.LD};

  for (int it = 0; it < max_windows && pos_v >= 0 && pos_h >= 0; ++it) {
    const int v_min = max(pos_v - COLS + 1, 0);
    const int h_min = max(pos_h - COLS + 1, 0);
    Window cur = win;
    window_chars<SMEM>(a, win, cur, true, lane, 32, v_min, h_min);
    fill_window<SMEM>(a, cur, peq_s, lane, lane, 32, true, nw, peq, v_min,
                      h_min);
    const uint64_t *pv = cur.pv, *mv = cur.mv;
    const int32_t *tr = cur.tr, *pr = cur.pr;

    // greedy backtrace, tie-break M, D, I, X
    const int v_ovl_rel = max(pos_v - W * (WS - a.OVL) + 1, 0) - v_min;
    const int h_ovl_rel = max(pos_h - W * (WS - a.OVL) + 1, 0) - h_min;
    int vr = pos_v - v_min, hr = pos_h - h_min;
    int wb = -1, c0 = -1;          // the staged chunk: block, top column
    while (hr >= 0 && vr >= v_ovl_rel && hr >= h_ovl_rel) {
      if ((vr >> 6) != wb || hr < c0 - 31) {
        // stage the chunk of columns hr, hr - 1, .. hr - 31 at the
        // cursor's block, lane l's column c0 - l: its D word (Pv set, no
        // match), M word and I word (Mv set, no match)
        wb = vr >> 6;
        c0 = hr;
        const int cl = c0 - lane, row = wb * W;
        const bool in = cl >= 0;
        const uint64_t pw = in ? pv[wb * COLS + cl] : 0ull;
        const uint64_t mw = in ? mv[wb * COLS + cl] : 0ull;
        const int tcl = in ? tr[cl] : -3;
        const int p0 = pr[row + lane], p1 = pr[row + 32 + lane];
        uint64_t m_l = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const uint64_t mk = match_word(p0, p1, __shfl_sync(FULL, tcl, k));
          if (lane == k) m_l = mk;
        }
        __syncwarp();
        chunk[lane] = pw & ~m_l;
        chunk[CHUNK + lane] = m_l;
        chunk[2 * CHUNK + lane] = mw & ~m_l;
        __syncwarp();
      }
      // lane 0 walks the chunk while the cursor stays in its block, no
      // D-run leaves the block and fewer than FLUSH bytes wait: a
      // column's words are shared loads issued a column ahead, and a
      // column with no D at the cursor (the common case) takes no branch
      // but the loop's
      int stop = 0;   // 1: the window's exit, mid-run; 2: a D-run below
      if (lane == 0) {
        const int jmax = min(32, c0 - h_ovl_rel + 1);
        const int vlow = max(v_ovl_rel, wb * W), lo_stop = r.hi - FLUSH;
        int j = c0 - hr, lo = r.lo;
        for (;;) {
          // the columns with no D at the cursor: an M, I or X step each
          uint64_t d = chunk[j], m = chunk[CHUNK + j];
          uint64_t iw = chunk[2 * CHUNK + j];
          while (j < jmax && vr >= vlow && lo > lo_stop &&
                 !((uint32_t)(d >> (vr & 63)) & 1u)) {
            const uint64_t dn = chunk[j + 1], mn = chunk[CHUNK + j + 1],
                           iwn = chunk[2 * CHUNK + j + 1];
            const int bit = vr & 63;
            const int is_i = (int)(iw >> bit) & 1, is_m = (int)(m >> bit) & 1;
            r.ring[(lo - 1) & (RING - 1)] = is_m ? 'M' : (is_i ? 'I' : 'X');
            --lo;
            vr += is_i - 1;
            --hr;
            ++j;
            d = dn;
            m = mn;
            iw = iwn;
          }
          if (!(j < jmax && vr >= vlow && lo > lo_stop)) break;
          // a D at the cursor: the D-run, down to the highest zero of the
          // D word, then the column's step
          const int bit = vr & 63;
          const uint64_t y = ~d & qtt::mask_le(bit);
          const int hz = y ? wb * W + 63 - __clzll((long long)y) : wb * W - 1;
          if (!y && hz >= v_ovl_rel) {
            stop = 2;
            break;
          }
          const int max_run = vr - v_ovl_rel + 1;
          const int run = min(vr - hz, max_run);
          for (int k = 1; k <= run; ++k) r.ring[(lo - k) & (RING - 1)] = 'D';
          lo -= run;
          vr -= run;
          if (run == max_run) {
            stop = 1;
            break;
          }
          const int is_i = (int)(iw >> (vr & 63)) & 1;
          const int is_m = (int)(m >> (vr & 63)) & 1;
          r.ring[(lo - 1) & (RING - 1)] = is_m ? 'M' : (is_i ? 'I' : 'X');
          --lo;
          vr += is_i - 1;
          --hr;
          ++j;
        }
        r.lo = lo;
      }
      vr = __shfl_sync(FULL, vr, 0);
      hr = __shfl_sync(FULL, hr, 0);
      r.lo = __shfl_sync(FULL, r.lo, 0);
      stop = __shfl_sync(FULL, stop, 0);
      if (stop == 2) {
        // the D-run leaves the chunk's block: each block's words and
        // match word below it, down to the block of the overlap edge (a
        // run past that edge exits the window), on every lane
        const int tc = tr[hr];
        int hz = -1;
        uint64_t m = 0, iw = 0;
        for (int w = wb - 1; w >= (v_ovl_rel >> 6); --w) {
          m = match_word(pr[w * W + lane], pr[w * W + 32 + lane], tc);
          const uint64_t y = ~(pv[w * COLS + hr] & ~m);
          if (y) {
            hz = w * W + 63 - __clzll((long long)y);
            iw = mv[w * COLS + hr] & ~m;
            break;
          }
        }
        const int max_run = vr - v_ovl_rel + 1;
        const int run = min(vr - hz, max_run);
        emit_run(r, lane, 'D', run);
        vr -= run;
        if (run == max_run) break;   // the window's exit, mid-run
        const int vb = vr & 63;
        const bool is_m = (m >> vb) & 1ull;
        const bool is_i = !is_m && ((iw >> vb) & 1ull);
        emit_op(r, lane, is_m ? 'M' : (is_i ? 'I' : 'X'));
        vr -= is_i ? 0 : 1;
        hr -= 1;
      }
      ring_flush(r, lane);
      if (stop == 1) break;          // the window's exit, mid-run
    }
    pos_v = v_min + vr;
    pos_h = h_min + hr;
    __syncwarp();
  }
  // the boundary runs (bpm_windowed.c:599-627), first in forward order
  emit_run(r, lane, 'I', max(pos_h + 1, 0));
  emit_run(r, lane, 'D', max(pos_v + 1, 0));
  // the rest, from the 16-byte boundary at or below the first op (the
  // bytes below it are unspecified)
  __syncwarp();
  for (int p = (r.lo & ~15) + 16 * lane; p < r.hi; p += 16 * 32)
    *reinterpret_cast<uint4*>(r.out + p) =
        *reinterpret_cast<const uint4*>(r.ring + (p & (RING - 1)));
  if (lane == 0) a.start[b] = r.lo;
}

int launch_score(WindowedArgs a, int shared_bytes, cudaStream_t s) {
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
        windowed_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (e != cudaSuccess) return (int)e;
    windowed_kernel<true><<<blocks, 32, shared_bytes, s>>>(a);
  } else {
    if (!a.scratch) return (int)cudaErrorInvalidValue;
    a.pair_bytes = scratch_pair_bytes(WS);
    windowed_kernel<false><<<blocks, 32, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

int launch_full(WindowedArgs a, int shared_bytes, cudaStream_t s) {
  const int WS = a.WS;
  if (WS < 1 || a.T < W * WS || a.P < W * WS || a.LD % 16 != 0 ||
      (long long)a.LD < (long long)a.P + a.T)
    return (int)cudaErrorInvalidValue;
  if (shared_bytes > STAGE) {
    a.pair_bytes = shared_pair_bytes(WS);
    if ((size_t)shared_bytes != STAGE + a.pair_bytes)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        windowed_full_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (e != cudaSuccess) return (int)e;
    windowed_full_kernel<true><<<a.B, 32, shared_bytes, s>>>(a);
  } else {
    if (!a.scratch || shared_bytes != STAGE)
      return (int)cudaErrorInvalidValue;
    a.pair_bytes = scratch_pair_bytes(WS);
    windowed_full_kernel<false><<<a.B, 32, STAGE, s>>>(a);
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
                 hew_cells, span, 0, nullptr, nullptr, 0};
  return launch_score(a, shared_bytes, (cudaStream_t)stream);
}

// The full mode, a pair a warp: ops (uint8, (B, LD), LD a multiple of 16
// and at least P + T) gets each pair's op bytes in forward order at
// [start[b], LD) (start int32 (B,)); nothing below start[b] is
// specified. shared_bytes: 3,072 (the op ring and the walk's staged
// chunk) plus shared_pair_bytes(ws) to keep the window in shared memory,
// or 3,072 alone for the scratch mode, where `scratch` holds
// scratch_pair_bytes(ws) bytes per pair.
extern "C" int qtt_windowed_full(const void* peq, const void* text_enc,
                                 const void* text_raw, const void* pat_raw,
                                 const void* plen, const void* tlen,
                                 const void* num_words, void* scratch,
                                 void* ops, void* start, int B, int KP,
                                 int T, int P, int WS, int OVL, int LD,
                                 int shared_bytes, void* stream) {
  if (B <= 0) return 0;
  WindowedArgs a{(const uint64_t*)peq, (const uint8_t*)text_enc,
                 (const int32_t*)text_raw, (const int32_t*)pat_raw,
                 (const int32_t*)plen, (const int32_t*)tlen,
                 (const int32_t*)num_words, (uint8_t*)scratch, nullptr,
                 nullptr, B, KP, T, P, WS, OVL, 0, 32, 0, (uint8_t*)ops,
                 (int32_t*)start, LD};
  return launch_full(a, shared_bytes, (cudaStream_t)stream);
}

// The most dynamic shared memory a CTA of either mode's shared-memory
// kernel may take on `device`: the card's opt-in limit less the larger
// static PEQ table of the two.
extern "C" int qtt_windowed_max_shared(int device, int* bytes) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fs, ff;
  e = cudaFuncGetAttributes(&fs, windowed_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncGetAttributes(&ff, windowed_full_kernel<true>);
  if (e != cudaSuccess) return (int)e;
  const size_t st =
      fs.sharedSizeBytes > ff.sharedSizeBytes ? fs.sharedSizeBytes
                                              : ff.sharedSizeBytes;
  *bytes = optin - (int)st;
  return 0;
}
