// Batched banded Myers fill, score-only and full (traceback) variants:
// one warp per pair, the band's carry chain resolved by a carry-map scan.
//
// Replaces the Pallas TPU kernel quicked_tpu/ops/banded_pallas.py:_kernel
// (launched by _pallas_banded, FULL=False and FULL=True) and its XLA twin
// banded_jax.py:banded_scan_impl + _maintenance. Same outputs: the scores
// window, final Pv/Mv band, first/last live block and, for FULL, one
// Pv/Mv band snapshot per text column (column 63 of every 64-column block
// stored after the band cut/shift).
//
// What bounds it on the H100: the operations, about 30 32-bit ones per
// 64-row Myers advance, one advance per live band block per column; for
// FULL the band snapshots (16 bytes per block per column) are the bytes.
// Per column the live blocks of a pair form a carry chain (block i's
// carry-in is block i-1's carry-out), so a pair is a latency chain: one
// thread per pair walking it with the band in device memory left a batch
// on 2-13 warps.
//
// Design: a pair's band is spread over a warp. Thread t owns the stripe
// of S contiguous band blocks [t*S, t*S+S) (S = 1, 2 or 4: EBB <= 32*S),
// and keeps their Pv/Mv words, score rows, level masks and the five PEQ
// words of each block in registers; PAIRS_PER_CTA pairs share a CTA. Per
// column:
//   1. each thread advances its blocks under carry-ins Z and M (two
//      independent advances per block) and composes the blocks' carry
//      maps into its stripe's map; blocks below `first` map to constant P
//      (the chain enters `first` with PHin=1);
//   2. the stripe maps are resolved into each stripe's carry-in: only
//      whether a carry is M decides the next carry-out, and a map acts
//      on that bit as a constant, the identity or the negation, so three
//      __ballot_sync and a few bit operations give every stripe's
//      carry-in (m_in) where a 5-step shuffle scan of the maps would
//      chain five shuffle latencies; no barrier;
//   3. each live block takes its real result: the M advance for carry M,
//      the Z advance for Z, and for P the Z advance with bit 0 of Pv/Mv
//      fixed (P and Z differ only in the carry shifted into bit 0).
// Staged once per 64-column block, not per column: the PEQ and level-mask
// words of the thread's blocks (their shifted-frame rows move by one per
// block), and the block's 64 text characters, read once by the warp and
// held as three 64-bit planes by __ballot_sync. Every 64 columns the band
// cut/shift of banded_jax.py:_maintenance runs on the pair's scores
// window and boundary Pv/Mv words in shared memory, with the edge scores
// read after the sweep as the Pallas kernel reads them; the window roll
// is a register shift, and the row that leaves the window is stored.
//
// Bands deeper than 128 blocks (stage-4 full buckets are not capped) take
// several warps per pair (S = 4, at most MAX_WARPS warps): one map per
// warp (its carry-out for a carry-in of P and of M) goes to shared memory
// and one barrier per column carries it across warps, as
// csrc/banded_cscan.cu does. Bands deeper than MAX_WARPS warps hold
// (MAX_RESIDENT blocks; lopsided pairs and very long reads reach them)
// are walked in rounds of MAX_RESIDENT blocks per column by
// banded_fill_stream_kernel, MAX_WARPS warps per pair: the carry out of
// one round enters the next, and the band lives in device memory, Pv/Mv
// in the pv/mv outputs and the scores window in scores_by_k (window row r
// of block nb is row nb + r), each round loading its stripes and storing
// their live blocks, so that no register array grows with the band. It
// is a kernel of its own: the register modes' code generation (no spill,
// their speed) moved with every edit of a shared body.
//
// FULL snapshots keep the (T, EBB, B) layout that csrc/banded_traceback.cu
// reads: each 8-byte store of a warp lands in its own 32-byte sector, and
// the pairs of a CTA fill neighbouring words of it. A snapshot stores zero
// in the rows outside the column's live band ([first, last] during the
// sweep; for column 63, the band before and after the cut/shift), as the
// host C fill writes them, where the XLA scan leaves stale words: the
// traceback reads such a row when its path leaves the band.

#include "qtt_common.cuh"

namespace {

using qtt::apply;
using qtt::compose;
using qtt::M_ST;
using qtt::m_in;
using qtt::mk;
using qtt::out_state;
using qtt::P_ST;
using qtt::pick;
using qtt::W;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int PAIRS_PER_CTA = 4;    // one warp each, EBB <= 128
constexpr int MULTI_S = 4;          // stripe of the several-warp modes
constexpr int MAX_WARPS = 16;       // warps of one pair
// band blocks MAX_WARPS warps hold in registers; deeper bands stream
constexpr int MAX_RESIDENT = 32 * MULTI_S * MAX_WARPS;

// u64 words of a pair's shared region: boundary Pv and Mv words of its
// tpp threads (plus one sentinel each) and its EBB+1 window scores.
__host__ __device__ inline int region_words(int tpp, int EBB) {
  return 2 * (tpp + 1) + (EBB + 2) / 2;
}

template <int S, bool MULTI, bool FULL>
__global__ void __launch_bounds__(MULTI ? 32 * MAX_WARPS
                                        : 32 * PAIRS_PER_CTA)
banded_fill_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text,    // (NB*64, B)
    const int32_t* __restrict__ init,    // (EBB+1, B)
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (NB+EBB+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    uint64_t* __restrict__ mat_pv, uint64_t* __restrict__ mat_mv,
    int64_t* __restrict__ work,          // (B,) or null: live block-columns
    int B, int EBB, int NB) {
  extern __shared__ uint64_t smem[];
  __shared__ int warp_map[2][MULTI ? MAX_WARPS : 1];   // by column parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpp = MULTI ? blockDim.x : 32;      // threads of one pair
  const int tid = MULTI ? threadIdx.x : lane;   // thread within the pair
  const int b = MULTI ? blockIdx.x : blockIdx.x * PAIRS_PER_CTA + warp;
  if (b >= B) return;     // a whole warp (one pair per warp here)
  uint64_t* sh_pv = smem + (size_t)(MULTI ? 0 : warp) *
                               region_words(tpp, EBB);
  uint64_t* sh_mv = sh_pv + tpp + 1;
  int* sh_sc = reinterpret_cast<int*>(sh_mv + tpp + 1);
  auto sync = [&]() {
    if (MULTI)
      __syncthreads();
    else
      __syncwarp();
  };
  const size_t Bs = (size_t)B;
  auto at = [&](long r) { return (size_t)r * Bs + b; };
  const int i0 = tid * S;

  uint64_t pv[S], mv[S], eqw[S][5], lmv[S];
  int sc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    pv[s] = qtt::ONES;
    mv[s] = 0;
    sc[s] = i0 + s < EBB ? init[at(i0 + s)] : 0;
  }
  int sc_top = init[at(EBB)];     // window row EBB, the same in every thread
  int first = first0[b], last = last0[b];
  const int tfin = tfinish[b], pro = prolog[b], co = cutoff[b];
  const int fv = finish_v[b], nbr_b = nbr[b];
  const int clamp_at = FULL ? nbr_b - 1 : nbr_b;
  long long advances = 0;
  if (tid == 0) {
    sh_pv[tpp] = qtt::ONES;
    sh_mv[tpp] = 0;
  }

  // band snapshots: this thread's rows of column t start at
  // snap + t * col_stride, one row every Bs words
  const size_t col_stride = (size_t)EBB * Bs;
  const size_t snap = (size_t)i0 * Bs + b;
  // rows outside [lo, hi] are stored as zero (see the note on FULL)
  auto snapshot = [&](long t, int lo, int hi) {
    uint64_t* spv = mat_pv + snap + (size_t)t * col_stride;
    uint64_t* smv = mat_mv + snap + (size_t)t * col_stride;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = i0 + s;
      if (i < EBB) {
        if (i >= lo && i <= hi) {
          spv[s * Bs] = pv[s];
          smv[s * Bs] = mv[s];
        } else {
          spv[s * Bs] = 0;
          smv[s * Bs] = 0;
        }
      }
    }
  };

  for (int nb = 0; nb < NB; ++nb) {
    // ---- stage the block: text planes, PEQ and level-mask words ----
    const int c_lo = text[at((long)nb * W + lane)];
    const int c_hi = text[at((long)nb * W + 32 + lane)];
    uint64_t plane[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      plane[k] = (uint64_t)__ballot_sync(FULL_MASK, (c_lo >> k) & 1) |
                 ((uint64_t)__ballot_sync(FULL_MASK, (c_hi >> k) & 1) << 32);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = i0 + s;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        eqw[s][c] = i < EBB ? peq[((size_t)(nb + i) * 5 + c) * Bs + b]
                            : qtt::ONES;
      lmv[s] = i < EBB ? lm[at(nb + i)] : qtt::TOPBIT;
    }
    const bool live = max(first, 0) <= min(last, EBB - 1);
    if (live)
      advances += (long long)(min(last, EBB - 1) - max(first, 0) + 1) *
                  max(min(tfin - nb * W, W), 0);

    for (int j = 0; j < W; ++j) {
      const long t = (long)nb * W + j;
      if (t < tfin && live) {         // the same in every thread of a pair
        const int c = (int)((plane[0] >> j) & 1) |
                      (int)(((plane[1] >> j) & 1) << 1) |
                      (int)(((plane[2] >> j) & 1) << 2);
        // 1. the Z and M advances of each block; stripe map
        uint64_t zp[S], zm[S], mp[S], mm[S];
        int raw[S], agg = 0;
        unsigned xv0 = 0;   // bit s: bit 0 of Eq | Mv of block s (for P)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const uint64_t e = pick(eqw[s], c);
          xv0 |= (unsigned)((e | mv[s]) & 1ull) << s;
          zp[s] = mp[s] = pv[s];
          zm[s] = mm[s] = mv[s];
          uint32_t zph = 0, zmh = 0, mph = 0, mmh = 1;
          qtt::advance_block(e, lmv[s], zp[s], zm[s], zph, zmh);
          qtt::advance_block(e, lmv[s], mp[s], mm[s], mph, mmh);
          raw[s] = mk(out_state(zph, zmh), out_state(mph, mmh));
          const int map = i0 + s < first ? mk(P_ST, P_ST) : raw[s];
          agg = s == 0 ? map : compose(map, agg);
        }
        // 2. the carry into each stripe, from three ballots (m_in)
        const int A = qtt::img_a(agg), Bm = qtt::img_b(agg);
        const bool am = A == M_ST, bm = Bm == M_ST;
        const unsigned R = __ballot_sync(FULL_MASK, am == bm);
        const unsigned V = __ballot_sync(FULL_MASK, am && bm);
        const unsigned N = __ballot_sync(FULL_MASK, am && !bm);
        int cw = P_ST;                  // the carry into this warp
        if (MULTI) {
          if (lane == 31)
            warp_map[j & 1][warp] = mk(m_in(R, V, N, 31, 0) ? Bm : A,
                                       m_in(R, V, N, 31, 1) ? Bm : A);
          __syncthreads();
          for (int w = 0; w < warp; ++w)
            cw = apply(warp_map[j & 1][w], cw);
        }
        const int out = m_in(R, V, N, lane, cw == M_ST) ? Bm : A;
        const int up = __shfl_up_sync(FULL_MASK, out, 1);
        int carry = lane > 0 ? up : cw;
        // 3. each live block takes the advance of its real carry-in
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = i0 + s;
          if (i >= first && i <= last && i < EBB) {
            const int out = carry == M_ST ? qtt::img_b(raw[s])
                                          : qtt::img_a(raw[s]);
            sc[s] += (out == P_ST) - (out == M_ST);
            if (carry == M_ST) {
              pv[s] = mp[s];
              mv[s] = mm[s];
            } else if (carry == P_ST) {
              mv[s] = zm[s] | ((xv0 >> s) & 1u);
              pv[s] = zp[s] & ~1ull;
            } else {
              pv[s] = zp[s];
              mv[s] = zm[s];
            }
          }
          carry = apply(i < first ? mk(P_ST, P_ST) : raw[s], carry);
        }
      }
      if (FULL && j < W - 1) snapshot(t, first, last);
    }

    // ---- band cut/shift (banded_jax.py:_maintenance), window roll ----
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (i0 + s < EBB) sh_sc[i0 + s] = sc[s];
    if (tid == 0) sh_sc[EBB] = sc_top;
    sh_pv[tid] = pv[0];
    sh_mv[tid] = mv[0];
    sync();
    auto cap = [&](int r) { return sh_sc[min(max(r, 0), EBB - 1)]; };
    const int c_first1 = cap(first + 1), c_last1 = cap(last - 1);
    const int c_last = cap(last);
    const bool do_shift = (long)(nb + 1) * W <= tfin;
    const bool cut_lower = (first + 2 < last) && (fv > W * (first + 1)) &&
                           (c_first1 + (fv - W * (first + 1)) > co);
    const int old_first = first, old_last = last;
    bool write_top = false;
    if (do_shift) {
      if (cut_lower && nb >= pro) ++first;
      if (!cut_lower && nb < pro) --first;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = i0 + s;
        if (i >= first && i < last && i + 1 < EBB) {
          pv[s] = s + 1 < S ? pv[s + 1] : sh_pv[tid + 1];
          mv[s] = s + 1 < S ? mv[s + 1] : sh_mv[tid + 1];
        } else if (i == last && i < EBB) {
          pv[s] = qtt::ONES;
          mv[s] = 0;
        }
      }
      write_top = last + 1 >= 0 && last + 1 <= EBB;
      const bool cut_higher = (first + 2 < last) &&
                              (W * (last - 1) > fv) &&
                              (c_last1 + (W * (last - 1) - fv) > co);
      if (cut_higher || nb - pro + last >= clamp_at) --last;
    }
    // window row r after the cut's write of row old_last + 1
    auto row = [&](int r) {
      return write_top && r == old_last + 1 ? c_last + W : sh_sc[r];
    };
    if (tid == 0) scores[at(nb)] = row(0);     // leaves the window
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (i0 + s < EBB) sc[s] = row(i0 + s + 1);
    sc_top = (nb + 1 + EBB - pro + 1) * W;
    sync();     // every read of the shared region is done
    if (FULL)
      snapshot((long)nb * W + W - 1, min(old_first, first), old_last);
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int i = i0 + s;
    if (i < EBB) {
      pv_out[at(i)] = pv[s];
      mv_out[at(i)] = mv[s];
      scores[at(NB + i)] = sc[s];
    }
  }
  if (tid == 0) {
    scores[at(NB + EBB)] = sc_top;
    first_out[b] = first;
    last_out[b] = last;
    if (work) work[b] = advances;
  }
}

// Bands over MAX_RESIDENT blocks: the several-warp mode with the band in
// device memory (pv/mv outputs; window row r of block nb is scores_by_k
// row nb + r), walked in rounds of MAX_RESIDENT blocks per column.
template <bool FULL>
__global__ void __launch_bounds__(32 * MAX_WARPS)
banded_fill_stream_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text,    // (NB*64, B)
    const int32_t* __restrict__ init,    // (EBB+1, B)
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (NB+EBB+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    uint64_t* __restrict__ mat_pv, uint64_t* __restrict__ mat_mv,
    int64_t* __restrict__ work,          // (B,) or null: live block-columns
    int B, int EBB, int NB) {
  constexpr int S = MULTI_S;
  // carry maps by barrier parity: one barrier per round publishes them
  __shared__ int warp_map[2][MAX_WARPS];
  // first and last before the cut/shift, for column 63's snapshot: in
  // shared memory, since this instantiation sits at the 128-register cap
  __shared__ int band0[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpp = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const size_t Bs = (size_t)B;
  auto at = [&](long r) { return (size_t)r * Bs + b; };
  const int i0 = tid * S;
  const int seg = tpp * S;                      // band blocks of a round
  const int rounds = (EBB + seg - 1) / seg;

  for (int i = tid; i < EBB; i += tpp) {
    pv_out[at(i)] = qtt::ONES;
    mv_out[at(i)] = 0;
  }
  for (int r = tid; r <= EBB; r += tpp) scores[at(r)] = init[at(r)];
  __syncthreads();
  int first = first0[b], last = last0[b];
  const int tfin = tfinish[b], pro = prolog[b], co = cutoff[b];
  const int fv = finish_v[b], nbr_b = nbr[b];
  const int clamp_at = FULL ? nbr_b - 1 : nbr_b;
  long long advances = 0;

  uint64_t pv[S], mv[S], lmv[S];
  int sc[S];
  // the stripe at s0; with `sweep`, also its window scores and level
  // masks for block nb
  auto load = [&](int s0, int nb, bool sweep) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = s0 + s;
      const bool in = i < EBB;
      pv[s] = in ? pv_out[at(i)] : qtt::ONES;
      mv[s] = in ? mv_out[at(i)] : 0;
      if (sweep) {
        sc[s] = in ? scores[at(nb + i)] : 0;
        lmv[s] = in ? lm[at(nb + i)] : qtt::TOPBIT;
      }
    }
  };
  const size_t col_stride = (size_t)EBB * Bs;
  // rows outside [lo, hi] are stored as zero (see the note on FULL)
  auto snapshot = [&](long t, int s0, int lo, int hi) {
    uint64_t* spv = mat_pv + (size_t)s0 * Bs + b + (size_t)t * col_stride;
    uint64_t* smv = mat_mv + (size_t)s0 * Bs + b + (size_t)t * col_stride;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int i = s0 + s;
      if (i < EBB) {
        if (i >= lo && i <= hi) {
          spv[s * Bs] = pv[s];
          smv[s * Bs] = mv[s];
        } else {
          spv[s * Bs] = 0;
          smv[s * Bs] = 0;
        }
      }
    }
  };

  for (int nb = 0; nb < NB; ++nb) {
    const int c_lo = text[at((long)nb * W + lane)];
    const int c_hi = text[at((long)nb * W + 32 + lane)];
    uint64_t plane[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      plane[k] = (uint64_t)__ballot_sync(FULL_MASK, (c_lo >> k) & 1) |
                 ((uint64_t)__ballot_sync(FULL_MASK, (c_hi >> k) & 1) << 32);
    const bool live = max(first, 0) <= min(last, EBB - 1);
    if (live)
      advances += (long long)(min(last, EBB - 1) - max(first, 0) + 1) *
                  max(min(tfin - nb * W, W), 0);

    for (int j = 0; j < W; ++j) {
      const long t = (long)nb * W + j;
      const bool act = t < tfin && live;   // the same in every thread
      const int c = (int)((plane[0] >> j) & 1) |
                    (int)(((plane[1] >> j) & 1) << 1) |
                    (int)(((plane[2] >> j) & 1) << 2);
      int rc = P_ST;      // the carry into the round's lowest block
      for (int r = 0; r < rounds; ++r) {
        const int s0 = r * seg + i0;
        const int par = (j * rounds + r) & 1;
        if (act || FULL) load(s0, nb, act);
        if (act) {
          // 1. the Z and M advances of each block; stripe map
          uint64_t zp[S], zm[S], mp[S], mm[S];
          int raw[S], agg = 0;
          unsigned xv0 = 0;   // bit s: bit 0 of Eq | Mv of block s (for P)
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int i = s0 + s;
            const uint64_t e = i < EBB
                                   ? peq[((size_t)(nb + i) * 5 + c) * Bs + b]
                                   : qtt::ONES;
            xv0 |= (unsigned)((e | mv[s]) & 1ull) << s;
            zp[s] = mp[s] = pv[s];
            zm[s] = mm[s] = mv[s];
            uint32_t zph = 0, zmh = 0, mph = 0, mmh = 1;
            qtt::advance_block(e, lmv[s], zp[s], zm[s], zph, zmh);
            qtt::advance_block(e, lmv[s], mp[s], mm[s], mph, mmh);
            raw[s] = mk(out_state(zph, zmh), out_state(mph, mmh));
            const int map = i < first ? mk(P_ST, P_ST) : raw[s];
            agg = s == 0 ? map : compose(map, agg);
          }
          // 2. the carry into each stripe: warp ballots, then the maps of
          // the warps below and of the rounds below
          const int A = qtt::img_a(agg), Bm = qtt::img_b(agg);
          const bool am = A == M_ST, bm = Bm == M_ST;
          const unsigned R = __ballot_sync(FULL_MASK, am == bm);
          const unsigned V = __ballot_sync(FULL_MASK, am && bm);
          const unsigned N = __ballot_sync(FULL_MASK, am && !bm);
          if (lane == 31)
            warp_map[par][warp] = mk(m_in(R, V, N, 31, 0) ? Bm : A,
                                     m_in(R, V, N, 31, 1) ? Bm : A);
          __syncthreads();
          int cw = rc;                    // the carry into this warp
          for (int w = 0; w < warp; ++w) cw = apply(warp_map[par][w], cw);
          for (int w = 0; w < tpp / 32; ++w)
            rc = apply(warp_map[par][w], rc);
          const int out = m_in(R, V, N, lane, cw == M_ST) ? Bm : A;
          const int up = __shfl_up_sync(FULL_MASK, out, 1);
          int carry = lane > 0 ? up : cw;
          // 3. each live block takes the advance of its real carry-in
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int i = s0 + s;
            if (i >= first && i <= last && i < EBB) {
              const int out = carry == M_ST ? qtt::img_b(raw[s])
                                            : qtt::img_a(raw[s]);
              sc[s] += (out == P_ST) - (out == M_ST);
              if (carry == M_ST) {
                pv[s] = mp[s];
                mv[s] = mm[s];
              } else if (carry == P_ST) {
                mv[s] = zm[s] | ((xv0 >> s) & 1u);
                pv[s] = zp[s] & ~1ull;
              } else {
                pv[s] = zp[s];
                mv[s] = zm[s];
              }
              pv_out[at(i)] = pv[s];
              mv_out[at(i)] = mv[s];
              scores[at(nb + i)] = sc[s];
            }
            carry = apply(i < first ? mk(P_ST, P_ST) : raw[s], carry);
          }
        }
        if (FULL && j < W - 1) snapshot(t, s0, first, last);
      }
    }

    // ---- band cut/shift (banded_jax.py:_maintenance) ----
    __syncthreads();      // the sweep's stores are visible
    auto cap = [&](int r) {
      return scores[at(nb + min(max(r, 0), EBB - 1))];
    };
    const int c_first1 = cap(first + 1), c_last1 = cap(last - 1);
    const int c_last = cap(last);
    const bool do_shift = (long)(nb + 1) * W <= tfin;
    const bool cut_lower = (first + 2 < last) && (fv > W * (first + 1)) &&
                           (c_first1 + (fv - W * (first + 1)) > co);
    if (FULL && tid == 0) {
      band0[0] = first;
      band0[1] = last;
    }
    __syncthreads();      // every read of the window is done
    if (do_shift) {
      if (cut_lower && nb >= pro) ++first;
      if (!cut_lower && nb < pro) --first;
      for (int r = 0; r < rounds; ++r) {
        const int s0 = r * seg + i0;
        load(s0, nb, false);
        const int nx = s0 + S;      // the next stripe's lowest block
        const uint64_t npv = nx < EBB ? pv_out[at(nx)] : qtt::ONES;
        const uint64_t nmv = nx < EBB ? mv_out[at(nx)] : 0;
        __syncthreads();    // every read of this round's rows is done
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = s0 + s;
          if (i >= first && i < last && i + 1 < EBB) {
            pv_out[at(i)] = s + 1 < S ? pv[s + 1] : npv;
            mv_out[at(i)] = s + 1 < S ? mv[s + 1] : nmv;
          } else if (i == last && i < EBB) {
            pv_out[at(i)] = qtt::ONES;
            mv_out[at(i)] = 0;
          }
        }
      }
      if (tid == 0 && last + 1 >= 0 && last + 1 <= EBB)
        scores[at(nb + last + 1)] = c_last + W;
      const bool cut_higher = (first + 2 < last) &&
                              (W * (last - 1) > fv) &&
                              (c_last1 + (W * (last - 1) - fv) > co);
      if (cut_higher || nb - pro + last >= clamp_at) --last;
    }
    // window row EBB of the next block; row nb leaves the window
    if (tid == 0) scores[at(nb + 1 + EBB)] = (nb + 1 + EBB - pro + 1) * W;
    __syncthreads();
    if (FULL)
      for (int r = 0; r < rounds; ++r) {
        load(r * seg + i0, nb, false);
        snapshot((long)nb * W + W - 1, r * seg + i0, min(band0[0], first),
                 band0[1]);
      }
  }
  if (tid == 0) {
    first_out[b] = first;
    last_out[b] = last;
    if (work) work[b] = advances;
  }
}

template <int S, bool MULTI>
cudaError_t launch(bool full, int grid, int threads, size_t smem,
                   cudaStream_t st, const uint64_t* peq, const uint64_t* lm,
                   const uint8_t* text, const int32_t* init,
                   const int32_t* cutoff, const int32_t* prolog,
                   const int32_t* nbr, const int32_t* finish_v,
                   const int32_t* tfinish, const int32_t* first0,
                   const int32_t* last0, int32_t* scores, uint64_t* pv,
                   uint64_t* mv, int32_t* first_out, int32_t* last_out,
                   uint64_t* mat_pv, uint64_t* mat_mv, int64_t* work, int B,
                   int EBB, int NB) {
  auto kernel = full ? banded_fill_kernel<S, MULTI, true>
                     : banded_fill_kernel<S, MULTI, false>;
  kernel<<<grid, threads, smem, st>>>(
      peq, lm, text, init, cutoff, prolog, nbr, finish_v, tfinish, first0,
      last0, scores, pv, mv, first_out, last_out, mat_pv, mat_mv, work, B,
      EBB, NB);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* qtt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int qtt_banded_fill(int full, const void* peq, const void* lm,
                    const void* text, const void* init, const void* cutoff,
                    const void* prolog, const void* nbr, const void* finish_v,
                    const void* tfinish, const void* first0,
                    const void* last0, void* scores, void* pv, void* mv,
                    void* first_out, void* last_out, void* mat_pv,
                    void* mat_mv, void* work, int B, int EBB, int NB,
                    void* stream) {
  if (B <= 0) return 0;
  if (EBB < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define QTT_FILL_ARGS                                                      \
  (const uint64_t*)peq, (const uint64_t*)lm, (const uint8_t*)text,         \
      (const int32_t*)init, (const int32_t*)cutoff, (const int32_t*)prolog, \
      (const int32_t*)nbr, (const int32_t*)finish_v,                        \
      (const int32_t*)tfinish, (const int32_t*)first0,                      \
      (const int32_t*)last0, (int32_t*)scores, (uint64_t*)pv,               \
      (uint64_t*)mv, (int32_t*)first_out, (int32_t*)last_out,               \
      (uint64_t*)mat_pv, (uint64_t*)mat_mv, (int64_t*)work, B, EBB, NB
  cudaError_t err;
  if (EBB <= 32 * 4) {
    const int grid = (B + PAIRS_PER_CTA - 1) / PAIRS_PER_CTA;
    const int threads = 32 * (B < PAIRS_PER_CTA ? B : PAIRS_PER_CTA);
    const size_t smem =
        sizeof(uint64_t) * PAIRS_PER_CTA * region_words(32, EBB);
    if (EBB <= 32)
      err = launch<1, false>(full, grid, threads, smem, st, QTT_FILL_ARGS);
    else if (EBB <= 64)
      err = launch<2, false>(full, grid, threads, smem, st, QTT_FILL_ARGS);
    else
      err = launch<4, false>(full, grid, threads, smem, st, QTT_FILL_ARGS);
  } else if (EBB <= MAX_RESIDENT) {
    const int warps = (EBB + 32 * MULTI_S - 1) / (32 * MULTI_S);
    const size_t smem = sizeof(uint64_t) * region_words(32 * warps, EBB);
    err = launch<MULTI_S, true>(full, B, 32 * warps, smem, st,
                                QTT_FILL_ARGS);
  } else {
    auto kernel = full ? banded_fill_stream_kernel<true>
                       : banded_fill_stream_kernel<false>;
    kernel<<<B, 32 * MAX_WARPS, 0, st>>>(QTT_FILL_ARGS);
    err = cudaGetLastError();
  }
#undef QTT_FILL_ARGS
  return (int)err;
}

}  // extern "C"
