// Deep-band banded score (score-only) by the carry-map scan.
//
// Replaces the Pallas TPU kernel quicked_tpu/ops/banded_cscan_pallas.py:
// _kernel (launched by _pallas_cscan) and its XLA twin
// banded_cscan_jax.py:cscan_scan_impl. Same outputs as the score-only
// fill (csrc/banded_fill.cu): the scores window, final Pv/Mv band and
// first/last live block.
//
// The carry entering band block i of a column is P (PHin=1), Z or M
// (MHin=1). A block's carry-out as a function of its carry-in is a map
// (a, b) = (out for P or Z, out for M): P and Z give the same carry-out.
// Maps compose associatively, so the chain through a column's blocks is
// an exclusive prefix composition, started from constant P below block
// `first` (the chain enters `first` with PHin=1).
//
// What bounds it on the H100: a pair is a chain of 64 * NB dependent
// columns; B pairs (at most 32 on the route's tiny batches, or the
// systolic kernel's ABORT lanes) fill B CTAs. So a column's latency is
// the time: no step of it waits on device memory, and it has one barrier
// at most.
//
// Design: one CTA per pair; thread t owns the stripe of S contiguous band
// blocks [t*S, t*S+S) and keeps their Pv/Mv words and score rows in
// registers, and, staged once per 64-column block (their shifted-frame
// rows move by one per block), their five PEQ words and level masks; the
// block's 64 characters are read once by each warp from the pair-major
// text and held as three 64-bit planes by __ballot_sync. Per column:
//   1. each thread advances its blocks under carry-ins Z and M (two
//      independent advances per block) and composes the blocks' maps into
//      its stripe's; blocks below `first` map to constant P;
//   2. the carry into each stripe from three ballots of the stripe maps
//      (qtt::m_in); past one warp, one map per warp to shared memory, one
//      barrier, and three ballots of the warp maps give every warp its
//      carry-in the same way;
//   3. each live block takes its real result: the M advance for carry M,
//      the Z advance for Z, and for P the Z advance with bit 0 of Pv/Mv
//      fixed (P and Z differ only in the carry shifted into bit 0).
// A pair's CTA has one warp per 32 stripes, so that few pairs still
// spread their blocks over many warps (a warp issues one instruction a
// cycle): S = 1 on one warp up to 32 blocks and on up to MAX_WARPS warps
// up to 512, then S = 2 and 4 up to 2048 blocks. Every 64 columns the
// band cut/shift of banded_jax.py:_maintenance runs on the pair's scores
// window and boundary Pv/Mv words in shared memory; the window roll is a
// register shift, and the row that leaves the window is stored.
// Bands deeper than 2048 blocks (the route's buckets over 16000, the
// systolic kernel's widest ABORT lanes) are walked in rounds of 2048
// blocks per column by banded_cscan_rounds_kernel: the band in device
// memory (Pv/Mv in the pv/mv outputs, window row r of block nb in
// scores_by_k row nb + r), the carry out of one round entering the next.
// The TPU kernel's (R, 128) layout, 8-sublane DMA windows and lane rolls
// have no counterpart.

#include "qtt_common.cuh"

namespace {

using qtt::compose;
using qtt::img_a;
using qtt::img_b;
using qtt::M_ST;
using qtt::m_in;
using qtt::mk;
using qtt::out_state;
using qtt::P_ST;
using qtt::pick;
using qtt::W;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MULTI_S = 4;          // stripe of the several-warp modes
constexpr int MAX_WARPS = 16;       // warps of one pair
// band blocks MAX_WARPS warps hold in registers; deeper bands go in rounds
constexpr int MAX_RESIDENT = 32 * MULTI_S * MAX_WARPS;

// u64 words of the shared region: boundary Pv and Mv words of the tpp
// threads (plus one sentinel each) and the EBB+1 window scores.
__host__ __device__ inline int region_words(int tpp, int EBB) {
  return 2 * (tpp + 1) + (EBB + 2) / 2;
}

// The carry into warp `warp` of `nw` for a carry `c0` into warp 0, and
// with TOP in `top` the carry out of the top warp. Lane w of every warp
// holds warp w's map `wm` (images of P or Z, and of M); the maps are
// resolved by three ballots, as qtt::m_in resolves a warp's stripes.
template <bool TOP>
__device__ __forceinline__ int warp_carry(int wm, int warp, int nw, int c0,
                                          int &top) {
  const bool am = img_a(wm) == M_ST, bm = img_b(wm) == M_ST;
  const unsigned R = __ballot_sync(FULL_MASK, am == bm);
  const unsigned V = __ballot_sync(FULL_MASK, am && bm);
  const unsigned N = __ballot_sync(FULL_MASK, am && !bm);
  const int m0 = c0 == M_ST;
  const int below = warp > 0 ? warp - 1 : 0;
  const int fb = __shfl_sync(FULL_MASK, wm, below);
  if (TOP) {
    const int ft = __shfl_sync(FULL_MASK, wm, nw - 1);
    top = m_in(R, V, N, nw - 1, m0) ? img_b(ft) : img_a(ft);
  }
  if (warp == 0) return c0;
  return m_in(R, V, N, below, m0) ? img_b(fb) : img_a(fb);
}

// The carry out of this lane's stripe, for a carry into the warp that is
// not M (out0) and that is M (out1), and the same of the stripe below
// (up0, up1; lane 0 has none): the stripes' part of the carry
// resolution, done before the warps' carries are known.
struct StripeCarry {
  int out0, out1, up0, up1;
};
__device__ __forceinline__ StripeCarry stripe_carry(int agg, int lane) {
  const int A = img_a(agg), Bm = img_b(agg);
  const bool am = A == M_ST, bm = Bm == M_ST;
  const unsigned R = __ballot_sync(FULL_MASK, am == bm);
  const unsigned V = __ballot_sync(FULL_MASK, am && bm);
  const unsigned N = __ballot_sync(FULL_MASK, am && !bm);
  StripeCarry c;
  c.out0 = m_in(R, V, N, lane, 0) ? Bm : A;
  c.out1 = m_in(R, V, N, lane, 1) ? Bm : A;
  c.up0 = __shfl_up_sync(FULL_MASK, c.out0, 1);
  c.up1 = __shfl_up_sync(FULL_MASK, c.out1, 1);
  return c;
}

// The text character of column j of the block from its three planes.
__device__ __forceinline__ int plane_char(const uint64_t (&plane)[3], int j) {
  return (int)((plane[0] >> j) & 1) | (int)(((plane[1] >> j) & 1) << 1) |
         (int)(((plane[2] >> j) & 1) << 2);
}

// The block's 64 characters (pair-major text of the pair at `txt`) as
// three bit planes, in every lane of the warp.
__device__ __forceinline__ void stage_planes(const uint8_t* txt, int nb,
                                             int lane, uint64_t (&plane)[3]) {
  const int c_lo = txt[(size_t)nb * W + lane];
  const int c_hi = txt[(size_t)nb * W + 32 + lane];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    plane[k] = (uint64_t)__ballot_sync(FULL_MASK, (c_lo >> k) & 1) |
               ((uint64_t)__ballot_sync(FULL_MASK, (c_hi >> k) & 1) << 32);
}

template <int S, bool MULTI>
__global__ void __launch_bounds__(MULTI ? 32 * MAX_WARPS : 32, 1)
banded_cscan_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text_pm, // (B, NB*64), pair-major
    const int32_t* __restrict__ init,    // (EBB+1, B)
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (NB+EBB+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    int B, int EBB, int NB) {
  extern __shared__ uint64_t smem[];
  __shared__ int warp_map[2][MULTI ? MAX_WARPS : 1];   // by column parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpp = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const int nw = tpp / 32;
  uint64_t* sh_pv = smem;
  uint64_t* sh_mv = sh_pv + tpp + 1;
  int* sh_sc = reinterpret_cast<int*>(sh_mv + tpp + 1);
  const size_t Bs = (size_t)B;
  auto at = [&](long r) { return (size_t)r * Bs + b; };
  const uint8_t* txt = text_pm + (size_t)b * NB * W;
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
  if (tid == 0) {
    sh_pv[tpp] = qtt::ONES;
    sh_mv[tpp] = 0;
  }

  for (int nb = 0; nb < NB; ++nb) {
    // ---- stage the block: text planes, PEQ and level-mask words ----
    uint64_t plane[3];
    stage_planes(txt, nb, lane, plane);
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

    for (int j = 0; j < W; ++j) {
      const long t = (long)nb * W + j;
      if (t < tfin && live) {         // the same in every thread of a pair
        const int c = plane_char(plane, j);
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
        // 2. the carry into each stripe, from three ballots (m_in), and
        // into each warp from three ballots of the warp maps
        const StripeCarry sc2 = stripe_carry(agg, lane);
        int cw = P_ST;                  // the carry into this warp
        if (MULTI) {
          if (lane == 31) warp_map[j & 1][warp] = mk(sc2.out0, sc2.out1);
          __syncthreads();
          int top;
          cw = warp_carry<false>(lane < nw ? warp_map[j & 1][lane] : 0, warp,
                                 nw, P_ST, top);
        }
        int carry = lane == 0 ? cw : cw == M_ST ? sc2.up1 : sc2.up0;
        // 3. each live block takes the advance of its real carry-in
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = i0 + s;
          if (i >= first && i <= last && i < EBB) {
            const int o = carry == M_ST ? img_b(raw[s]) : img_a(raw[s]);
            sc[s] += (o == P_ST) - (o == M_ST);
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
          carry = i < first ? P_ST
                            : (carry == M_ST ? img_b(raw[s]) : img_a(raw[s]));
        }
      }
    }

    // ---- band cut/shift (banded_jax.py:_maintenance), window roll ----
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (i0 + s < EBB) sh_sc[i0 + s] = sc[s];
    if (tid == 0) sh_sc[EBB] = sc_top;
    sh_pv[tid] = pv[0];
    sh_mv[tid] = mv[0];
    __syncthreads();
    auto cap = [&](int r) { return sh_sc[min(max(r, 0), EBB - 1)]; };
    const int c_first1 = cap(first + 1), c_last1 = cap(last - 1);
    const int c_last = cap(last);
    const bool do_shift = (long)(nb + 1) * W <= tfin;
    const bool cut_lower = (first + 2 < last) && (fv > W * (first + 1)) &&
                           (c_first1 + (fv - W * (first + 1)) > co);
    const int old_last = last;
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
      if (cut_higher || nb - pro + last >= nbr_b) --last;
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
    __syncthreads();     // every read of the shared region is done
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
  }
}

// Bands over MAX_RESIDENT blocks: MAX_WARPS warps walk the band in rounds
// of MAX_RESIDENT blocks per column, the band in device memory (pv/mv
// outputs; window row r of block nb is scores_by_k row nb + r).
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
banded_cscan_rounds_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text_pm, // (B, NB*64), pair-major
    const int32_t* __restrict__ init,    // (EBB+1, B)
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (NB+EBB+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    int B, int EBB, int NB) {
  constexpr int S = MULTI_S;
  // carry maps by barrier parity: one barrier per round publishes them
  __shared__ int warp_map[2][MAX_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpp = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const int nw = tpp / 32;
  const size_t Bs = (size_t)B;
  auto at = [&](long r) { return (size_t)r * Bs + b; };
  const uint8_t* txt = text_pm + (size_t)b * NB * W;
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

  for (int nb = 0; nb < NB; ++nb) {
    uint64_t plane[3];
    stage_planes(txt, nb, lane, plane);
    const bool live = max(first, 0) <= min(last, EBB - 1);

    for (int j = 0; j < W; ++j) {
      const long t = (long)nb * W + j;
      if (!(t < tfin && live)) continue;   // the same in every thread
      const int c = plane_char(plane, j);
      int rc = P_ST;      // the carry into the round's lowest block
      for (int r = 0; r < rounds; ++r) {
        const int s0 = r * seg + i0;
        const int par = (j * rounds + r) & 1;
        load(s0, nb, true);
        // 1. the Z and M advances of each block; stripe map
        uint64_t zp[S], zm[S], mp[S], mm[S];
        int raw[S], agg = 0;
        unsigned xv0 = 0;   // bit s: bit 0 of Eq | Mv of block s (for P)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = s0 + s;
          const uint64_t e =
              i < EBB ? peq[((size_t)(nb + i) * 5 + c) * Bs + b] : qtt::ONES;
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
        // 2. the carry into each stripe: warp ballots, then the warp maps
        // (with the carry out of the rounds below)
        const StripeCarry sc2 = stripe_carry(agg, lane);
        if (lane == 31) warp_map[par][warp] = mk(sc2.out0, sc2.out1);
        __syncthreads();
        int top;
        const int cw = warp_carry<true>(lane < nw ? warp_map[par][lane] : 0,
                                        warp, nw, rc, top);
        rc = top;
        int carry = lane == 0 ? cw : cw == M_ST ? sc2.up1 : sc2.up0;
        // 3. each live block takes the advance of its real carry-in
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int i = s0 + s;
          if (i >= first && i <= last && i < EBB) {
            const int o = carry == M_ST ? img_b(raw[s]) : img_a(raw[s]);
            sc[s] += (o == P_ST) - (o == M_ST);
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
          carry = i < first ? P_ST
                            : (carry == M_ST ? img_b(raw[s]) : img_a(raw[s]));
        }
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
      if (cut_higher || nb - pro + last >= nbr_b) --last;
    }
    // window row EBB of the next block; row nb leaves the window
    if (tid == 0) scores[at(nb + 1 + EBB)] = (nb + 1 + EBB - pro + 1) * W;
    __syncthreads();
  }
  if (tid == 0) {
    first_out[b] = first;
    last_out[b] = last;
  }
}

}  // namespace

// S (band blocks per thread) and threads as
// ops/banded_cscan_cuda.py:cscan_launch chooses them: S = 1 on one warp
// for EBB <= 32; S = 1, 2 or 4 on ceil(EBB / 32 S) warps (at most 16) for
// EBB <= 2048; S = 4 on 16 warps in rounds past that.
extern "C" int qtt_banded_cscan(const void* peq, const void* lm,
                                const void* text_pm, const void* init,
                                const void* cutoff, const void* prolog,
                                const void* nbr, const void* finish_v,
                                const void* tfinish, const void* first0,
                                const void* last0, void* scores, void* pv,
                                void* mv, void* first_out, void* last_out,
                                int B, int EBB, int NB, int S, int threads,
                                void* stream) {
  if (B <= 0) return 0;
  if (EBB < 1 || threads % 32 != 0 || threads < 32 ||
      threads > 32 * MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define QTT_CSCAN_ARGS                                                     \
  (const uint64_t*)peq, (const uint64_t*)lm, (const uint8_t*)text_pm,      \
      (const int32_t*)init, (const int32_t*)cutoff, (const int32_t*)prolog, \
      (const int32_t*)nbr, (const int32_t*)finish_v,                        \
      (const int32_t*)tfinish, (const int32_t*)first0,                      \
      (const int32_t*)last0, (int32_t*)scores, (uint64_t*)pv,               \
      (uint64_t*)mv, (int32_t*)first_out, (int32_t*)last_out, B, EBB, NB
  const size_t smem = sizeof(uint64_t) * region_words(threads, EBB);
  const int warps = (EBB + 32 * S - 1) / (32 * S);
  if (threads == 32 && S == 1 && EBB <= 32) {
    banded_cscan_kernel<1, false><<<B, 32, smem, st>>>(QTT_CSCAN_ARGS);
  } else if (EBB <= MAX_RESIDENT && threads == 32 * warps &&
             warps <= MAX_WARPS && (S == 1 || S == 2 || S == 4)) {
    if (S == 1)
      banded_cscan_kernel<1, true><<<B, threads, smem, st>>>(QTT_CSCAN_ARGS);
    else if (S == 2)
      banded_cscan_kernel<2, true><<<B, threads, smem, st>>>(QTT_CSCAN_ARGS);
    else
      banded_cscan_kernel<4, true><<<B, threads, smem, st>>>(QTT_CSCAN_ARGS);
  } else if (S == MULTI_S && EBB > MAX_RESIDENT &&
             threads == 32 * MAX_WARPS) {
    banded_cscan_rounds_kernel<<<B, threads, 0, st>>>(QTT_CSCAN_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef QTT_CSCAN_ARGS
  return (int)cudaGetLastError();
}
