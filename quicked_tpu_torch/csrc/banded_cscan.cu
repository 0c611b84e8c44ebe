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
// Design: one CTA per pair; thread t owns the stripe of S contiguous band
// blocks [t*S, t*S+S) and keeps their Pv/Mv words and score rows in
// registers. Per column:
//   1. each thread advances its blocks with carry-ins Z and M, keeping
//      only the carry-outs: the blocks' maps, composed into the stripe's;
//   2. an inclusive scan of the stripe maps inside each warp
//      (__shfl_up_sync), one map per warp to shared memory, one
//      __syncthreads; the carry entering a warp is P pushed through the
//      maps of the warps below it;
//   3. each thread walks its stripe from the resolved carry-in, advancing
//      each live block once with its real carry.
// Every 64 columns the score rows go to the scores window in device
// memory (the fill's layout: window row r of block nb is row nb + r, so
// the window roll is an index offset), and the band cut/shift of
// banded_jax.py:_maintenance runs in every thread on the same values; the
// one-block shift of Pv/Mv crosses stripes through shared memory.
// The TPU kernel's (R, 128) layout, 8-sublane DMA windows and lane rolls
// have no counterpart: PEQ words are read by shifted-frame row.
//
// What bounds it on the H100: a column costs three advances per block, a
// five-level shuffle scan and one barrier, so a pair is a chain of
// ~64*NB barriers; B pairs fill B CTAs. It serves the batches the
// thread-per-lane fill starves: few pairs with deep bands.

#include "qtt_common.cuh"

namespace {

using qtt::apply;
using qtt::compose;
using qtt::M_ST;
using qtt::mk;
using qtt::out_state;
using qtt::P_ST;
using qtt::W;

template <int S>
__global__ void __launch_bounds__(1024) banded_cscan_kernel(
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
    int B, int EBB, int NB) {
  __shared__ int warp_map[2][32];         // by column parity
  __shared__ uint64_t low_pv[1024], low_mv[1024];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t Bs = (size_t)B;
  auto at = [&](long r) { return (size_t)r * Bs + b; };
  const int i0 = tid * S;

  uint64_t pv[S], mv[S], eqv[S], lmv[S];
  int sc[S], map[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    pv[s] = qtt::ONES;
    mv[s] = 0;
  }
  for (int r = tid; r <= EBB; r += T) scores[at(r)] = init[at(r)];
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) sc[s] = i0 + s < EBB ? scores[at(i0 + s)] : 0;
  int first = first0[b], last = last0[b];
  const int tfin = tfinish[b], pro = prolog[b], co = cutoff[b];
  const int fv = finish_v[b], nbr_b = nbr[b];

  for (int nb = 0; nb < NB; ++nb) {
    for (int j = 0; j < W; ++j) {
      const long t = (long)nb * W + j;
      const bool col_act = t < tfin;
      const int c = text[at(t)];
      const int par = j & 1;
      // 1. block maps from the Z and M carry-ins, composed per stripe
      int agg = mk(P_ST, P_ST);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = i0 + s;
        eqv[s] = i < EBB ? peq[((size_t)(nb + i) * 5 + c) * Bs + b]
                         : qtt::ONES;
        lmv[s] = i < EBB ? lm[at(nb + i)] : qtt::TOPBIT;
        uint64_t zp = pv[s], zm = mv[s], mp = pv[s], mm = mv[s];
        uint32_t zph = 0, zmh = 0, mph = 0, mmh = 1;
        qtt::advance_block(eqv[s], lmv[s], zp, zm, zph, zmh);
        qtt::advance_block(eqv[s], lmv[s], mp, mm, mph, mmh);
        map[s] = i < first ? mk(P_ST, P_ST)
                           : mk(out_state(zph, zmh), out_state(mph, mmh));
        agg = s == 0 ? map[0] : compose(map[s], agg);
      }
      // 2. inclusive scan of the stripe maps in the warp, then across warps
      int x = agg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x = compose(x, y);
      }
      const int below = __shfl_up_sync(0xffffffffu, x, 1);
      if (lane == 31) warp_map[par][warp] = x;
      __syncthreads();
      int carry = P_ST;
      for (int w = 0; w < warp; ++w) carry = apply(warp_map[par][w], carry);
      if (lane > 0) carry = apply(below, carry);
      // 3. advance each live block once with its resolved carry-in
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = i0 + s;
        if (col_act && i >= first && i <= last && i < EBB) {
          uint32_t ph = carry == P_ST, mh = carry == M_ST;
          qtt::advance_block(eqv[s], lmv[s], pv[s], mv[s], ph, mh);
          sc[s] += (int)ph - (int)mh;
        }
        carry = apply(map[s], carry);
      }
    }

    // Band cut/shift (banded_jax.py:_maintenance) on the swept window.
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (i0 + s < EBB) scores[at(nb + i0 + s)] = sc[s];
    low_pv[tid] = pv[0];
    low_mv[tid] = mv[0];
    __syncthreads();
    auto cap = [&](int r) { return scores[at(nb + min(max(r, 0), EBB - 1))]; };
    const int c_first1 = cap(first + 1), c_last1 = cap(last - 1);
    const int c_last = cap(last);
    const bool do_shift = (long)(nb + 1) * W <= tfin;
    const bool cut_lower = (first + 2 < last) && (fv > W * (first + 1)) &&
                           (c_first1 + (fv - W * (first + 1)) > co);
    const int old_last = last;
    if (do_shift) {
      if (cut_lower && nb >= pro) ++first;
      if (!cut_lower && nb < pro) --first;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int i = i0 + s;
        if (i >= first && i < last) {
          pv[s] = s + 1 < S ? pv[s + 1] : low_pv[tid + 1];
          mv[s] = s + 1 < S ? mv[s + 1] : low_mv[tid + 1];
        } else if (i == last) {
          pv[s] = qtt::ONES;
          mv[s] = 0;
        }
      }
      const bool cut_higher = (first + 2 < last) &&
                              (W * (last - 1) > fv) &&
                              (c_last1 + (W * (last - 1) - fv) > co);
      if (cut_higher || nb - pro + last >= nbr_b) --last;
    }
    __syncthreads();     // every read of this window is done
    if (tid == 0) {
      if (do_shift && old_last + 1 >= 0 && old_last + 1 <= EBB)
        scores[at(nb + old_last + 1)] = c_last + W;
      scores[at(nb + 1 + EBB)] = (nb + 1 + EBB - pro + 1) * W;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (i0 + s < EBB) sc[s] = scores[at(nb + 1 + i0 + s)];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (i0 + s < EBB) {
      pv_out[at(i0 + s)] = pv[s];
      mv_out[at(i0 + s)] = mv[s];
    }
  }
  if (tid == 0) {
    first_out[b] = first;
    last_out[b] = last;
  }
}

}  // namespace

extern "C" int qtt_banded_cscan(const void* peq, const void* lm,
                                const void* text, const void* init,
                                const void* cutoff, const void* prolog,
                                const void* nbr, const void* finish_v,
                                const void* tfinish, const void* first0,
                                const void* last0, void* scores, void* pv,
                                void* mv, void* first_out, void* last_out,
                                int B, int EBB, int NB, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto threads = [&](int S) { return ((EBB + S - 1) / S + 31) / 32 * 32; };
#define QTT_CSCAN_ARGS                                                     \
  (const uint64_t*)peq, (const uint64_t*)lm, (const uint8_t*)text,         \
      (const int32_t*)init, (const int32_t*)cutoff, (const int32_t*)prolog, \
      (const int32_t*)nbr, (const int32_t*)finish_v,                        \
      (const int32_t*)tfinish, (const int32_t*)first0,                      \
      (const int32_t*)last0, (int32_t*)scores, (uint64_t*)pv,               \
      (uint64_t*)mv, (int32_t*)first_out, (int32_t*)last_out, B, EBB, NB
  if (threads(1) <= 1024)
    banded_cscan_kernel<1><<<B, threads(1), 0, s>>>(QTT_CSCAN_ARGS);
  else if (threads(4) <= 1024)
    banded_cscan_kernel<4><<<B, threads(4), 0, s>>>(QTT_CSCAN_ARGS);
  else if (threads(16) <= 1024)
    banded_cscan_kernel<16><<<B, threads(16), 0, s>>>(QTT_CSCAN_ARGS);
  else if (threads(64) <= 1024)
    banded_cscan_kernel<64><<<B, threads(64), 0, s>>>(QTT_CSCAN_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef QTT_CSCAN_ARGS
  return (int)cudaGetLastError();
}
