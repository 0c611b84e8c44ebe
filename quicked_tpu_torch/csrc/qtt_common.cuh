// Shared device helpers of the quicked_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qtt {

constexpr int W = 64;
constexpr uint64_t ONES = ~0ull;
constexpr uint64_t TOPBIT = 1ull << 63;

// Myers advance-block on one 64-bit word (BPM_ADVANCE_BLOCK,
// bpm_commons.h:49-68; quicked_tpu/ops/u64.py:advance_block64 emulates
// it on two u32 halves). phin/mhin are the 0/1 carries entering bit 0;
// returns the carries leaving the block at the `mask` level.
__device__ __forceinline__ void advance_block(uint64_t eq, uint64_t mask,
                                              uint64_t &pv, uint64_t &mv,
                                              uint32_t &ph_c,
                                              uint32_t &mh_c) {
  const uint64_t xv = eq | mv;
  const uint64_t eq2 = eq | (uint64_t)mh_c;
  const uint64_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  const uint32_t phout = (ph & mask) != 0;
  const uint32_t mhout = (mh & mask) != 0;
  ph = (ph << 1) | (uint64_t)ph_c;
  mh = (mh << 1) | (uint64_t)mh_c;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  ph_c = phout;
  mh_c = mhout;
}

// Carry maps (banded_cscan.cu, banded_fill.cu). The carry entering a band
// block is P (PHin=1), Z (none) or M (MHin=1); a block's carry-out as a
// function of its carry-in is a map (a, b) = (out for P or Z, out for M):
// P and Z give the same carry-out. Maps compose associatively, so the
// chain through a column's blocks is a prefix composition.
constexpr int P_ST = 0, Z_ST = 1, M_ST = 2;

// A carry map in one int: bits 0-1 the image of P and Z, bits 2-3 the
// image of M.
__device__ __forceinline__ int mk(int a, int b) { return a | (b << 2); }
__device__ __forceinline__ int img_a(int f) { return f & 3; }
__device__ __forceinline__ int img_b(int f) { return f >> 2; }
// f after g
__device__ __forceinline__ int compose(int f, int g) {
  return mk(img_a(g) == M_ST ? img_b(f) : img_a(f),
            img_b(g) == M_ST ? img_b(f) : img_a(f));
}
// the state f sends s to
__device__ __forceinline__ int apply(int f, int s) {
  return s == M_ST ? img_b(f) : img_a(f);
}
__device__ __forceinline__ int out_state(uint32_t ph, uint32_t mh) {
  return ph ? P_ST : (mh ? M_ST : Z_ST);
}

// Bits 0..k of a word, k in [0, 63].
__device__ __forceinline__ uint64_t mask_le(int k) {
  return k >= 63 ? ONES : ((2ull << k) - 1ull);
}

}  // namespace qtt
