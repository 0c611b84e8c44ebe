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

// The PEQ word of character c (0..4) from a row's five words, by a chain
// of selects: indexing the array by a per-thread character would put it
// in local memory or compile to branches.
__device__ __forceinline__ uint64_t pick(const uint64_t (&e)[5], int c) {
  uint64_t r = e[4];
  r = c == 3 ? e[3] : r;
  r = c == 2 ? e[2] : r;
  r = c == 1 ? e[1] : r;
  return c == 0 ? e[0] : r;
}

// Whether the carry into stripe `lane` of a warp is M. A stripe's map
// (a, b) sends "the carry-in is M" to "the carry-out is M" by a constant
// (a and b both M or both not: R, with the constant in V), the identity,
// or the negation (a is M, b is not: N); R, V and N are ballots of the
// warp's stripes. So the carry into a stripe is the constant of the
// nearest constant stripe below it, or `m0` (the carry into the warp) if
// there is none, flipped once per negating stripe in between.
__device__ __forceinline__ int m_in(unsigned R, unsigned V, unsigned N,
                                    int lane, int m0) {
  const unsigned below = (1u << lane) - 1u;
  const unsigned r = R & below;
  int base = m0;
  unsigned span = below;
  if (r) {
    const int j = 31 - __clz(r);
    base = (V >> j) & 1;
    span = below & ~((2u << j) - 1u);
  }
  return base ^ (__popc(N & span) & 1);
}

// The 32-bit shared address of a pointer into shared memory. As volatile
// asm it is computed once and kept in a register: the compiler would
// rebuild it from the CTA's shared window at every use inside a loop.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  unsigned a;
  asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
               : "=r"(a)
               : "l"(p));
  return a;
}

// Loads from shared memory at a 32-bit shared address (shared_addr). As
// volatile asm they stay where they are written: a walk issues a column's
// loads together, ahead of the branch that decides which of them it
// needs, where the compiler would merge them into one load after it.
__device__ __forceinline__ uint64_t lds_u64(unsigned addr) {
  uint64_t x;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(x) : "r"(addr));
  return x;
}
__device__ __forceinline__ int lds_s32(unsigned addr) {
  int x;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(x) : "r"(addr));
  return x;
}

// Asynchronous 8-byte copies from device to shared memory (cp.async):
// no register holds the word in flight; a thread sees its own copies after
// cp_async_wait<0>() (or cp_async_wait_all()).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bits 0..k of a word, k in [0, 63].
__device__ __forceinline__ uint64_t mask_le(int k) {
  return k >= 63 ? ONES : ((2ull << k) - 1ull);
}

}  // namespace qtt
