// Systolic deep-band banded score (score-only), with a per-pair ABORT flag.
//
// Replaces the Pallas TPU kernel quicked_tpu/ops/banded_sysband_pallas.py:
// _kernel (launched by _pallas_sysband), whose bit-exact specification is
// the step model quicked_tpu/ops/banded_sysband_np.py:run_sysband_pair.
// Band block-row k runs one column behind row k-1, in the absolute-row
// frame k = column block + band block, so each step is ONE Myers advance
// per resident row: the carry a row takes is the one its lower neighbour
// produced the step before. The per-64-column band cut/shift becomes two
// scalar machines (bottom edge: event E1; top edge: the c_last1 capture
// and event E2) that fire at exact steps and schedule single-row mask
// edits; the resident window recenters by 128 rows as the band climbs.
// A pair whose bottom-edge decision would need a top-edge value not yet
// decided raises ABORT; the caller recomputes it exactly (the carry-scan
// kernel, csrc/banded_cscan.cu). Contract, as the model's: scores and
// first/last exact, pv/mv exact on [first, last].
//
// What bounds it on the H100: the step count, ~66 * NB + NS, each step a
// chain of a shared-memory load, one Myers advance (~30 integer
// operations) and one barrier of the CTA; a pair is one CTA, so a batch of
// B pairs fills B SMs, and a step's time is the latency of that chain and
// the issue of the warps that hold live rows. Per step, no load from
// device memory sits on the chain:
//   - A row's five PEQ words and its level mask change only when its slot
//     takes a new row (at the start and at a recenter, 128 slots), so they
//     are fetched then, not every step (the TPU kernel's resident slab):
//     in registers at two rows per thread (NS <= 1024, the main path's
//     windows, EBB up to ~630); in shared memory, 48 bytes a row, at 8 rows
//     per thread (NS <= 4096); past that the level mask, score row and
//     mask bits stay in shared memory and the PEQ word a row needs at step
//     t+1 is copied from device memory by cp.async in step t (its
//     character is known a step ahead), 34 rows per thread on at most 256
//     threads (255 registers each; elsewhere at most 512 threads, 128
//     registers each); `sysband_launch` in ops/banded_sysband_cuda.py
//     makes the choice.
//   - The text is a per-pair ring in shared memory: the columns the
//     resident rows span (at most NS + ~450 bytes, TR a power of two), from
//     the pair-major copy of the text; 64 columns at a time are loaded into
//     registers one chunk ahead and stored a chunk before their first use,
//     so the load's latency hides behind ~65 steps. (The TPU kernel's
//     chars cascade, a char moved one row a step with the carry, would
//     need the warming slack to be proven for every fresh slot; the ring
//     needs nothing of the kind.)
//   - The character selects the row's word by a chain of selects
//     (qtt::pick) in registers, by address in shared memory.
//   - A row outside the live band (not both bottom- and top-active) passes
//     no carry and its result is dropped: no active row reads such a carry
//     (the row above is inactive too, or takes the forced carry of the
//     band's first row), so the result is the step model's; most of a
//     window (NS - EBB - 2 rows) is outside the band. A warp with no live
//     row skips the advances; with the words in registers a live warp
//     advances its two rows without branches, so their loads and advances
//     overlap (a branch per row chained them: 49 against 37 ms at the
//     stage-3 shape on an H100, PERF.md).
// Rows live in a ring: physical slot p holds the resident row k = p (mod
// NS), so a recenter rewrites only the 128 slots whose rows left the
// window, and moves no data. A thread's lowest slot takes its carry from
// the next lower thread's highest slot of the previous step, through a
// double-buffered shared array. Every thread runs the scalar machines on
// the same values (the three score rows an event reads are published
// through shared memory before the barrier), so their decisions need no
// second barrier; the first/last rings live in shared memory and every
// thread writes the same value to them. What the TPU kernel needs and
// this one does not: the phase/column planes (functions of the step and
// the row), the SMEM/VMEM split, the 4-char text packing and the DMA
// semaphores.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr int CY = W + 1;          // 64 columns and one bubble per chunk
constexpr int RECENTER = 128;
constexpr int MAX_RING = 256;
// mask bits of a resident row
constexpr int F_PHO = 1, F_MHO = 2, F_BOT = 4, F_TOP = 8, F_ISF = 16;
constexpr int F_LIVE = F_BOT | F_TOP;
// where a resident row's PEQ words and level mask live
constexpr int IN_REGS = 0, IN_SHARED = 1, IN_DEVICE = 2;

// Dynamic shared memory of a CTA of T threads of M row slots: per slot,
// IN_SHARED its five PEQ words and level mask, IN_DEVICE its next PEQ
// word, level mask, score row and mask bits; the carry exchange (2 ints
// a thread); then the TR-byte text ring.
__host__ __device__ inline size_t dyn_bytes(int words, int M, int T,
                                            int TR) {
  const size_t slot = words == IN_SHARED ? 48 : words == IN_DEVICE ? 24 : 0;
  return slot * M * T + 8 * (size_t)T + TR;
}

// threads of a CTA: 512 (4 warps a scheduler, 128 registers a thread);
// IN_DEVICE 256, so that 34 rows' Pv/Mv words fit in 255 registers
__host__ __device__ constexpr int max_threads(int words) {
  return words == IN_DEVICE ? 256 : 512;
}

template <int M, int WORDS>
__global__ void __launch_bounds__(max_threads(WORDS), 1)
banded_sysband_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text_pm, // (B, NB*64), pair-major
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (K+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,  // (EBB, B)
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    int32_t* __restrict__ abort_out, int B, int EBB, int NB, int NS,
    int RING, int TR) {
  extern __shared__ uint64_t smem[];
  __shared__ int sval[2][3];             // score rows read by the events
  __shared__ int fring[MAX_RING], lring[MAX_RING];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const size_t Bs = (size_t)B;
  const int K = NB + EBB;
  const int co = cutoff[b], pro = prolog[b], nbr_b = nbr[b];
  const int fv = finish_v[b], tfin = tfinish[b];
  const int f0 = first0[b], l0 = last0[b];
  const int tf64 = tfin / W;
  const int T_end = CY * NB + NB + NS + 2 * CY;
  const uint8_t* txt = text_pm + (size_t)b * NB * W;

  // The thread's row slots are p = tid * M + s for s < nvalid: T * M may
  // pass NS, and the last thread holds fewer.
  const int nvalid = min(M, NS - tid * M);
  // dynamic shared memory; row slot s of this thread at s*T + tid, but
  // IN_DEVICE at tid*M + s: one base address a thread, where M = 34
  // addresses would take registers
  const int MT = M * T;
  auto slot = [&](int s) {
    return WORDS == IN_DEVICE ? tid * M + s : s * T + tid;
  };
  uint64_t* sm_eq = smem;                // IN_SHARED: 5 a row; IN_DEVICE: 1
  uint64_t* sm_lm = sm_eq + (WORDS == IN_SHARED ? 5 * (size_t)MT :
                             WORDS == IN_DEVICE ? (size_t)MT : 0);
  int* exch = reinterpret_cast<int*>(sm_lm + (WORDS == IN_REGS ? 0 : MT));
  int* sm_sc = exch + 2 * T;             // IN_DEVICE: score row, mask bits
  int* sm_fl = sm_sc + MT;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      WORDS == IN_DEVICE ? sm_fl + MT : sm_sc);
  const int TRm = TR - 1;

  // scalar machines (the same in every thread)
  int base = 0, nbB = 0, fsB = f0, nbT = 0, lsT = l0, cl1 = 0;
  int bd_t = -10, tp_t = -10;
  int bd_row = 0, bd_case = 0, tp_row = 0, abort = 0;
  // the steps of the next E1, c_last1 capture (E2 is the step after it)
  int t_e1 = NB > 0 ? fsB + 64 : -1, t_c1 = NB > 0 ? lsT + 62 : -1;

  uint64_t pv[M], mv[M];
  int srow[M], flg[M];
  uint64_t eqr[WORDS == IN_REGS ? M : 1][5], lmr[M];
  auto sc = [&](int s) -> int& {
    if constexpr (WORDS == IN_DEVICE) return sm_sc[slot(s)];
    else return srow[s];
  };
  auto fl = [&](int s) -> int& {
    if constexpr (WORDS == IN_DEVICE) return sm_fl[slot(s)];
    else return flg[s];
  };
  // the text column a row reads at local clock u, or -1: none (not yet
  // reached, the bubble, or past the text's finish)
  auto column = [&](int u) {
    if (u < 0) return -1;
    const int q = (int)((unsigned)u / CY), r = u - CY * q;
    const int col = W * q + r;
    return r != W && col < tfin ? col : -1;
  };
  // slot s takes row k: its level mask and PEQ words (rows past K match
  // everything at the top level, as batch_prep's fill)
  auto take = [&](int s, int k) {
    const bool in = k < K;
    if constexpr (WORDS == IN_REGS) {
#pragma unroll
      for (int c = 0; c < 5; ++c)
        eqr[s][c] = in ? peq[((size_t)k * 5 + c) * Bs + b] : qtt::ONES;
      lmr[s] = in ? lm[(size_t)k * Bs + b] : qtt::TOPBIT;
    } else {
      if constexpr (WORDS == IN_SHARED) {
#pragma unroll
        for (int c = 0; c < 5; ++c)
          sm_eq[(s * 5 + c) * T + tid] =
              in ? peq[((size_t)k * 5 + c) * Bs + b] : qtt::ONES;
      }
      sm_lm[slot(s)] = in ? lm[(size_t)k * Bs + b] : qtt::TOPBIT;
    }
  };
  // IN_DEVICE: the PEQ word row k of slot s needs at step tt, copied by
  // cp.async (no register waits for it); the thread waits for its copies
  // before its next advances
  auto prefetch = [&](int s, int k, int tt) {
    const int col = column(tt - k);
    if (col >= 0 && k < K)
      qtt::cp_async8(&sm_eq[slot(s)],
                     &peq[((size_t)k * 5 + ring[col & TRm]) * Bs + b]);
    else
      sm_eq[slot(s)] = qtt::ONES;
  };

  // text ring: chunk 0 (columns 0-63) now, chunk 1 in flight in `pend`;
  // at step t_fill the chunk in flight is stored and the next one loaded
  for (int i = tid; i < W; i += T) ring[i] = txt[i];
  uint32_t pend = 0;
  if (tid < W / 4 && NB > 1)
    pend = reinterpret_cast<const uint32_t*>(txt + W)[tid];
  int chunk = 2;         // chunks below chunk - 1 are in the ring
  // the highest column a row reads at step t is that of local clock
  // t - base: chunk c - 1 is stored from t - base + 1 >= CY * (c - 2)
  auto fill_step = [&]() {
    return chunk <= NB ? CY * (chunk - 2) + base - 1 : T_end;
  };
  int t_fill = fill_step();

#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int k = tid * M + s;            // base 0: row == slot
    fl(s) = 0;                            // never live if it holds no row
    if (s >= nvalid) continue;
    pv[s] = qtt::ONES;
    mv[s] = 0;
    sc(s) = (k - pro + 1) * W;
    fl(s) = (k >= f0 ? F_BOT : 0) | (k <= l0 ? F_TOP : 0) |
            (k == f0 ? F_ISF : 0);
    take(s, k);
  }
  exch[T + tid] = 0;
  if (tid == 0) {
    fring[0] = f0;
    lring[0] = l0;
  }
  __syncthreads();
  if constexpr (WORDS == IN_DEVICE) {
#pragma unroll 1
    for (int s = 0; s < M; ++s)
      if (s < nvalid) prefetch(s, tid * M + s, 0);
  }

  // the resident row of slot s: the one in [base, base + NS) congruent to
  // its physical slot modulo NS
  int off = 0;                           // base % NS
  auto row_of = [&](int s) {
    const int p = tid * M + s;
    return base + (p >= off ? p - off : p - off + NS);
  };
  auto resident = [&](int row) { return row >= base && row < base + NS; };
  // the recenter's inputs change only at E1, E2 and a recenter
  bool recheck = true;

  for (int t = 0; t < T_end; ++t) {
    const int par = t & 1;
    if (t >= t_fill) {
      if (tid < W / 4) {
        reinterpret_cast<uint32_t*>(ring + (((chunk - 1) * W) & TRm))[tid] =
            pend;
        if (chunk < NB)
          pend = reinterpret_cast<const uint32_t*>(txt + (size_t)chunk * W)
              [tid];
      }
      ++chunk;
      t_fill = fill_step();
    }
    const bool e1 = t == t_e1, c1 = t == t_c1, e2 = t == t_c1 + 1;

    // ---- mask edits the machines scheduled for this step ----
    if (t - bd_t <= 3 || t == tp_t) {
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (s >= nvalid) continue;
        const int k = row_of(s);
        int f = fl(s);
        if (bd_case >= 1 && t == bd_t + 1 && k == bd_row)
          f &= ~(F_BOT | F_ISF);
        if (t == bd_t + 2 && k == bd_row + 1) {
          if (bd_case == 1) f |= F_ISF;
          if (bd_case == 2) f &= ~(F_BOT | F_ISF);
        }
        if (bd_case == 2 && t == bd_t + 3 && k == bd_row + 2) f |= F_ISF;
        if (t == tp_t && k == tp_row) f |= F_TOP;
        fl(s) = f;
      }
    }

    // ---- one advance per live resident row (top slot first: a slot
    // reads its lower slot's carry-out of the previous step) ----
    const int* ex_in = exch + (par ^ 1) * T;
    if constexpr (WORDS == IN_DEVICE) qtt::cp_async_wait_all();
    if constexpr (WORDS == IN_REGS) {
      // A warp with no live row skips the advances. In the others every
      // row advances without a branch and a row that is not live, or
      // reads no column at this step, drops the result: so the rows'
      // loads and advances overlap, where a branch per row chains them.
      bool any = false;
#pragma unroll
      for (int s = 0; s < M; ++s) any |= (fl(s) & F_LIVE) == F_LIVE;
      if (__any_sync(__activemask(), any)) {
#pragma unroll
        for (int s = M - 1; s >= 0; --s) {
          const int f = fl(s);
          const int k = row_of(s);
          const int u = t - k;
          const unsigned q = (unsigned)u / CY, r = (unsigned)u - CY * q;
          const unsigned col = W * q + r;
          const bool act = (f & F_LIVE) == F_LIVE && u >= 0 && r != W &&
                           (int)col < tfin;
          const int hin = k == base ? 0
                          : s > 0   ? fl(s - 1)
                                    : ex_in[tid == 0 ? T - 1 : tid - 1];
          const uint64_t eq = qtt::pick(eqr[s], ring[col & TRm]);
          const bool isf = f & F_ISF;
          uint32_t ph = isf ? 1u : (uint32_t)(hin & F_PHO);
          uint32_t mh = isf ? 0u : (uint32_t)((hin & F_MHO) >> 1);
          uint64_t P = pv[s], Mv = mv[s];
          qtt::advance_block(eq, lmr[s], P, Mv, ph, mh);
          pv[s] = act ? P : pv[s];
          mv[s] = act ? Mv : mv[s];
          sc(s) += act ? (int)ph - (int)mh : 0;
          fl(s) = (f & ~(F_PHO | F_MHO)) |
                  (act ? (int)ph | ((int)mh << 1) : 0);
        }
      } else {
#pragma unroll
        for (int s = 0; s < M; ++s) fl(s) &= ~(F_PHO | F_MHO);
      }
    } else {
      // a branch per row around its advance (8 or 34 rows a thread)
#pragma unroll
      for (int s = M - 1; s >= 0; --s) {
        int f = fl(s);
        int outs = 0;
        if ((f & F_LIVE) == F_LIVE) {
          const int k = row_of(s);
          const int col = column(t - k);
          if (col >= 0) {
            int hin;
            if (k == base)
              hin = 0;
            else if (s > 0)
              hin = fl(s - 1);
            else
              hin = ex_in[tid == 0 ? T - 1 : tid - 1];
            uint64_t eq, lmk;
            if constexpr (WORDS == IN_REGS) {
              eq = qtt::pick(eqr[s], ring[col & TRm]);
              lmk = lmr[s];
            } else if constexpr (WORDS == IN_SHARED) {
              eq = sm_eq[(s * 5 + ring[col & TRm]) * T + tid];
              lmk = sm_lm[s * T + tid];
            } else {
              eq = sm_eq[slot(s)];
              lmk = sm_lm[slot(s)];
            }
            const bool isf = f & F_ISF;
            uint32_t ph = isf ? 1u : (uint32_t)(hin & F_PHO);
            uint32_t mh = isf ? 0u : (uint32_t)((hin & F_MHO) >> 1);
            qtt::advance_block(eq, lmk, pv[s], mv[s], ph, mh);
            sc(s) += (int)ph - (int)mh;
            outs = (int)ph | ((int)mh << 1);
          }
        }
        fl(s) = (f & ~(F_PHO | F_MHO)) | outs;
      }
    }
    if (e1 || c1 || e2) {
      const int w1 = nbB + fsB + 1, w2 = nbT + lsT - 1, w3 = nbT + lsT;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        if (s >= nvalid) continue;
        const int k = row_of(s);
        if (e1 && k == w1) sval[par][0] = sc(s);
        if (c1 && k == w2) sval[par][1] = sc(s);
        if (e2 && k == w3) sval[par][2] = sc(s);
      }
    }
    int top = fl(0);                     // the highest slot's carry-out
#pragma unroll
    for (int s = 1; s < M; ++s)
      if (s < nvalid) top = fl(s);
    exch[par * T + tid] = top & (F_PHO | F_MHO);
    if constexpr (WORDS == IN_DEVICE) {
#pragma unroll 1
      for (int s = 0; s < M; ++s)
        if (s < nvalid) prefetch(s, row_of(s), t + 1);
    }
    __syncthreads();

    // ---- bottom machine: E1(nbB) ----
    if (e1) {
      const int faB = nbB + fsB;
      const bool ds_b = (long)(nbB + 1) * W <= tfin;
      const bool exact = nbB <= nbT;
      const int last_b = lring[nbB % RING];
      const int lb = lsT - (nbB - nbT);
      const bool b_true = exact ? fsB + 2 < last_b : fsB + 2 < lb;
      const bool b_false = exact ? !(fsB + 2 < last_b) : fsB + 2 >= lsT;
      if (ds_b && !b_true && !b_false) abort = 1;
      const int c_first1 = resident(faB + 1) ? sval[par][0] : 0;
      const bool a_pred = (fv > W * (fsB + 1)) &&
                          (c_first1 + (fv - W * (fsB + 1)) > co);
      const bool cut_lower = a_pred && b_true;
      const int inc = ds_b && cut_lower && nbB >= pro;
      const int dec = ds_b && !cut_lower && nbB < pro;
      const int new_fs = fsB + inc - dec;
      if (ds_b) {
        bd_t = t;
        bd_row = faB;
        bd_case = 1 + new_fs - fsB;
      }
      fring[(nbB + 1) % RING] = new_fs;    // same value from every thread
      ++nbB;
      fsB = new_fs;
      t_e1 = nbB < NB ? 66 * nbB + fsB + 64 : -1;
    }

    // ---- top machine: c_last1 capture and E2(nbT) ----
    auto first_le = [&](int thr, int nb_q, bool &yes, bool &no) {
      // first(nb_q) <= thr, exactly or from the bound |nb_q - nbB| when
      // the bottom machine has not decided chunk nb_q yet
      const bool exact = nb_q <= nbB;
      const int f_ex = fring[exact ? nb_q % RING : 0];
      const int dist = nb_q - nbB;
      yes = exact ? f_ex <= thr : fsB + dist <= thr;
      no = exact ? f_ex > thr : fsB - dist > thr;
    };
    if (c1) {
      const int laT = nbT + lsT;
      const bool ds_t = (long)(nbT + 1) * W <= tfin;
      bool yes, no;
      first_le(lsT - 1, nbT, yes, no);
      if (ds_t && !yes && !no) abort = 1;
      const int v = resident(laT - 1) ? sval[par][1] : 0;
      cl1 = ds_t && yes ? v : 0;
    }
    if (e2) {
      const int laT = nbT + lsT;
      const bool ds_t = (long)(nbT + 1) * W <= tfin;
      bool m_t, m_f, bt_t, bt_f;
      first_le(lsT, nbT, m_t, m_f);
      first_le(lsT - 3, nbT + 1, bt_t, bt_f);
      if (ds_t && ((!m_t && !m_f) || (!bt_t && !bt_f))) abort = 1;
      const int c_last =
          ds_t && m_t ? (resident(laT) ? sval[par][2] : 0) : 0;
      const bool cut_higher = bt_t && (W * (lsT - 1) > fv) &&
                              (cl1 + (W * (lsT - 1) - fv) > co);
      const bool clamp = nbT - pro + lsT >= nbr_b;
      if (ds_t && laT + 1 - base >= NS) abort = 1;
      if (ds_t && resident(laT + 1)) {
#pragma unroll
        for (int s = 0; s < M; ++s)
          if (s < nvalid && row_of(s) == laT + 1) sc(s) = c_last + W;
      }
      const int new_ls = lsT - (ds_t && (cut_higher || clamp) ? 1 : 0);
      if (ds_t && new_ls == lsT) {
        tp_t = t + 3;
        tp_row = laT + 1;
      }
      lring[(nbT + 1) % RING] = new_ls;    // same value from every thread
      ++nbT;
      lsT = new_ls;
      t_c1 = nbT < NB ? 66 * nbT + lsT + 62 : -1;
    }

    // ---- recenter: the 128 rows at the bottom leave the window, their
    // slots take the 128 rows above it ----
    if (recheck || e1 || e2) {
      const int nb_floor = min(nbB, nbT);
      const int f_floor = fring[nb_floor % RING];
      const int laT1 = nbT + lsT + 1;
      recheck = (laT1 - base >= NS - 1 - RECENTER) &&
                (base + RECENTER <= tf64) &&
                (nb_floor + f_floor > base + RECENTER - 1);
      if (recheck) {
        if (laT1 - base > NS - 1 - RECENTER) abort = 1;
#pragma unroll
        for (int s = 0; s < M; ++s) {
          if (s < nvalid && row_of(s) < base + RECENTER) {
            pv[s] = qtt::ONES;
            mv[s] = 0;
          }
        }
        // (IN_DEVICE: a loop of its own, not unrolled, for registers)
#pragma unroll(WORDS == IN_DEVICE ? 1 : M)
        for (int s = 0; s < M; ++s) {
          const int k = row_of(s);
          if (s < nvalid && k < base + RECENTER) {
            if (k <= K) scores[(size_t)k * Bs + b] = sc(s);
            sc(s) = (k + NS - pro + 1) * W;
            fl(s) = F_BOT;
            take(s, k + NS);
            if constexpr (WORDS == IN_DEVICE) prefetch(s, k + NS, t + 1);
          }
        }
        base += RECENTER;
        off = base % NS;
        t_fill = fill_step();
      }
    }
  }

  // ---- collect ----
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int k = row_of(s);
    if (s < nvalid && k <= K) scores[(size_t)k * Bs + b] = sc(s);
  }
  for (int r = base + NS + tid; r <= K; r += T)
    scores[(size_t)r * Bs + b] = (r - pro + 1) * W;
  for (int i = tid; i < EBB; i += T) {
    pv_out[(size_t)i * Bs + b] = qtt::ONES;
    mv_out[(size_t)i * Bs + b] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int i = row_of(s) - tf64;      // output slot i is row tf64 + i
    if (s < nvalid && i >= 0 && i < EBB) {
      pv_out[(size_t)i * Bs + b] = pv[s];
      mv_out[(size_t)i * Bs + b] = mv[s];
    }
  }
  if (tid == 0) {
    first_out[b] = fsB;
    last_out[b] = lsT;
    abort_out[b] = abort;
  }
}

template <int M, int WORDS>
cudaError_t launch(int B, int NS, size_t smem, cudaStream_t s,
                   const uint64_t* peq, const uint64_t* lm,
                   const uint8_t* text_pm, const int32_t* cutoff,
                   const int32_t* prolog, const int32_t* nbr,
                   const int32_t* finish_v, const int32_t* tfinish,
                   const int32_t* first0, const int32_t* last0,
                   int32_t* scores, uint64_t* pv, uint64_t* mv,
                   int32_t* first_out, int32_t* last_out, int32_t* abort_out,
                   int EBB, int NB, int RING, int TR) {
  const int T = (NS + M - 1) / M;
  if (T > max_threads(WORDS)) return cudaErrorInvalidValue;
  auto kernel = banded_sysband_kernel<M, WORDS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, T, smem, s>>>(peq, lm, text_pm, cutoff, prolog, nbr,
                                 finish_v, tfinish, first0, last0, scores, pv,
                                 mv, first_out, last_out, abort_out, B, EBB,
                                 NB, NS, RING, TR);
  return cudaGetLastError();
}

}  // namespace

// rows_per_thread and words (0 registers, 1 shared, 2 device) as
// ops/banded_sysband_cuda.py:sysband_launch chooses them; TR, the text
// ring's bytes, a power of two of at least NS + 512.
extern "C" int qtt_banded_sysband(const void* peq, const void* lm,
                                  const void* text_pm, const void* cutoff,
                                  const void* prolog, const void* nbr,
                                  const void* finish_v, const void* tfinish,
                                  const void* first0, const void* last0,
                                  void* scores, void* pv, void* mv,
                                  void* first_out, void* last_out,
                                  void* abort_out, int B, int EBB, int NB,
                                  int NS, int RING, int rows_per_thread,
                                  int words, int TR, void* stream) {
  if (B <= 0) return 0;
  if (NS % RECENTER != 0 || RING > MAX_RING || RING < 1 ||
      (TR & (TR - 1)) != 0 || TR < NS + 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = rows_per_thread;
  const size_t smem = M > 0 ? dyn_bytes(words, M, (NS + M - 1) / M, TR) : 0;
#define QTT_SYSBAND_ARGS                                                    \
  B, NS, smem, s, (const uint64_t*)peq, (const uint64_t*)lm,                \
      (const uint8_t*)text_pm, (const int32_t*)cutoff,                      \
      (const int32_t*)prolog, (const int32_t*)nbr,                          \
      (const int32_t*)finish_v, (const int32_t*)tfinish,                    \
      (const int32_t*)first0, (const int32_t*)last0, (int32_t*)scores,      \
      (uint64_t*)pv, (uint64_t*)mv, (int32_t*)first_out,                    \
      (int32_t*)last_out, (int32_t*)abort_out, EBB, NB, RING, TR
  cudaError_t err;
  if (rows_per_thread == 2 && words == IN_REGS)
    err = launch<2, IN_REGS>(QTT_SYSBAND_ARGS);
  else if (rows_per_thread == 8 && words == IN_SHARED)
    err = launch<8, IN_SHARED>(QTT_SYSBAND_ARGS);
  else if (rows_per_thread == 34 && words == IN_DEVICE)
    err = launch<34, IN_DEVICE>(QTT_SYSBAND_ARGS);
  else
    err = cudaErrorInvalidValue;
#undef QTT_SYSBAND_ARGS
  return (int)err;
}
