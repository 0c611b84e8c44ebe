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
// Design: one CTA per pair, NS = resident_rows(EBB) * 128 resident rows,
// M rows per thread in registers (Pv, Mv, score row, mask bits), so a
// step is M advances per thread and one __syncthreads. Rows live in a
// ring: physical slot p holds the resident row k = p (mod NS), so a
// recenter rewrites only the 128 slots whose rows left the window, and
// moves no data. A thread's lowest slot takes its carry from the next
// lower thread's highest slot of the previous step, through a
// double-buffered shared array. Every thread runs the scalar machines on
// the same values (the three score rows an event reads are published
// through shared memory before the barrier), so their decisions need no
// second barrier; the first/last rings live in shared memory and every
// thread writes the same value to them.
// What the TPU kernel needs and this one does not: the chars cascade (a
// row's text column is a function of the step, the row and nothing else,
// so each row reads it), the phase/column planes (functions of the step
// and the row too), the SMEM/VMEM split, the 4-char text packing and the
// DMA semaphores.
//
// What bounds it on the H100: the step count, ~66 * NB + NS, each ending
// in a barrier of NS / M threads; per step a row reads one PEQ word and
// one level mask (L1/L2) and one text byte.

#include "qtt_common.cuh"

namespace {

using qtt::W;
constexpr int CY = W + 1;          // 64 columns and one bubble per chunk
constexpr int RECENTER = 128;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_RING = 1024;
// mask bits of a resident row
constexpr int F_PHO = 1, F_MHO = 2, F_BOT = 4, F_TOP = 8, F_ISF = 16;

template <int M>
__global__ void __launch_bounds__(MAX_THREADS) banded_sysband_kernel(
    const uint64_t* __restrict__ peq,    // (K, 5, B)
    const uint64_t* __restrict__ lm,     // (K, B)
    const uint8_t* __restrict__ text,    // (NB*64, B)
    const int32_t* __restrict__ cutoff, const int32_t* __restrict__ prolog,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ finish_v,
    const int32_t* __restrict__ tfinish, const int32_t* __restrict__ first0,
    const int32_t* __restrict__ last0,
    int32_t* __restrict__ scores,        // (K+1, B)
    uint64_t* __restrict__ pv_out, uint64_t* __restrict__ mv_out,  // (EBB, B)
    int32_t* __restrict__ first_out, int32_t* __restrict__ last_out,
    int32_t* __restrict__ abort_out, int B, int EBB, int NB, int NS,
    int RING) {
  __shared__ int exch[2][MAX_THREADS];   // top row's carry-out, by parity
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

  // scalar machines (the same in every thread)
  int base = 0, nbB = 0, fsB = f0, nbT = 0, lsT = l0, cl1 = 0;
  int bd_t = -10, tp_t = -10;
  int bd_row = 0, bd_case = 0, tp_row = 0, abort = 0;

  uint64_t pv[M], mv[M];
  int srow[M], fl[M];
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int k = tid * M + s;            // base 0: row == slot
    pv[s] = qtt::ONES;
    mv[s] = 0;
    srow[s] = (k - pro + 1) * W;
    fl[s] = (k >= f0 ? F_BOT : 0) | (k <= l0 ? F_TOP : 0) |
            (k == f0 ? F_ISF : 0);
  }
  exch[1][tid] = 0;
  if (tid == 0) {
    fring[0] = f0;
    lring[0] = l0;
  }
  __syncthreads();

  // the resident row of slot s: the one in [base, base + NS) congruent to
  // its physical slot modulo NS
  int off = 0;                           // base % NS
  auto row_of = [&](int s) {
    const int p = tid * M + s;
    return base + (p >= off ? p - off : p - off + NS);
  };
  auto resident = [&](int row) { return row >= base && row < base + NS; };

  for (int t = 0; t < T_end; ++t) {
    const int par = t & 1;
    const bool e1 = nbB < NB && t == 66 * nbB + fsB + 64;
    const bool c1 = nbT < NB && t == 66 * nbT + lsT + 62;
    const bool e2 = nbT < NB && t == 66 * nbT + lsT + 63;
    const int w1 = nbB + fsB + 1, w2 = nbT + lsT - 1, w3 = nbT + lsT;

    // ---- mask edits the machines scheduled for this step ----
#pragma unroll
    for (int s = 0; s < M; ++s) {
      const int k = row_of(s);
      if (bd_case >= 1 && t == bd_t + 1 && k == bd_row)
        fl[s] &= ~(F_BOT | F_ISF);
      if (t == bd_t + 2 && k == bd_row + 1) {
        if (bd_case == 1) fl[s] |= F_ISF;
        if (bd_case == 2) fl[s] &= ~(F_BOT | F_ISF);
      }
      if (bd_case == 2 && t == bd_t + 3 && k == bd_row + 2) fl[s] |= F_ISF;
      if (t == tp_t && k == tp_row) fl[s] |= F_TOP;
    }

    // ---- one advance per resident row (top slot first: a slot reads its
    // lower slot's carry-out of the previous step) ----
#pragma unroll
    for (int s = M - 1; s >= 0; --s) {
      const int k = row_of(s);
      const int u = t - k;                // the row's local clock
      int hin;
      if (k == base)
        hin = 0;
      else if (s > 0)
        hin = fl[s - 1];
      else
        hin = exch[par ^ 1][tid == 0 ? T - 1 : tid - 1];
      int outs = 0;
      if (u >= 0) {
        const int q = u / CY, r = u - CY * q;
        const int col = W * q + r;
        if (r != W && col < tfin) {       // not the bubble, not finished
          const int c = text[(size_t)col * Bs + b];
          const uint64_t eq =
              k < K ? peq[((size_t)k * 5 + c) * Bs + b] : qtt::ONES;
          const uint64_t lmk = k < K ? lm[(size_t)k * Bs + b] : qtt::TOPBIT;
          const bool isf = fl[s] & F_ISF;
          uint32_t ph = isf ? 1u : (uint32_t)(hin & F_PHO);
          uint32_t mh = isf ? 0u : (uint32_t)((hin & F_MHO) >> 1);
          uint64_t P = pv[s], Mv = mv[s];
          qtt::advance_block(eq, lmk, P, Mv, ph, mh);
          if ((fl[s] & (F_BOT | F_TOP)) == (F_BOT | F_TOP)) {
            pv[s] = P;
            mv[s] = Mv;
            srow[s] += (int)ph - (int)mh;
          }
          outs = (int)ph | ((int)mh << 1);
        }
      }
      fl[s] = (fl[s] & ~(F_PHO | F_MHO)) | outs;
      if (e1 && k == w1) sval[par][0] = srow[s];
      if (c1 && k == w2) sval[par][1] = srow[s];
      if (e2 && k == w3) sval[par][2] = srow[s];
    }
    exch[par][tid] = fl[M - 1] & (F_PHO | F_MHO);
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
          if (row_of(s) == laT + 1) srow[s] = c_last + W;
      }
      const int new_ls = lsT - (ds_t && (cut_higher || clamp) ? 1 : 0);
      if (ds_t && new_ls == lsT) {
        tp_t = t + 3;
        tp_row = laT + 1;
      }
      lring[(nbT + 1) % RING] = new_ls;    // same value from every thread
      ++nbT;
      lsT = new_ls;
    }

    // ---- recenter: the 128 rows at the bottom leave the window ----
    const int nb_floor = min(nbB, nbT);
    const int f_floor = fring[nb_floor % RING];
    const int laT1 = nbT + lsT + 1;
    const bool trig = (laT1 - base >= NS - 1 - RECENTER) &&
                      (base + RECENTER <= tf64) &&
                      (nb_floor + f_floor > base + RECENTER - 1);
    if (trig) {
      if (laT1 - base > NS - 1 - RECENTER) abort = 1;
#pragma unroll
      for (int s = 0; s < M; ++s) {
        const int k = row_of(s);
        if (k < base + RECENTER) {
          if (k <= K) scores[(size_t)k * Bs + b] = srow[s];
          pv[s] = qtt::ONES;
          mv[s] = 0;
          srow[s] = (k + NS - pro + 1) * W;
          fl[s] = F_BOT;
        }
      }
      base += RECENTER;
      off = base % NS;
    }
  }

  // ---- collect ----
#pragma unroll
  for (int s = 0; s < M; ++s) {
    const int k = row_of(s);
    if (k <= K) scores[(size_t)k * Bs + b] = srow[s];
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
    if (i >= 0 && i < EBB) {
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

}  // namespace

extern "C" int qtt_banded_sysband(const void* peq, const void* lm,
                                  const void* text, const void* cutoff,
                                  const void* prolog, const void* nbr,
                                  const void* finish_v, const void* tfinish,
                                  const void* first0, const void* last0,
                                  void* scores, void* pv, void* mv,
                                  void* first_out, void* last_out,
                                  void* abort_out, int B, int EBB, int NB,
                                  int NS, int RING, void* stream) {
  if (B <= 0) return 0;
  if (NS % RECENTER != 0 || RING > MAX_RING || RING < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define QTT_SYSBAND_ARGS                                                    \
  (const uint64_t*)peq, (const uint64_t*)lm, (const uint8_t*)text,          \
      (const int32_t*)cutoff, (const int32_t*)prolog, (const int32_t*)nbr,  \
      (const int32_t*)finish_v, (const int32_t*)tfinish,                    \
      (const int32_t*)first0, (const int32_t*)last0, (int32_t*)scores,      \
      (uint64_t*)pv, (uint64_t*)mv, (int32_t*)first_out,                    \
      (int32_t*)last_out, (int32_t*)abort_out, B, EBB, NB, NS, RING
  if (NS <= MAX_THREADS)
    banded_sysband_kernel<1><<<B, NS, 0, s>>>(QTT_SYSBAND_ARGS);
  else if (NS <= 4 * MAX_THREADS)
    banded_sysband_kernel<4><<<B, NS / 4, 0, s>>>(QTT_SYSBAND_ARGS);
  else if (NS <= 16 * MAX_THREADS)
    banded_sysband_kernel<16><<<B, NS / 16, 0, s>>>(QTT_SYSBAND_ARGS);
  else
    return (int)cudaErrorInvalidValue;
#undef QTT_SYSBAND_ARGS
  return (int)cudaGetLastError();
}
