/*
 * Native host-side runtime for quicked_tpu.
 *
 * The device kernels (JAX/Pallas) produce band-matrix bit planes; the
 * sequential host-side walks and CIGAR machinery live here, re-expressing
 * the reference's C host code as a TPU-framework host runtime:
 *
 *   - banded traceback  (banded_backtrace_matrix_cutoff, bpm_banded.c:967-1036)
 *   - CIGAR edit score  (cigar_score_edit, cigar.c:274-289)
 *   - CIGAR correctness replay (cigar_check_alignment, cigar.c:363-434)
 *   - CIGAR RLE print   (cigar_sprint, cigar.c:453-488)
 *   - SAM packed CIGAR  (cigar_compute_CIGAR, cigar.c:193-240)
 *   - DNA 5-letter encode (dna_encode_table, dna_text.c:41-46)
 *
 * Bit planes are the kernels' native (T, EBB, B) u32 lo/hi layout —
 * accessed in place, no per-pair copies.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdio.h>
#include <string.h>
#include <pthread.h>
#include <sched.h>
#include <time.h>
#include <unistd.h>

#define W 64

/* ---------------------------------------------------------------- DNA */

/* Compile-time constant table (dna_encode_table, dna_text.c:41-46):
 * A/C/G/T upper+lower -> 0..3, everything else -> 4 ('N' bucket).
 * MUST be a static initializer, not lazily built: the batch pools call
 * qh_encode_dna from many threads, and a lazy memset+fill init raced
 * when a process's FIRST native call was multi-threaded — one thread's
 * re-init momentarily wiped entries under another thread's encode,
 * producing rare wrong scores (round-4 root cause; proven by a
 * fork+threads stress at ~1/1500 per cold process). */
#define QH_DT4_16 4,4,4,4, 4,4,4,4, 4,4,4,4, 4,4,4,4
static const uint8_t dna_table[256] = {
    QH_DT4_16, QH_DT4_16, QH_DT4_16, QH_DT4_16,         /* 0x00-0x3f */
    /* 0x40: @ A B C D E F G | H I J K L M N O */
    4, 0, 4, 1, 4, 4, 4, 2,   4, 4, 4, 4, 4, 4, 4, 4,
    /* 0x50: P Q R S T U V W | X Y Z ...       */
    4, 4, 4, 4, 3, 4, 4, 4,   4, 4, 4, 4, 4, 4, 4, 4,
    /* 0x60: ` a b c d e f g | h i j k l m n o */
    4, 0, 4, 1, 4, 4, 4, 2,   4, 4, 4, 4, 4, 4, 4, 4,
    /* 0x70: p q r s t u v w | x y z ...       */
    4, 4, 4, 4, 3, 4, 4, 4,   4, 4, 4, 4, 4, 4, 4, 4,
    QH_DT4_16, QH_DT4_16, QH_DT4_16, QH_DT4_16,         /* 0x80-0xbf */
    QH_DT4_16, QH_DT4_16, QH_DT4_16, QH_DT4_16,         /* 0xc0-0xff */
};

void qh_encode_dna(const uint8_t *raw, int64_t n, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) out[i] = dna_table[raw[i]];
}

/* ---------------------------------------------------------- traceback */

/* floor division/modulo (C truncates toward zero; the traceback's
 * effective-row arithmetic needs Python's floor semantics for negative
 * values, which are then range-guarded) */
static inline int64_t fdiv64(int64_t a) {
    return (a >= 0) ? a / 64 : -((-a + 63) / 64);
}
static inline int64_t fmod64(int64_t a) {
    return a - fdiv64(a) * 64;
}

/* Bit (t, block, bit) of a (T, EBB, B) u32-pair plane for lane `lane`;
 * column index `col` is the reference DP column (col 0 = init column:
 * Pv = ones, Mv = zeros; col c>0 = plane row c-1). */
static inline int plane_bit(const uint32_t *lo, const uint32_t *hi,
                            int64_t ebb, int64_t nlanes, int64_t lane,
                            int64_t col, int64_t block, int64_t bit,
                            int init_val) {
    if (col == 0) return init_val;
    const int64_t base = ((col - 1) * ebb + block) * nlanes + lane;
    const uint32_t w = (bit < 32) ? lo[base] : hi[base];
    return (int)((w >> (bit & 31)) & 1u);
}

/*
 * Walk one pair's alignment path. Tie-break order D, I, M, X
 * (bpm_banded.c:1001-1023); the M-test compares RAW characters
 * (bpm_banded.c:1012). Writes forward-order ops into `ops_out`
 * (capacity >= plen + tlen); returns the number of ops.
 */
int64_t qh_traceback_banded(
    const uint32_t *pv_lo, const uint32_t *pv_hi,
    const uint32_t *mv_lo, const uint32_t *mv_hi,
    int64_t ebb, int64_t nlanes, int64_t lane,
    const uint8_t *pattern, int64_t plen,
    const uint8_t *text, int64_t tlen,
    int64_t prolog, char *ops_out) {
    int64_t h = tlen - 1;
    int64_t v = plen - 1;
    char *rev = ops_out;   /* fill backwards from the end */
    int64_t cap = plen + tlen;
    int64_t n = 0;
    /* write right-to-left into ops_out[cap-1-n] */
    while (v >= 0 && h >= 0) {
        const int64_t block_h = h / W;
        const int64_t block_h_r = (h + 1) / W;
        const int64_t eff_v = v - W * (block_h - prolog);
        const int64_t eff_v_r = v - W * (block_h_r - prolog);
        const int64_t block_v = fdiv64(eff_v);
        const int64_t block_v_r = fdiv64(eff_v_r);
        const int64_t bit = fmod64(eff_v);
        const int64_t bit_r = fmod64(eff_v_r);
        char op;
        if (block_v_r >= 0 && block_v_r < ebb &&
            plane_bit(pv_lo, pv_hi, ebb, nlanes, lane, h + 1, block_v_r,
                      bit_r, 1)) {
            op = 'D'; v--;
        } else if (block_v >= 0 && block_v < ebb &&
                   plane_bit(mv_lo, mv_hi, ebb, nlanes, lane, h, block_v,
                             bit, 0)) {
            op = 'I'; h--;
        } else if (text[h] == pattern[v]) {
            op = 'M'; h--; v--;
        } else {
            op = 'X'; h--; v--;
        }
        rev[cap - 1 - n] = op;
        n++;
    }
    while (h >= 0) { rev[cap - 1 - n] = 'I'; n++; h--; }
    while (v >= 0) { rev[cap - 1 - n] = 'D'; n++; v--; }
    /* move to the front */
    memmove(ops_out, ops_out + cap - n, (size_t)n);
    return n;
}

/*
 * Batched banded traceback over the device kernels' lane-tiled planes
 * (P, T, EBB, LANES): pair i walks tile i/LANES, lane i%LANES. One
 * call for the whole batch with a pthread pool inside — the per-pair
 * ctypes dispatch (~60 us/pair: argument marshalling + buffer setup
 * under the GIL) dominated the device full-fill lane's host stage at
 * short read lengths (PERFORMANCE.md workload-3 device lane).
 *
 * Sequences arrive as concatenated blobs with offset/length arrays;
 * ops_out regions are pre-sized plen+tlen per pair (the walk fills
 * backwards then memmoves to the region front, like the single-lane
 * entry). Returns 0, or -1 on a malformed geometry.
 */
typedef struct {
    const uint32_t *pv_lo, *pv_hi, *mv_lo, *mv_hi;
    int64_t tile_stride;   /* T * ebb * lanes u32 words per tile */
    int64_t ebb, lanes;
    const uint8_t *pat_blob; const int64_t *pat_off; const int64_t *pat_len;
    const uint8_t *txt_blob; const int64_t *txt_off; const int64_t *txt_len;
    const int64_t *prolog;
    char *ops_blob; const int64_t *ops_off;
    int64_t *ops_len;
    int64_t n;
    int64_t next;
} qh_tbb_t;

static void *qh_tbb_thread(void *arg) {
    qh_tbb_t *c = (qh_tbb_t *)arg;
    for (;;) {
        int64_t i = __atomic_fetch_add(&c->next, 1, __ATOMIC_RELAXED);
        if (i >= c->n) break;
        const int64_t off = (i / c->lanes) * c->tile_stride;
        c->ops_len[i] = qh_traceback_banded(
            c->pv_lo + off, c->pv_hi + off, c->mv_lo + off, c->mv_hi + off,
            c->ebb, c->lanes, i % c->lanes,
            c->pat_blob + c->pat_off[i], c->pat_len[i],
            c->txt_blob + c->txt_off[i], c->txt_len[i],
            c->prolog[i], c->ops_blob + c->ops_off[i]);
    }
    return NULL;
}

#define QH_TBB_MAX 16

int64_t qh_traceback_banded_batch(
    const uint32_t *pv_lo, const uint32_t *pv_hi,
    const uint32_t *mv_lo, const uint32_t *mv_hi,
    int64_t tile_stride, int64_t ebb, int64_t lanes,
    const uint8_t *pat_blob, const int64_t *pat_off, const int64_t *pat_len,
    const uint8_t *txt_blob, const int64_t *txt_off, const int64_t *txt_len,
    const int64_t *prolog, int64_t n,
    char *ops_blob, const int64_t *ops_off, int64_t *ops_len_out,
    int64_t n_threads) {
    if (ebb < 1 || lanes < 1 || n < 0) return -1;
    qh_tbb_t c = {pv_lo, pv_hi, mv_lo, mv_hi, tile_stride, ebb, lanes,
                  pat_blob, pat_off, pat_len, txt_blob, txt_off, txt_len,
                  prolog, ops_blob, ops_off, ops_len_out, n, 0};
    int T = (int)(n_threads > QH_TBB_MAX ? QH_TBB_MAX : n_threads);
    if (T < 1) T = 1;
    if ((int64_t)T > n) T = (int)(n > 0 ? n : 1);
    pthread_t tids[QH_TBB_MAX];
    int spawned = 0;
    for (int s = 1; s < T; s++) {
        if (pthread_create(&tids[s], NULL, qh_tbb_thread, &c) != 0)
            break;
        spawned++;
    }
    qh_tbb_thread(&c);
    for (int s = 1; s <= spawned; s++)
        pthread_join(tids[s], NULL);
    return 0;
}

/* ------------------------------------------------------------- CIGAR */

int64_t qh_cigar_score_edit(const char *ops, int64_t n) {
    /* cigar_score_edit (cigar.c:274-289): M = 0; X/I/D = 1. */
    int64_t score = 0;
    for (int64_t i = 0; i < n; i++) score += (ops[i] != 'M');
    return score;
}

/*
 * Replay the ops against both sequences (cigar_check_alignment,
 * cigar.c:363-434). Returns 1 if valid, 0 otherwise.
 */
int qh_cigar_check(const char *ops, int64_t n,
                   const uint8_t *pattern, int64_t plen,
                   const uint8_t *text, int64_t tlen) {
    int64_t p = 0, t = 0;
    for (int64_t i = 0; i < n; i++) {
        switch (ops[i]) {
        case 'M':
            if (p >= plen || t >= tlen) return 0;
            if (pattern[p] != text[t]) return 0;
            p++; t++;
            break;
        case 'X':
            if (p >= plen || t >= tlen) return 0;
            if (pattern[p] == text[t]) return 0;
            p++; t++;
            break;
        case 'I':
            if (t >= tlen) return 0;
            t++;
            break;
        case 'D':
            if (p >= plen) return 0;
            p++;
            break;
        default:
            return 0;
        }
    }
    return (p == plen) && (t == tlen);
}

/*
 * RLE text form (cigar_sprint, cigar.c:453-488). `print_matches`
 * selects whether M runs are printed. Returns chars written (no NUL).
 * `out` capacity: 12 * n is always enough.
 */
int64_t qh_cigar_sprint(const char *ops, int64_t n, int print_matches,
                        char *out) {
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        char op = ops[i];
        int64_t run = 1;
        while (i + run < n && ops[i + run] == op) run++;
        if (op != 'M' || print_matches) {
            /* write run length then op */
            char tmp[24];
            int len = 0;
            int64_t x = run;
            do { tmp[len++] = (char)('0' + (x % 10)); x /= 10; } while (x);
            while (len) out[w++] = tmp[--len];
            out[w++] = op;
        }
        i += run;
    }
    return w;
}

/*
 * SAM-compliant packed CIGAR (cigar_compute_CIGAR, cigar.c:193-240):
 * adjacent M/X collapse into 'M' ops; entries are (len << 4) | opcode
 * with opcodes M=0, I=1, D=2. Returns number of uint32 entries.
 */
int64_t qh_cigar_sam(const char *ops, int64_t n, uint32_t *out) {
    static const uint8_t code[256] = {
        ['M'] = 0, ['X'] = 0, ['I'] = 1, ['D'] = 2 };
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t c = code[(uint8_t)ops[i]];
        int64_t run = 1;
        while (i + run < n && code[(uint8_t)ops[i + run]] == c) run++;
        out[w++] = ((uint32_t)run << 4) | c;
        i += run;
    }
    return w;
}

/* --------------------------------------------- banded score (CPU path) */

/*
 * Host-native BandEd score-only kernel: the CPU-fallback compute path
 * when no accelerator is available. Written from this repo's semantic
 * model (ops/myers_np.py: banded_score), not from the reference C —
 * same dataflow by construction: 64-bit Myers blocks, score-window band
 * with dynamic cut/shift every 64 text columns.
 *
 * pattern_enc/text_enc: 5-letter-encoded sequences. Returns the final
 * score; optionally exports the final band state for the Hirschberg
 * driver (pass NULL to skip): pv/mv (ebb_out words), first/last block,
 * and the block-row score array scores_out[row + prolog] for
 * row in [-prolog, nb_total + ebb).
 */
#include <stdlib.h>

#define QH_W 64
#define QH_WS_MAX 16   /* fixed window-buffer depth of the WindowEd kernels */

static inline int64_t qh_div_ceil(int64_t a, int64_t b) {
    return (a + b - 1) / b;
}

/* 4 x 64-bit SIMD lanes (GCC portable vector extensions; compiles to
 * AVX2 on x86, NEON pairs elsewhere, scalar code as a last resort). */
typedef uint64_t qh_v4u64 __attribute__((vector_size(32)));
typedef int64_t qh_v4i64 __attribute__((vector_size(32)));

/* Runtime SIMD toggle — the analogue of the reference's force_scalar
 * (bpm_banded.c:1049-1059 picks the scalar compute function over the
 * AVX one at align time). When set, banded fills take the scalar
 * column loop instead of the 4-column vector pipeline AND the threaded
 * wavefront built on it (its strips run the same vector kernel).
 * Process-global (set once before aligning, vs the reference's
 * per-aligner field); relaxed atomics so concurrent fills read safely. */
static int qh_force_scalar = 0;

void qh_set_force_scalar(int v) {
    __atomic_store_n(&qh_force_scalar, v ? 1 : 0, __ATOMIC_RELAXED);
}

int qh_get_force_scalar(void) {
    return __atomic_load_n(&qh_force_scalar, __ATOMIC_RELAXED);
}

/* Diagnostic counter: vector 4-column passes executed. Lets tests (and
 * the CLI's profile output) PROVE the toggle changed the kernel path
 * instead of inferring it from timing. One relaxed add per 4 columns
 * is noise next to the (band-depth x 20)-op pass body. */
static int64_t qh_simd_passes = 0;

int64_t qh_simd_pass_count(void) {
    return __atomic_load_n(&qh_simd_passes, __ATOMIC_RELAXED);
}

/*
 * Anti-diagonal 4-column pipeline over the live band: lane j advances
 * column c+j at block first + t - j during wavefront step t, so the
 * PHin/MHin carries stay in-lane (same column, previous block) and the
 * Pv/Mv values flow one lane per step (same block, previous column).
 * Identical dataflow to the scalar loop — only independent (column,
 * block) cells are reordered — so results are bit-exact.
 *
 * Processes columns [t0, t0+4) over blocks [first, last]; scores are
 * accumulated per block row like the scalar loop.
 */
static inline void qh_banded_cols4_c(
    const uint64_t *peq, int64_t nw, uint64_t lm_last, int64_t mod,
    const uint8_t *text_enc, int64_t t0,
    uint64_t *Pv, uint64_t *Mv, int64_t *sc,
    int64_t first, int64_t last, int64_t pos_v, int64_t prolog,
    const uint8_t *cin_p, const uint8_t *cin_m,
    uint8_t *cout_p, uint8_t *cout_m) {
    __atomic_fetch_add(&qh_simd_passes, 1, __ATOMIC_RELAXED);
    const int c0 = text_enc[t0], c1 = text_enc[t0 + 1];
    const int c2 = text_enc[t0 + 2], c3 = text_enc[t0 + 3];
    const int cols[4] = {c0, c1, c2, c3};
    const int64_t span = last - first + 1;
    qh_v4u64 pv = {0, 0, 0, 0}, mv = {0, 0, 0, 0};
    qh_v4u64 phin = {0, 0, 0, 0}, mhin = {0, 0, 0, 0};
    qh_v4u64 eqv = {0, 0, 0, 0}, lmv = {0, 0, 0, 0};
    qh_v4i64 delta = {0, 0, 0, 0};   /* per-block score delta, rides the
                                        pipeline; one scalar update per
                                        block at retirement */
    for (int64_t t = 0; t < span + 3; t++) {
        /* shift pipelines one lane; lane 0 loads the entering block */
        pv = __builtin_shuffle(pv, (qh_v4u64){0, 0, 1, 2});
        mv = __builtin_shuffle(mv, (qh_v4u64){0, 0, 1, 2});
        eqv = __builtin_shuffle(eqv, (qh_v4u64){0, 0, 1, 2});
        lmv = __builtin_shuffle(lmv, (qh_v4u64){0, 0, 1, 2});
        delta = __builtin_shuffle(delta, (qh_v4i64){0, 0, 1, 2});
        delta[0] = 0;
        if (t < span) {
            const int64_t i0 = first + t;
            const int64_t row0 = i0 + pos_v;
            pv[0] = Pv[i0];
            mv[0] = Mv[i0];
            eqv[0] = (row0 < nw) ? peq[row0 * 5 + c0] : ~0ULL;
            lmv[0] = (row0 == nw - 1 && mod) ? lm_last : (1ULL << 63);
        }
        /* lanes entering their first block: the per-column carry in
         * (1/0 for the band bottom; the strip boundary carry in the
         * threaded wavefront) */
        if (t < 4) { phin[t] = cin_p[t]; mhin[t] = cin_m[t]; }
        /* per-lane Eq: lanes 1..3 reuse the shifted PEQ words only when
         * their column chars match lane 0's; reload otherwise */
        for (int j = 1; j < 4; j++) {
            if (cols[j] != cols[j - 1]) {
                const int64_t i = first + t - j;
                if (i >= first && i <= last) {
                    const int64_t row = i + pos_v;
                    eqv[j] = (row < nw) ? peq[row * 5 + cols[j]] : ~0ULL;
                }
            }
        }
        const qh_v4u64 xv = eqv | mv;
        const qh_v4u64 eq2 = eqv | mhin;
        const qh_v4u64 xh = (((eq2 & pv) + pv) ^ pv) | eq2;
        qh_v4u64 ph = mv | ~(xh | pv);
        qh_v4u64 mh = pv & xh;
        const qh_v4u64 phout = ((qh_v4u64)((ph & lmv) != 0)) & 1;
        const qh_v4u64 mhout = ((qh_v4u64)((mh & lmv) != 0)) & 1;
        ph = (ph << 1) | phin;
        mh = (mh << 1) | mhin;
        pv = mh | ~(xv | ph);
        mv = ph & xv;
        phin = phout;
        mhin = mhout;
        delta += (qh_v4i64)phout - (qh_v4i64)mhout;
        /* lane t-(span-1) just processed block `last`: its carry out
         * leaves the strip */
        {
            const int64_t jo = t - (span - 1);
            if (jo >= 0 && jo < 4) {
                cout_p[jo] = (uint8_t)phout[jo];
                cout_m[jo] = (uint8_t)mhout[jo];
            }
        }
        /* lane 3 retires its block (state + accumulated score delta) */
        if (t >= 3 && t - 3 < span) {
            const int64_t i3 = first + t - 3;
            Pv[i3] = pv[3];
            Mv[i3] = mv[3];
            sc[i3 + pos_v + prolog] += delta[3];
        }
    }
}

/* 8 x 64-bit lanes: one zmm on AVX-512, two interleaved ymm chains on
 * AVX2 — either way the per-step dependency chain (the carry add in
 * xh) is amortized over twice the cells of the 4-lane pipeline. The
 * reference reaches the same ILP with a hand-written 8-deep AVX2
 * column pipeline (bpm_banded.c:423-616); measured here the 4-lane
 * kernel ran ~1.7x behind it per thread on the ONT band geometry. */
typedef uint64_t qh_v8u64 __attribute__((vector_size(64)));
typedef int64_t qh_v8i64 __attribute__((vector_size(64)));

/* Anti-diagonal 8-column pipeline — same dataflow as qh_banded_cols4_c
 * (lane j advances column t0+j at block first + t - j), bit-exact with
 * the scalar loop; only independent (column, block) cells reorder.
 * Processes columns [t0, t0+8) over blocks [first, last]. */
static inline void qh_banded_cols8_c(
    const uint64_t *peq, int64_t nw, uint64_t lm_last, int64_t mod,
    const uint8_t *text_enc, int64_t t0,
    uint64_t *Pv, uint64_t *Mv, int64_t *sc,
    int64_t first, int64_t last, int64_t pos_v, int64_t prolog,
    const uint8_t *cin_p, const uint8_t *cin_m,
    uint8_t *cout_p, uint8_t *cout_m) {
    __atomic_fetch_add(&qh_simd_passes, 1, __ATOMIC_RELAXED);
    int cols[8];
    for (int j = 0; j < 8; j++) cols[j] = text_enc[t0 + j];
    const int c0 = cols[0];
    const int64_t span = last - first + 1;
    qh_v8u64 pv = {0}, mv = {0}, phin = {0}, mhin = {0};
    qh_v8u64 eqv = {0}, lmv = {0};
    qh_v8i64 delta = {0};
    const qh_v8u64 shf = {0, 0, 1, 2, 3, 4, 5, 6};
    for (int64_t t = 0; t < span + 7; t++) {
        pv = __builtin_shuffle(pv, shf);
        mv = __builtin_shuffle(mv, shf);
        eqv = __builtin_shuffle(eqv, shf);
        lmv = __builtin_shuffle(lmv, shf);
        delta = __builtin_shuffle(delta, (qh_v8i64)shf);
        delta[0] = 0;
        if (t < span) {
            const int64_t i0 = first + t;
            const int64_t row0 = i0 + pos_v;
            pv[0] = Pv[i0];
            mv[0] = Mv[i0];
            eqv[0] = (row0 < nw) ? peq[row0 * 5 + c0] : ~0ULL;
            lmv[0] = (row0 == nw - 1 && mod) ? lm_last : (1ULL << 63);
        }
        if (t < 8) { phin[t] = cin_p[t]; mhin[t] = cin_m[t]; }
        for (int j = 1; j < 8; j++) {
            if (cols[j] != cols[j - 1]) {
                const int64_t i = first + t - j;
                if (i >= first && i <= last) {
                    const int64_t row = i + pos_v;
                    eqv[j] = (row < nw) ? peq[row * 5 + cols[j]] : ~0ULL;
                }
            }
        }
        const qh_v8u64 xv = eqv | mv;
        const qh_v8u64 eq2 = eqv | mhin;
        const qh_v8u64 xh = (((eq2 & pv) + pv) ^ pv) | eq2;
        qh_v8u64 ph = mv | ~(xh | pv);
        qh_v8u64 mh = pv & xh;
        const qh_v8u64 phout = ((qh_v8u64)((ph & lmv) != 0)) & 1;
        const qh_v8u64 mhout = ((qh_v8u64)((mh & lmv) != 0)) & 1;
        ph = (ph << 1) | phin;
        mh = (mh << 1) | mhin;
        pv = mh | ~(xv | ph);
        mv = ph & xv;
        phin = phout;
        mhin = mhout;
        delta += (qh_v8i64)phout - (qh_v8i64)mhout;
        {
            const int64_t jo = t - (span - 1);
            if (jo >= 0 && jo < 8) {
                cout_p[jo] = (uint8_t)phout[jo];
                cout_m[jo] = (uint8_t)mhout[jo];
            }
        }
        if (t >= 7 && t - 7 < span) {
            const int64_t i7 = first + t - 7;
            Pv[i7] = pv[7];
            Mv[i7] = mv[7];
            sc[i7 + pos_v + prolog] += delta[7];
        }
    }
}

static const uint8_t QH_ONE8[8] = {1, 1, 1, 1, 1, 1, 1, 1};
static const uint8_t QH_ZERO8[8] = {0, 0, 0, 0, 0, 0, 0, 0};

static inline void qh_banded_cols8(
    const uint64_t *peq, int64_t nw, uint64_t lm_last, int64_t mod,
    const uint8_t *text_enc, int64_t t0,
    uint64_t *Pv, uint64_t *Mv, int64_t *sc,
    int64_t first, int64_t last, int64_t pos_v, int64_t prolog) {
    uint8_t sink_p[8], sink_m[8];
    qh_banded_cols8_c(peq, nw, lm_last, mod, text_enc, t0, Pv, Mv, sc,
                      first, last, pos_v, prolog,
                      QH_ONE8, QH_ZERO8, sink_p, sink_m);
}

static const uint8_t QH_ONE4[4] = {1, 1, 1, 1};
static const uint8_t QH_ZERO4[4] = {0, 0, 0, 0};

static inline void qh_banded_cols4(
    const uint64_t *peq, int64_t nw, uint64_t lm_last, int64_t mod,
    const uint8_t *text_enc, int64_t t0,
    uint64_t *Pv, uint64_t *Mv, int64_t *sc,
    int64_t first, int64_t last, int64_t pos_v, int64_t prolog) {
    uint8_t sink_p[4], sink_m[4];
    qh_banded_cols4_c(peq, nw, lm_last, mod, text_enc, t0, Pv, Mv, sc,
                      first, last, pos_v, prolog,
                      QH_ONE4, QH_ZERO4, sink_p, sink_m);
}

/* ------------- multithreaded banded score: wavefront row strips ------
 *
 * The band's block rows are split into contiguous strips; strip s
 * advances the same anti-diagonal 4-column pipeline as the serial
 * kernel over its rows, consuming the per-column carry (PHout/MHout)
 * published by strip s-1 and publishing its own to strip s+1. Only
 * independent (column, block) cells are reordered, so results are
 * bit-exact with the serial kernel. Band maintenance (every 64
 * columns) runs serially on the LAST active strip's thread — the
 * carry handoffs already order strip completions within a block, so
 * no barrier is needed before it; a maintained-block sequence number
 * (bseq) releases the next block (and the re-partitioned strips) to
 * everyone else. The earlier design paid two full spin barriers per
 * block here, ~35% of ONT-geometry wall at 4 threads.
 */
#define QH_BMT_MAX 16

static inline void qh_cpu_relax(void) {
#if defined(__x86_64__) || defined(__i386__)
    __builtin_ia32_pause();
#endif
}

/* Spin briefly, then yield: with more runnable threads than cores a
 * pure pause-spin live-locks (the publisher never gets a core). */
static inline void qh_spin_step(int64_t *spins) {
    if (++*spins < 1024) qh_cpu_relax();
    else { sched_yield(); *spins = 0; }
}

/* Block-scale wait: spin, then yield, then SLEEP (50 us escalating to
 * 500 us). Used for the per-block sequence wait, where a strip
 * deactivated by the load-adaptive partition may sit out thousands of
 * blocks — a yield loop there stays runnable and burns the very cores
 * the shrink freed; a parked sleeper costs nothing and rejoins within
 * half a millisecond when the partition grows back. */
static inline void qh_spin_step_park(int64_t *spins) {
    int64_t s = ++*spins;
    if (s < 1024) { qh_cpu_relax(); return; }
    if (s < 1024 + 16) { sched_yield(); return; }
    /* exponential backoff 50 us -> 5 ms: every wake of a parked strip
     * tends to preempt an active strip (CFS wakeup preemption), and at
     * 500 us cadence that measured ~25% overhead on the loaded ONT
     * score; at 5 ms it is noise, while re-activation latency stays
     * far below the call's duration */
    int64_t extra = s - (1024 + 16);
    long ns = 50000L << (extra < 7 ? extra : 7);
    struct timespec ts = {0, ns > 5000000L ? 5000000L : ns};
    nanosleep(&ts, NULL);
}

/* Instantaneous free-core estimate for the intra-pair wavefront:
 * cores not already occupied by OTHER runnable threads
 * (/proc/stat procs_running counts this thread too). The wavefront's
 * fine-grained carry handoffs stall EVERY strip when one strip loses
 * its core, so on a co-loaded host running fewer strips (or serial)
 * beats oversubscribing — round-4 benchmark runs measured the 4-strip
 * ONT score 2x SLOWER than serial under background load. Two samples
 * 100 us apart, taking the min of "others", so one scheduler blip
 * does not needlessly serialize. QUICKED_TPU_NO_ADAPT=1 disables. */
static long qh_other_runnable_once(void) {
    FILE *f = fopen("/proc/stat", "re");
    if (!f) return 0;
    char line[192];
    long running = 1;
    while (fgets(line, sizeof line, f)) {
        if (strncmp(line, "procs_running", 13) == 0) {
            running = atol(line + 13);
            break;
        }
    }
    fclose(f);
    return running > 1 ? running - 1 : 0;
}

static int qh_adaptive_cap(int want) {
    const char *e = getenv("QUICKED_TPU_NO_ADAPT");
    if (e && e[0] == '1') return want;
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    if (ncpu <= 0) return want;
    long other = qh_other_runnable_once();
    if (other > 0) {
        struct timespec ts = {0, 100000};
        nanosleep(&ts, NULL);
        long o2 = qh_other_runnable_once();
        if (o2 < other) other = o2;
    }
    long freec = ncpu - other;
    if (freec < 1) freec = 1;
    return want > freec ? (int)freec : want;
}

typedef struct {
    const uint64_t *peq;
    int64_t nw;
    uint64_t lm_last;
    int64_t mod;
    const uint8_t *text;
    uint64_t *Pv, *Mv;
    int64_t *sc;
    int64_t prolog, cutoff, finish_v, nbr, text_block;
    int T;
    int Tcap;          /* live strip cap, re-sampled by the maintainer */
    int free_prev;     /* previous sample's free-core estimate */
    int64_t mtick;     /* maintenance counter for the re-sample period */
    int adapt;         /* 0 when QUICKED_TPU_NO_ADAPT=1 */
    /* per-block state; thread 0 updates at maintenance */
    int64_t first, last, pos_v, pos_h;
    int active;
    int64_t s_lo[QH_BMT_MAX + 1];   /* strip s = [s_lo[s], s_lo[s+1]) */
    /* carry into strip s at column offset t (t mod 64) */
    uint8_t bp[QH_BMT_MAX][QH_W], bm[QH_BMT_MAX][QH_W];
    struct { volatile int64_t v; char pad[56]; } done[QH_BMT_MAX];
    /* maintained-block sequence number: the LAST active strip runs the
     * maintenance and publishes k+1 here (release); everyone else
     * spins (acquire) before starting block k+1. Replaces the two
     * full spin barriers per block of the earlier design. */
    volatile int64_t bseq;
    /* partition version seqlock: even value 2*g means active/s_lo are
     * the consistent partition FOR BLOCK g (odd = maintainer mid-
     * write). A thread that reads generation g > its own block k
     * thereby learns the system maintained block k without it — i.e.
     * it was NOT an active strip of k (an active strip's columns are
     * required for the block to complete) — and must skip the block.
     * Without the version tag, a thread descheduled between the bseq
     * wait and the partition read could apply block k+1's partition
     * to block k (deadlock on never-published carries, or a double
     * maintenance). */
    volatile int64_t pver;
    volatile int go;
} qh_bmt_t;

typedef struct { qh_bmt_t *c; int s; } qh_bmt_arg_t;

static void qh_bmt_partition(qh_bmt_t *c) {
    int64_t span = c->last - c->first + 1;
    int a = (int)(span / 16);        /* >= 16 blocks per strip */
    if (a > c->T) a = c->T;
    if (c->Tcap > 0 && a > c->Tcap) a = c->Tcap;
    if (a < 1) a = 1;
    /* relaxed atomics: readers race these inside the seqlock window
     * (values discarded on version mismatch) — atomic accesses keep
     * that formally data-race-free for TSan without extra ordering
     * (the pver SEQ_CST stores provide it) */
    __atomic_store_n(&c->active, a, __ATOMIC_RELAXED);
    for (int s = 0; s <= a; s++)
        __atomic_store_n(&c->s_lo[s], c->first + span * s / a,
                         __ATOMIC_RELAXED);
}

/* serial maintenance between barriers (same decisions/shift as the
 * serial kernel's loop tail) */
static void qh_bmt_maintain(qh_bmt_t *c) {
    int64_t first = c->first, last = c->last;
    const int64_t pos_v = c->pos_v, pos_h = c->pos_h;
    int64_t *sc = c->sc;
    int cut_lower = (first + 2 < last) && (c->finish_v > QH_W * (first + 1))
        && (sc[first + pos_v + 1 + c->prolog]
            + (c->finish_v - QH_W * (first + 1))) > c->cutoff;
    if (cut_lower && pos_h >= c->prolog) first += 1;
    else if (!cut_lower && pos_h < c->prolog) first -= 1;
    for (int64_t j = first; j < last; j++) {
        c->Pv[j] = c->Pv[j + 1];
        c->Mv[j] = c->Mv[j + 1];
    }
    c->Pv[last] = ~0ULL;
    c->Mv[last] = 0;
    int64_t pos = last + pos_v;
    sc[pos + 1 + c->prolog] = sc[pos + c->prolog] + QH_W;
    int cut_higher = (first + 2 < last) && (QH_W * (last - 1) > c->finish_v)
        && (sc[last + pos_v - 1 + c->prolog]
            + (QH_W * (last - 1) - c->finish_v)) > c->cutoff;
    if (cut_higher || (pos_v + last >= c->nbr)) last -= 1;
    /* mid-call load adaptation: every 32 blocks (~2 ms of columns)
     * re-sample other-runnable threads and cap the next partitions'
     * strip count — a co-located process arriving MID-score otherwise
     * stalls every strip through the carry chain for the rest of the
     * call (the call-entry sample can't see it). Our own active strips
     * are runnable (spin-waiters included), so subtract them from the
     * /proc/stat count. Shrinks AND grows back. */
    if (c->adapt && (++c->mtick & 31) == 0) {
        long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
        if (ncpu > 0) {
            long running = qh_other_runnable_once() + 1;  /* incl. self */
            int cur = __atomic_load_n(&c->active, __ATOMIC_RELAXED);
            long other = running - cur;
            if (other < 0) other = 0;
            long freec = ncpu - other;
            if (freec < 1) freec = 1;
            int est = freec > c->T ? c->T : (int)freec;
            if (est <= c->Tcap) {
                c->Tcap = est;          /* shrink immediately */
            } else {
                /* grow only when two consecutive samples agree — one
                 * optimistic sample (a busy thread briefly off-CPU)
                 * otherwise grows strips onto still-busy cores and
                 * thrashes until the next sample (measured: 0.75 ->
                 * 0.95 s on the loaded ONT score) */
                int g = est < c->free_prev ? est : c->free_prev;
                if (g > c->Tcap) c->Tcap = g;
            }
            c->free_prev = est;
        }
    }
    /* seqlock write of the next block's partition + walk state: odd
     * pver = mid-write; the final even value 2*(k+1) tags the
     * partition with the block it belongs to. SEQ_CST stores double
     * as compiler barriers so the plain field writes cannot move
     * outside the odd window. */
    __atomic_store_n(&c->pver, c->pver + 1, __ATOMIC_SEQ_CST);
    c->first = first;
    c->last = last;
    c->pos_v = pos_v + 1;
    c->pos_h = pos_h + 1;
    qh_bmt_partition(c);
    __atomic_store_n(&c->pver, c->pver + 1, __ATOMIC_SEQ_CST);
}

static void qh_bmt_work(qh_bmt_t *c, int s) {
    uint8_t sink_p[8], sink_m[8];
    int was_inactive = 0;
    int64_t park = 0;   /* backoff level, persists while inactive */
    for (int64_t k = 0; k < c->text_block; k++) {
        /* wait for block k-1's maintenance (the maintainer itself
         * stored bseq = k and passes through). The acquire also makes
         * the new partition/bounds visible before they are read. A
         * strip that sat out the previous block parks immediately —
         * it will likely sit out this one too, and waking every block
         * to spin would burn ~10% of a core per deactivated strip. */
        if (k > 0) {
            int64_t spins = was_inactive ? 1024 + 16 + park : 0;
            if (was_inactive) {
                while (__atomic_load_n(&c->bseq, __ATOMIC_ACQUIRE) < k)
                    qh_spin_step_park(&spins);
            } else {
                /* active strips wait tens of us for the trailing strip
                 * + maintenance — parking here oversleeps every block */
                while (__atomic_load_n(&c->bseq, __ATOMIC_ACQUIRE) < k)
                    qh_spin_step(&spins);
            }
        }
        /* seqlock partition read, tagged with its block generation.
         * bseq >= k guarantees generation >= k is published; a
         * generation > k means the system maintained block k WITHOUT
         * this thread (it was not an active strip — an active strip's
         * columns are required for a block to complete), so it must
         * skip the block rather than apply a later partition to it. */
        int active;
        int64_t lo = 0, hi = -1;
        int64_t pspins = 0;
        for (;;) {
            int64_t v1 = __atomic_load_n(&c->pver, __ATOMIC_SEQ_CST);
            if (!(v1 & 1)) {
                active = __atomic_load_n(&c->active, __ATOMIC_RELAXED);
                if (s < active) {
                    lo = __atomic_load_n(&c->s_lo[s], __ATOMIC_RELAXED);
                    hi = __atomic_load_n(&c->s_lo[s + 1],
                                         __ATOMIC_RELAXED) - 1;
                }
                /* the relaxed data loads must complete before the v2
                 * validation load on weakly-ordered ISAs — without the
                 * fence a torn partition could pass v1 == v2 */
                __atomic_thread_fence(__ATOMIC_ACQUIRE);
                int64_t v2 = __atomic_load_n(&c->pver, __ATOMIC_SEQ_CST);
                if (v2 == v1) {
                    if (v1 / 2 > k) {
                        active = -2;   /* sentinel: skip this block */
                    }
                    break;
                }
            }
            qh_spin_step(&pspins);
        }
        was_inactive = (s >= active);
        park = was_inactive ? (park < 7 ? park + 1 : 7) : 0;
        if (active == -2)
            continue;
        const int64_t t0g = k * QH_W;
        if (s < active) {
            /* 8-column passes: half the carry handoffs of the old
             * 4-column strips AND the deeper pipeline's ILP */
            for (int64_t t = 0; t < QH_W; t += 8) {
                const uint8_t *cin_p = QH_ONE8, *cin_m = QH_ZERO8;
                if (s > 0) {
                    int64_t spins = 0;
                    while (__atomic_load_n(&c->done[s - 1].v,
                                           __ATOMIC_ACQUIRE) < t0g + t + 8)
                        qh_spin_step(&spins);
                    cin_p = &c->bp[s][t];
                    cin_m = &c->bm[s][t];
                }
                uint8_t *co_p = sink_p, *co_m = sink_m;
                if (s + 1 < active) {
                    co_p = &c->bp[s + 1][t];
                    co_m = &c->bm[s + 1][t];
                }
                qh_banded_cols8_c(c->peq, c->nw, c->lm_last, c->mod,
                                  c->text, t0g + t, c->Pv, c->Mv, c->sc,
                                  lo, hi, c->pos_v, c->prolog,
                                  cin_p, cin_m, co_p, co_m);
                if (s + 1 < active)
                    __atomic_store_n(&c->done[s].v, t0g + t + 8,
                                     __ATOMIC_RELEASE);
            }
        }
        /* The carry handoffs order strip completions: strip s reaches
         * column t0g+64 only after acquiring done[s-1] >= t0g+64, so
         * when the LAST active strip finishes the block, every strip
         * has — and their writes are visible to it through the
         * release/acquire chain. It therefore runs the serial
         * maintenance immediately (no barrier) and publishes bseq. */
        if (s == active - 1) {
            qh_bmt_maintain(c);
            __atomic_store_n(&c->bseq, k + 1, __ATOMIC_RELEASE);
        }
    }
}

static void *qh_bmt_thread(void *arg_) {
    qh_bmt_arg_t *a = (qh_bmt_arg_t *)arg_;
    int64_t spins = 0;
    while (!__atomic_load_n(&a->c->go, __ATOMIC_ACQUIRE))
        qh_spin_step(&spins);
    qh_bmt_work(a->c, a->s);
    return NULL;
}

static int64_t qh_banded_score_n(
    const uint8_t *pattern_enc, int64_t plen,
    const uint8_t *text_enc, int64_t text_finish,
    int64_t text_len, int64_t cutoff_score,
    uint64_t *pv_out, uint64_t *mv_out,
    int64_t *first_out, int64_t *last_out,
    int64_t *scores_out, int64_t *ebb_out, int64_t n_threads) {
    /* band geometry (model: band_geometry) */
    int64_t k_end = (text_len > plen ? text_len - plen : plen - text_len) + 1;
    int64_t cutoff = k_end > cutoff_score ? k_end : cutoff_score;
    if (cutoff < 65) cutoff = 65;
    int64_t diff = plen - text_len;
    int64_t adiff = diff < 0 ? -diff : diff;
    int64_t rel = qh_div_ceil(cutoff - adiff, 2);
    int64_t prolog = (diff >= 0) ? qh_div_ceil(rel, QH_W)
                                 : qh_div_ceil(rel - diff, QH_W);
    int64_t ebb = qh_div_ceil(cutoff, QH_W) + 1;   /* score-only width */
    int64_t num_block_rows = qh_div_ceil(plen > 0 ? plen : 1, QH_W);
    int64_t finish_v = prolog * QH_W + diff;

    /* PEQ over the 5-letter alphabet, tail padded to ones */
    int64_t nw = plen > 0 ? qh_div_ceil(plen, QH_W) : 1;
    uint64_t *peq = (uint64_t *)calloc((size_t)(nw * 5), sizeof(uint64_t));
    if (!peq) return -1;
    for (int64_t i = 0; i < plen; i++)
        peq[(i / QH_W) * 5 + pattern_enc[i]] |= 1ULL << (i % QH_W);
    for (int64_t i = plen; i < nw * QH_W; i++)
        for (int c = 0; c < 5; c++)
            peq[(i / QH_W) * 5 + c] |= 1ULL << (i % QH_W);
    int64_t mod = plen % QH_W;

    /* state */
    uint64_t *Pv = (uint64_t *)malloc((size_t)ebb * sizeof(uint64_t));
    uint64_t *Mv = (uint64_t *)malloc((size_t)ebb * sizeof(uint64_t));
    /* scores by absolute block row, offset by prolog; rows in
     * [-prolog, nb_total + ebb + 1) */
    int64_t nb_total = qh_div_ceil(text_finish > 0 ? text_finish : 1, QH_W);
    int64_t n_rows = prolog + nb_total + ebb + 2;
    /* the final-score read below indexes the pattern's last block row,
     * which lies beyond the processed band when text_finish << plen
     * (Hirschberg half-passes); cover it with init-valued rows — the
     * model's scores.get(final_block, (final_block+1)*64) fallback */
    int64_t fb = (plen % QH_W) ? plen / QH_W
                               : (plen > 0 ? (plen - 1) / QH_W : 0);
    if (n_rows < fb + prolog + 1) n_rows = fb + prolog + 1;
    int64_t *sc = (int64_t *)malloc((size_t)n_rows * sizeof(int64_t));
    if (!Pv || !Mv || !sc) {
        free(peq); free(Pv); free(Mv); free(sc);
        return -1;
    }
    for (int64_t r = 0; r < n_rows; r++)
        sc[r] = (r - prolog + 1) * QH_W;   /* init: (row+1)*64 */

    for (int64_t i = 0; i < ebb; i++) { Pv[i] = ~0ULL; Mv[i] = 0; }
    int64_t pos_v = -prolog, pos_h = 0;
    int64_t first = prolog, last = ebb - 1;

    const uint64_t lm_last_w = mod ? (1ULL << (mod - 1)) : 0;
    int64_t text_block = text_finish / QH_W;
    const int fsc = qh_get_force_scalar();
    int Tmt = (int)(n_threads > QH_BMT_MAX ? QH_BMT_MAX : n_threads);
    /* never oversubscribe: the wavefront needs every strip runnable */
    long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
    if (ncpu > 0 && Tmt > ncpu) Tmt = (int)ncpu;
    if (Tmt > 1 && !fsc && text_block >= 8 && last - first + 1 >= 48) {
        /* spawn the full strip set; the entry load sample only seeds
         * the live cap (Tcap), so a call that starts on a busy host
         * can still grow back to Tmt strips when the load clears
         * mid-call (parked strips sleep, they don't burn the freed
         * cores). The sample (two /proc/stat reads + up to 100 us)
         * runs only here — short serial-path calls must not pay it. */
        const char *noadapt = getenv("QUICKED_TPU_NO_ADAPT");
        int adapt_on = !(noadapt && noadapt[0] == '1');
        int tcap0 = adapt_on ? qh_adaptive_cap(Tmt) : Tmt;
        /* threaded wavefront over full 64-column blocks */
        qh_bmt_t *bc = (qh_bmt_t *)calloc(1, sizeof(qh_bmt_t));
        if (bc) {
            bc->peq = peq; bc->nw = nw; bc->lm_last = lm_last_w;
            bc->mod = mod; bc->text = text_enc;
            bc->Pv = Pv; bc->Mv = Mv; bc->sc = sc;
            bc->prolog = prolog; bc->cutoff = cutoff;
            bc->finish_v = finish_v; bc->nbr = num_block_rows;
            bc->text_block = text_block;
            bc->first = first; bc->last = last;
            bc->pos_v = pos_v; bc->pos_h = pos_h;
            bc->T = Tmt;
            bc->Tcap = tcap0;
            bc->adapt = adapt_on;
            pthread_t tids[QH_BMT_MAX];
            qh_bmt_arg_t wargs[QH_BMT_MAX];
            int spawned = 0;
            for (int si = 1; si < Tmt; si++) {
                wargs[si].c = bc; wargs[si].s = si;
                if (pthread_create(&tids[si], NULL, qh_bmt_thread,
                                   &wargs[si]) != 0)
                    break;
                spawned++;
            }
            bc->T = spawned + 1;
            qh_bmt_partition(bc);
            __atomic_store_n(&bc->go, 1, __ATOMIC_RELEASE);
            qh_bmt_work(bc, 0);
            for (int si = 1; si <= spawned; si++)
                pthread_join(tids[si], NULL);
            first = bc->first; last = bc->last;
            pos_v = bc->pos_v; pos_h = bc->pos_h;
            free(bc);
            /* final (partial) block, scalar — the serial kernel's
             * k == text_block iteration (no maintenance after it) */
            for (int64_t t = text_block * QH_W; t < text_finish; t++) {
                const int c = text_enc[t];
                uint64_t phin = 1, mhin = 0;
                for (int64_t i = first; i <= last; i++) {
                    int64_t row = i + pos_v;
                    uint64_t eq = (row < nw) ? peq[row * 5 + c] : ~0ULL;
                    uint64_t lm = (row == nw - 1 && mod)
                                      ? (1ULL << (mod - 1))
                                      : (1ULL << 63);
                    uint64_t pv = Pv[i], mv = Mv[i];
                    uint64_t xv = eq | mv;
                    uint64_t eq2 = eq | mhin;
                    uint64_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
                    uint64_t ph = mv | ~(xh | pv);
                    uint64_t mh = pv & xh;
                    uint64_t phout = (ph & lm) ? 1 : 0;
                    uint64_t mhout = (mh & lm) ? 1 : 0;
                    ph = (ph << 1) | phin;
                    mh = (mh << 1) | mhin;
                    Pv[i] = mh | ~(xv | ph);
                    Mv[i] = ph & xv;
                    phin = phout;
                    mhin = mhout;
                    sc[row + prolog] += (int64_t)phout - (int64_t)mhout;
                }
            }
            goto qh_bs_cols_done;
        }
    }
    for (int64_t k = 0; k <= text_block; k++) {
        int64_t t_end = (k < text_block) ? (k + 1) * QH_W : text_finish;
        int64_t t = k * QH_W;
        if (t_end - t == QH_W && last - first >= 8 && !fsc) {
            /* SIMD anti-diagonal pipeline, 8 columns per pass */
            for (; t < t_end; t += 8)
                qh_banded_cols8(peq, nw, lm_last_w, mod, text_enc, t,
                                Pv, Mv, sc, first, last, pos_v, prolog);
        } else if (t_end - t == QH_W && last - first >= 5 && !fsc) {
            /* narrow band: 4-column pipeline (less fill overhead) */
            for (; t < t_end; t += 4)
                qh_banded_cols4(peq, nw, lm_last_w, mod, text_enc, t,
                                Pv, Mv, sc, first, last, pos_v, prolog);
        }
        for (; t < t_end; t++) {
            const int c = text_enc[t];
            uint64_t phin = 1, mhin = 0;
            for (int64_t i = first; i <= last; i++) {
                int64_t row = i + pos_v;
                uint64_t eq = (row < nw) ? peq[row * 5 + c] : ~0ULL;
                uint64_t lm = (row == nw - 1 && mod)
                                  ? (1ULL << (mod - 1))
                                  : (1ULL << 63);
                /* advance block (model: advance_block) */
                uint64_t pv = Pv[i], mv = Mv[i];
                uint64_t xv = eq | mv;
                uint64_t eq2 = eq | mhin;
                uint64_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
                uint64_t ph = mv | ~(xh | pv);
                uint64_t mh = pv & xh;
                uint64_t phout = (ph & lm) ? 1 : 0;
                uint64_t mhout = (mh & lm) ? 1 : 0;
                ph = (ph << 1) | phin;
                mh = (mh << 1) | mhin;
                Pv[i] = mh | ~(xv | ph);
                Mv[i] = ph & xv;
                phin = phout;
                mhin = mhout;
                sc[row + prolog] += (int64_t)phout - (int64_t)mhout;
            }
        }
        if (k == text_block) break;
        /* band maintenance every 64 columns (model loop tail) */
        int cut_lower = (first + 2 < last) && (finish_v > QH_W * (first + 1))
            && (sc[first + pos_v + 1 + prolog]
                + (finish_v - QH_W * (first + 1))) > cutoff;
        if (cut_lower && pos_h >= prolog) first += 1;
        else if (!cut_lower && pos_h < prolog) first -= 1;
        for (int64_t j = first; j < last; j++) {
            Pv[j] = Pv[j + 1];
            Mv[j] = Mv[j + 1];
        }
        Pv[last] = ~0ULL;
        Mv[last] = 0;
        int64_t pos = last + pos_v;
        sc[pos + 1 + prolog] = sc[pos + prolog] + QH_W;
        int cut_higher = (first + 2 < last) && (QH_W * (last - 1) > finish_v)
            && (sc[last + pos_v - 1 + prolog]
                + (QH_W * (last - 1) - finish_v)) > cutoff;
        if (cut_higher || (pos_v + last >= num_block_rows)) last -= 1;
        pos_v += 1;
        pos_h += 1;
    }
qh_bs_cols_done: ;

    int64_t final_block = (mod != 0) ? plen / QH_W : (plen - 1) / QH_W;
    if (final_block < 0) final_block = 0;
    int64_t score = sc[final_block + prolog]
        - (mod != 0 ? (QH_W - mod) : 0);

    if (pv_out) for (int64_t i = 0; i < ebb; i++) pv_out[i] = Pv[i];
    if (mv_out) for (int64_t i = 0; i < ebb; i++) mv_out[i] = Mv[i];
    if (first_out) *first_out = first;
    if (last_out) *last_out = last;
    if (scores_out) for (int64_t r = 0; r < n_rows; r++) scores_out[r] = sc[r];
    if (ebb_out) *ebb_out = ebb;

    free(peq); free(Pv); free(Mv); free(sc);
    return score;
}

int64_t qh_banded_score(
    const uint8_t *pattern_enc, int64_t plen,
    const uint8_t *text_enc, int64_t text_finish,
    int64_t text_len, int64_t cutoff_score,
    uint64_t *pv_out, uint64_t *mv_out,
    int64_t *first_out, int64_t *last_out,
    int64_t *scores_out, int64_t *ebb_out) {
    return qh_banded_score_n(pattern_enc, plen, text_enc, text_finish,
                             text_len, cutoff_score, pv_out, mv_out,
                             first_out, last_out, scores_out, ebb_out, 1);
}

/* threaded-wavefront entry (bit-exact with qh_banded_score) */
int64_t qh_banded_score_mt(
    const uint8_t *pattern_enc, int64_t plen,
    const uint8_t *text_enc, int64_t text_finish,
    int64_t text_len, int64_t cutoff_score,
    uint64_t *pv_out, uint64_t *mv_out,
    int64_t *first_out, int64_t *last_out,
    int64_t *scores_out, int64_t *ebb_out, int64_t n_threads) {
    return qh_banded_score_n(pattern_enc, plen, text_enc, text_finish,
                             text_len, cutoff_score, pv_out, mv_out,
                             first_out, last_out, scores_out, ebb_out,
                             n_threads);
}

/* ----------------------------------- banded full align (CPU path) */

/*
 * Host-native BandEd full alignment (fill + traceback), the CPU-path
 * base case of the Hirschberg driver. Written from this repo's model
 * (ops/myers_np.py: banded_fill + banded_traceback). The stored matrix
 * is (tlen+1) x ebb u64 columns of Pv and Mv — the caller bounds the
 * footprint (the 16 MB Hirschberg budget). Returns the op count written
 * forward-order into ops_out (capacity plen + tlen); *score_out gets
 * the DP score. Returns -1 if scratch allocation fails.
 */
int64_t qh_banded_align_full(
    const uint8_t *pattern_enc, const uint8_t *pattern_raw, int64_t plen,
    const uint8_t *text_enc, const uint8_t *text_raw, int64_t tlen,
    int64_t cutoff_score, char *ops_out, int64_t *score_out) {
    /* allocate-variant band geometry (model: band_geometry) */
    int64_t k_end = (tlen > plen ? tlen - plen : plen - tlen) + 1;
    int64_t cutoff = k_end > cutoff_score ? k_end : cutoff_score;
    if (cutoff < 65) cutoff = 65;
    int64_t diff = plen - tlen;
    int64_t adiff = diff < 0 ? -diff : diff;
    int64_t rel = qh_div_ceil(cutoff - adiff, 2);
    int64_t prolog, ebb;
    if (diff >= 0) {
        prolog = qh_div_ceil(rel, QH_W);
        ebb = qh_div_ceil(rel + diff, QH_W) + 1 + prolog;
    } else {
        prolog = qh_div_ceil(rel - diff, QH_W);
        ebb = qh_div_ceil(rel, QH_W) + 1 + prolog;
    }
    int64_t num_block_rows = qh_div_ceil(plen > 0 ? plen : 1, QH_W);
    int64_t finish_v = prolog * QH_W + diff;
    int64_t mod = plen % QH_W;

    int64_t nw = plen > 0 ? qh_div_ceil(plen, QH_W) : 1;
    uint64_t *peq = (uint64_t *)calloc((size_t)(nw * 5), sizeof(uint64_t));
    uint64_t *PvM = (uint64_t *)malloc((size_t)((tlen + 1) * ebb) * 8);
    uint64_t *MvM = (uint64_t *)malloc((size_t)((tlen + 1) * ebb) * 8);
    int64_t nb_total = qh_div_ceil(tlen > 0 ? tlen : 1, QH_W);
    int64_t n_rows = prolog + nb_total + ebb + 2;
    int64_t *sc = (int64_t *)malloc((size_t)n_rows * sizeof(int64_t));
    if (!peq || !PvM || !MvM || !sc) {
        free(peq); free(PvM); free(MvM); free(sc);
        return -1;
    }
    for (int64_t i = 0; i < plen; i++)
        peq[(i / QH_W) * 5 + pattern_enc[i]] |= 1ULL << (i % QH_W);
    for (int64_t i = plen; i < nw * QH_W; i++)
        for (int c = 0; c < 5; c++)
            peq[(i / QH_W) * 5 + c] |= 1ULL << (i % QH_W);
    for (int64_t r = 0; r < n_rows; r++)
        sc[r] = (r - prolog + 1) * QH_W;

    for (int64_t i = 0; i < ebb; i++) { PvM[i] = ~0ULL; MvM[i] = 0; }
    int64_t pos_v = -prolog, pos_h = 0;
    int64_t first = prolog, last = ebb - 1;

    for (int64_t t = 0; t < tlen; t++) {
        const int c = text_enc[t];
        uint64_t phin = 1, mhin = 0;
        uint64_t *cur = PvM + t * ebb, *nxt = cur + ebb;
        uint64_t *curM = MvM + t * ebb, *nxtM = curM + ebb;
        /* rows outside the live band: zeros (never read by traceback) */
        for (int64_t i = 0; i < first; i++) { nxt[i] = 0; nxtM[i] = 0; }
        for (int64_t i = last + 1; i < ebb; i++) { nxt[i] = 0; nxtM[i] = 0; }
        for (int64_t i = first; i <= last; i++) {
            int64_t row = i + pos_v;
            uint64_t eq = (row < nw && row >= 0) ? peq[row * 5 + c] : ~0ULL;
            uint64_t lm = (row == nw - 1 && mod) ? (1ULL << (mod - 1))
                                                 : (1ULL << 63);
            uint64_t pv = cur[i], mv = curM[i];
            uint64_t xv = eq | mv;
            uint64_t eq2 = eq | mhin;
            uint64_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
            uint64_t ph = mv | ~(xh | pv);
            uint64_t mh = pv & xh;
            uint64_t phout = (ph & lm) ? 1 : 0;
            uint64_t mhout = (mh & lm) ? 1 : 0;
            ph = (ph << 1) | phin;
            mh = (mh << 1) | mhin;
            nxt[i] = mh | ~(xv | ph);
            nxtM[i] = ph & xv;
            phin = phout;
            mhin = mhout;
            sc[row + prolog] += (int64_t)phout - (int64_t)mhout;
        }
        if ((t + 1) % QH_W == 0) {
            /* band maintenance on the stored column (model: banded_fill) */
            int cut_lower = (first + 2 < last)
                && (finish_v > QH_W * (first + 1))
                && (sc[first + pos_v + 1 + prolog]
                    + (finish_v - QH_W * (first + 1))) > cutoff;
            if (cut_lower && pos_h >= prolog) first += 1;
            else if (!cut_lower && pos_h < prolog) first -= 1;
            for (int64_t j = first; j < last; j++) {
                nxt[j] = nxt[j + 1];
                nxtM[j] = nxtM[j + 1];
            }
            nxt[last] = ~0ULL;
            nxtM[last] = 0;
            int64_t pos = last + pos_v;
            sc[pos + 1 + prolog] = sc[pos + prolog] + QH_W;
            int cut_higher = (first + 2 < last)
                && (QH_W * (last - 1) > finish_v)
                && (sc[last + pos_v - 1 + prolog]
                    + (QH_W * (last - 1) - finish_v)) > cutoff;
            if (cut_higher || (pos_v + last >= num_block_rows - 1)) last -= 1;
            pos_v += 1;
            pos_h += 1;
        }
    }

    int64_t final_block = (mod != 0) ? plen / QH_W : (plen - 1) / QH_W;
    if (final_block < 0) final_block = 0;
    *score_out = sc[final_block + prolog] - (mod != 0 ? (QH_W - mod) : 0);

    /* traceback (model: banded_traceback; tie-break D, I, M, X;
     * the M-test compares RAW characters) */
    int64_t h = tlen - 1, v = plen - 1;
    int64_t cap = plen + tlen, n = 0;
    while (v >= 0 && h >= 0) {
        int64_t block_h = h / QH_W;
        int64_t block_h_r = (h + 1) / QH_W;
        int64_t eff_v = v - QH_W * (block_h - prolog);
        int64_t eff_v_r = v - QH_W * (block_h_r - prolog);
        int64_t block_v = fdiv64(eff_v);
        int64_t block_v_r = fdiv64(eff_v_r);
        uint64_t mask = 1ULL << fmod64(eff_v);
        uint64_t mask_r = 1ULL << fmod64(eff_v_r);
        char op;
        if (block_v_r >= 0 && block_v_r < ebb
            && (PvM[(h + 1) * ebb + block_v_r] & mask_r)) {
            op = 'D'; v--;
        } else if (block_v >= 0 && block_v < ebb
                   && (MvM[h * ebb + block_v] & mask)) {
            op = 'I'; h--;
        } else if (text_raw[h] == pattern_raw[v]) {
            op = 'M'; h--; v--;
        } else {
            op = 'X'; h--; v--;
        }
        ops_out[cap - 1 - n] = op;
        n++;
    }
    while (h >= 0) { ops_out[cap - 1 - n] = 'I'; n++; h--; }
    while (v >= 0) { ops_out[cap - 1 - n] = 'D'; n++; v--; }
    memmove(ops_out, ops_out + cap - n, (size_t)n);

    free(peq); free(PvM); free(MvM); free(sc);
    return n;
}

/* ------------------------------------- windowed score (CPU path) */

/* One maskless Myers advance on a single 64-bit block (the window
 * fill's inner op; carries ride bit 63). */
static inline void qh_adv1(uint64_t eq, uint64_t *pv_io, uint64_t *mv_io,
                           uint64_t *phin_io, uint64_t *mhin_io) {
    const uint64_t pv = *pv_io, mv = *mv_io;
    const uint64_t xv = eq | mv;
    const uint64_t eq2 = eq | *mhin_io;
    const uint64_t xh = (((eq2 & pv) + pv) ^ pv) | eq2;
    uint64_t ph = mv | ~(xh | pv);
    uint64_t mh = pv & xh;
    const uint64_t phout = ph >> 63, mhout = mh >> 63;
    ph = (ph << 1) | *phin_io;
    mh = (mh << 1) | *mhin_io;
    *pv_io = mh | ~(xv | ph);
    *mv_io = ph & xv;
    *phin_io = phout;
    *mhin_io = mhout;
}

typedef uint64_t qh_v2u64 __attribute__((vector_size(16)));

/*
 * SIMD ws==2 window fill: anti-diagonal 2-lane pipeline (the TPU-host
 * analogue of the reference's SSE4.1 window kernel,
 * bpm_windowed.c:283-445 — same dataflow idea, GCC portable vectors).
 * At steady state the two independent cells of the window's 2-block
 * anti-diagonal run in one 2x64-bit vector: lane 0 advances block 0 at
 * column k while lane 1 advances block 1 at column k-1, consuming the
 * carry lane 0 produced one step earlier. Only independent (column,
 * block) cells are reordered, so the fill is bit-exact with the scalar
 * loop. Writes the same (cols+1) x 2 PvW/MvW layout.
 */
static void qh_window_fill2_simd(
    const uint64_t (*peq_win)[5], const uint8_t *text_col,
    int64_t steps_h, uint64_t ph_first, uint64_t init_pv,
    uint64_t *PvW, uint64_t *MvW) {
    __atomic_fetch_add(&qh_simd_passes, 1, __ATOMIC_RELAXED);
    PvW[0] = init_pv; PvW[1] = init_pv;
    MvW[0] = 0; MvW[1] = 0;
    qh_v2u64 pv = {init_pv, init_pv}, mv = {0, 0};
    /* prologue: (col 0, block 0) */
    uint64_t carry_p, carry_m;
    {
        uint64_t p = pv[0], m = mv[0], ci = ph_first, mi = 0;
        qh_adv1(peq_win[0][text_col[0]], &p, &m, &ci, &mi);
        pv[0] = p; mv[0] = m;
        PvW[2] = p; MvW[2] = m;
        carry_p = ci; carry_m = mi;
    }
    /* steady state: step k retires (col k, b0) and (col k-1, b1) */
    for (int64_t k = 1; k <= steps_h; k++) {
        const qh_v2u64 eq = {peq_win[0][text_col[k]],
                             peq_win[1][text_col[k - 1]]};
        const qh_v2u64 phin = {ph_first, carry_p};
        const qh_v2u64 mhin = {0, carry_m};
        const qh_v2u64 xv = eq | mv;
        const qh_v2u64 eq2 = eq | mhin;
        const qh_v2u64 xh = (((eq2 & pv) + pv) ^ pv) | eq2;
        qh_v2u64 ph = mv | ~(xh | pv);
        qh_v2u64 mh = pv & xh;
        const qh_v2u64 phout = ph >> 63, mhout = mh >> 63;
        ph = (ph << 1) | phin;
        mh = (mh << 1) | mhin;
        pv = mh | ~(xv | ph);
        mv = ph & xv;
        carry_p = phout[0];
        carry_m = mhout[0];
        /* lane 1 lands at [k*2+1], lane 0 at [(k+1)*2] — adjacent;
         * one unaligned 16-byte store of the swapped pair */
        const qh_v2u64 sw_p = __builtin_shuffle(pv, (qh_v2u64){1, 0});
        const qh_v2u64 sw_m = __builtin_shuffle(mv, (qh_v2u64){1, 0});
        memcpy(&PvW[k * 2 + 1], &sw_p, 16);
        memcpy(&MvW[k * 2 + 1], &sw_m, 16);
    }
    /* epilogue: (col steps_h, block 1) */
    {
        uint64_t p = pv[1], m = mv[1], ci = carry_p, mi = carry_m;
        qh_adv1(peq_win[1][text_col[steps_h]], &p, &m, &ci, &mi);
        PvW[(steps_h + 1) * 2 + 1] = p;
        MvW[(steps_h + 1) * 2 + 1] = m;
    }
}

/* Window fill shared by score and full modes: init column + steps_h+1
 * text columns into the (cols+1) x ws PvW/MvW planes. Takes the SIMD
 * anti-diagonal path for full two-block ws==2 windows unless
 * force_scalar is set (the reference gates its SSE window kernel the
 * same way, bpm_windowed.c:576-586). */
static void qh_window_fill(
    const uint64_t (*peq_win)[5], const uint8_t *text_enc, int64_t h_min,
    int64_t steps_v, int64_t steps_h, int64_t ws,
    uint64_t ph_first, uint64_t init_pv, int force_scalar,
    uint64_t *PvW, uint64_t *MvW) {
    if (ws == 2 && steps_v == 2 && !force_scalar) {
        qh_window_fill2_simd(peq_win, text_enc + h_min, steps_h,
                             ph_first, init_pv, PvW, MvW);
        return;
    }
    uint64_t Pv[QH_WS_MAX], Mv[QH_WS_MAX];
    for (int64_t i = 0; i < steps_v; i++) {
        Pv[i] = init_pv;
        Mv[i] = 0;
        PvW[i] = init_pv;
        MvW[i] = 0;
    }
    for (int64_t tp = 0; tp <= steps_h; tp++) {
        const int c = text_enc[tp + h_min];
        uint64_t phin = ph_first, mhin = 0;
        for (int64_t i = 0; i < steps_v; i++)
            qh_adv1(peq_win[i][c], &Pv[i], &Mv[i], &phin, &mhin);
        for (int64_t i = 0; i < steps_v; i++) {
            PvW[(tp + 1) * ws + i] = Pv[i];
            MvW[(tp + 1) * ws + i] = Mv[i];
        }
    }
}

/*
 * Host-native WindowEd score bound (model: ops/myers_np.py
 * windowed_compute with score_only=True): walk overlapping
 * (64*ws x 64*ws)-cell windows from the bottom-right corner, fill each
 * with the maskless Myers advance, greedily backtrace to the overlap
 * boundary (tie-break D, I, M, X; M-test on RAW chars), accumulate the
 * score and count High-Error Windows. ws <= 16.
 */
int64_t qh_windowed_score(
    const uint8_t *pattern_enc, const uint8_t *pattern_raw, int64_t plen,
    const uint8_t *text_enc, const uint8_t *text_raw, int64_t tlen,
    int64_t window_size, int64_t overlap_size, int64_t hew_threshold,
    int64_t *hew_out) {
    const int64_t ws = window_size, ovl = overlap_size;
    /* the fixed window buffers below hold at most 16 blocks */
    if (ws < 1 || ws > QH_WS_MAX || ovl < 0 || ovl >= ws) return -1;
    const int64_t cols = QH_W * ws;
    int64_t nw = plen > 0 ? qh_div_ceil(plen, QH_W) : 1;
    uint64_t *peq = (uint64_t *)calloc((size_t)(nw * 5), sizeof(uint64_t));

    /* window matrices: (cols+1) columns x ws blocks */
    uint64_t *PvW = (uint64_t *)malloc((size_t)((cols + 1) * ws) * 8);
    uint64_t *MvW = (uint64_t *)malloc((size_t)((cols + 1) * ws) * 8);
    if (!peq || !PvW || !MvW) {
        free(peq); free(PvW); free(MvW);
        return -1;
    }
    for (int64_t i = 0; i < plen; i++)
        peq[(i / QH_W) * 5 + pattern_enc[i]] |= 1ULL << (i % QH_W);
    for (int64_t i = plen; i < nw * QH_W; i++)
        for (int c = 0; c < 5; c++)
            peq[(i / QH_W) * 5 + c] |= 1ULL << (i % QH_W);
    uint64_t peq_win[QH_WS_MAX][5];
    const int fsc = qh_get_force_scalar();

    int64_t pos_v = plen - 1, pos_h = tlen - 1;
    int64_t score = 0, hew = 0;
    const int64_t hew_cells = (ws - ovl) * QH_W * hew_threshold / 100;

    while (pos_v >= 0 && pos_h >= 0) {
        const int64_t v_min = pos_v - cols + 1 > 0 ? pos_v - cols + 1 : 0;
        const int64_t h_min = pos_h - cols + 1 > 0 ? pos_h - cols + 1 : 0;
        const int64_t steps_v = (pos_v - v_min) / QH_W + 1;
        const int64_t steps_h = pos_h - h_min;
        const int64_t shift = v_min % QH_W;
        const int64_t v_block = v_min / QH_W;

        /* shifted PEQ window (model: _window_fill) */
        for (int64_t i = 0; i < steps_v; i++)
            for (int c = 0; c < 5; c++) {
                uint64_t lo = (i + v_block < nw) ? peq[(i + v_block) * 5 + c]
                                                 : ~0ULL;
                uint64_t hi = (i + v_block + 1 < nw)
                                  ? peq[(i + v_block + 1) * 5 + c] : 0;
                peq_win[i][c] = shift ? ((lo >> shift) | (hi << (QH_W - shift)))
                                      : lo;
            }

        const uint64_t ph_first = (v_min == 0) ? 1 : 0;
        qh_window_fill(peq_win, text_enc, h_min, steps_v, steps_h, ws,
                       ph_first, (h_min == 0) ? ~0ULL : 0, fsc, PvW, MvW);

        /* greedy score-only backtrace (model: _window_backtrace) */
        int64_t h = pos_h, v = pos_v;
        const int64_t h_ovl = pos_h - QH_W * (ws - ovl) + 1 > 0
                                  ? pos_h - QH_W * (ws - ovl) + 1 : 0;
        const int64_t v_ovl = pos_v - QH_W * (ws - ovl) + 1 > 0
                                  ? pos_v - QH_W * (ws - ovl) + 1 : 0;
        int64_t wsc = 0;
        while (v >= v_ovl && h >= h_ovl) {
            const int64_t block = (v - v_min) / QH_W;
            const int64_t col = h - h_min + 1;
            const uint64_t mask = 1ULL << ((v - v_min) % QH_W);
            if (PvW[col * ws + block] & mask) {
                wsc++; v--;
            } else if (MvW[(col - 1) * ws + block] & mask) {
                wsc++; h--;
            } else if (text_raw[h] == pattern_raw[v]) {
                h--; v--;
            } else {
                wsc++; h--; v--;
            }
        }
        if (wsc > hew_cells) hew++;
        score += wsc;
        pos_h = h;
        pos_v = v;
    }
    if (pos_h >= 0) score += pos_h + 1;
    if (pos_v >= 0) score += pos_v + 1;

    free(peq); free(PvW); free(MvW);
    if (hew_out) *hew_out = hew;
    return score;
}

/*
 * Full-CIGAR windowed mode (model: windowed_compute with
 * score_only=False): same window fills, backtrace tie-break M, D, I, X
 * with op emission right-to-left. Writes forward-order ops into
 * ops_out (capacity plen + tlen); returns the op count.
 */
int64_t qh_windowed_full(
    const uint8_t *pattern_enc, const uint8_t *pattern_raw, int64_t plen,
    const uint8_t *text_enc, const uint8_t *text_raw, int64_t tlen,
    int64_t window_size, int64_t overlap_size, char *ops_out) {
    const int64_t ws = window_size, ovl = overlap_size;
    if (ws < 1 || ws > QH_WS_MAX || ovl < 0 || ovl >= ws) return -1;
    const int64_t cols = QH_W * ws;
    int64_t nw = plen > 0 ? qh_div_ceil(plen, QH_W) : 1;
    uint64_t *peq = (uint64_t *)calloc((size_t)(nw * 5), sizeof(uint64_t));
    uint64_t *PvW = (uint64_t *)malloc((size_t)((cols + 1) * ws) * 8);
    uint64_t *MvW = (uint64_t *)malloc((size_t)((cols + 1) * ws) * 8);
    if (!peq || !PvW || !MvW) {
        free(peq); free(PvW); free(MvW);
        return -1;
    }
    for (int64_t i = 0; i < plen; i++)
        peq[(i / QH_W) * 5 + pattern_enc[i]] |= 1ULL << (i % QH_W);
    for (int64_t i = plen; i < nw * QH_W; i++)
        for (int c = 0; c < 5; c++)
            peq[(i / QH_W) * 5 + c] |= 1ULL << (i % QH_W);
    uint64_t peq_win[QH_WS_MAX][5];
    const int fsc = qh_get_force_scalar();

    int64_t pos_v = plen - 1, pos_h = tlen - 1;
    const int64_t cap = plen + tlen;
    int64_t n = 0;

    while (pos_v >= 0 && pos_h >= 0) {
        const int64_t v_min = pos_v - cols + 1 > 0 ? pos_v - cols + 1 : 0;
        const int64_t h_min = pos_h - cols + 1 > 0 ? pos_h - cols + 1 : 0;
        const int64_t steps_v = (pos_v - v_min) / QH_W + 1;
        const int64_t steps_h = pos_h - h_min;
        const int64_t shift = v_min % QH_W;
        const int64_t v_block = v_min / QH_W;

        for (int64_t i = 0; i < steps_v; i++)
            for (int c = 0; c < 5; c++) {
                uint64_t lo = (i + v_block < nw) ? peq[(i + v_block) * 5 + c]
                                                 : ~0ULL;
                uint64_t hi = (i + v_block + 1 < nw)
                                  ? peq[(i + v_block + 1) * 5 + c] : 0;
                peq_win[i][c] = shift ? ((lo >> shift) | (hi << (QH_W - shift)))
                                      : lo;
            }

        const uint64_t ph_first = (v_min == 0) ? 1 : 0;
        qh_window_fill(peq_win, text_enc, h_min, steps_v, steps_h, ws,
                       ph_first, (h_min == 0) ? ~0ULL : 0, fsc, PvW, MvW);

        /* full-mode backtrace: tie-break M, D, I, X
         * (windowed_backtrace, bpm_windowed.c:448-502) */
        int64_t h = pos_h, v = pos_v;
        const int64_t h_ovl = pos_h - QH_W * (ws - ovl) + 1 > 0
                                  ? pos_h - QH_W * (ws - ovl) + 1 : 0;
        const int64_t v_ovl = pos_v - QH_W * (ws - ovl) + 1 > 0
                                  ? pos_v - QH_W * (ws - ovl) + 1 : 0;
        while (v >= v_ovl && h >= h_ovl) {
            const int64_t block = (v - v_min) / QH_W;
            const int64_t col = h - h_min + 1;
            const uint64_t mask = 1ULL << ((v - v_min) % QH_W);
            char op;
            if (text_raw[h] == pattern_raw[v]) {
                op = 'M'; h--; v--;
            } else if (PvW[col * ws + block] & mask) {
                op = 'D'; v--;
            } else if (MvW[(col - 1) * ws + block] & mask) {
                op = 'I'; h--;
            } else {
                op = 'X'; h--; v--;
            }
            ops_out[cap - 1 - n] = op;
            n++;
        }
        pos_h = h;
        pos_v = v;
    }
    while (pos_h >= 0) { ops_out[cap - 1 - n] = 'I'; n++; pos_h--; }
    while (pos_v >= 0) { ops_out[cap - 1 - n] = 'D'; n++; pos_v--; }
    memmove(ops_out, ops_out + cap - n, (size_t)n);

    free(peq); free(PvW); free(MvW);
    return n;
}

/* ------------------------------------------------------ sequence IO */

/*
 * Batch .seq reader (sequence_buffer semantics, sequence_buffer.c:90-127
 * + align_benchmark_read_input, align_benchmark.c:73-99): parse up to
 * `max_pairs` two-line records from `data[0..len)`, stripping the first
 * character of each line. Sequences are appended to `out` with
 * NUL-padding between them; offsets/lengths per line are recorded.
 * Returns the number of PAIRS parsed; *consumed is the byte offset of
 * the first unparsed record (callers stream chunks).
 */
int64_t qh_read_seq_batch(const char *data, int64_t len, int64_t max_pairs,
                          char *out, int64_t out_cap,
                          int64_t *offsets, int64_t *lengths,
                          int64_t *consumed) {
    int64_t pos = 0, w = 0, n_lines = 0;
    int64_t last_complete = 0;
    while (n_lines / 2 < max_pairs) {
        if (pos >= len) break;
        const char *nl = memchr(data + pos, '\n', (size_t)(len - pos));
        if (!nl) break;                    /* incomplete record tail */
        int64_t line_len = (int64_t)(nl - (data + pos));
        int64_t seq_len = line_len > 0 ? line_len - 1 : 0;
        if (w + seq_len + 1 > out_cap) break;
        memcpy(out + w, data + pos + 1, (size_t)seq_len);
        out[w + seq_len] = '\0';
        offsets[n_lines] = w;
        lengths[n_lines] = seq_len;
        w += seq_len + 1;
        pos = (int64_t)(nl - data) + 1;
        n_lines++;
        if (n_lines % 2 == 0) last_complete = pos;
    }
    *consumed = last_complete;
    return n_lines / 2;
}

/* ------------------------------------------------- windowed traceback */

/*
 * Greedy in-window backtrace for the full-CIGAR windowed mode
 * (windowed_backtrace, bpm_windowed.c:448-502). Tie-break M, D, I, X
 * (different from banded!). PvW/MvW are (COLS+1, WS) u32-pair planes
 * for one window (column 0 = init). Returns new (v, h) packed and
 * appends ops right-to-left into rev buffer via *pn.
 */
void qh_window_backtrace(
    const uint32_t *pvw_lo, const uint32_t *pvw_hi,
    const uint32_t *mvw_lo, const uint32_t *mvw_hi,
    int64_t ws, int64_t nlanes, int64_t lane,
    const uint8_t *pattern, const uint8_t *text,
    int64_t v_min, int64_t h_min,
    int64_t v_ovl, int64_t h_ovl,
    int64_t *pv, int64_t *ph,
    char *rev_buf, int64_t cap, int64_t *pn) {
    int64_t v = *pv, h = *ph, n = *pn;
    while (v >= v_ovl && h >= h_ovl) {
        const int64_t block = (v - v_min) / W;
        const int64_t bit = (v - v_min) % W;
        const int64_t col = h - h_min + 1;
        const int64_t base_p = (col * ws + block) * nlanes + lane;
        const int64_t base_m = ((col - 1) * ws + block) * nlanes + lane;
        const uint32_t pw = (bit < 32) ? pvw_lo[base_p] : pvw_hi[base_p];
        const uint32_t mw = (bit < 32) ? mvw_lo[base_m] : mvw_hi[base_m];
        const int pbit = (int)((pw >> (bit & 31)) & 1u);
        const int mbit = (int)((mw >> (bit & 31)) & 1u);
        char op;
        if (text[h] == pattern[v])      { op = 'M'; h--; v--; }
        else if (pbit)                  { op = 'D'; v--; }
        else if (mbit)                  { op = 'I'; h--; }
        else                            { op = 'X'; h--; v--; }
        rev_buf[cap - 1 - n] = op;
        n++;
    }
    *pv = v; *ph = h; *pn = n;
}

/* ------------------------------------------- batched QuickEd cascade */

/*
 * Full bound-and-align cascade for one pair (run_quicked semantics,
 * quicked.c:163-306), composed from the per-stage kernels above:
 *
 *   stage 1: WindowEd(ws=2, ovl=1) score bound        (quicked.c:184-199)
 *   stage 2: WindowEd(ws, ovl) forward + reversed-pair (quicked.c:204-235)
 *   stage 3: BandEd score-only, telescoping retry      (quicked.c:237-276)
 *   stage 4: full alignment under the proven bound     (quicked.c:290)
 *
 * Stage 4 runs the direct banded fill when the band footprint fits the
 * Hirschberg budget (bpm_hirschberg.c:63-65); larger problems return
 * *status_out = 1 with the proven bound in *score_out so the (batched,
 * device-kernel) Hirschberg driver can finish them.
 */
typedef struct {
    const uint8_t *pe, *praw;
    int64_t plen;
    const uint8_t *te, *traw;
    int64_t tlen, ws, ovl, thr;
    int64_t score, hew;
} qh_ws_job_t;

static void *qh_ws_job_thread(void *arg) {
    qh_ws_job_t *j = (qh_ws_job_t *)arg;
    j->score = qh_windowed_score(j->pe, j->praw, j->plen, j->te,
                                 j->traw, j->tlen, j->ws, j->ovl,
                                 j->thr, &j->hew);
    return NULL;
}

static void qh_quicked_one(
    const uint8_t *p_raw, int64_t plen, const uint8_t *t_raw, int64_t tlen,
    int64_t bandwidth, int64_t ws, int64_t ovl,
    int64_t thr0, int64_t thr1, int64_t pct0, int64_t pct1,
    int64_t budget, int64_t intra,
    int64_t *score_out, int64_t *status_out,
    char *ops_out, int64_t *ops_n_out) {
    const int64_t max_len = plen > tlen ? plen : tlen;
    uint8_t *pe = (uint8_t *)malloc((size_t)(plen > 0 ? plen : 1));
    uint8_t *te = (uint8_t *)malloc((size_t)(tlen > 0 ? tlen : 1));
    *ops_n_out = 0;
    if (!pe || !te) { free(pe); free(te); *status_out = 1; *score_out = max_len; return; }
    qh_encode_dna(p_raw, plen, pe);
    qh_encode_dna(t_raw, tlen, te);

    int64_t hew = 0;
    int64_t score = qh_windowed_score(pe, p_raw, plen, te, t_raw, tlen,
                                      2, 1, thr0, &hew);
    if (hew * 64 > max_len * pct0 / 100) {
        /* stage 2: large windows, forward + reversed pair */
        uint8_t *pr = (uint8_t *)malloc((size_t)(plen > 0 ? plen : 1));
        uint8_t *tr = (uint8_t *)malloc((size_t)(tlen > 0 ? tlen : 1));
        uint8_t *per = (uint8_t *)malloc((size_t)(plen > 0 ? plen : 1));
        uint8_t *ter = (uint8_t *)malloc((size_t)(tlen > 0 ? tlen : 1));
        if (!pr || !tr || !per || !ter) {
            free(pr); free(tr); free(per); free(ter); free(pe); free(te);
            *status_out = 1; *score_out = max_len; return;
        }
        for (int64_t i = 0; i < plen; i++) {
            pr[i] = p_raw[plen - 1 - i];
            per[i] = pe[plen - 1 - i];
        }
        for (int64_t i = 0; i < tlen; i++) {
            tr[i] = t_raw[tlen - 1 - i];
            ter[i] = te[tlen - 1 - i];
        }
        int64_t hew_f = 0, hew_r = 0;
        int64_t s_f, s_r;
        /* the forward and reversed-pair passes are independent; when
         * this pair owns spare threads (intra > 1: the batch has fewer
         * pairs than the pool), run the reverse pass concurrently —
         * the passes are the whole stage-2 wall for a single long pair */
        qh_ws_job_t rj = {per, pr, plen, ter, tr, tlen, ws, ovl, thr1,
                          0, 0};
        pthread_t rt;
        int threaded = (intra > 1)
            && pthread_create(&rt, NULL, qh_ws_job_thread, &rj) == 0;
        s_f = qh_windowed_score(pe, p_raw, plen, te, t_raw, tlen,
                                ws, ovl, thr1, &hew_f);
        if (threaded) {
            pthread_join(rt, NULL);
            s_r = rj.score;
            hew_r = rj.hew;
        } else {
            s_r = qh_windowed_score(per, pr, plen, ter, tr, tlen,
                                    ws, ovl, thr1, &hew_r);
        }
        score = s_f < s_r ? s_f : s_r;
        int64_t hw = hew_f;
        if (score >= s_r) hw = hew_r;
        free(pr); free(tr); free(per); free(ter);
        if (hw * 64 * (ws - ovl) > max_len * pct1 / 100) {
            /* stage 3: banded score-only + telescoping retry */
            int64_t cut = max_len * bandwidth / 100;
            if (score < cut) cut = score;
            /* Narrow-band trial (this repo's addition; outputs stay
             * byte-identical to run_quicked): a banded score <= its
             * cutoff is provably EXACT — any alignment scoring <= C
             * stays inside the C-band and survives the edge cuts, so
             * an in-band path scoring <= C certifies the optimum is in
             * band for BOTH the trial band and the reference's wider
             * band, and both return the same exact score. Stage-3 cost
             * scales with the band, so a successful 5/8 trial saves
             * ~37% of the dominant cascade stage on noisy long pairs
             * (the windowed bound typically overestimates 1.5-3x);
             * a failed trial costs 5/8 extra and falls through to the
             * untouched reference geometry + telescoping retry.
             * QUICKED_TPU_NO_BAND_TRIAL=1 opts out. */
            int64_t k_end = (tlen > plen ? tlen - plen : plen - tlen) + 1;
            int64_t cut_t = cut * 5 / 8;
            int trial_hit = 0;
            /* cap-limited only (ws bound > bandwidth cap): on uniform
             * noise the windowed bound is near-tight (measured
             * true/cut ~ 1.0 across synthetic corpora — a trial would
             * almost always miss), but a bound pushed past the cap
             * signals bursty error where the true score sits well
             * under the cap (ONT real pair: 0.52x) */
            if (score > cut && cut >= 4096 && cut_t > k_end) {
                const char *noty = getenv("QUICKED_TPU_NO_BAND_TRIAL");
                if (!(noty && noty[0] == '1')) {
                    int64_t ts = qh_banded_score_n(
                        pe, plen, te, tlen, tlen, cut_t,
                        NULL, NULL, NULL, NULL, NULL, NULL, intra);
                    if (ts >= 0 && ts <= cut_t) {
                        score = ts;
                        trial_hit = 1;
                    }
                }
            }
            if (!trial_hit) {
            int64_t ns = qh_banded_score_n(pe, plen, te, tlen, tlen, cut,
                                           NULL, NULL, NULL, NULL, NULL,
                                           NULL, intra);
            int neg_retries = 0;
            while ((ns > max_len / 4 && cut * 3 / 2 < ns) || ns < 0) {
                if (ns < 0 && ++neg_retries > 2) {
                    /* persistent kernel failure (allocation): defer */
                    free(pe); free(te);
                    *status_out = 1;
                    *score_out = score;
                    return;
                }
                cut *= 2;              /* floor at 1: 0 doubles to 0 */
                if (cut < 1) cut = 1;
                ns = qh_banded_score_n(pe, plen, te, tlen, tlen, cut,
                                       NULL, NULL, NULL, NULL, NULL,
                                       NULL, intra);
            }
            score = ns;
            }
        }
    }

    /* stage 4: footprint test (allocate-variant band geometry) */
    {
        int64_t k_end = (tlen > plen ? tlen - plen : plen - tlen) + 1;
        int64_t cutoff = k_end > score ? k_end : score;
        if (cutoff < 65) cutoff = 65;
        int64_t diff = plen - tlen;
        int64_t adiff = diff < 0 ? -diff : diff;
        int64_t rel = qh_div_ceil(cutoff - adiff, 2);
        int64_t ebb;
        if (diff >= 0)
            ebb = qh_div_ceil(rel + diff, QH_W) + 1 + qh_div_ceil(rel, QH_W);
        else
            ebb = qh_div_ceil(rel, QH_W) + 1 + qh_div_ceil(rel - diff, QH_W);
        if (ebb * tlen * 8 * 2 > budget) {
            *status_out = 1;       /* needs the Hirschberg driver */
            *score_out = score;    /* the proven bound */
            free(pe); free(te);
            return;
        }
    }
    int64_t sc4 = 0;
    int64_t n = qh_banded_align_full(pe, p_raw, plen, te, t_raw, tlen,
                                     score, ops_out, &sc4);
    free(pe); free(te);
    if (n < 0) {   /* scratch allocation failed: defer to the driver */
        *status_out = 1;
        *score_out = score;
        return;
    }
    /* extract_results: score from the CIGAR (cigar_score_edit) */
    int64_t edit = 0;
    for (int64_t i = 0; i < n; i++) edit += (ops_out[i] != 'M');
    *ops_n_out = n;
    *score_out = edit;
    *status_out = 0;
}

#include <pthread.h>

typedef struct {
    const char *buf;
    const int64_t *offsets;   /* 2*n line offsets into buf */
    const int64_t *lengths;   /* 2*n line lengths */
    int64_t n_pairs;
    int64_t bandwidth, ws, ovl, thr0, thr1, pct0, pct1, budget;
    int64_t intra;
    int64_t *scores;
    int64_t *status;
    char *ops;
    const int64_t *ops_off;   /* per-pair offsets into ops */
    int64_t *ops_len;
    volatile int64_t next;
    int64_t chunk;
} qh_batch_ctx_t;

static void *qh_batch_worker(void *arg) {
    qh_batch_ctx_t *ctx = (qh_batch_ctx_t *)arg;
    /* Chunked work claiming: a short-read pair is ~5 us of work, so a
       per-pair mutex round-trip serializes the pool at 100k-pair batch
       sizes (measured: 1.9x at 4 threads before, embarrassingly
       parallel work). One atomic fetch-add claims `chunk` pairs; the
       chunk count keeps ~64 claims per thread for stealing balance. */
    const int64_t chunk = ctx->chunk;
    for (;;) {
        int64_t i0 = __atomic_fetch_add(&ctx->next, chunk,
                                        __ATOMIC_RELAXED);
        if (i0 >= ctx->n_pairs) break;
        int64_t i1 = i0 + chunk;
        if (i1 > ctx->n_pairs) i1 = ctx->n_pairs;
        for (int64_t i = i0; i < i1; i++) {
            const uint8_t *p =
                (const uint8_t *)ctx->buf + ctx->offsets[2 * i];
            const uint8_t *t =
                (const uint8_t *)ctx->buf + ctx->offsets[2 * i + 1];
            qh_quicked_one(p, ctx->lengths[2 * i], t,
                           ctx->lengths[2 * i + 1],
                           ctx->bandwidth, ctx->ws, ctx->ovl,
                           ctx->thr0, ctx->thr1, ctx->pct0, ctx->pct1,
                           ctx->budget, ctx->intra,
                           &ctx->scores[i], &ctx->status[i],
                           ctx->ops + ctx->ops_off[i], &ctx->ops_len[i]);
        }
    }
    return NULL;
}

/*
 * Batched cascade over n_pairs (the OpenMP batch loop of the reference
 * benchmark, align_benchmark.c:232-306, fused with run_quicked): one
 * call per batch, pthread pool inside, zero per-pair Python overhead.
 * Returns the number of pairs fully aligned in C (status 0).
 */
int64_t qh_quicked_batch(
    const char *buf, const int64_t *offsets, const int64_t *lengths,
    int64_t n_pairs,
    int64_t bandwidth, int64_t window_size, int64_t overlap_size,
    int64_t hew_thr0, int64_t hew_thr1, int64_t hew_pct0, int64_t hew_pct1,
    int64_t budget, int64_t n_threads,
    int64_t *scores_out, int64_t *status_out,
    char *ops_out, const int64_t *ops_offsets, int64_t *ops_len_out) {
    qh_batch_ctx_t ctx;
    ctx.buf = buf; ctx.offsets = offsets; ctx.lengths = lengths;
    ctx.n_pairs = n_pairs;
    ctx.bandwidth = bandwidth; ctx.ws = window_size; ctx.ovl = overlap_size;
    ctx.thr0 = hew_thr0; ctx.thr1 = hew_thr1;
    ctx.pct0 = hew_pct0; ctx.pct1 = hew_pct1;
    ctx.budget = budget;
    ctx.scores = scores_out; ctx.status = status_out;
    ctx.ops = ops_out; ctx.ops_off = ops_offsets; ctx.ops_len = ops_len_out;
    ctx.next = 0;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    /* ~64 claims per thread bounds the stolen-tail imbalance at ~1.5%
       while keeping the claim traffic negligible */
    ctx.chunk = n_pairs / (n_threads * 64);
    if (ctx.chunk < 1) ctx.chunk = 1;
    if (ctx.chunk > 4096) ctx.chunk = 4096;
    /* leftover parallelism goes inside each pair's stage-3 band */
    ctx.intra = 1;
    if (n_pairs > 0 && n_threads > n_pairs) {
        ctx.intra = n_threads / n_pairs;
        if (ctx.intra > QH_BMT_MAX) ctx.intra = QH_BMT_MAX;
    }
    if (n_threads > n_pairs) n_threads = n_pairs > 0 ? n_pairs : 1;
    if (n_threads == 1) {
        qh_batch_worker(&ctx);
    } else {
        pthread_t tids[64];
        int64_t spawned = 0;
        for (int64_t k = 0; k < n_threads; k++) {
            if (pthread_create(&tids[k], NULL, qh_batch_worker, &ctx) != 0)
                break;
            spawned++;
        }
        if (spawned == 0) qh_batch_worker(&ctx);
        for (int64_t k = 0; k < spawned; k++)
            pthread_join(tids[k], NULL);
    }
    int64_t done = 0;
    for (int64_t i = 0; i < n_pairs; i++) done += (status_out[i] == 0);
    return done;
}

/*
 * Batched RLE CIGAR printing (cigar_sprint, cigar.c:453-488) over the
 * packed per-pair op strings a batch call produced: one ctypes call for
 * the whole batch. out capacity per pair: 3*len + 16.
 */
typedef struct {
    const char *ops;
    const int64_t *off, *len;
    int64_t n, print_matches;
    char *out;
    const int64_t *out_off;
    int64_t *out_len;
    volatile int64_t next;
    int64_t chunk;
} qh_csb_ctx_t;

static void *qh_csb_worker(void *arg) {
    qh_csb_ctx_t *c = (qh_csb_ctx_t *)arg;
    const int64_t chunk = c->chunk;
    for (;;) {
        int64_t i0 = __atomic_fetch_add(&c->next, chunk,
                                        __ATOMIC_RELAXED);
        if (i0 >= c->n) break;
        int64_t i1 = i0 + chunk;
        if (i1 > c->n) i1 = c->n;
        for (int64_t i = i0; i < i1; i++) {
            const char *o = c->ops + c->off[i];
            char *w0 = c->out + c->out_off[i], *w = w0;
            int64_t m = c->len[i];
            int64_t j = 0;
            while (j < m) {
                char ch = o[j];
                int64_t run = 1;
                while (j + run < m && o[j + run] == ch) run++;
                if (c->print_matches || ch != 'M') {
                    /* write run count then op char */
                    char tmp[24];
                    int64_t k = 0, r = run;
                    do { tmp[k++] = (char)('0' + (r % 10)); r /= 10; }
                    while (r);
                    while (k) *w++ = tmp[--k];
                    *w++ = ch;
                }
                j += run;
            }
            c->out_len[i] = (int64_t)(w - w0);
        }
    }
    return NULL;
}

int64_t qh_cigar_sprint_batch(
    const char *ops, const int64_t *off, const int64_t *len, int64_t n,
    int64_t print_matches,
    char *out, const int64_t *out_off, int64_t *out_len,
    int64_t n_threads) {
    qh_csb_ctx_t c;
    c.ops = ops; c.off = off; c.len = len; c.n = n;
    c.print_matches = print_matches;
    c.out = out; c.out_off = out_off; c.out_len = out_len;
    c.next = 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > n) n_threads = n > 0 ? n : 1;
    c.chunk = n / (n_threads * 64);
    if (c.chunk < 1) c.chunk = 1;
    if (c.chunk > 4096) c.chunk = 4096;
    if (n_threads == 1) {
        qh_csb_worker(&c);
    } else {
        pthread_t tids[64];
        int64_t spawned = 0;
        for (int64_t k = 0; k < n_threads; k++) {
            if (pthread_create(&tids[k], NULL, qh_csb_worker, &c) != 0)
                break;
            spawned++;
        }
        if (spawned == 0) qh_csb_worker(&c);
        for (int64_t k = 0; k < spawned; k++)
            pthread_join(tids[k], NULL);
    }
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) total += out_len[i];
    return total;
}

/* Expand per-column device-traceback records (lane-major) into op
 * strings: the consumer of ops/banded_traceback_jax.py's (d_run, op)
 * records. Per lane: 'D'*(v_fin+1) + 'I'*(h_fin+1), then for each
 * column ascending: opchar (1=M, 3=I, 4=X; 0 none) + 'D'*run. Pass
 * out == NULL to compute offs/lens only (the caller then allocates
 * exactly); with out != NULL both passes run in one call. Returns the
 * total byte count. */
int64_t qh_expand_colruns_batch(
    const uint16_t *runs, const int8_t *opcs,
    const int32_t *v_fin, const int32_t *h_fin,
    int64_t n, int64_t T,
    char *out, int64_t *offs, int64_t *lens) {
    static const char opch[5] = {0, 'M', 'D', 'I', 'X'};
    int64_t total = 0;
    for (int64_t b = 0; b < n; b++) {
        const uint16_t *r = runs + b * T;
        const int8_t *o = opcs + b * T;
        int64_t len = (v_fin[b] >= -1 ? v_fin[b] + 1 : 0)
            + (h_fin[b] >= -1 ? h_fin[b] + 1 : 0);
        for (int64_t t = 0; t < T; t++)
            len += (o[t] != 0) + r[t];
        offs[b] = total;
        lens[b] = len;
        total += len;
    }
    if (!out) return total;
    for (int64_t b = 0; b < n; b++) {
        const uint16_t *r = runs + b * T;
        const int8_t *o = opcs + b * T;
        char *w = out + offs[b];
        for (int64_t k = 0; k < v_fin[b] + 1; k++) *w++ = 'D';
        for (int64_t k = 0; k < h_fin[b] + 1; k++) *w++ = 'I';
        for (int64_t t = 0; t < T; t++) {
            if (o[t]) *w++ = opch[(int)o[t]];
            for (int64_t k = 0; k < r[t]; k++) *w++ = 'D';
        }
    }
    return total;
}

/* ------------------------------------------- Hirschberg (CPU path) */

/*
 * Memory-bounded full alignment: the bpm_compute_matrix_hirschberg
 * recursion (bpm_hirschberg.c:33-270) over the per-pair C kernels —
 * score-only half passes, band intersection + midpoint argmin, direct
 * banded fill under the 16 MB budget. Completes the native runtime so
 * host-only consumers (the C++ binding, CPU fallbacks) cover every
 * algorithm without Python.
 *
 * CIGAR ops are written right-to-left into the shared buffer exactly
 * like the reference (right half recursed first); non-convergence
 * leaves the partial right side in place and returns -2.
 */

typedef struct {
    const uint8_t *p_enc, *p_raw, *pr_enc, *pr_raw;
    const uint8_t *t_enc, *t_raw, *tr_enc, *tr_raw;
    int64_t plen_total, tlen_total, budget;
} qh_hirs_ctx_t;

static void qh_band_geo(int64_t plen, int64_t tlen, int64_t cutoff_score,
                        int64_t *cutoff_out, int64_t *prolog_out,
                        int64_t *ebb_alloc_out) {
    int64_t k_end = (tlen > plen ? tlen - plen : plen - tlen) + 1;
    int64_t cutoff = k_end > cutoff_score ? k_end : cutoff_score;
    if (cutoff < 65) cutoff = 65;
    int64_t diff = plen - tlen;
    int64_t adiff = diff < 0 ? -diff : diff;
    int64_t rel = qh_div_ceil(cutoff - adiff, 2);
    int64_t prolog, ebb;
    if (diff >= 0) {
        prolog = qh_div_ceil(rel, QH_W);
        ebb = qh_div_ceil(rel + diff, QH_W) + 1 + prolog;
    } else {
        prolog = qh_div_ceil(rel - diff, QH_W);
        ebb = qh_div_ceil(rel, QH_W) + 1 + prolog;
    }
    *cutoff_out = cutoff;
    *prolog_out = prolog;
    *ebb_alloc_out = ebb;
}

static inline int qh_w64_bit(const uint64_t *w, int64_t ebb, int64_t idx,
                             int dflt) {
    int64_t blk = idx / QH_W;
    if (blk < 0 || blk >= ebb) return dflt;  /* reset-value semantics */
    return (int)((w[blk] >> (idx % QH_W)) & 1ULL);
}

static int64_t qh_hirs_rec(const qh_hirs_ctx_t *cx,
                           int64_t p_off, int64_t plen,
                           int64_t t_off, int64_t tlen,
                           int64_t cutoff_score,
                           char *buf, int64_t *pos) {
    int64_t cutoff, prolog, ebb_alloc;
    qh_band_geo(plen, tlen, cutoff_score, &cutoff, &prolog, &ebb_alloc);
    if (ebb_alloc * tlen * 8 * 2 <= cx->budget) {
        /* base case: direct banded fill + traceback, prepended */
        char *tmp = (char *)malloc((size_t)(plen + tlen ? plen + tlen : 1));
        if (!tmp) return -1;
        int64_t sc;
        int64_t n = qh_banded_align_full(
            cx->p_enc + p_off, cx->p_raw + p_off, plen,
            cx->t_enc + t_off, cx->t_raw + t_off, tlen,
            cutoff_score, tmp, &sc);
        if (n < 0) { free(tmp); return -1; }
        *pos -= n;
        memcpy(buf + *pos, tmp, (size_t)n);
        free(tmp);
        return 0;
    }

    const int64_t text_mid = (tlen + 1) / 2;
    const int64_t text_mid_r = tlen - text_mid;
    /* reversed-slice offsets into the top-level reversed arrays */
    const int64_t pr_off = cx->plen_total - p_off - plen;
    const int64_t tr_off = cx->tlen_total - t_off - tlen;

    int64_t ebb_cap = cutoff / QH_W + 2;
    int64_t nb_total = qh_div_ceil(text_mid > 0 ? text_mid : 1, QH_W);
    int64_t nb_total_r = qh_div_ceil(text_mid_r > 0 ? text_mid_r : 1, QH_W);
    int64_t fb = (plen % QH_W) ? plen / QH_W
                               : (plen > 0 ? (plen - 1) / QH_W : 0);
    int64_t n_rows = prolog + nb_total + ebb_cap + 2;
    if (n_rows < fb + prolog + 1) n_rows = fb + prolog + 1;
    int64_t n_rows_r = prolog + nb_total_r + ebb_cap + 2;
    if (n_rows_r < fb + prolog + 1) n_rows_r = fb + prolog + 1;

    uint64_t *f_pv = (uint64_t *)malloc((size_t)ebb_cap * 8);
    uint64_t *f_mv = (uint64_t *)malloc((size_t)ebb_cap * 8);
    uint64_t *r_pv = (uint64_t *)malloc((size_t)ebb_cap * 8);
    uint64_t *r_mv = (uint64_t *)malloc((size_t)ebb_cap * 8);
    int64_t *f_sc = (int64_t *)malloc((size_t)n_rows * 8);
    int64_t *r_sc = (int64_t *)malloc((size_t)n_rows_r * 8);
    if (!f_pv || !f_mv || !r_pv || !r_mv || !f_sc || !r_sc) {
        free(f_pv); free(f_mv); free(r_pv); free(r_mv);
        free(f_sc); free(r_sc);
        return -1;
    }
    int64_t f_first, f_last, r_first, r_last, f_ebb, r_ebb;
    qh_banded_score(cx->p_enc + p_off, plen, cx->t_enc + t_off,
                    text_mid, tlen, cutoff_score,
                    f_pv, f_mv, &f_first, &f_last, f_sc, &f_ebb);
    qh_banded_score(cx->pr_enc + pr_off, plen, cx->tr_enc + tr_off,
                    text_mid_r, tlen, cutoff_score,
                    r_pv, r_mv, &r_first, &r_last, r_sc, &r_ebb);

    /* band intersection + midpoint argmin (bpm_hirschberg.c:103-200,
     * modeled by myers_np.hirschberg_split) */
    int64_t status = 0;
    int64_t fb_pos_v = (text_mid < prolog * QH_W) ? 0
                                                  : text_mid / QH_W - prolog;
    int64_t fb_pos_v_r = (text_mid_r < prolog * QH_W)
                             ? 0 : text_mid_r / QH_W - prolog;
    int64_t bottom_pos = f_first * QH_W + 63 + fb_pos_v * QH_W;
    int64_t bottom_pos_r = (plen - 1)
        - (r_last * QH_W + 63 + fb_pos_v_r * QH_W);
    int64_t higher_pos = f_last * QH_W + 63 + fb_pos_v * QH_W;
    int64_t higher_pos_r = (plen - 1)
        - (r_first * QH_W + 63 + fb_pos_v_r * QH_W);

    if (bottom_pos > higher_pos_r || bottom_pos_r > higher_pos) {
        status = -2;   /* QUICKED_FAIL_NON_CONVERGENCE */
        goto done;
    }
    {
        int64_t bottom_cell, starting_pos, higher_cell, higher_cell_r;
        if (bottom_pos > bottom_pos_r) {
            bottom_cell = f_first * QH_W + 63;
            starting_pos = bottom_pos;
        } else {
            bottom_cell = bottom_pos_r - fb_pos_v * QH_W;
            starting_pos = bottom_pos_r;
        }
        if (higher_pos < higher_pos_r) {
            higher_cell = f_last * QH_W + 63;
            higher_cell_r = (plen - 1) - higher_pos - fb_pos_v_r * QH_W;
        } else {
            higher_cell = higher_pos_r - fb_pos_v * QH_W;
            higher_cell_r = r_first * QH_W + 63;
        }
        int64_t n_cells = higher_cell - bottom_cell + 2;
        int64_t *cs = (int64_t *)malloc((size_t)(n_cells + 1) * 8);
        int64_t *csr = (int64_t *)malloc((size_t)(n_cells + 1) * 8);
        if (!cs || !csr) { free(cs); free(csr); status = -1; goto done; }
        cs[0] = 0;
        csr[0] = 0;
        for (int64_t i = 0; i < n_cells; i++) {
            cs[i + 1] = cs[i]
                + qh_w64_bit(f_pv, f_ebb, bottom_cell + i, 1)
                - qh_w64_bit(f_mv, f_ebb, bottom_cell + i, 0);
            csr[i + 1] = csr[i]
                + qh_w64_bit(r_pv, r_ebb, higher_cell_r + i, 1)
                - qh_w64_bit(r_mv, r_ebb, higher_cell_r + i, 0);
        }
        int64_t smaller_pos = 0;
        int64_t smaller = csr[n_cells - 1] + cs[0];
        for (int64_t i = 1; i < n_cells; i++) {
            int64_t v = csr[n_cells - 1 - i] + cs[i];
            if (v < smaller) { smaller_pos = i; smaller = v; }
        }
        int64_t pll = starting_pos + smaller_pos;
        int64_t plr = plen - pll;

        /* per-half bounds with the deterministic clamp the model uses
         * for the reference's out-of-range reads */
        #define QH_CS(arr, idx) \
            (arr[(idx) < 0 ? 0 : ((idx) > n_cells ? n_cells : (idx))])
        int64_t block_ref = qh_div_ceil(pll, QH_W)
            - ((n_cells < smaller_pos + QH_W) ? 1 : 0);
        int64_t score_pos_l = block_ref * QH_W
            - (bottom_cell + fb_pos_v * QH_W);
        int64_t score_l = cs[smaller_pos] - QH_CS(cs, score_pos_l)
            + f_sc[block_ref - 1 + prolog];
        int64_t block_ref_r = qh_div_ceil(plr, QH_W)
            - ((smaller_pos < QH_W) ? 1 : 0);
        int64_t score_pos_r = block_ref_r * QH_W
            - (higher_cell_r + fb_pos_v_r * QH_W);
        int64_t score_r = QH_CS(csr, n_cells - 1 - smaller_pos)
            - QH_CS(csr, score_pos_r)
            + r_sc[block_ref_r - 1 + prolog];
        #undef QH_CS
        free(cs); free(csr);

        /* right half first, then left (right-to-left shared buffer) */
        status = qh_hirs_rec(cx, p_off + pll, plr, t_off + text_mid,
                             tlen - text_mid, score_r, buf, pos);
        if (status == 0)
            status = qh_hirs_rec(cx, p_off, pll, t_off, text_mid,
                                 score_l, buf, pos);
    }
done:
    free(f_pv); free(f_mv); free(r_pv); free(r_mv);
    free(f_sc); free(r_sc);
    return status;
}

/*
 * Full Hirschberg alignment. Writes forward-order ops into ops_out
 * (capacity plen + tlen); *n_out = op count (partial right side on
 * non-convergence). Returns 0, -2 (non-convergence) or -1 (alloc).
 */
int64_t qh_hirschberg(
    const uint8_t *pattern_enc, const uint8_t *pattern_raw, int64_t plen,
    const uint8_t *text_enc, const uint8_t *text_raw, int64_t tlen,
    int64_t cutoff_score, int64_t budget,
    char *ops_out, int64_t *n_out) {
    uint8_t *pr_enc = (uint8_t *)malloc((size_t)(plen ? plen : 1));
    uint8_t *pr_raw = (uint8_t *)malloc((size_t)(plen ? plen : 1));
    uint8_t *tr_enc = (uint8_t *)malloc((size_t)(tlen ? tlen : 1));
    uint8_t *tr_raw = (uint8_t *)malloc((size_t)(tlen ? tlen : 1));
    if (!pr_enc || !pr_raw || !tr_enc || !tr_raw) {
        free(pr_enc); free(pr_raw); free(tr_enc); free(tr_raw);
        return -1;
    }
    for (int64_t i = 0; i < plen; i++) {
        pr_enc[i] = pattern_enc[plen - 1 - i];
        pr_raw[i] = pattern_raw[plen - 1 - i];
    }
    for (int64_t i = 0; i < tlen; i++) {
        tr_enc[i] = text_enc[tlen - 1 - i];
        tr_raw[i] = text_raw[tlen - 1 - i];
    }
    qh_hirs_ctx_t cx = {
        pattern_enc, pattern_raw, pr_enc, pr_raw,
        text_enc, text_raw, tr_enc, tr_raw,
        plen, tlen, budget,
    };
    int64_t cap = plen + tlen;
    int64_t pos = cap;
    int64_t status = qh_hirs_rec(&cx, 0, plen, 0, tlen, cutoff_score,
                                 ops_out, &pos);
    free(pr_enc); free(pr_raw); free(tr_enc); free(tr_raw);
    int64_t n = cap - pos;
    memmove(ops_out, ops_out + pos, (size_t)n);
    *n_out = n;
    return status;
}

/* --------------------------------------------- single-pair public API */

/*
 * quicked_align semantics over the native runtime (quicked.c:405-437):
 * algo 0=QUICKED 1=BANDED 2=WINDOWED 3=HIRSCHBERG. Outputs the CIGAR
 * ops (forward order) and the score (edit score from the CIGAR for
 * full modes; kernel score for only_score). Returns the status.
 */
int64_t qh_align(
    int64_t algo, const uint8_t *pattern_raw, int64_t plen,
    const uint8_t *text_raw, int64_t tlen,
    int64_t only_score, int64_t bandwidth,
    int64_t window_size, int64_t overlap_size,
    int64_t hew_thr0, int64_t hew_thr1,
    int64_t hew_pct0, int64_t hew_pct1,
    int64_t budget,
    int64_t *score_out, char *ops_out, int64_t *ops_n_out) {
    if (plen == 0 || tlen == 0) return -4;  /* QUICKED_EMPTY_SEQUENCE */
    if ((algo == 0 || algo == 2) &&
        (window_size < 1 || window_size > QH_WS_MAX ||
         overlap_size < 0 || overlap_size >= window_size))
        return -10;  /* QUICKED_UNIMPLEMENTED: fixed window depth */
    uint8_t *pe = (uint8_t *)malloc((size_t)plen);
    uint8_t *te = (uint8_t *)malloc((size_t)tlen);
    if (!pe || !te) { free(pe); free(te); return -1; }
    qh_encode_dna(pattern_raw, plen, pe);
    qh_encode_dna(text_raw, tlen, te);
    const int64_t max_len = plen > tlen ? plen : tlen;
    int64_t status = 0, n = 0, score = 0;
    *ops_n_out = 0;

    if (algo == 1) {            /* BANDED */
        int64_t cutoff = max_len * bandwidth / 100;
        if (only_score) {
            score = qh_banded_score(pe, plen, te, tlen, tlen, cutoff,
                                    NULL, NULL, NULL, NULL, NULL, NULL);
        } else {
            int64_t sc;
            n = qh_banded_align_full(pe, pattern_raw, plen, te, text_raw,
                                     tlen, cutoff, ops_out, &sc);
            if (n < 0) { status = -1; n = 0; }
        }
    } else if (algo == 2) {     /* WINDOWED */
        if (only_score) {
            int64_t hew;
            score = qh_windowed_score(pe, pattern_raw, plen, te, text_raw,
                                      tlen, window_size, overlap_size,
                                      0, &hew);
        } else {
            n = qh_windowed_full(pe, pattern_raw, plen, te, text_raw,
                                 tlen, window_size, overlap_size, ops_out);
            if (n < 0) { status = -1; n = 0; }
        }
    } else if (algo == 3) {     /* HIRSCHBERG */
        int64_t cutoff = max_len * bandwidth / 100;
        status = qh_hirschberg(pe, pattern_raw, plen, te, text_raw, tlen,
                               cutoff, budget, ops_out, &n);
    } else {                    /* QUICKED */
        int64_t st1;
        qh_quicked_one(pattern_raw, plen, text_raw, tlen,
                       bandwidth, window_size, overlap_size,
                       hew_thr0, hew_thr1, hew_pct0, hew_pct1,
                       budget, 1, &score, &st1, ops_out, &n);
        if (st1 == 1) {
            /* stage-4 footprint over budget: finish with Hirschberg
             * under the proven bound (run_quicked ignores its status) */
            qh_hirschberg(pe, pattern_raw, plen, te, text_raw, tlen,
                          score, budget, ops_out, &n);
        }
        status = 1;             /* QUICKED_WIP (quicked.c:305) */
    }
    free(pe); free(te);
    /* extract_results (quicked.c:34-56): the score is the CIGAR's edit
     * score whenever a traceback ran, and only_score keeps the cigar
     * NULL for every algorithm */
    if (n > 0) {
        int64_t edit = 0;
        for (int64_t i = 0; i < n; i++) edit += (ops_out[i] != 'M');
        score = edit;
    }
    if (only_score) n = 0;
    *score_out = score;
    *ops_n_out = n;
    return status;
}

/* ----------------------------------------- batched banded score */

typedef struct {
    const uint8_t *enc;
    const int64_t *p_off, *p_len, *t_off, *t_len, *cutoff, *tfinish;
    int64_t n;
    int64_t intra;
    int want_state;
    int64_t *score;
    uint64_t *pv, *mv;
    int64_t ebb_stride;
    int64_t *first, *last, *scores;
    int64_t rows_stride;
    int64_t *ebb;
    volatile int64_t next;
} qh_bsb_ctx_t;

static void *qh_bsb_worker(void *arg) {
    qh_bsb_ctx_t *c = (qh_bsb_ctx_t *)arg;
    for (;;) {
        /* lanes are ms-coarse, but the atomic claim still beats a
           mutex round-trip and frees the lock for nothing */
        int64_t i = __atomic_fetch_add(&c->next, 1, __ATOMIC_RELAXED);
        if (i >= c->n) break;
        if (c->want_state) {
            c->score[i] = qh_banded_score_n(
                c->enc + c->p_off[i], c->p_len[i],
                c->enc + c->t_off[i], c->tfinish[i], c->t_len[i],
                c->cutoff[i],
                c->pv + i * c->ebb_stride, c->mv + i * c->ebb_stride,
                &c->first[i], &c->last[i],
                c->scores + i * c->rows_stride, &c->ebb[i], c->intra);
        } else {
            c->score[i] = qh_banded_score_n(
                c->enc + c->p_off[i], c->p_len[i],
                c->enc + c->t_off[i], c->tfinish[i], c->t_len[i],
                c->cutoff[i], NULL, NULL, NULL, NULL, NULL, NULL,
                c->intra);
        }
    }
    return NULL;
}

/*
 * Batched score-only BandEd over packed encoded sequences: one ctypes
 * call, pthread pool inside — the host lane of the score-batch path
 * (the per-pair Python wrapper loop serialized on the GIL).
 */
int64_t qh_banded_score_batch(
    const uint8_t *enc_buf,
    const int64_t *p_off, const int64_t *p_len,
    const int64_t *t_off, const int64_t *t_len,
    const int64_t *cutoff, const int64_t *tfinish,
    int64_t n, int64_t n_threads, int64_t want_state,
    int64_t *score_out,
    uint64_t *pv_out, uint64_t *mv_out, int64_t ebb_stride,
    int64_t *first_out, int64_t *last_out,
    int64_t *scores_out, int64_t rows_stride, int64_t *ebb_out) {
    qh_bsb_ctx_t c;
    c.enc = enc_buf;
    c.p_off = p_off; c.p_len = p_len; c.t_off = t_off; c.t_len = t_len;
    c.cutoff = cutoff; c.tfinish = tfinish;
    c.n = n;
    c.intra = 1;
    if (n > 0 && n_threads > n) {
        c.intra = n_threads / n;
        if (c.intra > QH_BMT_MAX) c.intra = QH_BMT_MAX;
    }
    c.want_state = (int)want_state;
    c.score = score_out;
    c.pv = pv_out; c.mv = mv_out; c.ebb_stride = ebb_stride;
    c.first = first_out; c.last = last_out;
    c.scores = scores_out; c.rows_stride = rows_stride; c.ebb = ebb_out;
    c.next = 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > n) n_threads = n > 0 ? n : 1;
    if (n_threads == 1) {
        qh_bsb_worker(&c);
    } else {
        pthread_t tids[64];
        int64_t spawned = 0;
        for (int64_t k = 0; k < n_threads; k++) {
            if (pthread_create(&tids[k], NULL, qh_bsb_worker, &c) != 0)
                break;
            spawned++;
        }
        if (spawned == 0) qh_bsb_worker(&c);
        for (int64_t k = 0; k < spawned; k++)
            pthread_join(tids[k], NULL);
    }
    return n;
}
