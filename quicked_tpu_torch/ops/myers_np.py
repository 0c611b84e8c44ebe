"""Exact semantic model of the QuickEd algorithms (pure Python/NumPy).

The port's copy of quicked_tpu/ops/myers_np.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

This module is the *specification* the TPU kernels are tested against: a
bit-exact, per-pair re-derivation of the reference algorithms with 64-bit
Myers blocks:

  - Myers advance-block recurrence   (bpm_commons.h:49-68)
  - PEQ compilation + level masks    (bpm_banded.c:40-103)
  - BandEd score-only w/ band cutoff (bpm_banded.c:791-964)
  - BandEd full fill + traceback     (bpm_banded.c:199-316, 967-1036)
  - WindowEd fill + greedy backtrace (bpm_windowed.c:202-628)
  - Hirschberg divide & conquer      (bpm_hirschberg.c:33-270)
  - QuickEd cascade driver           (quicked.c:163-306)

It is NOT the production path (slow, sequential); the production path is
the port's batched CUDA kernels (csrc/), which must produce bit-identical
results to this model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quicked_tpu_torch import dna
from quicked_tpu_torch.params import QuickedStatus

W = 64  # Myers block height (bits per word), BPM_W64_LENGTH
M64 = (1 << 64) - 1
TOPBIT = 1 << 63
ALPHABET = 5
HIRSCHBERG_BUFFER = 16 * 1024 * 1024  # BUFFER_SIZE_16M (bpm_hirschberg.c:65)


def div_ceil(a: int, b: int) -> int:
    return (a + b - 1) // b


# ---------------------------------------------------------------------------
# Myers advance block (bpm_commons.h:49-68)
# ---------------------------------------------------------------------------

def advance_block(Eq: int, mask: int, Pv: int, Mv: int, PHin: int, MHin: int):
    """One 64-cell column step of the Myers bit-parallel edit DP.

    Returns (Pv', Mv', PHout, MHout). All words are 64-bit.
    """
    Xv = Eq | Mv
    _Eq = Eq | MHin
    Xh = ((((_Eq & Pv) + Pv) & M64) ^ Pv) | _Eq
    Ph = Mv | (~(Xh | Pv) & M64)
    Mh = Pv & Xh
    PHout = 1 if (Ph & mask) else 0
    MHout = 1 if (Mh & mask) else 0
    Ph = ((Ph << 1) & M64) | PHin
    Mh = ((Mh << 1) & M64) | MHin
    Pv_out = Mh | (~(Xv | Ph) & M64)
    Mv_out = Ph & Xv
    return Pv_out, Mv_out, PHout, MHout


# ---------------------------------------------------------------------------
# Pattern compilation (banded_pattern_compile, bpm_banded.c:40-103)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pattern:
    enc: np.ndarray           # encoded pattern (uint8, 5-letter)
    raw: np.ndarray           # raw bytes (uint8) — tracebacks compare RAW
    length: int
    num_words: int            # ceil(length/64)
    mod: int                  # length % 64
    peq: list[list[int]]      # [num_words][5] 64-bit words; tail padded to ones
    level_mask: list[int]     # [num_words]


def compile_pattern(pattern: str | np.ndarray) -> Pattern:
    if isinstance(pattern, np.ndarray):
        enc = pattern
        raw = pattern  # encoded-only input: raw falls back to encoded
    else:
        raw = np.frombuffer(pattern.encode("ascii", errors="replace"),
                            dtype=np.uint8)
        enc = dna.encode(pattern)
    n = int(len(enc))
    num_words = div_ceil(n, W)
    mod = n % W
    peq = [[0] * ALPHABET for _ in range(num_words)]
    for i in range(n):
        peq[i // W][int(enc[i])] |= 1 << (i % W)
    # Tail padding: rows beyond the pattern match every character
    # (bpm_banded.c:77-86).
    for i in range(n, num_words * W):
        for c in range(ALPHABET):
            peq[i // W][c] |= 1 << (i % W)
    level_mask = [TOPBIT] * num_words
    if mod > 0:
        level_mask[num_words - 1] = 1 << (mod - 1)
    return Pattern(enc=np.asarray(enc, dtype=np.uint8),
                   raw=np.asarray(raw, dtype=np.uint8), length=n,
                   num_words=num_words, mod=mod, peq=peq,
                   level_mask=level_mask)


# ---------------------------------------------------------------------------
# Band geometry (banded_matrix_allocate, bpm_banded.c:112-135)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BandGeometry:
    cutoff: int                  # effective cutoff score (>=65, >=|diff|+1)
    diff: int                    # pattern_len - text_len
    relative_cutoff: int
    prolog: int                  # prolog_column_blocks
    ebb: int                     # effective_bandwidth_blocks (allocate variant)


def band_geometry(pattern_len: int, text_len: int, cutoff_score: int) -> BandGeometry:
    k_end = abs(text_len - pattern_len) + 1
    cutoff = max(k_end, cutoff_score, 65)
    diff = pattern_len - text_len
    rel = div_ceil(cutoff - abs(diff), 2)
    if diff >= 0:
        prolog = div_ceil(rel, W)
        ebb = div_ceil(rel + diff, W) + 1 + prolog
    else:
        prolog = div_ceil(rel - diff, W)
        ebb = div_ceil(rel, W) + 1 + prolog
    return BandGeometry(cutoff=cutoff, diff=diff, relative_cutoff=rel,
                        prolog=prolog, ebb=ebb)


def band_geometries(pattern_lens, text_lens, cutoff_scores) -> BandGeometry:
    """`band_geometry` of many pairs at once: a BandGeometry whose fields
    are int64 arrays, element i that of pair i (the same integer
    arithmetic, on arrays)."""
    plen = np.asarray(pattern_lens, dtype=np.int64)
    tlen = np.asarray(text_lens, dtype=np.int64)
    diff = plen - tlen
    cutoff = np.maximum(np.maximum(np.abs(diff) + 1,
                                   np.asarray(cutoff_scores, np.int64)), 65)
    rel = div_ceil(cutoff - np.abs(diff), 2)
    pos = diff >= 0
    prolog = np.where(pos, div_ceil(rel, W), div_ceil(rel - diff, W))
    ebb = np.where(pos, div_ceil(rel + diff, W), div_ceil(rel, W)) \
        + 1 + prolog
    return BandGeometry(cutoff=cutoff, diff=diff, relative_cutoff=rel,
                        prolog=prolog, ebb=ebb)


def _reset_search(num_words: int):
    """bpm_reset_search (bpm_banded.c:180-197)."""
    Pv = [M64] * num_words
    Mv = [0] * num_words
    scores = {}
    for i in range(num_words):
        scores[i] = (i + 1) * W
    return Pv, Mv, scores


def _final_score(pat: Pattern, scores) -> int:
    """Final-cell score extraction (bpm_banded.c:952-960)."""
    if pat.length % W:
        return scores[pat.length // W] - (W - (pat.length % W))
    return scores[(pat.length - 1) // W]


@dataclasses.dataclass
class BandedScoreResult:
    score: int
    Pv: list[int]            # final live column (band-local words)
    Mv: list[int]
    scores: dict             # absolute block-row -> score at block end
    lower_block: int         # final first_block_v
    higher_block: int        # final last_block_v
    geometry: BandGeometry


def banded_score(pat: Pattern, text_enc: np.ndarray, cutoff_score: int,
                 text_len: int | None = None,
                 text_finish_pos: int | None = None) -> BandedScoreResult:
    """Score-only banded Myers with dynamic band cutoff.

    Bit-exact model of bpm_compute_matrix_banded_cutoff_score
    (bpm_banded.c:791-964). `text_len` is the *total* text length used for
    band sizing; `text_finish_pos` is how many columns to process
    (Hirschberg stops at the midpoint, bpm_hirschberg.c:89-100).
    """
    if text_len is None:
        text_len = len(text_enc)
    if text_finish_pos is None:
        text_finish_pos = text_len
    geo = band_geometry(pat.length, text_len, cutoff_score)
    # The score-only kernel derives its own band width from the cutoff
    # (bpm_banded.c:801-803) -- NOT the allocate-variant width.
    ebb = div_ceil(geo.cutoff, W) + 1
    num_block_rows = div_ceil(pat.length, W)
    prolog = geo.prolog
    finish_v = prolog * W + geo.diff   # finish_v_pos_inside_band

    pos_v = -prolog
    pos_h = 0
    first = prolog
    last = ebb - 1
    Pv, Mv, scores = _reset_search(ebb)
    # level_mask / PEQ accessors with absolute block-row index; rows beyond
    # the pattern read the padded tail semantics.
    def lm(row):
        return pat.level_mask[row] if row < pat.num_words else TOPBIT

    def peq(row, c):
        return pat.peq[row][c] if row < pat.num_words else M64

    text_block = text_finish_pos // W
    t = 0
    for k in range(text_block):
        for t in range(k * W, (k + 1) * W):
            c = int(text_enc[t])
            PHin, MHin = 1, 0
            for i in range(first, last + 1):
                row = i + pos_v
                Pv[i], Mv[i], PHout, MHout = advance_block(
                    peq(row, c), lm(row), Pv[i], Mv[i], PHin, MHin)
                PHin, MHin = PHout, MHout
                scores[row] = scores[row] + PHout - MHout
        # --- band maintenance every 64 columns (bpm_banded.c:889-922) ---
        cut_lower = (first + 2 < last) and (finish_v > W * (first + 1)) and \
            (scores[first + pos_v + 1] + (finish_v - W * (first + 1))) > geo.cutoff
        if cut_lower and pos_h >= prolog:
            first += 1
        elif not cut_lower and pos_h < prolog:
            first -= 1
        for j in range(first, last):
            Pv[j] = Pv[j + 1]
            Mv[j] = Mv[j + 1]
        Pv[last] = M64
        Mv[last] = 0
        pos = last + pos_v
        scores[pos + 1] = scores[pos] + W
        cut_higher = (first + 2 < last) and (W * (last - 1) > finish_v) and \
            (scores[last + pos_v - 1] + (W * (last - 1) - finish_v)) > geo.cutoff
        if cut_higher or (pos_v + last >= num_block_rows):
            last -= 1
        pos_v += 1
        pos_h += 1

    for t in range(text_block * W, text_finish_pos):
        c = int(text_enc[t])
        PHin, MHin = 1, 0
        for i in range(first, last + 1):
            row = i + pos_v
            Pv[i], Mv[i], PHout, MHout = advance_block(
                peq(row, c), lm(row), Pv[i], Mv[i], PHin, MHin)
            PHin, MHin = PHout, MHout
            scores[row] = scores[row] + PHout - MHout

    # Unwritten entries of the scores array are uninitialised in the
    # reference; model them as the row-boundary init value so the retry
    # loop sees a large (over-cutoff) score deterministically.
    final_block = (pat.length // W) if pat.length % W else ((pat.length - 1) // W)
    if final_block not in scores:
        scores[final_block] = (final_block + 1) * W
    score = _final_score(pat, scores)
    return BandedScoreResult(score=score, Pv=Pv, Mv=Mv, scores=scores,
                             lower_block=first, higher_block=last, geometry=geo)


@dataclasses.dataclass
class BandedFillResult:
    score: int
    PvM: list[list[int]]     # [text_len+1][ebb] stored band columns
    MvM: list[list[int]]
    lower_block: int
    higher_block: int
    geometry: BandGeometry
    ebb: int


def banded_fill(pat: Pattern, text_enc: np.ndarray,
                cutoff_score: int) -> BandedFillResult:
    """Full-matrix banded fill for traceback
    (bpm_compute_matrix_banded_cutoff, bpm_banded.c:199-316)."""
    text_len = len(text_enc)
    geo = band_geometry(pat.length, text_len, cutoff_score)
    ebb = geo.ebb                      # allocate-variant width
    num_block_rows = div_ceil(pat.length, W)
    prolog = geo.prolog
    finish_v = prolog * W + geo.diff

    pos_v = -prolog
    pos_h = 0
    first = prolog
    last = ebb - 1
    col0_P, col0_M, scores = _reset_search(ebb)
    PvM = [list(col0_P)] + [[0] * ebb for _ in range(text_len)]
    MvM = [list(col0_M)] + [[0] * ebb for _ in range(text_len)]

    def lm(row):
        return pat.level_mask[row] if row < pat.num_words else TOPBIT

    def peq(row, c):
        return pat.peq[row][c] if row < pat.num_words else M64

    for t in range(text_len):
        c = int(text_enc[t])
        PHin, MHin = 1, 0
        cur, nxt = PvM[t], PvM[t + 1]
        curM, nxtM = MvM[t], MvM[t + 1]
        # Columns not in the live band keep stale values of the previous
        # column buffer in C (uninitialised); the traceback never reads
        # them, we leave zeros.
        for i in range(first, last + 1):
            row = i + pos_v
            p, m, PHout, MHout = advance_block(
                peq(row, c), lm(row), cur[i], curM[i], PHin, MHin)
            nxt[i] = p
            nxtM[i] = m
            PHin, MHin = PHout, MHout
            scores[row] = scores.get(row, (row + 1) * W) + PHout - MHout
        if (t + 1) % W == 0:
            cut_lower = (first + 2 < last) and (finish_v > W * (first + 1)) and \
                (scores[first + pos_v + 1] + (finish_v - W * (first + 1))) > geo.cutoff
            if cut_lower and pos_h >= prolog:
                first += 1
            elif not cut_lower and pos_h < prolog:
                first -= 1
            for j in range(first, last):
                nxt[j] = nxt[j + 1]
                nxtM[j] = nxtM[j + 1]
            nxt[last] = M64
            nxtM[last] = 0
            pos = last + pos_v
            scores[pos + 1] = scores.get(pos, (pos + 1) * W) + W
            cut_higher = (first + 2 < last) and (W * (last - 1) > finish_v) and \
                (scores[last + pos_v - 1] + (W * (last - 1) - finish_v)) > geo.cutoff
            if cut_higher or (pos_v + last >= num_block_rows - 1):
                last -= 1
            pos_v += 1
            pos_h += 1

    final_block = (pat.length // W) if pat.length % W else ((pat.length - 1) // W)
    if final_block not in scores:
        scores[final_block] = (final_block + 1) * W
    score = _final_score(pat, scores)
    return BandedFillResult(score=score, PvM=PvM, MvM=MvM,
                            lower_block=first, higher_block=last,
                            geometry=geo, ebb=ebb)


def banded_traceback(fill: BandedFillResult, pat: Pattern,
                     text_raw: np.ndarray) -> str:
    """Banded traceback (banded_backtrace_matrix_cutoff, bpm_banded.c:967-1036).

    Tie-break order: D (Pv bit at column h+1), I (Mv bit at column h),
    M (chars equal), X.
    """
    prolog = fill.geometry.prolog
    text_len = len(text_raw)
    h = text_len - 1
    v = pat.length - 1
    ops = []
    praw = pat.raw
    while v >= 0 and h >= 0:
        block_h = h // W
        block_h_r = (h + 1) // W
        eff_v = v - W * (block_h - prolog)
        eff_v_r = v - W * (block_h_r - prolog)
        block_v = eff_v // W
        block_v_r = eff_v_r // W
        mask = 1 << (eff_v % W)
        mask_r = 1 << (eff_v_r % W)
        if fill.PvM[h + 1][block_v_r] & mask_r:
            ops.append("D")
            v -= 1
        elif fill.MvM[h][block_v] & mask:
            ops.append("I")
            h -= 1
        elif int(text_raw[h]) == int(praw[v]):
            ops.append("M")
            h -= 1
            v -= 1
        else:
            ops.append("X")
            h -= 1
            v -= 1
    ops.append("I" * (h + 1))
    ops.append("D" * (v + 1))
    return "".join(ops)[::-1]


def banded_align(pattern: str, text: str, cutoff_score: int,
                 only_score: bool = False):
    """BANDED algorithm driver (run_banded semantics, quicked.c:58-89).

    NOTE: the traceback M-test compares RAW characters (bpm_banded.c:1012),
    while the DP itself runs on the 5-letter encoding.
    Returns (score, cigar_ops or None).
    """
    pat = compile_pattern(pattern)
    text_enc = dna.encode(text)
    if only_score:
        res = banded_score(pat, text_enc, cutoff_score)
        return res.score, None
    fill = banded_fill(pat, text_enc, cutoff_score)
    text_raw = np.frombuffer(text.encode("ascii", errors="replace"),
                             dtype=np.uint8)
    ops = banded_traceback(fill, pat, text_raw)
    return fill.score, ops


# ---------------------------------------------------------------------------
# WindowEd (bpm_windowed.c)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowedState:
    pos_v: int
    pos_h: int
    score: int
    high_error_window: int
    ops: list  # reversed op chars (appended right-to-left)


def _window_fill(pat: Pattern, text_enc: np.ndarray, window_size: int,
                 pos_v_fi: int, pos_h_fi: int):
    """windowed_compute_window (bpm_windowed.c:202-280).

    Returns (PvW, MvW, pos_v, pos_h) where PvW[column][block] covers
    columns 0..steps_h+1 (column 0 = initial state).
    """
    ws = window_size
    pos_v = max(pos_v_fi - W * ws + 1, 0)
    pos_h = max(pos_h_fi - W * ws + 1, 0)
    steps_v = (pos_v_fi - pos_v) // W + 1
    steps_h = pos_h_fi - pos_h
    shift = pos_v % W
    pos_v_block = pos_v // W

    # Shifted PEQ window (bpm_windowed.c:237-244). Reading one word past
    # the PEQ tail yields garbage in C but is masked when shift==0; when
    # shift>0 the window never extends past the pattern tail (see module
    # docstring derivation) -- emulate with a zero word.
    peq_win = [[0] * ALPHABET for _ in range(steps_v)]
    for i in range(steps_v):
        for c in range(ALPHABET):
            lo = pat.peq[i + pos_v_block][c] if i + pos_v_block < pat.num_words else M64
            hi = pat.peq[i + pos_v_block + 1][c] if i + pos_v_block + 1 < pat.num_words else 0
            if shift:
                eq = (lo >> shift) | ((hi << (W - shift)) & M64)
            else:
                eq = lo
            peq_win[i][c] = eq

    if pos_h == 0:
        Pv = [M64] * ws
        Mv = [0] * ws
    else:
        Pv = [0] * ws
        Mv = [0] * ws
    ph_first = 1 if pos_v == 0 else 0

    PvW = [list(Pv)]
    MvW = [list(Mv)]
    for tp in range(steps_h + 1):
        c = int(text_enc[tp + pos_h])
        PHin, MHin = ph_first, 0
        for i in range(steps_v):
            Xv = peq_win[i][c] | Mv[i]
            _Eq = peq_win[i][c] | MHin
            Xh = ((((_Eq & Pv[i]) + Pv[i]) & M64) ^ Pv[i]) | _Eq
            Ph = Mv[i] | (~(Xh | Pv[i]) & M64)
            Mh = Pv[i] & Xh
            PHout = (Ph >> 63) & 1
            MHout = (Mh >> 63) & 1
            Ph = ((Ph << 1) & M64) | PHin
            Mh = ((Mh << 1) & M64) | MHin
            Pv[i] = Mh | (~(Xv | Ph) & M64)
            Mv[i] = Ph & Xv
            PHin, MHin = PHout, MHout
        PvW.append(list(Pv))
        MvW.append(list(Mv))
    return PvW, MvW, pos_v, pos_h


def _window_backtrace(state: WindowedState, pat: Pattern, text_raw: np.ndarray,
                      PvW, MvW, pos_v_min: int, pos_h_min: int,
                      window_size: int, overlap_size: int,
                      score_only: bool, hew_threshold: int):
    """windowed_backtrace[_score_only] (bpm_windowed.c:448-561).

    Score-only tie-break: D, I, M, X.  Full-CIGAR tie-break: M, D, I, X.
    The C bit index `1L << (v - v_min % 64)` wraps mod 64 on x86, which
    equals the intended `(v - v_min) % 64`.
    """
    ws, ovl = window_size, overlap_size
    h = state.pos_h
    v = state.pos_v
    h_min = pos_h_min
    v_min = pos_v_min
    h_overlap = max(state.pos_h - W * (ws - ovl) + 1, 0)
    v_overlap = max(state.pos_v - W * (ws - ovl) + 1, 0)
    praw = pat.raw
    score = 0
    while v >= v_overlap and h >= h_overlap:
        block = (v - v_min) // W
        col = h - h_min + 1
        mask = 1 << ((v - v_min) % W)
        if score_only:
            if PvW[col][block] & mask:
                score += 1
                v -= 1
            elif MvW[col - 1][block] & mask:
                score += 1
                h -= 1
            elif int(text_raw[h]) == int(praw[v]):
                h -= 1
                v -= 1
            else:
                score += 1
                h -= 1
                v -= 1
        else:
            if int(text_raw[h]) == int(praw[v]):
                state.ops.append("M")
                h -= 1
                v -= 1
            elif PvW[col][block] & mask:
                state.ops.append("D")
                v -= 1
            elif MvW[col - 1][block] & mask:
                state.ops.append("I")
                h -= 1
            else:
                state.ops.append("X")
                h -= 1
                v -= 1
    if score_only:
        if score > ((ws - ovl) * W * hew_threshold // 100):
            state.high_error_window += 1
        state.score += score
    state.pos_h = h
    state.pos_v = v


def windowed_compute(pattern: str | Pattern, text: str | np.ndarray,
                     hew_threshold: int, window_size: int, overlap_size: int,
                     score_only: bool):
    """windowed_compute (bpm_windowed.c:563-628).

    Returns (score, ops or None, high_error_window).
    """
    pat = pattern if isinstance(pattern, Pattern) else compile_pattern(pattern)
    if isinstance(text, np.ndarray):
        text_enc = text
        text_raw = text
    else:
        text_enc = dna.encode(text)
        text_raw = np.frombuffer(text.encode("ascii", errors="replace"),
                                 dtype=np.uint8)
    state = WindowedState(pos_v=pat.length - 1, pos_h=len(text_enc) - 1,
                          score=0, high_error_window=0, ops=[])
    while state.pos_v >= 0 and state.pos_h >= 0:
        PvW, MvW, pos_v_min, pos_h_min = _window_fill(
            pat, text_enc, window_size, state.pos_v, state.pos_h)
        _window_backtrace(state, pat, text_raw, PvW, MvW, pos_v_min,
                          pos_h_min, window_size, overlap_size,
                          score_only, hew_threshold)
    if score_only:
        if state.pos_h >= 0:
            state.score += state.pos_h + 1
        if state.pos_v >= 0:
            state.score += state.pos_v + 1
        return state.score, None, state.high_error_window
    ops = list(state.ops)
    h, v = state.pos_h, state.pos_v
    ops.extend("I" * (h + 1))
    ops.extend("D" * (v + 1))
    return None, "".join(ops)[::-1], state.high_error_window


# ---------------------------------------------------------------------------
# Hirschberg (bpm_hirschberg.c:33-270)
# ---------------------------------------------------------------------------

def hirschberg(text: str, pattern: str, cutoff_score: int):
    """bpm_compute_matrix_hirschberg semantics.

    Returns (status, ops). On QUICKED_FAIL_NON_CONVERGENCE, ops contains
    the partial right-side alignment computed so far (matching the
    reference's shared right-to-left output buffer).
    """
    segments: list[str] = []   # assembled left-to-right
    status = _hirschberg_rec(text, pattern, cutoff_score, segments)
    return status, "".join(segments)


def hirschberg_split(fwd: BandedScoreResult, rev: BandedScoreResult,
                     pattern_len: int, text_len: int, geo: BandGeometry):
    """Band intersection, midpoint argmin and per-half score bounds
    (bpm_hirschberg.c:103-200).

    Returns None on non-convergence, else
    (pattern_len_left, score_l, score_r). Shared by the sequential numpy
    recursion and the batched kernel-backed driver.
    """
    text_mid = (text_len + 1) // 2
    text_mid_r = text_len - text_mid
    prolog = geo.prolog
    fb_pos_v = 0 if text_mid < prolog * W else (text_mid // W) - prolog
    fb_pos_v_r = 0 if text_mid_r < prolog * W else (text_mid_r // W) - prolog

    bottom_pos = fwd.lower_block * W + 63 + fb_pos_v * W
    bottom_pos_r = (pattern_len - 1) - (rev.higher_block * W + 63 + fb_pos_v_r * W)
    higher_pos = fwd.higher_block * W + 63 + fb_pos_v * W
    higher_pos_r = (pattern_len - 1) - (rev.lower_block * W + 63 + fb_pos_v_r * W)

    if bottom_pos > higher_pos_r or bottom_pos_r > higher_pos:
        return None

    if bottom_pos > bottom_pos_r:
        bottom_cell = fwd.lower_block * W + 63
        starting_pos = bottom_pos
    else:
        bottom_cell = bottom_pos_r - fb_pos_v * W
        starting_pos = bottom_pos_r
    if higher_pos < higher_pos_r:
        higher_cell = fwd.higher_block * W + 63
        higher_cell_r = (pattern_len - 1) - higher_pos - fb_pos_v_r * W
    else:
        higher_cell = higher_pos_r - fb_pos_v * W
        higher_cell_r = rev.lower_block * W + 63
    n_cells = higher_cell - bottom_cell + 2

    # The scan can touch one block past the band top (n_cells spans
    # [bottom_cell, higher_cell + 1]). When higher_block is the last
    # band word, the C reference reads past its score-band array into
    # allocator slack (undefined). Model it deterministically with
    # bpm_reset_search values (Pv=ones, Mv=0) — which is also exactly
    # what the batched kernels' padded band rows hold.
    def _bit(words, block, cell, default):
        if 0 <= block < len(words):
            return (words[block] >> cell) & 1
        return default

    cell_score = [0] * (n_cells + 1)
    for i in range(n_cells):
        block = (bottom_cell + i) // W
        cell = (bottom_cell + i) % W
        cell_score[i + 1] = cell_score[i] + \
            _bit(fwd.Pv, block, cell, 1) - _bit(fwd.Mv, block, cell, 0)
    cell_score_r = [0] * (n_cells + 1)
    for i in range(n_cells):
        block = (higher_cell_r + i) // W
        cell = (higher_cell_r + i) % W
        cell_score_r[i + 1] = cell_score_r[i] + \
            _bit(rev.Pv, block, cell, 1) - _bit(rev.Mv, block, cell, 0)

    smaller_pos = 0
    smaller = cell_score_r[n_cells - 1] + cell_score[0]
    for i in range(1, n_cells):
        new = cell_score_r[n_cells - 1 - i] + cell_score[i]
        if new < smaller:
            smaller_pos = i
            smaller = new

    pattern_len_left = starting_pos + smaller_pos
    pattern_len_right = pattern_len - pattern_len_left

    # Sub-alignment score bounds (bpm_hirschberg.c:194-200). The C code
    # can index cell_score outside [0, n_cells] in degenerate band
    # geometries (undefined behavior in the reference, which reads
    # whatever is in the allocation slack); we clamp deterministically —
    # the bounds only seed the recursion's cutoffs, and the banded
    # kernels re-verify them.
    def _cs(arr, idx):
        return arr[min(max(idx, 0), n_cells)]

    block_ref = div_ceil(pattern_len_left, W) - (1 if n_cells < smaller_pos + W else 0)
    score_pos_l = block_ref * W - (bottom_cell + fb_pos_v * W)
    score_l = cell_score[smaller_pos] - _cs(cell_score, score_pos_l) + \
        fwd.scores.get(block_ref - 1, block_ref * W)
    block_ref_r = div_ceil(pattern_len_right, W) - (1 if smaller_pos < W else 0)
    score_pos_r = block_ref_r * W - (higher_cell_r + fb_pos_v_r * W)
    score_r = _cs(cell_score_r, n_cells - 1 - smaller_pos) - \
        _cs(cell_score_r, score_pos_r) + \
        rev.scores.get(block_ref_r - 1, block_ref_r * W)
    return pattern_len_left, score_l, score_r


def hirschberg_split_fast(pv64: np.ndarray, mv64: np.ndarray,
                          f_first: int, f_last: int,
                          scores_k: np.ndarray,
                          r_pv64: np.ndarray, r_mv64: np.ndarray,
                          r_first: int, r_last: int,
                          r_scores_k: np.ndarray,
                          prolog: int,
                          pattern_len: int, text_len: int):
    """Vectorised hirschberg_split over the batched kernels' native
    outputs: pv64/mv64 are (ebb,) uint64 band words, scores_k the
    (K+1,) shifted-row score vectors (row k = absolute block row
    k - prolog; untouched rows hold the init formula, which equals the
    reference's out-of-dict default block_ref*64).

    Bit-identical to hirschberg_split (first-argmin preserved by
    np.argmin); the per-cell Python loops were the Hirschberg driver's
    per-level host cost on long reads.
    """
    W_ = W
    text_mid = (text_len + 1) // 2
    text_mid_r = text_len - text_mid
    fb_pos_v = 0 if text_mid < prolog * W_ else (text_mid // W_) - prolog
    fb_pos_v_r = 0 if text_mid_r < prolog * W_ else (text_mid_r // W_) - prolog

    bottom_pos = f_first * W_ + 63 + fb_pos_v * W_
    bottom_pos_r = (pattern_len - 1) - (r_last * W_ + 63 + fb_pos_v_r * W_)
    higher_pos = f_last * W_ + 63 + fb_pos_v * W_
    higher_pos_r = (pattern_len - 1) - (r_first * W_ + 63 + fb_pos_v_r * W_)

    if bottom_pos > higher_pos_r or bottom_pos_r > higher_pos:
        return None

    if bottom_pos > bottom_pos_r:
        bottom_cell = f_first * W_ + 63
        starting_pos = bottom_pos
    else:
        bottom_cell = bottom_pos_r - fb_pos_v * W_
        starting_pos = bottom_pos_r
    if higher_pos < higher_pos_r:
        higher_cell = f_last * W_ + 63
        higher_cell_r = (pattern_len - 1) - higher_pos - fb_pos_v_r * W_
    else:
        higher_cell = higher_pos_r - fb_pos_v * W_
        higher_cell_r = r_first * W_ + 63
    n_cells = higher_cell - bottom_cell + 2

    def cell_cumsum(pv, mv, start):
        idx = start + np.arange(n_cells, dtype=np.int64)
        blocks = idx >> 6
        cells = (idx & 63).astype(np.uint64)
        ok = (blocks >= 0) & (blocks < len(pv))
        blk = np.clip(blocks, 0, max(len(pv) - 1, 0))
        pv_b = ((pv[blk] >> cells) & np.uint64(1)).astype(np.int64)
        mv_b = ((mv[blk] >> cells) & np.uint64(1)).astype(np.int64)
        # out-of-range words: reset-value semantics (Pv=1, Mv=0)
        step = np.where(ok, pv_b - mv_b, 1)
        out = np.empty(n_cells + 1, dtype=np.int64)
        out[0] = 0
        np.cumsum(step, out=out[1:])
        return out

    cs = cell_cumsum(pv64, mv64, bottom_cell)
    csr = cell_cumsum(r_pv64, r_mv64, higher_cell_r)

    joint = csr[n_cells - 1::-1][:n_cells] + cs[:n_cells]
    smaller_pos = int(np.argmin(joint))      # first minimum
    pattern_len_left = starting_pos + smaller_pos

    def _cs(arr, idx):
        return int(arr[min(max(idx, 0), n_cells)])

    def _score_row(sk, row):
        # scores_k row (row + prolog); absent rows = (row + 1) * 64
        r = row + prolog
        if 0 <= r < len(sk):
            return int(sk[r])
        return (row + 1) * W_

    block_ref = div_ceil(pattern_len_left, W_) - (
        1 if n_cells < smaller_pos + W_ else 0)
    score_pos_l = block_ref * W_ - (bottom_cell + fb_pos_v * W_)
    score_l = int(cs[smaller_pos]) - _cs(cs, score_pos_l) + \
        _score_row(scores_k, block_ref - 1)
    pattern_len_right = pattern_len - pattern_len_left
    block_ref_r = div_ceil(pattern_len_right, W_) - (
        1 if smaller_pos < W_ else 0)
    score_pos_r = block_ref_r * W_ - (higher_cell_r + fb_pos_v_r * W_)
    score_r = _cs(csr, n_cells - 1 - smaller_pos) - \
        _cs(csr, score_pos_r) + _score_row(r_scores_k, block_ref_r - 1)
    return pattern_len_left, score_l, score_r


def _hirschberg_rec(text: str, pattern: str, cutoff_score: int,
                    segments: list[str]) -> QuickedStatus:
    text_len = len(text)
    pattern_len = len(pattern)
    geo = band_geometry(pattern_len, text_len, cutoff_score)
    footprint = geo.ebb * text_len * 8 * 2
    if footprint <= HIRSCHBERG_BUFFER:
        score, ops = banded_align(pattern, text, cutoff_score, only_score=False)
        segments.insert(0, ops)   # cigar_prepend_forward semantics
        return QuickedStatus.QUICKED_OK

    text_mid = (text_len + 1) // 2
    text_mid_r = text_len - text_mid
    pat = compile_pattern(pattern)
    pat_r = compile_pattern(pattern[::-1])
    text_enc = dna.encode(text)
    text_r_enc = dna.encode(text[::-1])

    fwd = banded_score(pat, text_enc, cutoff_score,
                       text_len=text_len, text_finish_pos=text_mid)
    rev = banded_score(pat_r, text_r_enc, cutoff_score,
                       text_len=text_len, text_finish_pos=text_mid_r)

    split = hirschberg_split(fwd, rev, pattern_len, text_len, geo)
    if split is None:
        return QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE
    pattern_len_left, score_l, score_r = split

    # Right half first, then left (both write right-to-left in the
    # reference; we assemble left-to-right by list order).
    right_segments: list[str] = []
    status = _hirschberg_rec(text[text_mid:], pattern[pattern_len_left:],
                             score_r, right_segments)
    if int(status) < 0:
        segments[:0] = right_segments
        return status
    left_segments: list[str] = []
    status = _hirschberg_rec(text[:text_mid], pattern[:pattern_len_left],
                             score_l, left_segments)
    segments[:0] = left_segments + right_segments
    if int(status) < 0:
        return status
    return QuickedStatus.QUICKED_OK


# ---------------------------------------------------------------------------
# QuickEd cascade (run_quicked, quicked.c:163-306)
# ---------------------------------------------------------------------------

def quicked_align(pattern: str, text: str, bandwidth: int = 15,
                  window_size: int = 9, overlap_size: int = 1,
                  hew_threshold=(40, 40), hew_percentage=(15, 15)):
    """The full QuickEd bound-and-align cascade. Returns (status, ops)."""
    plen, tlen = len(pattern), len(text)
    max_len = max(plen, tlen)

    # STAGE 1: fast windowed bound (ws=2, ovl=1).
    score, _, hew = windowed_compute(pattern, text, hew_threshold[0], 2, 1,
                                     score_only=True)
    if hew * W > max_len * hew_percentage[0] // 100:
        # STAGE 2: large windowed forward + reverse.
        s_fwd, _, hew_fwd = windowed_compute(pattern, text, hew_threshold[1],
                                             window_size, overlap_size,
                                             score_only=True)
        s_rev, _, hew_rev = windowed_compute(pattern[::-1], text[::-1],
                                             hew_threshold[1], window_size,
                                             overlap_size, score_only=True)
        score = min(s_fwd, s_rev)
        high_error_window = hew_fwd
        if score >= s_rev:
            high_error_window = hew_rev
        if (high_error_window * W * (window_size - overlap_size)) > \
                (max_len * hew_percentage[1] // 100):
            # STAGE 3: banded score-only with telescoping retry.
            pat = compile_pattern(pattern)
            text_enc = dna.encode(text)
            score = min(max_len * bandwidth // 100, score)
            new_score = banded_score(pat, text_enc, score).score
            while (new_score > max_len // 4 and score * 3 // 2 < new_score) \
                    or new_score < 0:
                score *= 2
                new_score = banded_score(pat, text_enc, score).score
            score = new_score
    # STAGE 4: full alignment under the proven bound.
    status, ops = hirschberg(text, pattern, score)
    return status, ops
