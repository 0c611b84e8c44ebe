"""Quadratic edit-distance DP oracle (edit_dp.c semantics).

The port's copy of quicked_tpu/ops/edit_dp.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Vectorised over columns with the prefix-min trick; used as the
gold-standard score oracle in tests and as the `edit-dp` /
`edit-dp-banded` algorithms of the benchmark CLI
(tools/align_benchmark/edit/edit_dp.c:68-133).
"""

from __future__ import annotations

import numpy as np


def _chars(seq, encoded: bool) -> np.ndarray:
    """Comparison alphabet: the reference's edit_dp compares RAW bytes
    (edit_dp.c:59 on char*, case-sensitive), unlike the quicked
    algorithms' 5-letter encoding; encoded=True selects the encoded view
    (used when oracle-checking the case-insensitive algorithms)."""
    from quicked_tpu_torch import dna

    if isinstance(seq, np.ndarray):
        return seq
    if encoded:
        return dna.encode(seq)
    return np.frombuffer(seq.encode("ascii", "replace"), dtype=np.uint8)


def edit_distance(pattern: str | np.ndarray, text: str | np.ndarray,
                  encoded: bool = True) -> int:
    """Exact Levenshtein distance, O(n*m) time, O(m) memory."""
    p = _chars(pattern, encoded)
    t = _chars(text, encoded)
    n, m = len(p), len(t)
    # Row DP over pattern positions; D[j] = distance(p[:i], t[:j]).
    row = np.arange(m + 1, dtype=np.int64)
    jm1 = np.arange(m, dtype=np.int64)
    for i in range(n):
        cost = (t != p[i]).astype(np.int64)
        cand = np.minimum(row[1:] + 1, row[:-1] + cost)  # up / diag
        new = np.empty(m + 1, dtype=np.int64)
        new[0] = i + 1
        # left-move closure as a prefix min of (value - index), vectorised:
        run = np.minimum.accumulate(cand - jm1)
        new[1:] = np.minimum(cand, run + jm1)
        # account left-move from column 0 boundary
        new[1:] = np.minimum(new[1:], new[0] + 1 + jm1)
        row = new
    return int(row[m])


def edit_dp_matrix(pattern: str, text: str,
                   encoded: bool = False) -> np.ndarray:
    """Full DP matrix (rows = pattern+1, cols = text+1). Raw-byte
    comparisons by default (edit_dp.c parity)."""
    p = _chars(pattern, encoded)
    t = _chars(text, encoded)
    n, m = len(p), len(t)
    D = np.zeros((n + 1, m + 1), dtype=np.int64)
    D[0, :] = np.arange(m + 1)
    D[:, 0] = np.arange(n + 1)
    for i in range(1, n + 1):
        cost = (t != p[i - 1]).astype(np.int64)
        cand = np.minimum(D[i - 1, 1:] + 1, D[i - 1, :-1] + cost)
        jm1 = np.arange(m, dtype=np.int64)
        run = np.minimum.accumulate(cand - jm1)
        D[i, 1:] = np.minimum(cand, run + jm1)
        D[i, 1:] = np.minimum(D[i, 1:], D[i, 0] + 1 + jm1)
    return D


INT16_MAX = 32767


def edit_dp_matrix_banded(pattern: str, text: str, bandwidth_k: int,
                          encoded: bool = False) -> np.ndarray:
    """Banded quadratic DP (edit_dp_align_banded, edit_dp.c:98-133):
    band of half-width max(|len diff|+1, bandwidth_k) around the
    diagonal, INT16_MAX sentinels just outside the band."""
    p = _chars(pattern, encoded)
    t = _chars(text, encoded)
    n, m = len(p), len(t)
    k_end = abs(m - n) + 1
    ebw = max(k_end, bandwidth_k)
    D = np.full((n + 1, m + 1), INT16_MAX, dtype=np.int64)
    D[0, 0] = 0
    D[1:min(ebw, n) + 1, 0] = np.arange(1, min(ebw, n) + 1)
    for h in range(1, m + 1):
        lo_band = h <= ebw
        lo = 1 if lo_band else h - ebw
        D[lo - 1, h] = h if lo_band else INT16_MAX
        hi = min(n, ebw + h - 1)
        if h > 1:
            D[hi, h - 1] = INT16_MAX
        v = np.arange(lo, hi + 1)
        cost = (p[lo - 1:hi] != t[h - 1]).astype(np.int64)
        cand = np.minimum(D[lo:hi + 1, h - 1] + 1,        # ins
                          D[lo - 1:hi, h - 1] + cost)     # sub
        # del closure down the column (sequential dependency)
        col = np.empty(hi - lo + 1, dtype=np.int64)
        prev = D[lo - 1, h]
        for i in range(hi - lo + 1):
            prev = min(cand[i], prev + 1)
            col[i] = prev
        D[lo:hi + 1, h] = col
    return D


def edit_dp_traceback(D: np.ndarray, pattern: str, text: str) -> str:
    """Traceback following the reference tie-break
    (edit_dp.c:32-67: deletion, then insertion, then match/mismatch)."""
    v, h = len(pattern), len(text)
    ops = []
    while v > 0 and h > 0:
        if D[v, h] == D[v - 1, h] + 1:
            ops.append("D")
            v -= 1
        elif D[v, h] == D[v, h - 1] + 1:
            ops.append("I")
            h -= 1
        else:
            ops.append("M" if pattern[v - 1] == text[h - 1] else "X")
            v -= 1
            h -= 1
    ops.extend("D" * v)
    ops.extend("I" * h)
    return "".join(ops)[::-1]
