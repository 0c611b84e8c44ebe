"""Batched Hirschberg worklist over the port's banded kernels.

The counterpart of quicked_tpu/aligner/hirschberg.py (`hirschberg_batch`,
`_level_splits`), with the same worklist: all pairs' subproblems run level
by level. Base cases (band footprint <= the 16 MB budget,
bpm_hirschberg.c:63-65) run through the full fill and the on-device
traceback, or the host C fill and traceback where the router sends them.
Every split level runs in `batch.hirschberg_level_splits_device`: on the
card, the forward and reverse half passes, through the fill or, for a
deep band, the deep-band kernels, and the split epilogue, four numbers
per task read back; or, for a bucket the router sends to the host, the
host C half passes and `_level_splits`. Leaf CIGARs are assembled left to
right by their recursion path.

Failure semantics follow the reference's shared right-to-left buffer
(bpm_hirschberg.c:210-243): on QUICKED_FAIL_NON_CONVERGENCE only the
leaves right of the DFS-first failing node are kept.
"""

from __future__ import annotations

import numpy as np

from quicked_tpu_torch import dna
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops import myers_np
from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE, QuickedStatus


def _enc_raw(s):
    """(encoded uint8 array, raw bytes) of a sequence, made once per
    pair; levels slice both."""
    if isinstance(s, np.ndarray):
        e = np.asarray(s, np.uint8)
        return e, e.tobytes()
    return dna.encode(s), s.encode("ascii", "replace")


def _level_splits(pats, txts, fwd, rev):
    """Per-task midpoints of a split level whose half passes ran on the
    host (`batch.banded_score_results`): (pll, score_l, score_r) or None
    per task, by the spec path (myers_np.hirschberg_split_fast), which the
    card's split epilogue equals bit for bit. The JAX package runs its
    levels of 64 tasks or more through a batched XLA op on the CPU; the
    port has no XLA, so every level takes the spec path."""
    return [myers_np.hirschberg_split_fast(
        f.pv64, f.mv64, f.first, f.last, f.scores_k,
        r.pv64, r.mv64, r.first, r.last, r.scores_k,
        f.prolog, len(p), len(t))
        for p, t, f, r in zip(pats, txts, fwd, rev)]


def hirschberg_batch(texts, patterns, cutoffs, device="cuda"):
    """Full alignment of each (text, pattern) under its score bound.

    Returns a list of (status, ops_str) in input order. On
    QUICKED_FAIL_NON_CONVERGENCE, ops_str holds the partial right-side
    alignment the reference leaves in its output buffer (maybe empty).
    """
    from quicked_tpu_torch.aligner import batch as ab

    dev = resolve_device(device)
    n = len(texts)
    leaves: list[list] = [[] for _ in range(n)]
    status = [QuickedStatus.QUICKED_OK] * n
    # rightmost failing path per pair: the reference's DFS (right half
    # first) aborts there, and only leaves right of it were written
    fail_path: dict[int, tuple] = {}

    # task: (pair, path, text, pattern, cutoff, traw, praw); path is the
    # 0/1 left/right descent, so lexicographic order is CIGAR order
    tasks = []
    for i in range(n):
        te, tr = _enc_raw(texts[i])
        pe, pr = _enc_raw(patterns[i])
        tasks.append((i, (), te, pe, int(cutoffs[i]), tr, pr))

    while tasks:
        base, split = [], []
        for t in tasks:
            i, path, text, pattern, cutoff = t[:5]
            if i in fail_path and path < fail_path[i]:
                continue        # left of the failure: never visited
            geo = myers_np.band_geometry(len(pattern), len(text), cutoff)
            if geo.ebb * len(text) * 8 * 2 <= HIRSCHBERG_BUFFER_SIZE:
                base.append(t)
            else:
                split.append(t)

        if base:
            _, ops = ab.banded_align_batch(
                [t[3] for t in base], [t[2] for t in base],
                [t[4] for t in base], only_score=False, device=dev,
                raws=([t[6] for t in base], [t[5] for t in base]))
            for t, op in zip(base, ops):
                leaves[t[0]].append((t[1], op))

        tasks = []
        if split:
            pats = [t[3] for t in split]
            txts = [t[2] for t in split]
            cos = [t[4] for t in split]
            mids = [(len(t[2]) + 1) // 2 for t in split]
            mids_r = [len(t[2]) - m for t, m in zip(split, mids)]
            splits = ab.hirschberg_level_splits_device(
                pats, txts, cos, mids, mids_r, device=dev)
            for t, mid, sp in zip(split, mids, splits):
                i, path, text, pattern, cutoff, traw, praw = t
                if sp is None:
                    status[i] = QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE
                    if path >= fail_path.get(i, path):
                        fail_path[i] = path
                    continue
                pll, score_l, score_r = sp
                tasks.append((i, path + (0,), text[:mid], pattern[:pll],
                              int(score_l), traw[:mid], praw[:pll]))
                tasks.append((i, path + (1,), text[mid:], pattern[pll:],
                              int(score_r), traw[mid:], praw[pll:]))

    out = []
    for i in range(n):
        if status[i] != QuickedStatus.QUICKED_OK:
            fp = fail_path.get(i, ())
            kept = [(p, op) for p, op in leaves[i] if p > fp]
            out.append((status[i], "".join(op for _, op in sorted(kept))))
        else:
            ops = "".join(op for _, op in sorted(leaves[i]))
            out.append((QuickedStatus.QUICKED_OK, ops))
    return out
