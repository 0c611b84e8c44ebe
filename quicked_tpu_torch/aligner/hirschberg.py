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

from collections.abc import Sequence

import numpy as np

from quicked_tpu_torch import dna
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops import myers_np
from quicked_tpu_torch.ops.packed import PackedSeqs, lengths, pack_pairs
from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE, QuickedStatus


def _enc_raw(s):
    """(encoded uint8 array, raw bytes) of a sequence, made once per
    pair; levels slice both."""
    if isinstance(s, np.ndarray):
        e = np.asarray(s, np.uint8)
        return e, e.tobytes()
    return dna.encode(s), s.encode("ascii", "replace")


def _packed_enc_raw(seqs: PackedSeqs, i: int):
    """`_enc_raw` of sequence i of a PackedSeqs: a view of its encoded
    buffer and its raw bytes."""
    o, k = int(seqs.off[i]), int(seqs.len[i])
    return seqs.encoded()[o:o + k], seqs.buf[o:o + k].tobytes()


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


class HirschbergResult(Sequence):
    """`hirschberg_batch`'s result: (status, ops_str) per pair in input
    order, the strings decoded on first access; `status` (a list) and
    `ops` (every pair's op bytes, a PackedSeqs) as they came."""

    __slots__ = ("status", "ops", "_items")

    def __init__(self, status: list, ops: PackedSeqs):
        self.status, self.ops, self._items = status, ops, None

    def _list(self) -> list:
        if self._items is None:
            self._items = list(zip(self.status, self.ops.strs()))
        return self._items

    def __len__(self):
        return len(self.status)

    def __getitem__(self, i):
        return self._list()[i]

    def __iter__(self):
        return iter(self._list())

    def __eq__(self, other):
        return self._list() == list(other)


def hirschberg_batch(texts, patterns, cutoffs,
                     device="cuda") -> HirschbergResult:
    """Full alignment of each (text, pattern) under its score bound.

    texts/patterns: lists of str or encoded arrays, or PackedSeqs.
    Returns (status, ops_str) per pair in input order (a
    HirschbergResult: a pair whose alignment is one base case keeps the
    op bytes its chunk's traceback packed, and no str is made for it
    until read). On QUICKED_FAIL_NON_CONVERGENCE, ops_str holds the
    partial right-side alignment the reference leaves in its output
    buffer (maybe empty).
    """
    from quicked_tpu_torch.aligner import batch as ab

    dev = resolve_device(device)
    n = len(texts)
    cutoffs = np.asarray(cutoffs, dtype=np.int64)
    pk = pack_pairs(texts, patterns)
    leaves: dict[int, list] = {}    # pair -> its split tasks' leaves
    status = [QuickedStatus.QUICKED_OK] * n
    # rightmost failing path per pair: the reference's DFS (right half
    # first) aborts there, and only leaves right of it were written
    fail_path: dict[int, tuple] = {}

    # level 0, every pair at once: the base cases run as one batch (a
    # packed one where the pairs pack), the rest become split tasks
    tl = pk[0].len if pk is not None else lengths(texts)
    geo = myers_np.band_geometries(
        pk[1].len if pk is not None else lengths(patterns), tl, cutoffs)
    is_base = geo.ebb * tl * 8 * 2 <= HIRSCHBERG_BUFFER_SIZE
    base0 = np.flatnonzero(is_base)
    if pk is None:
        encs = [(_enc_raw(texts[i]), _enc_raw(patterns[i]))
                for i in range(n)]
    ops0 = None
    if len(base0):
        if pk is not None:
            _, ops0 = ab.banded_align_batch(
                pk[1].take(base0), pk[0].take(base0), cutoffs[base0],
                only_score=False, device=dev, packed_ops=True)
        else:
            b0 = base0.tolist()
            _, ops0 = ab.banded_align_batch(
                [encs[i][1][0] for i in b0], [encs[i][0][0] for i in b0],
                cutoffs[base0], only_score=False, device=dev,
                raws=([encs[i][1][1] for i in b0],
                      [encs[i][0][1] for i in b0]), packed_ops=True)

    # task: (pair, path, text, pattern, cutoff, traw, praw); path is the
    # 0/1 left/right descent, so lexicographic order is CIGAR order
    tasks = []
    for i in np.flatnonzero(~is_base).tolist():
        if pk is not None:
            te, tr = _packed_enc_raw(pk[0], i)
            pe, pr = _packed_enc_raw(pk[1], i)
        else:
            (te, tr), (pe, pr) = encs[i]
        tasks.append((i, (), te, pe, int(cutoffs[i]), tr, pr))

    while tasks:
        tasks = [t for t in tasks
                 if not (t[0] in fail_path and t[1] < fail_path[t[0]])]
        lens_t = np.fromiter((len(t[2]) for t in tasks), np.int64,
                             len(tasks))
        g = myers_np.band_geometries(
            np.fromiter((len(t[3]) for t in tasks), np.int64, len(tasks)),
            lens_t, np.fromiter((t[4] for t in tasks), np.int64,
                                len(tasks)))
        fits = (g.ebb * lens_t * 8 * 2 <= HIRSCHBERG_BUFFER_SIZE).tolist()
        base = [t for t, f in zip(tasks, fits) if f]
        split = [t for t, f in zip(tasks, fits) if not f]

        if base:
            _, ops = ab.banded_align_batch(
                [t[3] for t in base], [t[2] for t in base],
                [t[4] for t in base], only_score=False, device=dev,
                raws=([t[6] for t in base], [t[5] for t in base]))
            for t, op in zip(base, ops):
                leaves.setdefault(t[0], []).append((t[1], op))

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

    # the pairs of several leaves (or none): their leaves joined in order
    rest = np.flatnonzero(~is_base)
    joined = []
    for i in rest.tolist():
        fp = fail_path.get(i, ())
        kept = [(p, op) for p, op in leaves.get(i, [])
                if status[i] == QuickedStatus.QUICKED_OK or p > fp]
        joined.append("".join(op for _, op in sorted(kept)))
    pieces = [] if ops0 is None else [(base0, ops0.buf, ops0.off,
                                       ops0.len)]
    if len(rest):
        pj = PackedSeqs.of_bytes(joined)
        pieces.append((rest, pj.buf, pj.off, pj.len))
    return HirschbergResult(status, PackedSeqs.concat(n, pieces))
