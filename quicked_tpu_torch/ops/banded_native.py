"""The host C lanes of BandEd: the score pass and the full alignment.

The port's copy of quicked_tpu/ops/banded_native.py. The per-pair C
kernels of the port's host runtime (native/src/quicked_host.c) run the
banded score pass and the full fill with its traceback on the host's
cores. The venue router (aligner/batch.py) sends a batch here when the
host's measured estimate beats the card's. The score pass matches the
fill's score-only outputs lane for lane on everything the consumers read
(final scores, the live band [first..last], the block-row scores); band
rows outside the live band hold init values.
"""

from __future__ import annotations

import numpy as np

from quicked_tpu_torch import dna, native
from quicked_tpu_torch.ops.batch_prep import BandedBatch
from quicked_tpu_torch.utils.host_threads import map_lanes

W = 64


def native_available() -> bool:
    return native.available()


def run_banded_full_native(patterns, texts, cutoffs, workers=None,
                           raws=None):
    """Full BandEd alignment (fill + traceback) per pair through the C
    kernel, threaded over the pairs; returns (scores int64 array, ops
    list).

    `raws`: optional (praws, traws) lists of the original byte strings
    for pre-encoded inputs: the traceback's M-vs-X test compares raw
    characters (bpm_banded.c traceback semantics), which the 5-letter
    encoding collapses."""
    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    ops_out: list = [None] * n

    def raw(s, enc):
        if isinstance(s, np.ndarray):
            return np.asarray(enc, dtype=np.uint8).tobytes()
        return s.encode("ascii", "replace")

    def one(i):
        p, t = patterns[i], texts[i]
        pe = p if isinstance(p, np.ndarray) else dna.encode(p)
        te = t if isinstance(t, np.ndarray) else dna.encode(t)
        praw = raws[0][i] if raws is not None else raw(p, pe)
        traw = raws[1][i] if raws is not None else raw(t, te)
        scores[i], ops_out[i] = native.banded_align_full(
            pe, praw, te, traw, int(cutoffs[i]))

    map_lanes(one, n, workers)
    return scores, ops_out


def run_banded_native(batch: BandedBatch):
    """The score-only banded pass of a BandedBatch through the C kernel:
    ONE native call for the whole batch (pthread pool inside), then a
    vectorised scatter into the fill's output layout, as u32 lo/hi
    planes."""
    assert not batch.full, "native path is score-only"
    assert batch.enc_patterns is not None, "batch lacks host sequences"
    B, EBB, K = batch.B, batch.EBB, batch.K
    n = len(batch.enc_patterns)

    scores_by_k = np.empty((K + 1, B), dtype=np.int32)
    # padded lanes / untouched rows: the init formula (k - prolog + 1)*64
    k_idx = np.arange(K + 1, dtype=np.int64)[:, None]
    scores_by_k[:] = ((k_idx - batch.prolog[None, :] + 1) * W)
    pv_lo = np.full((EBB, B), 0xFFFFFFFF, dtype=np.uint32)
    pv_hi = np.full((EBB, B), 0xFFFFFFFF, dtype=np.uint32)
    mv_lo = np.zeros((EBB, B), dtype=np.uint32)
    mv_hi = np.zeros((EBB, B), dtype=np.uint32)
    first = batch.first0.astype(np.int32).copy()
    last = batch.last0.astype(np.int32).copy()

    res = native.banded_score_batch(
        batch.enc_patterns, batch.enc_texts,
        batch.cutoff[:n].astype(np.int64), batch.tfinish[:n],
        want_state=True)
    first[:n] = res["first"]
    last[:n] = res["last"]
    # per-pair ebb can differ; scatter with a column mask
    ebb = res["ebb"]
    rows = np.arange(res["pv"].shape[1], dtype=np.int64)
    live = rows[None, :] < ebb[:, None]          # (n, ebb_cap)
    m_rows = min(res["pv"].shape[1], EBB)
    lv = live[:, :m_rows].T                      # (m_rows, n)
    pvT = res["pv"][:, :m_rows].T
    mvT = res["mv"][:, :m_rows].T
    np.copyto(pv_lo[:m_rows, :n], (pvT & np.uint64(0xFFFFFFFF))
              .astype(np.uint32), where=lv)
    np.copyto(pv_hi[:m_rows, :n], (pvT >> np.uint64(32))
              .astype(np.uint32), where=lv)
    np.copyto(mv_lo[:m_rows, :n], (mvT & np.uint64(0xFFFFFFFF))
              .astype(np.uint32), where=lv)
    np.copyto(mv_hi[:m_rows, :n], (mvT >> np.uint64(32))
              .astype(np.uint32), where=lv)
    m = min(res["scores"].shape[1], K + 1)
    scores_by_k[:m, :n] = res["scores"][:, :m].T

    return dict(scores_by_k=scores_by_k, pv_lo=pv_lo, pv_hi=pv_hi,
                mv_lo=mv_lo, mv_hi=mv_hi, first=first, last=last)
