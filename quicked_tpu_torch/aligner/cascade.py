"""Batched QuickEd bound-and-align cascade on the card.

The counterpart of quicked_tpu/aligner/cascade.py (`windowed_score_batch`,
`quicked_cascade_batch`, `_cascade_staged`, `CascadeResult`): the staged
lane, where the batch is re-partitioned between stages and every stage
runs through the port's kernels (run_quicked, quicked.c:163-306):

  stage 1: windowed bound, ws=2 ovl=1                  (quicked.c:184-199)
  stage 2: windowed bound, ws/ovl of the params, on the
           pair and the reversed pair                  (quicked.c:204-235)
  stage 3: banded score with the telescoping retry     (quicked.c:237-276)
  stage 4: Hirschberg under the proven bound           (quicked.c:290)

The JAX package's one-call host C lane and its routing model are not
carried over: every pair takes the staged device lane.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quicked_tpu_torch.aligner.batch import _next_pow2, banded_align_batch
from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops.windowed_cuda import (prepare_windowed_batch,
                                                 run_windowed_score)
from quicked_tpu_torch.params import QuickedParams, QuickedStatus
from quicked_tpu_torch.utils.profiler import PhaseTimers

W = 64


@dataclasses.dataclass
class CascadeResult:
    status: list
    score: np.ndarray
    cigar: list


def windowed_score_batch(patterns, texts, hew_threshold: int,
                         window_size: int, overlap_size: int,
                         device="cuda"):
    """Bucketed windowed score bound. Returns (score, hew) int64 arrays."""
    dev = resolve_device(device)
    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    hews = np.zeros(n, dtype=np.int64)
    cols = W * window_size
    by_key: dict = {}
    for i in range(n):
        key = _next_pow2(max(len(patterns[i]), len(texts[i]), cols))
        by_key.setdefault(key, []).append(i)
    for idxs in by_key.values():
        batch = prepare_windowed_batch(
            [patterns[i] for i in idxs], [texts[i] for i in idxs],
            window_size=window_size)
        sc, hw = run_windowed_score(batch, hew_threshold, window_size,
                                    overlap_size, device=dev)
        scores[idxs] = sc
        hews[idxs] = hw
    return scores, hews


def quicked_cascade_batch(pairs, params: QuickedParams | None = None,
                          timers=None, device="cuda") -> CascadeResult:
    """Run the QuickEd cascade on a batch of (pattern, text) pairs.
    `timers` (utils.profiler.PhaseTimers) takes the per-stage times, as
    the reference's instrumentation does (quicked.c:184-294)."""
    params = params or QuickedParams()
    dev = resolve_device(device)
    if timers is None:
        timers = PhaseTimers()
    timers.total.start()
    try:
        return _cascade_staged(pairs, params, timers, dev)
    finally:
        timers.total.stop()


def proven_bounds(pats, txts, params: QuickedParams, timers,
                  device) -> np.ndarray:
    """Stages 1-3: the score bound each pair's stage-4 alignment runs
    under (quicked.c:184-276). int64 array in input order."""
    n = len(pats)
    max_len = np.array([max(len(p), len(t)) for p, t in zip(pats, txts)],
                       dtype=np.int64)

    # ---- STAGE 1: fast windowed bound (quicked.c:184-199) ----
    timers.windowed_s.start()
    score, hew = windowed_score_batch(pats, txts, params.hew_threshold[0],
                                      2, 1, device=device)
    timers.windowed_s.stop()
    hard = [i for i in range(n)
            if hew[i] * W > max_len[i] * params.hew_percentage[0] // 100]

    if hard:
        # ---- STAGE 2: large windows, forward + reversed pair ----
        ws, ovl = params.window_size, params.overlap_size
        timers.windowed_l.start()
        s_fwd, hew_fwd = windowed_score_batch(
            [pats[i] for i in hard], [txts[i] for i in hard],
            params.hew_threshold[1], ws, ovl, device=device)
        s_rev, hew_rev = windowed_score_batch(
            [pats[i][::-1] for i in hard], [txts[i][::-1] for i in hard],
            params.hew_threshold[1], ws, ovl, device=device)
        timers.windowed_l.stop()
        harder = []
        for j, i in enumerate(hard):
            sc = min(s_fwd[j], s_rev[j])
            hw = hew_fwd[j]
            if sc >= s_rev[j]:
                hw = hew_rev[j]
            score[i] = sc
            if hw * W * (ws - ovl) > \
                    max_len[i] * params.hew_percentage[1] // 100:
                harder.append(i)

        if harder:
            # ---- STAGE 3: banded score + telescoping retry
            # (quicked.c:246-276) ----
            timers.banded.start()
            cut = {i: int(min(max_len[i] * params.bandwidth // 100,
                              score[i]))
                   for i in harder}
            # Narrow-band trial: a banded score <= its cutoff is exact, so
            # a 5/8 band resolves cap-limited pairs at ~5/8 the cost;
            # failures fall into the reference retry schedule below.
            trial = [i for i in harder
                     if score[i] > cut[i] and cut[i] >= 4096
                     and cut[i] * 5 // 8
                     > abs(len(pats[i]) - len(txts[i])) + 1]
            if trial:
                tcut = [cut[i] * 5 // 8 for i in trial]
                ts, _ = banded_align_batch(
                    [pats[i] for i in trial], [txts[i] for i in trial],
                    tcut, only_score=True, device=device)
                accepted = set()
                for j, i in enumerate(trial):
                    s = int(ts[j])
                    if 0 <= s <= tcut[j]:
                        score[i] = s
                        accepted.add(i)
                harder = [i for i in harder if i not in accepted]
            pending = list(harder)
            while pending:
                ns, _ = banded_align_batch(
                    [pats[i] for i in pending], [txts[i] for i in pending],
                    [cut[i] for i in pending], only_score=True,
                    device=device)
                nxt = []
                for j, i in enumerate(pending):
                    new_score = int(ns[j])
                    if (new_score > max_len[i] // 4
                            and cut[i] * 3 // 2 < new_score) or new_score < 0:
                        # floor at 1: a zero cut would double to zero
                        cut[i] = max(cut[i] * 2, 1)
                        nxt.append(i)
                    else:
                        score[i] = new_score
                pending = nxt
            timers.banded.stop()
    return score


def _cascade_staged(pairs, params: QuickedParams, timers,
                    device) -> CascadeResult:
    from quicked_tpu_torch.aligner.hirschberg import hirschberg_batch

    n = len(pairs)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    score = proven_bounds(pats, txts, params, timers, device)

    # ---- STAGE 4: full alignment under the proven bound ----
    timers.align.start()
    res = hirschberg_batch(txts, pats, [int(s) for s in score],
                           device=device)
    timers.align.stop()

    statuses: list = [None] * n
    final_scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n
    for i, (st, ops) in enumerate(res):
        # run_quicked ignores the Hirschberg status and extracts whatever
        # (possibly partial) CIGAR is in the buffer, returning WIP
        # (quicked.c:290-305)
        statuses[i] = QuickedStatus.QUICKED_WIP
        c = Cigar(operations=ops or "")
        final_scores[i] = c.score_edit()
        cigars[i] = c.sprint(True) if ops else None
    return CascadeResult(status=statuses, score=final_scores, cigar=cigars)
