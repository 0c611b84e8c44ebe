"""The port's Hirschberg worklist
(quicked_tpu_torch.aligner.hirschberg) vs the JAX package's worklist and
the numpy model: split levels (the base-case budget shrunk so small
pairs split), the right-of-failure leaf rule, and the cascade ignoring a
stage-4 failure."""

from collections import Counter

import torch

from quicked_tpu import generate
from quicked_tpu.aligner import hirschberg as jax_hb
from quicked_tpu.ops import edit_dp, myers_np
from quicked_tpu.params import QuickedParams, QuickedStatus
from quicked_tpu_torch.aligner import batch, cascade
from quicked_tpu_torch.aligner import hirschberg as hb

torch.set_num_threads(1)


def _shrink_budget(monkeypatch, size):
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", size)
    monkeypatch.setattr(jax_hb, "HIRSCHBERG_BUFFER_SIZE", size)
    monkeypatch.setattr(myers_np, "HIRSCHBERG_BUFFER", size)


def test_torch_hirschberg_split_levels(monkeypatch):
    """A 4 KB budget forces real splits: forward and reverse half passes
    through the score fill and the split epilogue (the fused level)."""
    _shrink_budget(monkeypatch, 4096)
    pairs = list(generate.generate_pairs(3, 400, error=0.1, seed=11)) + \
        list(generate.generate_pairs(2, 600, error=0.12, seed=12))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [edit_dp.edit_distance(p, t) + 16 for p, t in pairs]
    got = hb.hirschberg_batch(txts, pats, cutoffs, device="cpu")
    want = jax_hb.hirschberg_batch(txts, pats, cutoffs)
    assert [(int(s), o) for s, o in got] == [(int(s), o) for s, o in want]
    for i, (p, t) in enumerate(pairs):
        mstatus, mops = myers_np.hirschberg(t, p, cutoffs[i])
        assert got[i][0] == mstatus
        assert got[i][1] == mops, i


def test_torch_hirschberg_partial_on_injected_failure(monkeypatch):
    """A split failure injected at one deep subproblem: the worklist keeps
    exactly the leaves right of it, as the model's DFS does."""
    (pat, txt), = generate.generate_pairs(1, 1500, error=0.05, seed=4)
    _shrink_budget(monkeypatch, 1 << 13)

    real_split = myers_np.hirschberg_split
    real_fast = myers_np.hirschberg_split_fast
    seen = []

    def recording(fwd, rev, plen, tlen, geo):
        seen.append((plen, tlen))
        return real_split(fwd, rev, plen, tlen, geo)

    monkeypatch.setattr(myers_np, "hirschberg_split", recording)
    st0, _ = myers_np.hirschberg(txt, pat, 65)
    assert st0 == QuickedStatus.QUICKED_OK and len(seen) >= 3
    counts = Counter(seen)
    target = next(s for s in reversed(seen) if counts[s] == 1)
    assert target != seen[0]

    def injected(fwd, rev, plen, tlen, geo):
        if (plen, tlen) == target:
            return None
        return real_split(fwd, rev, plen, tlen, geo)

    def injected_fast(pv, mv, first, last, sk, rpv, rmv, rfirst, rlast,
                      rsk, prolog, plen, tlen):
        if (plen, tlen) == target:
            return None
        return real_fast(pv, mv, first, last, sk, rpv, rmv, rfirst,
                         rlast, rsk, prolog, plen, tlen)

    real_fused = batch.hirschberg_level_splits_device

    def injected_fused(pats, txts, cos, mids, mids_r, device="cuda"):
        # the port's fused split level fails at the same subproblem
        res = real_fused(pats, txts, cos, mids, mids_r, device=device)
        return [None if (len(p), len(t)) == target else r
                for p, t, r in zip(pats, txts, res)]

    monkeypatch.setattr(myers_np, "hirschberg_split", injected)
    monkeypatch.setattr(myers_np, "hirschberg_split_fast", injected_fast)
    monkeypatch.setattr(batch, "hirschberg_level_splits_device",
                        injected_fused)
    st_model, ops_model = myers_np.hirschberg(txt, pat, 65)
    got = hb.hirschberg_batch([txt], [pat], [65], device="cpu")
    assert int(st_model) < 0
    assert got[0][0] == st_model
    assert got[0][1] == ops_model
    assert len(ops_model) > 0


def test_torch_cascade_ignores_hirschberg_failure(monkeypatch):
    """run_quicked returns the partial results as success even when the
    Hirschberg stage fails (quicked.c:290-305)."""
    def failing(texts, patterns, cutoffs, device="cuda"):
        return [(QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE, "MMMM")
                for _ in texts]

    monkeypatch.setattr(hb, "hirschberg_batch", failing)
    res = cascade.quicked_cascade_batch([("ACGT", "ACGT")], QuickedParams(),
                                        device="cpu")
    assert res.status[0] == QuickedStatus.QUICKED_WIP
    assert res.score[0] == 0
    assert res.cigar[0] == "4M"
