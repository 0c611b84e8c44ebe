"""Parity: the port's Hirschberg split epilogue
(quicked_tpu_torch.ops.hirschberg_split_cuda) and its fused split level
(batch.hirschberg_level_splits_device) vs the JAX package's XLA epilogue
(hirschberg_split_jax.hsplit_epilogue_interleaved, i.e.
hirschberg_split_batch), its fused Pallas level in interpret mode
(batch._hsplit_fused_pallas) and the numpy spec
(myers_np.hirschberg_split_fast), on the tasks of
tests/test_hsplit_device.py, infeasible tasks included. Tolerance 0."""

import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.ops.hirschberg_split_jax import hsplit_epilogue_interleaved
from quicked_tpu_torch.aligner import batch
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import hirschberg_split_cuda as hs

torch.set_num_threads(1)
W = 64


def _tasks(n, length, error, seed):
    pairs = list(generate.generate_pairs(n, length, error=error, seed=seed))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(max(len(p), len(t)) * 25 // 100, abs(len(p) - len(t)) + 1)
           for p, t in pairs]
    mids = [(len(t) + 1) // 2 for t in txts]
    mids_r = [len(t) - m for t, m in zip(txts, mids)]
    return pats, txts, cos, mids, mids_r


def _interleaved(pats, txts, cos, mids, mids_r, **pad):
    il = ([], [], [], [])
    for i in range(len(pats)):
        il[0].extend([pats[i], pats[i][::-1]])
        il[1].extend([txts[i], txts[i][::-1]])
        il[2].extend([int(cos[i])] * 2)
        il[3].extend([int(mids[i]), int(mids_r[i])])
    return prepare_banded_batch(il[0], il[1], il[2], full=False,
                                text_finish=il[3], **pad)


def _spec(pats, txts, cos, mids, mids_r):
    both = batch.banded_score_results(
        pats + [p[::-1] for p in pats], txts + [t[::-1] for t in txts],
        list(cos) + list(cos), text_finish=mids + mids_r, device="cpu")
    n = len(pats)
    return [myers_np.hirschberg_split_fast(
        f.pv64, f.mv64, f.first, f.last, f.scores_k,
        r.pv64, r.mv64, r.first, r.last, r.scores_k,
        f.prolog, len(pats[j]), len(txts[j]))
        for j, (f, r) in enumerate(zip(both[:n], both[n:]))]


def _port_split(b, out):
    task = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a[0::2], dtype=np.int32))
    return [x.numpy() for x in hs.hirschberg_split_torch(
        out, task(b.prolog), task(b.plen), task(b.tlen))]


def _xla_split(b, res):
    """The XLA epilogue over run_banded-style outputs of batch b."""
    return [np.asarray(x) for x in hsplit_epilogue_interleaved(
        res["scores_by_k"], res["pv_lo"], res["pv_hi"], res["mv_lo"],
        res["mv_hi"], res["first"], res["last"], b.prolog, b.plen, b.tlen,
        EBB=b.EBB)]


def _assert_splits(got, want):
    pll, sl, sr, ok = got
    for j, w in enumerate(want):
        if w is None:
            assert not ok[j], j
        else:
            assert ok[j], j
            assert (int(pll[j]), int(sl[j]), int(sr[j])) == w, j


def _assert_equal(a, b):
    """Two (pll, score_l, score_r, feasible) tuples: equal flags, equal
    values on the feasible tasks."""
    ok = np.asarray(a[3]).astype(bool)
    np.testing.assert_array_equal(ok, np.asarray(b[3]).astype(bool))
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(np.asarray(x)[ok], np.asarray(y)[ok])


@pytest.mark.parametrize("length,error,seed", [(500, 0.08, 3),
                                               (700, 0.2, 4)])
def test_torch_hsplit_parity(length, error, seed):
    tasks = _tasks(5, length, error, seed)
    want = _spec(*tasks)
    b = _interleaved(*tasks)
    out = bc.fill_staged(bc.stage_banded(b, "cpu"))
    got = _port_split(b, out)
    _assert_splits(got, want)
    _assert_equal(got, _xla_split(b, run_banded(b)))
    ebb_p2 = batch._next_pow2(max(myers_np.div_ceil(
        myers_np.band_geometry(len(p), len(t), int(c)).cutoff, W) + 1
        for p, t, c in zip(*tasks[:3])))
    nb_p2 = batch._next_pow2(max(myers_np.div_ceil(max(m, mr), W)
                                 for m, mr in zip(*tasks[3:])))
    padded = _interleaved(*tasks, pad_to_b=16, min_nb=nb_p2,
                          min_ebb=ebb_p2)
    pallas = jax_batch._hsplit_fused_pallas(padded)
    _assert_equal(got, [x[:len(want)] for x in pallas])
    fused = batch.hirschberg_level_splits_device(*tasks, device="cpu")
    assert fused == want


def test_torch_hsplit_infeasible_tasks():
    """Half-pass windows pushed apart (forward band at its top block,
    reverse at block 0): the spec returns None and every version flags
    the task infeasible through the same overlap condition."""
    tasks = _tasks(3, 900, 0.1, 3)
    b = _interleaved(*tasks)
    out = bc.fill_staged(bc.stage_banded(b, "cpu"))
    e = b.EBB
    out["first"][0] = out["last"][0] = e - 1
    out["first"][1] = out["last"][1] = 0
    got = _port_split(b, out)
    res = bc.to_host_dict(out)
    _assert_equal(got, _xla_split(b, res))
    f = lambda j: (out["pv"][:, j].numpy().view(np.uint64),  # noqa: E731
                   out["mv"][:, j].numpy().view(np.uint64),
                   int(out["first"][j]), int(out["last"][j]),
                   out["scores_by_k"][:, j].numpy())
    want = [myers_np.hirschberg_split_fast(
        *f(2 * j), *f(2 * j + 1), int(b.prolog[2 * j]), int(b.plen[2 * j]),
        int(b.tlen[2 * j])) for j in range(3)]
    assert want[0] is None
    _assert_splits(got, want)


def test_torch_hsplit_refuses_cpu_tensors():
    tasks = _tasks(2, 300, 0.1, 5)
    b = _interleaved(*tasks)
    out = bc.fill_staged(bc.stage_banded(b, "cpu"))
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hs._launch_hsplit(out, v, v, v)
    assert hs.HSPLIT.launches == 0
