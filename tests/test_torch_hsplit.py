"""Parity: the port's Hirschberg split epilogue
(quicked_tpu_torch.ops.hirschberg_split_cuda) and its split level
(batch.hirschberg_level_splits_device) vs the JAX package's XLA epilogue
(hirschberg_split_jax.hsplit_epilogue_interleaved, i.e.
hirschberg_split_batch), its fused Pallas level in interpret mode
(batch._hsplit_fused_pallas) and the numpy spec
(myers_np.hirschberg_split_fast), on the tasks of
tests/test_hsplit_device.py, infeasible tasks included; the epilogue on
the deep-band kernels' outputs, which are exact only on [first, last];
the words it reads; a cascade whose deep split level runs it; the launch
geometry. Tolerance 0."""

import numpy as np
import pytest
import torch

from quicked_tpu import api as jax_api
from quicked_tpu import generate, params
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.aligner import hirschberg as jax_hb
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.ops.hirschberg_split_jax import hsplit_epilogue_interleaved
from quicked_tpu.params import QuickedParams
from quicked_tpu_torch import api
from quicked_tpu_torch.aligner import batch
from quicked_tpu_torch.aligner import hirschberg as hb
from quicked_tpu_torch.ops import banded_cscan_cuda as cc
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import banded_sysband_cuda as sb
from quicked_tpu_torch.ops import hirschberg_split_cuda as hs
from quicked_tpu_torch.ops import myers_np as port_np

from .test_torch_copies import jax_warmup_inline  # noqa: F401

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
    both = jax_batch.banded_score_results(
        pats + [p[::-1] for p in pats], txts + [t[::-1] for t in txts],
        list(cos) + list(cos), text_finish=mids + mids_r)
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


def _fast(out, b):
    """port myers_np.hirschberg_split_fast per task over the words of a
    score pass's dict `out` for the interleaved batch `b`."""
    def f(j):
        return (out["pv"][:, j].numpy().view(np.uint64),
                out["mv"][:, j].numpy().view(np.uint64),
                int(out["first"][j]), int(out["last"][j]),
                out["scores_by_k"][:, j].numpy())
    return [port_np.hirschberg_split_fast(
        *f(2 * j), *f(2 * j + 1), int(b.prolog[2 * j]), int(b.plen[2 * j]),
        int(b.tlen[2 * j])) for j in range(b.B // 2)]


@pytest.mark.parametrize("length,pct,seed", [(900, 25, 3), (2000, 60, 9)])
def test_torch_hsplit_reads_only_first_to_last(length, pct, seed):
    """Every band word outside [first, last] of its lane overwritten with
    random bits: the plain epilogue and hirschberg_split_fast give the
    same (pll, score_l, score_r, feasible) as on the fill's own words, so
    the split reads no word the deep-band kernels leave unspecified."""
    pairs = list(generate.generate_pairs(4, length, error=0.1, seed=seed,
                                         indels_num=2,
                                         indels_length=length // 10))
    tasks = ([p for p, _ in pairs], [t for _, t in pairs],
             [max(len(p), len(t)) * pct // 100 for p, t in pairs],
             [(len(t) + 1) // 2 for _, t in pairs],
             [len(t) // 2 for _, t in pairs])
    b = _interleaved(*tasks)
    out = bc.fill_staged(bc.stage_banded(b, "cpu"))
    rows = torch.arange(b.EBB)[:, None]
    band = (rows >= out["first"].long()[None]) & \
        (rows <= out["last"].long()[None])
    assert not bool(band.all())
    rng = np.random.default_rng(seed)
    poisoned = dict(out)
    for k in ("pv", "mv"):
        noise = torch.from_numpy(rng.integers(-2**63, 2**63 - 1,
                                              out[k].shape, dtype=np.int64))
        poisoned[k] = torch.where(band, out[k], noise)
    want = _port_split(b, out)
    assert int(want[3].sum()) > 0
    for x, y in zip(_port_split(b, poisoned), want):
        np.testing.assert_array_equal(x, y)
    assert _fast(poisoned, b) == _fast(out, b)


@pytest.mark.parametrize("family", ["sysband", "cscan"])
def test_torch_hsplit_on_deep_band_outputs(family):
    """A deep interleaved level (3 tasks, cutoff 40%) through the plain
    systolic or carry-scan pass, then the plain epilogue: equal to the
    JAX package's batched split (hirschberg_split_batch) and to
    hirschberg_split_fast on the same words."""
    tasks = _tasks(3, 1200, 0.1, 6)
    tasks = (tasks[0], tasks[1],
             [max(len(p), len(t)) * 40 // 100
              for p, t in zip(tasks[0], tasks[1])], tasks[3], tasks[4])
    b = _interleaved(*tasks)
    st = bc.stage_banded(b, "cpu")
    if family == "sysband":
        out, aborted = sb.banded_sysband_torch(st)
        assert not bool(aborted.any())
    else:
        out = cc.banded_cscan_torch(st)
    got = _port_split(b, out)
    assert int(got[3].sum()) == 3
    _assert_equal(got, _xla_split(b, bc.to_host_dict(out)))
    _assert_splits(got, _fast(out, b))
    _assert_splits(got, _spec(*tasks))


def test_torch_deep_split_level_runs_the_epilogue(monkeypatch):
    """A cascade on the CPU, the route's bounds and the Hirschberg budget
    shrunk as in test_torch_longread: its deep split level (the systolic
    pass) and its later levels (the fill) each end in one call of
    hirschberg_split, the port never finds a midpoint on the host, and the
    results equal quicked_tpu.api.align_batch's."""
    for name, value in (("PALLAS_MAX_EBB", 8), ("CSCAN_MIN_EBB", 2),
                        ("SYSBAND_MIN_EBB", 8), ("SYSBAND_MAX_EBB", 8)):
        monkeypatch.setattr(batch, name, value)
    budget = 1 << 16
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(jax_hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(params, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(myers_np, "HIRSCHBERG_BUFFER", budget)
    assert not hasattr(hb, "_splits_np")

    calls, families = [], []
    real_split, real_level = batch.hirschberg_split, batch._hsplit_fused

    def split(out, prolog, plen, tlen):
        calls.append(families[-1])
        return real_split(out, prolog, plen, tlen)

    def level(b, dev, family):
        families.append(family)
        return real_level(b, dev, family)

    def host_split(*a, **kw):
        raise AssertionError("a midpoint searched on the host")

    monkeypatch.setattr(batch, "hirschberg_split", split)
    monkeypatch.setattr(batch, "_hsplit_fused", level)
    monkeypatch.setattr(port_np, "hirschberg_split_fast", host_split)
    monkeypatch.setattr(port_np, "hirschberg_split", host_split)
    pairs = list(generate.generate_pairs(2, 3000, error=0.1, seed=1,
                                         indels_num=4, indels_length=100))
    got = api.BatchAligner(QuickedParams(), device="cpu").align(pairs)
    assert calls == families
    assert "sysband" in calls and "fill" in calls, calls
    want = jax_api.align_batch(pairs, QuickedParams())
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)


@pytest.mark.parametrize("n,ebb", [(1, 1), (5, 31), (200, 94), (200, 244),
                                   (2, 244), (400, 128), (3000, 64),
                                   (1, 8192), (64, 16000)])
def test_torch_hsplit_launch_geometry(n, ebb):
    """Warps a task and tasks a CTA on the H100's 132 SMs: at most 8 warps
    a CTA, a power of 2 of them a task; no warp walks more than 4 chunks of
    32 words unless the task has 8; a level of at least 132 tasks spans
    the SMs."""
    wpt, tpc = hs.hsplit_launch(n, ebb, 132)
    chunks = -(-(ebb + 1) // 32)
    assert wpt in (1, 2, 4, 8) and tpc >= 1 and wpt * tpc <= hs.MAX_WARPS
    assert -(-chunks // wpt) <= 4 or wpt == hs.MAX_WARPS
    assert wpt == 1 or -(-chunks // (wpt // 2)) > 4
    if n >= 132:
        assert -(-n // tpc) >= 132
