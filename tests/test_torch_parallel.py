"""The port's lane-sharded mesh (quicked_tpu_torch.parallel) on the CPU:
every sharded run against the port's one-device run, bit for bit, and
against the JAX package's sharded run on its 8 virtual CPU devices
(quicked_tpu.parallel.mesh) on the same seeded inputs. The port's mesh is
eight CPU shards, `make_mesh(devices=["cpu"] * 8)`, which run the
kernels' plain versions; every output is an integer, so the tolerance is
0. Mirrors tests/test_parallel.py, with the checks the port adds: no
mesh without a card unless asked for the CPU, the entry's device and the
mesh's of one type, the kernels' launches on their tensors' card."""

import contextlib

import numpy as np
import pytest
import torch

from quicked_tpu.aligner import hirschberg as jax_hb
from quicked_tpu.aligner.cascade import quicked_cascade_batch as jax_cascade
from quicked_tpu.ops import batch_prep as jax_prep
from quicked_tpu.ops import windowed_jax
from quicked_tpu.parallel import mesh as jax_mesh
from quicked_tpu.params import QuickedParams as JaxParams
from quicked_tpu_torch import _build, api, generate
from quicked_tpu_torch.aligner import batch, cascade
from quicked_tpu_torch.aligner import hirschberg as hb
from quicked_tpu_torch.ops import banded_cscan_cuda as cc
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import banded_sysband_cuda as sb
from quicked_tpu_torch.ops import banded_traceback_cuda as btc
from quicked_tpu_torch.ops import hirschberg_split_cuda as hs
from quicked_tpu_torch.ops import windowed_cuda as wc
from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
from quicked_tpu_torch.parallel import dryrun, mesh
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

from .test_torch_banded import _model_planes
from .test_torch_copies import jax_warmup_inline  # noqa: F401
from .test_torch_hsplit import _interleaved, _tasks

torch.set_num_threads(1)

MATS = ("mat_pv_lo", "mat_pv_hi", "mat_mv_lo", "mat_mv_hi")


def _pairs(n, length, error, seed):
    return list(generate.generate_pairs(n, length, error=error, seed=seed))


def _cpu_mesh(n=8):
    return mesh.make_mesh(devices=["cpu"] * n)


def _banded(pairs, pct, prep=prepare_banded_batch, **kw):
    return prep([p for p, _ in pairs], [t for _, t in pairs],
                [max(len(p), len(t)) * pct // 100 for p, t in pairs], **kw)


def _one_device(b):
    return bc.to_host_dict(bc.run_banded_cuda(b, device="cpu"))


def _assert_dicts(want, got, names=None):
    for k in names or want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_torch_banded_sharded_equals_single():
    pairs = _pairs(16, 200, 0.1, 1)
    b = _banded(pairs, 40, full=False, pad_to_b=16)
    sharded = mesh.run_banded_sharded(b, _cpu_mesh())
    _assert_dicts(_one_device(b), sharded)
    jb = _banded(pairs, 40, prep=jax_prep.prepare_banded_batch, full=False,
                 pad_to_b=16)
    _assert_dicts(jax_mesh.run_banded_sharded(jb, jax_mesh.make_mesh(8)),
                  sharded)


def test_torch_banded_sharded_non_divisible_lanes():
    # B=10 on 8 shards: shard_lanes pads to 16 internally, and the
    # outputs come back stripped to the caller's lane count, bit-exact
    pairs = _pairs(10, 180, 0.1, 3)
    b = _banded(pairs, 40, full=False)
    assert mesh.shard_lanes(b, 8).B == 16
    sharded = mesh.run_banded_sharded(b, _cpu_mesh())
    _assert_dicts(_one_device(b), sharded)
    jb = _banded(pairs, 40, prep=jax_prep.prepare_banded_batch, full=False)
    _assert_dicts(jax_mesh.run_banded_sharded(jb, jax_mesh.make_mesh(8)),
                  sharded)


def test_torch_windowed_sharded_equals_single():
    pairs = _pairs(16, 250, 0.12, 2)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    b = wc.prepare_windowed_batch(pats, txts, window_size=2, pad_to_b=16)
    s1, h1 = wc.run_windowed_score(b, 40, 2, 1, device="cpu")
    s2, h2 = mesh.run_windowed_sharded(b, 40, 2, 1, _cpu_mesh())
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(h1, h2)
    jb = windowed_jax.prepare_windowed_batch(pats, txts, window_size=2,
                                             pad_to_b=16)
    s3, h3 = jax_mesh.run_windowed_sharded(jb, 40, 2, 1,
                                           jax_mesh.make_mesh(8))
    np.testing.assert_array_equal(s3, s2)
    np.testing.assert_array_equal(h3, h2)
    # uneven contiguous runs (16 lanes on 3 shards: 6, 5, 5)
    s4, h4 = mesh.run_windowed_sharded(b, 40, 2, 1, _cpu_mesh(3))
    np.testing.assert_array_equal(s1, s4)
    np.testing.assert_array_equal(h1, h4)


def test_torch_entry_single_device():
    """entry() is the staged score fill; it computes the JAX package's
    entry step on the same example batch."""
    import jax

    import __graft_entry__ as ge

    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert "scores_by_k" in out
    jfn, jargs = ge.entry()
    want = jax.jit(jfn)(*jargs)
    _assert_dicts({k: np.asarray(v) for k, v in want.items()},
                  bc.to_host_dict(out))


def test_torch_dryrun_multichip():
    dryrun.dryrun_multichip(8, device="cpu")


def test_torch_full_fill_sharded_equals_single():
    # full=True: the traceback band planes (mat_*) shard on lanes too;
    # against the JAX package inside each column's live band only, where
    # its XLA scan keeps stale words outside it and the port zero
    pairs = _pairs(10, 150, 0.1, 7)
    b = _banded(pairs, 30, full=True)
    sharded = mesh.run_banded_sharded(b, _cpu_mesh())
    assert "mat_pv_lo" in sharded
    _assert_dicts(_one_device(b), sharded)
    jb = _banded(pairs, 30, prep=jax_prep.prepare_banded_batch, full=True)
    jout = jax_mesh.run_banded_sharded(jb, jax_mesh.make_mesh(8))
    _assert_dicts(jout, sharded, [k for k in jout if k not in MATS])
    cutoffs = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    _, _, live = _model_planes(b, pairs, cutoffs)
    assert live.any()
    for k in MATS:
        np.testing.assert_array_equal(np.where(live, jout[k], 0),
                                      np.where(live, sharded[k], 0),
                                      err_msg=k)


@contextlib.contextmanager
def _spy(module, name, calls):
    """Count the calls of module.name in calls[name]."""
    real = getattr(module, name)

    def spy(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return real(*a, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def test_torch_cascade_under_mesh_bit_exact():
    """The full cascade (windowed bounds, banded scores, full fills and
    tracebacks) runs sharded inside use_mesh and returns what one device
    returns and what the JAX package's cascade under its mesh returns;
    the sharded runners were called (in place of the JAX package's venue
    counters) and the context is restored. Three shards here (uneven
    lanes, pad lanes in the full fills); the dry run holds the cascade
    on eight."""
    pairs = (_pairs(6, 300, 0.08, 11) + _pairs(5, 900, 0.15, 12)
             + _pairs(3, 150, 0.02, 13))
    base = cascade.quicked_cascade_batch(pairs, QuickedParams(),
                                         device="cpu")
    calls = {}
    with _spy(mesh, "banded_shards", calls), \
            _spy(mesh, "run_windowed_sharded", calls), \
            mesh.use_mesh(_cpu_mesh(3)):
        meshed = cascade.quicked_cascade_batch(pairs, QuickedParams(),
                                               device="cpu")
    assert batch.ACTIVE_MESH is None
    assert calls.get("banded_shards", 0) > 0, calls
    assert calls.get("run_windowed_sharded", 0) > 0, calls
    assert [int(s) for s in base.status] == [int(s) for s in meshed.status]
    np.testing.assert_array_equal(base.score, meshed.score)
    assert base.cigar == meshed.cigar
    with jax_mesh.use_mesh(jax_mesh.make_mesh(8)):
        want = jax_cascade(pairs, JaxParams())
    assert [int(s) for s in want.status] == [int(s) for s in meshed.status]
    np.testing.assert_array_equal(want.score, meshed.score)
    assert want.cigar == meshed.cigar


def test_torch_hirschberg_under_mesh_bit_exact(monkeypatch):
    """The Hirschberg driver's split levels and base cases both run
    sharded under use_mesh. A shrunken budget forces real split levels on
    small pairs."""
    pairs = _pairs(5, 700, 0.12, 17)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", 1 << 14)
    monkeypatch.setattr(jax_hb, "HIRSCHBERG_BUFFER_SIZE", 1 << 14)
    base = hb.hirschberg_batch(txts, pats, cutoffs, device="cpu")
    calls = {}
    with _spy(mesh, "run_level_splits_sharded", calls), \
            mesh.use_mesh(_cpu_mesh()):
        meshed = hb.hirschberg_batch(txts, pats, cutoffs, device="cpu")
    assert calls.get("run_level_splits_sharded", 0) > 0, calls
    assert base == meshed
    assert any(ops for _, ops in base)     # real alignments came back
    with jax_mesh.use_mesh(jax_mesh.make_mesh(8)):
        want = jax_hb.hirschberg_batch(txts, pats, cutoffs)
    assert [(int(s), o) for s, o in want] == [(int(s), o)
                                              for s, o in meshed]


def test_torch_long_read_windowed_under_mesh():
    """The JAX package keeps long-read windowed buckets (past 4096 bp:
    its 8192 bucket) on its host walk under a mesh; the port has no host
    walk and shards them like any bucket (two pairs, two shards). The
    bound and HEW count equal one device's and the JAX package's under
    its mesh."""
    pairs = _pairs(2, 4400, 0.05, 5)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    assert min(max(len(p), len(t)) for p, t in pairs) > 4096
    base = cascade.windowed_score_batch(pats, txts, 40, 3, 1, device="cpu")
    calls = {}
    with _spy(mesh, "run_windowed_sharded", calls), \
            mesh.use_mesh(_cpu_mesh(2)):
        meshed = cascade.windowed_score_batch(pats, txts, 40, 3, 1,
                                              device="cpu")
    assert calls.get("run_windowed_sharded") == 1, calls
    from quicked_tpu.aligner import cascade as jax_cascade_mod
    with jax_mesh.use_mesh(jax_mesh.make_mesh(8)):
        want = jax_cascade_mod.windowed_score_batch(pats, txts, 40, 3, 1)
    for x, y, z in zip(base, meshed, want):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(z, y)


def test_torch_split_level_sharded_uneven_runs():
    """One split level of 5 tasks on 3 shards (task runs 2, 2, 1) and on
    8 (three empty): equal to the one-device level bit for bit, and to
    the JAX package's sharded level on the feasible tasks."""
    tasks = _tasks(5, 500, 0.08, 3)
    b = _interleaved(*tasks)
    want = batch._hsplit_fused(b, torch.device("cpu"), "fill")
    assert mesh.lane_runs(5, 3) == [(0, 2), (2, 4), (4, 5)]
    for n in (3, 8):
        got = mesh.run_level_splits_sharded(b, _cpu_mesh(n))
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)
    ebb_p2 = batch._next_pow2(b.EBB)
    jb = jax_prep.prepare_banded_batch(
        [x for p in tasks[0] for x in (p, p[::-1])],
        [x for t in tasks[1] for x in (t, t[::-1])],
        [int(c) for c in tasks[2] for _ in range(2)], full=False,
        text_finish=[m for pair in zip(tasks[3], tasks[4]) for m in pair],
        pad_to_b=16, min_ebb=ebb_p2)
    jout = jax_mesh.run_level_splits_sharded(jb, jax_mesh.make_mesh(8))
    ok = np.asarray(got[3]).astype(bool)
    assert ok.any()
    np.testing.assert_array_equal(ok, np.asarray(jout[3][:5]).astype(bool))
    for x, y in zip(jout[:3], got[:3]):
        np.testing.assert_array_equal(np.asarray(x)[:5][ok],
                                      np.asarray(y)[ok])


def test_torch_sharded_route_and_pad_lanes(monkeypatch):
    """BANDED score-only with the route's bounds shrunk so that the
    chunk (5 pairs, 4 band blocks) goes to the systolic kernel's plain
    version, on 3 shards (5 lanes padded to 6): every shard takes the
    chunk's family, not its own lane count's, no lane aborts (the
    padding lane included: `fallbacks` counts every aborted lane), and
    the scores equal one device's."""
    consts = dict(PALLAS_MAX_EBB=2, CSCAN_MIN_EBB=2, SYSBAND_MIN_EBB=4,
                  SYSBAND_MAX_EBB=4)
    for name, value in consts.items():
        monkeypatch.setattr(batch, name, value)
    pairs = list(generate.generate_pairs(5, 600, error=0.1, seed=4,
                                         indels_num=2, indels_length=40))
    prm = QuickedParams(algo=QuickedAlgo.BANDED, only_score=True,
                        bandwidth=15)
    taken = []
    real_score = batch.score_staged

    def score_staged(st, fam):
        taken.append((fam, st.B))
        return real_score(st, fam)

    monkeypatch.setattr(batch, "score_staged", score_staged)
    monkeypatch.setattr(sb.SYSBAND, "fallbacks", 0)
    base = api.align_batch(pairs, prm, device="cpu")
    assert taken == [("sysband", 5)]
    with mesh.use_mesh(_cpu_mesh(3)):
        meshed = api.align_batch(pairs, prm, device="cpu")
    assert taken[1:] == [("sysband", 2)] * 3, taken
    assert sb.SYSBAND.fallbacks == 0
    assert list(base.score) == list(meshed.score)


def test_torch_use_mesh_restores_active_mesh():
    m3, m8 = _cpu_mesh(3), _cpu_mesh()
    assert batch.ACTIVE_MESH is None
    with mesh.use_mesh(m8):
        assert batch.ACTIVE_MESH is m8
        with pytest.raises(KeyError):
            with mesh.use_mesh(m3):
                assert batch.ACTIVE_MESH is m3
                raise KeyError("inner")
        assert batch.ACTIVE_MESH is m8
    assert batch.ACTIVE_MESH is None
    assert m8.size == 8 and m8.devices == (torch.device("cpu"),) * 8


def test_torch_make_mesh_needs_a_card(monkeypatch):
    """make_mesh() takes every card and raises without one, never
    falling back to the CPU; a CPU mesh is made only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh(devices=["cuda:0"] * 3)
    with pytest.raises(ValueError):
        mesh.make_mesh(9, devices=["cpu"] * 8)
    assert mesh.make_mesh(2, devices=["cpu"] * 8).size == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for devices in ([], ["cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="one type"):
            mesh.make_mesh(devices=devices)


def test_torch_mesh_and_entry_device_must_match(monkeypatch):
    """An entry on "cuda" under a CPU mesh raises ValueError before it
    stages anything (a card is faked present, so that the device itself
    resolves), and so does every entry that shards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    pats, txts = ["ACGTACGT"] * 2, ["ACGTTCGT"] * 2
    with mesh.use_mesh(_cpu_mesh(2)):
        with pytest.raises(ValueError, match="mesh"):
            batch.banded_align_batch(pats, txts, [65, 65], only_score=True,
                                     device="cuda")
        with pytest.raises(ValueError, match="mesh"):
            batch.hirschberg_level_splits_device(pats, txts, [65, 65],
                                                 [4, 4], [4, 4],
                                                 device="cuda")
        with pytest.raises(ValueError, match="mesh"):
            cascade.windowed_score_batch(pats, txts, 40, 2, 1,
                                         device="cuda")
        with pytest.raises(ValueError, match="mesh"):
            cascade.windowed_full_batch(pats, txts, 2, 1, device="cuda")
        with pytest.raises(ValueError, match="mesh"):
            api.align_batch(list(zip(pats, txts)), device="cuda")


def test_torch_windowed_full_under_mesh_on_first_device(monkeypatch):
    """The windowed full mode does not shard: under a mesh it runs once
    per bucket on the mesh's first device, with the one-device result."""
    pairs = _pairs(6, 300, 0.1, 21)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    base = cascade.windowed_full_batch(pats, txts, 2, 1, device="cpu")
    devices = []
    real = cascade.run_windowed_full

    def spy(b, ws, ovl, device):
        devices.append(device)
        return real(b, ws, ovl, device=device)

    monkeypatch.setattr(cascade, "run_windowed_full", spy)
    with mesh.use_mesh(_cpu_mesh(3)):
        assert cascade.windowed_full_batch(pats, txts, 2, 1,
                                           device="cpu") == base
    assert devices == [torch.device("cpu")]


def test_torch_launch_runs_under_its_tensors_device(monkeypatch):
    """Kernel.launch calls its C entry inside a torch.cuda.device guard
    of the card it is given, with that card's stream; and every launch
    wrapper gives it the device of its tensors (faked here: the checks
    and the card's properties are patched so that CPU tensors pass)."""
    guard, calls = [], []

    @contextlib.contextmanager
    def device_guard(dev):
        guard.append(dev)
        yield
        guard.pop()

    monkeypatch.setattr(torch.cuda, "device", device_guard)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: f"stream of {dev}")
    k = _build.Kernel("qtt_test", [])
    k._fn = lambda *a: calls.append((list(guard), a)) or 0
    k.launch(torch.device("cuda:1"), 7, 8)
    assert calls == [([torch.device("cuda:1")], (7, 8,
                                                  "stream of cuda:1"))]
    assert k.launches == 1 and guard == []

    # each wrapper passes its tensors' device
    seen = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, dev, *a: seen.append((self.symbol,
                                                           dev)))
    for mod in (bc, btc, hs, wc):
        monkeypatch.setattr(mod, "check_cuda", lambda *t: None)

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    monkeypatch.setattr(wc, "max_shared_bytes", lambda index: 231_168)
    pairs = _pairs(2, 200, 0.1, 9)
    cpu = torch.device("cpu")
    st = bc.stage_banded(_banded(pairs, 30, full=False), cpu)
    bc._launch_fill(st)
    cc._launch_cscan(st)
    sb._launch_sysband(st)
    full = bc.banded_scan_torch(bc.stage_banded(_banded(pairs, 30,
                                                        full=True), cpu))
    T = full["mat_pv"].shape[0]
    frame = torch.zeros((T, 2), dtype=torch.uint8)
    lane = torch.full((2,), 1, dtype=torch.int32)
    btc._launch_traceback(full["mat_pv"], full["mat_mv"], frame, frame,
                          lane, lane, lane)
    out = bc.banded_scan_torch(st)
    hs._launch_hsplit(out, lane[:1], lane[:1], lane[:1])
    stw = wc.stage_windowed(wc.prepare_windowed_batch(
        [p for p, _ in pairs], [t for _, t in pairs], window_size=2), cpu)
    wc._launch_windowed(stw, 2, 1, 0)
    wc._launch_windowed_full(stw, 2, 1)
    assert sorted(s for s, _ in seen) == sorted(
        k.symbol for k in (bc.FILL, cc.CSCAN, sb.SYSBAND, btc.TRACEBACK,
                           hs.HSPLIT, wc.WINDOWED, wc.WINDOWED_FULL))
    assert all(dev == cpu for _, dev in seen), seen

