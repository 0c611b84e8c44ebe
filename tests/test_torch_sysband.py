"""Parity: the port's systolic deep-band pass
(quicked_tpu_torch.ops.banded_sysband_cuda) vs the step model
(banded_sysband_np.run_sysband_pair, ABORT flags included) and the JAX
package's Pallas kernel in interpret mode (run_banded_sysband_pallas), at
the geometries of tests/test_sysband_pallas.py, under the model's
contract: scores, first and last exact; pv/mv exact on [first, last].
Tolerance 0. Also resident windows over 1024 and 4096 rows, and the
wiring of the exact fallback: lanes flagged ABORT are recomputed by the
carry-scan pass and merged."""

import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan
from quicked_tpu.ops.banded_sysband_np import SysbandAbort, run_sysband_pair
from quicked_tpu.ops.banded_sysband_pallas import run_banded_sysband_pallas
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import banded_sysband_cuda as sb

torch.set_num_threads(1)


def _pair(length, seed, error=0.1):
    return list(generate.generate_pairs(1, length, error=error,
                                        seed=seed))[0]


def _geometry(name):
    p, t = _pair(2000, 5)
    if name == "basic":
        return prepare_banded_batch([p], [t], [300], full=False)
    if name == "inverted_and_batch":
        p2, t2 = _pair(800, 7, error=0.2)
        return prepare_banded_batch([p[:1500], p2], [t, t2], [400, 200],
                                    full=False)
    if name == "text_finish":
        return prepare_banded_batch([p], [t], [300], full=False,
                                    text_finish=[999])
    if name in ("wide_m4", "wide_m16"):
        # resident windows of 2176 and 4352 rows: the card's 4- and
        # 16-rows-per-thread instantiations
        n, cutoff = (2, 108_000) if name == "wide_m4" else (1, 250_000)
        pairs = list(generate.generate_pairs(n, 300, error=0.1, seed=3))
        return prepare_banded_batch([p for p, _ in pairs],
                                    [t for _, t in pairs], [cutoff] * n,
                                    full=False)
    p, t = _pair(25000, 11)
    return prepare_banded_batch([p], [t], [4500], full=False)


def _assert_contract(want, got, batch, lanes):
    """want/got: run_banded-style dicts (u32 planes)."""
    for j in lanes:
        np.testing.assert_array_equal(got["scores_by_k"][:, j],
                                      want["scores_by_k"][:, j])
        assert got["first"][j] == want["first"][j]
        assert got["last"][j] == want["last"][j]
        f, l = int(want["first"][j]), int(want["last"][j])
        sl = slice(max(f, 0), min(l + 1, batch.EBB))
        for k in ("pv_lo", "pv_hi", "mv_lo", "mv_hi"):
            np.testing.assert_array_equal(got[k][sl, j], want[k][sl, j])


def _check(batch):
    out, aborted = sb.banded_sysband_torch(bc.stage_banded(batch, "cpu"))
    got = bc.to_host_dict(out)
    for j in range(batch.B):
        try:
            m = run_sysband_pair(batch, j)
        except SysbandAbort:
            assert aborted[j], j
            continue
        assert not aborted[j], j
        np.testing.assert_array_equal(got["scores_by_k"][:, j],
                                      m["scores_by_k"])
        assert (got["first"][j], got["last"][j]) == (m["first"], m["last"])
        sl = slice(max(m["first"], 0), min(m["last"] + 1, batch.EBB))
        pv = out["pv"][:, j].numpy().view(np.uint64)
        mv = out["mv"][:, j].numpy().view(np.uint64)
        np.testing.assert_array_equal(pv[sl], m["pv64"][sl])
        np.testing.assert_array_equal(mv[sl], m["mv64"][sl])
    lanes = [j for j in range(batch.B) if not aborted[j]]
    _assert_contract(run_banded_sysband_pallas(batch, interpret=True), got,
                     batch, lanes)


@pytest.mark.parametrize("name", ["basic", "inverted_and_batch",
                                  "text_finish", "wide_m4", "wide_m16"])
def test_torch_sysband_parity(name):
    _check(_geometry(name))


@pytest.mark.slow
def test_torch_sysband_recenter():
    _check(_geometry("recenter"))


def test_torch_sysband_abort_fallback(monkeypatch):
    """Forced aborts: both lanes reported ABORT with corrupted results;
    sysband_staged must restore them exactly from the carry-scan pass and
    count them."""
    batch = _geometry("inverted_and_batch")
    real = sb.sysband_raw

    def corrupting(st):
        out, aborted = real(st)
        return ({k: torch.full_like(v, -1) for k, v in out.items()},
                torch.ones_like(aborted))

    monkeypatch.setattr(sb, "sysband_raw", corrupting)
    before = sb.SYSBAND.fallbacks
    got = bc.to_host_dict(sb.sysband_staged(bc.stage_banded(batch, "cpu")))
    assert sb.SYSBAND.fallbacks - before == 2
    want = run_banded_cscan(batch)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_torch_sysband_refuses_cpu_tensors():
    st = bc.stage_banded(_geometry("basic"), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sb._launch_sysband(st)
    assert sb.SYSBAND.launches == 0


@pytest.mark.parametrize("ebb", [129, 192, 256, 630, 631, 1024, 1690, 2048,
                                 3706, 3707, 4096, 7970, 8192])
def test_torch_sysband_launch_geometry(ebb):
    """Every EBB the route sends the systolic kernel (buckets 192 to 8192,
    their pairs' bands down to 129 blocks): the window as the model sizes
    it, threads and shared memory within the H100's limits and the
    instantiation's launch bound, every resident row in exactly one slot,
    a text ring that spans the window's columns."""
    geo = sb.sysband_launch(ebb)
    NS, ring = sb.geometry(ebb)
    assert (geo.NS, geo.ring) == (NS, ring)
    assert NS >= ebb + 2 + 3 * sb.RECENTER
    m, slot_bytes, max_threads = sb.WORDS[geo.words]
    assert geo.rows_per_thread == m
    assert geo.threads == -(-NS // m) <= max_threads <= 1024
    slots = sorted(t * m + s for t in range(geo.threads) for s in range(m)
                   if t * m + s < NS)
    assert slots == list(range(NS))
    assert (geo.threads - 1) * m < NS      # every thread holds a row
    assert geo.text_ring & (geo.text_ring - 1) == 0
    assert geo.text_ring >= NS + 512
    assert geo.smem_bytes == (slot_bytes * m + 8) * geo.threads + \
        geo.text_ring
    assert geo.smem_bytes + sb.STATIC_SMEM <= sb.SMEM_PER_CTA
    assert geo.words == ("registers" if NS <= 1024 else
                         "shared" if NS <= 4096 else "device")


def test_torch_sysband_launch_refuses_deeper_windows():
    with pytest.raises(ValueError, match="resident rows"):
        sb.sysband_launch(8400)


def test_torch_staged_text_pair_major():
    """The pair-major text the deep-band kernels read is the lane-minor
    text transposed, also after a lane selection."""
    st = bc.stage_banded(_geometry("inverted_and_batch"), "cpu")
    assert st.text_pm.shape == (st.B, st.NB * 64)
    assert torch.equal(st.text_pm, st.text.t())
    sel = bc.select_lanes(st, torch.tensor([1]))
    assert torch.equal(sel.text_pm, st.text_pm[1:])
    assert sel.text_pm.is_contiguous()
