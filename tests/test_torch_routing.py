"""The port's venue router (quicked_tpu_torch/aligner/batch.py and
cascade.py) on the CPU: the estimate math, the probe cache, the kernel
rates' resolution, the routing decisions, and the host C lanes' results
against the JAX package's on the same pairs. The router decides only for
a card, so the tests that drive a routed batch here make `batch.routed`
say yes for the CPU and fake the device probes and device rates; every
batch still runs on the CPU (the host C lanes, or the kernels' plain
versions)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from quicked_tpu import generate as jax_generate
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.aligner import cascade as jax_cascade
from quicked_tpu.aligner import hirschberg as jax_hirschberg
from quicked_tpu.ops import banded_native as jax_banded_native
from quicked_tpu.ops.batch_prep import prepare_banded_batch as jax_prepare
from quicked_tpu.params import QuickedParams as JaxParams
from quicked_tpu.utils.profiler import PhaseTimers as JaxTimers
from quicked_tpu_torch import generate, native
from quicked_tpu_torch import params as qp
from quicked_tpu_torch.aligner import batch as ab
from quicked_tpu_torch.aligner import cascade as cs
from quicked_tpu_torch.aligner import hirschberg as hb
from quicked_tpu_torch.ops import banded_native
from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
from quicked_tpu_torch.params import QuickedParams, QuickedStatus
from quicked_tpu_torch.utils import memreport
from quicked_tpu_torch.utils.profiler import PhaseTimers

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)

needs_host_c = pytest.mark.skipif(
    not native.available(), reason="no C compiler for the host C runtime")


@pytest.fixture(autouse=True)
def fresh_router(tmp_path, monkeypatch):
    """Every test starts with empty probe and rate memos and its own
    probe cache directory."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv(ab.PIN_CARD_ENV, raising=False)
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(ab, "_PINNED_MBPS", [])
    monkeypatch.setattr(ab, "_DISPATCH_S", [])
    monkeypatch.setattr(ab, "_RATES", {})


def fake_card(monkeypatch, mbps=10_000.0, dispatch=1e-4, rates=None):
    """Route CPU entries as if they ran on a card whose probes read
    `mbps` (both links) and `dispatch` and whose rates are `rates`."""
    monkeypatch.setattr(ab, "routed", lambda dev: True)
    monkeypatch.setattr(ab, "_LINK_MBPS", [mbps])
    monkeypatch.setattr(ab, "_PINNED_MBPS", [mbps])
    monkeypatch.setattr(ab, "_DISPATCH_S", [dispatch])
    monkeypatch.setattr(ab, "_RATES", dict(rates or {
        "host": 1e9, "host_full": 1e9, "host_windowed": 1e9, "walk": 1e7,
        "fill": 1e10, "full": 1e10, "traceback": 1e10, "sysband": 1e10,
        "cscan": 1e10, "windowed": 1e10}))


def no_calibration(monkeypatch):
    """Calibration declines, as it does where the timed run is noise:
    `_kernel_rate` falls back to the measured constants."""
    monkeypatch.setattr(ab, "_calibrate_host_rate", lambda full=False: None)
    monkeypatch.setattr(ab, "_calibrate_device_rate", lambda family: None)


def _batch(n=4, length=600, bw=15, seed=11):
    pairs = list(generate.generate_pairs(n, length, error=0.1, seed=seed))
    cutoffs = [max(len(p), len(t)) * bw // 100 for p, t in pairs]
    return prepare_banded_batch([p for p, _ in pairs],
                                [t for _, t in pairs], cutoffs, full=False)


def _pairs(n, length, seed, **kw):
    return list(generate.generate_pairs(n, length, error=0.1, seed=seed,
                                        **kw))


def test_torch_native_fast_max_is_budget_boundary():
    for bw in (5, 15, 50, 100):
        L = cs._native_fast_max(bw)
        assert L == jax_cascade._native_fast_max(bw)
        ebb = (L * bw // 100) // 64 + 2
        assert ebb * L * 16 <= qp.HIRSCHBERG_BUFFER_SIZE
        L1 = L + 1
        assert ((L1 * bw // 100) // 64 + 2) * L1 * 16 > \
            qp.HIRSCHBERG_BUFFER_SIZE
    assert cs._native_fast_max(5) > cs._native_fast_max(15) > \
        cs._native_fast_max(50)


def test_torch_deep_band_advances_bounds_work():
    b = _batch(n=3, length=640)
    want = sum(int(b.tfinish[i]) * (int(b.cutoff[i]) // 64 + 1)
               for i in range(3))
    assert ab._deep_band_advances(b) == float(want)
    pairs = list(generate.generate_pairs(3, 640, error=0.1, seed=11))
    jb = jax_prepare([p for p, _ in pairs], [t for _, t in pairs],
                     [max(len(p), len(t)) * 15 // 100 for p, t in pairs],
                     full=False)
    assert ab._deep_band_advances(b) == jax_batch._deep_band_advances(jb)
    assert b.upload_bytes() == jb.upload_bytes()


def test_torch_score_estimate_scales_with_link_and_dispatch(monkeypatch):
    b = _batch()
    adv = ab._deep_band_advances(b)
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.001])
    monkeypatch.setattr(ab, "_LINK_MBPS", [10_000.0])
    fast = ab._score_device_est_s(b, adv, 1e10)
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    slow = ab._score_device_est_s(b, adv, 1e10)
    np.testing.assert_allclose(slow - fast, b.upload_bytes() / 20e6
                               - b.upload_bytes() / 10e9, rtol=1e-9)
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.5])
    np.testing.assert_allclose(ab._score_device_est_s(b, adv, 1e10) - slow,
                               0.499, rtol=1e-9)


def test_torch_occupancy_is_linear_to_the_calibrated_pairs():
    """A score family's rate share grows linearly with the pairs up to its
    calibration batch's count and stays flat past it; the full fill is
    flat."""
    for family in ("fill", "sysband", "cscan"):
        n_cal = ab._cal_geom(family)[0]
        assert ab._occupancy(family, 0) == ab._occupancy(family, 1) == \
            1 / n_cal
        assert ab._occupancy(family, n_cal // 2) == (n_cal // 2) / n_cal
        assert ab._occupancy(family, n_cal) == 1.0
        assert ab._occupancy(family, 10 * n_cal) == 1.0
    assert ab._occupancy("fill", 1) == 1 / ab._fill_full_lanes()
    assert ab._occupancy("full", 1) == ab._occupancy("full", 10_000) == 1.0


def test_torch_cal_pairs_repeat_eight_made_pairs():
    pats, txts, cos = ab._cal_pairs(20, 300)
    assert len(pats) == len(txts) == len(cos) == 20
    made = list(generate.generate_pairs(8, 300, error=0.1, seed=5))
    assert [(p, t) for p, t in zip(pats, txts)] == \
        [made[i % 8] for i in range(20)]
    assert cos == [max(len(p), len(t)) * 15 // 100 for p, t in
                   zip(pats, txts)]


def test_torch_venue_decision_flips_with_link(monkeypatch):
    """A deep batch favors the card on a fast, low-latency link and the
    host C kernel through a slow, high-latency one."""
    b = _batch(n=8, length=30_000)
    fake_card(monkeypatch, rates={"host": 2e9, "fill": 1e10,
                                  "sysband": 1e10, "cscan": 1e10})
    assert not ab._prefer_host_deep(b, sysband=True)
    assert not ab._prefer_host(b, "cscan")
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.5])
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    assert ab._prefer_host_deep(b, sysband=True)
    assert ab._prefer_host(b, "cscan")


def test_torch_shallow_decision_scales_with_lanes(monkeypatch):
    """The fill's rate grows with the pairs up to `_fill_full_lanes()`:
    one pair of a level favors the host where a full set of lanes favors
    the card."""
    b = _batch(n=4, length=5_000)
    adv = ab._deep_band_advances(b)
    full = ab._fill_full_lanes()
    fill = 1e10
    # a host rate between the card's estimate at one lane and at all
    fake_card(monkeypatch, dispatch=1e-6)
    dev_one = ab._score_device_est_s(b, adv, fill / full)
    dev_all = ab._score_device_est_s(b, adv, fill)
    host = adv / ((dev_one + dev_all) / 2)
    monkeypatch.setattr(ab, "_RATES", {"host": host, "fill": fill})
    # as many threads and cores as pairs: the whole host's rate applies
    monkeypatch.setattr(native, "usable_cores", lambda: 4)
    monkeypatch.setattr(native, "default_threads", lambda: 4)
    assert ab._prefer_host_shallow(b, 1)
    assert not ab._prefer_host_shallow(b, full)
    assert not ab._prefer_host_shallow(b, 10 * full)


def test_torch_probe_cache_roundtrip(tmp_path, monkeypatch):
    path = ab._probe_cache_path()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("device_probes_torch_")
    assert ab._probe_cache_get("readback_mbps") is None
    ab._probe_cache_put("readback_mbps", 123.5)
    ab._probe_cache_put("other", 7.0)
    assert ab._probe_cache_get("readback_mbps") == 123.5
    assert ab._probe_cache_get("other") == 7.0
    with open(path) as f:
        data = json.load(f)
    data["readback_mbps"]["ts"] -= ab._PROBE_TTL_S + 1
    with open(path, "w") as f:
        json.dump(data, f)
    assert ab._probe_cache_get("readback_mbps") is None
    assert ab._probe_cache_get("readback_mbps", ttl=ab._RATE_TTL_S) == 123.5


def test_torch_probe_cache_never_reads_the_jax_file(tmp_path, monkeypatch):
    """The JAX package's cache (`device_probes.json`, a TPU host's rates)
    in the same directory is never read, and the port's file is its own."""
    jax_batch._probe_cache_put("readback_mbps", 5.0)
    jax_batch._probe_cache_put("adv_rate_host", 9.0)
    assert jax_batch._probe_cache_get("readback_mbps") == 5.0
    assert os.path.exists(tmp_path / "device_probes.json")
    assert ab._probe_cache_path() != jax_batch._probe_cache_path()
    assert ab._probe_cache_get("readback_mbps") is None
    assert ab._probe_cache_get("adv_rate_host", ttl=ab._RATE_TTL_S) is None
    no_calibration(monkeypatch)
    assert ab._kernel_rate("host") == ab._rate_fallback("host")


def test_torch_readback_probe_memo_and_outage(monkeypatch):
    """The readback probe (its copies faked: the CPU has no card) takes
    the fastest of three copies, is memoized and persisted; a sub-1 MB/s
    reading serves this process but is not persisted; a fresh process
    reads the cache instead of probing."""
    seconds = []
    monkeypatch.setattr(ab, "_readback_seconds",
                        lambda n: seconds.append(n) or 10.0)
    mbps = ab._device_readback_mbps()
    assert mbps == (8 << 20) / 10.0 / 1e6 < 1.0
    assert ab._probe_cache_get("readback_mbps") is None
    assert ab._device_readback_mbps() == mbps and len(seconds) == 3
    times = iter([0.004, 0.002, 0.003])
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(ab, "_readback_seconds", lambda n: next(times))
    assert ab._device_readback_mbps() == (8 << 20) / 0.002 / 1e6
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    monkeypatch.setattr(ab, "_readback_seconds", lambda n: 0.002)
    mbps = ab._device_readback_mbps()
    assert mbps == (8 << 20) / 0.002 / 1e6
    assert ab._probe_cache_get("readback_mbps") == mbps
    monkeypatch.setattr(ab, "_LINK_MBPS", [])
    ab._probe_cache_put("readback_mbps", 42.0)
    assert ab._device_readback_mbps() == 42.0


def test_torch_planes_readback_probe_is_its_own(monkeypatch):
    """The page-locked readback probe (its copies faked) takes the fastest
    of three copies and is memoized and persisted under its own key, apart
    from the pageable probe; the readback lane's estimate prices the
    planes at it."""
    seconds = []
    monkeypatch.setattr(ab, "_pinned_readback_seconds",
                        lambda n: seconds.append(n) or 0.0004)
    monkeypatch.setattr(ab, "_readback_seconds", lambda n: 0.002)
    mbps = ab._planes_readback_mbps()
    assert mbps == (8 << 20) / 0.0004 / 1e6 and len(seconds) == 3
    assert ab._planes_readback_mbps() == mbps and len(seconds) == 3
    assert ab._probe_cache_get("pinned_readback_mbps") == mbps
    assert ab._device_readback_mbps() == (8 << 20) / 0.002 / 1e6
    pairs = _pairs(2, 600, 41)
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [90] * 2, full=True)
    monkeypatch.setattr(ab, "_DISPATCH_S", [1e-4])
    monkeypatch.setattr(ab, "_RATES", {"full": 1e10, "walk": 1e9})
    adv = ab._deep_band_advances(b)
    with native.thread_budget(native.usable_cores()):
        np.testing.assert_allclose(
            ab._readback_est_s(b, adv) - ab._full_fill_est_s(b, adv),
            ab._plane_bytes(b) / (mbps * 1e6) + ab._walk_steps(b)
            / (1e9 * min(2, native.usable_cores()) / native.usable_cores()),
            rtol=1e-12)


def test_torch_kernel_rate_resolution_order(monkeypatch):
    """With calibration declining and an empty cache the measured
    fallback constants come back; a cached entry overrides them; the memo
    serves without reading the cache again."""
    no_calibration(monkeypatch)
    assert ab._kernel_rate("host") == \
        ab.HOST_ADV_PER_S_PER_CORE * native.usable_cores()
    assert ab._kernel_rate("host_full") == \
        ab.HOST_FULL_ADV_PER_S_PER_CORE * native.usable_cores()
    assert ab._kernel_rate("fill") == ab.FILL_ADV_PER_S
    assert ab._kernel_rate("full") == ab.FULL_ADV_PER_S
    assert ab._kernel_rate("sysband") == ab.SYSBAND_ADV_PER_S
    assert ab._kernel_rate("cscan") == ab.CSCAN_ADV_PER_S
    monkeypatch.setattr(ab, "_RATES", {})
    ab._probe_cache_put("adv_rate_host", 123.0)
    assert ab._kernel_rate("host") == 123.0
    ab._probe_cache_put("adv_rate_host", 456.0)
    assert ab._kernel_rate("host") == 123.0


def test_torch_device_calibration_persists_and_is_not_caught(monkeypatch):
    """A device family's calibration (faked: it needs a card) is persisted
    with the long TTL; one that declines gives the fallback, unpersisted;
    one that raises is not caught."""
    monkeypatch.setattr(ab, "_calibrate_device_rate", lambda f: 3.5e9)
    assert ab._kernel_rate("sysband") == 3.5e9
    assert ab._probe_cache_get("adv_rate_sysband",
                               ttl=ab._RATE_TTL_S) == 3.5e9
    monkeypatch.setattr(ab, "_calibrate_device_rate", lambda f: None)
    assert ab._kernel_rate("cscan") == ab.CSCAN_ADV_PER_S
    assert ab._probe_cache_get("adv_rate_cscan",
                               ttl=ab._RATE_TTL_S) is None

    def boom(family):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ab, "_calibrate_device_rate", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        ab._kernel_rate("fill")
    assert "fill" not in ab._RATES


@pytest.mark.parametrize("family", ["fill", "sysband", "cscan"])
def test_torch_calibration_batches_route_to_their_family(family):
    b = ab._cal_batch(*ab._cal_geom(family))
    assert ab.score_family(b.B, ab._next_pow2(b.EBB)) == family


def test_torch_fake_cache_entry_flips_both_decisions(monkeypatch):
    """A fake host-rate cache entry flips the deep and the shallow
    decision through the real `_kernel_rate` chain."""
    no_calibration(monkeypatch)
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.001])
    monkeypatch.setattr(ab, "_LINK_MBPS", [10_000.0])
    b = _batch(n=4, length=30_000)
    for rate, host in ((1e15, True), (1.0, False)):
        monkeypatch.setattr(ab, "_RATES", {})
        ab._probe_cache_put("adv_rate_host", rate)
        assert ab._prefer_host_deep(b, sysband=True) is host
        assert ab._prefer_host_shallow(b, n_live=4) is host


@needs_host_c
@pytest.mark.parametrize("family", ["host", "host_full"])
def test_torch_host_calibration_measures_and_persists(family, monkeypatch):
    """First-use host calibration times the real C kernel (the score pass,
    or the full alignment; force_scalar pinned off, every usable core)
    and persists the rate with the long TTL; the short probe TTL does not
    expire it, and a later process reads it without calibrating."""
    monkeypatch.setattr(ab, "_HOST_CAL_LENGTH", 2_000)
    native.set_force_scalar(True)
    try:
        with native.thread_budget(1):
            rate = ab._kernel_rate(family)
        assert native.get_force_scalar()
    finally:
        native.set_force_scalar(False)
    assert rate > 1e6 and rate != ab._rate_fallback(family)
    key = f"adv_rate_{family}"
    assert ab._probe_cache_get(key, ttl=ab._RATE_TTL_S) == rate
    path = ab._probe_cache_path()
    with open(path) as f:
        data = json.load(f)
    data[key]["ts"] -= ab._PROBE_TTL_S + 10
    with open(path, "w") as f:
        json.dump(data, f)
    monkeypatch.setattr(ab, "_RATES", {})

    def no(*a, **k):
        raise AssertionError("calibrated again")

    monkeypatch.setattr(ab, "_calibrate_host_rate", no)
    assert ab._kernel_rate(family) == rate


def test_torch_host_rate_scales_with_pairs_and_threads(monkeypatch):
    """The host C full alignment runs a pair a thread: a batch of fewer
    pairs than threads gets that many cores' share of the whole host's
    rate; the score pass splits pairs over threads, so it keeps every
    thread's share. A thread budget caps both."""
    monkeypatch.setattr(native, "usable_cores", lambda: 8)
    monkeypatch.setattr(ab, "_RATES", {"host": 8e9, "host_full": 4e9})
    with native.thread_budget(8):
        assert ab._host_rate("host_full", 1) == 0.5e9
        assert ab._host_rate("host_full", 3) == 1.5e9
        assert ab._host_rate("host_full", 100) == 4e9
        assert ab._host_rate("host", 1) == 8e9
    with native.thread_budget(2):
        assert ab._host_rate("host", 100) == 2e9
        assert ab._host_rate("host_full", 1) == 0.5e9


def test_torch_prefer_staged_short_flips(monkeypatch):
    fake_card(monkeypatch, mbps=10_000.0, dispatch=0.001)
    monkeypatch.setattr(ab, "NATIVE_CASCADE_BASES_S_PER_CORE", 5e6)
    monkeypatch.setattr(ab, "STAGED_CASCADE_BASES_S", 1e8)
    monkeypatch.setattr(ab, "STAGED_BYTES_PER_BASE", 10.0)
    monkeypatch.setattr(native, "usable_cores", lambda: 2)
    assert ab.prefer_staged_short(10_000_000)
    assert not ab.prefer_staged_short(10_000)      # dispatch dominates
    monkeypatch.setattr(native, "usable_cores", lambda: 64)
    assert not ab.prefer_staged_short(10_000_000)
    monkeypatch.setattr(native, "usable_cores", lambda: 2)
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    assert not ab.prefer_staged_short(10_000_000)


def test_torch_pin_card_switch_stops_routing(monkeypatch):
    """QUICKED_TPU_PIN_CARD=1 is the one pin: nothing is routed on a card,
    and `router_ready` neither probes nor calibrates."""
    card = torch.device("cuda")
    assert ab.routed(card) and not ab.routed(torch.device("cpu"))
    monkeypatch.setenv(ab.PIN_CARD_ENV, "1")
    assert not ab.routed(card)

    def no(*a, **k):
        raise AssertionError("the router was consulted")

    for name in ("_device_readback_mbps", "_planes_readback_mbps",
                 "_device_dispatch_s", "_kernel_rate"):
        monkeypatch.setattr(ab, name, no)
    ab.router_ready(card)
    pairs = _pairs(2, 200, 9)
    assert cs._native_lane(pairs, QuickedParams(), card) == []
    monkeypatch.setenv(ab.PIN_CARD_ENV, "0")
    assert ab.routed(card)


def test_torch_router_never_consulted_on_cpu(monkeypatch):
    """With device="cpu" no probe, rate or decision runs and no batch
    takes a host C lane."""
    def no(*a, **k):
        raise AssertionError("the router was consulted")

    for name in ("_device_readback_mbps", "_planes_readback_mbps",
                 "_device_dispatch_s", "_kernel_rate", "_prefer_host",
                 "_full_venue", "prefer_host_windowed",
                 "prefer_staged_short"):
        monkeypatch.setattr(ab, name, no)
    monkeypatch.setattr(native, "quicked_batch", no)
    monkeypatch.setattr(ab, "run_banded_native", no)
    monkeypatch.setattr(ab, "run_banded_full_native", no)
    from quicked_tpu_torch import api
    pairs = _pairs(3, 300, 2, indels_num=2, indels_length=40)
    before = ab.venue_snapshot()
    res = api.align_batch(pairs, QuickedParams(), device="cpu")
    assert all(st == QuickedStatus.QUICKED_WIP for st in res.status)
    after = ab.venue_snapshot()
    assert after.get("host_c", 0) == before.get("host_c", 0)
    assert after.get("cascade_native", 0) == before.get("cascade_native", 0)


@needs_host_c
def test_torch_native_lane_matches_jax():
    """`_cascade_with_native_lane` over the same pairs in both packages:
    every status, score and CIGAR."""
    pairs = (_pairs(6, 500, 3, indels_num=2, indels_length=60)
             + _pairs(4, 300, 4) + [("ACGT", "ACGT")])
    fast = list(range(len(pairs)))
    got = cs._cascade_with_native_lane(pairs, QuickedParams(),
                                       PhaseTimers(), fast, device="cpu")
    want = jax_cascade._cascade_with_native_lane(pairs, JaxParams(),
                                                 JaxTimers(), fast)
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)


@needs_host_c
def test_torch_native_lane_defers_over_budget_pairs(monkeypatch):
    """A pair over the (shrunk) base-case budget comes back from the host
    C cascade with its bound and finishes in the port's Hirschberg driver
    on the CPU, booked under `align`; both packages agree."""
    import quicked_tpu.aligner.hirschberg as jax_hb
    import quicked_tpu.params as jax_params

    budget = 64_000
    monkeypatch.setattr(qp, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(jax_params, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(jax_hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    pairs = _pairs(2, 2_000, 5, indels_num=2, indels_length=100) + \
        _pairs(2, 400, 6)
    st, _, _ = native.quicked_batch(
        [p for p, _ in pairs], [t for _, t in pairs], bandwidth=15,
        window_size=9, overlap_size=1, hew_threshold=(40, 40),
        hew_percentage=(15, 15), budget=budget)
    assert list(st[:2]) == [1, 1] and not st[2:].any()
    timers = PhaseTimers()
    fast = list(range(len(pairs)))
    got = cs._cascade_with_native_lane(pairs, QuickedParams(), timers,
                                       fast, device="cpu")
    want = jax_cascade._cascade_with_native_lane(pairs, JaxParams(),
                                                 JaxTimers(), fast)
    assert timers.align.count.samples == 1
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)
    assert all(s == QuickedStatus.QUICKED_WIP for s in got.status)


@needs_host_c
def test_torch_mixed_batch_takes_both_lanes(monkeypatch):
    """A routed batch with a small fast-lane ceiling: the short pairs take
    the host C cascade, the long ones the staged lane and the port's
    Hirschberg driver on the CPU; one `total` lap for the call, every
    result equal to the unrouted run's."""
    from quicked_tpu_torch import api

    pairs = _pairs(3, 200, 7) + _pairs(2, 900, 8, indels_num=2,
                                       indels_length=120)
    want = api.align_batch(pairs, QuickedParams(), device="cpu")
    fake_card(monkeypatch)
    monkeypatch.setattr(cs, "_native_fast_max", lambda bandwidth: 400)
    monkeypatch.setattr(ab, "prefer_staged_short", lambda bases: False)
    before = ab.venue_snapshot()
    timers = PhaseTimers()
    got = cs.quicked_cascade_batch(pairs, QuickedParams(), timers=timers,
                                   device="cpu")
    after = ab.venue_snapshot()
    assert timers.total.count.samples == 1
    assert after.get("cascade_native", 0) - \
        before.get("cascade_native", 0) == 1
    assert sum(after.values()) - sum(before.values()) > 1
    assert all(s == QuickedStatus.QUICKED_WIP for s in got.status)
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)


@needs_host_c
def test_torch_staged_short_estimate_takes_the_staged_lane(monkeypatch):
    fake_card(monkeypatch)
    monkeypatch.setattr(ab, "prefer_staged_short", lambda bases: True)
    monkeypatch.setattr(native, "quicked_batch", None)
    pairs = _pairs(3, 200, 9)
    before = ab.venue_snapshot()
    cs.quicked_cascade_batch(pairs, QuickedParams(), device="cpu")
    after = ab.venue_snapshot()
    assert after.get("cascade_staged_shortreads", 0) - \
        before.get("cascade_staged_shortreads", 0) == 1
    assert after.get("cascade_native", 0) == before.get("cascade_native", 0)


@needs_host_c
def test_torch_run_banded_full_native_matches_jax():
    pairs = _pairs(5, 600, 10, indels_num=2, indels_length=50)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    got = banded_native.run_banded_full_native(pats, txts, cos)
    want = jax_banded_native.run_banded_full_native(pats, txts, cos)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@needs_host_c
def test_torch_host_split_level_matches_jax():
    """The restored `banded_score_results` (host C) and `_level_splits`
    against the JAX package's on the same tasks: every band state field
    and every midpoint."""
    pairs = _pairs(6, 1_200, 12, indels_num=2, indels_length=80)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    mids = [(len(t) + 1) // 2 for t in txts]
    mids_r = [len(t) - m for t, m in zip(txts, mids)]
    args = (pats + [p[::-1] for p in pats], txts + [t[::-1] for t in txts],
            cos + cos)
    got = ab.banded_score_results(*args, text_finish=mids + mids_r)
    want = jax_batch.banded_score_results(*args, text_finish=mids + mids_r)
    for g, w in zip(got, want):
        for f in ("score", "first", "last", "prolog"):
            assert getattr(g, f) == getattr(w, f), f
        for f in ("pv64", "mv64", "scores_k"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
        assert dataclasses.astuple(g.geometry) == \
            dataclasses.astuple(w.geometry)
    n = len(pairs)
    split = [(i, (), txts[i], pats[i], cos[i]) for i in range(n)]
    assert hb._level_splits(pats, txts, got[:n], got[n:]) == \
        jax_hirschberg._level_splits(split, want[:n], want[n:])


@needs_host_c
def test_torch_levels_bit_exact_across_venues(monkeypatch):
    """A Hirschberg run whose first split level takes the host C lane and
    whose later levels take the card path's kernels (their plain versions
    here) equals the unrouted run, and the JAX package's."""
    pairs = _pairs(3, 3_000, 13, indels_num=2, indels_length=200)
    txts = [t for _, t in pairs]
    pats = [p for p, _ in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    monkeypatch.setattr(qp, "HIRSCHBERG_BUFFER_SIZE", 80_000)
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", 80_000)
    want = hb.hirschberg_batch(txts, pats, cos, device="cpu")
    fake_card(monkeypatch)
    monkeypatch.setattr(ab, "_full_venue", lambda batch: "full_fill_tb")
    calls = []

    def first_level_on_host(batch, family):
        calls.append(family)
        return len(calls) == 1

    monkeypatch.setattr(ab, "_prefer_host", first_level_on_host)
    before = ab.venue_snapshot()
    got = hb.hirschberg_batch(txts, pats, cos, device="cpu")
    after = ab.venue_snapshot()
    assert len(calls) > 1
    assert after.get("host_c", 0) - before.get("host_c", 0) == 1
    assert after.get("hsplit_device", 0) > before.get("hsplit_device", 0)
    assert got == want


@needs_host_c
def test_torch_banded_score_host_lane(monkeypatch):
    """BANDED score-only batches the router sends to the host C pass give
    the card path's scores."""
    pairs = _pairs(4, 700, 14) + _pairs(2, 300, 15)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    want, _ = ab.banded_align_batch(pats, txts, cos, only_score=True,
                                    device="cpu")
    fake_card(monkeypatch, rates={"host": 1e30, "fill": 1.0,
                                  "sysband": 1.0, "cscan": 1.0})
    before = ab.venue_snapshot()
    got, _ = ab.banded_align_batch(pats, txts, cos, only_score=True,
                                   device="cpu")
    after = ab.venue_snapshot()
    assert after.get("host_c", 0) - before.get("host_c", 0) == 2
    np.testing.assert_array_equal(got, want)


def test_torch_full_estimate_scales_with_link(monkeypatch):
    """The card's full-chunk estimate: the link term moves with the
    probe, over the chunk's staged inputs, raw frames and records; the
    fill's and the traceback's terms (advances at the `full` rate, walk
    steps at the `traceback` rate) are priced flat in the chunk's
    pairs."""
    pairs = _pairs(4, 600, 18)
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [90] * 4, full=True)
    cols = b.NB * 64
    assert ab._full_link_bytes(b) == b.upload_bytes() + b.B * cols * 7
    adv = ab._deep_band_advances(b)
    fake_card(monkeypatch, mbps=10_000.0, dispatch=0.001)
    fast = ab._full_device_est_s(b, adv)
    np.testing.assert_allclose(
        fast, 0.001 + ab._full_link_bytes(b) / 10e9 + adv / 1e10
        + ab._walk_steps(b) / 1e10, rtol=1e-12)
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    np.testing.assert_allclose(
        ab._full_device_est_s(b, adv) - fast,
        ab._full_link_bytes(b) / 20e6 - ab._full_link_bytes(b) / 10e9,
        rtol=1e-9)


@needs_host_c
def test_torch_full_fill_venue_follows_estimate(monkeypatch):
    """Full chunks take the host C fill and traceback when its estimate
    wins and the card path (its plain versions here) when the card's
    does; the scores and CIGARs are equal either way."""
    pairs = _pairs(3, 500, 16, indels_num=1, indels_length=40)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    want = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                 device="cpu")
    for host_full, venue in ((1e30, "full_host_c"), (1.0, "full_fill_tb")):
        fake_card(monkeypatch, rates={"host_full": host_full, "full": 1e10,
                                      "traceback": 1e10, "walk": 1.0})
        before = ab.venue_snapshot()
        got = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                    device="cpu")
        after = ab.venue_snapshot()
        assert after.get(venue, 0) - before.get(venue, 0) >= 1, venue
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@needs_host_c
def test_torch_force_scalar_changes_the_path_not_the_output():
    """params.force_scalar switches the host C banded kernels to the
    scalar path (no vector passes) and changes no result."""
    pairs = _pairs(4, 2_000, 17, indels_num=2, indels_length=150)
    fast = list(range(len(pairs)))
    out, passes = [], []
    for scalar in (False, True):
        native.set_force_scalar(scalar)
        before = native.simd_pass_count()
        out.append(cs._cascade_with_native_lane(
            pairs, QuickedParams(force_scalar=scalar), PhaseTimers(), fast,
            device="cpu"))
        passes.append(native.simd_pass_count() - before)
    native.set_force_scalar(False)
    assert passes[0] > 0 and passes[1] == 0
    assert list(out[0].score) == list(out[1].score)
    assert list(out[0].cigar) == list(out[1].cigar)


def test_torch_jax_generate_matches_for_routing_inputs():
    """The routing tests' inputs come from the port's generator, the same
    pairs as the JAX package's."""
    assert _pairs(3, 200, 7) == list(jax_generate.generate_pairs(
        3, 200, error=0.1, seed=7))


# --- the windowed bound's host C lane and the plane-readback lane --------


def test_torch_windowed_advances_and_link_bytes():
    """The windowed estimates' work and bytes: 64 ws x ws advances over
    the fewest windows each pair walks, and exactly the bytes
    `stage_windowed` puts on the device for the bucket."""
    from quicked_tpu_torch.ops import windowed_cuda as wc

    pairs = _pairs(3, 700, 30, indels_num=1, indels_length=90) + \
        [("ACGT" * 10, "ACGTT" * 9)]
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    for ws, ovl in ((2, 1), (9, 1), (17, 3)):
        stride = 64 * (ws - ovl)
        want = sum(-(-min(len(p), len(t)) // stride) for p, t in pairs)
        assert ab.windowed_advances(pats, txts, ws, ovl) == \
            want * 64 * ws * ws
        st = wc.stage_windowed(wc.prepare_windowed_batch(
            pats, txts, window_size=ws), "cpu")
        staged = sum(x.numel() * x.element_size() for x in (
            st.peq, st.text_enc, st.text_raw, st.pat_raw, st.plen, st.tlen,
            st.num_words))
        assert ab._windowed_link_bytes(pats, txts, ws) == staged


def test_torch_windowed_estimates_scale(monkeypatch):
    """The card's windowed estimate moves with the link and the dispatch
    probe and is flat in the pairs' count; the host's grows with the
    threads the bucket's pairs can use, a pair a thread."""
    pairs = _pairs(4, 2_000, 31)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    adv = ab.windowed_advances(pats, txts, 2, 1)
    nbytes = ab._windowed_link_bytes(pats, txts, 2)
    fake_card(monkeypatch, mbps=10_000.0, dispatch=0.001,
              rates={"host_windowed": 8e9, "windowed": 1e9})
    monkeypatch.setattr(native, "usable_cores", lambda: 8)
    with native.thread_budget(8):
        host, card = ab.windowed_estimates(pats, txts, 2, 1)
        np.testing.assert_allclose(host, adv / 4e9, rtol=1e-12)
        np.testing.assert_allclose(
            card, 0.001 + nbytes / 10e9 + adv / 1e9, rtol=1e-12)
        host1, _ = ab.windowed_estimates(pats[:1], txts[:1], 2, 1)
        np.testing.assert_allclose(
            host1, ab.windowed_advances(pats[:1], txts[:1], 2, 1) / 1e9,
            rtol=1e-12)
    monkeypatch.setattr(ab, "_LINK_MBPS", [20.0])
    monkeypatch.setattr(ab, "_DISPATCH_S", [0.5])
    _, slow = ab.windowed_estimates(pats, txts, 2, 1)
    np.testing.assert_allclose(slow - card, 0.499 + nbytes / 20e6
                               - nbytes / 10e9, rtol=1e-9)


@needs_host_c
@pytest.mark.parametrize("ws,ovl", [(2, 1), (9, 1)])
def test_torch_windowed_venue_flips_with_rates(ws, ovl, monkeypatch):
    """Each windowed bucket (one of them over the JAX package's 8,192 bp
    mark) takes the host C kernel when its rate wins and the card's kernel
    (its plain version here) when the card's does; scores and HEW counts
    equal the JAX package's `windowed_score_batch` either way."""
    pairs = _pairs(3, 600, 32, indels_num=1, indels_length=60) + \
        _pairs(2, 8_300, 33)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    assert max(map(len, pats + txts)) > 8_192
    want = jax_cascade.windowed_score_batch(pats, txts, 40, ws, ovl)
    for host, venue in ((1e30, "windowed_host_c"), (1.0, "windowed")):
        fake_card(monkeypatch, rates={"host_windowed": host,
                                      "windowed": 1e10})
        before = ab.venue_snapshot()
        got = cs.windowed_score_batch(pats, txts, 40, ws, ovl, device="cpu")
        after = ab.venue_snapshot()
        assert after.get(venue, 0) - before.get(venue, 0) == 2, venue
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@needs_host_c
def test_torch_wide_windows_stay_on_the_card(monkeypatch):
    """A bucket with window_size > 16 (beyond the host C kernel) runs the
    card's kernel without consulting the router, equal to the JAX
    package's."""
    pairs = _pairs(2, 1_100, 34, indels_num=1, indels_length=50)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    fake_card(monkeypatch, rates={"host_windowed": 1e30, "windowed": 1.0})

    def no(*a, **k):
        raise AssertionError("the router was consulted")

    monkeypatch.setattr(ab, "prefer_host_windowed", no)
    before = ab.venue_snapshot()
    got = cs.windowed_score_batch(pats, txts, 40, 17, 1, device="cpu")
    after = ab.venue_snapshot()
    assert after.get("windowed", 0) - before.get("windowed", 0) == 1
    want = jax_cascade.windowed_score_batch(pats, txts, 40, 17, 1)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_torch_readback_estimate_terms(monkeypatch):
    """The plane-readback lane's estimate: the card's fill (dispatch + staged
    inputs over the link + advances at the `full` rate), then the planes
    over the link + the host walk at the `walk` rate for as many threads as
    pairs; the card's lane has the same fill, then the traceback's bytes
    over the link + its walk steps at the `traceback` rate; `_full_venue`
    takes the least of the three estimates."""
    pairs = _pairs(4, 600, 35)
    b = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             [90] * 4, full=True)
    adv = ab._deep_band_advances(b)
    fake_card(monkeypatch, mbps=10_000.0, dispatch=0.001,
              rates={"host_full": 8e9, "full": 1e10, "traceback": 2e8,
                     "walk": 8e8})
    monkeypatch.setattr(native, "usable_cores", lambda: 8)
    planes = b.NB * 64 * b.EBB * b.B * 16
    steps = sum(len(p) + len(t) for p, t in pairs)
    assert ab._plane_bytes(b) == planes and ab._walk_steps(b) == steps
    assert ab._traceback_link_bytes(b) == b.B * b.NB * 64 * 7
    fill = 0.001 + b.upload_bytes() / 10e9 + adv / 1e10
    with native.thread_budget(8):
        est = ab.full_estimates(b)
        np.testing.assert_allclose(est["full_fill_readback"], fill
                                   + planes / 10e9 + steps / 4e8,
                                   rtol=1e-12)
        np.testing.assert_allclose(est["full_host_c"], adv / 4e9,
                                   rtol=1e-12)
        np.testing.assert_allclose(est["full_fill_tb"], fill
                                   + b.B * b.NB * 64 * 7 / 10e9
                                   + steps / 2e8, rtol=1e-12)
        assert ab._full_venue(b) == min(est, key=est.get)


@needs_host_c
@pytest.mark.parametrize("venue,rates", [
    ("full_host_c", {"host_full": 1e30, "traceback": 1e10, "walk": 1e12}),
    ("full_fill_tb", {"host_full": 1.0, "traceback": 1e10, "walk": 1.0}),
    ("full_fill_readback", {"host_full": 1.0, "traceback": 1.0,
                            "walk": 1e12})])
def test_torch_full_venue_follows_the_rates(venue, rates, monkeypatch):
    """Each of the three full-chunk venues wins on its own estimate with
    the rates faked (the readback lane where the card's traceback is the
    cost); the scores and CIGARs equal the unrouted run's, and
    FullFill.Planes is recorded once per full chunk, whichever venue runs
    it, with the chunk's plane bytes."""
    pairs = _pairs(3, 500, 40, indels_num=1, indels_length=40)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    want = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                 device="cpu")
    fake_card(monkeypatch, rates=dict(rates, full=1e10))
    memreport.reset()
    before = ab.venue_snapshot()
    got = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                device="cpu")
    after = ab.venue_snapshot()
    rec = memreport.memory_report()["recorded"]["FullFill.Planes"]
    memreport.reset()
    keys = ab.bucket_keys(map(len, pats), map(len, txts), cos, full=True)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {venue: len(set(keys))}
    assert rec["count"] == len(set(keys))
    assert rec["bytes"] == sum(nb * 64 * ebb * 16 for nb, ebb in keys)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@needs_host_c
def test_torch_full_chunk_three_way_choice(monkeypatch):
    """A full chunk runs on the venue with the least estimate, each of the
    three in turn; the scores and CIGARs are equal on all three and to the
    unrouted run's (the plain versions on the CPU)."""
    pairs = _pairs(3, 500, 36, indels_num=1, indels_length=40)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    want = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                 device="cpu")
    fake_card(monkeypatch)
    venues = ("full_host_c", "full_fill_tb", "full_fill_readback")
    for venue in venues:
        monkeypatch.setattr(ab, "full_estimates", lambda batch, v=venue: {
            k: (1.0 if k == v else 2.0) for k in venues})
        before = ab.venue_snapshot()
        got = ab.banded_align_batch(pats, txts, cos, only_score=False,
                                    device="cpu")
        after = ab.venue_snapshot()
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == {venue: 1}
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_torch_pin_keeps_the_new_venues_on_the_card(monkeypatch):
    """QUICKED_TPU_PIN_CARD=1 gives `windowed` and `full_fill_tb` without
    consulting the router (the CPU stands in for the card: `routed`
    keeps its rule but for the device's type)."""
    monkeypatch.setattr(
        ab, "routed", lambda dev: os.environ.get(ab.PIN_CARD_ENV) != "1")
    monkeypatch.setenv(ab.PIN_CARD_ENV, "1")

    def no(*a, **k):
        raise AssertionError("the router was consulted")

    for name in ("prefer_host_windowed", "windowed_estimates",
                 "_full_venue", "full_estimates"):
        monkeypatch.setattr(ab, name, no)
    pairs = _pairs(2, 300, 37)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    before = ab.venue_snapshot()
    cs.windowed_score_batch(pats, txts, 40, 2, 1, device="cpu")
    ab.banded_align_batch(pats, txts, [45, 45], only_score=False,
                          device="cpu")
    after = ab.venue_snapshot()
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {"windowed": 1,
                                                 "full_fill_tb": 1}


def test_torch_cpu_device_takes_no_new_venue(monkeypatch):
    """With device="cpu" WINDOWED score-only and BANDED with CIGARs through
    the API take the card venues (the plain versions) and never consult
    the router."""
    from quicked_tpu_torch import api
    from quicked_tpu_torch.params import QuickedAlgo

    def no(*a, **k):
        raise AssertionError("the router was consulted")

    for name in ("prefer_host_windowed", "windowed_estimates",
                 "_full_venue", "full_estimates", "_kernel_rate"):
        monkeypatch.setattr(ab, name, no)
    monkeypatch.setattr(cs, "_windowed_native_batch", no)
    pairs = _pairs(2, 300, 38)
    before = ab.venue_snapshot()
    api.align_batch(pairs, QuickedParams(algo=QuickedAlgo.WINDOWED,
                                         only_score=True), device="cpu")
    api.align_batch(pairs, QuickedParams(algo=QuickedAlgo.BANDED),
                    device="cpu")
    after = ab.venue_snapshot()
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {"windowed": 1,
                                                 "full_fill_tb": 1}


@needs_host_c
def test_torch_new_families_resolve_like_the_others(monkeypatch):
    """`host_windowed`, `walk`, `traceback` and `windowed` resolve as
    every family does: the calibration when it measures (persisted), the
    fallback constant (host families per usable core) when it declines;
    `router_ready` resolves every family of FAMILIES."""
    monkeypatch.setattr(ab, "_calibrate_host_windowed_rate", lambda: 5e8)
    monkeypatch.setattr(ab, "_calibrate_walk_rate", lambda: None)
    monkeypatch.setattr(ab, "_calibrate_device_rate",
                        lambda family: 3e7 if family == "windowed" else None)
    monkeypatch.setattr(ab, "_calibrate_host_rate", lambda full=False: None)
    assert ab._kernel_rate("host_windowed") == 5e8
    assert ab._probe_cache_get("adv_rate_host_windowed",
                               ttl=ab._RATE_TTL_S) == 5e8
    assert ab._kernel_rate("walk") == \
        ab.WALK_STEPS_PER_S_PER_CORE * native.usable_cores()
    assert ab._kernel_rate("windowed") == 3e7
    assert ab._kernel_rate("traceback") == ab.TRACEBACK_STEPS_PER_S
    assert set(ab.HOST_FAMILIES) < set(ab.FAMILIES)
    monkeypatch.setattr(ab, "routed", lambda dev: True)
    monkeypatch.setattr(ab, "_LINK_MBPS", [1e4])
    monkeypatch.setattr(ab, "_PINNED_MBPS", [4e4])
    monkeypatch.setattr(ab, "_DISPATCH_S", [1e-4])
    ab.router_ready(torch.device("cpu"))
    assert set(ab._RATES) == set(ab.FAMILIES)


@needs_host_c
def test_torch_host_windowed_calibration_measures(monkeypatch):
    """The host C windowed calibration times the real kernel (shrunk
    geometry) on every usable core and persists a measured rate."""
    monkeypatch.setattr(ab, "_WINDOWED_CAL", (3_000, 2, 1))
    with native.thread_budget(1):
        rate = ab._kernel_rate("host_windowed")
    assert rate > 1e6 and rate != ab._rate_fallback("host_windowed")
    assert ab._probe_cache_get("adv_rate_host_windowed",
                               ttl=ab._RATE_TTL_S) == rate


def test_torch_windowed_score_entry_resolves_rates_first(monkeypatch):
    """WINDOWED score-only resolves the router's rates before it aligns
    (its buckets are routed); WINDOWED with CIGARs, card-only, does
    not."""
    from quicked_tpu_torch import api
    from quicked_tpu_torch.params import QuickedAlgo

    calls = []
    monkeypatch.setattr(ab, "router_ready", lambda dev: calls.append(dev))
    pairs = _pairs(2, 200, 39)
    api.align_batch(pairs, QuickedParams(algo=QuickedAlgo.WINDOWED,
                                         only_score=True), device="cpu")
    assert len(calls) == 1
    api.align_batch(pairs, QuickedParams(algo=QuickedAlgo.WINDOWED),
                    device="cpu")
    assert len(calls) == 1
