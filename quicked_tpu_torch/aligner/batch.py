"""Batch-first alignment engine: the card's kernels and the host C lanes.

The counterpart of quicked_tpu/aligner/batch.py (`banded_align_batch`,
`hirschberg_level_splits_device`, `banded_score_results`, `_finish`,
`align_batch_full`, `bucket_keys`, `_lane_pad`, and the venue router:
its probes, kernel rates and decisions). Pairs are bucketed by band/text
geometry. A score batch takes the score-kernel family of the JAX
package's device route (`score_family`, from its batch.py:540-572): the
fill for shallow bands, the systolic kernel for deep ones, the carry-scan
kernel for the rest of the deep batches and for tiny ones. A full batch
takes the full fill plus the on-device traceback, or the full fill with
its band planes read back and walked by the host C runtime
(`native.traceback_banded_batch`). A Hirschberg split
level runs its score pass and the split epilogue on the card and reads
back four numbers per task.

On a card (`device="cuda"`, no mesh) the venue router decides, before
any launch, whether a batch runs there or on the host C lanes
(`ops/banded_native.py`): a score batch or split level goes to the host
when its estimated host time (block advances over the host's measured
rate for as many threads as it has pairs) undercuts the card's (dispatch
latency + its bytes over the measured link + advances over the family's
measured rate); a full chunk takes the least of three estimates
(`_full_venue`: the host C fill and traceback, the card's fill and
traceback, the card's fill with its planes read back and the host C
walk); a windowed bucket goes to the host C kernel when its estimate
wins (`prefer_host_windowed`). Every rate is probed or calibrated on
the host the process runs on and kept in the port's own probe cache
(`_probe_cache_path`). Each routed batch records its venue
(`venue_snapshot`). QUICKED_TPU_PIN_CARD=1 pins every batch to the card.
With `device="cpu"` nothing is routed: every batch runs the kernels'
plain PyTorch versions. Under a device mesh
(`ACTIVE_MESH`, set by `parallel.mesh.use_mesh`) everything stays on the
card: each chunk's lanes and each split level's tasks are sharded over
the mesh's devices, with the kernels the unmeshed run picks.

Not carried over: the cold-shape deferral (`_device_with_cold_deferral`,
which would serve batches from host C while a kernel builds, and so hide
the kernel; the port builds each kernel source once at first use), and
the JAX package's switch between the full chunk's two card lanes
(`QUICKED_TPU_DEVICE_TB`): the plane-readback lane is a third venue the
router prices, not a switch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time

import numpy as np
import torch

from quicked_tpu_torch import native
from quicked_tpu_torch._build import BUILD_DIR
from quicked_tpu_torch.aligner.hirschberg import _level_splits
from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops import myers_np
from quicked_tpu_torch.ops.banded_cscan_cuda import cscan_staged
from quicked_tpu_torch.ops.banded_cuda import (fill_staged,
                                               full_planes_to_host,
                                               stage_banded)
from quicked_tpu_torch.ops.banded_native import (run_banded_full_native,
                                                 run_banded_native)
from quicked_tpu_torch.ops.banded_sysband_cuda import sysband_staged
from quicked_tpu_torch.ops.banded_traceback_cuda import traceback_ops
from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                              prepare_banded_batch)
from quicked_tpu_torch.ops.hirschberg_split_cuda import hirschberg_split
from quicked_tpu_torch.ops.packed import (PackedSeqs, lengths, pack_pairs,
                                          subset)
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams, QuickedStatus
from quicked_tpu_torch.utils import memreport

W = 64

# Memory budget for one full-fill launch: the band snapshots are
# NB*64*EBB*16 bytes per lane (Pv and Mv, 8 bytes each).
FULL_FILL_BYTES_BUDGET = 1 << 30

# The score-kernel route's bounds, the JAX package's own
# (quicked_tpu/aligner/batch.py): the fill up to
# PALLAS_MAX_EBB band blocks; the carry-scan kernel for tiny batches of
# deep-ish bands and for the deep batches the systolic kernel does not
# take; the systolic kernel for SYSBAND_MIN_EBB..SYSBAND_MAX_EBB.
PALLAS_MAX_EBB = 128
CSCAN_MIN_EBB = 48
CSCAN_MAX_B = 32
SYSBAND_MIN_EBB = 192
SYSBAND_MAX_EBB = 16000
MIN_LANES = 8       # the JAX package's lane floor for shallow buckets

# The device mesh of `parallel.mesh.use_mesh`: while it is set, every
# score pass, full fill, split level and windowed bound the entries run
# is sharded on lanes over its devices (bit-exact with the unmeshed run).
ACTIVE_MESH = None


@dataclasses.dataclass
class BatchResult:
    """Per-pair alignment results, in input order."""

    status: list
    score: np.ndarray
    cigar: list


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def next_pow2(x) -> np.ndarray:
    """`_next_pow2` of every element of an integer array (int64; exact
    below 2^53)."""
    x = np.maximum(np.asarray(x, dtype=np.int64) - 1, 0)
    return np.left_shift(1, np.frexp(x.astype(np.float64))[1]).astype(
        np.int64)


def key_groups(*keys) -> list:
    """Group pairs by key: `keys` are equal-length int64 arrays, pair i's
    key the tuple of their i-th elements. Returns (key tuple, ascending
    int64 indices) per distinct key, in the order of each key's first
    pair (the order a dict filled pair by pair keeps)."""
    if not len(keys[0]):
        return []
    stacked = np.stack([np.asarray(k, dtype=np.int64) for k in keys])
    uniq, first, inv = np.unique(stacked, axis=1, return_index=True,
                                 return_inverse=True)
    inv = inv.reshape(-1)
    members = np.split(np.argsort(inv, kind="stable"),
                       np.cumsum(np.bincount(inv))[:-1])
    return [(tuple(int(v) for v in uniq[:, g]), members[g])
            for g in np.argsort(first, kind="stable")]


def _raw_bytes(s) -> bytes:
    if isinstance(s, np.ndarray):
        return s.tobytes()
    return s.encode("ascii", errors="replace")


def _lane_pad(n_live: int, ebb_p2: int) -> int:
    """The padded lane count the JAX package gives a score bucket
    (quicked_tpu/aligner/batch.py:_lane_pad): deep buckets take the pow2
    of their pairs, shallow ones at least MIN_LANES. The port pads no
    lanes; the count only decides the route."""
    if ebb_p2 > PALLAS_MAX_EBB:
        return _next_pow2(n_live)
    return max(_next_pow2(n_live), MIN_LANES)


def score_family(n_live: int, ebb_p2: int) -> str:
    """The score kernel for a bucket of n_live pairs whose band bucket is
    ebb_p2 blocks: "fill", "cscan" or "sysband", as the JAX package's
    device route picks them (quicked_tpu/aligner/batch.py:540-572)."""
    b_pad = _lane_pad(n_live, ebb_p2)
    deep = ebb_p2 > PALLAS_MAX_EBB or \
        (b_pad <= CSCAN_MAX_B and ebb_p2 >= CSCAN_MIN_EBB)
    if not deep:
        return "fill"
    if SYSBAND_MIN_EBB <= ebb_p2 <= SYSBAND_MAX_EBB:
        return "sysband"
    return "cscan"


def score_staged(st, family: str) -> dict:
    """Run a staged score batch through the kernel of `family`."""
    if family == "sysband":
        return sysband_staged(st)
    if family == "cscan":
        return cscan_staged(st)
    return fill_staged(st)


def active_mesh(dev: torch.device):
    """ACTIVE_MESH (or None) for an entry running on `dev`; raises
    ValueError when the mesh's devices are not of `dev`'s type."""
    mesh = ACTIVE_MESH
    if mesh is not None and mesh.devices[0].type != dev.type:
        raise ValueError(f"the active mesh's devices are "
                         f"{mesh.devices[0].type}, the entry's device is "
                         f"{dev}")
    return mesh


def score_key(geo: myers_np.BandGeometry, finish: int) -> tuple[int, int]:
    """Bucket key of a score pass over `finish` text columns: (pow2 of its
    64-column blocks, pow2 of its score band's blocks)."""
    return (_next_pow2(max(myers_np.div_ceil(int(finish), W), 1)),
            _next_pow2(myers_np.div_ceil(geo.cutoff, W) + 1))


def _bucket_key_arrays(plens, tlens, cutoffs, full: bool):
    """(pow2(NB), pow2(EBB)) of every pair as two int64 arrays, from one
    `myers_np.band_geometries` over the batch."""
    def i64(x):
        if isinstance(x, np.ndarray):
            return x.astype(np.int64)
        return np.fromiter(x, dtype=np.int64)

    tl = i64(tlens)
    geo = myers_np.band_geometries(i64(plens), tl, i64(cutoffs))
    ebb = geo.ebb if full else myers_np.div_ceil(geo.cutoff, W) + 1
    nb = np.maximum(myers_np.div_ceil(tl, W), 1)
    return next_pow2(nb), next_pow2(ebb)


def bucket_keys(plens, tlens, cutoffs, full: bool):
    """Bucket key per pair: (pow2(NB), pow2(EBB)), so pairs of like
    geometry share a launch."""
    nb, ebb = _bucket_key_arrays(plens, tlens, cutoffs, full)
    return list(zip(nb.tolist(), ebb.tolist()))


# --- the venue router ----------------------------------------------------
# Each numeric constant below was measured by chip_smoke.py's phase 9 on
# the card host "NVIDIA H100 80GB HBM3, 700.00 W"
# (`nvidia-smi --query-gpu=name,power.limit`); every other figure the
# router reads is probed or calibrated on the host it runs on.

# Fallback rates, used only when the probe cache holds no measured rate
# and first-use calibration declines (`_kernel_rate`): per usable core,
# the host C score pass and full alignment (`_calibrate_host_rate`), the
# host C windowed bound (`_calibrate_host_windowed_rate`) in block
# advances/s, and the host C walk of read-back planes
# (`_calibrate_walk_rate`) in walk steps/s (`_walk_steps`); each card
# family on its calibration batch (`_calibrate_device_rate`; "full" is
# the fill writing its planes, "traceback" the card's traceback of those
# planes to op strings in walk steps/s, "windowed" the windowed bound
# with its batch prepared and staged).
HOST_ADV_PER_S_PER_CORE = 209552623.54002115
HOST_FULL_ADV_PER_S_PER_CORE = 86617657.19836313
HOST_WINDOWED_ADV_PER_S_PER_CORE = 44302830.9521064
WALK_STEPS_PER_S_PER_CORE = 36665215.79771295
FILL_ADV_PER_S = 474432642.0590884
FULL_ADV_PER_S = 1001286665.1641207
TRACEBACK_STEPS_PER_S = 76613770.58107783
SYSBAND_ADV_PER_S = 4533423036.71788
CSCAN_ADV_PER_S = 2239341011.5385923
WINDOWED_ADV_PER_S = 56537415.93663478

# The short-read cascade model (`prefer_staged_short`), on the 1,000 x 10
# kbp slice: the host C cascade's bases/s per usable core (warm, every
# core), the staged card lane's bases/s once its dispatch and link terms
# are taken off its wall, and the host-to-device bytes per base its
# staging calls upload.
NATIVE_CASCADE_BASES_S_PER_CORE = 2539210.8895836943
STAGED_CASCADE_BASES_S = 5040472.873180071
STAGED_BYTES_PER_BASE = 27.39676237455448

FAMILIES = ("host", "host_full", "host_windowed", "walk", "fill", "full",
            "traceback", "sysband", "cscan", "windowed")
# the families measured on the host's cores: their fallbacks are per core
HOST_FAMILIES = ("host", "host_full", "host_windowed", "walk")

# QUICKED_TPU_PIN_CARD=1 pins every batch to the card: nothing is routed,
# so each entry runs the kernels it runs without a router (processes
# started from this one inherit it).
PIN_CARD_ENV = "QUICKED_TPU_PIN_CARD"

_PROBE_TTL_S = 900.0        # link conditions drift with load
# kernel rates drift only with hardware: they persist for days
_RATE_TTL_S = 7 * 86400.0
_PROBE_BYTES = 8 << 20      # the readback probe's copy
_HOST_CAL_LENGTH = 20_000
# the windowed calibrations' pairs' length, window size and overlap: the
# cascade's stage 1
_WINDOWED_CAL = (50_000, 2, 1)
_HOST_CAL_PATIENCE = 10
_HOST_CAL_MAX_RUNS = 40

_LINK_MBPS: list = []       # device-to-host MB/s, probed once
_PINNED_MBPS: list = []     # the same into page-locked memory
_DISPATCH_S: list = []      # seconds of a trivial launch, probed once
_RATES: dict = {}           # family -> block advances/s, resolved once
_CACHE_KEY: list = []

# One probe at a time: two concurrent probes would time each other's
# transfers and cache the contended numbers. Reentrant: calibration holds
# it while it reads the link and dispatch probes.
_PROBE_LOCK = threading.RLock()

# Venue observability: routed batches per venue since process start
# (consumers snapshot and diff).
VENUE_COUNTS: dict = {}
_VENUE_LOCK = threading.Lock()


def _venue(name: str) -> None:
    with _VENUE_LOCK:
        VENUE_COUNTS[name] = VENUE_COUNTS.get(name, 0) + 1


def venue_snapshot() -> dict:
    with _VENUE_LOCK:
        return dict(VENUE_COUNTS)


def routed(dev: torch.device) -> bool:
    """Whether the venue router decides for an entry running on `dev`:
    only on a card, never under a mesh (which keeps everything on its
    devices), and not while QUICKED_TPU_PIN_CARD=1 pins the card. With
    device="cpu" every batch runs the plain versions."""
    return (dev.type == "cuda" and ACTIVE_MESH is None
            and os.environ.get(PIN_CARD_ENV) != "1")


def _probe_cache_path() -> str:
    """The port's own probe cache: under QUICKED_TPU_CACHE (default the
    build directory beside the package), one file per card name and host
    CPU, so that no rate of another card or host is ever read (nor the
    JAX package's `device_probes.json`)."""
    if not _CACHE_KEY:
        card = (torch.cuda.get_device_name(torch.cuda.current_device())
                if torch.cuda.is_available() else "no card")
        _CACHE_KEY.append(hashlib.sha256(
            f"{card}|{native._host_cpu()}".encode()).hexdigest()[:16])
    d = os.environ.get("QUICKED_TPU_CACHE", BUILD_DIR)
    return os.path.join(d, f"device_probes_torch_{_CACHE_KEY[0]}.json")


def _probe_cache_get(key: str, ttl: float | None = None):
    """Cross-process probe memo, TTL-bounded."""
    try:
        with open(_probe_cache_path()) as f:
            ent = json.load(f).get(key)
        if ent and time.time() - ent["ts"] <= (ttl if ttl is not None
                                               else _PROBE_TTL_S):
            return float(ent["value"])
    except (OSError, ValueError, KeyError):
        pass
    return None


def _probe_cache_put(key: str, value: float) -> None:
    path = _probe_cache_path()
    try:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data[key] = {"value": value, "ts": time.time()}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _readback_seconds(nbytes: int) -> float:
    """Seconds of one device-to-host copy of `nbytes` from the card."""
    buf = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf.cpu()
    return time.perf_counter() - t0


def _pinned_readback_seconds(nbytes: int) -> float:
    """Seconds of one device-to-host copy of `nbytes` from the card into
    page-locked memory, as `full_planes_to_host` copies the planes."""
    buf = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(buf)
    return time.perf_counter() - t0


def _link_mbps(memo: list, key: str, seconds) -> float:
    """A link probe (MB/s), taken once: the fastest of three copies of
    _PROBE_BYTES timed by `seconds` (one copy alone read 1,629-13,192 MB/s
    across calls on the H100 host, chip_smoke phase 9)."""
    with _PROBE_LOCK:
        if not memo:
            cached = _probe_cache_get(key)
            if cached is not None:
                memo.append(cached)
                return cached
            dt = max(min(seconds(_PROBE_BYTES) for _ in range(3)), 1e-9)
            memo.append(_PROBE_BYTES / dt / 1e6)
            # a sub-1 MB/s reading is a transient outage (another
            # process's transfers), not an operating point: this process
            # honors it, the cache does not keep it
            if memo[0] >= 1.0:
                _probe_cache_put(key, memo[0])
    return memo[0]


def _device_readback_mbps() -> float:
    """Device-to-host bandwidth (MB/s) into pageable memory."""
    return _link_mbps(_LINK_MBPS, "readback_mbps", _readback_seconds)


def _planes_readback_mbps() -> float:
    """Device-to-host bandwidth (MB/s) into page-locked memory: the rate
    at which the plane-readback lane's planes cross."""
    return _link_mbps(_PINNED_MBPS, "pinned_readback_mbps",
                      _pinned_readback_seconds)


def _device_dispatch_s() -> float:
    """Seconds of one launch of a trivial CUDA op ending in
    torch.cuda.synchronize(), probed once on its second launch (the first
    pays the op's own setup)."""
    with _PROBE_LOCK:
        if not _DISPATCH_S:
            x = torch.arange(256, device="cuda")
            (x * 2).sum()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (x * 2).sum()
            torch.cuda.synchronize()
            _DISPATCH_S.append(max(time.perf_counter() - t0, 1e-6))
    return _DISPATCH_S[0]


def _fill_full_lanes() -> int:
    """Pairs at which the fill reaches its calibrated rate. The fill runs
    a warp per pair, and each of an SM's four warp schedulers issues for
    one warp a cycle: up to 4 x SMs pairs, a pass takes the time of one
    pair's column chain whatever the count, so its rate grows with the
    pairs. The fill's calibration times exactly that many (528 on the
    H100's 132 SMs, the figure taken without a card)."""
    sms = (torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
        if torch.cuda.is_available() else 132)
    return 4 * sms


def _cal_geom(family: str) -> tuple[int, int]:
    """(pairs, length) of a card family's calibration batch, at bandwidth
    15, sized so that `score_family` routes it to the family itself: a
    full set of fill lanes at 5 kbp (EBB 13); 32 pairs of 100 kbp for the
    systolic pass (EBB 236) and 32 of 40 kbp for the carry-scan pass (EBB
    96, a small deep batch), the long-read stage-3 batches' scale; for
    the full fill and the traceback, 128 pairs of 10 kbp, the 10 kbp
    slice's chunk under FULL_FILL_BYTES_BUDGET."""
    return {"fill": (_fill_full_lanes(), 5_000), "full": (128, 10_000),
            "traceback": (128, 10_000),
            "sysband": (32, 100_000), "cscan": (32, 40_000),
            "windowed": (32, _WINDOWED_CAL[0])}[family]


def _occupancy(family: str, n_live: int) -> float:
    """The share of a score family's calibrated rate a batch of n_live
    pairs reaches. Each score kernel runs a pair on a warp (the fill) or
    on a CTA or warps of its own (the deep-band kernels), so below the
    card's width a pass takes one pair's chain whatever the count, and
    its rate grows with the pairs: linearly up to the calibration batch's
    pairs (`_cal_geom`), flat past them, where nothing was measured. The
    full fill and the traceback are priced flat: their walls follow the
    columns' staging, raw frames and record expansion, not the pairs
    (phases 9 and 10 of chip_smoke measure both chunks they price)."""
    if family in ("full", "traceback"):
        return 1.0
    n_cal = _cal_geom(family)[0]
    return min(max(n_live, 1), n_cal) / n_cal


def _rate_fallback(family: str) -> float:
    if family in HOST_FAMILIES:
        return {"host": HOST_ADV_PER_S_PER_CORE,
                "host_full": HOST_FULL_ADV_PER_S_PER_CORE,
                "host_windowed": HOST_WINDOWED_ADV_PER_S_PER_CORE,
                "walk": WALK_STEPS_PER_S_PER_CORE}[family] \
            * native.usable_cores()
    return {"fill": FILL_ADV_PER_S, "full": FULL_ADV_PER_S,
            "traceback": TRACEBACK_STEPS_PER_S,
            "sysband": SYSBAND_ADV_PER_S, "cscan": CSCAN_ADV_PER_S,
            "windowed": WINDOWED_ADV_PER_S}[family]


def _cal_pairs(n: int, length: int):
    """(patterns, texts, cutoffs) of a calibration batch, bandwidth 15:
    eight pairs made from a seed and repeated to n (the kernels' time
    does not depend on which pairs repeat; making them is Python-slow)."""
    from quicked_tpu_torch import generate

    made = list(generate.generate_pairs(min(n, 8), length, error=0.1,
                                        seed=5))
    pairs = [made[i % len(made)] for i in range(n)]
    return ([p for p, _ in pairs], [t for _, t in pairs],
            [max(len(p), len(t)) * 15 // 100 for p, t in pairs])


def _cal_batch(n: int, length: int, full: bool = False):
    return prepare_banded_batch(*_cal_pairs(n, length), full=full)


def _host_calibration(run) -> float:
    """Seconds of the fastest of repeated `run()`s on every usable core
    with force_scalar off: an estimate prices the default host path, and a
    figure taken under a thread cap or in scalar mode would mis-route later
    processes for days. The first calls at a size can run several times
    slower than later ones, for tens of calls, while fresh memory is first
    touched, so the runs go on until the fastest has not improved by 5% for
    _HOST_CAL_PATIENCE runs, or _HOST_CAL_MAX_RUNS runs: the cached rate is
    the warm host's."""
    prev = native.get_force_scalar()
    native.set_force_scalar(False)
    try:
        with native.thread_budget(native.usable_cores()):
            best, still = float("inf"), 0
            for _ in range(_HOST_CAL_MAX_RUNS):
                t = _timed(run)
                if t < 0.95 * best:
                    still = 0
                else:
                    still += 1
                best = min(best, t)
                if still >= _HOST_CAL_PATIENCE:
                    break
    finally:
        native.set_force_scalar(prev)
    return max(best, 1e-9)


def _calibrate_host_rate(full: bool = False):
    """The whole host's rate of the host C score pass (`full`: the full
    alignment, fill and traceback), by `_host_calibration`. The batch
    holds four pairs a usable core, so that every thread has work, of
    _HOST_CAL_LENGTH bp, long enough that the call's fixed costs (thread
    spawn, the result scatter) stay small beside its kernels."""
    if not native.available():
        return None
    pats, txts, cos = _cal_pairs(4 * native.usable_cores(),
                                 _HOST_CAL_LENGTH)
    b = prepare_banded_batch(pats, txts, cos, full=False)
    if full:
        def run():
            run_banded_full_native(pats, txts, cos)
    else:
        def run():
            run_banded_native(b)
    return _deep_band_advances(b) / _host_calibration(run)


def _calibrate_host_windowed_rate():
    """The whole host's rate of the host C windowed bound (a pair a
    thread), in `windowed_advances`, by `_host_calibration` on four pairs
    a usable core at the `_WINDOWED_CAL` geometry."""
    from quicked_tpu_torch.aligner.cascade import _windowed_native_batch

    if not native.available():
        return None
    length, ws, ovl = _WINDOWED_CAL
    pats, txts, _ = _cal_pairs(4 * native.usable_cores(), length)
    return windowed_advances(pats, txts, ws, ovl) / _host_calibration(
        lambda: _windowed_native_batch(pats, txts, 40, ws, ovl))


def _calibrate_walk_rate():
    """The whole host's rate of the host C walk over read-back band planes
    (`native.traceback_banded_batch`, a pair a thread), in `_walk_steps`,
    by `_host_calibration`, on four pairs a usable core (at most the full
    lane's calibration chunk) of the 10 kbp slice's chunk shape
    (`_cal_geom("full")`), filled once on the card."""
    if not native.available():
        return None
    n, length = _cal_geom("full")
    pats, txts, cos = _cal_pairs(min(4 * native.usable_cores(), n), length)
    b = prepare_banded_batch(pats, txts, cos, full=True)
    planes = full_planes_to_host(
        fill_staged(stage_banded(b, resolve_device("cuda"))))
    praws = [p.encode() for p in pats]
    traws = [t.encode() for t in txts]
    prologs = [int(x) for x in b.prolog[:b.B]]
    return _walk_steps(b) / _host_calibration(
        lambda: native.traceback_banded_batch(planes, b.B, praws, traws,
                                              prologs))


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _traceback_link_bytes(batch) -> int:
    """Bytes the card's traceback moves over the link: the raw character
    frames (a byte a pattern and a text column) up, its column records (an
    int32 run and an int8 op a text column) back."""
    return batch.B * batch.NB * W * (2 + 5)


def _full_link_bytes(batch) -> int:
    """Bytes a full chunk moves over the link on the card: the staged
    score inputs up, and the traceback's (`_traceback_link_bytes`)."""
    return batch.upload_bytes() + _traceback_link_bytes(batch)


def _calibrate_device_rate(family: str):
    """Time one real batch through the family's CUDA kernels as an entry
    runs it (the batch prepared and its planes built on the host, staged,
    launched, the outputs read back; for "full" the fill writing its
    planes, its scores read back) and invert the router's own estimate
    (dispatch + link bytes + work/rate = wall) for the rate, so the rate
    is consistent with how it is consumed. Declines (None) when dispatch
    and link take more than 70% of the timed run: the kernel term would be
    noise. "traceback" times the card's traceback of one filled chunk to
    op strings (its raw frames staged, its records read back and expanded
    inside each run), in walk steps; "windowed" times the windowed bound
    at the `_WINDOWED_CAL` geometry, its batch prepared, staged and given
    its pair-major copies inside each run."""
    dev = resolve_device("cuda")
    if family == "windowed":
        return _calibrate_windowed_rate(dev)
    pats, txts, cos = _cal_pairs(*_cal_geom(family))
    full = family in ("full", "traceback")
    # sized here; each run prepares its own, as an entry's chunk does
    batch = prepare_banded_batch(pats, txts, cos, full=full)
    work = _deep_band_advances(batch)
    nbytes = batch.upload_bytes()
    if family == "traceback":
        praws = [p.encode() for p in pats]
        traws = [t.encode() for t in txts]
        out = fill_staged(stage_banded(batch, dev))
        work = _walk_steps(batch)
        nbytes = _traceback_link_bytes(batch)

        def run():
            traceback_ops(out["mat_pv"], out["mat_mv"], praws, traws,
                          batch.plen, batch.tlen, batch.prolog, batch.B)
    elif full:
        def run():
            b = prepare_banded_batch(pats, txts, cos, full=True)
            fill_staged(stage_banded(b, dev))["scores_by_k"].cpu()
    else:
        assert score_family(batch.B, _next_pow2(batch.EBB)) == family

        def run():
            b = prepare_banded_batch(pats, txts, cos, full=False)
            score_staged(stage_banded(b, dev), family)["first"].cpu()

    run()                                   # build, warm
    best = min(_timed(run) for _ in range(2))
    overhead = _device_dispatch_s() + nbytes / (_device_readback_mbps()
                                                * 1e6)
    kern = best - overhead
    if kern < 0.3 * best:
        return None
    return work / kern


def _calibrate_windowed_rate(dev):
    from quicked_tpu_torch.ops.windowed_cuda import (prepare_windowed_batch,
                                                     run_windowed_score)

    _, ws, ovl = _WINDOWED_CAL
    pats, txts, _ = _cal_pairs(*_cal_geom("windowed"))

    def run():
        run_windowed_score(prepare_windowed_batch(pats, txts, window_size=ws),
                           40, ws, ovl, device=dev)

    run()                                   # build, warm
    best = min(_timed(run) for _ in range(2))
    overhead = _device_dispatch_s() + _windowed_link_bytes(
        pats, txts, ws) / (_device_readback_mbps() * 1e6)
    kern = best - overhead
    if kern < 0.3 * best:
        return None
    return windowed_advances(pats, txts, ws, ovl) / kern


def _calibrate(family: str):
    """The first-use calibration of `family` (None: it declined)."""
    if family in ("host", "host_full"):
        return _calibrate_host_rate(full=family == "host_full")
    if family == "host_windowed":
        return _calibrate_host_windowed_rate()
    if family == "walk":
        return _calibrate_walk_rate()
    return _calibrate_device_rate(family)


def _kernel_rate(family: str) -> float:
    """The rate of a family (FAMILIES): block advances/s, or walk steps/s
    for "walk" and "traceback". Resolution order: process
    memo, probe cache (TTL 7 days), first-use calibration (persisted), the
    measured fallback constants. A calibration that raises is not
    caught."""
    if family in _RATES:
        return _RATES[family]
    with _PROBE_LOCK:
        if family in _RATES:
            return _RATES[family]
        cached = _probe_cache_get(f"adv_rate_{family}", ttl=_RATE_TTL_S)
        if cached is not None and cached > 0:
            _RATES[family] = cached
            return cached
        rate = _calibrate(family)
        if rate is not None and rate > 0:
            _probe_cache_put(f"adv_rate_{family}", float(rate))
        else:
            rate = _rate_fallback(family)
        _RATES[family] = float(rate)
    return _RATES[family]


def router_ready(dev: torch.device) -> None:
    """Resolve the probes and every kernel rate the router reads, so that
    no calibration runs inside a timed stage. Entries call it before
    their timers start; a no-op where nothing is routed."""
    if routed(dev) and native.available():
        _device_readback_mbps()
        _planes_readback_mbps()
        _device_dispatch_s()
        for family in FAMILIES:
            _kernel_rate(family)


def forget_rates() -> None:
    """Drop this process's memo of the probes and kernel rates, so that
    the next `router_ready` (or routed call) resolves them again: from
    the probe cache under QUICKED_TPU_CACHE, else by calibrating. For a
    caller that points QUICKED_TPU_CACHE at a fresh directory and wants
    the router to calibrate there, as a new process would."""
    with _PROBE_LOCK:
        for memo in (_LINK_MBPS, _PINNED_MBPS, _DISPATCH_S, _RATES):
            memo.clear()


def _live(batch) -> int:
    return (len(batch.enc_patterns) if batch.enc_patterns is not None
            else batch.B)


def _host_rate(family: str, n_pairs: int) -> float:
    """The host C rate of a family of HOST_FAMILIES at this thread's
    thread count (`native.default_threads()`, capped by a
    `thread_budget`). The score pass splits a pair over several threads
    when it has fewer pairs than threads; the full alignment, the windowed
    bound and the walk run a pair a thread, so at most n_pairs of their
    threads work."""
    cores = native.usable_cores()
    threads = min(native.default_threads(), cores)
    if family != "host":
        threads = min(threads, max(n_pairs, 1))
    return _kernel_rate(family) * threads / cores


def _deep_band_advances(batch) -> float:
    """Upper-bound block-advance count of a score batch."""
    n = _live(batch)
    ebb = batch.cutoff[:n].astype(np.int64) // W + 1
    return float(np.sum(batch.tfinish[:n].astype(np.int64) * ebb))


def _walk_steps(batch) -> float:
    """Steps of the host walk over a full batch's planes: a walk moves
    back one row or column a step, so a pair takes at most plen + tlen."""
    n = _live(batch)
    return float(np.sum(batch.plen[:n].astype(np.int64)
                        + batch.tlen[:n].astype(np.int64)))


def _plane_bytes(batch) -> int:
    """Bytes of a full batch's band planes (Pv and Mv, 8 bytes a word)."""
    return batch.NB * W * batch.EBB * batch.B * 16


def windowed_advances(patterns, texts, ws: int, ovl: int) -> float:
    """Block advances of a windowed bound over the pairs: 64 ws x ws a
    window, over the fewest windows a pair can walk. A window moves each
    cursor back by at most 64 (ws - ovl) and the walk ends when one passes
    0, so a pair walks at least ceil(min(plen, tlen) / (64 (ws - ovl)))
    windows (chip_smoke's `windowed_bound` counts them so)."""
    stride = W * max(ws - ovl, 1)
    short = np.minimum(lengths(patterns), lengths(texts))
    return float(np.sum(-(-short // stride))) * W * ws * ws


def _windowed_link_bytes(patterns, texts, ws: int) -> int:
    """Bytes a windowed bucket stages on the card (`stage_windowed`): its
    u64 PEQ words, the encoded and raw text and the raw pattern as int32
    frames of at least a window, and three int32 lane vectors."""
    cols = W * ws
    plen = int(lengths(patterns).max(initial=1))
    tlen = int(lengths(texts).max(initial=1))
    kp = max(-(-plen // W), 1)
    return len(patterns) * (kp * 5 * 8 + 2 * max(tlen, cols) * 4
                            + max(plen, cols) * 4 + 3 * 4)


def windowed_estimates(patterns, texts, ws: int, ovl: int):
    """(host C, card) estimated seconds of a windowed bucket: its advances
    over the host C rate for as many threads as it has pairs, against
    dispatch + its staged bytes over the measured link + the advances at
    the card's calibrated rate, priced flat in the pairs (the card lane's
    wall follows its batch's preparation on the host, not its kernel)."""
    adv = windowed_advances(patterns, texts, ws, ovl)
    link = _device_readback_mbps() * 1e6
    host = adv / _host_rate("host_windowed", len(patterns))
    card = (_device_dispatch_s() + _windowed_link_bytes(patterns, texts, ws)
            / link + adv / _kernel_rate("windowed"))
    return host, card


def prefer_host_windowed(patterns, texts, ws: int, ovl: int) -> bool:
    """The windowed bucket's venue: True for the host C kernel."""
    host, card = windowed_estimates(patterns, texts, ws, ovl)
    return host < card


def _score_device_est_s(batch, adv: float, kernel_adv_per_s: float) -> float:
    """Estimated wall of a score pass on the card: dispatch latency + the
    staged inputs over the measured link + kernel time."""
    link = _device_readback_mbps() * 1e6
    return (_device_dispatch_s() + batch.upload_bytes() / link
            + adv / kernel_adv_per_s)


def _full_fill_est_s(batch, adv: float) -> float:
    """Estimated wall of a full chunk's fill on the card: dispatch latency
    + its staged inputs over the measured link + the fill at the `full`
    rate. Both card venues of a full chunk start with it."""
    return (_device_dispatch_s()
            + batch.upload_bytes() / (_device_readback_mbps() * 1e6)
            + adv / (_kernel_rate("full") * _occupancy("full", _live(batch))))


def _full_device_est_s(batch, adv: float) -> float:
    """Estimated wall of a full chunk on the card's fill and traceback:
    the fill (`_full_fill_est_s`) + the traceback's link bytes over the
    measured link + its walk steps at the `traceback` rate."""
    return (_full_fill_est_s(batch, adv)
            + _traceback_link_bytes(batch) / (_device_readback_mbps() * 1e6)
            + _walk_steps(batch) / (_kernel_rate("traceback")
                                    * _occupancy("traceback", _live(batch))))


def _readback_est_s(batch, adv: float) -> float:
    """Estimated wall of a full chunk on the plane-readback lane: the fill
    (`_full_fill_est_s`) + its planes over the page-locked link
    (`_planes_readback_mbps`) + the host C walk at the `walk` rate for as
    many threads as it has pairs. It wins over `_full_device_est_s` where
    the card's traceback costs more than the planes' readback and the
    host walk."""
    return (_full_fill_est_s(batch, adv)
            + _plane_bytes(batch) / (_planes_readback_mbps() * 1e6)
            + _walk_steps(batch) / _host_rate("walk", _live(batch)))


def full_estimates(batch) -> dict:
    """Estimated seconds of a full chunk on each of its three venues."""
    adv = _deep_band_advances(batch)
    return {"full_host_c": adv / _host_rate("host_full", _live(batch)),
            "full_fill_tb": _full_device_est_s(batch, adv),
            "full_fill_readback": _readback_est_s(batch, adv)}


def _prefer_host_deep(batch, sysband: bool) -> bool:
    """Deep-band venue: True when the estimated host C time undercuts the
    card's (dispatch + staging + the systolic or carry-scan kernel at its
    rate for the batch's pairs)."""
    family = "sysband" if sysband else "cscan"
    adv = _deep_band_advances(batch)
    est_dev = _score_device_est_s(
        batch, adv, _kernel_rate(family) * _occupancy(family, _live(batch)))
    return adv / _host_rate("host", _live(batch)) < est_dev


def _prefer_host_shallow(batch, n_live: int) -> bool:
    """Shallow-band venue (the fill): its rate scales with the pairs up
    to `_fill_full_lanes()` (a warp each), so a Hirschberg level over a
    handful of pairs can lose to the host C kernel."""
    adv = _deep_band_advances(batch)
    est_dev = _score_device_est_s(
        batch, adv, _kernel_rate("fill") * _occupancy("fill", n_live))
    return adv / _host_rate("host", _live(batch)) < est_dev


def _prefer_host(batch, family: str) -> bool:
    """The score-pass venue of a batch `score_family` sends to `family`:
    True for the host C kernel."""
    if family == "fill":
        return _prefer_host_shallow(batch, batch.B)
    return _prefer_host_deep(batch, family == "sysband")


def _full_venue(batch) -> str:
    """Full-chunk venue, the least of `full_estimates`: "full_host_c"
    (the host C fill and traceback, `run_banded_full_native`, a pair a
    thread), "full_fill_tb" (the card's fill and traceback) or
    "full_fill_readback" (the card's fill, its planes read back, the host C
    walk). Every rate is calibrated on this host, and the advance and walk
    step counts are the same on each side, so their definitions cancel."""
    est = full_estimates(batch)
    return min(est, key=est.get)


def prefer_staged_short(total_bases: int) -> bool:
    """The short-read cascade's venue: True when the staged card lane's
    estimate (dispatches, its staged bytes over the measured link, its
    bases at STAGED_CASCADE_BASES_S) beats the one-call host C cascade's
    for a batch of `total_bases`."""
    link = _device_readback_mbps() * 1e6
    native_s = total_bases / (NATIVE_CASCADE_BASES_S_PER_CORE
                              * native.usable_cores())
    staged_s = (4 * _device_dispatch_s()
                + total_bases * STAGED_BYTES_PER_BASE / max(link, 1.0)
                + total_bases / STAGED_CASCADE_BASES_S)
    return staged_s < native_s


class _OpsOut:
    """The op strings of a full banded batch as its chunks deliver them:
    a list of str in input order, or (`packed`) one PackedSeqs of op
    bytes that no per-pair str is made for on the way."""

    def __init__(self, n: int, packed: bool):
        self.n, self.packed = n, packed
        self.pieces: list = []
        self.strs: list = [None] * n

    def put(self, idx, ops) -> None:
        """The ops of pairs `idx`: a list of str, or a native.LazyOpsList
        whose packed bytes are taken as they are."""
        if not self.packed:
            for j, i in enumerate(np.asarray(idx).tolist()):
                self.strs[i] = ops[j]
            return
        segs = ops.segments() if isinstance(ops, native.LazyOpsList) \
            else None
        if segs is None:
            pk = PackedSeqs.of_bytes(ops)
            segs = pk.buf, pk.off, pk.len
        self.pieces.append((idx, *segs))

    def result(self):
        if self.packed:
            return PackedSeqs.concat(self.n, self.pieces)
        return self.strs


def banded_align_batch(patterns, texts, cutoffs, *, only_score: bool,
                       device="cuda", raws=None, packed_ops: bool = False):
    """BANDED over a batch (run_banded, quicked.c:58-89, per pair).
    Returns (scores int64 array, ops list of str|None).

    patterns/texts: lists of str or pre-encoded arrays, or PackedSeqs; a
    batch that packs (`packed.pack_pairs`) is bucketed, framed and
    subset a few numpy calls per chunk, its raw characters its buffers.
    `raws`: optional (praws, traws) raw byte strings for pre-encoded
    inputs; the traceback's M test compares raw characters.
    `packed_ops` (full mode): the ops as one PackedSeqs of op bytes in
    input order, the card's chunks' bytes as the traceback packed them.

    On a card the router picks each chunk's venue before any launch,
    whichever estimate wins: a full chunk runs the card's fill and
    traceback, the card's fill with the host C walk of its read-back
    planes, or the host C fill and traceback (`_full_venue`); a score
    chunk runs its `score_family` kernel or the host C score pass
    (`_prefer_host`). The port's chunks have no lane floor, so no
    chunk's padding can exceed FULL_FILL_BYTES_BUDGET and no chunk needs
    the JAX package's too-deep host lane (batch.py:755-770); a pair whose
    planes alone exceed the budget runs as a chunk of one.

    Under a mesh each chunk's lanes are sharded (`parallel.mesh.
    banded_shards`), the score kernel decided on the chunk's whole lane
    count, and every shard's fill is launched before any is read back."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
    route = routed(dev) and native.available()
    n = len(patterns)
    pk = pack_pairs(patterns, texts)
    if pk is not None:
        patterns, texts = pk
    cutoffs = np.asarray(cutoffs, dtype=np.int64)
    scores = np.zeros(n, dtype=np.int64)
    ops_out = None if only_score else _OpsOut(n, packed_ops)

    def raws_of(sub):
        """The chunk's (praws, traws) lists of bytes."""
        if pk is not None:
            return subset(patterns, sub).raws(), subset(texts, sub).raws()
        if raws:
            return ([raws[0][i] for i in sub.tolist()],
                    [raws[1][i] for i in sub.tolist()])
        return ([_raw_bytes(patterns[i]) for i in sub.tolist()],
                [_raw_bytes(texts[i]) for i in sub.tolist()])

    groups = key_groups(*_bucket_key_arrays(
        lengths(patterns), lengths(texts), cutoffs, full=not only_score))
    for (nb_p2, ebb_p2), idxs in groups:
        chunk = len(idxs)
        if not only_score:
            per_lane = nb_p2 * W * ebb_p2 * 16
            chunk = max(FULL_FILL_BYTES_BUDGET // per_lane, 1)
        for s in range(0, len(idxs), chunk):
            sub = idxs[s:s + chunk]
            if not only_score:
                memreport.record("FullFill.Planes", per_lane * len(sub))
            pats, txts = subset(patterns, sub), subset(texts, sub)
            batch = prepare_banded_batch(pats, txts, cutoffs[sub],
                                         full=not only_score)
            family = score_family(len(sub), ebb_p2) if only_score else "fill"
            venue = family if only_score else "full_fill_tb"
            if route and only_score and _prefer_host(batch, family):
                _venue("host_c")
                scores[sub] = extract_final_scores(
                    batch, run_banded_native(batch)["scores_by_k"])
                continue
            if route and not only_score:
                venue = _full_venue(batch)
            if venue == "full_host_c":
                _venue(venue)
                if pk is not None:
                    enc_p, enc_t = pats.arrays(), txts.arrays()
                else:
                    enc_p, enc_t = pats, txts
                sc, ops = run_banded_full_native(
                    enc_p, enc_t, cutoffs[sub],
                    raws=raws_of(sub) if pk is not None or raws else None)
                scores[sub] = sc
                ops_out.put(sub, ops)
                continue
            if venue == "full_fill_readback":
                _venue(venue)
                sc, ops = _run_full_readback(batch, dev, *raws_of(sub))
                scores[sub] = sc
                ops_out.put(sub, ops)
                continue
            if mesh is None:
                _venue(venue)
                parts = [(0, batch, score_staged(stage_banded(batch, dev),
                                                 family))]
            else:
                from quicked_tpu_torch.parallel.mesh import banded_shards
                _venue("mesh_" + venue)
                parts = banded_shards(batch, mesh, family)
            # (lane offset, host batch, device outputs) per shard; lanes
            # past the chunk's pairs are the shards' padding
            for lo, part, out in parts:
                live = sub[lo:lo + part.B]
                if not len(live):
                    continue
                sc = extract_final_scores(part,
                                          out["scores_by_k"].cpu().numpy())
                scores[live] = sc[:len(live)]
                if only_score:
                    continue
                if pk is not None:
                    lanes = np.arange(lo, lo + len(live))
                    praws, traws = subset(pats, lanes), subset(txts, lanes)
                else:
                    praws, traws = raws_of(live)
                ops = traceback_ops(out["mat_pv"], out["mat_mv"], praws,
                                    traws, part.plen, part.tlen, part.prolog,
                                    len(live))
                ops_out.put(live, ops)
            del parts   # free this chunk's planes before the next one
    if only_score:
        return scores, [None] * n
    return scores, ops_out.result()


def _run_full_readback(batch, dev, praws, traws):
    """The plane-readback lane of a full chunk: the full fill on `dev`,
    its four u32 planes read back (`full_planes_to_host`), every pair
    walked by the host C runtime in one call
    (`native.traceback_banded_batch`, a pair a thread). Returns (scores,
    op strings)."""
    out = fill_staged(stage_banded(batch, dev))
    sc = extract_final_scores(batch, out["scores_by_k"].cpu().numpy())
    planes = full_planes_to_host(out)
    del out
    n = len(praws)
    ops = native.traceback_banded_batch(
        planes, batch.B, praws, traws,
        [int(x) for x in batch.prolog[:n]])
    return sc[:n], ops


@dataclasses.dataclass
class BandedScoreState:
    """Per-pair band state of a host C score pass, in the numpy form
    myers_np.hirschberg_split_fast consumes."""

    score: int
    pv64: np.ndarray        # (ebb,) uint64 band words
    mv64: np.ndarray
    first: int
    last: int
    scores_k: np.ndarray    # (K+1,) shifted-row scores
    prolog: int
    geometry: myers_np.BandGeometry


def banded_score_results(patterns, texts, cutoffs, text_finish=None):
    """Score-only banded runs through the host C score pass, returning the
    per-pair band state a host split level consumes (`_level_splits`).
    `text_finish` stops each lane at its midpoint while the band is sized
    for the full text (bpm_hirschberg.c:85-100). Buckets and padding are
    the JAX package's, so the states equal its own."""
    n = len(patterns)
    if text_finish is None:
        text_finish = [len(t) for t in texts]
    results: list = [None] * n
    by_key: dict = {}
    geos: list = [None] * n
    for i in range(n):
        geos[i] = myers_np.band_geometry(len(patterns[i]), len(texts[i]),
                                         int(cutoffs[i]))
        by_key.setdefault(score_key(geos[i], text_finish[i]), []).append(i)

    for (nb_p2, ebb_p2), idxs in by_key.items():
        batch = prepare_banded_batch(
            [patterns[i] for i in idxs], [texts[i] for i in idxs],
            [cutoffs[i] for i in idxs], full=False,
            text_finish=[text_finish[i] for i in idxs],
            pad_to_b=_lane_pad(len(idxs), ebb_p2), min_nb=nb_p2,
            min_ebb=ebb_p2)
        out = run_banded_native(batch)
        final_scores = extract_final_scores(batch, out["scores_by_k"])
        # one 64-bit reassembly + transpose for the batch; per-pair rows
        # are then contiguous views
        pv64 = np.ascontiguousarray(
            (out["pv_lo"].astype(np.uint64)
             | (out["pv_hi"].astype(np.uint64) << np.uint64(32))).T)
        mv64 = np.ascontiguousarray(
            (out["mv_lo"].astype(np.uint64)
             | (out["mv_hi"].astype(np.uint64) << np.uint64(32))).T)
        sck = np.ascontiguousarray(out["scores_by_k"].T)
        for j, i in enumerate(idxs):
            results[i] = BandedScoreState(
                score=int(final_scores[j]), pv64=pv64[j], mv64=mv64[j],
                first=int(out["first"][j]), last=int(out["last"][j]),
                scores_k=sck[j], prolog=int(batch.prolog[j]),
                geometry=geos[i])
    return results


def _hsplit_launch(batch, dev, family: str):
    """The score pass of `family` and the split epilogue over an
    interleaved forward/reverse level batch, launched on `dev`; returns
    the four per-task vectors (pll, score_l, score_r, feasible) there."""
    st = stage_banded(batch, dev)
    out = score_staged(st, family)

    def task_vec(a):
        return torch.from_numpy(np.ascontiguousarray(
            a[0::2], dtype=np.int32)).to(dev)

    return hirschberg_split(out, st.lanes["prolog"][0::2].contiguous(),
                            task_vec(batch.plen), task_vec(batch.tlen))


def _hsplit_fused(batch, dev, family: str):
    """`_hsplit_launch`, its four per-task vectors read back as numpy."""
    return [x.cpu().numpy() for x in _hsplit_launch(batch, dev, family)]


def hirschberg_level_splits_device(pats, txts, cos, mids, mids_r,
                                   device="cuda"):
    """A Hirschberg split level: the forward and reverse half passes of
    each task as lanes 2j and 2j+1 of one score batch per bucket, then the
    midpoint epilogue on the card, reading back four numbers per task
    instead of band planes (bpm_hirschberg.c:149-200's consumption, after
    the kernel). The kernels are the JAX package's: where every bucket's
    band fits the fill (PALLAS_MAX_EBB), the fill, as its fused level
    runs; where one is deeper, each bucket takes the kernel
    `score_family` routes it to (the fill, the systolic pass with its
    ABORT lanes recomputed by the carry-scan pass, or the carry-scan
    pass), as its `banded_score_results` does before its batched split.
    On a card the router may send a bucket to the host instead, when the
    host C estimate of its half passes wins (the JAX package's batch.py:
    1013-1018): its tasks then take the host C score pass
    (`banded_score_results`) and the host midpoint search
    (`hirschberg._level_splits`), bit-exact with the card's. Returns per
    task (pll, score_l, score_r), or None where the split is infeasible.
    Under a mesh each bucket's tasks are dealt over its devices
    (`parallel.mesh.run_level_splits_sharded`)."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
    route = routed(dev) and native.available()
    n = len(pats)
    by_key: dict = {}
    for i in range(n):
        geo = myers_np.band_geometry(len(pats[i]), len(txts[i]),
                                     int(cos[i]))
        by_key.setdefault(score_key(geo, max(mids[i], mids_r[i])),
                          []).append(i)
    deep = any(ebb_p2 > PALLAS_MAX_EBB for _, ebb_p2 in by_key)
    results: list = [None] * n
    for (_, ebb_p2), idxs in by_key.items():
        pats_il, txts_il, cos_il, fins_il = [], [], [], []
        for i in idxs:
            # task j -> lanes 2j (forward) and 2j+1 (reverse)
            pats_il += [pats[i], pats[i][::-1]]
            txts_il += [txts[i], txts[i][::-1]]
            cos_il += [int(cos[i])] * 2
            fins_il += [int(mids[i]), int(mids_r[i])]
        batch = prepare_banded_batch(pats_il, txts_il, cos_il, full=False,
                                     text_finish=fins_il)
        # the level's band words (pv and mv, 8 bytes each); on the card
        # they stay there and only four numbers a task come back
        memreport.record("Hirschberg.LevelPlanes", batch.EBB * batch.B * 16)
        family = score_family(2 * len(idxs), ebb_p2) if deep else "fill"
        if route and _prefer_host(batch, family):
            _venue("host_c")
            t_pats = [pats[i] for i in idxs]
            t_txts = [txts[i] for i in idxs]
            t_cos = [int(cos[i]) for i in idxs]
            both = banded_score_results(
                t_pats + [p[::-1] for p in t_pats],
                t_txts + [t[::-1] for t in t_txts], t_cos + t_cos,
                text_finish=[int(mids[i]) for i in idxs]
                + [int(mids_r[i]) for i in idxs])
            splits = _level_splits(t_pats, t_txts, both[:len(idxs)],
                                   both[len(idxs):])
            for j, i in enumerate(idxs):
                results[i] = splits[j]
            continue
        if mesh is None:
            _venue("hsplit_device")
            pll, sl, sr, ok = _hsplit_fused(batch, dev, family)
        else:
            from quicked_tpu_torch.parallel.mesh import (
                run_level_splits_sharded)
            _venue("mesh_hsplit_device")
            pll, sl, sr, ok = run_level_splits_sharded(batch, mesh, family)
        for j, i in enumerate(idxs):
            results[i] = ((int(pll[j]), int(sl[j]), int(sr[j]))
                          if ok[j] else None)
    return results


def _finish(status, score, ops, only_score):
    """extract_results semantics (quicked.c:34-56): only_score keeps the
    cigar NULL for every algorithm."""
    if int(status) < 0:
        return status, -1, None
    if only_score:
        if ops is None:
            return status, int(score), None
        return status, Cigar(operations=ops).score_edit(), None
    cig = Cigar(operations=ops or "")
    return status, cig.score_edit(), (cig.sprint(True) if ops else None)


def align_batch_full(pairs, params: QuickedParams | None = None,
                     device="cuda", timers=None) -> BatchResult:
    """Align a batch of (pattern, text) pairs; results in input order.
    `timers` (utils.profiler.PhaseTimers) collects the QUICKED cascade's
    per-stage times."""
    params = params or QuickedParams()
    dev = resolve_device(device)
    native.set_force_scalar(params.force_scalar)
    n = len(pairs)
    statuses: list = [QuickedStatus.QUICKED_OK] * n
    scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n

    live = []
    for i, (p, t) in enumerate(pairs):
        if len(p) == 0 or len(t) == 0:
            statuses[i] = QuickedStatus.QUICKED_EMPTY_SEQUENCE
        else:
            live.append(i)
    if not live:
        return BatchResult(statuses, scores, cigars)
    pats = [pairs[i][0] for i in live]
    txts = [pairs[i][1] for i in live]

    algo = params.algo
    if params.use_kernels and (algo != QuickedAlgo.WINDOWED
                               or params.only_score):
        router_ready(dev)
    if not params.use_kernels:
        # the exact numpy semantic model, per pair
        from quicked_tpu_torch.api import _align_one_np
        for i in live:
            p, t = pairs[i]
            st, s, c = _align_one_np(p, t, params)
            statuses[i], scores[i], cigars[i] = st, s, (c if c else None)
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.BANDED:
        cos = [max(len(p), len(t)) * params.bandwidth // 100
               for p, t in zip(pats, txts)]
        sc, ops = banded_align_batch(pats, txts, cos,
                                     only_score=params.only_score,
                                     device=dev)
        for j, i in enumerate(live):
            statuses[i], scores[i], cigars[i] = _finish(
                QuickedStatus.QUICKED_WIP, sc[j], ops[j], params.only_score)
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.WINDOWED:
        from quicked_tpu_torch.aligner.cascade import (windowed_full_batch,
                                                       windowed_score_batch)
        if params.only_score:
            sc, _ = windowed_score_batch(pats, txts, 0, params.window_size,
                                         params.overlap_size, device=dev)
            for j, i in enumerate(live):
                statuses[i], scores[i], cigars[i] = _finish(
                    QuickedStatus.QUICKED_WIP, sc[j], None, True)
        else:
            ops = windowed_full_batch(pats, txts, params.window_size,
                                      params.overlap_size, device=dev)
            for j, i in enumerate(live):
                statuses[i], scores[i], cigars[i] = _finish(
                    QuickedStatus.QUICKED_WIP, None, ops[j], False)
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.HIRSCHBERG:
        from quicked_tpu_torch.aligner.hirschberg import hirschberg_batch
        cos = [max(len(p), len(t)) * params.bandwidth // 100
               for p, t in zip(pats, txts)]
        res = hirschberg_batch(txts, pats, cos, device=dev)
        for j, i in enumerate(live):
            st, ops = res[j]
            if int(st) < 0:
                # extract_results still runs on failure (quicked.c:154-157)
                c = Cigar(operations=ops or "")
                statuses[i] = st
                scores[i] = c.score_edit()
                cigars[i] = (c.sprint(True)
                             if ops and not params.only_score else None)
            else:
                statuses[i], scores[i], cigars[i] = _finish(
                    st, None, ops, params.only_score)
        return BatchResult(statuses, scores, cigars)

    if algo == QuickedAlgo.QUICKED:
        from quicked_tpu_torch.aligner.cascade import quicked_cascade_batch
        res = quicked_cascade_batch([pairs[i] for i in live], params,
                                    timers=timers, device=dev)
        scores[live] = res.score
        # only_score keeps the cigar NULL (quicked.c:38-42)
        cig = [None] * len(live) if params.only_score else list(res.cigar)
        for j, (i, st) in enumerate(zip(live, res.status)):
            statuses[i] = st
            cigars[i] = cig[j]
        return BatchResult(statuses, scores, cigars)

    for i in live:
        statuses[i] = QuickedStatus.QUICKED_UNKNOWN_ALGO
    return BatchResult(statuses, scores, cigars)
