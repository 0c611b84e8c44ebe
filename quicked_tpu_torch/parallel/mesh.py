"""Data-parallel execution over a list of devices.

The counterpart of quicked_tpu/parallel/mesh.py. Pairs are lanes of the
batched kernels and lanes are independent, so a batch is cut into
contiguous lane slices, one per device of the mesh: each slice is staged
on its device and run there by the same kernel, every slice is launched
before any is read back, and the results are joined in lane order,
bit-exact with one device. A mesh may name a device more than once (a
few shards on one card, or on the CPU for the tests); the shards of one
card then run in turn on its stream.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from quicked_tpu_torch.aligner import batch as ab
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops.banded_cuda import stage_banded, to_host_dict
from quicked_tpu_torch.ops.batch_prep import BandedBatch
from quicked_tpu_torch.ops.windowed_cuda import (WindowedBatch,
                                                 hew_cell_threshold,
                                                 stage_windowed,
                                                 windowed_score_staged)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D data mesh: the devices the lane shards run on, in order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A mesh over `devices` (any list of "cuda:i" or "cpu", repeats
    allowed; "cuda" means the current card), or by default over every
    card, cuda:0 .. cuda:device_count()-1, which raises without a card: a
    mesh never falls back to the CPU. `n_devices` keeps the first n."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    if n_devices is not None:
        if not 0 < n_devices <= len(devs):
            raise ValueError(f"n_devices {n_devices}: the mesh has "
                             f"{len(devs)} devices")
        devs = devs[:n_devices]
    if not devs or len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh needs devices of one type, got {devs}")
    return DeviceMesh(tuple(devs))


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Run the full pipeline sharded over `mesh`: every batched kernel
    call the entries make inside the context (windowed bounds, banded
    score passes, Hirschberg split levels, full fills and their
    tracebacks) runs on lane shards over its devices, bit-exact with one
    device. The windowed full mode runs on the mesh's first device."""
    prev = ab.ACTIVE_MESH
    ab.ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        ab.ACTIVE_MESH = prev


def shard_lanes(batch: BandedBatch, n_shards: int) -> BandedBatch:
    """Pad the lane axis so it divides evenly across shards. The padded
    batch is an internal execution artifact (run_banded_sharded strips
    the pad from its outputs); its host-side sequence lists keep their
    original length."""
    B = batch.B
    rem = B % n_shards
    if rem == 0:
        return batch
    pad = n_shards - rem

    def pad_last(a, fill=0):
        widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
        return np.pad(a, widths, constant_values=fill)

    return dataclasses.replace(
        batch, B=B + pad,
        peq_lo=pad_last(batch.peq_lo), peq_hi=pad_last(batch.peq_hi),
        lm_lo=pad_last(batch.lm_lo), lm_hi=pad_last(batch.lm_hi),
        text=pad_last(batch.text), init_scores=pad_last(batch.init_scores),
        cutoff=pad_last(batch.cutoff, 65), prolog=pad_last(batch.prolog),
        nbr=pad_last(batch.nbr, 1), finish_v=pad_last(batch.finish_v),
        tfinish=pad_last(batch.tfinish),
        first0=pad_last(batch.first0, batch.EBB - 1),
        last0=pad_last(batch.last0), plen=pad_last(batch.plen, 1),
        tlen=pad_last(batch.tlen, 1))


def lane_runs(count: int, n: int) -> list[tuple[int, int]]:
    """`count` items dealt to n shards in contiguous runs [lo, hi), the
    first count % n runs one longer (some empty when count < n)."""
    q, r = divmod(count, n)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(n)])
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


def _slice_banded(batch: BandedBatch, lo: int, hi: int) -> BandedBatch:
    """Lanes [lo, hi) of a batch, its geometry (EBB, NB) unchanged."""
    lanes = {f: getattr(batch, f)[..., lo:hi] for f in (
        "peq_lo", "peq_hi", "lm_lo", "lm_hi", "text", "init_scores",
        "cutoff", "prolog", "nbr", "finish_v", "tfinish", "first0", "last0",
        "plen", "tlen")}
    return dataclasses.replace(
        batch, B=hi - lo, plane_builder=None,
        enc_patterns=None if batch.enc_patterns is None
        else batch.enc_patterns[lo:hi],
        enc_texts=None if batch.enc_texts is None
        else batch.enc_texts[lo:hi], **lanes)


def banded_shards(batch: BandedBatch, mesh: DeviceMesh,
                  family: str = "fill") -> list:
    """The banded kernel of `family` ("fill", "cscan" or "sysband"; full
    batches take the fill) over the lanes of `batch`, padded by
    `shard_lanes` and cut into one contiguous slice per device of the
    mesh, each staged and launched on its device before any is read back.
    Returns (lane offset, host batch of the slice, device outputs) per
    shard; the pad lanes sit at the end of the last shards."""
    padded = shard_lanes(batch, mesh.size)
    parts = []
    for dev, (lo, hi) in zip(mesh.devices, lane_runs(padded.B, mesh.size)):
        part = _slice_banded(padded, lo, hi)
        parts.append((lo, part, ab.score_staged(stage_banded(part, dev),
                                                family)))
    return parts


def run_banded_sharded(batch: BandedBatch, mesh: DeviceMesh | None = None,
                       family: str = "fill") -> dict:
    """Execute the banded kernel with lanes sharded over the mesh.

    Returns the dict of host arrays of `banded_cuda.to_host_dict` (the
    JAX package's `run_banded` dict), identical to the one-device run
    (bit-exact: lanes are independent; the lane padding added for
    divisibility is stripped from the outputs)."""
    mesh = mesh or make_mesh()
    outs = [to_host_dict(out) for _, _, out in
            banded_shards(batch, mesh, family)]
    return {k: np.concatenate([o[k] for o in outs], axis=-1)[..., :batch.B]
            for k in outs[0]}


def run_level_splits_sharded(batch: BandedBatch,
                             mesh: DeviceMesh | None = None,
                             family: str = "fill"):
    """One Hirschberg split level, sharded: `batch` is the level's forward
    and reverse half passes interleaved (task j on lanes 2j and 2j+1).
    The tasks are dealt to the devices in contiguous runs, so both halves
    of a task stay on one device, and each shard runs the score pass of
    `family` and the split epilogue there (`aligner.batch._hsplit_launch`),
    so only four numbers a task leave the devices. Returns (pll, score_l,
    score_r, feasible) numpy arrays per task."""
    mesh = mesh or make_mesh()
    if batch.B % 2:
        raise ValueError(f"an interleaved level batch has an even lane "
                         f"count, got {batch.B}")
    launched = [ab._hsplit_launch(_slice_banded(batch, 2 * lo, 2 * hi), dev,
                                  family)
                for dev, (lo, hi) in zip(mesh.devices,
                                         lane_runs(batch.B // 2, mesh.size))
                if hi > lo]
    return [np.concatenate([res[i].cpu().numpy() for res in launched])
            for i in range(4)]


def _slice_windowed(batch: WindowedBatch, lo: int, hi: int) -> WindowedBatch:
    """Lanes [lo, hi) of a windowed batch, its frames' heights unchanged."""
    return dataclasses.replace(batch, B=hi - lo, **{
        f: getattr(batch, f)[..., lo:hi] for f in (
            "peq_lo", "peq_hi", "text_enc", "text_raw", "pat_raw", "plen",
            "tlen", "num_words")})


def run_windowed_sharded(batch: WindowedBatch, hew_threshold: int,
                         window_size: int, overlap_size: int,
                         mesh: DeviceMesh | None = None):
    """Execute the score-only windowed kernel with lanes sharded over the
    mesh in contiguous runs. Returns (score, hew) numpy arrays (bit-exact
    with one device)."""
    mesh = mesh or make_mesh()
    cells = hew_cell_threshold(window_size, overlap_size, hew_threshold)
    launched = [windowed_score_staged(
        stage_windowed(_slice_windowed(batch, lo, hi), dev), window_size,
        overlap_size, cells)
        for dev, (lo, hi) in zip(mesh.devices,
                                 lane_runs(batch.B, mesh.size)) if hi > lo]
    return tuple(np.concatenate([res[i].cpu().numpy() for res in launched])
                 for i in range(2))
