"""Batch-first alignment engine on the card.

The counterpart of quicked_tpu/aligner/batch.py (`banded_align_batch`,
`hirschberg_level_splits_device`, `_finish`, `align_batch_full`,
`bucket_keys`, `_lane_pad`). Pairs are bucketed by
band/text geometry and every bucket runs through the port's kernels.
Score batches take the score-kernel family of the JAX package's device
route (`score_family`, from its batch.py:540-572): the fill for shallow
bands, the systolic kernel for deep ones, the carry-scan
kernel for the rest of the deep batches and for tiny ones. Full batches
take the full fill plus the on-device traceback. A Hirschberg split level
runs its score pass and the split epilogue on the card, whatever its
band's depth, and reads back four numbers per task. Under a device mesh
(`ACTIVE_MESH`, set by `parallel.mesh.use_mesh`) each chunk's lanes and
each split level's tasks are sharded over the mesh's devices, with the
kernels the unmeshed run picks. What the JAX package routes by venue
(host C lanes, rate probes, cold-shape deferral, the QUICKED_TPU_*
switches) is not carried over: routing is by geometry only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops import myers_np
from quicked_tpu_torch.ops.banded_cscan_cuda import cscan_staged
from quicked_tpu_torch.ops.banded_cuda import fill_staged, stage_banded
from quicked_tpu_torch.ops.banded_sysband_cuda import sysband_staged
from quicked_tpu_torch.ops.banded_traceback_cuda import traceback_ops
from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                              prepare_banded_batch)
from quicked_tpu_torch.ops.hirschberg_split_cuda import hirschberg_split
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


def bucket_keys(plens, tlens, cutoffs, full: bool):
    """Bucket key per pair: (pow2(NB), pow2(EBB)), so pairs of like
    geometry share a launch."""
    keys = []
    for pl, tl, co in zip(plens, tlens, cutoffs):
        geo = myers_np.band_geometry(int(pl), int(tl), int(co))
        ebb = geo.ebb if full else myers_np.div_ceil(geo.cutoff, W) + 1
        nb = max(myers_np.div_ceil(int(tl), W), 1)
        keys.append((_next_pow2(nb), _next_pow2(ebb)))
    return keys


def banded_align_batch(patterns, texts, cutoffs, *, only_score: bool,
                       device="cuda", raws=None):
    """BANDED over a batch (run_banded, quicked.c:58-89, per pair).
    Returns (scores int64 array, ops list of str|None).

    `raws`: optional (praws, traws) raw byte strings for pre-encoded
    inputs; the traceback's M test compares raw characters.

    Under a mesh each chunk's lanes are sharded (`parallel.mesh.
    banded_shards`), the score kernel decided on the chunk's whole lane
    count, and every shard's fill is launched before any is read back."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    ops_out: list = [None] * n
    keys = bucket_keys([len(p) for p in patterns], [len(t) for t in texts],
                       cutoffs, full=not only_score)
    by_key: dict = {}
    for i, k in enumerate(keys):
        by_key.setdefault(k, []).append(i)

    for (nb_p2, ebb_p2), idxs in by_key.items():
        chunk = len(idxs)
        if not only_score:
            per_lane = nb_p2 * W * ebb_p2 * 16
            chunk = max(FULL_FILL_BYTES_BUDGET // per_lane, 1)
        for s in range(0, len(idxs), chunk):
            sub = idxs[s:s + chunk]
            if not only_score:
                memreport.record("FullFill.Planes", per_lane * len(sub))
            batch = prepare_banded_batch(
                [patterns[i] for i in sub], [texts[i] for i in sub],
                [cutoffs[i] for i in sub], full=not only_score)
            family = score_family(len(sub), ebb_p2) if only_score else "fill"
            if mesh is None:
                parts = [(0, batch, score_staged(stage_banded(batch, dev),
                                                 family))]
            else:
                from quicked_tpu_torch.parallel.mesh import banded_shards
                parts = banded_shards(batch, mesh, family)
            # (lane offset, host batch, device outputs) per shard; lanes
            # past the chunk's pairs are the shards' padding
            for lo, part, out in parts:
                live = sub[lo:lo + part.B]
                if not live:
                    continue
                sc = extract_final_scores(part,
                                          out["scores_by_k"].cpu().numpy())
                scores[live] = sc[:len(live)]
                if only_score:
                    continue
                praws = [raws[0][i] if raws else _raw_bytes(patterns[i])
                         for i in live]
                traws = [raws[1][i] if raws else _raw_bytes(texts[i])
                         for i in live]
                ops = traceback_ops(out["mat_pv"], out["mat_mv"], praws,
                                    traws, part.plen, part.tlen, part.prolog,
                                    len(live))
                for j, i in enumerate(live):
                    ops_out[i] = ops[j]
            del parts   # free this chunk's planes before the next one
    return scores, ops_out


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
    """A Hirschberg split level on the card: the forward and reverse half
    passes of each task as lanes 2j and 2j+1 of one score batch per
    bucket, then the midpoint epilogue, reading back four numbers per task
    instead of band planes (bpm_hirschberg.c:149-200's consumption, after
    the kernel). The kernels are the JAX package's: where every bucket's
    band fits the fill (PALLAS_MAX_EBB), the fill, as its fused level
    runs; where one is deeper, each bucket takes the kernel
    `score_family` routes it to (the fill, the systolic pass with its
    ABORT lanes recomputed by the carry-scan pass, or the carry-scan
    pass), as its `banded_score_results` does before its batched split.
    Returns per task (pll, score_l, score_r), or None where the split is
    infeasible. Under a mesh each bucket's tasks are dealt over its
    devices (`parallel.mesh.run_level_splits_sharded`). The counterpart of
    the JAX package's function of the same name with `_level_splits`,
    without their venue and warm-up branches."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
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
        # the level's band words (pv and mv, 8 bytes each), which stay
        # on the card: only four numbers a task come back
        memreport.record("Hirschberg.LevelPlanes", batch.EBB * batch.B * 16)
        family = score_family(2 * len(idxs), ebb_p2) if deep else "fill"
        if mesh is None:
            pll, sl, sr, ok = _hsplit_fused(batch, dev, family)
        else:
            from quicked_tpu_torch.parallel.mesh import (
                run_level_splits_sharded)
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
        for j, i in enumerate(live):
            statuses[i] = res.status[j]
            scores[i] = res.score[j]
            # only_score keeps the cigar NULL (quicked.c:38-42)
            cigars[i] = None if params.only_score else res.cigar[j]
        return BatchResult(statuses, scores, cigars)

    for i in live:
        statuses[i] = QuickedStatus.QUICKED_UNKNOWN_ALGO
    return BatchResult(statuses, scores, cigars)
