"""Batched QuickEd bound-and-align cascade on the card.

The counterpart of quicked_tpu/aligner/cascade.py (`windowed_score_batch`,
`windowed_full_batch`, `quicked_cascade_batch`, `_cascade_staged`,
`CascadeResult`): the staged
lane, where the batch is re-partitioned between stages and every stage
runs through the port's kernels (run_quicked, quicked.c:163-306):

  stage 1: windowed bound, ws=2 ovl=1                  (quicked.c:184-199)
  stage 2: windowed bound, ws/ovl of the params, on the
           pair and the reversed pair                  (quicked.c:204-235)
  stage 3: banded score with the telescoping retry     (quicked.c:237-276)
  stage 4: Hirschberg under the proven bound           (quicked.c:290)

On a card, `quicked_cascade_batch` routes as the JAX package does
(cascade.py:300-440): the pairs no longer than `_native_fast_max` take the
one-call host C cascade (`native.quicked_batch`, all four stages in C,
threads inside) unless the staged card lane's estimate beats it
(`batch.prefer_staged_short`, from the probes and the three cascade
rates measured on the card host); longer pairs take the staged lane; a
host C pair whose stage-4 band is over the Hirschberg budget comes back
with its proven bound and finishes in the port's `hirschberg_batch` on
the card. In the staged lane each windowed bucket (stages 1-2) runs the
card's kernel or, when its estimate wins, the host C windowed kernel a
pair a thread (`_windowed_native_batch`, `batch.prefer_host_windowed`),
as the JAX package sends buckets of WINDOWED_CPU_MIN_LEN bp and more to
that kernel on an accelerator host (cascade.py:117-132). With
device="cpu", or QUICKED_TPU_PIN_CARD=1, every pair takes the staged lane
and every bucket the card's kernel (its plain version for the CPU).
Under a device mesh (`aligner.batch.ACTIVE_MESH`) every pair takes the
staged lane, the windowed bounds and the banded kernels sharded over its
devices; the windowed full mode runs on its first.

Not carried over: the JAX package's buckets on XLA's CPU backend
(`_windowed_device`): where no host C kernel serves (window_size > 16,
no C compiler) and for the windowed full mode, it runs a long bucket's
XLA program on the host's CPU. Its only counterpart here is the kernels'
plain version, which no path with a card runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quicked_tpu_torch import dna, native
from quicked_tpu_torch.aligner import batch as ab
from quicked_tpu_torch.aligner.batch import active_mesh, banded_align_batch
from quicked_tpu_torch.cigar import Cigar, score_edit_packed
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.ops.packed import (PackedSeqs, as_list, lengths,
                                          pack_pairs, subset)
from quicked_tpu_torch.ops.windowed_cuda import (prepare_windowed_batch,
                                                 run_windowed_full,
                                                 run_windowed_score)
from quicked_tpu_torch.params import QuickedParams, QuickedStatus
from quicked_tpu_torch.utils.host_threads import map_lanes
from quicked_tpu_torch.utils.profiler import PhaseTimers

W = 64


@dataclasses.dataclass
class CascadeResult:
    status: list
    score: np.ndarray
    cigar: list


def _raw(s, enc) -> bytes:
    """The raw bytes the host C kernels compare (the M-vs-X test): the
    ascii characters, or the encoded array itself for pre-encoded
    input."""
    if isinstance(s, np.ndarray):
        return np.asarray(enc, dtype=np.uint8).tobytes()
    return s.encode("ascii", "replace")


def _windowed_native_batch(patterns, texts, hew_threshold, window_size,
                           overlap_size):
    """The host C windowed bound (`native.windowed_score`), a pair a
    thread (`map_lanes`). Returns (score, hew) int64 arrays."""
    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    hews = np.zeros(n, dtype=np.int64)

    def one(i):
        p, t = patterns[i], texts[i]
        pe = p if isinstance(p, np.ndarray) else dna.encode(p)
        te = t if isinstance(t, np.ndarray) else dna.encode(t)
        scores[i], hews[i] = native.windowed_score(
            pe, _raw(p, pe), te, _raw(t, te), window_size, overlap_size,
            hew_threshold)

    map_lanes(one, n)
    return scores, hews


def _windowed_groups(patterns, texts, window_size: int) -> list:
    """The windowed buckets of a batch: (key, ascending indices) per
    distinct pow2 of max(plen, tlen, 64 ws), in first-pair order."""
    key = np.maximum(np.maximum(lengths(patterns), lengths(texts)),
                     W * window_size)
    return ab.key_groups(ab.next_pow2(key))


def windowed_score_batch(patterns, texts, hew_threshold: int,
                         window_size: int, overlap_size: int,
                         device="cuda"):
    """Bucketed windowed score bound. Returns (score, hew) int64 arrays.
    patterns/texts: lists of str or encoded arrays, or PackedSeqs (a
    batch that packs is subset per bucket without a step a pair).
    Where the router decides (a card, no mesh, not pinned) a bucket with
    window_size <= 16 runs the host C kernel when its estimate beats the
    card's (`batch.prefer_host_windowed`); every other bucket runs the
    card's kernel. Under a mesh each bucket's lanes are sharded over its
    devices."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
    route = ab.routed(dev) and native.available() and window_size <= 16
    pk = pack_pairs(patterns, texts)
    if pk is not None:
        patterns, texts = pk
    n = len(patterns)
    scores = np.zeros(n, dtype=np.int64)
    hews = np.zeros(n, dtype=np.int64)
    for _, idxs in _windowed_groups(patterns, texts, window_size):
        pats, txts = subset(patterns, idxs), subset(texts, idxs)
        if route and ab.prefer_host_windowed(pats, txts, window_size,
                                             overlap_size):
            ab._venue("windowed_host_c")
            sc, hw = _windowed_native_batch(as_list(pats), as_list(txts),
                                            hew_threshold, window_size,
                                            overlap_size)
        elif mesh is None:
            ab._venue("windowed")
            sc, hw = run_windowed_score(
                prepare_windowed_batch(pats, txts, window_size=window_size),
                hew_threshold, window_size, overlap_size, device=dev)
        else:
            from quicked_tpu_torch.parallel.mesh import run_windowed_sharded
            ab._venue("mesh_windowed")
            sc, hw = run_windowed_sharded(
                prepare_windowed_batch(pats, txts, window_size=window_size),
                hew_threshold, window_size, overlap_size, mesh)
        scores[idxs] = sc
        hews[idxs] = hw
    return scores, hews


def windowed_full_batch(patterns, texts, window_size: int,
                        overlap_size: int, device="cuda") -> list:
    """Bucketed full-CIGAR windowed alignment; returns op strings in input
    order. The counterpart of quicked_tpu/aligner/cascade.py
    `windowed_full_batch`, on the card only: on an accelerator the JAX
    package runs this mode on its device kernel, or a long bucket on XLA's
    CPU backend, never on the host C kernel (which serves only its CPU
    platform), and the port's counterpart of the CPU backend, the plain
    version, runs on no path with a card. Like it, it does not shard:
    under a mesh it runs on the mesh's first device."""
    dev = resolve_device(device)
    mesh = active_mesh(dev)
    if mesh is not None:
        dev = mesh.devices[0]
    pk = pack_pairs(patterns, texts)
    if pk is not None:
        patterns, texts = pk
    out: list = [None] * len(patterns)
    for _, idxs in _windowed_groups(patterns, texts, window_size):
        batch = prepare_windowed_batch(
            subset(patterns, idxs), subset(texts, idxs),
            window_size=window_size)
        ops = run_windowed_full(batch, window_size, overlap_size,
                                device=dev)
        for j, i in enumerate(idxs.tolist()):
            out[i] = ops[j]
    return out


_FAST_MAX_CACHE: dict = {}


def _native_fast_max(bandwidth: int) -> int:
    """Largest pair length whose worst-case stage-4 banded footprint
    (ebb * text_len * 8 * 2, bpm_hirschberg.c:63-65) fits the 16 MB
    Hirschberg base-case budget: ~20 kbp at the default 15% band. Pairs
    up to it take the one-call host C cascade on a card host when its
    estimate wins; past it the host lane would defer stage 4 to the
    batched Hirschberg driver anyway. Memoized on (bandwidth, budget)."""
    from quicked_tpu_torch import params as qp

    key = (bandwidth, qp.HIRSCHBERG_BUFFER_SIZE)
    got = _FAST_MAX_CACHE.get(key)
    if got is not None:
        return got

    def fits(L: int) -> bool:
        ebb = (L * bandwidth // 100) // W + 2
        return ebb * L * 16 <= qp.HIRSCHBERG_BUFFER_SIZE

    lo, hi = W, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    _FAST_MAX_CACHE[key] = lo
    return lo


def _native_lane(pairs, params: QuickedParams, dev) -> list:
    """Indices of the pairs the host C cascade takes: none unless the
    router decides for `dev` (a card, no mesh, not pinned); else those no
    longer than `_native_fast_max`, unless the staged lane's estimate wins
    (`batch.prefer_staged_short`)."""
    if not (ab.routed(dev) and native.available()
            and params.window_size <= 16):
        return []
    n = len(pairs)
    lens = np.fromiter(map(len, (s for pair in pairs for s in pair)),
                       np.int64, 2 * n)
    maxlens = np.maximum(lens[0::2], lens[1::2])
    sel = maxlens <= _native_fast_max(params.bandwidth)
    fast = np.nonzero(sel)[0].tolist()
    if fast and ab.prefer_staged_short(int(maxlens[sel].sum())):
        ab._venue("cascade_staged_shortreads")
        return []
    return fast


def quicked_cascade_batch(pairs, params: QuickedParams | None = None,
                          timers=None, device="cuda") -> CascadeResult:
    """Run the QuickEd cascade on a batch of (pattern, text) pairs.
    `timers` (utils.profiler.PhaseTimers) takes the per-stage times, as
    the reference's instrumentation does (quicked.c:184-294): one
    `total` lap per call, whichever lanes the batch takes, and the router
    resolves its probes and rates before it."""
    params = params or QuickedParams()
    dev = resolve_device(device)
    if timers is None:
        timers = PhaseTimers()
    native.set_force_scalar(params.force_scalar)
    ab.router_ready(dev)
    fast = _native_lane(pairs, params, dev)
    timers.total.start()
    try:
        if fast:
            return _cascade_with_native_lane(pairs, params, timers, fast,
                                             dev)
        return _cascade_staged(pairs, params, timers, dev)
    finally:
        timers.total.stop()


def _cascade_with_native_lane(pairs, params: QuickedParams, timers, fast,
                              device="cuda") -> CascadeResult:
    """The pairs `fast` through the host C cascade in one call; those over
    the Hirschberg budget finish in `hirschberg_batch` under their proven
    bound (booked under `timers.align`), the rest of the batch through
    the staged lane."""
    from quicked_tpu_torch.aligner.hirschberg import hirschberg_batch
    from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE

    n = len(pairs)
    ab._venue("cascade_native")
    all_fast = len(fast) == n
    st, sc, rles = native.quicked_batch(
        [pairs[i][0] for i in fast], [pairs[i][1] for i in fast],
        bandwidth=params.bandwidth, window_size=params.window_size,
        overlap_size=params.overlap_size,
        hew_threshold=params.hew_threshold,
        hew_percentage=params.hew_percentage,
        budget=HIRSCHBERG_BUFFER_SIZE, rle=True)
    if all_fast and not np.any(st):
        # every pair aligned in C: return the packed results as they are
        # (run_quicked returns QUICKED_WIP on success, quicked.c:305)
        return CascadeResult(status=[QuickedStatus.QUICKED_WIP] * n,
                             score=sc, cigar=rles.with_empty_as_none())
    statuses: list = [None] * n
    scores = np.full(n, -1, dtype=np.int64)
    cigars: list = [None] * n
    deferred = []       # (input index, proven bound)
    for j, i in enumerate(fast):
        if st[j] == 0:
            statuses[i] = QuickedStatus.QUICKED_WIP
            scores[i] = sc[j]
            cigars[i] = rles[j] or None
        else:
            deferred.append((i, int(sc[j])))
    if deferred:
        timers.align.start()
        res = hirschberg_batch([pairs[i][1] for i, _ in deferred],
                               [pairs[i][0] for i, _ in deferred],
                               [b for _, b in deferred], device=device)
        for (i, _), (_, h_ops) in zip(deferred, res):
            # run_quicked ignores the Hirschberg status and returns WIP
            # (quicked.c:290-305)
            statuses[i] = QuickedStatus.QUICKED_WIP
            c = Cigar(operations=h_ops or "")
            scores[i] = c.score_edit()
            cigars[i] = c.sprint(True) if h_ops else None
        timers.align.stop()
    fast_set = set(fast)
    slow = [i for i in range(n) if i not in fast_set]
    if slow:
        sub = _cascade_staged([pairs[i] for i in slow], params, timers,
                              device)
        for j, i in enumerate(slow):
            statuses[i] = sub.status[j]
            scores[i] = sub.score[j]
            cigars[i] = sub.cigar[j]
    return CascadeResult(status=statuses, score=scores, cigar=cigars)


def proven_bounds(pats, txts, params: QuickedParams, timers,
                  device) -> np.ndarray:
    """Stages 1-3: the score bound each pair's stage-4 alignment runs
    under (quicked.c:184-276). int64 array in input order. pats/txts:
    lists of sequences, or PackedSeqs."""
    plen, tlen = lengths(pats), lengths(txts)
    max_len = np.maximum(plen, tlen)

    # ---- STAGE 1: fast windowed bound (quicked.c:184-199) ----
    timers.windowed_s.start()
    score, hew = windowed_score_batch(pats, txts, params.hew_threshold[0],
                                      2, 1, device=device)
    timers.windowed_s.stop()
    hard = np.flatnonzero(
        hew * W > max_len * params.hew_percentage[0] // 100)

    if len(hard):
        # ---- STAGE 2: large windows, forward + reversed pair ----
        ws, ovl = params.window_size, params.overlap_size
        timers.windowed_l.start()
        hp, ht = subset(pats, hard), subset(txts, hard)
        if isinstance(hp, PackedSeqs):
            rp, rt = hp.reversed(), ht.reversed()
        else:
            rp, rt = [p[::-1] for p in hp], [t[::-1] for t in ht]
        s_fwd, hew_fwd = windowed_score_batch(
            hp, ht, params.hew_threshold[1], ws, ovl, device=device)
        s_rev, hew_rev = windowed_score_batch(
            rp, rt, params.hew_threshold[1], ws, ovl, device=device)
        timers.windowed_l.stop()
        sc = np.minimum(s_fwd, s_rev)
        hw = np.where(sc >= s_rev, hew_rev, hew_fwd)
        score[hard] = sc
        harder = hard[hw * W * (ws - ovl)
                      > max_len[hard] * params.hew_percentage[1] // 100]

        if len(harder):
            # ---- STAGE 3: banded score + telescoping retry
            # (quicked.c:246-276) ----
            timers.banded.start()
            cut = np.minimum(max_len * params.bandwidth // 100, score)
            # Narrow-band trial: a banded score <= its cutoff is exact, so
            # a 5/8 band resolves cap-limited pairs at ~5/8 the cost;
            # failures fall into the reference retry schedule below.
            tcut = cut * 5 // 8
            trial = harder[(score[harder] > cut[harder])
                           & (cut[harder] >= 4096)
                           & (tcut[harder]
                              > np.abs(plen[harder] - tlen[harder]) + 1)]
            if len(trial):
                ts, _ = banded_align_batch(
                    subset(pats, trial), subset(txts, trial), tcut[trial],
                    only_score=True, device=device)
                ok = (ts >= 0) & (ts <= tcut[trial])
                score[trial[ok]] = ts[ok]
                harder = np.setdiff1d(harder, trial[ok])
            pending = harder
            while len(pending):
                ns, _ = banded_align_batch(
                    subset(pats, pending), subset(txts, pending),
                    cut[pending], only_score=True, device=device)
                retry = ((ns > max_len[pending] // 4)
                         & (cut[pending] * 3 // 2 < ns)) | (ns < 0)
                done = pending[~retry]
                score[done] = ns[~retry]
                pending = pending[retry]
                # floor at 1: a zero cut would double to zero
                cut[pending] = np.maximum(cut[pending] * 2, 1)
            timers.banded.stop()
    return score


def cigar_results(ops: PackedSeqs):
    """(edit scores int64, RLE CIGARs) of every op string of a packed
    buffer, an empty one's CIGAR None: with the host C runtime, the
    scores in numpy (`cigar.score_edit_packed`) and the CIGARs in one call
    (`native.cigar_sprint_packed`, a LazyOpsList); without it, a `Cigar`
    a pair, as `Cigar.sprint` itself falls back."""
    if native.available():
        return (score_edit_packed(ops.buf, ops.off, ops.len),
                native.cigar_sprint_packed(ops.buf, ops.off, ops.len))
    scores = np.zeros(len(ops), dtype=np.int64)
    cigars: list = [None] * len(ops)
    for i, o in enumerate(ops.strs()):
        c = Cigar(operations=o)
        scores[i] = c.score_edit()
        cigars[i] = c.sprint(True) if o else None
    return scores, cigars


def _cascade_staged(pairs, params: QuickedParams, timers,
                    device) -> CascadeResult:
    from quicked_tpu_torch.aligner.hirschberg import hirschberg_batch

    n = len(pairs)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    pk = pack_pairs(pats, txts)
    if pk is not None:
        pats, txts = pk
    score = proven_bounds(pats, txts, params, timers, device)

    # ---- STAGE 4: full alignment under the proven bound ----
    timers.align.start()
    res = hirschberg_batch(txts, pats, score, device=device)
    timers.align.stop()

    # run_quicked ignores the Hirschberg status and extracts whatever
    # (possibly partial) CIGAR is in the buffer, returning WIP
    # (quicked.c:290-305)
    final_scores, cigars = cigar_results(res.ops)
    return CascadeResult(status=[QuickedStatus.QUICKED_WIP] * n,
                         score=final_scores, cigar=cigars)
