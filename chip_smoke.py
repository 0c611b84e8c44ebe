#!/usr/bin/env python3
"""Smoke run of quicked_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--pairs N] [--length L]
                          [--long-pairs N] [--long-length L]

Run from the repository root. It builds the port's CUDA kernels from
`quicked_tpu_torch/csrc/`, then:

  phase 1  names the card (nvidia-smi name and power limit) and its SM
           clock, times the kernel build and prints the register report
           of every instantiation of the fill, windowed (score and full),
           traceback, systolic, carry-scan and split kernels (`nvcc
           -Xptxas -v`; any spill fails), and builds (or loads)
           the port's host C library, the oracle and the record
           expansion;
  phase 2  runs each kernel and its plain PyTorch version on the same
           inputs, the plain versions on host copies in worker processes
           (`PlainPool`) while the card goes on, drained before phase 3,
           and requires bit-exact agreement (tolerance 0: every
           output is an integer; the systolic pass under its contract,
           pv/mv on [first, last] and its ABORT flags): 64 pairs x 2 kbp
           with large indels on the card (score, Hirschberg-midpoint and
           full fills, the traceback, ws 2 and 9 for the windowed bound);
           8 of those pairs for the carry-scan and systolic passes, the
           split epilogue and ws 1 (ovl 0), 14, 15 (the window's
           shared/scratch cutover), 20 and 33 (past one warp), the
           windowed full-CIGAR mode at ws 1 (ovl 0), 2, 9, 14, 15 and 20
           on them and a pure-deletion and a pure-insertion pair, and one
           pair of 25 kbp for the
           systolic recentering, the plain side on a host copy; the
           deepest two of 16 pairs of 10 kbp with four 500 bp indels, full
           fill and traceback under their stage-4 bound, the plain side on
           a host copy; the systolic kernel's 4- and 16-rows-per-thread
           windows against the carry-scan pass and both plain versions,
           and the fill (14 warps per pair; four rounds of 2048 blocks)
           against the carry-scan pass on the same batches;
           the carry-scan pass on phase 5's BANDED batch; the full-depth
           check: the systolic and carry-scan passes against the fill
           kernel on the long-read phase's first Hirschberg level (its
           deep half-pass bucket), and against their plain versions on
           two of its lanes; the fill at each of its stripe widths (1, 2,
           4 band blocks per thread), past 128 blocks (2 and 13 warps per
           pair) and past 2048 (the band walked in rounds), score, full
           and at text-finish midpoints; and, at
           the shapes one long-read run hands the kernels, the split
           epilogue on every split level (level 1 on the systolic pass's
           outputs, also against hirschberg_split_fast on the same
           words; the later ones on the fill's), timed by its device time
           (torch.profiler), the fill on the smallest fill level and on
           the first stage-4 base-case chunk (the plain versions on a
           host copy of one or two lanes); the windowed
           kernel on batches of 1, 17, 140, 700 and 4,300 pairs (1 to 32
           pairs per warp), the traceback on one pair with a 500-row
           D-run and on random planes at EBB 1, 128 and 7,300 (D-runs past
           the staged window); kernel times by CUDA events, and the
           fill's times at every fused level, that chunk and the 10 kbp
           run's largest full-fill chunk;
  phase 3  aligns N pairs x L bp at 10% error (half of them with four
           large indels) through `api.BatchAligner(QuickedParams())` on
           the card, requires every status, score and CIGAR to equal the
           host C cascade (`quicked_tpu_torch.native.quicked_batch`),
           and requires the fill, traceback and windowed kernels to have
           been launched by that run;
  phase 5  the long-read path: --long-pairs pairs x --long-length bp the
           same way (stage 3 and the first split level on the systolic
           pass, the next levels on the fill, every level finished by the
           split epilogue on the card, no midpoint searched on the host),
           held against the host C cascade (its Hirschberg for the pairs
           over the 16 MB budget), every kernel of the path launched;
           then BANDED score-only on 16 pairs x 30 kbp (the carry-scan
           pass) against the host C banded kernel;
  phase 6  WINDOWED with CIGARs (ws 9, ovl 1) over the phase-3 pairs
           through `api.BatchAligner`, every score and CIGAR held to the
           host C windowed full mode (`native.windowed_full`), the
           full-mode kernel launched, then timed on that batch with its
           bound and held to its plain version on two lanes;
  phase 7  the CLI on the card: `align_benchmark -a quicked` in-process
           over the phase-3 pairs (written to a .seq file, batches of
           250), every TSV line equal to the host C cascade and the fill,
           traceback and windowed kernels launched, its wall beside phase
           3's API wall; `-a edit-bpm` (a full-width band, the fill past
           128 blocks) on 100 of them, scores equal to the host C cascade
           and `--check correct` at 100%; `-a edit-banded`,
           `edit-banded-hirschberg` and `edit-windowed`, with and without
           `--only-score`, on 200, every line equal to the host C runtime
           (`native.hirschberg` with the band's cutoff, an unbounded
           budget for BANDED; the host C banded kernel for BANDED scores;
           `native.windowed_full` and `native.windowed_score`) and to
           `api.align_batch`;
           one subprocess run of the module entry with `--profile` (the
           trace names the fill) and `--memory-report` (the card's peak,
           the full fill's planes);
  phase 8  the multi-device layer (`quicked_tpu_torch.parallel`) on the
           card: `dryrun_multichip` over every card; the phase-3 and
           phase-5 pairs again under `use_mesh` on three shards of
           cuda:0 (uneven lanes and task runs), every status, score and
           CIGAR equal to the unmeshed run's and every kernel that run
           launched launched again, each wall beside the unmeshed one;
           two `distributed_align` processes on cuda:0 (the torchrun
           environment, gloo) over phase 7's .seq file with interleaved
           sharding, the merged TSV equal to phase 7's `-a quicked`
           lines; one run of `examples_torch/mesh_pipeline.py`;
  recorded both slices aligned once more, untimed, while `Recorder`
           keeps what they hand the windowed kernel (stage 1, stage 2
           forward and reverse), the traceback (the 10 kbp run's
           largest chunk, the long-read run's first) and the deep-band
           kernels (the long-read run's stage 3 and split level 1): every
           windowed pair against the host C windowed bound
           (`native.windowed_score`), each batch timed with its bound;
           each chunk held to the plain version on two lanes of a host
           copy, timed with its bound; each deep-band batch staged anew
           and timed with its bound, its ABORT lanes in the run and its
           cycles a step, the stage-3 systolic batch held to the plain
           version on its first and last lanes of a host copy;
  phase 4  aligns the phase-3 and the long-read pairs again under
           `torch.profiler` and prints the device time of each kernel and
           copy and the card's busy share of the wall.

The line before the last is a JSON object with one entry per kernel,
with its bound: the larger of the bytes its function must move over
3.35 TB/s and its operations over the card's int32 rate (Myers advances
at OPS_PER_ADVANCE each). `quicked_tpu_torch.kernel_ab` times another
checkout's windowed, traceback, deep-band and split kernels against this
one's at the recorded shapes. The last line is {"ok": true, "device":
{...}}. Any failure exits non-zero without that line. No CUDA card, or no repository around the script,
also exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_PAIRS, SMALL_LEN = 64, 2000
DEEP_PAIRS = 8      # pairs of the deep-band kernels' phase-2 comparisons
DEEP_LEN = 10_000   # the main path's deep full-fill bucket at 10 kbp
RECENTER_LEN, RECENTER_CUTOFF = 25_000, 4500
BANDED_PAIRS, BANDED_LEN = 16, 30_000   # the carry-scan score run
# the systolic kernel's wide windows: name -> (text length, bases inserted
# into the middle of each pattern, cutoff, resident rows to exceed)
WIDE = {
    "wide_m4": (30_000, 100_000, 108_000, 1024),   # EBB ~1690, recenters
    "wide_m16": (2_000, 0, 510_000, 4096),         # EBB ~7970
}
SEED = 7
# the fill's stripe widths and past 128 band blocks: cutoff -> the EBB
# range it must give (S = 1, 2, 4 band blocks per thread; several warps)
STRIPES = {1500: (17, 32), 3000: (33, 64), 7000: (65, 128),
           12000: (129, 256)}
# deeper bands on 2 pairs whose texts are one 64-column block, so that
# the plain version stays cheap: cutoff -> (EBB range, kinds); 13 warps
# per pair, then past 2048 blocks (the band walked in two rounds per
# column)
DEEP_STRIPES = {100_000: ((1537, 1664), ("score", "full")),
                150_000: ((2049, 4096), ("score", "full", "mid"))}

# Bounds. H100 SXM: 3.35e12 B/s of device memory; 132 SMs x 64 int32
# lanes x 1.98 GHz = 1.67e13 int32 operations/s. A 64-row Myers advance
# on 64-bit words is about 30 int32 operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_ADVANCE = 30
# the card's maximum SM clock in MHz, read by nvidia-smi in phase 1
MAX_SM_MHZ = None


# the TPU kernel (or XLA program) each CUDA kernel replaces
REPLACES = {
    "banded_fill": "quicked_tpu/ops/banded_pallas.py:57",
    "banded_traceback": "quicked_tpu/ops/banded_traceback_jax.py:82",
    "windowed_score": "quicked_tpu/ops/windowed_jax.py:186",
    "banded_cscan": "quicked_tpu/ops/banded_cscan_pallas.py:176",
    "banded_sysband": "quicked_tpu/ops/banded_sysband_pallas.py:68",
    "hirschberg_split": "quicked_tpu/ops/hirschberg_split_jax.py:39",
    "windowed_full": "quicked_tpu/ops/windowed_jax.py:186",
}
# the source of each kernel, where it is not csrc/<name>.cu
SOURCES = {"windowed_full": "windowed_score"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Median milliseconds of `fn` over `reps` runs, by CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes=0, ops=0):
    """(bound_ms, bound_by): the least time for a call that moves
    `nbytes` bytes and does `ops` int32 operations, and which sets it."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (o_ms, "operations") if o_ms >= b_ms else (b_ms, "bytes")


def banded_bound(st):
    """Bound of a banded pass over the staged batch `st` (fill, carry-scan
    or systolic): one Myers advance per live block-column, as the fill
    counts them (`fill_advances`); bytes: the staged inputs read once,
    the outputs written once (the planes too for a full batch)."""
    from quicked_tpu_torch.ops import banded_cuda as bc

    B, EBB, NB = st.B, st.EBB, st.NB
    nbytes = sum(t.numel() * t.element_size() for t in
                 (st.peq, st.lm, st.text, st.init_scores,
                  *st.lanes.values()))
    nbytes += B * ((NB + EBB + 1) * 4 + EBB * 16 + 8)
    if st.full:
        nbytes += NB * 64 * EBB * B * 16
    return bound(nbytes, bc.fill_advances(st) * OPS_PER_ADVANCE)


# the instantiations of each source's kernels in the `-Xptxas -v` report:
# mangled-name pattern -> label
REPORTED = {
    "banded_fill.cu": (
        (r"banded_fill_kernelILi(\d+)ELb(\d)ELb(\d)E",
         "S={0} several_warps={1} full={2}"),
        (r"banded_fill_stream_kernelILb(\d)E", "streamed full={0}")),
    "windowed_score.cu": (
        (r"windowed_kernelILb(\d)ELb(\d)E", "shared={0} full={1}"),),
    "hirschberg_split.cu": ((r"hsplit_kernel", "warps walk task spans"),),
    "banded_traceback.cu": ((r"banded_traceback_kernel", "warp per pair"),),
    "banded_sysband.cu": (
        (r"banded_sysband_kernelILi(\d+)ELi(\d)E",
         "rows_per_thread={0} words={1} (0 registers, 1 shared, 2 device)"),),
    "banded_cscan.cu": (
        (r"banded_cscan_kernelILi(\d+)ELb(\d)E", "S={0} several_warps={1}"),
        (r"banded_cscan_rounds_kernel", "rounds")),
}


def register_check(_build):
    """Print the register report of every kernel in REPORTED, one line per
    instantiation; fail on any spill."""
    import re

    spills = []
    for src, kinds in REPORTED.items():
        name, seen = None, 0
        for line in _build.register_report(src).splitlines():
            if "Compiling entry function" in line:
                name = None
                for rx, label in kinds:
                    m = re.search(rx, line)
                    if m:
                        name, seen = label.format(*m.groups()), seen + 1
            elif name and ("Used" in line or "spill" in line):
                text = line.split(":", 1)[-1].strip()
                print(f"[phase 1] {src[:-3]} {name}: {text}")
                sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
                if sp and not sp.group(1) == sp.group(2) == "0":
                    spills.append(f"{src[:-3]} {name} spills: {text}")
        check(seen > 0, f"no register report for {src}")
    check(not spills, "; ".join(spills))


def max_abs_err(a, b):
    """Largest |a - b| over matching tensors (int64 words compare as
    equal or not: their difference could overflow)."""
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.int64:
        return 0 if torch.equal(a, b) else float("inf")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _plain_worker_init(root):
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(1)


def _timed(fn, args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


class PlainPool:
    """The plain versions (Python loops of small torch ops, minutes in
    all) on host copies, in worker processes while the main process goes
    on with the card. `submit` queues fn(*args), a module-level function
    and host tensors, both pickled to a worker, with a callback that
    checks its result; `drain` waits for every job queued so far and runs
    their callbacks, which raise SmokeFailure on a disagreement. The main
    process drains the pool before it times a slice, so that no worker
    shares the host with that run."""

    def __init__(self, workers):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.ex = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_plain_worker_init, initargs=(ROOT,))
        self.jobs = []

    def submit(self, fn, args, done):
        self.jobs.append((self.ex.submit(_timed, fn, args), done))

    def drain(self):
        jobs, self.jobs = self.jobs, []
        for fut, done in jobs:
            done(*fut.result())

    def close(self):
        self.ex.shutdown(wait=True, cancel_futures=True)


def plain_check(pool, name, kern, fn, args, entry, compare=None):
    """Queue the plain version fn(*args) on host tensors; when it returns,
    hold the kernel's host outputs `kern` (a dict, or a sequence in the
    plain version's order) to it bit-exact, or by `compare(plain)` (which
    returns the error), and record err and plain_ms in `entry`."""
    def done(plain, plain_ms):
        if compare is not None:
            err = compare(plain)
        elif isinstance(plain, dict):
            err = max(max_abs_err(kern[k], plain[k]) for k in plain)
        else:
            err = max(max_abs_err(a, b) for a, b in zip(kern, plain))
        check(err == 0, f"{name}: kernel disagrees with plain version")
        entry.update(err=err, plain_ms=plain_ms)
        print(f"[plain] {name}: bit-exact, plain on the host "
              f"{plain_ms:.1f} ms")
    pool.submit(fn, args, done)


def host_tensors(x):
    """A host copy of a tensor, a dict or a sequence of tensors."""
    if isinstance(x, dict):
        return {k: v.cpu() for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(v.cpu() for v in x)
    return x.cpu()


def phase2(gen, seed, torch, pool):
    """Each kernel against its plain version on the same inputs, the
    plain side on a host copy."""
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc
    from quicked_tpu_torch.ops import windowed_cuda as wc

    pairs = list(gen.generate_pairs(SMALL_PAIRS, SMALL_LEN, error=0.1,
                                    indels_num=4, indels_length=100,
                                    seed=seed))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    res = {}

    # banded fill: score, score stopped at Hirschberg midpoints, full
    cases = {
        "fill_score": dict(full=False),
        "fill_midpoint": dict(full=False,
                              text_finish=[(len(t) + 1) // 2 for t in txts]),
        "fill_full": dict(full=True),
    }
    staged = {}
    for name, kw in cases.items():
        b = prepare_banded_batch(pats, txts, cos, **kw)
        st = bc.stage_banded(b, "cuda")
        staged[name] = st
        kern = host_tensors(bc.fill_staged(st))
        ms = cuda_ms(lambda: bc.fill_staged(st), 5)
        res[name] = dict(ms=ms)
        print(f"[phase 2] {name}: B={st.B} EBB={st.EBB} NB={st.NB} "
              f"kernel {ms:.3f} ms")
        plain_check(pool, name, kern, bc.banded_scan_torch,
                    (bc.stage_banded(b, "cpu"),), res[name])
        del kern

    # traceback over the full fill's planes
    st = staged["fill_full"]
    out = bc.fill_staged(st)
    maxp = max(len(p) for p in pats)
    praw, traw = btc.prep_raw_frames([p.encode() for p in pats],
                                     [t.encode() for t in txts],
                                     out["mat_pv"].shape[0], maxp)
    args = (out["mat_pv"], out["mat_mv"], torch.from_numpy(praw).cuda(),
            torch.from_numpy(traw).cuda(), st.lanes["prolog"].new_tensor(
                [len(p) for p in pats]),
            st.lanes["prolog"].new_tensor([len(t) for t in txts]),
            st.lanes["prolog"])
    res.update(traceback_check("traceback", args, host_tensors(args), torch,
                               pool, reps=5))

    # windowed bound, stage 1 (ws 2) and stage 2 (ws 9) shapes
    for ws in (2, 9):
        res.update(windowed_check(f"windowed_ws{ws}", pats, txts, ws, 1,
                                  torch, pool))
    return res


def phase2_deep(gen, torch, pool):
    """Full fill and traceback at the main path's deep full-fill bucket:
    the deepest two of 16 pairs with four 500 bp indels, cut off at the
    stage-4 bound the port's stages 1-3 prove for them. The plain
    versions are Python loops of small ops, slower on the card than on
    the host, so they run on a host copy of the same staged tensors."""
    from quicked_tpu_torch.ops import myers_np
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.utils.profiler import PhaseTimers
    from quicked_tpu_torch.aligner.batch import bucket_keys
    from quicked_tpu_torch.aligner.cascade import proven_bounds
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc

    cand = list(gen.generate_pairs(16, DEEP_LEN, error=0.1, indels_num=4,
                                   indels_length=500, seed=SEED + 20))
    bounds = proven_bounds([p for p, _ in cand], [t for _, t in cand],
                           QuickedParams(), PhaseTimers(), "cuda")
    depth = [myers_np.band_geometry(len(p), len(t), int(b)).ebb
             for (p, t), b in zip(cand, bounds)]
    deep = sorted(range(len(cand)), key=depth.__getitem__)[-2:]
    pats = [cand[i][0] for i in deep]
    txts = [cand[i][1] for i in deep]
    cos = [int(bounds[i]) for i in deep]
    bucket = min(k[1] for k in bucket_keys(
        [len(p) for p in pats], [len(t) for t in txts], cos, full=True))
    check(bucket >= 64, f"deep case reached only the EBB {bucket} bucket")

    batch = prepare_banded_batch(pats, txts, cos, full=True)
    st = bc.stage_banded(batch, "cuda")
    kern = bc.fill_staged(st)
    ms = cuda_ms(lambda: bc.fill_staged(st), 3)
    res = dict(fill_full_deep=dict(ms=ms))
    print(f"[phase 2] fill_full_deep: bounds {cos}, B={st.B} EBB={st.EBB} "
          f"(bucket {bucket}) NB={st.NB}, kernel {ms:.3f} ms")
    plain_check(pool, "fill_full_deep", host_tensors(kern),
                bc.banded_scan_torch, (bc.stage_banded(batch, "cpu"),),
                res["fill_full_deep"])

    T = kern["mat_pv"].shape[0]
    praw, traw = btc.prep_raw_frames([p.encode() for p in pats],
                                     [t.encode() for t in txts], T,
                                     max(len(p) for p in pats))
    dev = (kern["mat_pv"], kern["mat_mv"], torch.from_numpy(praw).cuda(),
           torch.from_numpy(traw).cuda(),
           st.lanes["prolog"].new_tensor([len(p) for p in pats]),
           st.lanes["prolog"].new_tensor([len(t) for t in txts]),
           st.lanes["prolog"])
    res.update(traceback_check("traceback_deep", dev, host_tensors(dev),
                               torch, pool))
    return res


def fill_plain_check(name, st, b, lanes, torch, pool, reps=3):
    """The fill kernel on the CUDA batch `st` (staged from `b`) against
    its plain version on a host copy of lanes `lanes`, every output
    bit-exact; the kernel's time on the whole batch by CUDA events."""
    from quicked_tpu_torch.ops import banded_cuda as bc

    idx = torch.tensor(lanes)
    kern = {k: v[..., idx.cuda()].cpu() for k, v in bc.fill_staged(st).items()}
    ms = cuda_ms(lambda: bc.fill_staged(st), reps)
    b_ms, b_by = banded_bound(st)
    entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[phase 2] {name}: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"full={st.full}, lanes {lanes} to the plain version: kernel "
          f"{ms:.3f} ms (bound {b_ms:.3f} ms, {b_by})")
    plain_check(pool, name, kern, bc.banded_scan_torch,
                (bc.select_lanes(bc.stage_banded(b, "cpu"), idx),), entry)
    return entry


def phase2_stripes(gen, torch, pool):
    """The fill at each of its stripe widths (1, 2 and 4 band blocks per
    thread: EBB <= 32, 64, 128) and past 128 blocks (several warps per
    pair), score and full, and at text-finish midpoints; 6 pairs x 300 bp
    whose cutoffs set the depth; then 13 warps per pair and a band over
    2048 blocks on 2 pairs of 80 bp patterns and 64 bp texts (the band
    cut/shift runs after the block's last column); the plain version on a
    host copy."""
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch

    res = {}
    cases = [(6, 300, None, cutoff, rng, ("score", "full", "mid"))
             for cutoff, rng in STRIPES.items()]
    cases += [(2, 80, 64, cutoff, rng, kinds)
              for cutoff, (rng, kinds) in DEEP_STRIPES.items()]
    for n, length, cut, cutoff, (lo, hi), kinds in cases:
        pairs = list(gen.generate_pairs(n, length, error=0.1, indels_num=2,
                                        indels_length=length // 7,
                                        seed=SEED + 60))
        pats = [p for p, _ in pairs]
        txts = [t[:cut] for _, t in pairs]
        mids = [(len(t) + 1) // 2 for t in txts]
        kws = {"score": dict(full=False), "full": dict(full=True),
               "mid": dict(full=False, text_finish=mids)}
        for kind in kinds:
            b = prepare_banded_batch(pats, txts, [cutoff] * n, **kws[kind])
            check(lo <= b.EBB <= hi, f"cutoff {cutoff}: EBB {b.EBB} not in "
                  f"[{lo}, {hi}]")
            name = f"fill_stripe_{kind}_ebb{b.EBB}"
            res[name] = fill_plain_check(name, bc.stage_banded(b, "cuda"),
                                         b, list(range(n)), torch, pool)
    return res


def host_ms(fn):
    """(result, milliseconds) of fn on the host's clock."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def band_err(got, want, lanes):
    """max_abs_err of a score pass under the systolic contract, against
    `want` on `lanes`: scores_by_k, first and last, and pv/mv on the rows
    [first, last] of `want`."""
    import torch

    got = {k: v[..., lanes].cpu() for k, v in got.items()}
    want = {k: v[..., lanes].cpu() for k, v in want.items()}
    err = max(max_abs_err(got[k], want[k])
              for k in ("scores_by_k", "first", "last"))
    rows = torch.arange(want["pv"].shape[0])[:, None]
    band = (rows >= want["first"].long()[None]) & \
        (rows <= want["last"].long()[None])
    for k in ("pv", "mv"):
        err = max(err, max_abs_err(torch.where(band, got[k], 0),
                                   torch.where(band, want[k], 0)))
    return err


def device_ms(fn, kernel, reps=5):
    """Median device milliseconds of the launches of `kernel` (a substring
    of its name) over `reps` runs of fn, by torch.profiler. For a kernel
    shorter than the host time of its wrapper, which the CUDA events
    around a call would measure instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [_device_ms(e) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and
             kernel in e.name]
    check(times, f"the profiler recorded no launch of {kernel}")
    return statistics.median(times)


def hsplit_bound(host_out, host_task):
    """Bound of one split epilogue call: per feasible task the words of
    both spans the split must read (Pv and Mv, 16 bytes a word: the
    forward band from bottom_cell over n_cells - 1 cells, the reverse one
    from higher_cell_r over n_cells), and per task its two lanes'
    first/last and score rows, its three scalars and four results read or
    written once; one compare a candidate cell of the argmin."""
    from quicked_tpu_torch.ops import hirschberg_split_cuda as hs

    g = hs.split_geometry(host_out, *host_task)
    ok = g["feasible"]
    n, fwd, rev = (g[k][ok] for k in ("n_cells", "bottom_cell",
                                       "higher_cell_r"))
    words = ((fwd + n - 2) >> 6) - (fwd >> 6) + 1 + \
        ((rev + n - 1) >> 6) - (rev >> 6) + 1
    tasks = len(host_task[0])
    return bound(int(words.sum()) * 16 + tasks * (16 + 8 + 12 + 16),
                 int(n.sum()))


def hsplit_check(name, b, out, torch, spec=False):
    """The split epilogue on the card over a score pass's outputs `out`
    for the interleaved forward/reverse level batch `b`, against the plain
    split on a host copy of them, every output equal; with `spec`, each
    task also against the host's myers_np.hirschberg_split_fast on the
    same words (a deep level, whose midpoints the host once searched).
    Timed by its device time (torch.profiler) and, wrapper included, by
    CUDA events."""
    import numpy as np

    from quicked_tpu_torch.ops import hirschberg_split_cuda as hs
    from quicked_tpu_torch.ops import myers_np

    task = [torch.tensor(a[0::2], dtype=torch.int32, device="cuda")
            for a in (b.prolog, b.plen, b.tlen)]
    kern = [x.cpu() for x in hs.hirschberg_split(out, *task)]
    host_out = {k: v.cpu() for k, v in out.items()}
    host_task = [x.cpu() for x in task]
    plain, plain_ms = host_ms(lambda: hs.hirschberg_split_torch(
        host_out, *host_task))
    err = max(max_abs_err(k, p) for k, p in zip(kern, plain))
    check(err == 0, f"{name}: kernel disagrees with plain version")
    msg = ""
    if spec:
        def words(j, k):
            return host_out[k][:, j].numpy().view(np.uint64)

        for j in range(len(host_task[0])):
            f, r = 2 * j, 2 * j + 1
            want = myers_np.hirschberg_split_fast(
                words(f, "pv"), words(f, "mv"), int(host_out["first"][f]),
                int(host_out["last"][f]), host_out["scores_by_k"][:, f]
                .numpy(), words(r, "pv"), words(r, "mv"),
                int(host_out["first"][r]), int(host_out["last"][r]),
                host_out["scores_by_k"][:, r].numpy(),
                int(b.prolog[f]), int(b.plen[f]), int(b.tlen[f]))
            got = tuple(int(x[j]) for x in kern[:3]) if kern[3][j] else None
            check(got == want, f"{name}: task {j} differs from "
                  f"hirschberg_split_fast on the same words")
        msg = ", equal to hirschberg_split_fast"
    ms = device_ms(lambda: hs.hirschberg_split(out, *task), "hsplit_kernel")
    call_ms = cuda_ms(lambda: hs.hirschberg_split(out, *task), 5)
    b_ms, b_by = hsplit_bound(host_out, host_task)
    print(f"[phase 2] {name}: {len(task[0])} tasks, EBB={b.EBB} NB={b.NB} "
          f"{hs.hsplit_launch(len(task[0]), b.EBB, 132)} (warps a task, "
          f"tasks a CTA), {int(kern[3].sum())} feasible, bit-exact{msg}; "
          f"kernel {ms:.4f} ms (the call {call_ms:.4f} ms; bound "
          f"{b_ms:.5f} ms, {b_by}), plain on the host {plain_ms:.1f} ms")
    return dict(err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase2_deepband(gen, torch, pool):
    """The long-read path's kernels against their plain versions, which
    run on a host copy of the same staged tensors: carry-scan and
    systolic passes (8 pairs x 2 kbp: a full pass and Hirschberg half
    passes; one 25 kbp pair that recenters the systolic window), the
    split epilogue over an interleaved forward/reverse level batch, and
    the windowed bound at WINDOW_SHAPES (the shared/scratch cutover and
    past one warp)."""
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb
    from quicked_tpu_torch.ops import windowed_cuda as wc

    pairs = list(gen.generate_pairs(DEEP_PAIRS, SMALL_LEN, error=0.1,
                                    indels_num=4, indels_length=100,
                                    seed=SEED))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    res = {}
    (rp, rt), = gen.generate_pairs(1, RECENTER_LEN, error=0.1, seed=11)
    batches = {
        "score": prepare_banded_batch(
            pats, txts, [max(len(p), len(t)) * 40 // 100 for p, t in pairs],
            full=False),
        "midpoint": prepare_banded_batch(
            pats, txts, [max(len(p), len(t)) * 25 // 100 for p, t in pairs],
            full=False, text_finish=[(len(t) + 1) // 2 for t in txts]),
    }
    for name, b in batches.items():
        st = bc.stage_banded(b, "cuda")
        kern = host_tensors(cc.cscan_staged(st))
        ms = cuda_ms(lambda: cc.cscan_staged(st), 5)
        res[f"cscan_{name}"] = dict(ms=ms)
        print(f"[phase 2] cscan_{name}: B={st.B} EBB={st.EBB} NB={st.NB}, "
              f"kernel {ms:.3f} ms")
        plain_check(pool, f"cscan_{name}", kern, cc.banded_cscan_torch,
                    (bc.stage_banded(b, "cpu"),), res[f"cscan_{name}"])

    batches["recenter"] = prepare_banded_batch([rp], [rt], [RECENTER_CUTOFF],
                                               full=False)
    for name, b in batches.items():
        st = bc.stage_banded(b, "cuda")
        ms = cuda_ms(lambda: sb.sysband_raw(st), 5)
        res[f"sysband_{name}"] = dict(ms=ms)
        print(f"[phase 2] sysband_{name}: B={st.B} EBB={st.EBB} NB={st.NB} "
              f"NS={sb.geometry(st.EBB)[0]}, "
              f"{int(sb.sysband_raw(st)[1].sum())} ABORT lanes, kernel "
              f"{ms:.3f} ms")
        sysband_plain_check(pool, f"sysband_{name}", sb.sysband_raw(st),
                            bc.stage_banded(b, "cpu"), res[f"sysband_{name}"])

    # split epilogue: lane 2j forward, 2j+1 reverse half pass of task j
    il = ([], [], [], [])
    for p, t in pairs:
        mid = (len(t) + 1) // 2
        il[0].extend([p, p[::-1]])
        il[1].extend([t, t[::-1]])
        il[2].extend([max(len(p), len(t)) * 25 // 100] * 2)
        il[3].extend([mid, len(t) - mid])
    b = prepare_banded_batch(*il[:3], full=False, text_finish=il[3])
    res["hsplit"] = hsplit_check(
        "hsplit", b, bc.fill_staged(bc.stage_banded(b, "cuda")), torch)

    for ws, ovl in WINDOW_SHAPES:
        res.update(windowed_check(f"windowed_ws{ws}", pats, txts, ws, ovl,
                                  torch, pool))

    # the full-CIGAR mode, with a pure-deletion and a pure-insertion pair
    import numpy as np

    rng = np.random.default_rng(SEED + 90)
    d = "".join(rng.choice(list("ACGT"), 1500))
    fp, ft = pats + [d, d[400:700]], txts + [d[400:700], d]
    for ws, ovl in FULL_WINDOW_SHAPES:
        st = wc.stage_windowed(wc.prepare_windowed_batch(fp, ft,
                                                         window_size=ws),
                               "cuda")
        res.update(windowed_full_check(f"wfull_ws{ws}", st, ws, ovl, torch,
                                       pool))
    return res


def sysband_plain_check(pool, name, kern, host, entry):
    """The systolic pass's outputs `kern` (the raw pass and its ABORT
    flags, on the card) against its plain version on the host batch
    `host`: the ABORT flags equal, the other lanes on its contract."""
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    k_out, k_abort = host_tensors(kern[0]), kern[1].cpu()

    def compare(plain):
        p_out, p_abort = plain
        check(bool((k_abort == p_abort).all()),
              f"{name}: ABORT flags differ from the plain version")
        return band_err(k_out, p_out, (~p_abort).nonzero()[:, 0])
    plain_check(pool, name, None, sb.banded_sysband_torch, (host,), entry,
                compare)


# the windowed kernel's branches: ws 1 (ovl 0); the last window in shared
# memory (14) and the first in the scratch (15); 20; past one warp (33)
WINDOW_SHAPES = ((1, 0), (14, 1), (15, 1), (20, 1), (33, 1))
# the full-CIGAR mode's: ws 1 (ovl 0), 2, 9 (the default), 14, 15, 20
FULL_WINDOW_SHAPES = ((1, 0), (2, 1), (9, 1), (14, 1), (15, 1), (20, 1))


def windowed_check(name, pats, txts, ws, ovl, torch, pool, reps=5):
    """The windowed kernel on the pairs against its plain version on a
    host copy, (score, hew) bit-exact; its time by CUDA events."""
    from quicked_tpu_torch.ops import windowed_cuda as wc

    wb = wc.prepare_windowed_batch(pats, txts, window_size=ws)
    stw = wc.stage_windowed(wb, "cuda")
    cells = wc.hew_cell_threshold(ws, ovl, 40)
    kern = host_tensors(wc.windowed_score_staged(stw, ws, ovl, cells))
    ms = cuda_ms(lambda: wc.windowed_score_staged(stw, ws, ovl, cells), reps)
    _, (b_ms, b_by) = windowed_bound(stw, ws, ovl)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = wc.windowed_geometry(ws, len(pats), sms, wc.max_shared_bytes(0))
    entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[phase 2] {name}: ws={ws} ovl={ovl} B={len(pats)} "
          f"({geo.pairs_per_warp} per warp, "
          f"{'shared' if geo.shared_bytes else 'scratch'}), kernel {ms:.3f} "
          f"ms (bound {b_ms:.4f} ms, {b_by})")
    plain_check(pool, name, kern, wc.windowed_scan_torch,
                (wc.stage_windowed(wb, "cpu"), ws, ovl, cells), entry)
    return {name: entry}


def windowed_full_bound(st, ws, ovl):
    """(windows, (bound_ms, bound_by)) of a full-mode windowed launch: the
    score kernel's count of the fewest windows (`windowed_bound`), and the
    (B, MW, 64 ws) records of 3 bytes and the final cursors written."""
    from quicked_tpu_torch.ops import windowed_cuda as wc

    windows, _ = windowed_bound(st, ws, ovl)
    B = st.plen.numel()
    mw = wc.max_windows(st.pat_raw.shape[0], st.text_enc.shape[0], ws, ovl)
    nbytes = sum(x.numel() * x.element_size() for x in (
        st.peq, st.text_enc, st.text_raw, st.pat_raw, st.plen, st.tlen,
        st.num_words)) + B * mw * 64 * ws * 3 + 8 * B
    return windows, bound(nbytes, windows * 64 * ws * ws * OPS_PER_ADVANCE)


def windowed_full_check(name, st, ws, ovl, torch, pool, lanes=None,
                        reps=3, phase="phase 2"):
    """The full-mode windowed kernel on the staged CUDA batch `st`
    against its plain version on a host copy of lanes `lanes` (or all),
    records and cursors bit-exact; its time (zeroing the records and the
    pair-major copies included) by CUDA events, with its bound."""
    from quicked_tpu_torch.ops import windowed_cuda as wc

    B = st.plen.numel()
    idx = torch.arange(B) if lanes is None else torch.tensor(lanes)
    kern = [x[idx.cuda()].cpu()
            for x in wc.windowed_full_staged(st, ws, ovl)]
    ms = cuda_ms(lambda: wc.windowed_full_staged(st, ws, ovl), reps)
    windows, (b_ms, b_by) = windowed_full_bound(st, ws, ovl)
    entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    which = "all lanes" if lanes is None else f"lanes {lanes}"
    print(f"[{phase}] {name}: ws={ws} ovl={ovl} B={B} "
          f"T={st.text_enc.shape[0]}, at least {windows} windows, records "
          f"{tuple(kern[0].shape[1:])} a pair, max run {int(kern[0].max())}"
          f", {which} to the plain version: kernel {ms:.3f} ms (bound "
          f"{b_ms:.4f} ms, {b_by})")
    plain_check(pool, name, kern, wc.windowed_full_torch,
                (select_windowed(st, idx), ws, ovl), entry)
    return {name: entry}


def phase2_batches(gen, torch, pool):
    """The windowed kernel on batches of 1, 17 and more than 132 pairs
    (1, 4 and 32 pairs per warp: partial segments and CTAs), the plain
    version on a host copy."""
    res = {}
    one = list(gen.generate_pairs(1, SMALL_LEN, error=0.1, indels_num=2,
                                  indels_length=100, seed=SEED + 70))
    small = list(gen.generate_pairs(140, 150, error=0.1, seed=SEED + 71))
    tiny = list(gen.generate_pairs(4300, 90, error=0.1, seed=SEED + 72))
    for name, ws, ovl, pairs in (("b1", 9, 1, one), ("b17", 2, 1, small[:17]),
                                 ("b140", 2, 1, small),
                                 ("b700", 2, 1, small * 5),
                                 ("b4300", 1, 0, tiny)):
        res.update(windowed_check(f"windowed_{name}", [p for p, _ in pairs],
                                  [t for _, t in pairs], ws, ovl, torch,
                                  pool, reps=3))
    return res


def synthetic_planes(EBB, T, B, seed, ones=0.93):
    """The traceback's inputs over random planes: Pv bits one at the rate
    `ones` (long D-runs), random Mv, characters, band offsets and lengths
    (a pattern of the band's full depth, a text of T columns, an empty
    text). The walk is defined on any planes, so this reaches depths the
    fill's geometry never gives (EBB 1). Host tensors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    bits = rng.random((T, EBB, B, 64)) < ones
    pv = torch.from_numpy((bits * (1 << np.arange(64, dtype=np.uint64)))
                          .sum(-1).astype(np.uint64).view(np.int64))
    mv = torch.from_numpy(rng.integers(0, 2**63, (T, EBB, B),
                                       dtype=np.int64))
    PP = EBB * 64 + 100
    acgt = np.frombuffer(b"ACGT", np.uint8)
    praw = torch.from_numpy(rng.choice(acgt, (PP, B)))
    traw = torch.from_numpy(rng.choice(acgt, (T, B)))
    plen = torch.tensor(rng.integers(0, PP + 1, B), dtype=torch.int32)
    tlen = torch.tensor(rng.integers(0, T + 1, B), dtype=torch.int32)
    plen[0], tlen[1], tlen[-1] = PP, T, 0
    prolog = torch.tensor(rng.integers(0, min(EBB, 3) + 1, B),
                          dtype=torch.int32)
    return pv, mv, praw, traw, plen, tlen, prolog


def traceback_check(name, dev_args, host_args, torch, pool, lanes=None,
                    reps=3, phase="phase 2"):
    """The traceback kernel on `dev_args` against its plain version on the
    host copy `host_args` (of lanes `lanes` of the batch, or all of it),
    every output bit-exact; its time on the whole batch by CUDA events and
    its bound."""
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc

    kern = btc.traceback_records(*dev_args)
    idx = slice(None) if lanes is None else torch.tensor(lanes).cuda()
    ms = cuda_ms(lambda: btc.traceback_records(*dev_args), reps)
    b_ms, b_by = traceback_bound(dev_args[0], kern)
    T, EBB, B = dev_args[0].shape
    entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    which = "all lanes" if lanes is None else f"lanes {lanes}"
    print(f"[{phase}] {name}: B={B} T={T} EBB={EBB}, max run "
          f"{int(kern[0].max())}, {which} to the plain version: kernel "
          f"{ms:.3f} ms (bound {b_ms:.4f} ms, {b_by})")
    plain_check(pool, name, [k[..., idx].cpu() for k in kern],
                btc.traceback_records_torch, host_args, entry)
    return {name: entry}


def traceback_bound(mat_pv, out):
    """Bound of one traceback call: per walked column a Pv and an Mv word
    and two characters read, every column's 5-byte record written."""
    T, _, B = mat_pv.shape
    runs, opcs = out[:2]
    walked = int(((opcs != 0) | (runs != 0)).sum())
    return bound(walked * (8 + 8 + 1 + 1) + T * B * 5 + B * 20)


def phase2_traceback(gen, torch, pool):
    """The traceback kernel at its branches, the plain version on a host
    copy: one pair (B = 1) with a 500-row D-run (eight words, past the
    staged window), filled on the card; random planes at EBB 1, 128 and
    7300 whose D-runs reach band words far below the cursor (read from
    device memory)."""
    import numpy as np

    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch

    res = {}
    rng = np.random.default_rng(SEED + 80)
    s = "".join(rng.choice(list("ACGT"), 1400))
    z = "".join(rng.choice(list("ACGT"), 500))
    b = prepare_banded_batch([s + z], [s], [600], full=True)
    out = bc.fill_staged(bc.stage_banded(b, "cuda"))
    praw, traw = btc.prep_raw_frames([(s + z).encode()], [s.encode()],
                                     out["mat_pv"].shape[0], len(s + z))
    lanes = [torch.tensor(a, dtype=torch.int32)
             for a in (b.plen, b.tlen, b.prolog)]
    host = (out["mat_pv"].cpu(), out["mat_mv"].cpu(), torch.from_numpy(praw),
            torch.from_numpy(traw), *lanes)
    dev = (out["mat_pv"], out["mat_mv"]) + tuple(x.cuda() for x in host[2:])
    res.update(traceback_check("traceback_del500", dev, host, torch, pool))
    check(int(btc.traceback_records(*dev)[0].max()) == 500,
          "traceback_del500: no 500-row D-run")
    for ebb, t, ones in ((1, 200, 0.93), (1, 200, 0.99), (128, 200, 0.93),
                         (128, 200, 0.99), (7300, 64, 0.99)):
        host = synthetic_planes(ebb, t, 5 if ebb < 7300 else 2, ebb, ones)
        res.update(traceback_check(
            f"traceback_ebb{ebb}_{int(ones * 100)}",
            tuple(x.cuda() for x in host), host, torch, pool))
    return res


def record_levels(long_pairs):
    """One run of the long-read phase's pairs through the aligner, keeping
    each Hirschberg split level batch it hands the split (interleaved
    forward/reverse lanes, with the family of its score pass: level 1 on
    the systolic pass, the later ones on the fill) and its first stage-4
    base-case chunk (a full fill)."""
    from quicked_tpu_torch.aligner import batch as qb
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.params import QuickedParams

    levels, chunks = [], []
    real_split, real_prep = qb._hsplit_fused, qb.prepare_banded_batch

    def recording(batch, dev, family):
        levels.append((batch, family))
        return real_split(batch, dev, family)

    def prep(*args, **kw):
        b = real_prep(*args, **kw)
        if b.full and not chunks:
            chunks.append(b)
        return b

    qb._hsplit_fused, qb.prepare_banded_batch = recording, prep
    try:
        BatchAligner(QuickedParams(), device="cuda").align(long_pairs)
    finally:
        qb._hsplit_fused, qb.prepare_banded_batch = real_split, real_prep
    check(levels, "the long-read run split no level")
    check(chunks, "the long-read run filled no base case")
    print("[phase 2] the long-read run's split levels (lanes, EBB, NB, "
          "family): " + ", ".join(f"({b.B}, {b.EBB}, {b.NB}, {f})"
                                  for b, f in levels))
    return levels, chunks[0]


def deep_plain_check(name, st, b, lanes, torch, pool, cscan_plain=True):
    """Systolic and carry-scan kernels on lanes `lanes` of the CUDA batch
    `st` (staged from the BandedBatch `b`) against their plain versions
    on a host copy of the same lanes: ABORT flags equal, the systolic pass
    on its contract, the carry-scan pass on every key. Returns the result
    entries of both kernels."""
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    idx = torch.tensor(lanes)
    host = bc.select_lanes(bc.stage_banded(b, "cpu"), idx)
    sel = bc.select_lanes(st, idx.cuda())
    sys_ms = cuda_ms(lambda: sb.sysband_raw(sel), 3)
    n_abort = int(sb.sysband_raw(sel)[1].sum())
    entry = dict(ms=sys_ms)
    entry.update(zip(("bound_ms", "bound_by"), banded_bound(sel)))
    res = {f"sysband_{name}": entry}
    sysband_plain_check(pool, f"sysband_{name}", sb.sysband_raw(sel), host,
                        entry)
    msg = (f"[phase 2] {name}, lanes {lanes} to the plain versions: sysband "
           f"{sys_ms:.3f} ms ({n_abort} ABORT lanes)")
    if cscan_plain:
        cs_ms = cuda_ms(lambda: cc.cscan_staged(sel), 3)
        res[f"cscan_{name}"] = dict(ms=cs_ms)
        plain_check(pool, f"cscan_{name}", host_tensors(cc.cscan_staged(sel)),
                    cc.banded_cscan_torch, (host,), res[f"cscan_{name}"])
        msg += f", cscan {cs_ms:.3f} ms"
    print(msg)
    return res


def phase2_fulldepth(levels, torch, pool):
    """Systolic and carry-scan passes against the fill kernel on the
    long-read phase's deep level 1 (its largest batch on the systolic
    pass), the only place recentering and deep bands meet at full size;
    then both against their plain versions on two of its lanes (a forward
    half pass of a pair with large indels, a reverse one without)."""
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    deep = [b for b, family in levels if family == "sysband"]
    check(deep, "no split level on the systolic pass")
    b = max(deep, key=lambda x: x.B)
    st = bc.stage_banded(b, "cuda")
    fill = bc.fill_staged(st)
    before = sb.SYSBAND.fallbacks
    sysb = sb.sysband_staged(st)
    aborts = sb.SYSBAND.fallbacks - before
    cscan = cc.cscan_staged(st)
    torch.cuda.synchronize()
    lanes = torch.arange(st.B)
    err_sys = band_err(sysb, fill, lanes)
    err_cs = max(max_abs_err(cscan[k], fill[k]) for k in fill)
    check(err_sys == 0, "full depth: systolic pass disagrees with the fill")
    check(err_cs == 0, "full depth: carry-scan pass disagrees with the fill")
    fill_ms = cuda_ms(lambda: bc.fill_staged(st), 2)
    sys_ms = cuda_ms(lambda: sb.sysband_staged(st), 3)
    cs_ms = cuda_ms(lambda: cc.cscan_staged(st), 3)
    NS = sb.geometry(st.EBB)[0]
    steps = sb.total_steps(st.NB, NS)
    print(f"[phase 2] full depth: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"NS={NS}: systolic (aborts {aborts}) and "
          f"carry-scan equal to the fill kernel; fill {fill_ms:.3f} ms, "
          f"sysband {sys_ms:.3f} ms ({per_step(sys_ms, steps)}), "
          f"cscan {cs_ms:.3f} ms ({per_step(cs_ms, st.NB * 64)})")
    res = dict(fulldepth_sysband=dict(err=err_sys, ms=sys_ms),
               fulldepth_cscan=dict(err=err_cs, ms=cs_ms),
               fulldepth_fill=dict(ms=fill_ms))
    res.update(deep_plain_check("level1", st, b, [0, st.B - 1], torch, pool))
    return res


def phase2_levels(levels, chunk, torch, pool):
    """The split epilogue and the fill at the shapes the long-read phase
    gives them (`record_levels`): each split level's score pass run again
    (the family the route gave it, the systolic pass's ABORT lanes by the
    carry-scan pass), then the split, held to the plain split on a host
    copy of the pass's outputs, and on a deep level to
    hirschberg_split_fast on the same words; the fill timed on every fill
    level and on the base-case chunk, and held to its plain version on
    two lanes of the fill level with the fewest column blocks and on one
    lane of the chunk."""
    from quicked_tpu_torch.aligner import batch as qb
    from quicked_tpu_torch.ops import banded_cuda as bc

    res = {}
    fills = [i for i, (_, f) in enumerate(levels, 1) if f == "fill"]
    small = min(fills, key=lambda i: levels[i - 1][0].NB) if fills else 0
    for i, (b, family) in enumerate(levels, 1):
        st = bc.stage_banded(b, "cuda")
        res[f"hsplit_level{i}"] = hsplit_check(
            f"hsplit_level{i} ({family})", b, qb.score_staged(st, family),
            torch, spec=family != "fill")
        if family != "fill":
            continue
        if i == small:
            res[f"fill_level{i}"] = fill_plain_check(
                f"fill_level{i}", st, b, [0, 1], torch, pool)
        else:
            ms = cuda_ms(lambda: bc.fill_staged(st), 3)
            b_ms, b_by = banded_bound(st)
            res[f"fill_level{i}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            print(f"[phase 2] fill_level{i}: B={st.B} EBB={st.EBB} "
                  f"NB={st.NB}: kernel {ms:.3f} ms (bound {b_ms:.3f} ms, "
                  f"{b_by})")
    res["fill_basecase"] = fill_plain_check(
        "fill_basecase", bc.stage_banded(chunk, "cuda"), chunk, [0], torch,
        pool)
    return res


def phase2_wide(gen, torch, pool):
    """The systolic kernel's 4- and 16-rows-per-thread instantiations
    (resident windows over 1024 and 4096 rows), which no bucket of the
    long-read phase reaches: two pairs each, the systolic pass against the
    carry-scan pass (its 4- and 16-blocks-per-thread stripes) on the card,
    and lane 0 against the plain versions on a host copy. The fill on the
    same batches (14 warps per pair at EBB ~1690; at EBB ~7970 the band
    walked in four rounds per column) against the carry-scan pass, every
    output equal."""
    import numpy as np

    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    res = {}
    for name, (tlen, insert, cutoff, min_ns) in WIDE.items():
        rng = np.random.default_rng(SEED + 50)
        pats, txts = [], []
        for p, t in gen.generate_pairs(2, tlen, error=0.1, seed=SEED + 50):
            ins = "".join(rng.choice(list("ACGT"), insert))
            pats.append(p[:len(p) // 2] + ins + p[len(p) // 2:])
            txts.append(t)
        b = prepare_banded_batch(pats, txts, [cutoff] * 2, full=False)
        NS = sb.geometry(b.EBB)[0]
        check(NS > min_ns, f"{name}: {NS} resident rows, not over {min_ns}")
        st = bc.stage_banded(b, "cuda")
        k_sys, k_abort = sb.sysband_raw(st)
        k_cs = cc.cscan_staged(st)
        k_fill = bc.fill_staged(st)
        torch.cuda.synchronize()
        ok = (~k_abort).nonzero()[:, 0].cpu()
        err = band_err(k_sys, k_cs, ok)
        check(err == 0, f"{name}: systolic and carry-scan passes disagree")
        err_fill = max(max_abs_err(k_fill[k], k_cs[k]) for k in k_cs)
        check(err_fill == 0, f"{name}: fill and carry-scan passes disagree")
        del k_fill
        fill_ms = cuda_ms(lambda: bc.fill_staged(st), 2)
        print(f"[phase 2] {name}: B={st.B} EBB={st.EBB} NB={st.NB} NS={NS}: "
              f"sysband equal to cscan on {len(ok)} lanes, the fill equal "
              f"to cscan on every lane (fill {fill_ms:.3f} ms)")
        res[f"cscan_vs_sysband_{name}"] = dict(err=err)
        res[f"fill_{name}"] = dict(err=err_fill, ms=fill_ms)
        res.update(deep_plain_check(name, st, b, [0], torch, pool,
                                    cscan_plain=insert == 0))
    return res


def phase2_banded(gen, torch, pool):
    """The carry-scan pass at the shape of phase 5's BANDED score run
    (the same 16 pairs x 30 kbp at bandwidth 15), against its plain
    version on a host copy."""
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc

    bpairs = banded_pairs(gen)
    b = prepare_banded_batch([p for p, _ in bpairs], [t for _, t in bpairs],
                             [max(len(p), len(t)) * 15 // 100
                              for p, t in bpairs], full=False)
    st = bc.stage_banded(b, "cuda")
    ms = cuda_ms(lambda: cc.cscan_staged(st), 5)
    b_ms, b_by = banded_bound(st)
    entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
    print(f"[phase 2] cscan_banded: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"({cc.cscan_launch(st.EBB)}), kernel {ms:.3f} ms (bound "
          f"{b_ms:.4f} ms, {b_by}), {per_step(ms, st.NB * 64)}")
    plain_check(pool, "cscan_banded", host_tensors(cc.cscan_staged(st)),
                cc.banded_cscan_torch, (bc.stage_banded(b, "cpu"),), entry)
    return dict(cscan_banded=entry)


def banded_pairs(gen):
    return list(gen.generate_pairs(BANDED_PAIRS, BANDED_LEN, error=0.1,
                                   seed=SEED + 40))


def make_pairs(gen, n, length, seed):
    half = n // 2
    pairs = list(gen.generate_pairs(half, length, error=0.1,
                                    indels_num=4, indels_length=500,
                                    seed=seed))
    pairs += list(gen.generate_pairs(n - half, length, error=0.1,
                                     seed=seed + 1))
    return pairs


def kernels():
    """Every kernel of the port by its name in the kernels line."""
    from quicked_tpu_torch.ops import banded_cscan_cuda, banded_cuda
    from quicked_tpu_torch.ops import banded_sysband_cuda
    from quicked_tpu_torch.ops import banded_traceback_cuda
    from quicked_tpu_torch.ops import hirschberg_split_cuda, windowed_cuda

    return {"banded_fill": banded_cuda.FILL,
            "banded_traceback": banded_traceback_cuda.TRACEBACK,
            "windowed_score": windowed_cuda.WINDOWED,
            "banded_cscan": banded_cscan_cuda.CSCAN,
            "banded_sysband": banded_sysband_cuda.SYSBAND,
            "hirschberg_split": hirschberg_split_cuda.HSPLIT,
            "windowed_full": windowed_cuda.WINDOWED_FULL}


def run_counted(fn, torch):
    """(result, wall seconds, launches per kernel, systolic ABORT lanes)
    of fn(), with every count set to 0 just before it."""
    for k in kernels().values():
        k.launches = 0
        k.fallbacks = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ks = kernels()
    return (res, wall, {name: k.launches for name, k in ks.items()},
            ks["banded_sysband"].fallbacks)


def report_run(tag, pairs, wall, launches, timers):
    bases = sum(max(len(p), len(t)) for p, t in pairs)
    stages = {name: getattr(timers, name).total_ns() / 1e9
              for name in ("windowed_s", "windowed_l", "banded", "align")}
    print(f"[{tag}] {len(pairs)} pairs x ~{len(pairs[0][1])} bp: "
          f"{wall:.3f} s, {len(pairs) / wall:.1f} pairs/s, "
          f"{bases / wall:.4g} aligned bases/s")
    print(f"[{tag}] stage seconds " + json.dumps(stages))
    print(f"[{tag}] launches " + json.dumps(launches))


def windowed_bound(st, ws, ovl):
    """(windows, (bound_ms, bound_by)) of a windowed launch over the
    staged batch `st`: its inputs read once and (score, hew) written once;
    64 ws x ws Myers advances a window, over the fewest windows the walk
    can take. A window moves each cursor back by at most 64 (ws - ovl)
    and the walk ends when one of them passes 0, so a pair walks at least
    ceil(min(plen, tlen) / (64 (ws - ovl))) windows."""
    import torch

    stride = 64 * max(ws - ovl, 1)
    shortest = torch.minimum(st.plen, st.tlen).long()
    windows = int(((shortest + stride - 1) // stride).sum())
    nbytes = sum(x.numel() * x.element_size() for x in (
        st.peq, st.text_enc, st.text_raw, st.pat_raw, st.plen, st.tlen,
        st.num_words)) + 8 * st.plen.numel()
    return windows, bound(nbytes, windows * 64 * ws * ws * OPS_PER_ADVANCE)


class Recorder:
    """While active, records what the main path hands the windowed,
    traceback and deep-band kernels: every windowed batch with its outputs
    (by wrapping `windowed_cuda.windowed_score_staged`), the traceback
    inputs and outputs of the first chunk, or of the largest (by wrapping
    `banded_traceback_cuda.traceback_records`), and every score batch the
    route sends to the systolic or carry-scan kernel, as its host
    `BandedBatch` with the family and the lanes the systolic pass aborted
    (by wrapping the aligner's `stage_banded` and `score_staged`), and the
    arguments of every split epilogue call, a score pass's outputs on the
    card among them (by wrapping the aligner's `hirschberg_split`), and
    the largest full-fill `BandedBatch` the aligner staged (`full`)."""

    def __init__(self, largest_chunk):
        self.largest = largest_chunk
        self.windowed = []
        self.chunk = None
        self.full = None
        self.deep = []          # (BandedBatch, family, ABORT lanes)
        self.hsplit = []        # the split epilogue's arguments, per level

    def __enter__(self):
        from quicked_tpu_torch.aligner import batch as qb
        from quicked_tpu_torch.ops import banded_sysband_cuda as sb
        from quicked_tpu_torch.ops import banded_traceback_cuda as btc
        from quicked_tpu_torch.ops import windowed_cuda as wc

        self.real = (wc.windowed_score_staged, btc.traceback_records,
                     qb.stage_banded, qb.score_staged, qb.hirschberg_split)
        last = [None, None]     # the staged batch and its host batch

        def windowed(st, WS, OVL, cells):
            out = self.real[0](st, WS, OVL, cells)
            self.windowed.append((st, WS, OVL, cells, out))
            return out

        def traceback(*args):
            out = self.real[1](*args)
            size = args[0].numel()
            if self.chunk is None or (self.largest and
                                      size > self.chunk[0][0].numel()):
                self.chunk = (args, out)
            return out

        def stage(batch, dev):
            last[:] = [self.real[2](batch, dev), batch]
            size = batch.B * batch.NB * batch.EBB
            if batch.full and (self.full is None or size > self.full.B *
                               self.full.NB * self.full.EBB):
                self.full = batch
            return last[0]

        def score(st, family):
            before = sb.SYSBAND.fallbacks
            out = self.real[3](st, family)
            if family != "fill" and st is last[0]:
                self.deep.append((last[1], family,
                                  sb.SYSBAND.fallbacks - before))
            return out

        def split(out, prolog, plen, tlen):
            self.hsplit.append((out, prolog, plen, tlen))
            return self.real[4](out, prolog, plen, tlen)

        wc.windowed_score_staged, btc.traceback_records = windowed, traceback
        qb.stage_banded, qb.score_staged = stage, score
        qb.hirschberg_split = split
        return self

    def __exit__(self, *exc):
        from quicked_tpu_torch.aligner import batch as qb
        from quicked_tpu_torch.ops import banded_traceback_cuda as btc
        from quicked_tpu_torch.ops import windowed_cuda as wc

        (wc.windowed_score_staged, btc.traceback_records, qb.stage_banded,
         qb.score_staged, qb.hirschberg_split) = self.real


def record_run(pairs, largest_chunk, params=None):
    """A `Recorder` over one more run of `pairs` through the aligner (with
    `params`, default QuickedParams()), so that the timed runs go without
    the memory it holds on the card."""
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.params import QuickedParams

    with Recorder(largest_chunk) as rec:
        BatchAligner(params or QuickedParams(), device="cuda").align(pairs)
    return rec


def windowed_host_c(st, ws, ovl, cells, out, hew_threshold):
    """Every pair of a recorded windowed batch: the kernel's (score, hew)
    against the host C qh_windowed_score on the same sequences."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from quicked_tpu_torch import dna, native
    from quicked_tpu_torch.ops import windowed_cuda as wc

    check(wc.hew_cell_threshold(ws, ovl, hew_threshold) == cells,
          f"recorded windowed batch: {cells} HEW cells at ws {ws} is not "
          f"the {hew_threshold}% threshold")
    plen, tlen = st.plen.cpu().numpy(), st.tlen.cpu().numpy()
    pat = st.pat_raw.cpu().numpy().astype(np.uint8)
    txt = st.text_raw.cpu().numpy().astype(np.uint8)

    def one(b):
        p = pat[:plen[b], b].tobytes()
        t = txt[:tlen[b], b].tobytes()
        return native.windowed_score(dna.encode(p.decode()), p,
                                     dna.encode(t.decode()), t, ws, ovl,
                                     hew_threshold)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        want = list(ex.map(one, range(len(plen))))
    got = list(zip(out[0].cpu().tolist(), out[1].cpu().tolist()))
    bad = [b for b in range(len(plen)) if got[b] != want[b]]
    check(not bad, f"windowed pairs {bad[:5]}: kernel differs from the host "
          f"C qh_windowed_score")
    return len(plen)


def select_windowed(st, lanes):
    """A host copy of lanes `lanes` of a staged windowed batch."""
    from quicked_tpu_torch.ops import windowed_cuda as wc

    idx = lanes.to(st.peq.device)
    return wc.StagedWindowed(*(x[..., idx].cpu() for x in (
        st.peq, st.text_enc, st.text_raw, st.pat_raw, st.plen, st.tlen,
        st.num_words)))


def check_recorded(tag, rec, torch, pool, plain=False):
    """At the shapes one slice's run handed the two kernels: every pair of
    every windowed batch against the host C windowed bound, each batch
    timed with its bound (and, with `plain`, the stage-2 forward batch
    held to the plain version on two lanes of a host copy); the recorded
    traceback chunk against its plain version on two lanes of a host
    copy, timed with its bound."""
    from quicked_tpu_torch.ops import windowed_cuda as wc
    from quicked_tpu_torch.params import QuickedParams

    params = QuickedParams()
    res = {}
    check(len(rec.windowed) >= 3, f"{tag}: {len(rec.windowed)} windowed "
          f"batches recorded, expected stage 1 and stage 2 both ways")
    for i, (st, ws, ovl, cells, out) in enumerate(rec.windowed):
        thr = params.hew_threshold[0 if i == 0 else 1]
        n = windowed_host_c(st, ws, ovl, cells, out, thr)
        ms = cuda_ms(lambda: wc.windowed_score_staged(st, ws, ovl, cells), 3)
        windows, (b_ms, b_by) = windowed_bound(st, ws, ovl)
        name = f"windowed_{tag}_{i + 1}"
        entry = dict(err=0, ms=ms, bound_ms=b_ms, bound_by=b_by)
        msg = ""
        if plain and i == 1:
            lanes = torch.tensor([0, n - 1])
            plain_check(pool, name, [o[lanes.to(o.device)].cpu() for o in out],
                        wc.windowed_scan_torch,
                        (select_windowed(st, lanes), ws, ovl, cells), entry)
            msg = f"; lanes 0, {n - 1} to the plain version"
        res[name] = entry
        print(f"[recorded] {name}: ws={ws} B={n} T={st.text_enc.shape[0]}, "
              f"at least {windows} windows, all pairs equal to the host C "
              f"windowed bound{msg}; kernel {ms:.3f} ms (bound {b_ms:.4f} "
              f"ms, {b_by})")
    check(rec.chunk is not None, f"{tag}: no traceback chunk recorded")
    args, _ = rec.chunk
    B = args[0].shape[2]
    lanes = [0, B - 1]
    idx = torch.tensor(lanes, device=args[0].device)
    host = tuple(x[..., idx].cpu() for x in args)
    res.update(traceback_check(f"traceback_{tag}", args, host, torch, pool,
                               lanes=lanes, phase="recorded"))
    return res


def per_step(ms, steps):
    """A launch's time per dependent step (a systolic step, a carry-scan
    column): microseconds and cycles at the card's maximum SM clock."""
    us = ms * 1e3 / steps
    cyc = f", {us * MAX_SM_MHZ:.0f} cycles" if MAX_SM_MHZ else ""
    return f"{us:.4f} us a step over {steps} steps{cyc}"


def check_deep(tag, rec, torch, pool, stage3=False):
    """Every deep-band batch one slice's run handed the systolic or
    carry-scan kernel (recorded by `Recorder`), staged anew: each timed
    with its bound, with its ABORT lanes in that run; with `stage3`, the
    first batch must be systolic (stage 3) and is held to the plain version
    on its first and last lanes, on a host copy."""
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    res, seen = {}, {}
    if stage3:
        check(rec.deep and rec.deep[0][1] == "sysband",
              f"{tag}: stage 3 sent no batch to the systolic kernel")
    for b, family, aborts in rec.deep:
        seen[family] = seen.get(family, 0) + 1
        name = f"{family}_{tag}_{seen[family]}"
        st = bc.stage_banded(b, "cuda")
        if family == "sysband":
            geo = sb.sysband_launch(st.EBB)
            steps = sb.total_steps(st.NB, geo.NS)
            fn = lambda: sb.sysband_raw(st)
            how = (f"NS={geo.NS}, {geo.rows_per_thread} rows a thread, "
                   f"words in {geo.words}")
        else:
            geo = cc.cscan_launch(st.EBB)
            steps = st.NB * 64
            fn = lambda: cc.cscan_staged(st)
            how = f"S={geo.S}, {geo.threads} threads, {geo.rounds} round(s)"
        ms = cuda_ms(fn, 3)
        b_ms, b_by = banded_bound(st)
        entry = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
        msg = ""
        if stage3 and seen[family] == 1 and family == "sysband":
            lanes = sorted({0, st.B - 1})
            idx = torch.tensor(lanes)
            sysband_plain_check(
                pool, name, sb.sysband_raw(bc.select_lanes(st, idx.cuda())),
                bc.select_lanes(bc.stage_banded(b, "cpu"), idx), entry)
            msg = f"; lanes {lanes} to the plain version"
        res[name] = entry
        print(f"[recorded] {name}: B={st.B} EBB={st.EBB} NB={st.NB} ({how}), "
              f"{aborts} ABORT lanes in the run{msg}; kernel {ms:.3f} ms "
              f"(bound {b_ms:.4f} ms, {b_by}), {per_step(ms, steps)}")
        del st
    return res


def phase3(gen, args, torch):
    """The slice at real size, held against the host C cascade; then the
    fill's time on the run's largest full-fill chunk (recorded as the run
    prepares it)."""
    from quicked_tpu_torch import native
    from quicked_tpu_torch.aligner import batch as qb
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.utils.profiler import PhaseTimers

    check(native.available(), "the host C library is needed as the oracle")
    pairs = make_pairs(gen, args.pairs, args.length, SEED + 10)
    params = QuickedParams()
    timers = PhaseTimers()
    aligner = BatchAligner(params, device="cuda")
    chunks = []
    real_prep = qb.prepare_banded_batch

    def prep(*a, **kw):
        b = real_prep(*a, **kw)
        if b.full:
            chunks.append(b)
        return b

    qb.prepare_banded_batch = prep
    try:
        res, wall, launches, _ = run_counted(
            lambda: aligner.align(pairs, timers=timers), torch)
    finally:
        qb.prepare_banded_batch = real_prep
    report_run("phase 3", pairs, wall, launches, timers)
    for name in ("banded_fill", "banded_traceback", "windowed_score"):
        check(launches[name] > 0, f"phase 3 never launched {name}")

    wip = 1    # run_quicked returns QUICKED_WIP on success (quicked.c:305)
    check(all(int(s) == wip for s in res.status), "a status is not WIP")
    want, over = host_cascade(pairs, params)
    for i, (sc, cig) in enumerate(want):
        check(int(res.score[i]) == sc and res.cigar[i] == cig,
              f"pair {i}: port differs from the oracle")
    print(f"[phase 3] oracle: host C cascade, {len(pairs)} pairs equal "
          f"({over} over the budget, finished by its Hirschberg)")

    b = max(chunks, key=lambda c: c.B * c.NB * c.EBB)
    st = bc.stage_banded(b, "cuda")
    ms = cuda_ms(lambda: bc.fill_staged(st), 3)
    b_ms, b_by = banded_bound(st)
    print(f"[phase 3] fill on the largest of {len(chunks)} full-fill "
          f"chunks: B={st.B} EBB={st.EBB} NB={st.NB}: kernel {ms:.3f} ms "
          f"(bound {b_ms:.3f} ms, {b_by})")
    return pairs, launches, dict(fill_10kbp_chunk=dict(
        ms=ms, bound_ms=b_ms, bound_by=b_by)), wall, want, res


def host_cascade(pairs, params):
    """The host C cascade's (score, CIGAR) per pair: quicked_batch, and
    its Hirschberg under the proven bound for the pairs whose band is
    over the 16 MB budget (qh_align's QUICKED path), on every host core."""
    from concurrent.futures import ThreadPoolExecutor

    from quicked_tpu_torch import dna, native
    from quicked_tpu_torch.cigar import Cigar
    from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE

    st, sc, rles = native.quicked_batch(
        [p for p, _ in pairs], [t for _, t in pairs],
        bandwidth=params.bandwidth, window_size=params.window_size,
        overlap_size=params.overlap_size,
        hew_threshold=params.hew_threshold,
        hew_percentage=params.hew_percentage,
        budget=HIRSCHBERG_BUFFER_SIZE, rle=True)
    over = [i for i in range(len(pairs)) if st[i] != 0]

    def hirschberg(i):
        p, t = pairs[i]
        return native.hirschberg(dna.encode(p), p.encode(), dna.encode(t),
                                 t.encode(), int(sc[i]),
                                 HIRSCHBERG_BUFFER_SIZE)[1]

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        ops = dict(zip(over, ex.map(hirschberg, over)))
    want = []
    for i in range(len(pairs)):
        if i in ops:
            c = Cigar(operations=ops[i] or "")
            want.append((c.score_edit(),
                         c.sprint(True) if ops[i] else None))
        else:
            want.append((int(sc[i]), rles[i] or None))
    return want, len(over)


def phase5(gen, pairs, torch):
    """The long-read path at real size, held against the host C cascade;
    then BANDED score-only over 16 pairs x 30 kbp (the carry-scan pass)
    against the host C banded kernel."""
    from quicked_tpu_torch import native
    from quicked_tpu_torch.native import run_banded_native
    from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                            prepare_banded_batch)
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams
    from quicked_tpu_torch.utils.profiler import PhaseTimers
    from quicked_tpu_torch.api import BatchAligner

    check(native.available(), "the host C library is needed as the "
          "long-read oracle")
    from quicked_tpu_torch.ops import myers_np

    params = QuickedParams()
    timers = PhaseTimers()
    aligner = BatchAligner(params, device="cuda")
    host_splits = []        # midpoints searched on the host: none
    real_fast = myers_np.hirschberg_split_fast

    def fast(*a):
        host_splits.append(a)
        return real_fast(*a)

    myers_np.hirschberg_split_fast = fast
    try:
        res, wall, launches, aborts = run_counted(
            lambda: aligner.align(pairs, timers=timers), torch)
    finally:
        myers_np.hirschberg_split_fast = real_fast
    report_run("phase 5", pairs, wall, launches, timers)
    print(f"[phase 5] systolic ABORT lanes recomputed by the carry-scan "
          f"pass: {aborts}; split levels on the card: "
          f"{launches['hirschberg_split']}, midpoints searched on the host: "
          f"{len(host_splits)}")
    for name in ("banded_sysband", "hirschberg_split", "banded_fill",
                 "banded_traceback", "windowed_score"):
        check(launches[name] > 0, f"phase 5 never launched {name}")
    check(not host_splits, "phase 5 searched a midpoint on the host")
    wip = 1    # run_quicked returns QUICKED_WIP on success (quicked.c:305)
    check(all(int(s) == wip for s in res.status), "a status is not WIP")
    (want, over), oracle_ms = host_ms(lambda: host_cascade(pairs, params))
    for i, (sc, cig) in enumerate(want):
        check(int(res.score[i]) == sc and res.cigar[i] == cig,
              f"long-read pair {i}: port differs from the oracle")
    print(f"[phase 5] oracle: host C cascade, {len(pairs)} pairs equal "
          f"({over} over the budget, finished by its Hirschberg), "
          f"{oracle_ms / 1e3:.1f} s on the host")

    bpairs = banded_pairs(gen)
    bparams = QuickedParams(algo=QuickedAlgo.BANDED, only_score=True,
                            bandwidth=15)
    bres, bwall, blaunches, _ = run_counted(
        lambda: BatchAligner(bparams, device="cuda").align(bpairs), torch)
    print(f"[phase 5] BANDED score-only, {len(bpairs)} pairs x "
          f"{BANDED_LEN} bp: {bwall:.3f} s, launches "
          + json.dumps(blaunches))
    check(blaunches["banded_cscan"] > 0, "BANDED score run never launched "
          "banded_cscan")
    pats = [p for p, _ in bpairs]
    txts = [t for _, t in bpairs]
    b = prepare_banded_batch(pats, txts, [max(len(p), len(t)) * 15 // 100
                                          for p, t in bpairs], full=False)
    bwant = extract_final_scores(b, run_banded_native(b)["scores_by_k"])
    check([int(x) for x in bres.score] == [int(x) for x in bwant],
          "BANDED score run differs from the host C banded kernel")
    print(f"[phase 5] oracle: host C banded kernel, {len(bpairs)} scores "
          f"equal")
    return launches, blaunches, res, wall


def phase6(pairs, torch, pool):
    """WINDOWED with CIGARs (ws 9, ovl 1) over the phase-3 pairs through
    `api.BatchAligner` on the card: every score and CIGAR equal to the
    host C windowed full mode (`native.windowed_full`), the full-mode
    kernel launched; then the kernel timed on the run's batch (rebuilt as
    the aligner buckets it) with its bound, and held to its plain version
    on its first and last lanes of a host copy."""
    from concurrent.futures import ThreadPoolExecutor

    from quicked_tpu_torch import dna, native
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.cigar import Cigar
    from quicked_tpu_torch.ops import windowed_cuda as wc
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    params = QuickedParams(algo=QuickedAlgo.WINDOWED, only_score=False,
                           window_size=9, overlap_size=1)
    aligner = BatchAligner(params, device="cuda")
    res, wall, launches, _ = run_counted(lambda: aligner.align(pairs),
                                         torch)
    bases = sum(max(len(p), len(t)) for p, t in pairs)
    print(f"[phase 6] WINDOWED with CIGARs, {len(pairs)} pairs x "
          f"~{len(pairs[0][1])} bp, ws 9 ovl 1: {wall:.3f} s, "
          f"{len(pairs) / wall:.1f} pairs/s, {bases / wall:.4g} aligned "
          f"bases/s")
    print("[phase 6] launches " + json.dumps(launches))
    check(launches["windowed_full"] > 0, "phase 6 never launched "
          "windowed_full")

    def oracle(pair):
        p, t = pair
        ops = native.windowed_full(dna.encode(p), p.encode(), dna.encode(t),
                                   t.encode(), 9, 1)
        c = Cigar(operations=ops)
        return c.score_edit(), c.sprint(True)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        want, oracle_ms = host_ms(lambda: list(ex.map(oracle, pairs)))
    bad = [i for i, (sc, cig) in enumerate(want)
           if int(res.score[i]) != sc or res.cigar[i] != cig]
    check(not bad, f"phase 6: pairs {bad[:5]} differ from the host C "
          f"windowed full mode")
    print(f"[phase 6] oracle: host C windowed full mode, {len(pairs)} "
          f"pairs equal, {oracle_ms / 1e3:.1f} s on the host")

    check(launches["windowed_full"] == 1, "phase 6's pairs took more than "
          "one bucket")
    st = wc.stage_windowed(wc.prepare_windowed_batch(
        [p for p, _ in pairs], [t for _, t in pairs], window_size=9), "cuda")
    return launches, windowed_full_check(
        "wfull_slice", st, 9, 1, torch, pool, lanes=[0, len(pairs) - 1],
        phase="phase 6")


def cli_run(argv, torch):
    """align_benchmark's main in-process on the card: (its stderr, wall
    seconds, launches per kernel), the counts set to 0 just before it;
    fails unless it exits 0."""
    import contextlib
    import io

    from quicked_tpu_torch.tools import align_benchmark

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, wall, launches, _ = run_counted(
            lambda: align_benchmark.main(argv), torch)
    check(rc == 0, f"align_benchmark {' '.join(argv)} exited {rc}: "
          f"{err.getvalue()[-2000:]}")
    return err.getvalue(), wall, launches


def tsv_line(score, cigar, status=0, only_score=False):
    """A pair's line of align_benchmark's TSV (benchmark_utils.c:167-188)."""
    if int(status) < 0:
        return "ERROR\t" + ("-" if only_score else "ERROR")
    return f"{int(score)}\t{'-' if cigar is None else cigar}"


def read_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def cli_oracle(algo, only_score, pairs):
    """Each pair's align_benchmark line for `algo` at the CLI's defaults
    (bandwidth 15, ws 9, ovl 1, HEW threshold 40) from the host C runtime,
    which shares no code with the card's path: BANDED CIGARs from its
    Hirschberg with the band's cutoff and no budget (so the whole band is
    one base case), BANDED scores from its banded kernel, HIRSCHBERG from
    its Hirschberg under the 16 MB budget, WINDOWED from its windowed
    full and score modes."""
    from concurrent.futures import ThreadPoolExecutor

    from quicked_tpu_torch import dna, native
    from quicked_tpu_torch.cigar import Cigar
    from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                                  prepare_banded_batch)
    from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE

    if algo == "edit-banded" and only_score:
        b = prepare_banded_batch(
            [p for p, _ in pairs], [t for _, t in pairs],
            [max(len(p), len(t)) * 15 // 100 for p, t in pairs], full=False)
        scores = extract_final_scores(
            b, native.run_banded_native(b)["scores_by_k"])
        return [tsv_line(s, None) for s in scores]

    def line(pair):
        p, t = pair
        args = (dna.encode(p), p.encode(), dna.encode(t), t.encode())
        if algo == "edit-windowed":
            if only_score:
                return tsv_line(native.windowed_score(*args, 9, 1, 40)[0],
                                None)
            ops, st = native.windowed_full(*args, 9, 1), 0
        else:
            budget = (HIRSCHBERG_BUFFER_SIZE
                      if algo == "edit-banded-hirschberg" else 1 << 62)
            st, ops = native.hirschberg(
                *args, max(len(p), len(t)) * 15 // 100, budget)
        c = Cigar(operations=ops)
        return tsv_line(c.score_edit(), None if only_score
                        else c.sprint(True), st, only_score)

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        return list(ex.map(line, pairs))


def phase7(pairs, want, api_wall, torch):
    """The CLI on the card, in-process as a user's script would call it:
    `-a quicked` over phase 3's pairs in batches of 250, every TSV line
    equal to the host C cascade (phase 3's oracle); `-a edit-bpm` (a
    full-width band in full mode) on the first 100 pairs, every score equal
    to the host C cascade's and `--check correct` at 100%; `-a
    edit-banded`, `edit-banded-hirschberg` and `edit-windowed`, with and
    without `--only-score`, on the first 200, every line equal to the host
    C runtime's (`cli_oracle`) and to `api.align_batch` on the card; then
    one run of the module entry in a subprocess with `--profile` and
    `--memory-report`. Returns the `-a quicked` TSV lines."""
    import tempfile

    from quicked_tpu_torch import seqio
    from quicked_tpu_torch.aligner import batch as qb
    from quicked_tpu_torch.api import align_batch
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    with tempfile.TemporaryDirectory() as td:
        seq = os.path.join(td, "pairs.seq")
        out = os.path.join(td, "out.tsv")
        seqio.write_seq_pairs(seq, pairs)
        err, wall, launches = cli_run(
            ["-a", "quicked", "-i", seq, "-o", out, "--batch-size", "250",
             "-v"], torch)
        for line in err.splitlines():
            if "Time." in line or "Total.reads" in line:
                print(f"[phase 7] quicked: {line.strip()}")
        bench = [line for line in err.splitlines() if "Time.Benchmark" in line]
        check(len(bench) == 1, "phase 7: no Time.Benchmark line")
        print(f"[phase 7] quicked CLI, {len(pairs)} pairs in batches of 250: "
              f"{wall:.3f} s wall ({bench[0].split('Benchmark')[1].strip()} "
              f"Time.Benchmark) against phase 3's API {api_wall:.3f} s: "
              f"{wall - api_wall:+.3f} s")
        print("[phase 7] launches " + json.dumps(launches))
        for name in ("banded_fill", "banded_traceback", "windowed_score"):
            check(launches[name] > 0, f"phase 7 never launched {name}")
        got = quicked_lines = read_lines(out)
        check(len(got) == len(pairs), f"phase 7: {len(got)} TSV lines")
        bad = [i for i, (sc, cig) in enumerate(want)
               if got[i] != tsv_line(sc, cig)]
        check(not bad, f"phase 7: quicked lines {bad[:5]} differ from the "
              f"host C cascade")
        print(f"[phase 7] quicked: {len(pairs)} TSV lines equal to the host "
              f"C cascade")

        # edit-bpm: cutoff = max length, the fill past 128 band blocks
        ebbs = []
        real_prep = qb.prepare_banded_batch

        def prep(*a, **kw):
            b = real_prep(*a, **kw)
            ebbs.append(b.EBB)
            return b

        n = min(100, len(pairs))
        seq100 = os.path.join(td, "pairs100.seq")
        seqio.write_seq_pairs(seq100, pairs[:n])
        qb.prepare_banded_batch = prep
        try:
            err, wall, launches = cli_run(
                ["-a", "edit-bpm", "-i", seq100, "-o", out, "-c", "correct"],
                torch)
        finally:
            qb.prepare_banded_batch = real_prep
        got = read_lines(out)
        bad = [i for i in range(n)
               if got[i].split("\t")[0] != str(want[i][0])]
        check(not bad, f"phase 7: edit-bpm scores {bad[:5]} differ from "
              f"the host C cascade")
        correct = [line for line in err.splitlines()
                   if "Alignments.Correct" in line]
        check(correct and "(100.00 %)" in correct[0],
              f"phase 7: edit-bpm --check correct: {correct}")
        print(f"[phase 7] edit-bpm, {n} pairs: {wall:.3f} s, largest EBB "
              f"{max(ebbs)}, {launches['banded_fill']} fill and "
              f"{launches['banded_traceback']} traceback launches, scores "
              f"equal to the host C cascade, {correct[0].strip()}")
        check(launches["banded_fill"] > 0 and max(ebbs) > 128,
              "phase 7: edit-bpm did not run the fill past 128 blocks")

        # the other algorithms against the host C runtime and the API
        n = min(200, len(pairs))
        seq200 = os.path.join(td, "pairs200.seq")
        seqio.write_seq_pairs(seq200, pairs[:n])
        for algo, qa in (("edit-banded", QuickedAlgo.BANDED),
                         ("edit-banded-hirschberg", QuickedAlgo.HIRSCHBERG),
                         ("edit-windowed", QuickedAlgo.WINDOWED)):
            for only_score in (False, True):
                flags = ["--only-score"] if only_score else []
                _, wall, launches = cli_run(
                    ["-a", algo, "-i", seq200, "-o", out, *flags], torch)
                got = read_lines(out)
                host, oracle_ms = host_ms(
                    lambda: cli_oracle(algo, only_score, pairs[:n]))
                bad = [i for i in range(n) if got[i] != host[i]]
                check(len(got) == n and not bad, f"phase 7: {algo} "
                      f"{' '.join(flags)}: lines {bad[:5]} differ from the "
                      f"host C runtime")
                res = align_batch(pairs[:n], QuickedParams(
                    algo=qa, only_score=only_score), device="cuda")
                api = [tsv_line(res.score[i], res.cigar[i], res.status[i],
                                only_score) for i in range(n)]
                check(got == api, f"phase 7: {algo} "
                      f"{' '.join(flags)} differs from api.align_batch")
                used = sorted(k for k, v in launches.items() if v)
                check(used, f"phase 7: {algo} launched no kernel")
                print(f"[phase 7] {algo} {' '.join(flags)}: {n} lines equal "
                      f"to the host C runtime ({oracle_ms / 1e3:.1f} s on "
                      f"the host) and to api.align_batch, {wall:.3f} s, "
                      f"kernels {used}")

        # the module entry, profiled, with the memory report
        seq50 = os.path.join(td, "pairs50.seq")
        seqio.write_seq_pairs(seq50, pairs[:50])
        prof = os.path.join(td, "prof")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "quicked_tpu_torch.tools.align_benchmark",
             "-a", "quicked", "-i", seq50, "-o", out, "--profile", prof,
             "--memory-report"], capture_output=True, text=True, timeout=600,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
        check(r.returncode == 0, f"phase 7: the module entry exited "
              f"{r.returncode}: {r.stderr[-2000:]}")
        traces = os.listdir(prof) if os.path.isdir(prof) else []
        check(len(traces) == 1, f"phase 7: trace files {traces}")
        with open(os.path.join(prof, traces[0])) as f:
            trace = f.read()
        check("banded_fill" in trace, "phase 7: the trace names no "
              "banded_fill kernel")
        mem = r.stderr[r.stderr.index("[Memory]"):r.stderr.index(
            "[Benchmark]")] if "[Memory]" in r.stderr else ""
        dev = [line for line in mem.splitlines()
               if line.strip().startswith("cuda:")]
        check(dev and "peak 0 B" not in dev[0],
              f"phase 7: [Memory] shows no CUDA device peak: {mem}")
        check("FullFill.Planes" in mem, "phase 7: [Memory] has no "
              "FullFill.Planes")
        check(read_lines(out) == [tsv_line(*w) for w in want[:50]],
              "phase 7: the module entry's lines differ from the host C "
              "cascade")
        print(f"[phase 7] module entry, 50 pairs, profiled: "
              f"{time.perf_counter() - t0:.1f} s with the process start, "
              f"trace {len(trace)} bytes naming banded_fill")
        for line in mem.splitlines():
            print(f"[phase 7] {line.rstrip()}")
    return quicked_lines


def phase8(runs, quicked_lines, smi, torch):
    """The multi-device layer on the card: `dryrun_multichip` over every
    card; each run of `runs` (tag, pairs, its unmeshed result, wall and
    launches) again under `use_mesh` on three shards of cuda:0, every
    status, score and CIGAR equal to the unmeshed run's and every kernel
    it launched launched again; two `distributed_align` processes on
    cuda:0 over phase 7's pairs, interleaved in two 16 MiB chunks, the
    merged TSV equal to phase 7's `-a quicked` lines; one run of the mesh
    example."""
    import tempfile

    from quicked_tpu_torch import seqio
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.parallel.distributed import CHUNK_BYTES
    from quicked_tpu_torch.parallel.dryrun import dryrun_multichip
    from quicked_tpu_torch.parallel.mesh import make_mesh, use_mesh
    from quicked_tpu_torch.parallel.multicard_check import (
        CheckFailure, run_distributed)

    print(f"[phase 8] card: {smi}")
    n = torch.cuda.device_count()
    _, wall, launches, _ = run_counted(lambda: dryrun_multichip(n), torch)
    print(f"[phase 8] dryrun_multichip({n}) passed in {wall:.3f} s, "
          f"launches " + json.dumps(launches))

    mesh = make_mesh(devices=["cuda:0"] * 3)
    aligner = BatchAligner(QuickedParams(), device="cuda")
    for tag, pairs, base, base_wall, base_launches in runs:
        with use_mesh(mesh):
            res, wall, launches, aborts = run_counted(
                lambda: aligner.align(pairs), torch)
        bad = [i for i in range(len(pairs))
               if (int(res.status[i]), int(res.score[i]), res.cigar[i])
               != (int(base.status[i]), int(base.score[i]), base.cigar[i])]
        check(not bad, f"phase 8: {tag} pairs {bad[:5]} differ under the "
              f"mesh")
        missing = [k for k, v in base_launches.items()
                   if v and not launches[k]]
        check(not missing, f"phase 8: {tag} under the mesh never launched "
              f"{missing}")
        print(f"[phase 8] {tag}, {len(pairs)} pairs under a mesh of 3 "
              f"shards of cuda:0: {wall:.3f} s against {base_wall:.3f} s "
              f"unmeshed ({smi}); every status, score and CIGAR equal; "
              f"systolic ABORT lanes {aborts}")
        print(f"[phase 8] {tag} launches under the mesh "
              + json.dumps(launches) + " unmeshed "
              + json.dumps(base_launches))

    with tempfile.TemporaryDirectory() as td:
        seq = os.path.join(td, "pairs.seq")
        out = os.path.join(td, "out.tsv")
        seqio.write_seq_pairs(seq, runs[0][1])
        size = os.path.getsize(seq)
        check(CHUNK_BYTES < size <= 2 * CHUNK_BYTES, f"phase 8: the .seq "
              f"file's {size} bytes are not two interleaved chunks")
        try:
            wall = run_distributed(seq, out, 2, "interleaved")
        except CheckFailure as e:
            check(False, f"phase 8: {e}")
        got = read_lines(out)
        bad = [i for i in range(len(quicked_lines))
               if i >= len(got) or got[i] != quicked_lines[i]]
        check(len(got) == len(quicked_lines) and not bad,
              f"phase 8: distributed_align lines {bad[:5]} differ from "
              f"phase 7's")
        print(f"[phase 8] distributed_align, 2 processes on cuda:0 (gloo, "
              f"interleaved, {size} bytes in 2 chunks): {len(got)} lines "
              f"equal to phase 7's -a quicked TSV, {wall:.1f} s with the "
              f"process starts")

    t0 = time.perf_counter()
    example = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples_torch",
                                      "mesh_pipeline.py")],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = example.communicate(timeout=600)
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
    check(example.returncode == 0 and "devices:" in stdout,
          f"phase 8: examples_torch/mesh_pipeline.py exited "
          f"{example.returncode}: {stderr[-2000:]}")
    for line in stdout.splitlines()[:2]:
        print(f"[phase 8] mesh_pipeline.py: {line}")
    print(f"[phase 8] mesh_pipeline.py on the card in "
          f"{time.perf_counter() - t0:.1f} s with the process start")


def _device_ms(evt):
    total = getattr(evt, "self_device_time_total", None)
    if total is None:
        total = evt.self_cuda_time_total
    return total / 1e3


def phase4(runs, torch):
    """Each run again under torch.profiler: device time per kernel and
    copy, and the card's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.api import BatchAligner

    aligner = BatchAligner(QuickedParams(), device="cuda")
    for tag, pairs in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aligner.align(pairs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = sorted(((_device_ms(e), e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        busy = sum(r[0] for r in rows)
        print(f"[phase 4] profiled {tag}: {wall:.3f} s wall, device busy "
              f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f}% of the "
              f"wall)")
        for ms, count, key in rows[:10]:
            print(f"[phase 4]   {ms:10.2f} ms  {count:5d} x  {key[:70]}")
        if not rows:
            print("[phase 4] the profiler recorded no device time: not "
                  "measured")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--length", type=int, default=10_000)
    ap.add_argument("--long-pairs", type=int, default=100)
    ap.add_argument("--long-length", type=int, default=100_000)
    args = ap.parse_args(argv)
    global MAX_SM_MHZ

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from quicked_tpu_torch import generate, native
        from quicked_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script: {e}",
              file=sys.stderr)
        return 2

    pool = None
    try:
        t_start = time.perf_counter()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                else "nvidia-smi: no output")
        print(card)
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        if clk:
            MAX_SM_MHZ = float(clk[0].split(",")[1])
            print(f"[phase 1] SM clock now, max (MHz): {clk[0]}")
        nvcc = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True, timeout=60)
        print(f"[phase 1] {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s), torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}, "
              f"{nvcc.stdout.strip().splitlines()[-1]}")
        _build.load()
        print(f"[phase 1] kernels built and loaded in "
              f"{_build.build_seconds:.1f} s")
        register_check(_build)
        # the host C library builds at first use; do it here, so that no
        # later phase times its gcc run
        t0 = time.perf_counter()
        have_native = native.available()
        print(f"[phase 1] host C library "
              f"{'built or loaded' if have_native else 'unavailable'} in "
              f"{time.perf_counter() - t0:.1f} s")

        pool = PlainPool(max(1, min(6, (os.cpu_count() or 2) - 2)))
        p2 = phase2(generate, SEED, torch, pool)
        p2.update(phase2_deep(generate, torch, pool))
        p2.update(phase2_stripes(generate, torch, pool))
        p2.update(phase2_deepband(generate, torch, pool))
        p2.update(phase2_wide(generate, torch, pool))
        p2.update(phase2_banded(generate, torch, pool))
        long_pairs = make_pairs(generate, args.long_pairs, args.long_length,
                                SEED + 30)
        levels, chunk = record_levels(long_pairs)
        p2.update(phase2_fulldepth(levels, torch, pool))
        p2.update(phase2_levels(levels, chunk, torch, pool))
        del levels, chunk
        p2.update(phase2_batches(generate, torch, pool))
        p2.update(phase2_traceback(generate, torch, pool))
        t0 = time.perf_counter()
        pool.drain()
        print(f"[plain] phase 2's plain versions done "
              f"{time.perf_counter() - t0:.1f} s after its kernels")
        pairs, launches, p3, api_wall, want, res = phase3(generate, args,
                                                          torch)
        p2.update(p3)
        long_launches, banded_launches, long_res, long_wall = phase5(
            generate, long_pairs, torch)
        wfull_launches, p6 = phase6(pairs, torch, pool)
        p2.update(p6)
        quicked_lines = phase7(pairs, want, api_wall, torch)
        phase8([("10 kbp", pairs, res, api_wall, launches),
                ("long-read", long_pairs, long_res, long_wall,
                 long_launches)], quicked_lines, card, torch)
        del res, long_res
        p2.update(check_recorded("10kbp", record_run(pairs, True), torch,
                                 pool, plain=True))
        rec = record_run(long_pairs, False)
        p2.update(check_recorded("long", rec, torch, pool))
        p2.update(check_deep("long", rec, torch, pool, stage3=True))
        del rec
        pool.drain()
        phase4([("10 kbp slice", pairs), ("long-read slice", long_pairs)],
               torch)
        check("jax" not in sys.modules, "jax was imported")
        print(f"[end] {time.perf_counter() - t_start:.1f} s in all")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if pool is not None:
            pool.close()

    def row(name, launched, prefixes, timed):
        """The kernel's line: max_abs_err over every comparison whose key
        starts with one of `prefixes`, times and bound from the `timed`
        one. No single PyTorch call computes any of these functions, so
        library_ms is null."""
        errs = [v["err"] for k, v in p2.items()
                if k.startswith(prefixes) and "err" in v]
        t = p2[timed]
        src = SOURCES.get(name, name)
        return dict(name=name, route="cuda",
                    source=f"quicked_tpu_torch/csrc/{src}.cu",
                    replaces=REPLACES[name], launches=launched,
                    max_abs_err=max(errs), ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None)

    level = next(k for k, v in p2.items()
                 if k.startswith("fill_level") and "plain_ms" in v)
    rows = [
        row("banded_fill", launches["banded_fill"], ("fill_",), level),
        row("banded_traceback", launches["banded_traceback"],
            ("traceback",), "traceback_10kbp"),
        row("windowed_score", launches["windowed_score"], ("windowed_",),
            "windowed_10kbp_2"),
        row("banded_cscan", banded_launches["banded_cscan"],
            ("cscan_", "fulldepth_cscan"), "cscan_banded"),
        row("banded_sysband", long_launches["banded_sysband"],
            ("sysband_", "fulldepth_sysband"), "sysband_long_1"),
        row("hirschberg_split", long_launches["hirschberg_split"],
            ("hsplit",), "hsplit_level1"),
        row("windowed_full", wfull_launches["windowed_full"], ("wfull_",),
            "wfull_slice"),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
