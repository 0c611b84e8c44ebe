#!/usr/bin/env python3
"""Smoke run of quicked_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--pairs N] [--length L]
                          [--long-pairs N] [--long-length L]

Run from the repository root. It builds the port's CUDA kernels from
`quicked_tpu_torch/csrc/`, then:

  phase 1  names the card (nvidia-smi name and power limit), times the
           kernel build and prints the fill kernel's register report
           (`nvcc -Xptxas -v`; any spill fails), and builds (or loads)
           the port's host C library, the oracle and the record
           expansion;
  phase 2  runs each kernel and its plain PyTorch version on the same
           inputs and requires bit-exact agreement (tolerance 0: every
           output is an integer; the systolic pass under its contract,
           pv/mv on [first, last] and its ABORT flags): 64 pairs x 2 kbp
           with large indels on the card (score, Hirschberg-midpoint and
           full fills, the traceback, ws 2 and 9 for the windowed bound);
           8 of those pairs for the carry-scan and systolic passes, the
           split epilogue and ws 20 and 32, and one pair of 25 kbp for the
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
           epilogue on each fused level, the fill on the smallest fused
           level and on the first stage-4 base-case chunk (the plain
           versions on a host copy of one or two lanes); kernel times by
           CUDA events, and the fill's times at every fused level, that
           chunk and the 10 kbp run's largest full-fill chunk;
  phase 3  aligns N pairs x L bp at 10% error (half of them with four
           large indels) through `api.BatchAligner(QuickedParams())` on
           the card, requires every status, score and CIGAR to equal the
           host C cascade (`quicked_tpu_torch.native.quicked_batch`),
           and requires the fill, traceback and windowed kernels to have
           been launched by that run;
  phase 5  the long-read path: --long-pairs pairs x --long-length bp the
           same way (stage 3 and the first split level on the systolic
           pass, the next levels fused with the split epilogue), held
           against the host C cascade (its Hirschberg for the pairs over
           the 16 MB budget), every kernel of the path launched; then
           BANDED score-only on 16 pairs x 30 kbp (the carry-scan pass)
           against the host C banded kernel;
  phase 4  aligns the phase-3 and the long-read pairs again under
           `torch.profiler` and prints the device time of each kernel and
           copy and the card's busy share of the wall.

The line before the last is a JSON object with one entry per kernel,
with its bound: the larger of the bytes its function must move over
3.35 TB/s and its operations over the card's int32 rate (Myers advances
at OPS_PER_ADVANCE each); the last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line. No CUDA card, or no repository around the script,
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


# the TPU kernel (or XLA program) each CUDA kernel replaces
REPLACES = {
    "banded_fill": "quicked_tpu/ops/banded_pallas.py:57",
    "banded_traceback": "quicked_tpu/ops/banded_traceback_jax.py:82",
    "windowed_score": "quicked_tpu/ops/windowed_jax.py:186",
    "banded_cscan": "quicked_tpu/ops/banded_cscan_pallas.py:176",
    "banded_sysband": "quicked_tpu/ops/banded_sysband_pallas.py:68",
    "hirschberg_split": "quicked_tpu/ops/hirschberg_split_jax.py:39",
}


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


def register_check(_build):
    """Print the fill kernel's register report, one line per
    instantiation; fail on any spill."""
    import re

    name = None
    for line in _build.register_report("banded_fill.cu").splitlines():
        m = re.search(r"banded_fill_kernelILi(\d+)ELb(\d)ELb(\d)E", line)
        ms = re.search(r"banded_fill_stream_kernelILb(\d)E", line)
        if "Compiling entry function" in line and m:
            name = (f"S={m.group(1)} several_warps={m.group(2)} "
                    f"full={m.group(3)}")
        elif "Compiling entry function" in line and ms:
            name = f"streamed full={ms.group(1)}"
        elif name and ("Used" in line or "spill" in line):
            text = line.split(":", 1)[-1].strip()
            print(f"[phase 1] banded_fill {name}: {text}")
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            check(not sp or sp.group(1) == sp.group(2) == "0",
                  f"banded_fill {name} spills: {text}")
    check(name is not None, "no register report for banded_fill.cu")


def max_abs_err(a, b):
    """Largest |a - b| over matching tensors (int64 words compare as
    equal or not: their difference could overflow)."""
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.int64:
        return 0 if torch.equal(a, b) else float("inf")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase2(gen, seed, torch):
    """Each kernel against its plain version on the same CUDA inputs."""
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

    def compare(name, kern_out, plain_out):
        err = max(max_abs_err(kern_out[k], plain_out[k]) for k in kern_out)
        check(err == 0, f"{name}: kernel disagrees with plain version")
        return err

    # banded fill: score, score stopped at Hirschberg midpoints, full
    cases = {
        "fill_score": dict(full=False),
        "fill_midpoint": dict(full=False,
                              text_finish=[(len(t) + 1) // 2 for t in txts]),
        "fill_full": dict(full=True),
    }
    staged = {}
    for name, kw in cases.items():
        st = bc.stage_banded(prepare_banded_batch(pats, txts, cos, **kw),
                             "cuda")
        staged[name] = st
        kern = bc.fill_staged(st)
        torch.cuda.synchronize()
        plain = bc.banded_scan_torch(st)
        err = compare(name, kern, plain)
        ms = cuda_ms(lambda: bc.fill_staged(st), 5)
        plain_ms = cuda_ms(lambda: bc.banded_scan_torch(st), 1)
        res[name] = dict(err=err, ms=ms, plain_ms=plain_ms)
        print(f"[phase 2] {name}: B={st.B} EBB={st.EBB} NB={st.NB} "
              f"bit-exact, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")

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
    kern = btc.traceback_records(*args)
    plain = btc.traceback_records_torch(*args)
    err = compare("traceback", dict(enumerate(kern)), dict(enumerate(plain)))
    ms = cuda_ms(lambda: btc.traceback_records(*args), 5)
    plain_ms = cuda_ms(lambda: btc.traceback_records_torch(*args), 1)
    # per column and lane: a Pv and an Mv word, two raw characters, one
    # (run, op) record
    T, _, B = out["mat_pv"].shape
    b_ms, b_by = bound(T * B * (8 + 8 + 1 + 1 + 4 + 1))
    res["traceback"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
    print(f"[phase 2] traceback: T={out['mat_pv'].shape[0]} bit-exact, "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")

    # windowed bound, stage 1 (ws 2) and stage 2 (ws 9) shapes
    for ws in (2, 9):
        stw = wc.stage_windowed(
            wc.prepare_windowed_batch(pats, txts, window_size=ws), "cuda")
        cells = wc.hew_cell_threshold(ws, 1, 40)
        kern = wc.windowed_score_staged(stw, ws, 1, cells)
        plain = wc.windowed_scan_torch(stw, ws, 1, cells)
        err = compare(f"windowed_ws{ws}", dict(enumerate(kern)),
                      dict(enumerate(plain)))
        ms = cuda_ms(lambda: wc.windowed_score_staged(stw, ws, 1, cells), 5)
        plain_ms = cuda_ms(lambda: wc.windowed_scan_torch(stw, ws, 1, cells),
                           1)
        # a window advances at most 64*(ws-1) along each sequence, and
        # fills 64*ws columns of ws blocks
        windows = sum(-(-min(len(p), len(t)) // (64 * (ws - 1)))
                      for p, t in pairs)
        b_ms, b_by = bound(
            sum(x.numel() * x.element_size() for x in
                (stw.peq, stw.text_enc, stw.text_raw, stw.pat_raw)),
            windows * 64 * ws * ws * OPS_PER_ADVANCE)
        res[f"windowed_ws{ws}"] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by)
        print(f"[phase 2] windowed ws={ws}: bit-exact, kernel {ms:.3f} ms, "
              f"plain {plain_ms:.1f} ms")
    return res


def phase2_deep(gen, torch):
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
    st_host = bc.stage_banded(batch, "cpu")
    kern = bc.fill_staged(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bc.banded_scan_torch(st_host)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(kern[k].cpu(), plain[k]) for k in kern)
    check(err == 0, "fill_full_deep: kernel disagrees with plain version")
    ms = cuda_ms(lambda: bc.fill_staged(st), 3)
    res = dict(fill_full_deep=dict(err=err, ms=ms, plain_ms=plain_ms))
    print(f"[phase 2] fill_full_deep: bounds {cos}, B={st.B} EBB={st.EBB} "
          f"(bucket {bucket}) NB={st.NB} bit-exact, kernel {ms:.3f} ms, "
          f"plain on the host {plain_ms:.1f} ms")

    T = plain["mat_pv"].shape[0]
    praw, traw = btc.prep_raw_frames([p.encode() for p in pats],
                                     [t.encode() for t in txts], T,
                                     max(len(p) for p in pats))
    host = (plain["mat_pv"], plain["mat_mv"], torch.from_numpy(praw),
            torch.from_numpy(traw),
            torch.tensor([len(p) for p in pats], dtype=torch.int32),
            torch.tensor([len(t) for t in txts], dtype=torch.int32),
            st_host.lanes["prolog"])
    dev = (kern["mat_pv"], kern["mat_mv"]) + tuple(x.cuda() for x in host[2:])
    kern_tb = [x.cpu() for x in btc.traceback_records(*dev)]
    t0 = time.perf_counter()
    plain_tb = btc.traceback_records_torch(*host)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_abs_err(a, b) for a, b in zip(kern_tb, plain_tb))
    check(err == 0, "traceback_deep: kernel disagrees with plain version")
    ms = cuda_ms(lambda: btc.traceback_records(*dev), 3)
    res["traceback_deep"] = dict(err=err, ms=ms, plain_ms=plain_ms)
    print(f"[phase 2] traceback_deep: T={T} bit-exact, kernel {ms:.3f} ms, "
          f"plain on the host {plain_ms:.1f} ms")
    return res


def fill_plain_check(name, st, b, lanes, torch, reps=3):
    """The fill kernel on the CUDA batch `st` (staged from `b`) against
    its plain version on a host copy of lanes `lanes`, every output
    bit-exact; the kernel's time on the whole batch by CUDA events."""
    from quicked_tpu_torch.ops import banded_cuda as bc

    idx = torch.tensor(lanes)
    kern = bc.fill_staged(st)
    torch.cuda.synchronize()
    host = bc.select_lanes(bc.stage_banded(b, "cpu"), idx)
    plain, plain_ms = host_ms(lambda: bc.banded_scan_torch(host))
    err = max(max_abs_err(kern[k][..., idx.cuda()].cpu(), plain[k])
              for k in plain)
    check(err == 0, f"{name}: fill kernel disagrees with plain version")
    del kern
    ms = cuda_ms(lambda: bc.fill_staged(st), reps)
    b_ms, b_by = banded_bound(st)
    print(f"[phase 2] {name}: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"full={st.full}: lanes {lanes} bit-exact, kernel {ms:.3f} ms "
          f"(bound {b_ms:.3f} ms, {b_by}), plain on the host "
          f"{plain_ms:.1f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase2_stripes(gen, torch):
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
                                         b, list(range(n)), torch)
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


def hsplit_check(name, b, torch):
    """The fill and the split epilogue on the card over an interleaved
    forward/reverse level batch `b`; the plain split on a host copy of
    the fill's outputs. Feasibility flags equal, split values equal on
    the feasible tasks."""
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import hirschberg_split_cuda as hs

    st = bc.stage_banded(b, "cuda")
    out = bc.fill_staged(st)
    task = [torch.tensor(a[0::2], dtype=torch.int32, device="cuda")
            for a in (b.prolog, b.plen, b.tlen)]
    kern = hs.hirschberg_split(out, *task)
    torch.cuda.synchronize()
    host_out = {k: v.cpu() for k, v in out.items()}
    plain, plain_ms = host_ms(lambda: hs.hirschberg_split_torch(
        host_out, *[x.cpu() for x in task]))
    ok = plain[3].bool()
    check(torch.equal(kern[3].cpu(), plain[3]),
          f"{name}: feasibility flags differ")
    err = max(max_abs_err(a.cpu()[ok], b_[ok])
              for a, b_ in zip(kern[:3], plain[:3]))
    check(err == 0, f"{name}: kernel disagrees with plain version")
    ms = cuda_ms(lambda: hs.hirschberg_split(out, *task), 5)
    # per task: both lanes' Pv/Mv bands, two score rows, four results
    b_ms, b_by = bound(st.B // 2 * (2 * st.EBB * 16 + 8 + 16))
    print(f"[phase 2] {name}: {st.B // 2} tasks, EBB={st.EBB} NB={st.NB}, "
          f"{int(ok.sum())} feasible, bit-exact, kernel {ms:.3f} ms (bound "
          f"{b_ms:.4f} ms, {b_by}), plain on the host {plain_ms:.1f} ms")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase2_deepband(gen, torch):
    """The long-read path's kernels against their plain versions, which
    run on a host copy of the same staged tensors: carry-scan and
    systolic passes (8 pairs x 2 kbp: a full pass and Hirschberg half
    passes; one 25 kbp pair that recenters the systolic window), the
    split epilogue over an interleaved forward/reverse level batch, and
    the windowed bound at ws 20 and 32 (the scratch window)."""
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
        st, host = bc.stage_banded(b, "cuda"), bc.stage_banded(b, "cpu")
        kern = cc.cscan_staged(st)
        torch.cuda.synchronize()
        plain, plain_ms = host_ms(lambda: cc.banded_cscan_torch(host))
        err = max(max_abs_err(kern[k].cpu(), plain[k]) for k in kern)
        check(err == 0, f"cscan_{name}: kernel disagrees with plain version")
        ms = cuda_ms(lambda: cc.cscan_staged(st), 5)
        res[f"cscan_{name}"] = dict(err=err, ms=ms, plain_ms=plain_ms)
        print(f"[phase 2] cscan_{name}: B={st.B} EBB={st.EBB} NB={st.NB} "
              f"bit-exact, kernel {ms:.3f} ms, plain on the host "
              f"{plain_ms:.1f} ms")

    batches["recenter"] = prepare_banded_batch([rp], [rt], [RECENTER_CUTOFF],
                                               full=False)
    for name, b in batches.items():
        st, host = bc.stage_banded(b, "cuda"), bc.stage_banded(b, "cpu")
        kern, k_abort = sb.sysband_raw(st)
        torch.cuda.synchronize()
        (plain, p_abort), plain_ms = host_ms(
            lambda: sb.banded_sysband_torch(host))
        check(torch.equal(k_abort.cpu(), p_abort),
              f"sysband_{name}: ABORT flags differ")
        lanes = (~p_abort).nonzero()[:, 0]
        err = band_err(kern, plain, lanes)
        check(err == 0, f"sysband_{name}: kernel disagrees with plain "
              f"version")
        ms = cuda_ms(lambda: sb.sysband_raw(st), 5)
        res[f"sysband_{name}"] = dict(err=err, ms=ms, plain_ms=plain_ms)
        print(f"[phase 2] sysband_{name}: B={st.B} EBB={st.EBB} NB={st.NB} "
              f"NS={sb.geometry(st.EBB)[0]} aborts {int(p_abort.sum())}, "
              f"bit-exact on the contract, kernel {ms:.3f} ms, plain on the "
              f"host {plain_ms:.1f} ms")

    # split epilogue: lane 2j forward, 2j+1 reverse half pass of task j
    il = ([], [], [], [])
    for p, t in pairs:
        mid = (len(t) + 1) // 2
        il[0].extend([p, p[::-1]])
        il[1].extend([t, t[::-1]])
        il[2].extend([max(len(p), len(t)) * 25 // 100] * 2)
        il[3].extend([mid, len(t) - mid])
    res["hsplit"] = hsplit_check(
        "hsplit", prepare_banded_batch(*il[:3], full=False,
                                       text_finish=il[3]), torch)

    for ws in (20, 32):
        wb = wc.prepare_windowed_batch(pats, txts, window_size=ws)
        stw, hostw = wc.stage_windowed(wb, "cuda"), wc.stage_windowed(wb,
                                                                      "cpu")
        cells = wc.hew_cell_threshold(ws, 1, 40)
        kern = wc.windowed_score_staged(stw, ws, 1, cells)
        torch.cuda.synchronize()
        plain, plain_ms = host_ms(
            lambda: wc.windowed_scan_torch(hostw, ws, 1, cells))
        err = max(max_abs_err(a.cpu(), b_) for a, b_ in zip(kern, plain))
        check(err == 0, f"windowed_ws{ws}: kernel disagrees with plain "
              f"version")
        ms = cuda_ms(lambda: wc.windowed_score_staged(stw, ws, 1, cells), 5)
        res[f"windowed_ws{ws}"] = dict(err=err, ms=ms, plain_ms=plain_ms)
        print(f"[phase 2] windowed ws={ws}: bit-exact, kernel {ms:.3f} ms, "
              f"plain on the host {plain_ms:.1f} ms")
    return res


def level1_batch(pairs, torch):
    """The long-read phase's first Hirschberg split level: its pairs'
    stage-4 bounds (stages 1-3 on the card), the forward and reverse half
    passes of every pair over the 16 MB budget, bucketed as
    banded_score_results buckets them; returns the largest bucket the
    route sends to the systolic kernel, as a BandedBatch."""
    from quicked_tpu_torch.ops import myers_np
    from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
    from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE, QuickedParams
    from quicked_tpu_torch.utils.profiler import PhaseTimers
    from quicked_tpu_torch.aligner.batch import score_family, score_key
    from quicked_tpu_torch.aligner.cascade import proven_bounds

    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    bounds = proven_bounds(pats, txts, QuickedParams(), PhaseTimers(),
                           "cuda")
    lanes = []          # (pattern, text, cutoff, text_finish)
    for p, t, co in zip(pats, txts, bounds):
        geo = myers_np.band_geometry(len(p), len(t), int(co))
        if geo.ebb * len(t) * 16 <= HIRSCHBERG_BUFFER_SIZE:
            continue
        mid = (len(t) + 1) // 2
        lanes += [(p, t, int(co), mid), (p[::-1], t[::-1], int(co),
                                          len(t) - mid)]
    buckets: dict = {}
    for ln in lanes:
        geo = myers_np.band_geometry(len(ln[0]), len(ln[1]), ln[2])
        buckets.setdefault(score_key(geo, ln[3]), []).append(ln)
    deep = [(len(v), k, v) for k, v in buckets.items()
            if score_family(len(v), k[1]) == "sysband"]
    check(deep, f"no systolic bucket at level 1: {sorted(buckets)}")
    n, key, sel = max(deep, key=lambda x: x[0])
    print(f"[phase 2] full depth: {len(lanes)} level-1 half passes of "
          f"{len(pairs)} pairs, buckets (NB, EBB) -> lanes "
          f"{ {k: len(v) for k, v in sorted(buckets.items())} }; "
          f"bucket {key}")
    return prepare_banded_batch([x[0] for x in sel], [x[1] for x in sel],
                                [x[2] for x in sel], full=False,
                                text_finish=[x[3] for x in sel])


def deep_plain_check(name, st, b, lanes, torch, cscan_plain=True):
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
    k_sys, k_abort = sb.sysband_raw(sel)
    k_cs = cc.cscan_staged(sel)
    torch.cuda.synchronize()
    (p_sys, p_abort), sys_plain_ms = host_ms(
        lambda: sb.banded_sysband_torch(host))
    check(torch.equal(k_abort.cpu(), p_abort),
          f"{name}: systolic ABORT flags differ from the plain version")
    err_sys = band_err(k_sys, p_sys, (~p_abort).nonzero()[:, 0])
    check(err_sys == 0, f"{name}: systolic kernel disagrees with its plain "
          f"version")
    sys_ms = cuda_ms(lambda: sb.sysband_raw(sel), 3)
    res = {f"sysband_{name}": dict(err=err_sys, ms=sys_ms,
                                   plain_ms=sys_plain_ms)}
    res[f"sysband_{name}"].update(zip(("bound_ms", "bound_by"),
                                      banded_bound(sel)))
    msg = (f"[phase 2] {name}, lanes {lanes}: sysband (aborts "
           f"{int(p_abort.sum())}) equal to its plain version, kernel "
           f"{sys_ms:.3f} ms, plain on the host {sys_plain_ms:.1f} ms")
    if cscan_plain:
        p_cs, cs_plain_ms = host_ms(lambda: cc.banded_cscan_torch(host))
        err_cs = max(max_abs_err(k_cs[k].cpu(), p_cs[k]) for k in p_cs)
        check(err_cs == 0, f"{name}: carry-scan kernel disagrees with its "
              f"plain version")
        cs_ms = cuda_ms(lambda: cc.cscan_staged(sel), 3)
        res[f"cscan_{name}"] = dict(err=err_cs, ms=cs_ms,
                                    plain_ms=cs_plain_ms)
        msg += (f"; cscan equal to its plain version, kernel {cs_ms:.3f} "
                f"ms, plain on the host {cs_plain_ms:.1f} ms")
    print(msg)
    return res


def phase2_fulldepth(long_pairs, torch):
    """Systolic and carry-scan passes against the fill kernel on the
    long-read phase's deep level-1 bucket, the only place recentering and
    deep bands meet at full size; then both against their plain versions
    on two of its lanes (a pair with large indels, one without)."""
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    b = level1_batch(long_pairs, torch)
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
    print(f"[phase 2] full depth: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"NS={sb.geometry(st.EBB)[0]}: systolic (aborts {aborts}) and "
          f"carry-scan equal to the fill kernel; fill {fill_ms:.3f} ms, "
          f"sysband {sys_ms:.3f} ms, cscan {cs_ms:.3f} ms")
    res = dict(fulldepth_sysband=dict(err=err_sys, ms=sys_ms),
               fulldepth_cscan=dict(err=err_cs, ms=cs_ms),
               fulldepth_fill=dict(ms=fill_ms))
    res.update(deep_plain_check("level1", st, b, [0, st.B - 1], torch))
    return res


def phase2_levels(long_pairs, torch):
    """The split epilogue and the fill at the shapes the long-read phase
    gives them: one run of that phase records each fused level batch it
    hands the fill and split kernels, and its first stage-4 base-case
    chunk (a full fill); each level is run again here, the plain split on
    a host copy of the fill's outputs; the fill is timed on every level
    and on the chunk, and held to its plain version on two lanes of the
    level with the fewest column blocks and on one lane of the chunk."""
    from quicked_tpu_torch.aligner import batch as qb
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.params import QuickedParams

    seen, chunks = [], []
    real_split, real_prep = qb._hsplit_fused, qb.prepare_banded_batch

    def recording(batch, dev):
        seen.append(batch)
        return real_split(batch, dev)

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
    check(seen, "the long-read run fused no split level")
    check(chunks, "the long-read run filled no base case")
    res = {f"hsplit_fused{i}": hsplit_check(f"hsplit_fused{i}", b, torch)
           for i, b in enumerate(seen, 1)}
    small = min(range(len(seen)), key=lambda i: seen[i].NB)
    for i, b in enumerate(seen, 1):
        st = bc.stage_banded(b, "cuda")
        if i - 1 == small:
            res[f"fill_level{i}"] = fill_plain_check(
                f"fill_level{i}", st, b, [0, 1], torch)
        else:
            ms = cuda_ms(lambda: bc.fill_staged(st), 3)
            b_ms, b_by = banded_bound(st)
            res[f"fill_level{i}"] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by)
            print(f"[phase 2] fill_level{i}: B={st.B} EBB={st.EBB} "
                  f"NB={st.NB}: kernel {ms:.3f} ms (bound {b_ms:.3f} ms, "
                  f"{b_by})")
    b = chunks[0]
    res["fill_basecase"] = fill_plain_check(
        "fill_basecase", bc.stage_banded(b, "cuda"), b, [0], torch)
    return res


def phase2_wide(gen, torch):
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
        res.update(deep_plain_check(name, st, b, [0], torch,
                                    cscan_plain=insert == 0))
    return res


def phase2_banded(gen, torch):
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
    st, host = bc.stage_banded(b, "cuda"), bc.stage_banded(b, "cpu")
    kern = cc.cscan_staged(st)
    torch.cuda.synchronize()
    plain, plain_ms = host_ms(lambda: cc.banded_cscan_torch(host))
    err = max(max_abs_err(kern[k].cpu(), plain[k]) for k in kern)
    check(err == 0, "cscan_banded: kernel disagrees with plain version")
    ms = cuda_ms(lambda: cc.cscan_staged(st), 5)
    b_ms, b_by = banded_bound(st)
    print(f"[phase 2] cscan_banded: B={st.B} EBB={st.EBB} NB={st.NB} "
          f"bit-exact, kernel {ms:.3f} ms (bound {b_ms:.3f} ms, {b_by}), "
          f"plain on the host {plain_ms:.1f} ms")
    return dict(cscan_banded=dict(err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by))


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
            "hirschberg_split": hirschberg_split_cuda.HSPLIT}


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
        ms=ms, bound_ms=b_ms, bound_by=b_by))


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
    params = QuickedParams()
    timers = PhaseTimers()
    aligner = BatchAligner(params, device="cuda")
    res, wall, launches, aborts = run_counted(
        lambda: aligner.align(pairs, timers=timers), torch)
    report_run("phase 5", pairs, wall, launches, timers)
    print(f"[phase 5] systolic ABORT lanes recomputed by the carry-scan "
          f"pass: {aborts}")
    for name in ("banded_sysband", "hirschberg_split", "banded_fill",
                 "banded_traceback", "windowed_score"):
        check(launches[name] > 0, f"phase 5 never launched {name}")
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
    return launches, blaunches


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

    try:
        t_start = time.perf_counter()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
              else "nvidia-smi: no output")
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

        p2 = phase2(generate, SEED, torch)
        p2.update(phase2_deep(generate, torch))
        p2.update(phase2_stripes(generate, torch))
        p2.update(phase2_deepband(generate, torch))
        p2.update(phase2_wide(generate, torch))
        p2.update(phase2_banded(generate, torch))
        long_pairs = make_pairs(generate, args.long_pairs, args.long_length,
                                SEED + 30)
        p2.update(phase2_fulldepth(long_pairs, torch))
        p2.update(phase2_levels(long_pairs, torch))
        pairs, launches, p3 = phase3(generate, args, torch)
        p2.update(p3)
        long_launches, banded_launches = phase5(generate, long_pairs, torch)
        phase4([("10 kbp slice", pairs), ("long-read slice", long_pairs)],
               torch)
        check("jax" not in sys.modules, "jax was imported")
        print(f"[end] {time.perf_counter() - t_start:.1f} s in all")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    def row(name, launched, prefixes, timed):
        """The kernel's line: max_abs_err over every comparison whose key
        starts with one of `prefixes`, times and bound from the `timed`
        one. No single PyTorch call computes any of these functions, so
        library_ms is null."""
        errs = [v["err"] for k, v in p2.items()
                if k.startswith(prefixes) and "err" in v]
        t = p2[timed]
        return dict(name=name, route="cuda",
                    source=f"quicked_tpu_torch/csrc/{name}.cu",
                    replaces=REPLACES[name], launches=launched,
                    max_abs_err=max(errs), ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None)

    level = next(k for k, v in p2.items()
                 if k.startswith("fill_level") and "plain_ms" in v)
    rows = [
        row("banded_fill", launches["banded_fill"], ("fill_",), level),
        row("banded_traceback", launches["banded_traceback"],
            ("traceback",), "traceback"),
        row("windowed_score", launches["windowed_score"], ("windowed_",),
            "windowed_ws9"),
        row("banded_cscan", banded_launches["banded_cscan"],
            ("cscan_", "fulldepth_cscan"), "cscan_banded"),
        row("banded_sysband", long_launches["banded_sysband"],
            ("sysband_", "fulldepth_sysband"), "sysband_level1"),
        row("hirschberg_split", long_launches["hirschberg_split"],
            ("hsplit",), "hsplit_fused1"),
    ]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
