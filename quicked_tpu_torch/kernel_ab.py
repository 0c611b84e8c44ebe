"""Time the windowed score and full-CIGAR, banded traceback, full fill,
deep-band score and Hirschberg split kernels of another checkout of this
repository against this one's, in turns on one card, at the shapes the
aligner hands them.

    python3 -m quicked_tpu_torch.kernel_ab OTHER [--pairs N] [--length L]
                                           [--long-pairs N] [--long-length L]

Run from the repository root on a machine with a CUDA card. OTHER is the
root of the other checkout, for example the parent commit unpacked with
`git archive <commit> | tar -x -C build/parent`. chip_smoke.py's two
slices (N pairs x L bp and the long-read pairs, made from the same seeds)
are aligned once by this checkout, with the card's venue pinned as in
chip_smoke's phases 2-8 (`pin_card_venue`), while chip_smoke's `Recorder`
keeps
every windowed batch, one traceback chunk (the 10 kbp run's largest, the
long-read run's first), each run's largest full-fill `BandedBatch`,
every host `BandedBatch` the route sends to a deep-band kernel (the long-read run's stage 3 and split level 1 on the
systolic kernel; the carry-scan kernel on BANDED score-only over 16 pairs
x 30 kbp, also recorded) and the arguments of every split epilogue call
(the long-read run's three split levels), and every bucket that WINDOWED
with CIGARs (ws 9, ovl 1) hands `run_windowed_full` for the N pairs x L
bp. The other checkout's package
is then imported in place of this one, so that its own wrappers launch
its own kernels, built from its sources into its own build/ directory:
only the wrappers' Python signatures, `windowed_score_staged(st, ws, ovl,
hew_cells)`, `traceback_records(mat_pv, mat_mv, praw, traw, plen, tlen,
prolog)`, `stage_banded(batch, device)`, `fill_staged(st)`,
`sysband_raw(st)`, `cscan_staged(st)`, `hirschberg_split(out, prolog,
plen, tlen)` and `run_windowed_full(batch, ws, ovl, device)`, must agree
(the C entries may differ); each checkout stages a banded batch with its
own `stage_banded`, so the staged layouts need not. Each recorded batch
goes through both, the outputs must be equal (the full fill's plane
words where this one's are not zero, since a fill may store zero outside
the live band where an earlier one kept stale words; the systolic
pass's ABORT flags, and its other lanes under its contract: scores,
first and last, pv/mv on [first, last]; the split's feasibility flags,
and its values on the feasible tasks), and both are timed by CUDA events in turns (other, this,
this, other), the median of 3 runs each; the split, shorter than its
wrapper's host time, by its kernel's device time (torch.profiler), in the
same turns; `run_windowed_full`, whose op strings must be equal, on the
host's clock, and then each checkout's steps of that path
(`windowed_full_breakdown`: other, this, other), and last the walls of
WINDOWED with CIGARs through each checkout's own `BatchAligner`, each in
a process of that checkout (`api_turns`). Exits non-zero if the outputs
differ.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys

PKG = "quicked_tpu_torch"


MODULES = {"fill_staged": "banded_cuda",
           "windowed_score_staged": "windowed_cuda",
           "run_windowed_full": "windowed_cuda",
           "traceback_records": "banded_traceback_cuda",
           "stage_banded": "banded_cuda",
           "sysband_raw": "banded_sysband_cuda",
           "cscan_staged": "banded_cscan_cuda",
           "hirschberg_split": "hirschberg_split_cuda"}


def load_other(root: str) -> dict:
    """The other checkout's wrappers named in MODULES, by name: its
    package imported under this one's name, then this one's modules put
    back (the other's functions keep their own module globals)."""
    def ours(name):
        return name == PKG or name.startswith(PKG + ".")

    mine = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        fns = {fn: getattr(importlib.import_module(f"{PKG}.ops.{mod}"), fn)
               for fn, mod in MODULES.items()}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(mine)
    for fn in fns.values():
        if not fn.__globals__["__file__"].startswith(root + os.sep):
            raise RuntimeError(f"imported {fn.__globals__['__file__']}, "
                               f"not from {root}")
    return fns


def turns(name, shape, other, this, differ=None, timer=None):
    """Outputs of both equal (or `differ(a, b)` false), then medians in
    turns by `timer(fn)` (CUDA events by default); False if the outputs
    differ."""
    import torch

    from chip_smoke import cuda_ms

    timer = timer or (lambda f: cuda_ms(f, 3))
    a, b = other(), this()
    torch.cuda.synchronize()
    if differ is None:
        bad = not all(torch.equal(x, y) for x, y in zip(a, b))
    else:
        bad = differ(a, b)
    if bad:
        print(f"[A/B] {name} ({shape}): outputs differ")
        return False
    t = [timer(f) for f in (other, this, this, other)]
    print(f"[A/B] {name} ({shape}): other {t[0]:.3f} / {t[3]:.3f} ms, this "
          f"{t[1]:.3f} / {t[2]:.3f} ms, outputs equal")
    return True


def sysband_differ(a, b):
    """Two systolic passes (dict, ABORT flags) differ: other ABORT flags,
    or another result on a lane that did not abort, under the contract."""
    import torch

    from chip_smoke import band_err

    if not torch.equal(a[1], b[1]):
        return True
    return band_err(a[0], b[0], (~a[1]).nonzero()[:, 0].cpu()) != 0


def cscan_differ(a, b):
    import torch

    return any(not torch.equal(a[k], b[k]) for k in b)


def fill_differ(a, b):
    """Two full fills differ: another score window, final band or first
    and last, or another plane word where this one's is not zero."""
    import torch

    if any(not torch.equal(a[k], b[k])
           for k in ("scores_by_k", "pv", "mv", "first", "last")):
        return True
    return any(not torch.equal(torch.where(b[k] != 0, a[k], 0), b[k])
               for k in ("mat_pv", "mat_mv"))


def hsplit_differ(a, b):
    """Two splits differ: other feasibility flags, or another value on a
    feasible task (an infeasible task's values are unspecified in earlier
    versions of the kernel)."""
    import torch

    ok = b[3].bool()
    return not torch.equal(a[3], b[3]) or any(
        not torch.equal(x[ok], y[ok]) for x, y in zip(a[:3], b[:3]))


def hsplit_turns(tag, rec, other) -> bool:
    """Every recorded split epilogue call through the other checkout's
    kernel and this one's, on the same score pass outputs."""
    from chip_smoke import device_ms
    from quicked_tpu_torch.ops import hirschberg_split_cuda as hs

    ok = True
    for i, args in enumerate(rec.hsplit):
        EBB, lanes = args[0]["pv"].shape
        ok &= turns(f"hsplit_{tag}_{i + 1}",
                    f"{lanes // 2} tasks, EBB {EBB}",
                    lambda: other["hirschberg_split"](*args),
                    lambda: hs.hirschberg_split(*args), hsplit_differ,
                    lambda f: device_ms(f, "hsplit_kernel"))
    return ok


def deep_turns(tag, rec, other) -> bool:
    """Every recorded deep-band batch through the other checkout's kernel
    and this one's, each staged by its own checkout."""
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb

    ok = True
    for i, (b, family, _) in enumerate(rec.deep):
        st_o = other["stage_banded"](b, "cuda")
        st = bc.stage_banded(b, "cuda")
        shape = f"B {b.B}, EBB {b.EBB}, NB {b.NB}"
        if family == "sysband":
            ok &= turns(f"sysband_{tag}_{i + 1}", shape,
                        lambda: other["sysband_raw"](st_o),
                        lambda: sb.sysband_raw(st), sysband_differ)
        # the carry-scan kernel on every deep batch: its own route's, and
        # the systolic kernel's (the exact fallback of its ABORT lanes)
        ok &= turns(f"cscan_{tag}_{i + 1}", shape,
                    lambda: other["cscan_staged"](st_o),
                    lambda: cc.cscan_staged(st), cscan_differ)
        del st_o, st
    return ok


def windowed_full_breakdown(wc, pairs, ws=9, ovl=1, reps=3) -> dict:
    """Milliseconds of each step of WINDOWED with CIGARs on the card for
    `pairs` (one bucket, as `cascade.windowed_full_batch` makes it), each
    step on the host's clock ending in a synchronize, medians of `reps`:
    staging (`prepare_windowed_batch`), h2d (`stage_windowed`), pair_major
    (the kernel's pair-major input copies), the kernel alone (CUDA events
    around its bare launch), d2h, decode (to op strings) and cigar
    (`Cigar` and `sprint`, as `batch._finish`). `wc` is a windowed_cuda
    module, this checkout's or another's: in the records layout (the
    kernel writes (B, MW, 64 ws) run and op records) the steps add
    zeroing (the records' `torch.zeros`) and permute (to the host's (MW,
    64 ws, B) layout), and decode is `expand_window_records`; in the op
    buffer layout (`windowed_full_ops_torch` present) pair_major includes
    the outputs' allocation (`_full_launch`), d2h is `ops_to_host` and
    decode `decode_ops`. Returns {step: ms} with the
    steps' sum under "sum"."""
    import statistics
    import time

    import torch

    from quicked_tpu_torch.cigar import Cigar

    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    records = not hasattr(wc, "windowed_full_ops_torch")
    times: dict = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    def kernel(launch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        times.setdefault("kernel", []).append(start.elapsed_time(end))

    for _ in range(reps):
        batch = step("staging", lambda: wc.prepare_windowed_batch(
            pats, txts, window_size=ws))
        st = step("h2d", lambda: wc.stage_windowed(batch, "cuda"))
        KP, B, T, P_ = wc._check_windowed(st, ws)
        dev = st.peq.device
        if records:
            geo, bufs, scratch = step(
                "pair_major", lambda: wc._kernel_inputs(st, ws, B))
            shape = (B, wc.max_windows(P_, T, ws, ovl), 64 * ws)
            rr, ro = step("zeroing", lambda: (
                torch.zeros(shape, dtype=torch.int16, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev)))
            pv = torch.empty((B,), dtype=torch.int32, device=dev)
            ph = torch.empty_like(pv)
            kernel(lambda: wc.WINDOWED_FULL.launch(
                dev, *(x.data_ptr() for x in bufs),
                None if scratch is None else scratch.data_ptr(),
                rr.data_ptr(), ro.data_ptr(), pv.data_ptr(), ph.data_ptr(),
                B, KP, T, P_, ws, ovl, geo.span, geo.shared_bytes))
            perm = step("permute", lambda: [
                x.permute(1, 2, 0).contiguous() for x in (rr, ro)])
            host = step("d2h", lambda: [
                x.cpu().numpy() for x in (*perm, pv, ph)])
            ops = step("decode", lambda: wc.expand_window_records(
                *host, n=batch.B))
            del rr, ro, perm, host
        else:
            fl = step("pair_major", lambda: wc._full_launch(st, ws, ovl))
            kernel(lambda: wc.WINDOWED_FULL.launch(dev, *fl.args))
            host = step("d2h", lambda: wc.ops_to_host(fl.ops, fl.start))
            ops = step("decode", lambda: wc.decode_ops(*host, n=batch.B))
            del fl, host
        step("cigar", lambda: [
            (c.score_edit(), c.sprint(True) if o else None)
            for o in ops for c in (Cigar(operations=o),)])
        del st, ops
    res = {k: statistics.median(v) for k, v in times.items()}
    res["sum"] = sum(res.values())
    return res


def record_windowed_full(pairs) -> list:
    """The (batch, ws, ovl) of every `run_windowed_full` call that
    WINDOWED with CIGARs (ws 9, ovl 1, chip_smoke's phase 6) makes on the
    card for `pairs`: one bucket a call."""
    from quicked_tpu_torch.aligner import cascade
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    calls, real = [], cascade.run_windowed_full

    def recording(batch, ws, ovl, device):
        calls.append((batch, ws, ovl))
        return real(batch, ws, ovl, device=device)

    cascade.run_windowed_full = recording
    try:
        BatchAligner(QuickedParams(
            algo=QuickedAlgo.WINDOWED, only_score=False, window_size=9,
            overlap_size=1), device="cuda").align(pairs)
    finally:
        cascade.run_windowed_full = real
    return calls


# WINDOWED with CIGARs through a checkout's own `BatchAligner` and
# chip_smoke (`make_pairs`, `run_counted`), card pinned: its walls, s
API_WALLS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from quicked_tpu_torch import generate
from quicked_tpu_torch.api import BatchAligner
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams
cs.pin_card_venue()
pairs = cs.make_pairs(generate, int(sys.argv[1]), int(sys.argv[2]),
                      cs.SEED + 10)
aligner = BatchAligner(QuickedParams(
    algo=QuickedAlgo.WINDOWED, only_score=False, window_size=9,
    overlap_size=1), device="cuda")
aligner.align(pairs)
print(json.dumps([cs.run_counted(lambda: aligner.align(pairs), torch)[1]
                  for _ in range(3)]))
'''


def api_walls(root, n, length) -> list:
    """Walls (s) of three runs of WINDOWED with CIGARs over chip_smoke's
    n x length pairs, after one untimed run, in a process of the checkout
    at `root`: the whole path, staging to CIGAR strings, with nothing of
    another checkout imported."""
    import json

    proc = subprocess.run([sys.executable, "-c", API_WALLS, str(n),
                           str(length)], cwd=root, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"WINDOWED walls in {root}:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def windowed_full_turns(calls, pairs, other) -> bool:
    """Each recorded full-mode bucket through both checkouts'
    `run_windowed_full` (their own wrappers, kernels and host side), op
    strings equal, timed in turns on the host's clock (the call returns
    strings on the host); then both paths' steps on `pairs`
    (`windowed_full_breakdown`)."""
    import json
    import statistics
    import time
    import types

    import torch

    from quicked_tpu_torch.ops import windowed_cuda as wc

    def wall_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    ok = True
    for i, (batch, ws, ovl) in enumerate(calls):
        ok &= turns(f"windowed_full_{i + 1}", f"ws {ws}, B {batch.B}",
                    lambda: other["run_windowed_full"](batch, ws, ovl,
                                                       "cuda"),
                    lambda: wc.run_windowed_full(batch, ws, ovl, "cuda"),
                    lambda a, b: a != b, wall_ms)
    other_wc = types.SimpleNamespace(
        **other["run_windowed_full"].__globals__)
    for tag, mod in (("other", other_wc), ("this", wc), ("other", other_wc)):
        steps = windowed_full_breakdown(mod, pairs)
        print(f"[A/B] windowed_full steps, {tag}, ms: " + json.dumps(
            {k: round(v, 3) for k, v in steps.items()}))
    return ok


def api_turns(other_root, n, length) -> None:
    """Both checkouts' walls of WINDOWED with CIGARs, each in a process
    of its own, in turns (other, this, this, other)."""
    roots = {"other": os.path.abspath(other_root), "this": os.getcwd()}
    for tag in ("other", "this", "this", "other"):
        walls = api_walls(roots[tag], n, length)
        print(f"[A/B] WINDOWED with CIGARs, {n} x {length} bp, {tag}: "
              f"walls {', '.join(f'{w:.3f}' for w in walls)} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--length", type=int, default=10_000)
    ap.add_argument("--long-pairs", type=int, default=100)
    ap.add_argument("--long-length", type=int, default=100_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from quicked_tpu_torch import generate
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc
    from quicked_tpu_torch.ops import windowed_cuda as wc
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    # record the card's kernels: on its default route the venue router
    # sends the 10 kbp slice to the host C cascade
    cs.pin_card_venue()
    pairs = cs.make_pairs(generate, args.pairs, args.length, cs.SEED + 10)
    wfull = record_windowed_full(pairs)
    recorded = [
        ("10kbp", cs.record_run(pairs, True)),
        ("long", cs.record_run(cs.make_pairs(
            generate, args.long_pairs, args.long_length, cs.SEED + 30),
            False))]
    banded = cs.record_run(cs.banded_pairs(generate), False, QuickedParams(
        algo=QuickedAlgo.BANDED, only_score=True, bandwidth=15))
    other = load_other(args.other)
    other_windowed = other["windowed_score_staged"]
    other_traceback = other["traceback_records"]
    ok = True
    for tag, rec in recorded:
        for i, (st, ws, ovl, cells, _) in enumerate(rec.windowed):
            ok &= turns(f"windowed_{tag}_{i + 1}",
                        f"ws {ws}, B {st.peq.shape[2]}",
                        lambda: other_windowed(st, ws, ovl, cells),
                        lambda: wc.windowed_score_staged(st, ws, ovl, cells))
        st_o = other["stage_banded"](rec.full, "cuda")
        st = bc.stage_banded(rec.full, "cuda")
        ok &= turns(f"fill_full_{tag}", f"B {st.B}, EBB {st.EBB}, NB {st.NB}",
                    lambda: other["fill_staged"](st_o),
                    lambda: bc.fill_staged(st), fill_differ)
        del st_o, st
        chunk = rec.chunk[0]
        ok &= turns(f"traceback_{tag}",
                    "B {2}, T {0}, EBB {1}".format(*chunk[0].shape),
                    lambda: other_traceback(*chunk),
                    lambda: btc.traceback_records(*chunk))
        ok &= deep_turns(tag, rec, other)
        ok &= hsplit_turns(tag, rec, other)
    ok &= deep_turns("banded", banded, other)
    ok &= windowed_full_turns(wfull, pairs, other)
    api_turns(args.other, args.pairs, args.length)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
