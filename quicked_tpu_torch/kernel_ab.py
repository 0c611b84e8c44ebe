"""Time the windowed score, banded traceback, deep-band score and
Hirschberg split kernels of another checkout of this repository against
this one's, in turns on one card, at the shapes the aligner hands them.

    python3 -m quicked_tpu_torch.kernel_ab OTHER [--pairs N] [--length L]
                                           [--long-pairs N] [--long-length L]

Run from the repository root on a machine with a CUDA card. OTHER is the
root of the other checkout, for example the parent commit unpacked with
`git archive <commit> | tar -x -C build/parent`. chip_smoke.py's two
slices (N pairs x L bp and the long-read pairs, made from the same seeds)
are aligned once by this checkout while chip_smoke's `Recorder` keeps
every windowed batch, one traceback chunk (the 10 kbp run's largest, the
long-read run's first), every host `BandedBatch` the route sends to a
deep-band kernel (the long-read run's stage 3 and split level 1 on the
systolic kernel; the carry-scan kernel on BANDED score-only over 16 pairs
x 30 kbp, also recorded) and the arguments of every split epilogue call
(the long-read run's three split levels). The other checkout's package
is then imported in place of this one, so that its own wrappers launch
its own kernels, built from its sources into its own build/ directory:
only the wrappers' Python signatures, `windowed_score_staged(st, ws, ovl,
hew_cells)`, `traceback_records(mat_pv, mat_mv, praw, traw, plen, tlen,
prolog)`, `stage_banded(batch, device)`, `sysband_raw(st)`,
`cscan_staged(st)` and `hirschberg_split(out, prolog, plen, tlen)`, must
agree; each checkout stages a deep-band batch with its own
`stage_banded`, so the staged layouts need not. Each recorded batch goes
through both, the outputs must be equal (the systolic pass's ABORT flags,
and its other lanes under its contract: scores, first and last, pv/mv on
[first, last]; the split's feasibility flags, and its values on the
feasible tasks), and both are timed by CUDA events in turns (other, this,
this, other), the median of 3 runs each; the split, shorter than its
wrapper's host time, by its kernel's device time (torch.profiler), in the
same turns. Exits non-zero if the outputs differ.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys

PKG = "quicked_tpu_torch"


MODULES = {"windowed_score_staged": "windowed_cuda",
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
    from quicked_tpu_torch.ops import banded_traceback_cuda as btc
    from quicked_tpu_torch.ops import windowed_cuda as wc
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    recorded = [
        ("10kbp", cs.record_run(cs.make_pairs(
            generate, args.pairs, args.length, cs.SEED + 10), True)),
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
        chunk = rec.chunk[0]
        ok &= turns(f"traceback_{tag}",
                    "B {2}, T {0}, EBB {1}".format(*chunk[0].shape),
                    lambda: other_traceback(*chunk),
                    lambda: btc.traceback_records(*chunk))
        ok &= deep_turns(tag, rec, other)
        ok &= hsplit_turns(tag, rec, other)
    ok &= deep_turns("banded", banded, other)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
