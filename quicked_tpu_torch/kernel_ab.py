"""Time the windowed score and banded traceback kernels of another
checkout of this repository against this one's, in turns on one card, at
the shapes the aligner hands them.

    python3 -m quicked_tpu_torch.kernel_ab OTHER [--pairs N] [--length L]
                                           [--long-pairs N] [--long-length L]

Run from the repository root on a machine with a CUDA card. OTHER is the
root of the other checkout, for example the parent commit unpacked with
`git archive <commit> | tar -x -C build/parent`. chip_smoke.py's two
slices (N pairs x L bp and the long-read pairs, made from the same seeds)
are aligned once by this checkout while chip_smoke's `Recorder` keeps
every windowed batch and one traceback chunk (the 10 kbp run's largest,
the long-read run's first). The other checkout's package is then imported
in place of this one, so that its own wrappers launch its own kernels,
built from its sources into its own build/ directory: only the wrappers'
Python signatures, `windowed_score_staged(st, ws, ovl, hew_cells)` and
`traceback_records(mat_pv, mat_mv, praw, traw, plen, tlen, prolog)`, and
what they take must agree. Each recorded batch goes through both, the
outputs must be equal, and both are timed by CUDA events in turns (other,
this, this, other), the median of 3 runs each. Exits non-zero if the
outputs differ.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys

PKG = "quicked_tpu_torch"


def load_other(root: str):
    """The other checkout's `windowed_score_staged` and
    `traceback_records`: its package imported under this one's name, then
    this one's modules put back (the other's functions keep their own
    module globals)."""
    def ours(name):
        return name == PKG or name.startswith(PKG + ".")

    mine = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    try:
        wc = importlib.import_module(PKG + ".ops.windowed_cuda")
        btc = importlib.import_module(PKG + ".ops.banded_traceback_cuda")
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(mine)
    if not wc.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {wc.__file__}, not from {root}")
    return wc.windowed_score_staged, btc.traceback_records


def turns(name, shape, other, this):
    """Outputs of both equal, then CUDA-event medians in turns; False if
    the outputs differ."""
    import torch

    from chip_smoke import cuda_ms

    a, b = other(), this()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        print(f"[A/B] {name} ({shape}): outputs differ")
        return False
    t = [cuda_ms(f, 3) for f in (other, this, this, other)]
    print(f"[A/B] {name} ({shape}): other {t[0]:.3f} / {t[3]:.3f} ms, this "
          f"{t[1]:.3f} / {t[2]:.3f} ms, outputs equal")
    return True


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
    other_windowed, other_traceback = load_other(args.other)
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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
