"""Where the host's time goes in the card lane: cProfile of one pinned
`BatchAligner.align` on each cell of the benchmark.

    python3 -m quicked_tpu_torch.host_profile [--cell NAME] [--top N]
                                              [--out DIR]

Run from the repository root on a machine with a CUDA card. For each cell
of `benchmarks_torch/cells.py` (all three by default) it builds the cell's
pairs, runs `BatchAligner.align` once with the card pinned
(QUICKED_TPU_PIN_CARD=1) as a warm-up, then once more under `cProfile`,
and prints that run's wall (ending in `torch.cuda.synchronize()`), its
stage seconds (`PhaseTimers`) and the top N functions by their own time
and by their cumulative time. A third, unprofiled run gives the wall
without the profiler's cost. With `--out DIR` the full profiles are
written there as `<cell>.pstats`. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

STAGES = ("windowed_s", "windowed_l", "banded", "align", "total")


def _top(prof, key: str, n: int) -> str:
    out = io.StringIO()
    st = pstats.Stats(prof, stream=out)
    st.sort_stats(key).print_stats(n)
    lines = out.getvalue().splitlines()
    # from the table's header on: the run's totals and the rows
    head = next((i for i, x in enumerate(lines) if "ncalls" in x), 0)
    return "\n".join(lines[head:])


def profile_cell(cell, top: int, out_dir: str | None):
    import torch

    from quicked_tpu_torch.aligner import batch as ab
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.utils.profiler import PhaseTimers
    from benchmarks_torch import cells

    pairs = cell.pairs()
    aligner = BatchAligner(cells.quicked_defaults(), device="cuda")
    os.environ[ab.PIN_CARD_ENV] = "1"
    try:
        def run(prof=None):
            timers = PhaseTimers()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if prof is not None:
                prof.enable()
            aligner.align(pairs, timers=timers)
            torch.cuda.synchronize()
            if prof is not None:
                prof.disable()
            return time.perf_counter() - t0, {
                s: getattr(timers, s).total_ns() / 1e9 for s in STAGES}

        run()                                   # warm-up
        prof = cProfile.Profile()
        wall_p, stages = run(prof)
        wall, stages_plain = run()
    finally:
        os.environ.pop(ab.PIN_CARD_ENV, None)
    tag = f"[{cell.name}]"
    print(f"{tag} pinned wall {wall:.4f} s unprofiled, {wall_p:.4f} s "
          f"under cProfile")
    print(f"{tag} stage seconds unprofiled: " + ", ".join(
        f"{s} {v:.4f}" for s, v in stages_plain.items()))
    print(f"{tag} stage seconds under cProfile: " + ", ".join(
        f"{s} {v:.4f}" for s, v in stages.items()))
    print(f"{tag} top {top} by own time (tottime):")
    print(_top(prof, "tottime", top))
    print(f"{tag} top {top} by cumulative time:")
    print(_top(prof, "cumulative", top))
    if out_dir:
        prof.dump_stats(os.path.join(out_dir, f"{cell.name}.pstats"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", action="append")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("host_profile: no CUDA card", file=sys.stderr)
        return 2
    root = os.getcwd()
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmarks_torch import cells
    from quicked_tpu_torch import _build, native

    _build.load()
    if not native.available():
        print("host_profile: the host C library did not build",
              file=sys.stderr)
        return 1
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    print(f"[host_profile] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, {native.default_threads()} host C threads")
    for name in args.cell or list(cells.CELLS):
        profile_cell(cells.CELLS[name], args.top, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
