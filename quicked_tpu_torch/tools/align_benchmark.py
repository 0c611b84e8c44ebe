"""align_benchmark CLI (tools/align_benchmark/align_benchmark.c parity).

    python -m quicked_tpu_torch.tools.align_benchmark -a ALGO -i IN.seq
        [-o OUT.tsv] [--device cuda|cpu] ...

The port's counterpart of quicked_tpu/tools/align_benchmark.py, with the
same flags, TSV output (benchmark_utils.c:151-188), progress/results
reporting (align_benchmark.c:103-142) and `--check` modes
(benchmark_check.c), byte for byte. `--device` (cuda by default; cpu
runs the kernels' plain PyTorch versions) takes the place of
`--platform`; `--device cuda` without a card exits non-zero.

Pairs are streamed in batches (`--batch-size`) through the port's
batched CUDA kernels and, where the venue router sends them on a card
host, its host C lanes, in place of the reference's per-pair loop and
OpenMP batches (align_benchmark.c:232-306); `-t` caps the host lanes'
threads and `--force-scalar` switches their banded kernels to the scalar
path. The `--check
score|alignment` ground truth and the `-a edlib` comparison algorithm
run through an independent edlib oracle (tools/oracle_src/
edlib_oracle.cpp, built against the reference's vendored edlib) when it
is built, falling back to the exact DP for scores.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from quicked_tpu_torch import native, seqio
from quicked_tpu_torch.aligner.batch import router_ready
from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.device import resolve_device
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams
from quicked_tpu_torch.utils.profiler import Counter, PhaseTimers, Timer

ALGORITHMS = (
    "quicked", "edit-banded", "edit-banded-hirschberg", "edit-windowed",
    "edit-dp", "edit-dp-banded", "edit-bpm",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="align_benchmark",
        description="Batch sequence-alignment benchmark (PyTorch/CUDA)")
    p.add_argument("--algorithm", "-a", required=True,
                   choices=ALGORITHMS + ("edlib",))
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--output-full", default=None)
    # default None resolves per-algorithm (align_benchmark_params.c:
    # 268-312): 15 for the quicked family, unbanded (-1) for edlib
    p.add_argument("--bandwidth", type=int, default=None)
    p.add_argument("--window-size", type=int, default=9)
    p.add_argument("--overlap-size", type=int, default=1)
    p.add_argument("--hew-threshold", type=int, default=40)
    p.add_argument("--hew-percentage", type=int, default=15)
    p.add_argument("--force-scalar", action="store_true")
    p.add_argument("--only-score", action="store_true",
                   help="score-only mode (no CIGAR computation)")
    p.add_argument("--check", "-c", default=None,
                   choices=("display", "correct", "score", "alignment"))
    p.add_argument("--num-threads", "-t", type=int, default=None,
                   help="cap the host C lanes' threads for the run (the "
                        "reference's OpenMP batch loop, "
                        "align_benchmark.c:232-306)")
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--progress", "-P", type=int, default=100000)
    p.add_argument("--verbose", "-v", nargs="?", const=1, type=int,
                   default=0)
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA card (default; exits non-zero "
                        "without one) or on the CPU (the kernels' plain "
                        "PyTorch versions)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record the run with torch.profiler (CPU and CUDA "
                        "activities) and write a Chrome trace into DIR")
    p.add_argument("--memory-report", action="store_true",
                   help="print the engine memory report (budgets, plane"
                        " allocations, host RSS, device stats) after the"
                        " run — the mm_allocator occupancy analogue")
    return p


def _params_from_args(args) -> QuickedParams:
    algo = {
        "quicked": QuickedAlgo.QUICKED,
        "edit-banded": QuickedAlgo.BANDED,
        "edit-banded-hirschberg": QuickedAlgo.HIRSCHBERG,
        "edit-windowed": QuickedAlgo.WINDOWED,
    }.get(args.algorithm, QuickedAlgo.QUICKED)
    return QuickedParams(
        algo=algo, bandwidth=args.bandwidth, window_size=args.window_size,
        overlap_size=args.overlap_size,
        hew_threshold=(args.hew_threshold,) * 2,
        hew_percentage=(args.hew_percentage,) * 2,
        only_score=args.only_score, force_scalar=args.force_scalar)


def _align_oracle_batch(pairs, only_score, banded=False, bandwidth=15):
    """Exact-score/CIGAR oracles run through the numpy models
    (edit-dp / edit-dp-banded selectable algorithms; edit_dp.c:68-133)."""
    from quicked_tpu_torch.ops import edit_dp

    out = []
    for p, t in pairs:
        if banded:
            bk = max(len(p), len(t)) * bandwidth // 100
            D = edit_dp.edit_dp_matrix_banded(p, t, bk)
        else:
            D = edit_dp.edit_dp_matrix(p, t)
        score = int(D[-1, -1])
        ops = None if only_score else edit_dp.edit_dp_traceback(D, p, t)
        out.append((score, ops))
    return out


def _align_bpm_batch(pairs, only_score, device):
    """edit-bpm: full-pattern Myers (edit_bpm.c semantics) — expressed as
    a full-width band (cutoff = max length makes the band exact)."""
    from quicked_tpu_torch.aligner.batch import banded_align_batch

    cutoffs = [max(len(p), len(t)) for p, t in pairs]
    scores, ops = banded_align_batch(
        [p for p, _ in pairs], [t for _, t in pairs], cutoffs,
        only_score=only_score, device=device)
    return list(zip([int(s) for s in scores], ops))


def _exact_oracle(p, t):
    """Fallback ground truth (score, ops) via the exact DP when the
    edlib oracle shim is unavailable."""
    from quicked_tpu_torch.ops import edit_dp

    D = edit_dp.edit_dp_matrix(p, t)
    return int(D[-1, -1]), edit_dp.edit_dp_traceback(D, p, t)


def _truth_batch(pairs):
    """Ground truth [(score, ops)] for --check score|alignment: the
    INDEPENDENT edlib oracle (benchmark_check.c:117-158 semantics,
    unbanded) when available, else the exact DP."""
    from quicked_tpu_torch.tools._edlib_oracle import edlib_batch

    res = edlib_batch(pairs, bandwidth=-1)
    if res is not None:
        return [(sc, Cigar.from_rle(cig).operations) for sc, cig in res]
    return [_exact_oracle(p, t) for p, t in pairs]


class CheckStats:
    """Accuracy counters (align_input_t, benchmark_utils.h:38-85)."""

    def __init__(self):
        self.align = Counter()
        self.align_correct = Counter()
        self.align_score = Counter()
        self.align_score_total = Counter()
        self.align_score_diff = Counter()
        self.align_cigar = Counter()
        self.align_bases = Counter()
        self.align_matches = Counter()
        self.align_mismatches = Counter()
        self.align_ins = Counter()
        self.align_del = Counter()


def _check_pair(mode, pattern, text, score, cigar_rle, stats, verbose,
                truth=None):
    """benchmark_check_alignment_using_solution semantics — counters,
    early-exit structure, and accumulation bases match the reference
    exactly (benchmark_check.c:33-113): samples only on success,
    |computed| score totalled unconditionally, bases = pattern length,
    each failed stage aborts the later checks. `truth` is a precomputed
    (score, ops) oracle tuple (edlib when the shim is available)."""
    stats.align.add(1)
    stats.align_score_total.add(abs(score))
    ops = Cigar.from_rle(cigar_rle).operations if cigar_rle else None
    # CHECK_CORRECT (all three modes)
    if ops is not None:
        c = Cigar(operations=ops)
        if not c.check_alignment(pattern, text):
            if verbose:
                print("INCORRECT ALIGNMENT", file=sys.stderr)
            return
        stats.align_correct.add(1)
        stats.align_bases.add(len(pattern))
        # O(1)-per-pair breakdown: all samples are 1, so add_repeat is
        # bit-exact with the reference's per-op counter_add loop
        stats.align_matches.add_repeat(1, ops.count("M"))
        stats.align_mismatches.add_repeat(1, ops.count("X"))
        stats.align_ins.add_repeat(1, ops.count("I"))
        stats.align_del.add_repeat(1, len(ops) - ops.count("M")
                                   - ops.count("X") - ops.count("I"))
    else:
        stats.align_correct.add(1)
    if mode in ("score", "alignment"):
        true_score, true_ops = (truth if truth is not None
                                else _exact_oracle(pattern, text))
        if score != true_score:
            if verbose:
                print(f"INACCURATE SCORE computed={score} "
                      f"correct={true_score}", file=sys.stderr)
            stats.align_score_diff.add(abs(score - true_score))
            return
        stats.align_score.add(1)
        if mode == "alignment" and ops is not None:
            if ops != true_ops:
                return
            stats.align_cigar.add(1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.algorithm == "edlib":
        from quicked_tpu_torch.tools._edlib_oracle import find_edlib_oracle

        if find_edlib_oracle() is None:
            print("ERROR: the edlib oracle shim is unavailable (no "
                  "reference checkout / C++ toolchain); use "
                  "edit-dp/edit-bpm as exact baselines", file=sys.stderr)
            return 1
    if args.bandwidth is None:
        # per-algorithm resolution (align_benchmark_params.c:268-312)
        args.bandwidth = -1 if args.algorithm == "edlib" else 15
    if not os.path.exists(args.input):
        print(f"ERROR: input file '{args.input}' not found", file=sys.stderr)
        return 1

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1

    params = _params_from_args(args)
    timers = PhaseTimers()
    timer_global = Timer()
    out_file = None
    output_full = False
    if args.output_full:
        out_file = open(args.output_full, "w")
        output_full = True
    elif args.output:
        out_file = open(args.output, "w")
    stats = CheckStats() if args.check in ("correct", "score",
                                           "alignment") else None

    profiler = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()

    n_processed = 0
    # -t caps the host C lanes through a thread budget, not the process
    # environment, so that nothing outlives the run
    budget = (native.thread_budget(args.num_threads)
              if args.num_threads is not None else contextlib.nullcontext())
    with budget:
        # the router's probes and first-use calibration, before the clock
        native.set_force_scalar(params.force_scalar)
        router_ready(device)
        timer_global.start()
        try:
            for batch_pairs in seqio.read_seq_batches(args.input,
                                                      args.batch_size):
                n_processed += _run_batch(args, params, timers, batch_pairs,
                                          out_file, output_full, stats,
                                          n_processed, timer_global, device)
        finally:
            timer_global.stop()
            if profiler is not None:
                profiler.stop()
                os.makedirs(args.profile, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(args.profile, "align_benchmark.trace.json"))
            if out_file:
                out_file.close()

    if not args.quiet:
        _print_results(args, timers, timer_global, stats, n_processed)
    return 0


def _run_batch(args, params, timers, pairs, out_file, output_full, stats,
               already, timer_global, device):
    from quicked_tpu_torch.aligner.batch import align_batch_full
    from quicked_tpu_torch.aligner.cascade import quicked_cascade_batch

    if args.algorithm == "edlib":
        from quicked_tpu_torch.tools._edlib_oracle import edlib_batch

        res = edlib_batch(pairs, bandwidth=args.bandwidth)
        if res is None:
            print("ERROR: edlib oracle failed", file=sys.stderr)
            raise SystemExit(1)
        scores = [r[0] for r in res]
        cigars = [r[1] for r in res]
        statuses = [0] * len(pairs)
    elif args.algorithm in ("edit-dp", "edit-dp-banded"):
        results = _align_oracle_batch(
            pairs, args.only_score,
            banded=args.algorithm == "edit-dp-banded",
            bandwidth=args.bandwidth)
        scores = [r[0] for r in results]
        cigars = [None if r[1] is None else Cigar(operations=r[1]).sprint(True)
                  for r in results]
        statuses = [0] * len(pairs)
    elif args.algorithm == "edit-bpm":
        results = _align_bpm_batch(pairs, args.only_score, device)
        # score comes from the CIGAR (benchmark_print_output semantics):
        # the raw-char traceback can emit X where the encoded DP matched
        scores = [r[0] if r[1] is None else Cigar(operations=r[1]).score_edit()
                  for r in results]
        cigars = [None if r[1] is None else Cigar(operations=r[1]).sprint(True)
                  for r in results]
        statuses = [0] * len(pairs)
    elif args.algorithm == "quicked":
        res = quicked_cascade_batch(pairs, params, timers=timers,
                                    device=device)
        scores, cigars, statuses = res.score, res.cigar, res.status
    else:
        res = align_batch_full(pairs, params, device=device)
        scores, cigars, statuses = res.score, res.cigar, res.status

    truths = None
    if stats is not None and args.check in ("score", "alignment"):
        truths = _truth_batch(pairs)

    for i, (pattern, text) in enumerate(pairs):
        err = int(statuses[i]) < 0
        if out_file:
            if err:
                score_s, cigar_s = "ERROR", ("-" if args.only_score
                                             else "ERROR")
            else:
                score_s = str(int(scores[i]))
                cigar_s = "-" if cigars[i] is None else cigars[i]
            if output_full:
                out_file.write(f"{len(pattern)}\t{len(text)}\t{score_s}\t"
                               f"{pattern}\t{text}\t{cigar_s}\n")
            else:
                out_file.write(f"{score_s}\t{cigar_s}\n")
        if args.check == "display" and not err and cigars[i]:
            c = Cigar.from_rle(cigars[i])
            print(f"PATTERN/TEXT lengths {len(pattern)}/{len(text)} "
                  f"score {int(scores[i])}", file=sys.stderr)
            print(c.print_pretty(pattern, text), file=sys.stderr)
        if stats is not None and not err:
            _check_pair(args.check, pattern, text, int(scores[i]),
                        cigars[i], stats, args.verbose,
                        truth=truths[i] if truths else None)

    total = already + len(pairs)
    if args.progress and total // args.progress > already // args.progress \
            and not args.quiet:
        rate = total / max(timer_global.total_ns() / 1e9, 1e-9)
        print(f"...processed {total} reads (alignment = {rate:2.3f} seq/s)",
              file=sys.stderr)
    return len(pairs)


def _print_results(args, timers, timer_global, stats, n):
    err = sys.stderr
    if getattr(args, "memory_report", False):
        from quicked_tpu_torch.utils import memreport
        memreport.print_report(err)
    print("[Benchmark]", file=err)
    print(f"=> Total.reads              {n}", file=err)
    err.write("=> Time.Benchmark        ")
    timer_global.print(err)
    if args.algorithm == "quicked" and args.verbose:
        err.write("  => Time.Windowed Small ")
        timers.windowed_s.print(err, timer_global)
        err.write("  => Time.Windowed Large ")
        timers.windowed_l.print(err, timer_global)
        err.write("  => Time.Banded         ")
        timers.banded.print(err, timer_global)
        err.write("  => Time.Align          ")
        timers.align.print(err, timer_global)
    if stats is not None:
        print("[Accuracy]", file=err)
        err.write(" => Alignments.Correct     ")
        stats.align_correct.print(err, stats.align, "alg       ")
        if args.check in ("score", "alignment"):
            err.write(" => Score.Correct          ")
            stats.align_score.print(err, stats.align, "alg       ")
            err.write("   => Score.Total          ")
            stats.align_score_total.print(err, None, "score uds.")
            err.write("     => Score.Diff         ")
            stats.align_score_diff.print(err, stats.align_score_total,
                                         "score uds.")
        if args.check == "alignment":
            err.write(" => CIGAR.Correct          ")
            stats.align_cigar.print(err, stats.align, "alg       ")
        err.write(" => CIGAR.Breakdown        \n")
        for label, c in (("Matches   ", stats.align_matches),
                         ("Mismatches", stats.align_mismatches),
                         ("Insertions", stats.align_ins),
                         ("Deletions ", stats.align_del)):
            err.write(f"   => CIGAR.{label}     ")
            c.print(err, stats.align_bases, "bases     ")


if __name__ == "__main__":
    sys.exit(main())
