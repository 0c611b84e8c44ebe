"""The multi-device layer across every card of one host.

    python -m quicked_tpu_torch.parallel.multicard_check [--pairs N]
        [--length L] [--long-pairs N] [--long-length L]

Run from the repository root on a host with two or more CUDA cards. With
the pairs of chip_smoke.py's 10 kbp and long-read slices (the same
generator, seeds and sizes), it:

  1. runs `dryrun_multichip` over every card;
  2. aligns each slice on cuda:0, then on the last card alone (a launch on
     a card that is not the current one at the start, the windowed and
     systolic kernels' shared-memory opt-in made there), then under
     `use_mesh(make_mesh())`, a lane shard a card; every status, score
     and CIGAR must equal cuda:0's, and every card must have held a
     shard (its peak allocation in the meshed run);
  3. runs `distributed_align` in one process a card (the environment
     torchrun sets, range sharding, so that every process has a slice)
     over the 10 kbp pairs' `.seq` file; the merged TSV must equal the
     lines of cuda:0's results.

It prints each wall with every card's name and power limit, then, as its
last line, one JSON object with the walls. It exits non-zero on any
failure and on a host with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class CheckFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailure(msg)


def make_pairs(n, length, seed):
    """chip_smoke.py's slice pairs: half with four 500 bp indels."""
    from quicked_tpu_torch import generate

    half = n // 2
    pairs = list(generate.generate_pairs(half, length, error=0.1,
                                         indels_num=4, indels_length=500,
                                         seed=seed))
    pairs += list(generate.generate_pairs(n - half, length, error=0.1,
                                          seed=seed + 1))
    return pairs


def timed(fn):
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    res = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return res, time.perf_counter() - t0


def results(res):
    return [(int(s), int(c), g) for s, c, g in zip(res.status, res.score,
                                                  res.cigar)]


def run_distributed(seq, out, n, sharding):
    """distributed_align of `seq` into `out` in n processes started with
    the environment torchrun sets, rank r on cuda:(r % cards); returns
    their wall. Raises CheckFailure unless every process exits 0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = ("import sys\n"
              "from quicked_tpu_torch.parallel.distributed import (\n"
              "    distributed_align, maybe_initialize_distributed)\n"
              "rank, world = maybe_initialize_distributed()\n"
              f"assert world == {n}, world\n"
              "distributed_align(sys.argv[1], sys.argv[2], batch_size=250,"
              f" sharding={sharding!r})\n")
    env = dict(os.environ, PYTHONPATH=ROOT, WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, seq, out], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        errs = [p.communicate(timeout=900)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        check(p.returncode == 0, f"distributed rank {r} exited "
              f"{p.returncode}: {err[-2000:]}")
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--length", type=int, default=10_000)
    ap.add_argument("--long-pairs", type=int, default=100)
    ap.add_argument("--long-length", type=int, default=100_000)
    args = ap.parse_args(argv)

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"multicard_check: needs two or more CUDA cards, found {n}",
              file=sys.stderr)
        return 2

    from quicked_tpu_torch import _build, seqio
    from quicked_tpu_torch.api import BatchAligner
    from quicked_tpu_torch.params import QuickedParams
    from quicked_tpu_torch.parallel.dryrun import dryrun_multichip
    from quicked_tpu_torch.parallel.mesh import make_mesh, use_mesh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    cards = "; ".join(f"cuda:{i} {line}" for i, line in enumerate(smi))
    print(f"[cards] {n}: {cards}")
    report = {"cards": n}
    try:
        _build.load()
        print(f"[build] kernels built and loaded in "
              f"{_build.build_seconds:.1f} s")
        _, wall = timed(lambda: dryrun_multichip(n))
        print(f"[dryrun] dryrun_multichip({n}) passed in {wall:.3f} s")

        last = f"cuda:{n - 1}"
        slices = [("10kbp", make_pairs(args.pairs, args.length, 17)),
                  ("long", make_pairs(args.long_pairs, args.long_length,
                                      37))]
        mesh = make_mesh()
        for tag, pairs in slices:
            base, wall0 = timed(lambda: BatchAligner(
                QuickedParams(), device="cuda:0").align(pairs))
            want = results(base)
            one, wall1 = timed(lambda: BatchAligner(
                QuickedParams(), device=last).align(pairs))
            check(results(one) == want, f"{tag} on {last} differs from "
                  f"cuda:0")
            for i in range(n):
                torch.cuda.reset_peak_memory_stats(i)
            with use_mesh(mesh):
                meshed, walln = timed(lambda: BatchAligner(
                    QuickedParams(), device="cuda").align(pairs))
            check(results(meshed) == want, f"{tag} on the mesh of {n} "
                  f"cards differs from cuda:0")
            peaks = [torch.cuda.max_memory_allocated(i) for i in range(n)]
            check(all(peaks), f"{tag}: a card held no shard: {peaks}")
            print(f"[{tag}] {len(pairs)} pairs, every status, score and "
                  f"CIGAR equal: cuda:0 {wall0:.3f} s, {last} {wall1:.3f} "
                  f"s, mesh of {n} cards {walln:.3f} s; peak MiB per card "
                  f"{[round(p / 2**20, 1) for p in peaks]} ({cards})")
            report[tag] = dict(pairs=len(pairs), cuda0_s=wall0,
                               last_card_s=wall1, mesh_s=walln)
            if tag == "10kbp":
                lines = [seqio.format_output_lite(s, c)
                         for s, c in zip(base.score, base.cigar)]
                ten_kbp = pairs

        with tempfile.TemporaryDirectory() as td:
            seq = os.path.join(td, "pairs.seq")
            out = os.path.join(td, "out.tsv")
            seqio.write_seq_pairs(seq, ten_kbp)
            wall = run_distributed(seq, out, n, "range")
            with open(out) as f:
                got = f.read().splitlines()
            check(got == lines, "the distributed TSV differs from "
                  "cuda:0's results")
            print(f"[distributed] {n} processes, one a card (range "
                  f"sharding): {len(got)} lines equal to cuda:0's, "
                  f"{wall:.1f} s with the process starts")
            report["distributed_s"] = wall
    except CheckFailure as e:
        print(f"multicard_check: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(dict(ok=True, **report)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
