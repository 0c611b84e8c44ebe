"""Batch-first alignment: the production surface. The unit of work is a
batch of pairs, bucketed onto the card's kernels (no reference
counterpart: this replaces the OpenMP batch loop of
align_benchmark.c:232-306)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quicked_tpu_torch import generate
from quicked_tpu_torch.api import BatchAligner

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the default) or cpu (the plain PyTorch versions)")
args = ap.parse_args()

pairs = list(generate.generate_pairs(32, 200, error=0.1, seed=11))

aligner = BatchAligner(device=args.device)
result = aligner.align(pairs)

for i in range(3):
    print(f"pair {i}: score={result.score[i]} cigar={result.cigar[i][:40]}...")
print(f"... {len(pairs)} pairs aligned")
