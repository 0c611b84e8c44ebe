"""Data-parallel alignment over all visible cards: the banded score
kernel with its lanes sharded over a device mesh, one contiguous lane
slice a card (no reference counterpart: it replaces host threads with
cards). `--device cpu` shards over eight CPU shards instead."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quicked_tpu_torch import generate
from quicked_tpu_torch.ops.batch_prep import (extract_final_scores,
                                              prepare_banded_batch)
from quicked_tpu_torch.parallel.mesh import make_mesh, run_banded_sharded

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the default) or cpu (the plain PyTorch versions)")
args = ap.parse_args()

mesh = (make_mesh(devices=["cpu"] * 8) if args.device == "cpu"
        else make_mesh())
n = max(8, 2 * mesh.size)
pairs = list(generate.generate_pairs(n, 300, error=0.1, seed=12))

cutoffs = [max(len(p), len(t)) * 40 // 100 for p, t in pairs]
batch = prepare_banded_batch([p for p, _ in pairs], [t for _, t in pairs],
                             cutoffs, full=False, pad_to_b=n)
out = run_banded_sharded(batch, mesh)
scores = extract_final_scores(batch, out["scores_by_k"][:, :n])
print(f"devices: {mesh.size}; scores: {scores}")
