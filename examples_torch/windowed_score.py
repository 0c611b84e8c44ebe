"""WINDOWED algorithm, score-only (examples/windowed_score.c parity)
through quicked_tpu_torch, on the card."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quicked_tpu_torch.api import QuickedAligner
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the default) or cpu (the plain PyTorch versions)")
args = ap.parse_args()

params = QuickedParams(algo=QuickedAlgo.WINDOWED, window_size=2,
                       overlap_size=1, only_score=True)
aligner = QuickedAligner(params, device=args.device)

pattern = "ACGT"
text = "ACTT"

print(f"Aligning '{pattern}' and '{text}' using Windowed (score only)")
aligner.align(pattern, text)
print(f"Score: {aligner.get_score()}")
