"""BANDED algorithm with CIGAR (examples/banded.c parity) through
quicked_tpu_torch, on the card."""

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

params = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=10)
aligner = QuickedAligner(params, device=args.device)

pattern = "ACGT"
text = "ACTT"

print(f"Aligning '{pattern}' and '{text}' using Banded")
aligner.align(pattern, text)
print(f"Score: {aligner.get_score()}")
print(f"CIGAR: {aligner.get_cigar()}")
