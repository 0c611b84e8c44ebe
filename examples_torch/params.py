"""Parameter setters + exception handling
(examples/bindings/params.cpp parity: camelCase setter surface) through
quicked_tpu_torch, on the card."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quicked_tpu_torch import BANDED
from quicked_tpu_torch.api import QuickedAligner
from quicked_tpu_torch.params import QuickedException

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (the default) or cpu (the plain PyTorch versions)")
args = ap.parse_args()

pattern = "ACGT"
text = "ACTT"

print(f"Aligning {pattern} and {text} using Banded")
try:
    aligner = QuickedAligner(device=args.device)   # default parameters
    aligner.setAlgorithm(BANDED)     # select the algorithm: Banded
    aligner.setBandwidth(10)         # 10% of the seq. length (default 15%)
    aligner.setOnlyScore(True)       # only score: saves memory and time
    aligner.align(pattern, text)
    score = aligner.getScore()
    cigar = aligner.getCigar()
except QuickedException as e:
    print(e, file=sys.stderr)
    sys.exit(1)

print(f"Score: {score}")
print(f"Cigar <Expecting NULL>: {cigar}")
