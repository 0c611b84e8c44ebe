"""pyquicked — module shim for the reference Python binding, on the port.

The counterpart of the repository root's pyquicked.py. The reference
builds a pybind11 module named ``pyquicked``
(bindings/python/quicked.cpp:30-66); its example does
``from pyquicked import QuickedAligner, QuickedException``
(examples/bindings/basic.py). This module gives that import's surface on
top of quicked_tpu_torch: the aligner class (with the camelCase
methods), both enums with their values exported at module level
(pybind11's ``export_values()`` semantics), and the exception. The
aligner runs on the CUDA card by default; ``QuickedAligner(device="cpu")``
runs the kernels' plain PyTorch versions.
"""

from quicked_tpu_torch import (
    QuickedAligner,
    QuickedAlgo,
    QuickedStatus,
    QuickedException,
)

# QuickedAlgo.export_values()
QUICKED = QuickedAlgo.QUICKED
WINDOWED = QuickedAlgo.WINDOWED
BANDED = QuickedAlgo.BANDED
HIRSCHBERG = QuickedAlgo.HIRSCHBERG

# QuickedStatus.export_values()
QUICKED_OK = QuickedStatus.QUICKED_OK
QUICKED_ERROR = QuickedStatus.QUICKED_ERROR
QUICKED_FAIL_NON_CONVERGENCE = QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE
QUICKED_UNKNOWN_ALGO = QuickedStatus.QUICKED_UNKNOWN_ALGO
QUICKED_EMPTY_SEQUENCE = QuickedStatus.QUICKED_EMPTY_SEQUENCE
QUICKED_UNIMPLEMENTED = QuickedStatus.QUICKED_UNIMPLEMENTED
QUICKED_WIP = QuickedStatus.QUICKED_WIP

__all__ = [
    "QuickedAligner", "QuickedAlgo", "QuickedStatus", "QuickedException",
    "QUICKED", "WINDOWED", "BANDED", "HIRSCHBERG",
    "QUICKED_OK", "QUICKED_ERROR", "QUICKED_FAIL_NON_CONVERGENCE",
    "QUICKED_UNKNOWN_ALGO", "QUICKED_EMPTY_SEQUENCE",
    "QUICKED_UNIMPLEMENTED", "QUICKED_WIP",
]
