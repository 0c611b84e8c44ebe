"""quicked_tpu_torch — the PyTorch/CUDA port of quicked_tpu.

The batched QuickEd cascade (windowed bound, banded score, Hirschberg
under the proven bound) on an NVIDIA H100 through hand-written CUDA
kernels (`csrc/`), bit-identical to the JAX package `quicked_tpu`, which
stays the reference. The port imports nothing of `quicked_tpu`: it keeps
its own copies of the host-only modules it needs (dna, cigar, params,
generate, seqio, ops.batch_prep, ops.myers_np, ops.edit_dp,
utils.profiler, utils.memreport, and the host C runtime in native/,
which builds into build/quicked_tpu_torch/). Its command-line tools (align_benchmark,
generate_dataset, quicked_harness) run as
`python -m quicked_tpu_torch.tools.<name>`.

Public surface, the JAX package's (`quicked_tpu/__init__.py`):

  - QuickedAlgo / QuickedStatus / QuickedParams  (params.py)
  - QuickedAligner        — single-pair convenience API (api.py)
  - BatchAligner          — the batch-first production API (api.py)
  - Cigar                 — alignment-path container (cigar.py)

Every aligner entry takes `device` ("cuda" by default; "cpu" runs the
kernels' plain PyTorch versions).
"""

from quicked_tpu_torch.params import (
    QuickedAlgo,
    QuickedStatus,
    QuickedParams,
    QuickedException,
    default_params,
    status_msg,
    check_error,
    QUICKED_WINDOW_STAGES,
    QUICKED_FAST_WINDOW_SIZE,
    QUICKED_FAST_WINDOW_OVERLAP,
)
from quicked_tpu_torch.cigar import Cigar
from quicked_tpu_torch.api import QuickedAligner, BatchAligner, align_batch

# the reference enum spellings (bindings/python/quicked.cpp:48-63)
QUICKED = QuickedAlgo.QUICKED
WINDOWED = QuickedAlgo.WINDOWED
BANDED = QuickedAlgo.BANDED
HIRSCHBERG = QuickedAlgo.HIRSCHBERG

__version__ = "0.1.0"

__all__ = [
    "QuickedAlgo",
    "QuickedStatus",
    "QuickedParams",
    "QuickedException",
    "QuickedAligner",
    "BatchAligner",
    "align_batch",
    "Cigar",
    "default_params",
    "status_msg",
    "check_error",
    "QUICKED",
    "WINDOWED",
    "BANDED",
    "HIRSCHBERG",
    "QUICKED_WINDOW_STAGES",
    "QUICKED_FAST_WINDOW_SIZE",
    "QUICKED_FAST_WINDOW_OVERLAP",
]
