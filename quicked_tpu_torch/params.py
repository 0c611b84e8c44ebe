"""Parameters, algorithm selection and status codes.

The port's copy of quicked_tpu/params.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Mirrors the reference public API surface (quicked/quicked.h:36-99):
`quicked_algo_t`, `quicked_params_t`, `quicked_status_t`,
`quicked_default_params`, `quicked_status_msg`, `quicked_check_error`.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

# Cascade constants (quicked/quicked.h:32-34)
QUICKED_WINDOW_STAGES = 2
QUICKED_FAST_WINDOW_SIZE = 2
QUICKED_FAST_WINDOW_OVERLAP = 1

# Hirschberg base-case memory budget in bytes (bpm_hirschberg.c:63-65 uses
# BUFFER_SIZE_16M from commons.h).
HIRSCHBERG_BUFFER_SIZE = 16 * 1024 * 1024

# Myers block geometry of the *semantic* model: 64-row blocks, exactly like
# the reference (bpm_commons.h:31-36). The TPU kernels emulate 64-bit words
# as pairs of uint32 lanes but keep this geometry bit-exact.
W = 64
ALPHABET = 5


class QuickedAlgo(IntEnum):
    """Algorithm selector (quicked.h:36-41)."""

    QUICKED = 0
    WINDOWED = 1
    BANDED = 2
    HIRSCHBERG = 3


class QuickedStatus(IntEnum):
    """Status codes (quicked.h:69-79)."""

    QUICKED_OK = 0
    QUICKED_ERROR = -1
    QUICKED_FAIL_NON_CONVERGENCE = -2
    QUICKED_UNKNOWN_ALGO = -3
    QUICKED_EMPTY_SEQUENCE = -4
    QUICKED_UNIMPLEMENTED = -10
    QUICKED_WIP = 1


_STATUS_MESSAGES = {
    QuickedStatus.QUICKED_ERROR: "ERROR: QuickEd has finished with unspecific error\n",
    QuickedStatus.QUICKED_FAIL_NON_CONVERGENCE: (
        "ERROR: Hirschberg algorithm can not find a middle point of "
        "subsequence division!\n"
    ),
    QuickedStatus.QUICKED_UNIMPLEMENTED: (
        "ERROR: The algorithm or parameter combination selected is not implemented\n"
    ),
    QuickedStatus.QUICKED_UNKNOWN_ALGO: "ERROR: Unknown algorithm selection\n",
    QuickedStatus.QUICKED_EMPTY_SEQUENCE: "ERROR: Tried to align an empty sequence\n",
}


def check_error(status: QuickedStatus | int) -> bool:
    """True iff `status` is an error (quicked.c:380)."""
    return int(status) < 0


def status_msg(status: QuickedStatus | int) -> str:
    """Human-readable status message (quicked.c:382-403)."""
    try:
        status = QuickedStatus(int(status))
    except ValueError:
        return "QuickEd finished without errors.\n"
    return _STATUS_MESSAGES.get(status, "QuickEd finished without errors.\n")


class QuickedException(Exception):
    """Raised by the high-level API on error statuses (bindings/cpp/quicked.hpp:36-45)."""

    def __init__(self, status: QuickedStatus | int):
        try:
            self.status = QuickedStatus(int(status))
        except ValueError:
            # unmapped native code: carry the raw int rather than
            # replacing the exception with a ValueError
            self.status = int(status)
        super().__init__(status_msg(status).strip())


@dataclasses.dataclass
class QuickedParams:
    """Alignment parameters (quicked.h:43-54).

    Defaults follow `quicked_default_params` (quicked.c:308-321).

    `force_scalar` switches the host C banded kernels to their scalar
    column loop (the reference's runtime SIMD toggle,
    bpm_banded.c:1049-1059); the TPU kernels have a single vectorised
    implementation, so it only affects work routed to the host.
    Like the reference's toggle it is a PROCESS-GLOBAL switch in the C
    runtime: concurrent calls with different values race (last writer
    wins for the overlap), and first-use calibration pins it off for
    the duration of the probe. Results stay bit-exact either way
    (scalar/vector parity is tested); only timing is affected.
    """

    algo: QuickedAlgo = QuickedAlgo.QUICKED
    bandwidth: int = 15
    window_size: int = 9
    overlap_size: int = 1
    hew_threshold: tuple[int, int] = (40, 40)
    hew_percentage: tuple[int, int] = (15, 15)
    only_score: bool = False
    force_scalar: bool = False
    # Execution knob (no reference counterpart):
    #   use_kernels: route compute through the device kernels (True) or the
    #   exact numpy semantic model (False; used by tests / tiny inputs).
    use_kernels: bool = True

    def replace(self, **kw) -> "QuickedParams":
        return dataclasses.replace(self, **kw)


def default_params() -> QuickedParams:
    """Equivalent of quicked_default_params() (quicked.c:308-321)."""
    return QuickedParams()
