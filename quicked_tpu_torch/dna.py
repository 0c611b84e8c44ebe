"""DNA alphabet encoding.

The port's copy of quicked_tpu/dna.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Semantics of the reference 5-letter encoding (quicked_utils/src/dna_text.c:41-46):
A/a->0, C/c->1, G/g->2, T/t->3, everything else (incl. N/n) -> 4.
"""

from __future__ import annotations

import numpy as np

ENC_A, ENC_C, ENC_G, ENC_T, ENC_N = 0, 1, 2, 3, 4
ALPHABET_SIZE = 5

_ENCODE_TABLE = np.full(256, ENC_N, dtype=np.uint8)
for _c, _e in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("N", 4)):
    _ENCODE_TABLE[ord(_c)] = _e
    _ENCODE_TABLE[ord(_c.lower())] = _e

_DECODE_TABLE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Encode a sequence into the 5-letter alphabet (uint8 array)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    if isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return _ENCODE_TABLE[raw]


def decode(enc: np.ndarray) -> str:
    """Decode a 5-letter-encoded array back to an ACGTN string."""
    enc = np.asarray(enc, dtype=np.uint8)
    return _DECODE_TABLE[enc].tobytes().decode("ascii")


def reverse(seq: str) -> str:
    """Reverse a sequence (quicked_utils/src/commons.c:81-87 reverse_string)."""
    return seq[::-1]
