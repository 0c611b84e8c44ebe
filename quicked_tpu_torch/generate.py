"""Synthetic dataset generation (generate_dataset.c semantics).

The port's copy of quicked_tpu/generate.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Random DNA of length L, extract-with-offset, inject ceil(e*L) random
mismatch/insertion/deletion errors (plus optional large indels), emit
(pattern, text) with the shorter sequence as pattern
(generate_dataset.c:354-417).
"""

from __future__ import annotations

import math
import random
from typing import Iterator

_ALPHABET = "ACGT"


def _generate_errors(seq: list[str], num_errors: int, rng: random.Random):
    """sequence_generate_errors (generate_dataset.c:170-199)."""
    for _ in range(num_errors):
        etype = rng.randrange(3)
        if not seq:
            # deletions emptied the sequence; the reference hits
            # rand%0 UB here — clamp to an insertion instead
            seq.insert(0, _ALPHABET[rng.randrange(4)])
            continue
        if etype == 0:  # mismatch
            while True:
                pos = rng.randrange(len(seq))
                ch = _ALPHABET[rng.randrange(4)]
                if seq[pos] != ch:
                    break
            seq[pos] = ch
        elif etype == 1:  # deletion
            pos = rng.randrange(len(seq))
            del seq[pos]
        else:  # insertion
            pos = rng.randrange(len(seq))
            seq.insert(pos, _ALPHABET[rng.randrange(4)])
    return seq


def _generate_indels(seq: list[str], max_indels: int, deletion_length: int,
                     rng: random.Random):
    """sequence_generate_indels (generate_dataset.c:204-245): each indel
    shrinks the sequence by EXACTLY deletion_length — when the drawn
    position lands within deletion_length of the tail, the reference's
    shift loop degenerates to truncating the last deletion_length
    chars (it still sets length -= deletion_length)."""
    indels = rng.randrange(max_indels + 1)
    for _ in range(indels):
        pos = rng.randrange(len(seq))       # drawn before the length check
        if deletion_length >= len(seq):
            continue
        new_len = len(seq) - deletion_length
        if pos <= new_len:
            del seq[pos:pos + deletion_length]
        else:
            del seq[new_len:]
    return seq


def text_length_for(pattern_length: int, length_diff: float) -> int:
    """ceilf((float)length * (float)length_diff) in FLOAT32 like the
    reference (generate_dataset.c:367) — float64 ceil differs, e.g.
    100 * 1.07 is 107.00000286 in f32 (ceil 108) but 107.0 in f64."""
    import numpy as np

    return int(np.ceil(np.float32(pattern_length) * np.float32(length_diff)))


def generate_pairs(num: int, length: int, error: float = 0.04,
                   length_diff: float = 1.0, indels_num: int = 0,
                   indels_length: int = 0,
                   seed: int | None = None) -> Iterator[tuple[str, str]]:
    """Yield (pattern, text) pairs; the shorter sequence is the pattern."""
    import numpy as np

    rng = random.Random(seed)
    pattern_length = length
    text_length = text_length_for(pattern_length, length_diff)
    seqlong_len = max(pattern_length, text_length)
    seqshort_len = min(pattern_length, text_length)
    # float32 ceilf like the reference (generate_dataset.c:370)
    num_errors = int(error) if error >= 1.0 else \
        int(np.ceil(np.float32(pattern_length) * np.float32(error)))
    for _ in range(num):
        seqlong = "".join(_ALPHABET[rng.randrange(4)] for _ in range(seqlong_len))
        offset = rng.randrange(seqlong_len - seqshort_len + 1)
        seqshort = list(seqlong[offset:offset + seqshort_len])
        if num_errors > 0:
            _generate_errors(seqshort, num_errors, rng)
        if indels_num > 0:
            _generate_indels(seqshort, indels_num, indels_length, rng)
        short = "".join(seqshort)
        # The reference prints ">short/<long" when the nominal pattern is
        # the shorter sequence, but "<long/>short" otherwise
        # (generate_dataset.c:399-409) — and align_benchmark takes LINE 1
        # as the pattern regardless of prefix (align_benchmark.c:88-93),
        # so for length_diff < 1 the LONG sequence is the pattern.
        if pattern_length <= text_length:
            yield short, seqlong
        else:
            yield seqlong, short
