"""Bitmap: 64-bit blocks with rank counters.

The port's copy of quicked_tpu/utils/bitmap.py.

Re-expresses the reference's standalone bitmap util
(quicked_utils/include/bitmap.h:54-93): set bits block-wise, then build
per-block cumulative popcounts so rank(pos) = #set bits strictly before
pos is O(1) (kept unwired in the main path, as in the reference).
"""

from __future__ import annotations

import numpy as np

BITMAP_BLOCK_ELEMENTS = 64


class Bitmap:
    def __init__(self, num_bits: int):
        self.num_bits = num_bits
        n_blocks = (num_bits + 63) // 64
        self.bitmap = np.zeros(n_blocks, dtype=np.uint64)
        self.counters = np.zeros(n_blocks, dtype=np.int64)
        self._built = False

    def set_bit(self, pos: int) -> None:
        self.bitmap[pos // 64] |= np.uint64(1 << (pos % 64))
        self._built = False

    def is_set(self, pos: int) -> bool:
        return bool((int(self.bitmap[pos // 64]) >> (pos % 64)) & 1)

    def update_counters(self) -> None:
        """Build cumulative rank counters (bitmap_update_counters)."""
        pops = np.array([int(b).bit_count() for b in self.bitmap],
                        dtype=np.int64)
        self.counters[0] = 0
        np.cumsum(pops[:-1], out=self.counters[1:])
        self._built = True

    def erank(self, pos: int) -> int:
        """Exclusive rank: #set bits strictly before `pos`."""
        if not self._built:
            self.update_counters()
        block = pos // 64
        mask = (1 << (pos % 64)) - 1
        return int(self.counters[block]) + \
            (int(self.bitmap[block]) & mask).bit_count()
