"""mm_stack: push/pop scoped allocation states.

The port's copy of quicked_tpu/utils/mm_stack.py.

Re-expresses the reference's standalone mm_stack util
(quicked_utils/include/mm_stack.h:39-88): a segment-backed stack
allocator where push() opens a scope, allocations land in the current
segment (spilling to new segments as needed), and pop() frees every
allocation made since the matching push. Host Python has no use for
manual arenas (numpy owns buffers), so — like the reference, where
mm_stack has no consumer in the main path — this exists for inventory
parity and as a scoped-scratch bookkeeping helper.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEGMENT = 1 << 20


class MMStack:
    def __init__(self, segment_size: int = DEFAULT_SEGMENT):
        self.segment_size = segment_size
        self._segments: list[np.ndarray] = [
            np.empty(segment_size, dtype=np.uint8)]
        self._seg = 0
        self._used = 0
        self._states: list[tuple[int, int]] = []

    def push(self) -> None:
        """Open an allocation scope (mm_stack_push)."""
        self._states.append((self._seg, self._used))

    def pop(self) -> None:
        """Free everything allocated since the matching push
        (mm_stack_pop)."""
        self._seg, self._used = self._states.pop()

    def allocate(self, num_bytes: int, zero: bool = False,
                 align: int = 8) -> np.ndarray:
        """Allocate a uint8 view from the current segment
        (mm_stack_allocate); oversized requests get whole segments."""
        pad = (-self._used) % align
        start = self._used + pad
        if num_bytes > self.segment_size:
            seg = np.empty(num_bytes, dtype=np.uint8)
            self._segments.insert(self._seg + 1, seg)
            self._seg += 1
            self._used = num_bytes
            buf = seg[:num_bytes]
        else:
            if start + num_bytes > self.segment_size:
                self._seg += 1
                if self._seg == len(self._segments):
                    self._segments.append(
                        np.empty(self.segment_size, dtype=np.uint8))
                start = 0
            self._used = start + num_bytes
            buf = self._segments[self._seg][start:start + num_bytes]
        if zero:
            buf[:] = 0
        return buf
