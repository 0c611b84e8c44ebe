"""Heatmap: binned 2-D access matrix with CSV dump.

The port's copy of quicked_tpu/utils/heatmap.py.

Re-expresses the reference's standalone heatmap util
(quicked_utils/src/heatmap.c:38-165): a (num_rows x num_cols) binned
view over a value domain, with min/max/value set modes — a debugging /
visualization aid for DP-matrix access patterns (kept unwired in the
main path, as in the reference).
"""

from __future__ import annotations

import numpy as np

HEATMAP_MIN = 0
HEATMAP_MAX = 1
HEATMAP_VALUE = 2


class Heatmap:
    def __init__(self, num_rows: int, num_cols: int,
                 min_v: int, max_v: int, min_h: int, max_h: int,
                 mode: int = HEATMAP_VALUE):
        self.mode = mode
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.min_v, self.max_v = min_v, max_v
        self.min_h, self.max_h = min_h, max_h
        self.binning_v = max((max_v - min_v) / num_rows, 1e-12)
        self.binning_h = max((max_h - min_h) / num_cols, 1e-12)
        if mode == HEATMAP_MIN:
            self.values = np.full((num_rows, num_cols), np.iinfo(np.int64).max,
                                  dtype=np.int64)
        elif mode == HEATMAP_MAX:
            self.values = np.full((num_rows, num_cols),
                                  np.iinfo(np.int64).min, dtype=np.int64)
        else:
            self.values = np.zeros((num_rows, num_cols), dtype=np.int64)

    def _bin(self, v: int, h: int) -> tuple[int, int]:
        r = int((v - self.min_v) / self.binning_v)
        c = int((h - self.min_h) / self.binning_h)
        return (min(max(r, 0), self.num_rows - 1),
                min(max(c, 0), self.num_cols - 1))

    def set(self, v: int, h: int, value: int) -> None:
        r, c = self._bin(v, h)
        if self.mode == HEATMAP_MIN:
            self.values[r, c] = min(self.values[r, c], value)
        elif self.mode == HEATMAP_MAX:
            self.values[r, c] = max(self.values[r, c], value)
        else:
            self.values[r, c] = value

    def print(self, stream) -> None:
        """CSV dump (heatmap_print, heatmap.c)."""
        for r in range(self.num_rows):
            stream.write(",".join(str(int(x)) for x in self.values[r]))
            stream.write("\n")
