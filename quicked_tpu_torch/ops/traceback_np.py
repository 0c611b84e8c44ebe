"""Host-side traceback over the kernel-produced band matrix.

The port's copy of quicked_tpu/ops/traceback_np.py. Reads the (T, EBB, B)
uint32 lo/hi Pv/Mv stacks of the full fill (the card's, through
`banded_cuda.full_planes_to_host`; column c of the stack = state after
text column c, reference column index c+1) and walks the alignment
path with the exact reference tie-break order
(banded_backtrace_matrix_cutoff, bpm_banded.c:967-1036): D, I, M, X.

The hot path is the native C walk (native/src/quicked_host.c,
qh_traceback_banded) operating on the batch planes in place; the pure
numpy walk below is the fallback and the readable specification.
"""

from __future__ import annotations

import numpy as np

W = 64


def banded_traceback_batch(mat_pv_lo, mat_pv_hi, mat_mv_lo, mat_mv_hi,
                           lanes, patterns_raw, texts_raw,
                           prologs) -> list[str]:
    """Traceback several lanes of one kernel invocation's (T, EBB, B)
    planes. patterns_raw/texts_raw: bytes per lane."""
    from quicked_tpu_torch import native

    if native.available():
        mats = [np.ascontiguousarray(m) for m in
                (mat_pv_lo, mat_pv_hi, mat_mv_lo, mat_mv_hi)]
        return [native.traceback_banded(*mats, lane, pat, txt, int(pro))
                for lane, pat, txt, pro in zip(lanes, patterns_raw,
                                               texts_raw, prologs)]
    return [
        banded_traceback_pair(
            mat_pv_lo[:, :, lane], mat_pv_hi[:, :, lane],
            mat_mv_lo[:, :, lane], mat_mv_hi[:, :, lane],
            np.frombuffer(pat, dtype=np.uint8),
            np.frombuffer(txt, dtype=np.uint8), int(pro))
        for lane, pat, txt, pro in zip(lanes, patterns_raw, texts_raw,
                                       prologs)]


def banded_traceback_pair(mat_pv_lo, mat_pv_hi, mat_mv_lo, mat_mv_hi,
                          pattern_raw: np.ndarray, text_raw: np.ndarray,
                          prolog: int) -> str:
    """Traceback one pair. mat_* are (T, EBB) uint32 arrays; the M-test
    compares RAW characters (bpm_banded.c:1012)."""
    tlen = len(text_raw)
    plen = len(pattern_raw)
    ebb = mat_pv_lo.shape[1]
    h = tlen - 1
    v = plen - 1
    ops = []

    def pv_bit(col, block, bit):
        # reference column index `col`; col 0 is the init column (all ones)
        if col == 0:
            return 1  # Pv init = ones
        w = mat_pv_lo[col - 1, block] if bit < 32 else mat_pv_hi[col - 1, block]
        return (int(w) >> (bit % 32)) & 1

    def mv_bit(col, block, bit):
        if col == 0:
            return 0
        w = mat_mv_lo[col - 1, block] if bit < 32 else mat_mv_hi[col - 1, block]
        return (int(w) >> (bit % 32)) & 1

    while v >= 0 and h >= 0:
        block_h = h // W
        block_h_r = (h + 1) // W
        eff_v = v - W * (block_h - prolog)
        eff_v_r = v - W * (block_h_r - prolog)
        block_v = eff_v // W
        block_v_r = eff_v_r // W
        bit = eff_v % W
        bit_r = eff_v_r % W
        if 0 <= block_v_r < ebb and pv_bit(h + 1, block_v_r, bit_r):
            ops.append("D")
            v -= 1
        elif 0 <= block_v < ebb and mv_bit(h, block_v, bit):
            ops.append("I")
            h -= 1
        elif int(text_raw[h]) == int(pattern_raw[v]):
            ops.append("M")
            h -= 1
            v -= 1
        else:
            ops.append("X")
            h -= 1
            v -= 1
    ops.append("I" * (h + 1))
    ops.append("D" * (v + 1))
    return "".join(ops)[::-1]
