"""Batched windowed score bound on the card (score-only mode).

The counterpart of quicked_tpu/ops/windowed_jax.py (`windowed_scan_impl`
in score mode, `run_windowed_score`). The CUDA kernel is
`csrc/windowed_score.cu`; `windowed_scan_torch` is the plain PyTorch
version, a port of the XLA while-loop. Full-CIGAR mode (tie-break
M, D, I, X) is not on the cascade's path and is not ported yet.

`WindowedBatch`, `prepare_windowed_batch` and `hew_cell_threshold` are
numpy helpers copied from windowed_jax.py, which imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quicked_tpu_torch import dna
from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.device import check_cuda, resolve_device, stream_ptr
from quicked_tpu_torch.ops.banded_cuda import advance_block, fuse_u64
from quicked_tpu_torch.ops.banded_traceback_cuda import (
    bit_at, highest_zero_at_or_below)
from quicked_tpu_torch.ops.batch_prep import pack_peq_batch
from quicked_tpu_torch.ops.myers_np import div_ceil

W = 64
# csrc/windowed_score.cu keeps a window of up to 16 blocks in the thread;
# a wider one goes to a scratch buffer the wrapper allocates
MAX_REG_WS = 16

WINDOWED = Kernel("qtt_windowed_score", [P] * 14 + [I] * 7 + [P])


@dataclasses.dataclass
class WindowedBatch:
    """Fixed-shape arrays for one windowed kernel invocation."""

    B: int
    KP: int                 # pattern PEQ rows
    T: int                  # text columns (>= 64*ws)
    P: int                  # pattern rows
    peq_lo: np.ndarray      # (KP, 5, B) u32
    peq_hi: np.ndarray
    text_enc: np.ndarray    # (T, B) i32
    text_raw: np.ndarray    # (T, B) i32 — raw bytes; M-test compares RAW
    pat_raw: np.ndarray     # (P, B) i32
    plen: np.ndarray        # (B,) i32
    tlen: np.ndarray
    num_words: np.ndarray


def hew_cell_threshold(window_size: int, overlap_size: int,
                       hew_threshold: int) -> int:
    """Cell count above which a window counts as high-error
    (bpm_windowed.c:925 semantics)."""
    return (window_size - overlap_size) * W * hew_threshold // 100


def _raw_i32(s, enc) -> np.ndarray:
    if isinstance(s, np.ndarray):
        return np.asarray(enc, dtype=np.int32)
    if s.isascii():
        return np.frombuffer(s.encode("ascii"),
                             dtype=np.uint8).astype(np.int32)
    # true char compare for non-ASCII input (cigar.check_alignment's
    # convention): a replacing encode would let distinct chars match
    return np.fromiter(map(ord, s), dtype=np.int32, count=len(s))


def prepare_windowed_batch(patterns, texts, *, window_size: int,
                           pad_to_b: int | None = None) -> WindowedBatch:
    n = len(patterns)
    enc_p = [p if isinstance(p, np.ndarray) else dna.encode(p)
             for p in patterns]
    enc_t = [t if isinstance(t, np.ndarray) else dna.encode(t) for t in texts]
    plen = np.array([len(p) for p in enc_p], dtype=np.int32)
    tlen = np.array([len(t) for t in enc_t], dtype=np.int32)
    B = pad_to_b or n
    assert B >= n
    cols = W * window_size
    KP = max(max(div_ceil(int(L), W), 1) for L in plen) if n else 1
    T = max(int(tlen.max()) if n else 1, cols)
    # at least one window tall: the kernel reads (cols,)-windows
    P = max(int(plen.max()) if n else 1, cols)

    peq_lo = np.zeros((KP, 5, B), dtype=np.uint32)
    peq_hi = np.zeros((KP, 5, B), dtype=np.uint32)
    text_enc = np.zeros((T, B), dtype=np.int32)
    text_raw = np.full((T, B), -1, dtype=np.int32)
    pat_raw = np.full((P, B), -2, dtype=np.int32)
    num_words = np.ones(B, dtype=np.int32)

    if n:
        max_nw = max(max(div_ceil(int(L), W), 1) for L in plen)
        lo, hi = pack_peq_batch(enc_p, max_nw)   # (max_nw, 5, n)
        peq_lo[:max_nw, :, :n] = lo
        peq_hi[:max_nw, :, :n] = hi
        num_words[:n] = np.maximum((plen.astype(np.int64) + W - 1) // W, 1)
    for b in range(n):
        tl = int(tlen[b])
        text_enc[:tl, b] = enc_t[b].astype(np.int32)
        text_raw[:tl, b] = _raw_i32(texts[b], enc_t[b])
        pl = int(plen[b])
        pat_raw[:pl, b] = _raw_i32(patterns[b], enc_p[b])

    def vec(x, fill=0):
        out = np.full(B, fill, dtype=np.int32)
        out[:n] = x
        return out

    return WindowedBatch(B=B, KP=KP, T=T, P=P, peq_lo=peq_lo, peq_hi=peq_hi,
                         text_enc=text_enc, text_raw=text_raw,
                         pat_raw=pat_raw, plen=vec(plen, fill=0),
                         tlen=vec(tlen, fill=0), num_words=num_words)


@dataclasses.dataclass
class StagedWindowed:
    """A WindowedBatch as tensors on one device (int64 PEQ words)."""

    peq: torch.Tensor        # (KP, 5, B) int64
    text_enc: torch.Tensor   # (T, B) int32
    text_raw: torch.Tensor   # (T, B) int32
    pat_raw: torch.Tensor    # (P, B) int32
    plen: torch.Tensor       # (B,) int32
    tlen: torch.Tensor
    num_words: torch.Tensor


def stage_windowed(batch: WindowedBatch, device="cuda") -> StagedWindowed:
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return StagedWindowed(
        peq=fuse_u64(batch.peq_lo, batch.peq_hi).to(dev),
        text_enc=t(batch.text_enc), text_raw=t(batch.text_raw),
        pat_raw=t(batch.pat_raw), plen=t(batch.plen), tlen=t(batch.tlen),
        num_words=t(batch.num_words))


def _lshr(x, s):
    """Logical right shift of int64 words by per-lane s in [1, 63]."""
    return (x >> s) & ((torch.ones_like(s) << (64 - s)) - 1)


def windowed_scan_torch(st: StagedWindowed, WS: int, OVL: int,
                        hew_cells: int):
    """Plain PyTorch version: windowed_jax.windowed_scan_impl in score
    mode, vectorized over lanes that move in lockstep, one window per
    loop iteration. Returns (score, hew) (B,) int64 tensors."""
    peq = st.peq
    dev = peq.device
    KP, _, B = peq.shape
    COLS = W * WS
    pos_v = st.plen.long() - 1
    pos_h = st.tlen.long() - 1
    num_words = st.num_words.long()
    score = torch.zeros(B, dtype=torch.int64, device=dev)
    hew = torch.zeros_like(score)
    zeros = torch.zeros_like(score)
    topbit = torch.full((B,), -(1 << 63), dtype=torch.int64, device=dev)
    w_rows = torch.arange(WS, device=dev)[:, None]
    c_rows = torch.arange(COLS, device=dev)[:, None]
    pv_after = torch.empty((COLS, WS, B), dtype=torch.int64, device=dev)
    mv_before = torch.empty_like(pv_after)
    while True:
        active = (pos_v >= 0) & (pos_h >= 0)
        if not bool(active.any()):
            break
        pv_pos = pos_v.clamp(min=0)
        ph_pos = pos_h.clamp(min=0)
        v_min = (pv_pos - COLS + 1).clamp(min=0)
        h_min = (ph_pos - COLS + 1).clamp(min=0)
        shift = v_min % W

        # shifted PEQ window (bpm_windowed.c:237-244)
        rows = (v_min // W)[None] + w_rows                   # (WS, B)

        def rows_of(r):
            idx = r.clamp(max=KP - 1)[:, None, :].expand(WS, 5, B)
            return peq.gather(0, idx)

        lo = torch.where((rows < num_words[None])[:, None], rows_of(rows),
                         -1)
        hi = torch.where(((rows + 1) < num_words[None])[:, None],
                         rows_of(rows + 1), 0)
        s = shift[None, None].expand(WS, 5, B)
        s1 = s.clamp(min=1)
        peqw = torch.where(s == 0, lo, _lshr(lo, s1) | (hi << (64 - s1)))

        text_enc = st.text_enc.gather(0, h_min[None] + c_rows).long()
        text_raw = st.text_raw.gather(0, h_min[None] + c_rows)
        pat_raw = st.pat_raw.gather(0, v_min[None] + c_rows)

        # window fill (bpm_windowed.c:202-280), no level masks
        pv = [torch.where(h_min == 0, -1, 0)] * WS
        mv = [zeros] * WS
        ph_first = (v_min == 0).long()
        for tp in range(COLS):
            c = text_enc[tp][None]
            mv_before[tp] = torch.stack(mv)
            ph, mh = ph_first, zeros
            for i in range(WS):
                eq = peqw[i].gather(0, c)[0]
                pv[i], mv[i], ph, mh = advance_block(eq, topbit, pv[i],
                                                     mv[i], ph, mh)
            pv_after[tp] = torch.stack(pv)

        # greedy backtrace as a column scan, tie-break D, I, M, X
        v_ovl_rel = (pv_pos - W * (WS - OVL) + 1).clamp(min=0) - v_min
        h_ovl_rel = (ph_pos - W * (WS - OVL) + 1).clamp(min=0) - h_min
        vr = pv_pos - v_min
        hr = ph_pos - h_min
        sc = torch.zeros_like(score)
        for col in range(COLS, 0, -1):
            act = active & (hr == col - 1) & (vr >= v_ovl_rel) & \
                (hr >= h_ovl_rel)
            if not bool(act.any()):
                continue
            vru = vr.clamp(0, COLS - 1)
            hz = highest_zero_at_or_below(pv_after[col - 1], vru)
            max_run = vru - v_ovl_rel + 1
            run = torch.minimum(vru - hz, max_run)
            ended = run == max_run          # window exit mid-run
            v1 = vru - run
            v1u = v1.clamp(0, COLS - 1)
            is_i = bit_at(mv_before[col - 1], v1u) == 1
            match = pat_raw.gather(0, v1u[None])[0] == text_raw[col - 1]
            step_sc = (is_i | ~match).long()
            sc = sc + torch.where(act, run + torch.where(ended, 0, step_sc),
                                  0)
            vr = torch.where(act, torch.where(ended, v1,
                                              v1 - (~is_i).long()), vr)
            hr = torch.where(act & ~ended, hr - 1, hr)
        hew = hew + (active & (sc > hew_cells)).long()
        score = score + torch.where(active, sc, 0)
        pos_v = torch.where(active, v_min + vr, pos_v)
        pos_h = torch.where(active, h_min + hr, pos_h)
    # boundary fill (bpm_windowed.c:599-627, score-only accounting)
    score = score + torch.where(pos_h >= 0, pos_h + 1, 0)
    score = score + torch.where(pos_v >= 0, pos_v + 1, 0)
    return score, hew


def _launch_windowed(st: StagedWindowed, WS: int, OVL: int,
                     hew_cells: int):
    if WS < 1:
        raise ValueError(f"window_size {WS}: must be at least 1")
    dev = st.peq.device
    KP, _, B = st.peq.shape
    T, P_ = st.text_enc.shape[0], st.pat_raw.shape[0]
    if T < W * WS or P_ < W * WS:
        raise ValueError("windowed batch shorter than one window")
    COLS = W * WS
    pv_after = torch.empty((COLS, WS, B), dtype=torch.int64, device=dev)
    mv_before = torch.empty_like(pv_after)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    hew = torch.empty_like(score)
    args = [st.peq, st.text_enc, st.text_raw, st.pat_raw, st.plen, st.tlen,
            st.num_words, pv_after, mv_before, score, hew]
    if WS > MAX_REG_WS:     # the window words of a lane, lane-minor
        args += [torch.empty((WS * 5, B), dtype=torch.int64, device=dev),
                 torch.empty((WS, B), dtype=torch.int64, device=dev),
                 torch.empty((WS, B), dtype=torch.int64, device=dev)]
    check_cuda(*args)
    ptrs = [x.data_ptr() for x in args] + [None] * (14 - len(args))
    WINDOWED.launch(*ptrs, B, KP, T, P_, WS, OVL, hew_cells,
                    stream_ptr(dev))
    return score.long(), hew.long()


def windowed_score_staged(st: StagedWindowed, WS: int, OVL: int,
                          hew_cells: int):
    """(score, hew) on the staged batch's device: the CUDA kernel for a
    CUDA batch, the plain version for a CPU one."""
    if st.peq.device.type == "cpu":
        return windowed_scan_torch(st, WS, OVL, hew_cells)
    return _launch_windowed(st, WS, OVL, hew_cells)


def run_windowed_score(batch: WindowedBatch, hew_threshold: int,
                       window_size: int, overlap_size: int,
                       device="cuda"):
    """Score-only windowed bound; returns (score, hew) as numpy int64."""
    st = stage_windowed(batch, device)
    cells = hew_cell_threshold(window_size, overlap_size, hew_threshold)
    score, hew = windowed_score_staged(st, window_size, overlap_size, cells)
    return score.cpu().numpy(), hew.cpu().numpy()
