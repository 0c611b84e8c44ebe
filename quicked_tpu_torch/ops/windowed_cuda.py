"""Batched windowed alignment on the card: the score bound (score-only
mode) and the full-CIGAR mode.

The counterpart of quicked_tpu/ops/windowed_jax.py (`windowed_scan_impl`
in both modes, `run_windowed_score`, `run_windowed_full`). The CUDA
kernels are in `csrc/windowed_score.cu` (`windowed_kernel`, the score
mode; `windowed_full_kernel`, which writes each pair's op bytes in final
order); `windowed_scan_torch` and `windowed_full_ops_torch` are their
plain PyTorch versions, ports of the XLA while-loop
(`windowed_full_torch`, the full mode's per-column records as the JAX
package keeps them, expanded by `expand_window_records`).

`WindowedBatch`, `prepare_windowed_batch`, `hew_cell_threshold` and
`expand_window_records` are numpy helpers copied from windowed_jax.py,
which imports jax.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from quicked_tpu_torch import dna
from quicked_tpu_torch._build import I, P, Kernel, load
from quicked_tpu_torch.device import check_cuda, resolve_device
from quicked_tpu_torch.ops.banded_cuda import advance_block, fuse_u64
from quicked_tpu_torch.ops.banded_traceback_cuda import (
    bit_at, highest_zero_at_or_below)
from quicked_tpu_torch.ops.batch_prep import pack_peq_pair_major
from quicked_tpu_torch.ops.myers_np import div_ceil
from quicked_tpu_torch.ops.packed import pack_pairs

W = 64

WINDOWED = Kernel("qtt_windowed_score", [P] * 10 + [I] * 9 + [P])
WINDOWED_FULL = Kernel("qtt_windowed_full", [P] * 10 + [I] * 8 + [P])
# the full-mode kernel's shared memory beside a window: its op ring and
# the walk's staged chunk (csrc/windowed_score.cu, STAGE)
FULL_STAGE_BYTES = 3072


@dataclasses.dataclass
class WindowedBatch:
    """Fixed-shape arrays for one windowed kernel invocation. The frames
    are lane-minor views of pair-major arrays, the layout the kernels read
    (`stage_windowed` uploads them so)."""

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
    """The windowed kernels' batch of the pairs (lists of str or encoded
    arrays, or PackedSeqs). A batch that packs (`packed.pack_pairs`)
    builds every pair-major frame by one masked assignment; any other
    writes a row a pair."""
    n = len(patterns)
    pk = pack_pairs(patterns, texts)
    if pk is not None:
        plen = pk[0].len.astype(np.int32)
        tlen = pk[1].len.astype(np.int32)
    else:
        enc_p = [p if isinstance(p, np.ndarray) else dna.encode(p)
                 for p in patterns]
        enc_t = [t if isinstance(t, np.ndarray) else dna.encode(t)
                 for t in texts]
        plen = np.array([len(p) for p in enc_p], dtype=np.int32)
        tlen = np.array([len(t) for t in enc_t], dtype=np.int32)
    B = pad_to_b or n
    assert B >= n
    cols = W * window_size
    KP = max(div_ceil(int(plen.max()), W), 1) if n else 1
    T = max(int(tlen.max()) if n else 1, cols)
    # at least one window tall: the kernel reads (cols,)-windows
    P = max(int(plen.max()) if n else 1, cols)

    # pair-major: (B, KP, 5) PEQ words, (B, T) and (B, P) frames
    peq_lo = np.zeros((B, KP, 5), dtype=np.uint32)
    peq_hi = np.zeros((B, KP, 5), dtype=np.uint32)
    num_words = np.ones(B, dtype=np.int32)
    if pk is not None:
        pp, tp = pk
        text_enc = tp.frame(T, 0, np.int32, rows=B, encoded=True)
        text_raw = tp.frame(T, -1, np.int32, rows=B)
        pat_raw = pp.frame(P, -2, np.int32, rows=B)
    else:
        text_enc = np.zeros((B, T), dtype=np.int32)
        text_raw = np.full((B, T), -1, dtype=np.int32)
        pat_raw = np.full((B, P), -2, dtype=np.int32)
        for b in range(n):
            tl = int(tlen[b])
            text_enc[b, :tl] = enc_t[b]
            text_raw[b, :tl] = _raw_i32(texts[b], enc_t[b])
            pat_raw[b, :int(plen[b])] = _raw_i32(patterns[b], enc_p[b])
    if n:
        lo, hi = pack_peq_pair_major(pk[0] if pk is not None else enc_p,
                                     KP)          # (n, KP, 5)
        peq_lo[:n] = lo
        peq_hi[:n] = hi
        num_words[:n] = np.maximum((plen.astype(np.int64) + W - 1) // W, 1)

    def vec(x, fill=0):
        out = np.full(B, fill, dtype=np.int32)
        out[:n] = x
        return out

    return WindowedBatch(B=B, KP=KP, T=T, P=P,
                         peq_lo=peq_lo.transpose(1, 2, 0),
                         peq_hi=peq_hi.transpose(1, 2, 0),
                         text_enc=text_enc.T, text_raw=text_raw.T,
                         pat_raw=pat_raw.T, plen=vec(plen, fill=0),
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
    """The batch on `device`, uploaded pair-major (no copy on the host
    for a batch from `prepare_windowed_batch`); the staged fields are
    lane-minor views of it, so `_pair_major` copies nothing but the
    encoded text's narrowing to uint8."""
    dev = resolve_device(device)

    def pm(a):      # the pair-major array behind a lane-minor frame
        return np.ascontiguousarray(np.moveaxis(a, -1, 0))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return StagedWindowed(
        peq=fuse_u64(pm(batch.peq_lo), pm(batch.peq_hi)).to(dev).permute(
            1, 2, 0),
        text_enc=t(pm(batch.text_enc)).t(), text_raw=t(pm(batch.text_raw)).t(),
        pat_raw=t(pm(batch.pat_raw)).t(), plen=t(batch.plen),
        tlen=t(batch.tlen), num_words=t(batch.num_words))


def _lshr(x, s):
    """Logical right shift of int64 words by per-lane s in [1, 63]."""
    return (x >> s) & ((torch.ones_like(s) << (64 - s)) - 1)


def max_windows(P: int, T: int, WS: int, OVL: int) -> int:
    """MW: a bound on the windows a pair walks in a batch of P pattern and
    T text rows (windowed_jax.py:217-218): every window but the last
    moves pos_v + pos_h by at least 64 * (ws - ovl)."""
    return -(-(P + T) // (W * max(WS - OVL, 1))) + 2


def _fill_window(st: StagedWindowed, pos_v, pos_h, WS: int, pv_after,
                 mv_before):
    """One window of the plain version's loop (windowed_scan_impl's body
    up to its backtrace): the window's corner (v_min, h_min), its raw
    pattern and text characters (COLS, B), and, written into pv_after and
    mv_before (COLS, WS, B), Pv after and Mv before each column."""
    peq = st.peq
    dev = peq.device
    KP, _, B = peq.shape
    COLS = W * WS
    num_words = st.num_words.long()
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    topbit = torch.full((B,), -(1 << 63), dtype=torch.int64, device=dev)
    w_rows = torch.arange(WS, device=dev)[:, None]
    c_rows = torch.arange(COLS, device=dev)[:, None]
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

    lo = torch.where((rows < num_words[None])[:, None], rows_of(rows), -1)
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
            pv[i], mv[i], ph, mh = advance_block(eq, topbit, pv[i], mv[i],
                                                 ph, mh)
        pv_after[tp] = torch.stack(pv)
    return v_min, h_min, text_raw, pat_raw


def windowed_scan_torch(st: StagedWindowed, WS: int, OVL: int,
                        hew_cells: int):
    """Plain PyTorch version: windowed_jax.windowed_scan_impl in score
    mode, vectorized over lanes that move in lockstep, one window per
    loop iteration. Returns (score, hew) (B,) int64 tensors."""
    dev = st.peq.device
    B = st.peq.shape[2]
    COLS = W * WS
    pos_v = st.plen.long() - 1
    pos_h = st.tlen.long() - 1
    score = torch.zeros(B, dtype=torch.int64, device=dev)
    hew = torch.zeros_like(score)
    pv_after = torch.empty((COLS, WS, B), dtype=torch.int64, device=dev)
    mv_before = torch.empty_like(pv_after)
    while True:
        active = (pos_v >= 0) & (pos_h >= 0)
        if not bool(active.any()):
            break
        v_min, h_min, text_raw, pat_raw = _fill_window(
            st, pos_v, pos_h, WS, pv_after, mv_before)
        pv_pos = pos_v.clamp(min=0)
        ph_pos = pos_h.clamp(min=0)

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


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(64 N, B) bools -> (N, B) int64 words, bit k of word w = row 64w+k."""
    n64, B = bits.shape
    shifts = torch.arange(W, device=bits.device)[None, :, None]
    return (bits.view(n64 // W, W, B).long() << shifts).sum(1)


def windowed_full_torch(st: StagedWindowed, WS: int, OVL: int):
    """Plain PyTorch version of the full-CIGAR mode:
    windowed_jax.windowed_scan_impl with full=True, vectorized over lanes
    that move in lockstep, one window per loop iteration. The backtrace's
    tie-break is M, D, I, X: a D step needs Pv set and no match at the
    cell (the D-predicate Pv & ~match, windowed_jax.py:357). Returns
    (rec_run (B, MW, COLS) int16, rec_op (B, MW, COLS) int8, pos_v (B,)
    int32, pos_h (B,) int32): one (d_run, opcode) record per window column
    (opcode 1 M, 3 I, 4 X, 0 none), pair-major, window k of a pair at row
    k, and the cursor where the walk left the last window."""
    dev = st.peq.device
    B = st.peq.shape[2]
    COLS = W * WS
    MW = max_windows(st.pat_raw.shape[0], st.text_enc.shape[0], WS, OVL)
    rec_run = torch.zeros((B, MW, COLS), dtype=torch.int16, device=dev)
    rec_op = torch.zeros((B, MW, COLS), dtype=torch.int8, device=dev)
    pos_v = st.plen.long() - 1
    pos_h = st.tlen.long() - 1
    pv_after = torch.empty((COLS, WS, B), dtype=torch.int64, device=dev)
    mv_before = torch.empty_like(pv_after)
    widx = 0
    while True:
        active = (pos_v >= 0) & (pos_h >= 0)
        if not bool(active.any()):
            break
        v_min, h_min, text_raw, pat_raw = _fill_window(
            st, pos_v, pos_h, WS, pv_after, mv_before)
        pv_pos = pos_v.clamp(min=0)
        ph_pos = pos_h.clamp(min=0)
        v_ovl_rel = (pv_pos - W * (WS - OVL) + 1).clamp(min=0) - v_min
        h_ovl_rel = (ph_pos - W * (WS - OVL) + 1).clamp(min=0) - h_min
        vr = pv_pos - v_min
        hr = ph_pos - h_min
        wc = min(widx, MW - 1)
        for col in range(COLS, 0, -1):
            act = active & (hr == col - 1) & (vr >= v_ovl_rel) & \
                (hr >= h_ovl_rel)
            if not bool(act.any()):
                continue
            match = pat_raw == text_raw[col - 1][None]      # (COLS, B)
            vru = vr.clamp(0, COLS - 1)
            hz = highest_zero_at_or_below(
                pv_after[col - 1] & ~_pack_bits(match), vru)
            max_run = vru - v_ovl_rel + 1
            run = torch.minimum(vru - hz, max_run)
            ended = run == max_run          # window exit mid-run
            v1 = vru - run
            v1u = v1.clamp(0, COLS - 1)
            is_m = match.gather(0, v1u[None])[0]
            is_i = ~is_m & (bit_at(mv_before[col - 1], v1u) == 1)
            opc = torch.where(is_m, 1, torch.where(is_i, 3, 4))
            rec_op[:, wc, col - 1] = torch.where(act & ~ended, opc, 0).to(
                torch.int8)
            rec_run[:, wc, col - 1] = torch.where(act, run, 0).to(
                torch.int16)
            vr = torch.where(act, torch.where(ended, v1,
                                              v1 - (~is_i).long()), vr)
            hr = torch.where(act & ~ended, hr - 1, hr)
        pos_v = torch.where(active, v_min + vr, pos_v)
        pos_h = torch.where(active, h_min + hr, pos_h)
        widx += 1
    return rec_run, rec_op, pos_v.int(), pos_h.int()


def ops_width(P: int, T: int) -> int:
    """L, the row width of the full mode's op buffer for a batch of P
    pattern and T text rows: P + T (every op consumes a row or a column,
    so no pair has more ops) rounded up to 16 bytes, so that every row
    starts 16-byte aligned."""
    return -(-(P + T) // 16) * 16


def windowed_full_ops_torch(st: StagedWindowed, WS: int, OVL: int):
    """Plain PyTorch version of the full-mode kernel: windowed_full_torch's
    walk, its records expanded to op strings (expand_window_records) and
    each written at the end of its pair's row. Returns (ops (B, L) uint8,
    start (B,) int32), L = ops_width(P, T): pair b's op bytes in forward
    order at [start[b], L), zeros below."""
    dev = st.peq.device
    rec_run, rec_op, pos_v, pos_h = windowed_full_torch(st, WS, OVL)
    strs = expand_window_records(
        rec_run.permute(1, 2, 0).cpu().numpy(),
        rec_op.permute(1, 2, 0).cpu().numpy(), pos_v.cpu().numpy(),
        pos_h.cpu().numpy())
    L = ops_width(st.pat_raw.shape[0], st.text_enc.shape[0])
    ops = np.zeros((len(strs), L), dtype=np.uint8)
    start = np.empty(len(strs), dtype=np.int32)
    for b, text in enumerate(strs):
        start[b] = L - len(text)
        ops[b, start[b]:] = np.frombuffer(text.encode("ascii"), np.uint8)
    return torch.from_numpy(ops).to(dev), torch.from_numpy(start).to(dev)


def shared_pair_bytes(ws: int) -> int:
    """A pair's shared memory in csrc/windowed_score.cu: Pv after and Mv
    before each of the window's 64*ws columns (ws words each), its raw
    text and pattern characters (int32) and its encoded text (uint8)."""
    cols = W * ws
    return cols * (16 * ws + 9)


def scratch_pair_bytes(ws: int) -> int:
    """A pair's device-memory scratch where its window does not fit in
    shared memory: the two planes and two carry buffers of 64*ws bytes."""
    cols = W * ws
    return cols * (16 * ws + 2)


@dataclasses.dataclass(frozen=True)
class WindowedGeometry:
    """Launch geometry of the windowed kernel for one batch."""

    span: int             # lanes per pair (a power of 2, >= min(ws, 32))
    pairs_per_warp: int   # 32 // span; one warp per CTA
    shared_bytes: int     # the CTA's dynamic shared memory; 0: scratch
    scratch_bytes: int    # per pair in the scratch mode, else 0


def windowed_geometry(ws: int, B: int, sms: int, max_shared: int
                      ) -> WindowedGeometry:
    """Pairs per warp and where the window lives on a card of `sms` SMs
    whose CTAs may take `max_shared` bytes of dynamic shared memory: as
    many pairs as the segments of next_pow2(ws) lanes (at most 32) and
    that memory allow, halved while the batch would leave SMs idle; the
    window in shared memory where one pair's fits, else in the scratch."""
    seg = min(32, 1 << (ws - 1).bit_length())
    ppw = 32 // seg
    per = shared_pair_bytes(ws)
    fits = per <= max_shared
    if fits:
        while ppw * per > max_shared:
            ppw //= 2
    while ppw > 1 and -(-B // ppw) < sms:
        ppw //= 2
    return WindowedGeometry(span=32 // ppw, pairs_per_warp=ppw,
                            shared_bytes=ppw * per if fits else 0,
                            scratch_bytes=0 if fits else
                            scratch_pair_bytes(ws))


def windowed_full_geometry(ws: int, B: int, sms: int, max_shared: int,
                           shared: bool | None = None) -> WindowedGeometry:
    """Launch geometry of the full-mode kernel: a pair a warp, a warp a
    CTA. The window sits in shared memory (beside the op ring and the
    walk's chunk, FULL_STAGE_BYTES) where one pair's fits and the batch runs in one wave of the CTAs that memory
    lets an SM hold (taken as `max_shared` over one CTA's bytes), else in
    the pair-major device-memory scratch, where every pair of the batch
    runs at once and the L2 holds most of the windows. `shared` forces
    the choice (a window that does not fit is never in shared memory)."""
    per = FULL_STAGE_BYTES + shared_pair_bytes(ws)
    fits = per <= max_shared
    if shared is None:
        shared = B <= sms * max(max_shared // per, 1)
    if fits and shared:
        return WindowedGeometry(span=32, pairs_per_warp=1, shared_bytes=per,
                                scratch_bytes=0)
    return WindowedGeometry(span=32, pairs_per_warp=1,
                            shared_bytes=FULL_STAGE_BYTES,
                            scratch_bytes=scratch_pair_bytes(ws))


@functools.cache
def max_shared_bytes(device_index: int) -> int:
    """The dynamic shared memory a CTA of either mode's kernel may take on
    the card: its opt-in limit less the kernels' static PEQ table."""
    out = ctypes.c_int()
    fn = load().qtt_windowed_max_shared
    fn.argtypes, fn.restype = [I, ctypes.POINTER(ctypes.c_int)], I
    with torch.cuda.device(device_index):   # the kernel's attributes there
        err = fn(device_index, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"qtt_windowed_max_shared: CUDA error {err}")
    return out.value


def _check_windowed(st: StagedWindowed, WS: int):
    """Validate a staged batch for the kernel; returns (KP, B, T, P)."""
    if WS < 1:
        raise ValueError(f"window_size {WS}: must be at least 1")
    KP, five, B = st.peq.shape
    T, P_ = st.text_enc.shape[0], st.pat_raw.shape[0]
    if T < W * WS or P_ < W * WS:
        raise ValueError("windowed batch shorter than one window")
    lanes = (st.plen, st.tlen, st.num_words)
    # the staged frames may be lane-minor views: the kernels read their
    # pair-major copies (`_pair_major`), which the launches check
    check_cuda(*lanes)
    if st.peq.dtype != torch.int64 or five != 5 or any(
            x.dtype != torch.int32 for x in
            (st.text_enc, st.text_raw, st.pat_raw, *lanes)):
        raise ValueError("windowed: peq (KP, 5, B) int64, the rest int32")
    if st.text_raw.shape != (T, B) or st.text_enc.shape != (T, B) or \
            st.pat_raw.shape != (P_, B) or any(x.shape != (B,)
                                               for x in lanes):
        raise ValueError("windowed: text (T, B), pattern (P, B), lanes (B,)")
    return KP, B, T, P_


def _pair_major(st: StagedWindowed) -> list:
    """The pair-major copies of the lane-minor staged batch the kernels
    read: the inputs, then the lanes."""
    return [st.peq.permute(2, 0, 1).contiguous(),
            st.text_enc.t().to(torch.uint8).contiguous(),
            st.text_raw.t().contiguous(), st.pat_raw.t().contiguous(),
            st.plen, st.tlen, st.num_words]


def _kernel_inputs(st: StagedWindowed, WS: int, B: int):
    """The score kernel's launch geometry, its inputs (`_pair_major`) and
    its scratch (None in the shared mode)."""
    dev = st.peq.device
    geo = windowed_geometry(
        WS, B, torch.cuda.get_device_properties(dev).multi_processor_count,
        max_shared_bytes(dev.index))
    scratch = (torch.empty((B, geo.scratch_bytes), dtype=torch.uint8,
                           device=dev) if geo.scratch_bytes else None)
    bufs = _pair_major(st)
    check_cuda(*bufs)
    return geo, bufs, scratch


def _launch_windowed(st: StagedWindowed, WS: int, OVL: int,
                     hew_cells: int):
    KP, B, T, P_ = _check_windowed(st, WS)
    geo, bufs, scratch = _kernel_inputs(st, WS, B)
    score = torch.empty((B,), dtype=torch.int32, device=st.peq.device)
    hew = torch.empty_like(score)
    WINDOWED.launch(
        st.peq.device, *(x.data_ptr() for x in bufs),
        None if scratch is None else scratch.data_ptr(), score.data_ptr(),
        hew.data_ptr(), B, KP, T, P_, WS, OVL, hew_cells, geo.span,
        geo.shared_bytes)
    return score.long(), hew.long()


@dataclasses.dataclass
class FullLaunch:
    """A full-mode launch made ready: the C entry's arguments after the
    device, the tensors they point into, and the outputs."""

    args: tuple
    inputs: list
    ops: torch.Tensor     # (B, L) uint8
    start: torch.Tensor   # (B,) int32


def _full_launch(st: StagedWindowed, WS: int, OVL: int,
                 shared: bool | None = None) -> FullLaunch:
    """Check the batch and allocate the full-mode kernel's inputs
    (`_pair_major`), scratch and outputs, uninitialized: the kernel writes
    every byte of a pair's row from its start and every start."""
    KP, B, T, P_ = _check_windowed(st, WS)
    dev = st.peq.device
    geo = windowed_full_geometry(
        WS, B, torch.cuda.get_device_properties(dev).multi_processor_count,
        max_shared_bytes(dev.index), shared)
    bufs = _pair_major(st)
    check_cuda(*bufs)
    scratch = (torch.empty((B, geo.scratch_bytes), dtype=torch.uint8,
                           device=dev) if geo.scratch_bytes else None)
    L = ops_width(P_, T)
    ops = torch.empty((B, L), dtype=torch.uint8, device=dev)
    start = torch.empty((B,), dtype=torch.int32, device=dev)
    args = (*(x.data_ptr() for x in bufs),
            None if scratch is None else scratch.data_ptr(), ops.data_ptr(),
            start.data_ptr(), B, KP, T, P_, WS, OVL, L, geo.shared_bytes)
    return FullLaunch(args, [*bufs, scratch], ops, start)


def _launch_windowed_full(st: StagedWindowed, WS: int, OVL: int,
                          shared: bool | None = None):
    fl = _full_launch(st, WS, OVL, shared)
    WINDOWED_FULL.launch(st.peq.device, *fl.args)
    return fl.ops, fl.start


def windowed_score_staged(st: StagedWindowed, WS: int, OVL: int,
                          hew_cells: int):
    """(score, hew) on the staged batch's device: the CUDA kernel for a
    CUDA batch, the plain version for a CPU one."""
    if st.peq.device.type == "cpu":
        return windowed_scan_torch(st, WS, OVL, hew_cells)
    return _launch_windowed(st, WS, OVL, hew_cells)


def windowed_full_staged(st: StagedWindowed, WS: int, OVL: int):
    """(ops, start) of the full-CIGAR mode on the staged batch's device
    (see `windowed_full_ops_torch`): the CUDA kernel for a CUDA batch, the
    plain version for a CPU one."""
    if st.peq.device.type == "cpu":
        return windowed_full_ops_torch(st, WS, OVL)
    return _launch_windowed_full(st, WS, OVL)


def run_windowed_score(batch: WindowedBatch, hew_threshold: int,
                       window_size: int, overlap_size: int,
                       device="cuda"):
    """Score-only windowed bound; returns (score, hew) as numpy int64."""
    st = stage_windowed(batch, device)
    cells = hew_cell_threshold(window_size, overlap_size, hew_threshold)
    score, hew = windowed_score_staged(st, window_size, overlap_size, cells)
    return score.cpu().numpy(), hew.cpu().numpy()


_OP_BYTES = np.array([0, ord("M"), ord("D"), ord("I"), ord("X")],
                     dtype=np.uint8)


def expand_window_records(runs, opcs, pos_v, pos_h,
                          n: int | None = None) -> list[str]:
    """Expand (MW, COLS, B) per-window column records to forward-order
    op strings: 'D'*(pos_v+1) + 'I'*(pos_h+1) + for windows DESCENDING
    (the last window processed is the leftmost piece), columns
    ascending: op + 'D'*d_run — the reference's right-to-left buffer,
    reversed. One vectorized np.repeat per lane chunk."""
    runs = np.asarray(runs)
    opcs = np.asarray(opcs)
    pos_v = np.asarray(pos_v)
    pos_h = np.asarray(pos_h)
    MW, COLS, B = runs.shape
    n = B if n is None else n
    R = MW * COLS
    rflat = runs[::-1].reshape(R, B)
    oflat = opcs[::-1].reshape(R, B)
    out = []
    CH = max(1, (1 << 24) // max(R, 1))        # bound temp arrays
    for s in range(0, n, CH):
        e = min(s + CH, n)
        m = e - s
        vals = np.empty((m, 2 + 2 * R), dtype=np.uint8)
        cnts = np.empty((m, 2 + 2 * R), dtype=np.int64)
        vals[:, 0] = ord("D")
        cnts[:, 0] = np.maximum(pos_v[s:e] + 1, 0)
        vals[:, 1] = ord("I")
        cnts[:, 1] = np.maximum(pos_h[s:e] + 1, 0)
        vals[:, 2::2] = _OP_BYTES[oflat[:, s:e]].T
        cnts[:, 2::2] = (oflat[:, s:e] != 0).T
        vals[:, 3::2] = ord("D")
        cnts[:, 3::2] = rflat[:, s:e].T
        flat = np.repeat(vals.ravel(), cnts.ravel())
        tot = cnts.sum(axis=1)
        ends = np.cumsum(tot)
        starts = ends - tot
        buf = flat.tobytes()
        out.extend(buf[starts[i]:ends[i]].decode("ascii")
                   for i in range(m))
    return out


def ops_to_host(ops: torch.Tensor, start: torch.Tensor):
    """(ops, start) of the full mode as numpy arrays: from a card, one copy
    each into page-locked memory from torch's caching host allocator,
    which later calls reuse."""
    if ops.device.type == "cpu":
        return ops.numpy(), start.numpy()
    host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(
        x, non_blocking=True) for x in (ops, start)]
    torch.cuda.synchronize(ops.device)
    return host[0].numpy(), host[1].numpy()


def decode_ops(ops: np.ndarray, start: np.ndarray,
               n: int | None = None) -> list[str]:
    """The op strings of the first n pairs (all by default) of a full-mode
    result on the host: row b's bytes from start[b]."""
    n = len(start) if n is None else n
    return [ops[b, start[b]:].tobytes().decode("ascii") for b in range(n)]


def run_windowed_full(batch: WindowedBatch, window_size: int,
                      overlap_size: int, device="cuda") -> list[str]:
    """Full-CIGAR windowed mode: forward-order op strings per pair
    (windowed_compute's CIGAR path, bpm_windowed.c:563-628). On a card the
    kernel writes them; the host reads its buffer back once and slices
    it."""
    st = stage_windowed(batch, device)
    ops, start = windowed_full_staged(st, window_size, overlap_size)
    return decode_ops(*ops_to_host(ops, start), n=batch.B)
