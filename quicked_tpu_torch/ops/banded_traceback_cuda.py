"""Banded traceback over the full fill's planes, on the card.

The counterpart of quicked_tpu/ops/banded_traceback_jax.py
(`traceback_records_impl`, `traceback_ops_from_tiled`). The CUDA kernel
is `csrc/banded_traceback.cu`; `traceback_records_torch` is the plain
PyTorch version. Both take the (T, EBB, B) int64 Pv/Mv planes that
`banded_cuda` leaves on the device, so the planes never go to host
memory, and return one (d_run, op) record per column. The records expand
on the host through the port's `native.expand_colruns`, or
`records_to_packed` below.

`prep_raw_frames` and `records_to_packed` are numpy helpers copied from
banded_traceback_jax.py, which imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from quicked_tpu_torch import native
from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.device import check_cuda
from quicked_tpu_torch.ops.packed import PackedSeqs, lengths

W = 64

# opcode values: 1=M, 2=D, 3=I, 4=X
_OP_BYTES = np.array([0, ord("M"), ord("D"), ord("I"), ord("X")],
                     dtype=np.uint8)

TRACEBACK = Kernel("qtt_banded_traceback", [P] * 11 + [I] * 4 + [P])


def hsb64(y: torch.Tensor) -> torch.Tensor:
    """Highest set bit of int64 words (0 for y == 0; callers mask), by a
    binary search on logical right shifts."""
    p = torch.zeros_like(y)
    for k in (32, 16, 8, 4, 2, 1):
        t = (y >> k) & ((1 << (64 - k)) - 1)
        big = t != 0
        p = p + big.long() * k
        y = torch.where(big, t, y)
    return p


def highest_zero_at_or_below(words: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """Per lane, the highest zero bit at or below `pos` in an (N, B)
    stack of 64-bit words (word w holds bits 64w..64w+63); -1 if none."""
    w_idx = torch.arange(words.shape[0], device=words.device)[:, None]
    d = pos[None] - W * w_idx
    mask = torch.where(d >= 63, -1, torch.where(
        d < 0, 0, (2 << d.clamp(0, 62)) - 1))
    y = ~words & mask
    cand = torch.where(y != 0, W * w_idx + hsb64(y), -1)
    return cand.amax(dim=0)


def bit_at(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit `pos` (per lane, in range) of an (N, B) stack of words."""
    word = words.gather(0, (pos >> 6)[None])[0]
    return (word >> (pos & 63)) & 1


def traceback_records_torch(mat_pv, mat_mv, praw, traw, plen, tlen,
                            prolog):
    """Plain PyTorch version: banded_traceback_jax.traceback_records_impl
    step for step, with the M test read from the raw frames directly.
    planes (T, EBB, B) int64; praw (PP, B) / traw (T, B) uint8; plen,
    tlen, prolog (B,) int32. Returns (runs (T, B) int32, opcs (T, B)
    int8, v_fin (B,) int32, h_fin (B,) int32)."""
    T, EBB, B = mat_pv.shape
    dev = mat_pv.device
    nbits = EBB * W
    prolog = prolog.long()
    v = plen.long() - 1
    h = tlen.long() - 1
    runs = torch.zeros((T, B), dtype=torch.int32, device=dev)
    opcs = torch.zeros((T, B), dtype=torch.int8, device=dev)
    for hc in range(T - 1, -1, -1):
        act = (h == hc) & (v >= 0)
        if not bool(act.any()):
            continue
        # D-run: band frame of column hc + 1 (plane hc)
        bp_r = v - W * ((hc + 1) // W) + W * prolog
        bpc = bp_r.clamp(0, nbits - 1)
        hz = highest_zero_at_or_below(mat_pv[hc], bpc)
        run = torch.minimum(bpc - hz, v + 1)
        run = torch.where((bp_r < 0) | (bp_r >= nbits), 0, run)
        run = torch.where(act, run, 0)
        v1 = v - run
        ended_v = v1 < 0
        # trailing column-consuming step at (v1, hc)
        v1u = v1.clamp(min=0)
        eff_v = v1u - W * (hc // W) + W * prolog      # band frame of hc
        in_band = (eff_v >= 0) & (eff_v < nbits)
        if hc > 0:
            ibit = bit_at(mat_mv[hc - 1], eff_v.clamp(0, nbits - 1))
            ibit = torch.where(in_band, ibit, 0)
        else:
            ibit = torch.zeros_like(v)
        mbit = praw.gather(0, v1u.clamp(max=praw.shape[0] - 1)[None])[0] \
            == traw[hc]
        is_i = ibit == 1
        opc = torch.where(is_i, 3, torch.where(mbit, 1, 4))
        opc = torch.where(act & ~ended_v, opc, 0)
        v = torch.where(act, torch.where(ended_v, v1,
                                         v1 - (~is_i).long()), v)
        h = torch.where(act & ~ended_v, h - 1, h)
        runs[hc] = run.int()
        opcs[hc] = opc.to(torch.int8)
    return runs, opcs, v.int(), h.int()


def _launch_traceback(mat_pv, mat_mv, praw, traw, plen, tlen, prolog):
    T, EBB, B = mat_pv.shape
    dev = mat_pv.device
    check_cuda(mat_pv, mat_mv, plen, tlen, prolog)
    if praw.dtype != torch.uint8 or traw.dtype != torch.uint8 or \
            traw.shape != (T, B) or praw.shape[1] != B or \
            mat_mv.shape != mat_pv.shape:
        raise ValueError("traceback: raw frames must be uint8, traw (T, B), "
                         "praw (PP, B)")
    if mat_pv.dtype != torch.int64 or mat_mv.dtype != torch.int64:
        raise ValueError("traceback: planes must be int64")
    if any(x.dtype != torch.int32 or x.shape != (B,)
           for x in (plen, tlen, prolog)):
        raise ValueError("traceback: plen/tlen/prolog must be (B,) int32")
    if int(plen.max()) > praw.shape[0] or int(tlen.max()) > T:
        raise ValueError("traceback: praw/traw shorter than a sequence")
    runs = torch.empty((T, B), dtype=torch.int32, device=dev)
    opcs = torch.empty((T, B), dtype=torch.int8, device=dev)
    v_fin = torch.empty((B,), dtype=torch.int32, device=dev)
    h_fin = torch.empty((B,), dtype=torch.int32, device=dev)
    # the walk reads each pair's characters pair-major (a copy unless the
    # frames are views of pair-major tensors, as `traceback_ops` stages
    # them)
    praw_t, traw_t = praw.t().contiguous(), traw.t().contiguous()
    check_cuda(mat_pv, praw_t, traw_t)
    args = (mat_pv, mat_mv, praw_t, traw_t, plen, tlen, prolog, runs, opcs,
            v_fin, h_fin)
    TRACEBACK.launch(dev, *[x.data_ptr() for x in args], B, T, EBB,
                     praw.shape[0])
    return runs, opcs, v_fin, h_fin


def traceback_records(mat_pv, mat_mv, praw, traw, plen, tlen, prolog):
    """Records on the planes' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU ones."""
    if mat_pv.device.type == "cpu":
        return traceback_records_torch(mat_pv, mat_mv, praw, traw, plen,
                                       tlen, prolog)
    return _launch_traceback(mat_pv, mat_mv, praw, traw, plen, tlen,
                             prolog)


def prep_raw_frames(patterns_raw, texts_raw, T: int, PP: int,
                    pad_to_b: int | None = None):
    """(PP, B) / (T, B) uint8 raw-char frames, lane-minor views of the
    pair-major arrays the kernel reads. Pad positions hold 0: the M test
    only reads (v1 <= plen-1, h <= tlen-1). The raws: lists of bytes or
    arrays, or two PackedSeqs (framed by `PackedSeqs.frame`)."""
    B = pad_to_b or len(patterns_raw)
    if isinstance(patterns_raw, PackedSeqs) and \
            isinstance(texts_raw, PackedSeqs):
        return (patterns_raw.frame(PP, 0, np.uint8, rows=B).T,
                texts_raw.frame(T, 0, np.uint8, rows=B).T)
    praw = np.zeros((B, PP), dtype=np.uint8)
    traw = np.zeros((B, T), dtype=np.uint8)
    for b, (p, t) in enumerate(zip(patterns_raw, texts_raw)):
        pa = np.frombuffer(p, dtype=np.uint8) if isinstance(p, bytes) else p
        ta = np.frombuffer(t, dtype=np.uint8) if isinstance(t, bytes) else t
        praw[b, :len(pa)] = pa
        traw[b, :len(ta)] = ta
    return praw.T, traw.T


def records_to_packed(runs_bt, opcs_bt, v_fin, h_fin):
    """(B, T) lane-major column records -> one packed op-byte buffer and
    per-lane (start, length): 'D'*(v+1) + 'I'*(h+1) + ascending-h
    (op + 'D'*run), the reference's right-to-left buffer reversed."""
    runs_bt = np.asarray(runs_bt)
    opcs_bt = np.asarray(opcs_bt)
    v_fin = np.asarray(v_fin)
    h_fin = np.asarray(h_fin)
    n, T = runs_bt.shape
    vals = np.empty((n, 2 + 2 * T), dtype=np.uint8)
    cnts = np.empty((n, 2 + 2 * T), dtype=np.int32)
    vals[:, 0] = ord("D")
    cnts[:, 0] = np.maximum(v_fin + 1, 0)
    vals[:, 1] = ord("I")
    cnts[:, 1] = np.maximum(h_fin + 1, 0)
    vals[:, 2::2] = _OP_BYTES[opcs_bt]
    cnts[:, 2::2] = opcs_bt != 0
    vals[:, 3::2] = ord("D")
    cnts[:, 3::2] = runs_bt
    flat = np.repeat(vals.ravel(), cnts.ravel())
    tot = cnts.sum(axis=1, dtype=np.int64)
    ends = np.cumsum(tot)
    return flat, ends - tot, tot


def traceback_ops(mat_pv, mat_mv, praws, traws, plen, tlen, prolog,
                  n: int) -> native.LazyOpsList:
    """Op strings of the first n lanes from the fill's device planes
    (counterpart of traceback_ops_from_tiled), as a `native.LazyOpsList`:
    a list of str decoded on first access, whose packed op bytes a caller
    may take as they are (`segments`). praws/traws: raw byte strings per
    live lane, or two PackedSeqs; plen/tlen/prolog: (B,) numpy vectors.
    Only the records cross to the host."""
    T, EBB, B = mat_pv.shape
    dev = mat_pv.device
    maxp = int(lengths(praws).max()) if len(praws) else 1
    praw_np, traw_np = prep_raw_frames(praws, traws, T, max(maxp, 1),
                                       pad_to_b=B)

    def lane(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    # the frames go up pair-major (their .T), as the kernel reads them
    runs, opcs, v_f, h_f = traceback_records(
        mat_pv, mat_mv, torch.from_numpy(praw_np.T).to(dev).t(),
        torch.from_numpy(traw_np.T).to(dev).t(), lane(plen), lane(tlen),
        lane(prolog))
    # lane-major on the device: the host expansion walks records per lane
    runs_bt = runs[:, :n].T.contiguous().cpu().numpy()
    opcs_bt = opcs[:, :n].T.contiguous().cpu().numpy()
    v_f = v_f[:n].cpu().numpy()
    h_f = h_f[:n].cpu().numpy()
    packed = None
    if EBB * W < (1 << 16) and native.available():
        packed = native.expand_colruns(runs_bt.astype(np.uint16), opcs_bt,
                                       v_f, h_f)
    if packed is None:
        packed = records_to_packed(runs_bt, opcs_bt, v_f, h_f)
    return native.LazyOpsList([(*packed, np.zeros(n, dtype=np.int64))])
