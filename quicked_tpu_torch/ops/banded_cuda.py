"""Batched banded Myers fill on the card: score-only and full variants.

The counterpart of quicked_tpu/ops/banded_pallas.py (the Pallas TPU
kernel `_kernel` through `_pallas_banded`, `stage_batch`,
`collect_outputs`) and of its XLA twin banded_jax.py
(`banded_scan_impl`, `_maintenance`). The CUDA kernel is
`csrc/banded_fill.cu` (one warp per pair, the band's carry chain
resolved by a carry-map scan; several warps per pair past 128 band
blocks, and past 2048 the band walked in rounds from device memory, so
any depth is taken); `banded_scan_torch` below is the plain PyTorch
version, a line-for-line port of the XLA scan.

Layout: lanes last, as in the JAX package. Each 64-bit Myers word is one
int64 element holding the u64 bits (`stage_banded` fuses the
BandedBatch's u32 lo/hi planes); `to_host_dict` splits them back into the
exact dict `banded_jax.run_banded` returns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.device import check_cuda, resolve_device
from quicked_tpu_torch.ops.batch_prep import BandedBatch

W = 64
LANE_FIELDS = ("cutoff", "prolog", "nbr", "finish_v", "tfinish", "first0",
               "last0")

FILL = Kernel("qtt_banded_fill", [I] + [P] * 19 + [I, I, I, P])


@dataclasses.dataclass
class StagedBanded:
    """A BandedBatch as tensors on one device."""

    peq: torch.Tensor          # (K, 5, B) int64, u64 bits
    lm: torch.Tensor           # (K, B) int64
    text: torch.Tensor         # (NB*64, B) uint8, encoded chars 0..4
    text_pm: torch.Tensor      # (B, NB*64) uint8: `text` pair-major, so a
                               # pair's columns are contiguous (deep bands)
    init_scores: torch.Tensor  # (EBB+1, B) int32
    lanes: dict                # LANE_FIELDS -> (B,) int32
    B: int
    EBB: int
    NB: int
    full: bool


def fuse_u64(lo: np.ndarray, hi: np.ndarray) -> torch.Tensor:
    """u32 lo/hi planes -> one int64 tensor holding the u64 words."""
    u = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(u.view(np.int64))


def split_u64(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor of u64 words -> host u32 (lo, hi) planes."""
    u = t.cpu().numpy().view(np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def stage_banded(batch: BandedBatch, device="cuda") -> StagedBanded:
    """Move a prepared batch to `device` (counterpart of
    banded_pallas.stage_batch, without the TPU lane tiling, 8-row
    rounding or alphabet padding)."""
    dev = resolve_device(device)
    lanes = {k: torch.from_numpy(
        np.ascontiguousarray(getattr(batch, k), dtype=np.int32)).to(dev)
        for k in LANE_FIELDS}
    # the text goes up pair-major (as `prepare_banded_batch` builds it)
    # and is transposed on the card for the kernels that read it
    # lane-minor
    text_pm = torch.from_numpy(
        np.ascontiguousarray(batch.text.T, dtype=np.uint8)).to(dev)
    return StagedBanded(
        peq=fuse_u64(batch.peq_lo, batch.peq_hi).to(dev),
        lm=fuse_u64(batch.lm_lo, batch.lm_hi).to(dev),
        text=text_pm.t().contiguous(), text_pm=text_pm,
        init_scores=torch.from_numpy(
            np.ascontiguousarray(batch.init_scores, dtype=np.int32)).to(dev),
        lanes=lanes, B=batch.B, EBB=batch.EBB, NB=batch.NB,
        full=bool(batch.full))


def select_lanes(st: StagedBanded, idx: torch.Tensor) -> StagedBanded:
    """The staged batch restricted to lanes `idx` (a 1-D index tensor on
    the batch's device)."""
    return StagedBanded(
        peq=st.peq[:, :, idx].contiguous(), lm=st.lm[:, idx].contiguous(),
        text=st.text[:, idx].contiguous(),
        text_pm=st.text_pm[idx].contiguous(),
        init_scores=st.init_scores[:, idx].contiguous(),
        lanes={k: v[idx].contiguous() for k, v in st.lanes.items()},
        B=len(idx), EBB=st.EBB, NB=st.NB, full=st.full)


def advance_block(eq, mask, pv, mv, phin, mhin):
    """Myers advance-block on int64 words (ops/u64.py:advance_block64
    without the u32 halves). Only left shifts and bit tests are used, so
    the arithmetic right shift of int64 never enters."""
    xv = eq | mv
    eq2 = eq | mhin
    xh = (((eq2 & pv) + pv) ^ pv) | eq2
    ph = mv | ~(xh | pv)
    mh = pv & xh
    phout = ((ph & mask) != 0).long()
    mhout = ((mh & mask) != 0).long()
    ph = (ph << 1) | phin
    mh = (mh << 1) | mhin
    return mh | ~(xv | ph), ph & xv, phout, mhout


def maintain(st: StagedBanded, nb: int, pv, mv, scw, first, last,
             c_first1, c_last1, c_last):
    """Band cut/shift after the 64-column block nb (banded_jax.py
    _maintenance), then the scores-window roll. The c_* are the window
    rows first+1, last-1 and last after the block's sweep. Returns
    (pv, mv, scw, first, last, the dropped window row 0)."""
    L = {k: v.long() for k, v in st.lanes.items()}
    cutoff, prolog, nbr = L["cutoff"], L["prolog"], L["nbr"]
    finish_v, tfinish = L["finish_v"], L["tfinish"]
    EBB = st.EBB
    rows = torch.arange(EBB, device=pv.device)[:, None]
    w_idx = torch.arange(EBB + 1, device=pv.device)[:, None]
    do_shift = (nb + 1) * W <= tfinish
    cut_lower = (first + 2 < last) & (finish_v > W * (first + 1)) & \
        ((c_first1 + (finish_v - W * (first + 1))) > cutoff)
    inc = do_shift & cut_lower & (nb >= prolog)
    dec = do_shift & ~cut_lower & (nb < prolog)
    first = first + inc.long() - dec.long()
    m_shift = do_shift[None] & (rows >= first[None]) & (rows < last[None])
    m_top = do_shift[None] & (rows == last[None])
    pv = torch.where(m_top, -1, torch.where(
        m_shift, torch.roll(pv, -1, 0), pv))
    mv = torch.where(m_top, 0, torch.where(
        m_shift, torch.roll(mv, -1, 0), mv))
    m_write = do_shift[None] & (w_idx == (last + 1)[None])
    scw = torch.where(m_write, (c_last + W)[None], scw)
    cut_higher = (first + 2 < last) & (W * (last - 1) > finish_v) & \
        ((c_last1 + (W * (last - 1) - finish_v)) > cutoff)
    clamp_at = nbr - 1 if st.full else nbr
    clamp = (nb - prolog + last) >= clamp_at
    last = last - (do_shift & (cut_higher | clamp)).long()
    row0 = scw[0].clone()
    new_row = (nb + 1 + EBB - prolog + 1) * W
    scw = torch.cat([scw[1:], new_row[None]], dim=0)
    return pv, mv, scw, first, last, row0


def banded_scan_torch(st: StagedBanded) -> dict:
    """Plain PyTorch version of the fill: banded_jax.banded_scan_impl and
    _maintenance op for op, vectorized over lanes. The edge scores for
    the band cut are captured inside the column loop as the XLA scan
    does; the kernel reads them after the sweep as the Pallas kernel
    does (both agree; see the note at banded_jax.py:116-122).

    A stored column holds zero in the rows outside its live band, as the
    host C fill writes them (native/src/quicked_host.c, the full fill's
    column loop), not the stale words the XLA scan leaves there: the
    traceback reads such a row when its path leaves the band, and the C
    walk sees zero there."""
    B, EBB, NB, full = st.B, st.EBB, st.NB, st.full
    dev = st.peq.device
    tfinish = st.lanes["tfinish"].long()
    first = st.lanes["first0"].long().clone()
    last = st.lanes["last0"].long().clone()
    pv = torch.full((EBB, B), -1, dtype=torch.int64, device=dev)
    mv = torch.zeros((EBB, B), dtype=torch.int64, device=dev)
    scw = st.init_scores.long().clone()
    text = st.text.long()
    ones = torch.ones(B, dtype=torch.int64, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    if full:
        mat_pv = torch.empty((NB * W, EBB, B), dtype=torch.int64, device=dev)
        mat_mv = torch.empty_like(mat_pv)
        rows = torch.arange(EBB, device=dev)[:, None]
    dropped = []
    for nb in range(NB):
        # rows outside [min(first), max(last)] are inactive in every lane
        lo = max(int(first.min()), 0) if B else 0
        hi = min(int(last.max()), EBB - 1) if B else -1
        c_first1, c_last1, c_last = zeros, zeros, zeros
        for j in range(W):
            t = nb * W + j
            col_active = t < tfinish
            c = text[t][None]
            phin, mhin = ones, zeros
            for i in range(lo, hi + 1):
                active = col_active & (i >= first) & (i <= last)
                is_first = i == first
                eq = st.peq[nb + i].gather(0, c)[0]
                npv, nmv, phout, mhout = advance_block(
                    eq, st.lm[nb + i], pv[i], mv[i],
                    torch.where(is_first, ones, phin),
                    torch.where(is_first, zeros, mhin))
                pv[i] = torch.where(active, npv, pv[i])
                mv[i] = torch.where(active, nmv, mv[i])
                srow = torch.where(active, scw[i] + phout - mhout, scw[i])
                scw[i] = srow
                c_first1 = torch.where(active & (i == first + 1), srow,
                                       c_first1)
                c_last1 = torch.where(active & (i == last - 1), srow, c_last1)
                c_last = torch.where(active & (i == last), srow, c_last)
                phin, mhin = phout, mhout
            if full:
                keep = (rows >= first) & (rows <= last)
                mat_pv[t] = torch.where(keep, pv, 0)
                mat_mv[t] = torch.where(keep, mv, 0)

        old_first, old_last = first, last
        pv, mv, scw, first, last, row0 = maintain(
            st, nb, pv, mv, scw, first, last, c_first1, c_last1, c_last)
        dropped.append(row0)
        if full:
            # the stored 64th column reflects the shifted band: the rows
            # of the band before and after the shift, and the top row
            keep = (rows >= torch.minimum(old_first, first)) & \
                (rows <= old_last)
            mat_pv[nb * W + W - 1] = torch.where(keep, pv, 0)
            mat_mv[nb * W + W - 1] = torch.where(keep, mv, 0)
    out = dict(scores_by_k=torch.cat(
                   [torch.stack(dropped).reshape(NB, B), scw]).int(),
               pv=pv, mv=mv, first=first.int(), last=last.int())
    if full:
        out.update(mat_pv=mat_pv, mat_mv=mat_mv)
    return out


def launch_outputs(st: StagedBanded, *extra) -> dict:
    """The score pass's output tensors for a staged CUDA batch (the full
    fill's planes too), after checking the batch and `extra` outputs
    the way every banded kernel takes them."""
    dev = st.peq.device
    B, EBB, NB = st.B, st.EBB, st.NB

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(scores_by_k=empty((NB + EBB + 1, B), torch.int32),
               pv=empty((EBB, B), torch.int64),
               mv=empty((EBB, B), torch.int64),
               first=empty((B,), torch.int32),
               last=empty((B,), torch.int32))
    if st.full:
        out.update(mat_pv=empty((NB * W, EBB, B), torch.int64),
                   mat_mv=empty((NB * W, EBB, B), torch.int64))
    check_cuda(st.peq, st.lm, st.text, st.text_pm, st.init_scores,
               *st.lanes.values(), *out.values(), *extra)
    if st.text.dtype != torch.uint8 or st.text_pm.dtype != torch.uint8 or \
            st.peq.dtype != torch.int64:
        raise ValueError("staged text must be uint8 and PEQ int64")
    return out


def _launch_fill(st: StagedBanded, work=None) -> dict:
    out = launch_outputs(st)
    if work is not None:
        check_cuda(st.peq, work)
        if work.dtype != torch.int64 or work.shape != (st.B,):
            raise ValueError("work must be a (B,) int64 tensor")
    ptr = torch.Tensor.data_ptr
    FILL.launch(st.peq.device, int(st.full), ptr(st.peq), ptr(st.lm),
                ptr(st.text), ptr(st.init_scores),
                *[ptr(st.lanes[k]) for k in LANE_FIELDS],
                ptr(out["scores_by_k"]), ptr(out["pv"]), ptr(out["mv"]),
                ptr(out["first"]), ptr(out["last"]),
                ptr(out["mat_pv"]) if st.full else None,
                ptr(out["mat_mv"]) if st.full else None,
                ptr(work) if work is not None else None,
                st.B, st.EBB, st.NB)
    return out


def fill_advances(st: StagedBanded) -> int:
    """Myers block advances the batch needs: over every lane, the live
    band blocks of each 64-column block times its columns before the
    lane's text finish, as the CUDA fill counts them on a CUDA batch
    (one extra launch). The bound of the score passes is counted from it."""
    work = torch.empty((st.B,), dtype=torch.int64, device=st.peq.device)
    _launch_fill(st, work)
    return int(work.sum())


def fill_staged(st: StagedBanded) -> dict:
    """Run the fill on the staged batch's device: the CUDA kernel for a
    CUDA batch, the plain version for a CPU one."""
    if st.peq.device.type == "cpu":
        return banded_scan_torch(st)
    return _launch_fill(st)


def run_banded_cuda(batch: BandedBatch, device="cuda") -> dict:
    """Stage and fill a batch; returns the output tensors on `device`
    (scores_by_k, pv, mv, first, last, and mat_pv/mat_mv for full
    batches). `to_host_dict` gives banded_jax.run_banded's dict."""
    return fill_staged(stage_banded(batch, device))


def full_planes_to_host(out: dict) -> tuple:
    """The full fill's planes (`mat_pv`, `mat_mv`: (NB*64, EBB, B) int64
    holding u64 words) as the four u32 (1, NB*64, EBB, B) planes (pv lo,
    pv hi, mv lo, mv hi) that `native.traceback_banded_batch` walks, a
    tile of B lanes. Each word is split on the planes' own device (its
    int32 halves, little-endian) and each half copied to the host once:
    from a card, into page-locked memory from torch's caching host
    allocator, which later calls reuse (on the H100 card's host 50 GB/s,
    against 2.2 GB/s into freshly allocated pageable memory, whose pages
    fault in on every call; PERF.md)."""
    dev = out["mat_pv"].device
    host = []
    for name in ("mat_pv", "mat_mv"):
        for k in (0, 1):
            half = out[name].view(torch.int32)[..., k::2].contiguous()
            if dev.type == "cpu":
                host.append(half)
                continue
            # the copy is ordered on the stream before any later reuse of
            # `half`'s memory by the caching allocator
            dst = torch.empty(half.shape, dtype=half.dtype, pin_memory=True)
            host.append(dst.copy_(half, non_blocking=True))
    if dev.type != "cpu":
        torch.cuda.synchronize(dev)
    return tuple(h.numpy().view(np.uint32)[None] for h in host)


def to_host_dict(out: dict) -> dict:
    """The exact dict of banded_jax.run_banded (banded_jax.py:187-195):
    u32 lo/hi planes, int32 scores and band edges."""
    res = dict(scores_by_k=out["scores_by_k"].cpu().numpy())
    for name in ("pv", "mv"):
        res[f"{name}_lo"], res[f"{name}_hi"] = split_u64(out[name])
    res["first"] = out["first"].cpu().numpy()
    res["last"] = out["last"].cpu().numpy()
    if "mat_pv" in out:
        res["mat_pv_lo"], res["mat_pv_hi"] = split_u64(out["mat_pv"])
        res["mat_mv_lo"], res["mat_mv_hi"] = split_u64(out["mat_mv"])
    return res
