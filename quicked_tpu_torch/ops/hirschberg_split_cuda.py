"""Hirschberg split epilogue on the card.

The counterpart of quicked_tpu/ops/hirschberg_split_jax.py
(`hirschberg_split_batch`, `hsplit_epilogue_interleaved`,
`hsplit_epilogue_tiled`): from the forward and reverse half-pass band
states of each task, its midpoint (pattern_len_left, score_l, score_r,
feasible), as `myers_np.hirschberg_split_fast` computes it. The CUDA
kernel is `csrc/hirschberg_split.cu`; `hirschberg_split_torch` is the
plain PyTorch version, a port of the XLA function.

Both read a score pass's outputs in place (the fill's dict: scores_by_k
(K+1, 2n), pv/mv (EBB, 2n), first/last (2n,)) for a batch whose lanes
interleave the halves, lane 2j forward and lane 2j+1 reverse of task j,
so a split level reads back O(tasks) numbers instead of band planes.
"""

from __future__ import annotations

import torch

from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.device import check_cuda

W = 64
MASKED = 1 << 30

HSPLIT = Kernel("qtt_hirschberg_split", [P] * 12 + [I] * 5 + [P])
MAX_WARPS = 8       # warps a CTA of the kernel


def split_geometry(out: dict, prolog, plen, tlen) -> dict:
    """Per task, the split's geometry from the half passes' first/last
    (hirschberg_split_batch's prologue): feasible, fb, fb_r, bottom_cell
    (the forward running sum's first cell), starting_pos, higher_cell_r
    (the reverse one's) and n_cells, (n,) int64 tensors (feasible bool).
    The split reads the forward band on cells bottom_cell ..
    bottom_cell + n_cells - 2 and the reverse band on higher_cell_r ..
    higher_cell_r + n_cells - 1, all in blocks [first, last] of the lane
    when the task is feasible."""
    pro, plen, tlen = prolog.long(), plen.long(), tlen.long()
    f_first, r_first = out["first"][0::2].long(), out["first"][1::2].long()
    f_last, r_last = out["last"][0::2].long(), out["last"][1::2].long()
    text_mid = (tlen + 1) // 2
    text_mid_r = tlen - text_mid
    fb = torch.where(text_mid < pro * W, 0, text_mid // W - pro)
    fb_r = torch.where(text_mid_r < pro * W, 0, text_mid_r // W - pro)
    bottom_pos = f_first * W + 63 + fb * W
    bottom_pos_r = (plen - 1) - (r_last * W + 63 + fb_r * W)
    higher_pos = f_last * W + 63 + fb * W
    higher_pos_r = (plen - 1) - (r_first * W + 63 + fb_r * W)
    feasible = ~((bottom_pos > higher_pos_r) | (bottom_pos_r > higher_pos))
    use_f_bottom = bottom_pos > bottom_pos_r
    bottom_cell = torch.where(use_f_bottom, f_first * W + 63,
                              bottom_pos_r - fb * W)
    starting_pos = torch.where(use_f_bottom, bottom_pos, bottom_pos_r)
    use_f_high = higher_pos < higher_pos_r
    higher_cell = torch.where(use_f_high, f_last * W + 63,
                              higher_pos_r - fb * W)
    higher_cell_r = torch.where(use_f_high,
                                (plen - 1) - higher_pos - fb_r * W,
                                r_first * W + 63)
    return dict(feasible=feasible, fb=fb, fb_r=fb_r, bottom_cell=bottom_cell,
                starting_pos=starting_pos, higher_cell_r=higher_cell_r,
                n_cells=higher_cell - bottom_cell + 2)


def hirschberg_split_torch(out: dict, prolog, plen, tlen):
    """Plain version: hirschberg_split_batch over the interleaved lanes.
    prolog: the forward lanes' prolog; plen/tlen: each task's pattern and
    text lengths; all (n,). Returns (pll, score_l, score_r, feasible),
    (n,) int32 each (feasible 0/1; an infeasible task's split values are
    0)."""
    pv, mv, scores = out["pv"], out["mv"], out["scores_by_k"].long()
    EBB = pv.shape[0]
    NC = EBB * W + W
    pro, plen = prolog.long(), plen.long()
    n = pro.shape[0]
    dev = pv.device
    g = split_geometry(out, prolog, plen, tlen)
    feasible, fb, fb_r = g["feasible"], g["fb"], g["fb_r"]
    bottom_cell, starting_pos = g["bottom_cell"], g["starting_pos"]
    higher_cell_r, n_cells = g["higher_cell_r"], g["n_cells"]
    steps = torch.arange(NC, device=dev)[:, None]

    def cell_cumsum(pvw, mvw, start):
        idx = start[None] + steps
        blocks, cells = idx >> 6, idx & 63
        ok = (blocks >= 0) & (blocks < EBB)
        blk = blocks.clamp(0, EBB - 1)
        step = ((pvw.gather(0, blk) >> cells) & 1) - \
            ((mvw.gather(0, blk) >> cells) & 1)
        step = torch.where(ok, step, 1)
        return torch.cat([torch.zeros((1, n), dtype=torch.int64,
                                      device=dev), step.cumsum(0)])

    cs = cell_cumsum(pv[:, 0::2], mv[:, 0::2], bottom_cell)
    csr = cell_cumsum(pv[:, 1::2], mv[:, 1::2], higher_cell_r)
    r_idx = (n_cells[None] - 1 - steps).clamp(0, NC)
    joint = csr.gather(0, r_idx) + cs[:NC]
    joint = torch.where(steps < n_cells[None], joint, MASKED)
    smaller_pos = joint.argmin(0)         # the first minimum
    pll = starting_pos + smaller_pos

    def cs_at(arr, idx):
        idx = torch.minimum(idx.clamp(min=0), n_cells).clamp(0, NC)
        return arr.gather(0, idx[None])[0]

    def score_row(sk, row):
        r = row + pro
        inb = (r >= 0) & (r < sk.shape[0])
        v = sk.gather(0, r.clamp(0, sk.shape[0] - 1)[None])[0]
        return torch.where(inb, v, (row + 1) * W)

    block_ref = (pll + W - 1) // W - (n_cells < smaller_pos + W).long()
    score_pos_l = block_ref * W - (bottom_cell + fb * W)
    score_l = cs_at(cs, smaller_pos) - cs_at(cs, score_pos_l) + \
        score_row(scores[:, 0::2], block_ref - 1)
    plr = plen - pll
    block_ref_r = (plr + W - 1) // W - (smaller_pos < W).long()
    score_pos_r = block_ref_r * W - (higher_cell_r + fb_r * W)
    score_r = cs_at(csr, n_cells - 1 - smaller_pos) - \
        cs_at(csr, score_pos_r) + score_row(scores[:, 1::2], block_ref_r - 1)
    return tuple(torch.where(feasible, x, 0).int()
                 for x in (pll, score_l, score_r)) + (feasible.int(),)


def hsplit_launch(n: int, EBB: int, sms: int) -> tuple[int, int]:
    """(warps a task, tasks a CTA) of the kernel for n tasks whose bands
    are EBB blocks deep on a card of `sms` SMs: a warp walks at most 4
    chunks of 32 words of a span (at most EBB + 1 words) unless a task
    has MAX_WARPS warps already; as many tasks to a CTA as MAX_WARPS
    allows while the level still spans the SMs."""
    chunks = -(-(EBB + 1) // 32)
    wpt = min(MAX_WARPS, 1 << (-(-chunks // 4) - 1).bit_length())
    tpc = max(1, min(MAX_WARPS // wpt, n // sms))
    return wpt, tpc


def _launch_hsplit(out: dict, prolog, plen, tlen):
    pv = out["pv"]
    EBB, B2 = pv.shape
    n = B2 // 2
    if B2 != 2 * n or prolog.shape != (n,):
        raise ValueError("split epilogue needs 2 interleaved lanes per task")
    dev = pv.device
    res = [torch.empty((n,), dtype=torch.int32, device=dev)
           for _ in range(4)]
    ints = [out["scores_by_k"], out["first"], out["last"], prolog, plen,
            tlen]
    if any(a.dtype != torch.int32 for a in ints):
        raise ValueError("scores, first/last and task scalars must be int32")
    args = [out["scores_by_k"], pv, out["mv"], out["first"], out["last"],
            prolog, plen, tlen]
    check_cuda(*args, *res)
    wpt, tpc = hsplit_launch(
        n, EBB, torch.cuda.get_device_properties(dev).multi_processor_count)
    HSPLIT.launch(dev, *[a.data_ptr() for a in args],
                  *[r.data_ptr() for r in res], n, EBB,
                  out["scores_by_k"].shape[0], wpt, tpc)
    return tuple(res)


def hirschberg_split(out: dict, prolog, plen, tlen):
    """(pll, score_l, score_r, feasible) per task on the score pass's
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    ones."""
    if out["pv"].device.type == "cpu":
        return hirschberg_split_torch(out, prolog, plen, tlen)
    return _launch_hsplit(out, prolog, plen, tlen)
