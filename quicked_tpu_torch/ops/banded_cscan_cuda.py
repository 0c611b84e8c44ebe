"""Deep-band banded score on the card: the carry-map scan.

The counterpart of quicked_tpu/ops/banded_cscan_pallas.py (the Pallas
TPU kernel `_kernel` through `_pallas_cscan`, `stage_cscan_batch`,
`run_banded_cscan_pallas`, `collect_cscan`) and of its XLA twin
banded_cscan_jax.py (`cscan_scan_impl`, `advance_variants`,
`compose_maps`). The CUDA kernel is `csrc/banded_cscan.cu`;
`banded_cscan_torch` below is the plain PyTorch version.

The carry entering a band block is one of three states, P (PHin=1), Z
(none) or M (MHin=1), and a block's carry-out as a function of its
carry-in is a pair (a, b) = (out for P or Z, out for M): P and Z give
the same carry-out. Such maps compose associatively, so a column's
block-to-block carry chain is an exclusive prefix composition over the
blocks, started from constant P below block `first`.

It takes the fill's staged score batch (`banded_cuda.StagedBanded`) and
returns the dict `banded_cuda.fill_staged` returns: scores_by_k, pv, mv,
first, last.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.ops.banded_cuda import (LANE_FIELDS, StagedBanded,
                                               advance_block, launch_outputs,
                                               maintain)

W = 64
P_ST, Z_ST, M_ST = 0, 1, 2
# one CTA per pair: 16 warps of 4 band blocks a thread hold 2048 blocks in
# registers; deeper bands are walked in rounds of 2048, up to MAX_EBB
MULTI_S, MAX_WARPS = 4, 16
MAX_EBB = 1024 * 64

CSCAN = Kernel("qtt_banded_cscan", [P] * 16 + [I] * 5 + [P])


@dataclasses.dataclass(frozen=True)
class CscanLaunch:
    """How the kernel runs a band of EBB blocks: S band blocks a thread,
    the threads of a pair's CTA, rounds per column (1: the band stays in
    registers) and the dynamic shared memory of a CTA."""

    S: int
    threads: int
    rounds: int
    smem_bytes: int


def cscan_launch(EBB: int) -> CscanLaunch:
    """One warp with one band block a thread up to 32 blocks; then up to
    16 warps of S = 1, 2 or 4 blocks a thread (the least S that fits), so
    that the few pairs the kernel takes spread their blocks over many
    warps; past 2048 blocks 16 warps of S = 4 walking the band in rounds
    of 2048. Shared memory: the boundary Pv/Mv words of each thread and
    the scores window (the register modes; the rounds keep both in device
    memory)."""
    if not 1 <= EBB <= MAX_EBB:
        raise ValueError(f"EBB {EBB}: the carry-scan kernel takes 1 to "
                         f"{MAX_EBB} band blocks")
    S = next((s for s in (1, 2, 4) if EBB <= 32 * MAX_WARPS * s), MULTI_S)
    threads = 32 * min(-(-EBB // (32 * S)), MAX_WARPS)
    rounds = -(-EBB // (threads * S))
    smem = 0 if rounds > 1 else 8 * (2 * (threads + 1) + (EBB + 2) // 2)
    return CscanLaunch(S=S, threads=threads, rounds=rounds, smem_bytes=smem)


def _out_state(pho, mho):
    """Carry-out encoding: P if PHout, else M if MHout, else Z."""
    return torch.where(pho != 0, P_ST, torch.where(mho != 0, M_ST, Z_ST))


def compose_maps(af, bf, ag, bg):
    """f after g, each map a pair (image of P or Z, image of M)."""
    return (torch.where(ag == M_ST, bf, af), torch.where(bg == M_ST, bf, af))


def _shift_down(x, d: int):
    """y[i] = x[i - d] along the block axis; the d lowest rows get P."""
    if d >= x.shape[0]:
        return torch.full_like(x, P_ST)
    return torch.cat([torch.full_like(x[:d], P_ST), x[:-d]])


def banded_cscan_torch(st: StagedBanded) -> dict:
    """Plain PyTorch version: banded_cscan_jax.cscan_scan_impl, every
    band block of a column at once (vectorized over blocks and lanes),
    the carries resolved by a Hillis-Steele scan over the block axis."""
    if st.full:
        raise ValueError("the carry-scan kernel is score-only")
    B, EBB, NB = st.B, st.EBB, st.NB
    dev = st.peq.device
    tfinish = st.lanes["tfinish"].long()
    first = st.lanes["first0"].long().clone()
    last = st.lanes["last0"].long().clone()
    pv = torch.full((EBB, B), -1, dtype=torch.int64, device=dev)
    mv = torch.zeros((EBB, B), dtype=torch.int64, device=dev)
    scw = st.init_scores.long().clone()
    text = st.text.long()
    blk = torch.arange(EBB, device=dev)[:, None]
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    ones = torch.ones(B, dtype=torch.int64, device=dev)
    n_levels = max(math.ceil(math.log2(max(EBB, 2))), 1)
    dropped = []
    for nb in range(NB):
        peq_win = st.peq[nb:nb + EBB]                     # (EBB, 5, B)
        lm_win = st.lm[nb:nb + EBB]
        for j in range(W):
            t = nb * W + j
            c = text[t][None, None].expand(EBB, 1, B)
            eq = peq_win.gather(1, c)[:, 0]
            z_pv, z_mv, z_pho, z_mho = advance_block(eq, lm_win, pv, mv,
                                                     zeros, zeros)
            m_pv, m_mv, m_pho, m_mho = advance_block(eq, lm_win, pv, mv,
                                                     zeros, ones)
            # P from Z: only bit 0 of the new words differs
            p_pv = z_pv & -2
            p_mv = (z_mv & -2) | ((eq | mv) & 1)
            below = blk < first[None]
            a = torch.where(below, P_ST, _out_state(z_pho, z_mho))
            b = torch.where(below, P_ST, _out_state(m_pho, m_mho))
            a, b = _shift_down(a, 1), _shift_down(b, 1)
            for lev in range(n_levels):
                d = 1 << lev
                a, b = compose_maps(a, b, _shift_down(a, d),
                                    _shift_down(b, d))
            is_m, is_p = a == M_ST, a == P_ST
            act = (t < tfinish)[None] & (blk >= first[None]) & \
                (blk <= last[None])
            pv = torch.where(act, torch.where(
                is_m, m_pv, torch.where(is_p, p_pv, z_pv)), pv)
            mv = torch.where(act, torch.where(
                is_m, m_mv, torch.where(is_p, p_mv, z_mv)), mv)
            delta = torch.where(is_m, m_pho - m_mho, z_pho - z_mho)
            scw[:EBB] += torch.where(act, delta, 0)

        def cap(rows):
            return scw[:EBB].gather(0, rows.clamp(0, EBB - 1)[None])[0]

        pv, mv, scw, first, last, row0 = maintain(
            st, nb, pv, mv, scw, first, last, cap(first + 1), cap(last - 1),
            cap(last))
        dropped.append(row0)
    return dict(scores_by_k=torch.cat(
                    [torch.stack(dropped).reshape(NB, B), scw]).int(),
                pv=pv, mv=mv, first=first.int(), last=last.int())


def _launch_cscan(st: StagedBanded) -> dict:
    if st.full:
        raise ValueError("the carry-scan kernel is score-only")
    geo = cscan_launch(st.EBB)
    out = launch_outputs(st)
    ptr = torch.Tensor.data_ptr
    CSCAN.launch(st.peq.device, ptr(st.peq), ptr(st.lm), ptr(st.text_pm),
                 ptr(st.init_scores), *[ptr(st.lanes[k]) for k in LANE_FIELDS],
                 ptr(out["scores_by_k"]), ptr(out["pv"]), ptr(out["mv"]),
                 ptr(out["first"]), ptr(out["last"]), st.B, st.EBB, st.NB,
                 geo.S, geo.threads)
    return out


def cscan_staged(st: StagedBanded) -> dict:
    """The carry-scan score pass on the staged batch's device: the CUDA
    kernel for a CUDA batch, the plain version for a CPU one."""
    if st.peq.device.type == "cpu":
        return banded_cscan_torch(st)
    return _launch_cscan(st)
