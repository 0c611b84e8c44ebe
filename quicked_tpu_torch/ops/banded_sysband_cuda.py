"""Systolic deep-band banded score on the card, with its exact fallback.

The counterpart of quicked_tpu/ops/banded_sysband_pallas.py (the Pallas
TPU kernel `_kernel` through `_pallas_sysband`, `stage_sysband_batch`,
`collect_sysband`, `run_banded_sysband_pallas`); the step model
quicked_tpu/ops/banded_sysband_np.py (`run_sysband_pair`) is the
bit-exact specification both follow; `resident_rows` and `total_steps`
below are copies of its window sizing. The CUDA
kernel is `csrc/banded_sysband.cu`; `banded_sysband_torch` below is the
plain PyTorch version.

Band block-row k runs one column behind row k-1 in the absolute-row
frame, so a step is one advance per resident row; the band cut/shift is
two scalar machines firing at exact steps. A pair whose bottom-edge
decision would need a top-edge value not decided yet is flagged ABORT
and recomputed by the carry-scan pass (`banded_cscan_cuda`), on the same
device: `sysband_staged` returns the merged, exact result and counts the
lanes it recomputed on `SYSBAND.fallbacks`.

Contract (the model's): scores_by_k, first and last exact; pv/mv exact
on [first, last].
"""

from __future__ import annotations

import math

import torch

from quicked_tpu_torch._build import I, P, Kernel
from quicked_tpu_torch.device import stream_ptr
from quicked_tpu_torch.ops.banded_cscan_cuda import cscan_staged
from quicked_tpu_torch.ops.banded_cuda import (LANE_FIELDS, StagedBanded,
                                               advance_block, launch_outputs,
                                               select_lanes)

W = 64
CY = W + 1
RECENTER = 128
TOPBIT = -(1 << 63)      # the level mask of rows past the pattern
# 1024 threads x 16 rows: the route sends at most EBB 8192 (the largest
# pow2 bucket at or below SYSBAND_MAX_EBB), which needs 8704 rows
MAX_RESIDENT = 16 * 1024

def resident_rows(ebb: int) -> int:
    """Resident-window depth in RECENTER-lane rows: EBB+2 band rows +
    the recenter slab + early-trigger slack (fresh top slots must sit
    >= RECENTER rows above the band top so the chars cascade warms them
    before activation). The kernel's window sizing MUST match the
    model's — the recenter-delayed abort depends on this slack."""
    return -(-(ebb + 2 + 3 * RECENTER + 4) // RECENTER)


def total_steps(nb: int, ns: int) -> int:
    """Step count covering the last event E2(NB-1) at ~la + CY*(NB-1)
    + 63 with la up to NB + EBB: the skew adds ~NB + NS on top of the
    CY*NB columns, plus drain slack."""
    return CY * nb + nb + ns + 2 * CY


SYSBAND = Kernel("qtt_banded_sysband", [P] * 16 + [I] * 5 + [P])


def geometry(EBB: int) -> tuple[int, int]:
    """(NS, RING): resident rows and the first/last ring length, as the
    Pallas kernel sizes them (stage_sysband_batch)."""
    NS = resident_rows(EBB) * RECENTER
    ring = 1 << max(math.ceil(math.log2(NS // CY + 8)), 4)
    return NS, ring


def _lane_torch(st: StagedBanded, j: int, NS: int):
    """The step model for lane j, vectorized over the NS resident rows
    (slot s holds row base + s). Returns (scores (K+1,), pv (EBB,),
    mv (EBB,), first, last, abort)."""
    EBB, NB = st.EBB, st.NB
    K = NB + EBB
    dev = st.peq.device
    lane = {k: int(v[j]) for k, v in st.lanes.items()}
    cutoff, prolog, nbr = lane["cutoff"], lane["prolog"], lane["nbr"]
    finish_v, tfinish = lane["finish_v"], lane["tfinish"]
    first0, last0 = lane["first0"], lane["last0"]
    tf64 = tfinish // W
    text = st.text[:, j].long()
    # rows past K match everything at the top level (batch_prep's fill)
    peq = torch.cat([st.peq[:, :, j],
                     torch.full((NS, 5), -1, dtype=torch.int64, device=dev)])
    lm = torch.cat([st.lm[:, j],
                    torch.full((NS,), TOPBIT, dtype=torch.int64,
                               device=dev)])

    def formula(k):
        return (k - prolog + 1) * W

    slots = torch.arange(NS, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    base = 0
    pv = torch.full((NS,), -1, dtype=torch.int64, device=dev)
    mv = torch.zeros(NS, dtype=torch.int64, device=dev)
    srow = formula(slots)
    pho = torch.zeros(NS, dtype=torch.int64, device=dev)
    mho = torch.zeros_like(pho)
    act_bot, act_top, isf = slots >= first0, slots <= last0, slots == first0
    scores = formula(torch.arange(K + 1, device=dev))

    nbB, fsB, nbT, lsT, cl1 = 0, first0, 0, last0, 0
    fring, lring = {0: first0}, {0: last0}
    bd = None            # (t, row, case) of the last bottom event
    tp = None            # (t, row) of the pending top-edge activation
    abort = False

    def read(row):
        s = row - base
        return int(srow[s]) if 0 <= s < NS else 0

    def set_mask(mask, row, value):
        s = row - base
        if 0 <= s < NS:
            mask[s] = value

    for t in range(total_steps(NB, NS)):
        # ---- mask edits scheduled for this step ----
        if bd is not None:
            bt, brow, bcase = bd
            if bcase >= 1 and t == bt + 1:
                set_mask(act_bot, brow, False)
                set_mask(isf, brow, False)
            if t == bt + 2 and bcase == 1:
                set_mask(isf, brow + 1, True)
            if t == bt + 2 and bcase == 2:
                set_mask(act_bot, brow + 1, False)
                set_mask(isf, brow + 1, False)
            if t == bt + 3 and bcase == 2:
                set_mask(isf, brow + 2, True)
        if tp is not None and t == tp[0]:
            set_mask(act_top, tp[1], True)

        # ---- one advance per resident row ----
        k = base + slots
        u = t - k
        q = torch.div(u, CY, rounding_mode="floor")
        col = W * q + (u - CY * q)
        adv = (u >= 0) & (u - CY * q != W) & (col < tfinish)
        c = text[col.clamp(0, text.shape[0] - 1)]
        eq = peq[k, c]
        phin = torch.where(isf, 1, torch.cat([zero, pho[:-1]]))
        mhin = torch.where(isf, 0, torch.cat([zero, mho[:-1]]))
        npv, nmv, phout, mhout = advance_block(eq, lm[k], pv, mv, phin, mhin)
        wr = adv & act_bot & act_top
        pv = torch.where(wr, npv, pv)
        mv = torch.where(wr, nmv, mv)
        srow = srow + torch.where(wr, phout - mhout, 0)
        pho = torch.where(adv, phout, 0)
        mho = torch.where(adv, mhout, 0)

        # ---- bottom machine: E1(nbB) ----
        if nbB < NB and t == 66 * nbB + fsB + 64:
            faB = nbB + fsB
            ds_b = (nbB + 1) * W <= tfinish
            if nbB <= nbT:
                b_true = fsB + 2 < lring[nbB]
                b_false = not b_true
            else:
                b_true = fsB + 2 < lsT - (nbB - nbT)
                b_false = fsB + 2 >= lsT
            abort |= ds_b and not b_true and not b_false
            c_first1 = read(faB + 1)
            a_pred = finish_v > W * (fsB + 1) and \
                c_first1 + (finish_v - W * (fsB + 1)) > cutoff
            cut_lower = a_pred and b_true
            inc = ds_b and cut_lower and nbB >= prolog
            dec = ds_b and not cut_lower and nbB < prolog
            new_fs = fsB + int(inc) - int(dec)
            if ds_b:
                bd = (t, faB, 1 + new_fs - fsB)
            fring[nbB + 1] = new_fs
            nbB += 1
            fsB = new_fs

        # ---- top machine: c_last1 capture and E2(nbT) ----
        def first_le(thr, nb_q):
            """first(nb_q) <= thr: (surely, surely not)."""
            if nb_q <= nbB:
                return fring[nb_q] <= thr, fring[nb_q] > thr
            dist = nb_q - nbB
            return fsB + dist <= thr, fsB - dist > thr

        if nbT < NB:
            laT = nbT + lsT
            ds_t = (nbT + 1) * W <= tfinish
            if t == 66 * nbT + lsT + 62:
                yes, no = first_le(lsT - 1, nbT)
                abort |= ds_t and not yes and not no
                cl1 = read(laT - 1) if ds_t and yes else 0
            elif t == 66 * nbT + lsT + 63:
                m_t, m_f = first_le(lsT, nbT)
                bt_t, bt_f = first_le(lsT - 3, nbT + 1)
                abort |= ds_t and ((not m_t and not m_f) or
                                   (not bt_t and not bt_f))
                c_last = read(laT) if ds_t and m_t else 0
                cut_higher = bt_t and W * (lsT - 1) > finish_v and \
                    cl1 + (W * (lsT - 1) - finish_v) > cutoff
                clamp = nbT - prolog + lsT >= nbr
                abort |= ds_t and laT + 1 - base >= NS
                if ds_t:
                    set_mask(srow, laT + 1, c_last + W)
                new_ls = lsT - int(ds_t and (cut_higher or clamp))
                if ds_t and new_ls == lsT:
                    tp = (t + 3, laT + 1)
                lring[nbT + 1] = new_ls
                nbT += 1
                lsT = new_ls

        # ---- recenter ----
        nb_floor = min(nbB, nbT)
        laT1 = nbT + lsT + 1
        if (laT1 - base >= NS - 1 - RECENTER and base + RECENTER <= tf64
                and nb_floor + fring[nb_floor] > base + RECENTER - 1):
            abort |= laT1 - base > NS - 1 - RECENTER
            hi = min(base + RECENTER, K + 1)
            scores[base:hi] = srow[:hi - base]
            base += RECENTER

            def shift(x, fill):
                """Drop the bottom 128 slots; fresh top slots get fill."""
                return torch.cat([x[RECENTER:],
                                  torch.full_like(x[:RECENTER], fill)])

            pv, mv, pho, mho = (shift(pv, -1), shift(mv, 0), shift(pho, 0),
                                shift(mho, 0))
            srow = torch.cat([srow[RECENTER:],
                              formula(base + NS - RECENTER
                                      + slots[:RECENTER])])
            act_bot = shift(act_bot, True)
            act_top = shift(act_top, False)
            isf = shift(isf, False)

    hi = min(base + NS, K + 1)
    scores[base:hi] = srow[:hi - base]
    rows = tf64 + torch.arange(EBB, device=dev)
    ok = (rows >= base) & (rows < base + NS)
    idx = (rows - base).clamp(0, NS - 1)
    pv_out = torch.where(ok, pv[idx], -1)
    mv_out = torch.where(ok, mv[idx], 0)
    return scores, pv_out, mv_out, fsB, lsT, abort


def banded_sysband_torch(st: StagedBanded) -> tuple[dict, torch.Tensor]:
    """Plain PyTorch version of the kernel, lane by lane. Returns the
    fill's dict and the (B,) bool ABORT flags (an aborted lane's outputs
    are not meaningful)."""
    if st.full:
        raise ValueError("the systolic kernel is score-only")
    NS, _ = geometry(st.EBB)
    lanes = [_lane_torch(st, j, NS) for j in range(st.B)]
    dev = st.peq.device

    def stack(i, dtype):
        return torch.stack([ln[i] for ln in lanes], dim=1).to(dtype)

    def vec(i):
        return torch.tensor([ln[i] for ln in lanes], dtype=torch.int32,
                            device=dev)

    out = dict(scores_by_k=stack(0, torch.int32), pv=stack(1, torch.int64),
               mv=stack(2, torch.int64), first=vec(3), last=vec(4))
    return out, vec(5) != 0


def _launch_sysband(st: StagedBanded) -> tuple[dict, torch.Tensor]:
    if st.full:
        raise ValueError("the systolic kernel is score-only")
    NS, ring = geometry(st.EBB)
    if NS > MAX_RESIDENT:
        raise ValueError(f"EBB {st.EBB}: the systolic kernel holds at most "
                         f"{MAX_RESIDENT} resident rows, {NS} needed")
    abort = torch.empty((st.B,), dtype=torch.int32, device=st.peq.device)
    out = launch_outputs(st, abort)
    ptr = torch.Tensor.data_ptr
    SYSBAND.launch(ptr(st.peq), ptr(st.lm), ptr(st.text),
                   *[ptr(st.lanes[k]) for k in LANE_FIELDS],
                   ptr(out["scores_by_k"]), ptr(out["pv"]), ptr(out["mv"]),
                   ptr(out["first"]), ptr(out["last"]), ptr(abort), st.B,
                   st.EBB, st.NB, NS, ring, stream_ptr(st.peq.device))
    return out, abort != 0


def sysband_raw(st: StagedBanded) -> tuple[dict, torch.Tensor]:
    """The systolic pass alone on the staged batch's device (the CUDA
    kernel for a CUDA batch, the plain version for a CPU one): the fill's
    dict and the ABORT flags, before any fallback."""
    if st.peq.device.type == "cpu":
        return banded_sysband_torch(st)
    return _launch_sysband(st)


def sysband_staged(st: StagedBanded) -> dict:
    """The systolic pass with aborted lanes recomputed by the carry-scan
    pass on the same device and merged: the exact score-pass dict."""
    out, aborted = sysband_raw(st)
    idx = aborted.nonzero()[:, 0]
    if len(idx):
        SYSBAND.fallbacks += len(idx)
        fb = cscan_staged(select_lanes(st, idx))
        for k, v in fb.items():
            out[k][..., idx] = v
    return out
