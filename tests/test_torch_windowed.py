"""Parity: the port's windowed score bound and full-CIGAR mode
(quicked_tpu_torch.ops.windowed_cuda) vs the JAX package's XLA
while-loop (windowed_jax.run_windowed_score, run_windowed_full) and the
numpy model (myers_np.windowed_compute): scores, high-error-window counts
and op strings must be equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.ops import myers_np
from quicked_tpu.ops import windowed_jax as wj
from quicked_tpu_torch.ops import windowed_cuda as wc

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)


def _pairs(n, length, error, seed, length_diff=1.0, **kw):
    return list(generate.generate_pairs(n, length, error=error, seed=seed,
                                        length_diff=length_diff, **kw))


def _check(pats, txts, ws, ovl, model=False):
    jb = wj.prepare_windowed_batch(pats, txts, window_size=ws, pad_to_b=8)
    tb = wc.prepare_windowed_batch(pats, txts, window_size=ws, pad_to_b=8)
    for f in ("peq_lo", "peq_hi", "text_enc", "text_raw", "pat_raw",
              "plen", "tlen", "num_words"):
        np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f))
    want = wj.run_windowed_score(jb, 40, ws, ovl)
    got = wc.run_windowed_score(tb, 40, ws, ovl, device="cpu")
    np.testing.assert_array_equal(want[0], got[0], err_msg="score")
    np.testing.assert_array_equal(want[1], got[1], err_msg="hew")
    if model:
        for i, (p, t) in enumerate(zip(pats, txts)):
            ms, _, mhew = myers_np.windowed_compute(p, t, 40, ws, ovl,
                                                    score_only=True)
            assert (got[0][i], got[1][i]) == (ms, mhew), i


@pytest.mark.parametrize("ws,ovl,length,error,seed,ldiff", [
    (2, 1, 150, 0.05, 1, 1.0),
    (2, 1, 400, 0.2, 3, 1.2),
    (2, 1, 129, 0.1, 4, 0.8),
    (3, 2, 300, 0.1, 7, 1.0),
])
def test_torch_windowed_score_parity(ws, ovl, length, error, seed, ldiff):
    pairs = _pairs(6, length, error, seed, ldiff)
    _check([p for p, _ in pairs], [t for _, t in pairs], ws, ovl,
           model=True)


def test_torch_windowed_ws9_large_indels():
    """Stage 2's shape: ws 9 over pairs with large indels (HEWs > 0)."""
    pairs = _pairs(4, 700, 0.15, 5, indels_num=2, indels_length=100)
    _check([p for p, _ in pairs], [t for _, t in pairs], 9, 1)


@pytest.mark.parametrize("ws,ovl", [(2, 1), (3, 1), (2, 0)])
def test_torch_windowed_extreme_indels(ws, ovl):
    """Long D/I runs (run clamping at the overlap exit, block-crossing
    runs), pure deletions/insertions and N-char raw compares."""
    rng = np.random.default_rng(31 + ws)
    pats, txts = [], []
    for _ in range(3):
        pl = int(rng.integers(150, 400))
        tl = int(rng.integers(5, pl // 2))
        p = "".join(rng.choice(list("ACGT"), pl))
        tp = int(rng.integers(0, pl - tl + 1))
        pats.append(p)
        txts.append(p[tp:tp + tl])               # deletion-heavy
    for _ in range(2):
        tl = int(rng.integers(150, 400))
        pl = int(rng.integers(5, tl // 2))
        t = "".join(rng.choice(list("ACGTN"), tl))
        pats.append(t[:pl].replace("A", "N"))    # insertion-heavy + N
        txts.append(t)
    pats.append("A" * 200)                       # all-D column runs
    txts.append("C" * 3)
    _check(pats, txts, ws, ovl, model=True)


def test_torch_windowed_short_pairs():
    """Pairs much shorter than one window, and the mixed-length bucket."""
    pairs = (_pairs(4, 30, 0.1, 14) + _pairs(2, 64, 0.2, 15)
             + _pairs(2, 257, 0.05, 13, 1.3))
    _check([p for p, _ in pairs], [t for _, t in pairs], 2, 1, model=True)


def test_torch_windowed_rejects_wide_windows():
    """The CUDA wrapper refuses a window size below 1 before it launches
    anything. A wide window (ws >= 15, held in a scratch buffer on the
    card) passes that check and stops only at the device check here."""
    tb = wc.prepare_windowed_batch(["ACGT"], ["ACGT"], window_size=17)
    st = wc.stage_windowed(tb, "cpu")
    with pytest.raises(ValueError, match="window_size"):
        wc._launch_windowed(st, 0, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        wc._launch_windowed(st, 17, 1, 0)
    assert wc.WINDOWED.launches == 0


def test_torch_windowed_ws20_matches_jax():
    """A window wider than the kernel's register window (ws 20): the
    cascade's bucketed windowed bound equals the JAX package's."""
    from quicked_tpu.aligner import cascade as jax_cascade
    from quicked_tpu_torch.aligner import cascade

    pairs = _pairs(2, 300, 0.1, 21) + _pairs(1, 900, 0.15, 22,
                                             indels_num=1,
                                             indels_length=80)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    want = jax_cascade.windowed_score_batch(pats, txts, 40, 20, 1)
    got = cascade.windowed_score_batch(pats, txts, 40, 20, 1, device="cpu")
    np.testing.assert_array_equal(np.asarray(want[0]), got[0])
    np.testing.assert_array_equal(np.asarray(want[1]), got[1])


@pytest.mark.parametrize("ws", [2, 9])
def test_torch_windowed_batch_matches_host_c(ws):
    """The port's bucketed windowed bound (the plain version on the CPU)
    equals the host C qh_windowed_score pair by pair."""
    from quicked_tpu_torch import dna, native
    from quicked_tpu_torch.aligner import cascade

    if not native.available():
        pytest.skip("no C compiler for the host C runtime")
    pairs = _pairs(3, 800, 0.15, 23, indels_num=2, indels_length=90) + \
        _pairs(2, 200, 0.1, 24, 1.3) + [("ACGTTAGC" * 3, "ACGTAGC" * 2)]
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    got = cascade.windowed_score_batch(pats, txts, 40, ws, 1, device="cpu")
    for i, (p, t) in enumerate(pairs):
        want = native.windowed_score(dna.encode(p), p.encode(),
                                     dna.encode(t), t.encode(), ws, 1, 40)
        assert (int(got[0][i]), int(got[1][i])) == want, i


def test_torch_windowed_geometry():
    """The windowed kernel's launch geometry for ws 1..40 on the H100
    (132 SMs; 232,448 bytes of shared memory a CTA, 1,280 of them the
    kernel's static PEQ table): segments of next_pow2(ws) lanes (at most
    32), the CTA's shared memory within that limit, the scratch taken
    exactly where one pair's window does not fit, and the packing
    narrowed until a batch of enough pairs spans the SMs."""
    sms, dyn = 132, 232_448 - 1280
    for ws in range(1, 41):
        fits = wc.shared_pair_bytes(ws) <= dyn
        assert fits == (ws <= 14), ws
        for B in (1, 17, 140, 1000, 5000):
            g = wc.windowed_geometry(ws, B, sms, dyn)
            assert g.span * g.pairs_per_warp == 32
            assert g.span >= min(ws, 32)
            assert g.span & (g.span - 1) == 0
            assert g.shared_bytes + 1280 <= 232_448
            if fits:
                assert g.shared_bytes == \
                    g.pairs_per_warp * wc.shared_pair_bytes(ws)
                assert g.scratch_bytes == 0
            else:
                assert g.shared_bytes == 0
                assert g.scratch_bytes == wc.scratch_pair_bytes(ws)
            warps = -(-B // g.pairs_per_warp)
            assert g.pairs_per_warp == 1 or warps >= sms, (ws, B)
            if B >= sms * 32 and fits:
                # the widest packing shared memory allows
                assert 2 * g.shared_bytes > dyn or \
                    g.span == min(32, 1 << (ws - 1).bit_length()), (ws, B)
    assert wc.windowed_geometry(2, 5000, sms, dyn).pairs_per_warp == 16
    assert wc.windowed_geometry(9, 1000, sms, dyn).pairs_per_warp == 2
    assert wc.windowed_geometry(9, 100, sms, dyn).pairs_per_warp == 1


def _check_full(pats, txts, ws, ovl):
    """The port's full mode (plain version) against the JAX package's
    run_windowed_full and the numpy model, op string by op string."""
    jb = wj.prepare_windowed_batch(pats, txts, window_size=ws, pad_to_b=8)
    want = wj.run_windowed_full(jb, ws, ovl)
    got = wc.run_windowed_full(
        wc.prepare_windowed_batch(pats, txts, window_size=ws), ws, ovl,
        device="cpu")
    assert got == want[:len(pats)]
    for i, (p, t) in enumerate(zip(pats, txts)):
        _, mops, _ = myers_np.windowed_compute(p, t, 0, ws, ovl,
                                               score_only=False)
        assert got[i] == mops, (i, len(p), len(t))


@pytest.mark.parametrize("ws,ovl,length,error,seed,ldiff", [
    (2, 1, 150, 0.08, 21, 1.0),
    (2, 1, 300, 0.15, 22, 1.2),
    (9, 1, 700, 0.1, 23, 1.0),
    (3, 2, 260, 0.1, 24, 0.8),
])
def test_torch_windowed_full_cigar_parity(ws, ovl, length, error, seed,
                                          ldiff):
    pairs = _pairs(5, length, error, seed, ldiff)
    _check_full([p for p, _ in pairs], [t for _, t in pairs], ws, ovl)


@pytest.mark.parametrize("ws,ovl", [(2, 1), (3, 1)])
def test_torch_windowed_full_extreme_indels(ws, ovl):
    """Long D/I runs, the M-outranks-D tie-break on match columns, pure
    deletions and insertions, N characters."""
    rng = np.random.default_rng(47 + ws)
    pats, txts = [], []
    for _ in range(2):
        pl = int(rng.integers(150, 350))
        tl = int(rng.integers(5, pl // 2))
        p = "".join(rng.choice(list("ACGTN"), pl))
        tp = int(rng.integers(0, pl - tl + 1))
        pats.append(p)
        txts.append(p[tp:tp + tl])
        pats.append(p[tp:tp + tl])
        txts.append(p)
    pats.append("A" * 150)
    txts.append("C" * 4)
    _check_full(pats, txts, ws, ovl)


def test_torch_windowed_full_ws20_matches_model():
    """ws 20 (the kernel's scratch mode): the port's bucketed full mode
    against the numpy model."""
    from quicked_tpu_torch.aligner import cascade

    pairs = _pairs(2, 500, 0.1, 25) + _pairs(1, 1500, 0.12, 26,
                                             indels_num=1,
                                             indels_length=200)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    got = cascade.windowed_full_batch(pats, txts, 20, 1, device="cpu")
    for i, (p, t) in enumerate(pairs):
        _, mops, _ = myers_np.windowed_compute(p, t, 0, 20, 1,
                                               score_only=False)
        assert got[i] == mops, i


def test_torch_windowed_full_align_batch_matches_jax():
    """align_batch(WINDOWED, only_score=False) of the port against the
    JAX package's on the CPU: statuses, scores and CIGARs, an empty pair
    among them."""
    from quicked_tpu import api as jax_api
    from quicked_tpu.params import QuickedAlgo, QuickedParams
    from quicked_tpu_torch import api

    pairs = _pairs(3, 600, 0.12, 27, indels_num=1, indels_length=60) + \
        [("ACGT", ""), ("ACGTNACGT", "ACGTACGGT")]
    prm = QuickedParams(algo=QuickedAlgo.WINDOWED, only_score=False,
                        window_size=2, overlap_size=1)
    got = api.align_batch(pairs, prm, device="cpu")
    want = jax_api.align_batch(pairs, prm)
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)
    assert all(c for c in got.cigar[:3])


def test_torch_windowed_full_refuses_cpu_tensors():
    """The full-mode wrapper launches only on CUDA tensors."""
    tb = wc.prepare_windowed_batch(["ACGT"], ["ACGT"], window_size=2)
    st = wc.stage_windowed(tb, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        wc._launch_windowed_full(st, 2, 1)
    assert wc.WINDOWED_FULL.launches == 0


# the full mode's op buffer at the kernel's branches: ws 1 (ovl 0), 2, 3,
# 9 (the default), 14 (the last window in shared memory), 15 (the first in
# the scratch), 20, and 33 (past one warp of blocks)
FULL_OPS_SHAPES = [(1, 0), (2, 1), (3, 1), (9, 1), (14, 1), (15, 1), (20, 1),
                   (33, 1)]


def _full_ops_pairs(ws, seed):
    """Pairs for the op buffer, made with numpy from `seed`: random pairs
    with 4% substitutions, deletions and insertions each, 0.6 and 1.3
    windows long; a long block deleted from the text and the same block
    inserted; a pure-deletion and a pure-insertion pair; pairs shorter than
    a window; one empty side of each kind; `N` and a non-ASCII character."""
    rng = np.random.default_rng(seed)
    cols = 64 * ws

    def rand(n):
        return "".join(rng.choice(list("ACGT"), n))

    def mutate(s):
        out = []
        for ch, r in zip(s, rng.random(len(s))):
            if r < 0.04:
                continue
            out.append(str(rng.choice(list("ACGT"))) if r < 0.08 else ch)
            if r > 0.96:
                out.append(str(rng.choice(list("ACGT"))))
        return "".join(out)

    pats, txts = [], []
    for f in (0.6, 1.3):
        p = rand(int(cols * f))
        pats.append(p)
        txts.append(mutate(p))
    p = rand(int(cols * 1.2))
    k = len(p) // 3
    pats += [p, p[:k] + p[2 * k:]]
    txts += [p[:k] + p[2 * k:], p]
    d = rand(min(cols, 400) + 40)
    pats += [d, d[30:90]]
    txts += [d[30:90], d]
    pats += ["ACGTTGCA", "ACGTAC", ""]
    txts += ["ACGTGCA", "", "ACG"]
    pats.append("ACGTNNACGÄTTACGT" * 3)
    txts.append("ACGTNACGÄTTACCGT" * 3)
    return pats, txts


@pytest.mark.parametrize("ws,ovl", FULL_OPS_SHAPES)
def test_torch_windowed_full_ops_match_jax(ws, ovl):
    """The full mode's op buffer (`windowed_full_ops_torch`, the plain
    version of the kernel's function: ops (B, L) uint8, start (B,) int32)
    against windowed_jax.run_windowed_full, op string by op string: every
    start at least 0, no pair past its own P + T bound, L the batch's
    P + T rounded up to 16 bytes; `run_windowed_full` on the CPU gives the
    same strings."""
    pats, txts = _full_ops_pairs(ws, 60 + ws)
    want = wj.run_windowed_full(
        wj.prepare_windowed_batch(pats, txts, window_size=ws), ws, ovl)
    tb = wc.prepare_windowed_batch(pats, txts, window_size=ws)
    ops, start = wc.windowed_full_ops_torch(wc.stage_windowed(tb, "cpu"), ws,
                                            ovl)
    assert ops.dtype == torch.uint8 and start.dtype == torch.int32
    L = ops.shape[1]
    assert ops.shape[0] == len(pats) and L == wc.ops_width(tb.P, tb.T)
    assert L % 16 == 0 and L - 16 < tb.P + tb.T <= L
    assert bool((start >= 0).all())
    for i, (p, t) in enumerate(zip(pats, txts)):
        assert L - int(start[i]) <= len(p) + len(t), i
    assert wc.decode_ops(ops.numpy(), start.numpy()) == want
    assert wc.run_windowed_full(tb, ws, ovl, device="cpu") == want


@pytest.mark.parametrize("ws,shared", [(2, None), (2, True), (2, False),
                                       (15, None), (33, False)])
def test_torch_windowed_full_launch_refuses_cpu_tensors(ws, shared):
    """The full-mode launcher refuses a CPU batch, whichever place the
    window would take, before it launches anything."""
    tb = wc.prepare_windowed_batch(["ACGT"], ["ACGT"], window_size=ws)
    st = wc.stage_windowed(tb, "cpu")
    before = wc.WINDOWED_FULL.launches
    with pytest.raises(ValueError, match="CUDA"):
        wc._launch_windowed_full(st, ws, 1, shared)
    assert wc.WINDOWED_FULL.launches == before


def test_torch_windowed_full_geometry():
    """The full mode's launch geometry on the H100 (132 SMs, 231,168
    bytes of dynamic shared memory a CTA): a pair a warp; the window in
    shared memory beside the op ring and the walk's chunk (3 KB) where it
    fits (ws <= 14) and the batch runs in one wave of the CTAs that memory
    lets an SM hold, else in the scratch with those 3 KB alone in shared
    memory; a forced choice
    never puts a window that does not fit in shared memory."""
    sms, dyn = 132, 232_448 - 1280
    ring = wc.FULL_STAGE_BYTES
    for ws in range(1, 41):
        per = ring + wc.shared_pair_bytes(ws)
        fits = per <= dyn
        assert fits == (ws <= 14), ws
        for B in (1, 17, 264, 265, 1000, 5000):
            for shared in (None, True, False):
                g = wc.windowed_full_geometry(ws, B, sms, dyn, shared)
                assert (g.span, g.pairs_per_warp) == (32, 1)
                want = fits and (B <= sms * (dyn // per) if shared is None
                                 else shared)
                if want:
                    assert (g.shared_bytes, g.scratch_bytes) == (per, 0)
                else:
                    assert g.shared_bytes == ring
                    assert g.scratch_bytes == wc.scratch_pair_bytes(ws)
    assert wc.windowed_full_geometry(9, 1000, sms, dyn).scratch_bytes > 0
    assert wc.windowed_full_geometry(9, 264, sms, dyn).scratch_bytes == 0
