"""Parity: the port's banded fill (quicked_tpu_torch.ops.banded_cuda) vs
the JAX package's XLA scan (banded_jax.run_banded) and its Pallas kernel
in interpret mode (banded_pallas.run_banded_pallas).

On the CPU the port runs the kernel's plain PyTorch version; the CUDA
kernel is held to the same version on the card (chip_smoke.py and
test_torch_imports.py's CUDA-marked test). Every output is an integer,
so the tolerance is 0: the dicts must be equal field by field.
"""

import numpy as np
import pytest
import torch

from quicked_tpu import dna, generate
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.banded_jax import run_banded
from quicked_tpu.ops.banded_pallas import _untile_lanes, run_banded_pallas
from quicked_tpu.ops.batch_prep import extract_final_scores, prepare_banded_batch
from quicked_tpu_torch.ops import banded_cuda as bc

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)

_FIELDS = ("scores_by_k", "pv_lo", "pv_hi", "mv_lo", "mv_hi", "first",
           "last")


def _pairs(n, length, error, seed, length_diff=1.0, **kw):
    return list(generate.generate_pairs(n, length, error=error, seed=seed,
                                        length_diff=length_diff, **kw))


def _port(batch):
    return bc.to_host_dict(bc.run_banded_cuda(batch, device="cpu"))


def _assert_same(want, got, names):
    for k in names:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize("length,error,seed,ldiff,bw", [
    (200, 0.1, 1, 1.0, 40),
    (300, 0.15, 3, 1.2, 40),
    (129, 0.1, 4, 0.8, 40),
    (500, 0.1, 5, 1.0, 15),
])
def test_torch_banded_score_parity(length, error, seed, ldiff, bw):
    pairs = _pairs(6, length, error, seed, ldiff)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * bw // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False,
                                 pad_to_b=8)
    got = _port(batch)
    _assert_same(run_banded(batch), got, _FIELDS)
    _assert_same(run_banded_pallas(batch, interpret=True), got, _FIELDS)
    scores = extract_final_scores(batch, got["scores_by_k"])
    for i, (p, t) in enumerate(pairs):
        model = myers_np.banded_score(myers_np.compile_pattern(p),
                                      dna.encode(t), cutoffs[i])
        assert scores[i] == model.score, i


def _model_planes(batch, pairs, cutoffs):
    """(pv, mv, live): the band columns of the JAX package's numpy model of
    the C full fill (myers_np.banded_fill) in the port's (T, EBB, B) u64
    layout, zero outside each column's live band as the C fill leaves
    them; `live` marks the model's nonzero words."""
    T = batch.NB * 64
    pv = np.zeros((T, batch.EBB, batch.B), dtype=np.uint64)
    mv = np.zeros_like(pv)
    for b, (p, t) in enumerate(pairs):
        fill = myers_np.banded_fill(myers_np.compile_pattern(p),
                                    dna.encode(t), cutoffs[b])
        pv[:len(t), :fill.ebb, b] = np.array(fill.PvM[1:], dtype=np.uint64)
        mv[:len(t), :fill.ebb, b] = np.array(fill.MvM[1:], dtype=np.uint64)
    return pv, mv, (pv != 0) | (mv != 0)


def test_torch_banded_full_parity():
    """Full variant: every stored band column equals the C fill's (the
    numpy model's: zero outside the live band, where the traceback can
    read when its path leaves the band), and the XLA scan's and the
    Pallas kernel's snapshots in the live band."""
    pairs = _pairs(5, 200, 0.12, 7) + _pairs(2, 300, 0.2, 8, 1.15)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=True)
    got = _port(batch)
    mats = ("mat_pv_lo", "mat_pv_hi", "mat_mv_lo", "mat_mv_hi")
    xla = run_banded(batch)
    _assert_same(xla, got, _FIELDS)
    pal = run_banded_pallas(batch, interpret=True)
    _assert_same(pal, got, _FIELDS)
    tiles = {name: _untile_lanes(tiled)[:, :batch.EBB, :batch.B]
             for name, tiled in zip(mats, pal["mats_tiled"])}
    model_pv, model_mv, live = _model_planes(batch, pairs, cutoffs)
    tlen = np.array([len(t) for t in txts])
    cols = np.arange(batch.NB * 64)[:, None, None] < tlen[None, None, :]
    assert live.any() and (~live & cols).any()
    for name in mats:
        word = got[name].astype(np.uint64)
        model = model_pv if "pv" in name else model_mv
        half = (model & np.uint64(0xFFFFFFFF)) if name.endswith("lo") \
            else (model >> np.uint64(32))
        np.testing.assert_array_equal(np.where(cols, word, 0),
                                      np.where(cols, half, 0),
                                      err_msg=name)
        for ref in (xla[name], tiles[name]):
            np.testing.assert_array_equal(np.where(live, word, 0),
                                          np.where(live, ref, 0),
                                          err_msg=name)


def test_torch_banded_text_finish():
    """Hirschberg midpoints: only `finish` columns run while the band is
    sized for the whole text; the tfinish column mask applies per column."""
    pairs = _pairs(3, 600, 0.1, 8) + _pairs(2, 300, 0.1, 9,
                                            indels_num=2, indels_length=40)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [90] * len(pairs)
    finishes = [len(t) // 2 + 7 * i for i, t in enumerate(txts)]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False,
                                 text_finish=finishes, pad_to_b=8)
    got = _port(batch)
    _assert_same(run_banded(batch), got, _FIELDS)
    _assert_same(run_banded_pallas(batch, interpret=True), got, _FIELDS)


def test_torch_banded_mixed_length_bucket():
    """Very different lengths in one batch, with pad lanes: the pad lanes'
    empty band range must not perturb live lanes."""
    pairs = (_pairs(2, 80, 0.1, 15) + _pairs(2, 500, 0.1, 16)
             + _pairs(1, 257, 0.2, 17))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cutoffs, full=False,
                                 pad_to_b=8, min_ebb=8)
    got = _port(batch)
    _assert_same(run_banded(batch), got, _FIELDS)
    _assert_same(run_banded_pallas(batch, interpret=True), got, _FIELDS)


def test_torch_stage_banded_fuses_words():
    """Staging fuses the u32 lo/hi planes into u64 words, and to_host_dict
    splits them back exactly."""
    pairs = _pairs(3, 150, 0.1, 3)
    batch = prepare_banded_batch([p for p, _ in pairs],
                                 [t for _, t in pairs], [60] * 3,
                                 full=False)
    st = bc.stage_banded(batch, "cpu")
    assert st.peq.dtype == torch.int64 and st.peq.shape == (batch.K, 5, 3)
    lo, hi = bc.split_u64(st.peq)
    np.testing.assert_array_equal(lo, batch.peq_lo)
    np.testing.assert_array_equal(hi, batch.peq_hi)
    assert st.text.dtype == torch.uint8


def test_torch_banded_traceback_leaves_the_band():
    """A BANDED pair whose traceback path steps below the live band (two
    250 bp indels at 15% bandwidth): the port's CIGAR is the C walk's,
    which reads zero there, as the JAX package's host lane and its numpy
    model give it (its XLA scan's stale words gave 582 for 577)."""
    from quicked_tpu.api import align_batch as jax_align_batch
    from quicked_tpu.params import QuickedAlgo as JaxAlgo
    from quicked_tpu.params import QuickedParams as JaxParams
    from quicked_tpu_torch.api import align_batch
    from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

    pair = _pairs(8, 2000, 0.1, 2002, indels_num=4, indels_length=250)[5]
    got = align_batch([pair], QuickedParams(algo=QuickedAlgo.BANDED,
                                            only_score=False), device="cpu")
    for use_kernels in (True, False):
        want = jax_align_batch([pair], JaxParams(
            algo=JaxAlgo.BANDED, only_score=False, use_kernels=use_kernels))
        assert (int(got.score[0]), got.cigar[0]) == \
            (int(want.score[0]), want.cigar[0])
    assert int(got.score[0]) == 577
