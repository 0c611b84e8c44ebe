"""Parity: the port's windowed score bound
(quicked_tpu_torch.ops.windowed_cuda) vs the JAX package's XLA
while-loop (windowed_jax.run_windowed_score) and the numpy model
(myers_np.windowed_compute): scores and high-error-window counts must be
equal (tolerance 0)."""

import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.ops import myers_np
from quicked_tpu.ops import windowed_jax as wj
from quicked_tpu_torch.ops import windowed_cuda as wc

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
    anything. A wide window (ws > 16, held in a scratch buffer on the
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
