"""End to end: quicked_tpu_torch.api.align_batch vs quicked_tpu.api
.align_batch on the same pairs. Statuses, scores and CIGARs must be
equal for QUICKED, BANDED and HIRSCHBERG."""

import numpy as np
import pytest
import torch

from quicked_tpu import api as jax_api
from quicked_tpu import generate
from quicked_tpu.ops import myers_np
from quicked_tpu.params import QuickedAlgo, QuickedParams, QuickedStatus
from quicked_tpu.utils.profiler import PhaseTimers
from quicked_tpu_torch import api

torch.set_num_threads(1)


def _pairs(n, length, error, seed, **kw):
    return list(generate.generate_pairs(n, length, error=error, seed=seed,
                                        **kw))


def _same(pairs, params, timers=None):
    want = jax_api.align_batch(pairs, params)
    got = api.align_batch(pairs, params, device="cpu", timers=timers)
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)
    return got


def test_torch_quicked_large_indels_reach_stage3():
    """The generator's large indels push pairs past stages 1 and 2 into
    the banded score (stage 3); the port's stage timers show it."""
    pairs = _pairs(3, 800, 0.1, 1, indels_num=4, indels_length=200) + \
        _pairs(2, 300, 0.1, 2) + [("", "ACGT")]
    timers = PhaseTimers()
    _same(pairs, QuickedParams(), timers)
    assert timers.windowed_s.count.samples == 1
    assert timers.windowed_l.count.samples == 1
    assert timers.banded.count.samples == 1
    assert timers.align.count.samples == 1


@pytest.mark.parametrize("algo", [QuickedAlgo.BANDED,
                                  QuickedAlgo.HIRSCHBERG])
@pytest.mark.parametrize("only_score", [False, True])
def test_torch_banded_and_hirschberg(algo, only_score):
    pairs = _pairs(3, 200, 0.1, 11) + _pairs(2, 300, 0.15, 12,
                                             length_diff=1.2)
    _same(pairs, QuickedParams(algo=algo, only_score=only_score))


def test_torch_banded_band_past_2048_blocks():
    """A 131.5 kbp pattern against 64 bp of it: the full fill's band is
    2056 blocks deep, past what 16 warps hold in registers, so the kernel
    walks it in rounds; on the CPU its plain version runs. The CIGAR (one
    long deletion around the text) equals the JAX package's."""
    rng = np.random.default_rng(5)
    pattern = "".join(rng.choice(list("ACGT"), 131_500))
    text = pattern[1000:1064]
    prm = QuickedParams(algo=QuickedAlgo.BANDED)
    assert myers_np.band_geometry(
        len(pattern), len(text),
        len(pattern) * prm.bandwidth // 100).ebb > 2048
    pairs = [(pattern, text)]
    want = jax_api.BatchAligner(prm).align(pairs)
    got = api.BatchAligner(prm, device="cpu").align(pairs)
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score) == [131_436]
    assert list(got.cigar) == list(want.cigar)


def test_torch_quicked_only_score():
    pairs = _pairs(4, 150, 0.1, 31)
    got = _same(pairs, QuickedParams(only_score=True))
    assert all(c is None for c in got.cigar)


def test_torch_empty_sequences():
    pairs = [("", "ACGT"), ("ACGT", ""), ("ACGT", "ACGT")]
    got = _same(pairs, QuickedParams())
    assert got.status[0] == QuickedStatus.QUICKED_EMPTY_SEQUENCE
    assert got.status[2] == QuickedStatus.QUICKED_WIP
    assert got.score[2] == 0
    assert api.align_batch([("", "")], device="cpu").status[0] == \
        QuickedStatus.QUICKED_EMPTY_SEQUENCE


def test_torch_windowed_score_and_full():
    pairs = _pairs(3, 300, 0.1, 41)
    _same(pairs, QuickedParams(algo=QuickedAlgo.WINDOWED, only_score=True))
    _same(pairs, QuickedParams(algo=QuickedAlgo.WINDOWED))


def test_torch_numpy_model_path():
    """use_kernels=False takes the shared exact numpy model, as the JAX
    package does."""
    pairs = _pairs(2, 120, 0.1, 51)
    _same(pairs, QuickedParams(use_kernels=False))


def test_torch_quicked_aligner_object():
    (p, t), = _pairs(1, 200, 0.1, 61)
    al = api.QuickedAligner(device="cpu")
    ref = jax_api.QuickedAligner()
    al.setAlgorithm(QuickedAlgo.BANDED)
    ref.setAlgorithm(QuickedAlgo.BANDED)
    al.setBandwidth(20)
    ref.setBandwidth(20)
    assert al.align(p, t) == ref.align(p, t)
    assert (al.getScore(), al.getCigar()) == (ref.getScore(),
                                               ref.getCigar())
    assert api.BatchAligner(device="cpu").align([(p, t)]).cigar[0] == \
        jax_api.BatchAligner().align([(p, t)]).cigar[0]
