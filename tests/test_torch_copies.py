"""The port's copies of the JAX package's host-only code against their
originals: the same seeded inputs through both, outputs identical."""

import dataclasses

import numpy as np
import pytest

from quicked_tpu import api as jax_api
from quicked_tpu import cigar as jax_cigar
from quicked_tpu import generate as jax_generate
from quicked_tpu import native as jax_native
from quicked_tpu.ops import batch_prep as jax_prep
from quicked_tpu.ops import myers_np as jax_np
from quicked_tpu.params import QuickedAlgo as JaxAlgo
from quicked_tpu.params import QuickedParams as JaxParams
from quicked_tpu_torch import api, cigar, dna, generate, native
from quicked_tpu_torch.aligner import batch
from quicked_tpu_torch.ops import batch_prep, myers_np
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams


def _pairs(n=6, length=400, seed=5):
    return list(generate.generate_pairs(n, length, error=0.1, seed=seed,
                                        indels_num=2, indels_length=40))


def check_generate():
    for kw in (dict(num=5, length=300, error=0.08, seed=1),
               dict(num=4, length=500, error=0.1, indels_num=3,
                    indels_length=60, seed=2),
               dict(num=3, length=200, error=0.05, length_diff=1.07,
                    seed=3),
               dict(num=3, length=200, error=2.0, length_diff=0.9, seed=4)):
        assert list(generate.generate_pairs(**kw)) == \
            list(jax_generate.generate_pairs(**kw)), kw


def check_prepare_banded_batch():
    pairs = _pairs()
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [80, 150, 300, 65, 1000, 120]
    mids = [(len(t) + 1) // 2 for t in txts]
    for kw in (dict(full=False), dict(full=True),
               dict(full=False, text_finish=mids),
               dict(full=False, pad_to_b=8, min_nb=9, min_ebb=12)):
        got = batch_prep.prepare_banded_batch(pats, txts, cos, **kw)
        want = jax_prep.prepare_banded_batch(pats, txts, cos, **kw)
        for f in dataclasses.fields(want):
            if f.name == "plane_builder":
                continue
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, list):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        sck = np.random.default_rng(0).integers(
            0, 5000, (want.K + 1, want.B)).astype(np.int32)
        np.testing.assert_array_equal(
            batch_prep.extract_final_scores(got, sck),
            jax_prep.extract_final_scores(want, sck))


def check_band_geometry():
    rng = np.random.default_rng(1)
    for _ in range(200):
        pl, tl, co = (int(x) for x in rng.integers(1, 20_000, 3))
        assert dataclasses.asdict(myers_np.band_geometry(pl, tl, co)) == \
            dataclasses.asdict(jax_np.band_geometry(pl, tl, co))
        assert myers_np.div_ceil(pl, 64) == jax_np.div_ceil(pl, 64)


def check_hirschberg_split_fast():
    pairs = _pairs(6, 900, seed=7)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 25 // 100 for p, t in pairs]
    mids = [(len(t) + 1) // 2 for t in txts]
    both = batch.banded_score_results(
        pats + [p[::-1] for p in pats], txts + [t[::-1] for t in txts],
        cos + cos, text_finish=mids + [len(t) - m for t, m in
                                       zip(txts, mids)], device="cpu")
    n = 0
    for i in range(len(pairs)):
        f, r = both[i], both[len(pairs) + i]
        args = (f.pv64, f.mv64, f.first, f.last, f.scores_k, r.pv64,
                r.mv64, r.first, r.last, r.scores_k, f.prolog, len(pats[i]),
                len(txts[i]))
        got = myers_np.hirschberg_split_fast(*args)
        assert got == jax_np.hirschberg_split_fast(*args)
        n += got is not None
    assert n > 0


def check_cigar():
    rng = np.random.default_rng(2)
    for _ in range(50):
        ops = "".join(rng.choice(list("MMMMXID"), int(rng.integers(0, 300))))
        a, b = cigar.Cigar(operations=ops), jax_cigar.Cigar(operations=ops)
        assert a.score_edit() == b.score_edit()
        for pm in (True, False):
            assert a.sprint(pm) == b.sprint(pm)
        assert a.sprint_sam(True) == b.sprint_sam(True)
    p, t = _pairs(1)[0]
    _, ops = myers_np.banded_align(p, t, 200)
    assert cigar.Cigar(operations=ops).check_alignment(p, t) == \
        jax_cigar.Cigar(operations=ops).check_alignment(p, t)


def check_align_one_np():
    pairs = _pairs(3, 300, seed=9) + [("ACGT", ""), ("ACGTTA", "ACTTA")]
    for algo, jalgo in zip(QuickedAlgo, JaxAlgo):
        for only_score in (False, True):
            params = QuickedParams(algo=algo, only_score=only_score,
                                   bandwidth=20, window_size=4)
            jparams = JaxParams(algo=jalgo, only_score=only_score,
                                bandwidth=20, window_size=4)
            for p, t in pairs:
                got = api._align_one_np(p, t, params)
                want = jax_api._align_one_np(p, t, jparams)
                assert tuple(int(x) if i < 2 and x is not None else x
                             for i, x in enumerate(got)) == \
                    tuple(int(x) if i < 2 and x is not None else x
                          for i, x in enumerate(want)), (algo, only_score)


def check_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    pairs = _pairs(8, 1500, seed=11)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    kw = dict(bandwidth=15, window_size=9, overlap_size=1,
              hew_threshold=(40, 40), hew_percentage=(15, 15),
              budget=100_000)
    for rle in (False, True):
        st, sc, ops = native.quicked_batch(pats, txts, rle=rle, **kw)
        jst, jsc, jops = jax_native.quicked_batch(pats, txts, rle=rle, **kw)
        np.testing.assert_array_equal(st, jst)
        np.testing.assert_array_equal(sc, jsc)
        assert list(ops) == list(jops)
        assert (st != 0).any() and (st == 0).any()
    for (p, t), s in zip(pairs, sc):
        args = (dna.encode(p), p.encode(), dna.encode(t), t.encode(),
                int(s), 100_000)
        assert native.hirschberg(*args) == jax_native.hirschberg(*args)
    rng = np.random.default_rng(3)
    runs = rng.integers(0, 4, (5, 40)).astype(np.uint16)
    opcs = rng.integers(0, 5, (5, 40)).astype(np.int8)
    v, h = rng.integers(-1, 30, 5), rng.integers(-1, 30, 5)
    for a, b in zip(native.expand_colruns(runs, opcs, v, h),
                    jax_native.expand_colruns(runs, opcs, v, h)):
        np.testing.assert_array_equal(a, b)
    b = batch_prep.prepare_banded_batch(pats, txts, [300] * len(pats),
                                        full=False)
    got = native.run_banded_native(b)
    from quicked_tpu.ops.banded_native import run_banded_native
    want = run_banded_native(jax_prep.prepare_banded_batch(
        pats, txts, [300] * len(pats), full=False))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CASES = {f.__name__[len("check_"):]: f for f in (
    check_generate, check_prepare_banded_batch, check_band_geometry,
    check_hirschberg_split_fast, check_cigar, check_align_one_np,
    check_native)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_copy_matches_original(name):
    CASES[name]()
