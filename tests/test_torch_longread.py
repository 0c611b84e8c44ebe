"""The long-read path of the port: the score-kernel route
(`batch.score_family`) against the JAX package's device route
(quicked_tpu/aligner/batch.py:540-572), and the QUICKED cascade end to
end on the CPU with the route's bounds and the Hirschberg budget shrunk,
so that small pairs take every deep-band family: the carry-scan pass in
stage 3, the systolic pass in a Hirschberg split level, and a split level
on the fill, each level finished by the split epilogue. Results must equal the JAX package's and
the numpy model's exactly."""

import pytest
import torch

from quicked_tpu import api as jax_api
from quicked_tpu import generate, params
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.aligner import hirschberg as jax_hb
from quicked_tpu.cigar import Cigar
from quicked_tpu.ops import myers_np
from quicked_tpu.params import QuickedParams
from quicked_tpu_torch import api
from quicked_tpu_torch.aligner import batch, cascade
from quicked_tpu_torch.aligner import hirschberg as hb

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)

ROUTE_CONSTANTS = ("PALLAS_MAX_EBB", "CSCAN_MIN_EBB", "CSCAN_MAX_B",
                   "SYSBAND_MIN_EBB", "SYSBAND_MAX_EBB")

# (pairs in the bucket, the bucket's band blocks) -> family, read off
# batch.py:540-572: deep = EBB > 128 or (padded lanes <= 32 and
# EBB >= 48); deep batches with 192 <= EBB <= 16000 go to the systolic
# kernel, the other deep ones to the carry-scan kernel. Shallow buckets
# pad to at least 8 lanes, deep ones to the pow2 of their pairs.
ROUTE_TABLE = [
    (1000, 64, "fill"),
    (100, 128, "fill"),
    (33, 48, "fill"),        # 64 padded lanes
    (8, 47, "fill"),
    (8, 32, "fill"),
    (1, 16, "fill"),
    (32, 48, "cscan"),
    (8, 48, "cscan"),
    (8, 64, "cscan"),
    (1, 128, "cscan"),       # padded to the 8-lane floor, still <= 32
    (16, 128, "cscan"),
    (64, 191, "cscan"),      # deep by depth, below the systolic range
    (64, 192, "sysband"),
    (200, 256, "sysband"),
    (1, 256, "sysband"),
    (5000, 4096, "sysband"),
    (64, 16000, "sysband"),
    (64, 16001, "cscan"),
    (3, 16384, "cscan"),
]


def test_torch_route_constants_match_jax():
    for name in ROUTE_CONSTANTS:
        assert getattr(batch, name) == getattr(jax_batch, name), name
    for n, ebb in ((1, 8), (5, 64), (9, 64), (3, 256), (33, 512)):
        assert batch._lane_pad(n, ebb) == jax_batch._lane_pad(n, ebb, 8)


@pytest.mark.parametrize("n_live,ebb_p2,family", ROUTE_TABLE)
def test_torch_score_family_route(n_live, ebb_p2, family):
    assert batch.score_family(n_live, ebb_p2) == family


def test_torch_longread_slice_takes_every_family(monkeypatch):
    """Two 3 kbp pairs with four 100 bp indels, the route's bounds shrunk
    (fill up to 8 blocks, carry-scan from 2, systolic for exactly 8) and
    a 64 KB Hirschberg budget: stage 3 runs the carry-scan pass, a split
    level the systolic pass, a later level the fill, each level then the
    split epilogue. Statuses, scores and
    CIGARs equal quicked_tpu.api's and the numpy model's."""
    for name, value in (("PALLAS_MAX_EBB", 8), ("CSCAN_MIN_EBB", 2),
                        ("SYSBAND_MIN_EBB", 8), ("SYSBAND_MAX_EBB", 8)):
        monkeypatch.setattr(batch, name, value)
    budget = 1 << 16
    monkeypatch.setattr(hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(jax_hb, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(params, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(myers_np, "HIRSCHBERG_BUFFER", budget)

    taken = []          # (caller, family) of every score pass
    caller = ["?"]
    real_score = batch.score_staged
    real_stage3 = cascade.banded_align_batch
    real_level = batch._hsplit_fused

    def score_staged(st, family):
        taken.append((caller[0], family))
        return real_score(st, family)

    def stage3(*a, **kw):
        caller[0] = "stage3"
        return real_stage3(*a, **kw)

    def level(batch_, dev, family):
        caller[0] = "level"
        return real_level(batch_, dev, family)

    monkeypatch.setattr(batch, "score_staged", score_staged)
    monkeypatch.setattr(cascade, "banded_align_batch", stage3)
    monkeypatch.setattr(batch, "_hsplit_fused", level)

    pairs = list(generate.generate_pairs(2, 3000, error=0.1, seed=1,
                                         indels_num=4, indels_length=100))
    got = api.BatchAligner(QuickedParams(), device="cpu").align(pairs)
    assert ("stage3", "cscan") in taken, taken
    assert ("level", "sysband") in taken, taken
    assert ("level", "fill") in taken, taken

    want = jax_api.align_batch(pairs, QuickedParams())
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)
    for i, (p, t) in enumerate(pairs):
        _, ops = myers_np.quicked_align(p, t)
        c = Cigar(operations=ops or "")
        assert (got.score[i], got.cigar[i]) == (c.score_edit(),
                                                c.sprint(True)), i


@pytest.mark.parametrize("family", ["cscan", "sysband"])
def test_torch_banded_score_takes_deep_family(monkeypatch, family):
    """BANDED score-only through BatchAligner on the CPU, the route's
    bounds shrunk so that the pairs' bucket (4 band blocks) goes to the
    carry-scan or the systolic kernel's plain version; scores equal
    quicked_tpu.api's."""
    consts = dict(PALLAS_MAX_EBB=2, CSCAN_MIN_EBB=2, SYSBAND_MIN_EBB=1000,
                  SYSBAND_MAX_EBB=1000)
    if family == "sysband":
        consts.update(SYSBAND_MIN_EBB=4, SYSBAND_MAX_EBB=4)
    for name, value in consts.items():
        monkeypatch.setattr(batch, name, value)
    taken = []
    real_score = batch.score_staged

    def score_staged(st, fam):
        taken.append((fam, st.EBB))
        return real_score(st, fam)

    monkeypatch.setattr(batch, "score_staged", score_staged)
    pairs = list(generate.generate_pairs(3, 1000, error=0.1, seed=4,
                                         indels_num=2, indels_length=40))
    prm = QuickedParams(algo=params.QuickedAlgo.BANDED, only_score=True,
                        bandwidth=15)
    got = api.BatchAligner(prm, device="cpu").align(pairs)
    assert {f for f, _ in taken} == {family}, taken
    want = jax_api.align_batch(pairs, prm)
    assert [int(s) for s in got.status] == [int(s) for s in want.status]
    assert list(got.score) == list(want.score)
