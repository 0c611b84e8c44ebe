"""Parity: the port's carry-scan deep-band pass
(quicked_tpu_torch.ops.banded_cscan_cuda) vs the JAX package's XLA
carry-scan (banded_cscan_jax.run_banded_cscan) and its Pallas kernel in
interpret mode (banded_cscan_pallas.run_banded_cscan_pallas), on the
batches of tests/test_cscan.py. On the CPU the port runs the kernel's
plain version. Every output is an integer: all seven keys must be equal
(tolerance 0)."""

import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.ops.banded_cscan_jax import run_banded_cscan
from quicked_tpu.ops.banded_cscan_pallas import run_banded_cscan_pallas
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu_torch.ops import banded_cscan_cuda as cc
from quicked_tpu_torch.ops import banded_cuda as bc

torch.set_num_threads(1)

KEYS = ("scores_by_k", "pv_lo", "pv_hi", "mv_lo", "mv_hi", "first",
        "last")


def _batch(n, L, e, cutoff, seed, half=False):
    pairs = list(generate.generate_pairs(n, L, error=e, seed=seed))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    fins = [len(t) // 2 for t in txts] if half else None
    return prepare_banded_batch(pats, txts, [cutoff] * n, full=False,
                                text_finish=fins)


@pytest.mark.parametrize("n,L,e,cutoff,seed,half", [
    (2, 300, 0.15, 120, 7, False),       # one band row of blocks
    (1, 3000, 0.25, 3000, 8, False),     # EBB 48
    (1, 12000, 0.3, 10000, 9, False),    # EBB 158
    (2, 3000, 0.2, 2000, 11, True),      # Hirschberg half passes
])
def test_torch_cscan_parity(n, L, e, cutoff, seed, half):
    batch = _batch(n, L, e, cutoff, seed, half)
    got = bc.to_host_dict(cc.cscan_staged(bc.stage_banded(batch, "cpu")))
    for want in (run_banded_cscan(batch),
                 run_banded_cscan_pallas(batch, interpret=True)):
        for k in KEYS:
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_torch_cscan_refuses_cpu_and_full_batches():
    """The launch path takes CUDA score batches only and launches
    nothing otherwise."""
    st = bc.stage_banded(prepare_banded_batch(["ACGT"], ["ACGT"], [65],
                                              full=False), "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cc._launch_cscan(st)
    st_full = bc.stage_banded(prepare_banded_batch(["ACGT"], ["ACGT"],
                                                   [65], full=True), "cpu")
    with pytest.raises(ValueError, match="score-only"):
        cc.cscan_staged(st_full)
    assert cc.CSCAN.launches == 0


@pytest.mark.parametrize("ebb", [33, 48, 64, 65, 100, 128, 129, 512, 513,
                                 1000, 2048, 2049, 16384, 65536])
def test_torch_cscan_launch_geometry(ebb):
    """Every EBB the route sends the carry-scan kernel (buckets 48 to
    65,536, their pairs' bands down to 33 blocks): threads a whole number
    of warps within the launch bound, shared memory within the H100's,
    and every band block in exactly one thread's stripe of one round."""
    geo = cc.cscan_launch(ebb)
    assert geo.threads % 32 == 0 and 32 <= geo.threads <= 512
    assert geo.smem_bytes <= 232_448
    seg = geo.threads * geo.S
    blocks = sorted(r * seg + t * geo.S + s for r in range(geo.rounds)
                    for t in range(geo.threads) for s in range(geo.S))
    assert blocks == list(range(geo.rounds * seg))
    assert geo.rounds * seg >= ebb > (geo.rounds - 1) * seg
    if ebb <= 2048:
        assert geo.rounds == 1
        assert geo.threads == -(-ebb // (32 * geo.S)) * 32
        assert geo.S == (1 if ebb <= 512 else 2 if ebb <= 1024 else 4)
    else:
        assert (geo.S, geo.threads) == (4, 512)


def test_torch_cscan_launch_refuses_deeper_bands():
    with pytest.raises(ValueError, match="band blocks"):
        cc.cscan_launch(65537)
