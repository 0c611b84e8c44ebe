"""Parity: the port's banded traceback
(quicked_tpu_torch.ops.banded_traceback_cuda) vs the JAX package's XLA
column walk (banded_traceback_jax.traceback_records) and the spec walk
(traceback_np.banded_traceback_pair). Records and op strings must be
equal (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quicked_tpu import generate
from quicked_tpu.ops.banded_traceback_jax import (prep_raw_frames,
                                                  traceback_records)
from quicked_tpu.ops import myers_np
from quicked_tpu.ops.batch_prep import prepare_banded_batch
from quicked_tpu.ops.traceback_np import banded_traceback_pair
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import banded_traceback_cuda as btc

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)


def _check(pairs, cutoffs):
    """Both walks read the same planes, the port's fill's (held to the
    JAX package's fill by test_torch_banded.py), the JAX walks in their
    u32 halves; the op strings also equal the numpy model's C walk."""
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    b = prepare_banded_batch(pats, txts, cutoffs, full=True, pad_to_b=8)
    out = bc.run_banded_cuda(b, device="cpu")
    ref = {}
    for k in ("mat_pv", "mat_mv"):
        ref[k + "_lo"], ref[k + "_hi"] = bc.split_u64(out[k])
    T = ref["mat_pv_lo"].shape[0]
    PP = 32 * ((max(len(p) for p in pats) + 31) // 32)
    praw, traw = prep_raw_frames([p.encode() for p in pats],
                                 [t.encode() for t in txts], T, PP,
                                 pad_to_b=b.B)
    want = traceback_records(
        *[jnp.asarray(ref[k]) for k in ("mat_pv_lo", "mat_pv_hi",
                                        "mat_mv_lo", "mat_mv_hi")],
        jnp.asarray(praw), jnp.asarray(traw), jnp.asarray(b.plen),
        jnp.asarray(b.tlen), jnp.asarray(b.prolog), EBB=b.EBB, PP=PP)

    got = btc.traceback_records(
        out["mat_pv"], out["mat_mv"], torch.from_numpy(praw),
        torch.from_numpy(traw), torch.from_numpy(b.plen),
        torch.from_numpy(b.tlen), torch.from_numpy(b.prolog))
    for w, g, name in zip(want, got, ("runs", "opcs", "v_fin", "h_fin")):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)

    ops = btc.traceback_ops(out["mat_pv"], out["mat_mv"],
                            [p.encode() for p in pats],
                            [t.encode() for t in txts], b.plen, b.tlen,
                            b.prolog, len(pairs))
    spec = [banded_traceback_pair(
        ref["mat_pv_lo"][:, :, i], ref["mat_pv_hi"][:, :, i],
        ref["mat_mv_lo"][:, :, i], ref["mat_mv_hi"][:, :, i],
        np.frombuffer(pats[i].encode(), dtype=np.uint8),
        np.frombuffer(txts[i].encode(), dtype=np.uint8),
        int(b.prolog[i])) for i in range(len(pairs))]
    assert ops == spec
    assert ops == [myers_np.banded_align(p, t, c)[1]
                   for (p, t), c in zip(pairs, cutoffs)]


@pytest.mark.parametrize("length,error,seed,ldiff", [
    (100, 0.02, 1, 1.0),
    (100, 0.2, 2, 1.0),
    (200, 0.1, 3, 0.85),
    (200, 0.1, 4, 1.2),
    (500, 0.05, 5, 1.0),
    (64, 0.4, 6, 1.0),
])
def test_torch_traceback_parity(length, error, seed, ldiff):
    pairs = list(generate.generate_pairs(6, length, error=error, seed=seed,
                                         length_diff=ldiff))
    cutoffs = [max(max(len(p), len(t)) * 25 // 100,
                   abs(len(p) - len(t)) + 1) for p, t in pairs]
    _check(pairs, cutoffs)


def test_torch_traceback_indel_heavy():
    """Long D/I runs (run clamping, band-frame crossings) and N chars
    (the M test compares raw characters)."""
    rng = np.random.default_rng(17)
    pairs = []
    for _ in range(2):
        pl = int(rng.integers(120, 300))
        dl = int(rng.integers(20, 60))
        p = "".join(rng.choice(list("ACGT"), pl))
        cut = int(rng.integers(0, pl - dl))
        pairs.append((p, p[:cut] + p[cut + dl:]))       # big deletion
        pairs.append((p[:cut] + p[cut + dl:], p))       # big insertion
    p = "".join(rng.choice(list("ACGTN"), 150))
    pairs.append((p, p.replace("A", "N")))              # N raw-compare
    cutoffs = [max(max(len(p), len(t)) * 40 // 100,
                   abs(len(p) - len(t)) + 1) for p, t in pairs]
    _check(pairs, cutoffs)


def test_torch_records_expand_like_jax():
    """The copied numpy expansion equals the JAX package's."""
    from quicked_tpu.ops.banded_traceback_jax import records_to_packed

    rng = np.random.default_rng(3)
    n, T = 33, 40
    runs = rng.integers(0, 5, (n, T)).astype(np.int32)
    opcs = rng.choice(np.array([0, 1, 3, 4], np.int8), (n, T))
    v_f = rng.integers(-1, 40, n).astype(np.int32)
    h_f = rng.integers(-1, 40, n).astype(np.int32)
    for w, g in zip(records_to_packed(runs, opcs, v_f, h_f),
                    btc.records_to_packed(runs, opcs, v_f, h_f)):
        np.testing.assert_array_equal(w, g)


def test_torch_hsb64_matches_numpy():
    """The plain version's 64-bit bit search (logical shifts on int64)."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 63, 200, dtype=np.uint64) << \
        rng.integers(0, 2, 200, dtype=np.uint64)
    words[:4] = [1, 2 ** 63, 2 ** 64 - 1, 2 ** 32]
    t = torch.from_numpy(words.view(np.int64))
    got = btc.hsb64(t).numpy()
    want = np.array([int(w).bit_length() - 1 for w in words])
    np.testing.assert_array_equal(got, want)
