"""The card lane's batch staging from one packed buffer (`ops/packed.py`)
against the JAX package's per-pair originals: the windowed batch
(`windowed_jax.prepare_windowed_batch`, its frames compared pair-major),
the banded batch with its planes (`batch_prep.prepare_banded_batch`), the
traceback's raw frames (`banded_traceback_jax.prep_raw_frames`), the
vectorized band geometry and bucket keys, and the batched edit score and
RLE CIGARs against `Cigar` a pair. Non-ASCII and pre-encoded batches take
the per-pair path and are held to the same originals."""

import dataclasses

import numpy as np
import pytest
import torch

from quicked_tpu import cigar as jax_cigar
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.ops import banded_traceback_jax as jax_tb
from quicked_tpu.ops import batch_prep as jax_prep
from quicked_tpu.ops import myers_np as jax_np
from quicked_tpu.ops import windowed_jax as wj
from quicked_tpu_torch import dna, native
from quicked_tpu_torch.aligner import batch as ab
from quicked_tpu_torch.aligner import cascade
from quicked_tpu_torch.aligner.hirschberg import HirschbergResult
from quicked_tpu_torch.cigar import Cigar, score_edit_packed
from quicked_tpu_torch.ops import banded_traceback_cuda as btc
from quicked_tpu_torch.ops import batch_prep, myers_np
from quicked_tpu_torch.ops import windowed_cuda as wc
from quicked_tpu_torch.ops import packed
from quicked_tpu_torch.ops.packed import PackedSeqs, pack_pairs

torch.set_num_threads(1)

EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129)
ALPHABET = list("ACGTACGTACGTNacgtR")      # raw bytes beyond the encoding


def _seq(rng, n: int) -> str:
    return "".join(rng.choice(ALPHABET, n))


def _mutate(rng, s: str) -> str:
    """s with a few substitutions, insertions and deletions."""
    out = list(s)
    for _ in range(max(1, len(s) // 20)):
        k = int(rng.integers(0, 3))
        i = int(rng.integers(0, len(out) + 1))
        if k == 0 and i < len(out):
            out[i] = str(rng.choice(ALPHABET))
        elif k == 1:
            out.insert(i, str(rng.choice(ALPHABET)))
        elif len(out) > 1 and i < len(out):
            del out[i]
    return "".join(out)


def _batch(lengths_set: str, seed: int):
    """(patterns, texts) of a seeded batch: every edge length, or mixed
    lengths 1-700."""
    rng = np.random.default_rng(seed)
    if lengths_set == "edges":
        lens = [L for L in EDGE_LENGTHS for _ in range(2)]
    else:
        lens = rng.integers(1, 700, 11).tolist()
    pats = [_seq(rng, L) for L in lens]
    txts = [_mutate(rng, p) for p in pats]
    # pattern and text lengths apart: one of each side longer
    txts[0] = txts[0] + _seq(rng, 70)
    pats[1] = pats[1] + _seq(rng, 90)
    return pats, txts


def _inputs(kind: str, pats, txts):
    """(JAX package's inputs, the port's inputs) of a batch kind: packed
    (lists of ASCII str), reversed (the JAX side reverses each str, the
    port a PackedSeqs), non-ASCII (per-pair path), pre-encoded arrays
    (per-pair path)."""
    if kind == "ascii":
        return (pats, txts), (pats, txts)
    if kind == "reversed":
        pk = pack_pairs(pats, txts)
        return ([p[::-1] for p in pats], [t[::-1] for t in txts]), \
            (pk[0].reversed(), pk[1].reversed())
    if kind == "nonascii":
        p2 = [p[:-1] + "é" for p in pats]
        t2 = [t[:1] + "Å" + t[1:] for t in txts]
        assert pack_pairs(p2, t2) is None
        return (p2, t2), (p2, t2)
    enc_p = [dna.encode(p) for p in pats]
    enc_t = [dna.encode(t) for t in txts]
    assert pack_pairs(enc_p, enc_t) is None
    return (enc_p, enc_t), (enc_p, enc_t)


KINDS = ("ascii", "reversed", "nonascii", "encoded")


@pytest.fixture(params=["mask", "rows"])
def copy_way(request, monkeypatch):
    """Both ways a PackedSeqs copies bytes: one index array or mask over
    every byte, and a slice copy a sequence (ROW_COPY_MIN_MEAN, which
    picks by the mean length, moved so that each way runs on every
    batch)."""
    monkeypatch.setattr(packed, "ROW_COPY_MIN_MEAN",
                        10 ** 9 if request.param == "mask" else 1)
    return request.param


def _pair_major(a: np.ndarray) -> np.ndarray:
    """The lanes-first layout of a lane-minor frame (its transpose)."""
    return np.moveaxis(a, -1, 0)


@pytest.mark.parametrize("pad", [None, 24])
@pytest.mark.parametrize("ws", [1, 2, 9, 17])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lengths_set", ["edges", "mixed"])
def test_torch_staging_windowed_batch(lengths_set, kind, ws, pad, copy_way):
    """prepare_windowed_batch from a packed buffer (or the per-pair path)
    equals the JAX package's, frame for frame pair-major; the frames are
    views of C-contiguous pair-major arrays, staged so, and the kernels'
    pair-major copies (`_pair_major`) share their memory but for the
    encoded text's narrowing."""
    pats, txts = _batch(lengths_set, 7 + ws)
    (jp, jt), (tp, tt) = _inputs(kind, pats, txts)
    jb = wj.prepare_windowed_batch(jp, jt, window_size=ws, pad_to_b=pad)
    tb = wc.prepare_windowed_batch(tp, tt, window_size=ws, pad_to_b=pad)
    assert (tb.B, tb.KP, tb.T, tb.P) == (jb.B, jb.KP, jb.T, jb.P)
    for f in ("peq_lo", "peq_hi", "text_enc", "text_raw", "pat_raw"):
        got, want = _pair_major(getattr(tb, f)), _pair_major(getattr(jb, f))
        assert got.flags.c_contiguous, f
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("plen", "tlen", "num_words"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                      err_msg=f)
    st = wc.stage_windowed(tb, "cpu")
    bufs = wc._pair_major(st)
    for got, field in zip(bufs, ("peq", "text_enc", "text_raw", "pat_raw")):
        assert got.is_contiguous(), field
    assert bufs[0].data_ptr() == st.peq.data_ptr()
    assert bufs[2].data_ptr() == st.text_raw.data_ptr()
    assert bufs[3].data_ptr() == st.pat_raw.data_ptr()
    np.testing.assert_array_equal(bufs[1].numpy(),
                                  _pair_major(jb.text_enc).astype(np.uint8))


@pytest.mark.parametrize("ws", [2, 9])
def test_torch_staging_windowed_score_from_packed(ws, copy_way):
    """The windowed bound of a packed batch (its plain version on the
    CPU) equals the JAX package's on the same pairs, forward and
    reversed, through `windowed_score_batch`'s buckets."""
    pats, txts = _batch("mixed", 3)
    pk = pack_pairs(pats, txts)
    for (jp, jt), (tp, tt) in (((pats, txts), pk),
                               (([p[::-1] for p in pats],
                                 [t[::-1] for t in txts]),
                                (pk[0].reversed(), pk[1].reversed()))):
        want = wj.run_windowed_score(
            wj.prepare_windowed_batch(jp, jt, window_size=ws), 40, ws, 1)
        got = cascade.windowed_score_batch(tp, tt, 40, ws, 1, device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _banded_cases():
    return [dict(full=True), dict(full=False),
            dict(full=False, text_finish="mid"),
            dict(full=True, pad_to_b=30, min_nb=12, min_ebb=9)]


@pytest.mark.parametrize("case", range(len(_banded_cases())))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lengths_set", ["edges", "mixed"])
def test_torch_staging_banded_batch(lengths_set, kind, case, copy_way):
    """prepare_banded_batch from a packed buffer (or the per-pair path)
    equals the JAX package's, planes and host sequences included; its
    text is a view of a pair-major array, which stage_banded uploads as
    the pair-major copy and transposes for the lane-minor one."""
    kw = dict(_banded_cases()[case])
    pats, txts = _batch(lengths_set, 40 + case)
    (jp, jt), (tp, tt) = _inputs(kind, pats, txts)
    rng = np.random.default_rng(case)
    cos = rng.integers(0, 400, len(pats)).tolist()
    if kw.get("text_finish") == "mid":
        kw["text_finish"] = [(len(t) + 1) // 2 for t in jt]
    want = jax_prep.prepare_banded_batch(jp, jt, cos, **kw)
    got = batch_prep.prepare_banded_batch(tp, tt, cos, **kw)
    for f in dataclasses.fields(want):
        if f.name == "plane_builder":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.text.T.flags.c_contiguous
    st = batch_prep_stage(got)
    np.testing.assert_array_equal(st.text_pm.numpy(),
                                  want.text.T.astype(np.uint8))
    np.testing.assert_array_equal(st.text.numpy(),
                                  want.text.astype(np.uint8))


def batch_prep_stage(b):
    from quicked_tpu_torch.ops.banded_cuda import stage_banded
    return stage_banded(b, "cpu")


@pytest.mark.parametrize("pad", [None, 20])
@pytest.mark.parametrize("lengths_set", ["edges", "mixed"])
def test_torch_staging_raw_frames(lengths_set, pad, copy_way):
    """prep_raw_frames from two PackedSeqs, and from byte lists, equals
    the JAX package's, as views of pair-major arrays."""
    pats, txts = _batch(lengths_set, 90)
    T = max(map(len, txts)) + 5
    PP = max(map(len, pats)) + 3
    want = jax_tb.prep_raw_frames([p.encode() for p in pats],
                                  [t.encode() for t in txts], T, PP,
                                  pad_to_b=pad)
    for raws in (pack_pairs(pats, txts),
                 ([p.encode() for p in pats], [t.encode() for t in txts])):
        got = btc.prep_raw_frames(*raws, T, PP, pad_to_b=pad)
        for g, w in zip(got, want):
            assert g.T.flags.c_contiguous
            np.testing.assert_array_equal(g, w)


def test_torch_staging_band_geometries_grid():
    """band_geometries over a grid of lengths and cutoffs equals
    band_geometry (the port's and the JAX package's) pair by pair."""
    grid = np.array(list(EDGE_LENGTHS) + [191, 192, 1000, 4097, 20_000])
    cuts = np.array([-5, 0, 1, 64, 65, 66, 100, 129, 4096, 30_000])
    pl, tl, co = (x.ravel() for x in np.meshgrid(grid, grid, cuts))
    geo = myers_np.band_geometries(pl, tl, co)
    for i in range(len(pl)):
        args = (int(pl[i]), int(tl[i]), int(co[i]))
        one = dataclasses.asdict(myers_np.band_geometry(*args))
        assert one == dataclasses.asdict(jax_np.band_geometry(*args))
        assert {k: int(getattr(geo, k)[i]) for k in one} == one, args


@pytest.mark.parametrize("full", [False, True])
def test_torch_staging_bucket_keys(full):
    """The vectorized bucket keys equal the JAX package's per-pair ones,
    and `key_groups` groups the pairs as a dict filled pair by pair."""
    rng = np.random.default_rng(11)
    pl = rng.integers(1, 30_000, 400)
    tl = np.maximum(pl + rng.integers(-3000, 3000, 400), 1)
    co = rng.integers(0, 6000, 400)
    keys = ab.bucket_keys(pl, tl, co, full=full)
    assert keys == [tuple(k) for k in jax_batch.bucket_keys(
        pl.tolist(), tl.tolist(), co.tolist(), full=full)]
    assert ab.bucket_keys(map(int, pl), map(int, tl), map(int, co),
                          full=full) == keys
    by_key: dict = {}
    for i, k in enumerate(keys):
        by_key.setdefault(k, []).append(i)
    groups = ab.key_groups(*ab._bucket_key_arrays(pl, tl, co, full))
    assert [(k, v.tolist()) for k, v in groups] == list(by_key.items())
    x = np.arange(-2, 70_000)
    assert ab.next_pow2(x).tolist() == [ab._next_pow2(v) for v in x]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_staging_packed_ops(seed, copy_way):
    """take, reversed, frame (with `upto`), concat and the list views of
    a PackedSeqs against the per-sequence str operations."""
    rng = np.random.default_rng(seed)
    seqs = [_seq(rng, int(L)) for L in rng.integers(0, 90, 25)]
    pk = PackedSeqs.of(seqs)
    assert pk.strs() == seqs and pk.raws() == [s.encode() for s in seqs]
    idx = rng.permutation(len(seqs))[:13]
    assert pk.take(idx).strs() == [seqs[i] for i in idx]
    assert pk.take(np.arange(len(seqs))) is pk
    assert pk.take(idx).reversed().strs() == [seqs[i][::-1] for i in idx]
    upto = rng.integers(0, 100, len(seqs))
    fr = pk.frame(95, 7, np.int32, rows=30, upto=upto, encoded=True)
    for i, s in enumerate(seqs):
        k = min(len(s), int(upto[i]))
        np.testing.assert_array_equal(fr[i, :k], dna.encode(s[:k]))
        assert (fr[i, k:] == 7).all()
    assert (fr[len(seqs):] == 7).all()
    for e, s in zip(pk.arrays(), seqs):
        np.testing.assert_array_equal(e, dna.encode(s))
    assert [x.tobytes() for x in pk.arrays()[3:9]] == \
        [dna.encode(s).tobytes() for s in seqs[3:9]]
    halves = PackedSeqs.concat(len(seqs), [
        (np.arange(0, len(seqs), 2), *(lambda p: (p.buf, p.off, p.len))(
            PackedSeqs.of_bytes(seqs[0::2]))),
        (np.arange(1, len(seqs), 2), *(lambda p: (p.buf, p.off, p.len))(
            PackedSeqs.of(seqs[1::2])))])
    assert halves.strs() == seqs
    assert halves.take(np.arange(len(seqs))[::-1]).buf.tobytes() == \
        "".join(seqs[::-1]).encode()
    assert PackedSeqs.of(["AC", "Gé"]) is None
    assert PackedSeqs.of([dna.encode("ACGT")]) is None


def _op_strings(rng, n: int) -> list:
    """Seeded op strings: empty, single ops, runs past 9 and 99."""
    out = ["", "M", "X", "MMMM", "D" * 12 + "M" * 150 + "I"]
    for _ in range(n):
        k = int(rng.integers(0, 40))
        ops = rng.choice(list("MMMMMXID"), k)
        out.append("".join(o * int(r) for o, r in
                           zip(ops, rng.integers(1, 120, k))))
    return out


@pytest.mark.parametrize("with_native", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_torch_staging_cigar_results(seed, with_native, monkeypatch):
    """The cascade's batched edit scores and RLE CIGARs over packed op
    bytes equal `Cigar(ops).score_edit()` / `.sprint(True)` a pair (the
    port's and the JAX package's), an empty one's CIGAR None; without
    the host C runtime the `Cigar` path runs and agrees."""
    if with_native and not native.available():
        pytest.skip("no C compiler for the host C runtime")
    if not with_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ops = _op_strings(np.random.default_rng(seed), 60)
    rng = np.random.default_rng(seed + 10)
    order = rng.permutation(len(ops))
    # a buffer whose segments lie out of order, as concat leaves them
    pk = PackedSeqs.concat(len(ops), [(order, *(lambda p: (
        p.buf, p.off, p.len))(PackedSeqs.of_bytes([ops[i] for i in order])))])
    scores, cigars = cascade.cigar_results(pk)
    assert isinstance(cigars, native.LazyOpsList) == with_native
    for i, o in enumerate(ops):
        assert scores[i] == Cigar(operations=o).score_edit() == \
            jax_cigar.Cigar(operations=o).score_edit()
        want = Cigar(operations=o).sprint(True) if o else None
        assert cigars[i] == want, i
        assert want is None or want == jax_cigar.Cigar(
            operations=o).sprint(True)


@pytest.mark.parametrize("bad", ["Q", "m", "="])
def test_torch_staging_score_edit_rejects_bad_byte(bad):
    """A byte outside MXID raises the ValueError `Cigar.score_edit`
    raises for the first pair in order holding one."""
    ops = ["MMX", "MD" + bad + "I", "Z"]
    pk = PackedSeqs.of_bytes(ops)
    with pytest.raises(ValueError) as got:
        score_edit_packed(pk.buf, pk.off, pk.len)
    with pytest.raises(ValueError) as want:
        for o in ops:
            Cigar(operations=o).score_edit()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        cascade.cigar_results(PackedSeqs.of_bytes(ops))


def test_torch_staging_lazy_ops_segments():
    """LazyOpsList.segments hands back the packed bytes undecoded (several
    segments joined), and nothing once decoded or where an element is
    None; traceback_ops' result is such a list."""
    segs = [PackedSeqs.of_bytes(["MX", "", "DDI"]),
            PackedSeqs.of_bytes(["M", "XX"])]
    lazy = native.LazyOpsList([(p.buf, p.off, p.len,
                                np.zeros(len(p), np.int64)) for p in segs])
    buf, off, ln = lazy.segments()
    assert PackedSeqs(buf, off, ln).strs() == ["MX", "", "DDI", "M", "XX"]
    assert list(lazy) == ["MX", "", "DDI", "M", "XX"]
    assert lazy.segments() is None
    failed = native.LazyOpsList([(segs[1].buf, segs[1].off, segs[1].len,
                                  np.array([0, -2]))])
    assert failed.segments() is None
    res = HirschbergResult([0, 0], PackedSeqs.of_bytes(["MX", ""]))
    assert res == [(0, "MX"), (0, "")] and len(res) == 2


def test_torch_staging_launch_wrappers_accept_staged_batches(monkeypatch):
    """Every kernel's launch wrapper takes the tensors the main path stages
    (pair-major frames with lane-minor views) and hands the kernel only
    contiguous buffers: the CPU cascade runs with each plain version first
    passing its inputs through the wrapper (the launch itself faked, the
    CUDA device test off, the contiguity test kept), over the long-read
    route shrunk to small pairs so that every wrapper runs."""
    from quicked_tpu import api as jax_api
    from quicked_tpu.params import QuickedParams as JaxParams
    from quicked_tpu_torch import _build, generate
    from quicked_tpu_torch.ops import banded_cscan_cuda as cc
    from quicked_tpu_torch.ops import banded_cuda as bc
    from quicked_tpu_torch.ops import banded_sysband_cuda as sb
    from quicked_tpu_torch.ops import hirschberg_split_cuda as hs
    from quicked_tpu_torch.params import QuickedParams

    def contiguous(*tensors):
        assert all(t.is_contiguous() for t in tensors), \
            [tuple(t.stride()) for t in tensors]

    class Props:
        multi_processor_count = 132

    launched = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, dev, *a: launched.append(self.symbol))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    monkeypatch.setattr(wc, "max_shared_bytes", lambda index: 231_168)
    for mod in (bc, btc, hs, wc):
        monkeypatch.setattr(mod, "check_cuda", contiguous)

    def through(mod, plain, launch):
        real = getattr(mod, plain)

        def run(*a):
            getattr(mod, launch)(*a)
            return real(*a)
        monkeypatch.setattr(mod, plain, run)

    for mod, plain, launch in (
            (wc, "windowed_scan_torch", "_launch_windowed"),
            (bc, "banded_scan_torch", "_launch_fill"),
            (btc, "traceback_records_torch", "_launch_traceback"),
            (sb, "banded_sysband_torch", "_launch_sysband"),
            (cc, "banded_cscan_torch", "_launch_cscan"),
            (hs, "hirschberg_split_torch", "_launch_hsplit")):
        through(mod, plain, launch)
    # the long-read route on small pairs: deep bands past a shrunk
    # PALLAS_MAX_EBB (systolic and carry-scan passes) and split levels
    # under a shrunk Hirschberg budget
    from quicked_tpu import params as jax_params
    from quicked_tpu.aligner import hirschberg as jax_hb
    from quicked_tpu_torch import params as qp
    from quicked_tpu_torch.aligner import hirschberg as hb
    for name, value in (("PALLAS_MAX_EBB", 8), ("CSCAN_MIN_EBB", 2),
                        ("SYSBAND_MIN_EBB", 8), ("SYSBAND_MAX_EBB", 8)):
        monkeypatch.setattr(ab, name, value)
    budget = 1 << 15
    for mod in (hb, jax_hb, qp, jax_params):
        monkeypatch.setattr(mod, "HIRSCHBERG_BUFFER_SIZE", budget)
    monkeypatch.setattr(jax_np, "HIRSCHBERG_BUFFER", budget)
    pairs = (list(generate.generate_pairs(2, 1500, error=0.1, seed=5,
                                          indels_num=4, indels_length=100))
             + list(generate.generate_pairs(6, 100, error=0.03, seed=6)))
    got = cascade.quicked_cascade_batch(pairs, QuickedParams(),
                                        device="cpu")
    stw = wc.stage_windowed(wc.prepare_windowed_batch(
        [p for p, _ in pairs], [t for _, t in pairs], window_size=9), "cpu")
    wc._launch_windowed_full(stw, 9, 1)
    assert set(launched) == {k.symbol for k in (
        wc.WINDOWED, wc.WINDOWED_FULL, bc.FILL, btc.TRACEBACK, cc.CSCAN,
        sb.SYSBAND, hs.HSPLIT)}, launched
    want = jax_api.align_batch(pairs, JaxParams())
    assert list(got.score) == list(want.score)
    assert list(got.cigar) == list(want.cigar)
