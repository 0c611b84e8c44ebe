"""The port's host C loader (quicked_tpu_torch/native) and the host copies
that came with its last entries (ops/traceback_np.py,
utils/{bitmap,heatmap,mm_stack}.py) against the JAX package's, on the
same seeded inputs: outputs identical. The band planes the walks read
come from the port's plain full fill, which stores zero outside the live
band as the host C fill does (the JAX package's XLA planes keep stale
words there)."""

import ast
import io
import os

import numpy as np
import pytest
import torch

from quicked_tpu import native as jax_native
from quicked_tpu.aligner import cascade as jax_cascade
from quicked_tpu.ops import traceback_np as jax_traceback_np
from quicked_tpu_torch import dna, generate, native
from quicked_tpu_torch.aligner import cascade as cs
from quicked_tpu_torch.ops import traceback_np
from quicked_tpu_torch.ops.banded_cuda import full_planes_to_host, split_u64
from quicked_tpu_torch.ops.banded_cuda import run_banded_cuda
from quicked_tpu_torch.ops.banded_native import run_banded_full_native
from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_host_c = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="no C compiler for the host C runtime")

CASCADE = dict(bandwidth=15, window_size=9, overlap_size=1,
               hew_threshold=(40, 40), hew_percentage=(15, 15),
               budget=16 << 20)


def _pairs(n, length, seed, **kw):
    return list(generate.generate_pairs(n, length, error=0.1, seed=seed,
                                        **kw))


def _public(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_torch_native_loader_has_every_public_entry():
    """Every public def and class of the JAX package's loader has a
    counterpart of the same name in the port's."""
    want = _public("quicked_tpu/native/__init__.py")
    got = _public("quicked_tpu_torch/native/__init__.py")
    assert want, "no public entry found in the JAX loader"
    assert want <= got, sorted(want - got)


@pytest.fixture(scope="module")
def full_planes():
    """A full batch of five pairs filled by the port's plain fill, its four
    u32 planes on the host (`full_planes_to_host`), and the pairs."""
    pairs = _pairs(4, 500, 41, indels_num=2, indels_length=40) + \
        [("ACGTTGCA" * 20, "ACGTGCA" * 22)]
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    batch = prepare_banded_batch(pats, txts, cos, full=True)
    out = run_banded_cuda(batch, "cpu")
    return dict(pats=pats, txts=txts, cos=cos, batch=batch,
                planes=full_planes_to_host(out),
                numpy_planes=(*split_u64(out["mat_pv"]),
                              *split_u64(out["mat_mv"])))


def test_torch_full_planes_to_host_split(full_planes):
    """The planes split on their device equal the numpy split of one
    copy, with the walk's (1, T, EBB, B) u32 layout."""
    b = full_planes["batch"]
    for got, want in zip(full_planes["planes"], full_planes["numpy_planes"]):
        assert got.dtype == np.uint32 and got.flags.c_contiguous
        assert got.shape == (1, b.NB * 64, b.EBB, b.B)
        np.testing.assert_array_equal(got[0], want)


@needs_host_c
def test_torch_traceback_banded_matches_jax(full_planes):
    """`traceback_banded` lane by lane and `traceback_banded_batch` in one
    call, against the JAX loader's on the same planes, and both against
    the host C fill and traceback."""
    b = full_planes["batch"]
    pats, txts = full_planes["pats"], full_planes["txts"]
    planes = full_planes["planes"]
    flat = [p[0] for p in planes]
    praws = [p.encode() for p in pats]
    traws = [t.encode() for t in txts]
    prologs = [int(x) for x in b.prolog[:len(pats)]]
    _, want_ops = run_banded_full_native(pats, txts, full_planes["cos"])
    for lane in range(len(pats)):
        args = (lane, praws[lane], traws[lane], prologs[lane])
        got = native.traceback_banded(*flat, *args)
        assert got == jax_native.traceback_banded(*flat, *args)
        assert got == want_ops[lane]
    # the texts as str: encoded inside with dna-text semantics
    got = native.traceback_banded_batch(planes, b.B, praws, txts, prologs)
    assert got == jax_native.traceback_banded_batch(planes, b.B, praws,
                                                     txts, prologs)
    assert got == want_ops


@needs_host_c
def test_torch_traceback_np_matches_jax(full_planes):
    """ops/traceback_np.py: the per-lane host C walk and the numpy walk,
    against the original."""
    b = full_planes["batch"]
    pats, txts = full_planes["pats"], full_planes["txts"]
    flat = [p[0] for p in full_planes["planes"]]
    praws = [p.encode() for p in pats]
    traws = [t.encode() for t in txts]
    prologs = [int(x) for x in b.prolog[:len(pats)]]
    lanes = list(range(len(pats)))
    got = traceback_np.banded_traceback_batch(*flat, lanes, praws, traws,
                                              prologs)
    assert got == jax_traceback_np.banded_traceback_batch(
        *flat, lanes, praws, traws, prologs)
    for lane in (0, len(pats) - 1):
        args = ([m[:, :, lane] for m in flat]
                + [np.frombuffer(praws[lane], np.uint8),
                   np.frombuffer(traws[lane], np.uint8), prologs[lane]])
        one = traceback_np.banded_traceback_pair(*args)
        assert one == jax_traceback_np.banded_traceback_pair(*args)
        assert one == got[lane]


@needs_host_c
@pytest.mark.parametrize("rle", [False, True])
def test_torch_quicked_batch_pipelined_chunks(rle, monkeypatch):
    """With the chunk constant shrunk, a batch runs as at least three
    pipelined chunks; status, scores and ops equal the JAX loader's
    chunked call and the port's one call at the default chunk size."""
    pairs = _pairs(10, 400, 43, indels_num=1, indels_length=60) + \
        _pairs(6, 900, 44) + [("ACGT", "ACGT")]
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    kw = dict(CASCADE, budget=30_000, rle=rle)
    runs = []
    real_run = native._quicked_batch_run

    def counted(*a, **k):
        runs.append(len(a[3]) // 2)
        return real_run(*a, **k)

    monkeypatch.setattr(native, "_quicked_batch_run", counted)
    default = native.BATCH_CHUNK_BASES
    monkeypatch.setattr(native, "BATCH_CHUNK_BASES", 1_500)
    monkeypatch.setenv("QUICKED_TPU_BATCH_CHUNK_BASES", "1500")
    st, sc, ops = native.quicked_batch(pats, txts, **kw)
    assert len(runs) >= 3 and sum(runs) == len(pairs)
    assert isinstance(ops, native.LazyOpsList)
    jst, jsc, jops = jax_native.quicked_batch(pats, txts, **kw)
    np.testing.assert_array_equal(st, jst)
    np.testing.assert_array_equal(sc, jsc)
    assert list(ops) == list(jops)
    assert (st != 0).any() and (st == 0).any()
    runs.clear()
    monkeypatch.setattr(native, "BATCH_CHUNK_BASES", default)
    ost, osc, oops = native.quicked_batch(pats, txts, **kw)
    assert runs == [len(pairs)]
    np.testing.assert_array_equal(st, ost)
    np.testing.assert_array_equal(sc, osc)
    assert ops == oops


def _segs(mod):
    raw = np.frombuffer(b"MMXMMDIMM", dtype=np.uint8)
    return [(raw, np.array([0, 2, 5, 5]), np.array([2, 3, 0, 4]),
             np.array([0, 0, 0, 1])),
            (raw, np.array([5]), np.array([4]), np.array([0]))]


def test_torch_lazy_ops_list_matches_jax():
    """LazyOpsList: length before decoding, indexing, iteration, equality
    with lists and with another LazyOpsList, and `with_empty_as_none`
    before and after decoding, as the JAX package's."""
    got = native.LazyOpsList(_segs(native))
    want = jax_native.LazyOpsList(_segs(jax_native))
    assert len(got) == len(want) == 5
    assert "materialized=False" in repr(got)
    assert list(got.with_empty_as_none()) == \
        list(want.with_empty_as_none()) == ["MM", "XMM", None, None, "DIMM"]
    assert got[1] == want[1] == "XMM"
    assert "materialized=True" in repr(got)
    assert list(got) == list(want) == ["MM", "XMM", "", None, "DIMM"]
    assert got == ["MM", "XMM", "", None, "DIMM"]
    assert got == native.LazyOpsList(_segs(native))
    assert got != ["MM"]
    assert got.with_empty_as_none() == ["MM", "XMM", None, None, "DIMM"]
    assert got[-1] == "DIMM" and got[1:3] == ["XMM", ""]


@needs_host_c
@pytest.mark.parametrize("only_score", [False, True])
def test_torch_align_one_matches_jax(only_score):
    """`align_one` for the four algorithms of qh_align (0 QUICKED, 1
    BANDED, 2 WINDOWED, 3 HIRSCHBERG) over the same pairs."""
    pairs = _pairs(3, 700, 45, indels_num=2, indels_length=50) + \
        [("ACGTACGT", "ACGTTCGT"), ("A", "ACGT")]
    for algo in range(4):
        for p, t in pairs:
            kw = dict(only_score=only_score, bandwidth=20, window_size=4)
            got = native.align_one(algo, p.encode(), t.encode(), **kw)
            assert got == jax_native.align_one(algo, p.encode(),
                                               t.encode(), **kw), algo
            assert got[0] >= 0


@needs_host_c
@pytest.mark.parametrize("n_threads", [1, 3])
def test_torch_banded_score_matches_jax(n_threads):
    """`banded_score`, score alone and with the lane's state, over whole
    texts and to a midpoint."""
    for p, t in _pairs(3, 900, 46, indels_num=1, indels_length=80):
        pe, te = dna.encode(p), dna.encode(t)
        cutoff = max(len(p), len(t)) * 15 // 100
        for finish in (len(t), len(t) // 2):
            args = (pe, te, cutoff, len(t), finish)
            assert native.banded_score(*args, n_threads=n_threads) == \
                jax_native.banded_score(*args, n_threads=n_threads)
            got = native.banded_score(*args, want_state=True,
                                      n_threads=n_threads)
            want = jax_native.banded_score(*args, want_state=True,
                                           n_threads=n_threads)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], k)


@needs_host_c
def test_torch_cigar_sam_encode_dna_seqs_as_bytes():
    for ops in ("MMMXMMDI", "IIIDDDMMMM", "M", "X" * 40 + "D" + "M" * 3):
        np.testing.assert_array_equal(native.cigar_sam(ops),
                                      jax_native.cigar_sam(ops))
    raw = bytes(range(256)) + b"ACGTNacgtn"
    np.testing.assert_array_equal(native.encode_dna(raw),
                                  jax_native.encode_dna(raw))
    np.testing.assert_array_equal(native.encode_dna(b"ACGTN"),
                                  dna.encode("ACGTN"))
    mixed = ["ACGT", b"GGA", bytearray(b"T"), np.frombuffer(b"CA", np.uint8),
             "ACé"]
    for seqs in (mixed, ["A", "CG"], [b"A", b"CG"], []):
        assert native._seqs_as_bytes(seqs) == jax_native._seqs_as_bytes(seqs)


@needs_host_c
def test_torch_read_seq_batch_matches_jax():
    """The .seq parser in batches, by offset, as the JAX loader parses."""
    pairs = _pairs(7, 150, 47)
    data = "".join(f">{p}\n<{t}\n" for p, t in pairs).encode()
    for max_pairs in (1, 3, 10):
        off, got, want = 0, [], []
        joff = 0
        while off < len(data):
            g, used = native.read_seq_batch(data, max_pairs, off)
            w, jused = jax_native.read_seq_batch(data, max_pairs, joff)
            assert (g, used) == (w, jused)
            assert used > 0
            got += g
            want += w
            off += used
            joff += jused
        assert got == want == pairs


def test_torch_heap_settings_are_module_constants(monkeypatch):
    """The heap retention sets glibc's mmap and trim thresholds when
    MALLOC_RETAIN is set and does nothing by default; the prefault touches
    MALLOC_PREFAULT_MB once per process and never when the retention is
    off (libc faked: the settings are process-wide)."""
    calls = []

    class FakeLibc:
        def mallopt(self, param, value):
            calls.append(("mallopt", param, value))

        class malloc:
            restype = None

            def __new__(cls, n):
                calls.append(("malloc", n))
                return 0            # NULL: nothing to touch or free

    monkeypatch.setattr(native.ctypes, "CDLL", lambda name: FakeLibc())
    assert native.MALLOC_RETAIN is False
    native._retain_large_allocations()
    assert calls == []
    monkeypatch.setattr(native, "MALLOC_RETAIN", True)
    native._retain_large_allocations()
    assert calls == [("mallopt", -3, 1 << 30), ("mallopt", -1, 1 << 30)]
    calls.clear()
    monkeypatch.setattr(native, "MALLOC_RETAIN", False)
    native._retain_large_allocations()
    monkeypatch.setattr(native, "_prefaulted", False)
    native._ensure_prefault()
    assert calls == []
    monkeypatch.setattr(native, "MALLOC_RETAIN", True)
    monkeypatch.setattr(native, "MALLOC_PREFAULT_MB", 3)
    monkeypatch.setattr(native, "_prefaulted", False)
    native._ensure_prefault()
    native._ensure_prefault()
    assert calls == [("malloc", 3 << 20)]


@needs_host_c
def test_torch_large_batches_prefault_the_heap(monkeypatch):
    """`quicked_batch` and `banded_score_batch` pre-fault the heap before a
    batch of more than 2**18 bases, and not before a small one."""
    calls = []
    monkeypatch.setattr(native, "_ensure_prefault", lambda: calls.append(1))
    small = ["ACGT" * 50] * 2
    native.quicked_batch(small, small, **CASCADE)
    native.banded_score_batch([dna.encode(x) for x in small],
                              [dna.encode(x) for x in small], [30, 30],
                              [200, 200])
    assert calls == []
    big = ["ACGT" * 35_000] * 2
    st, sc, _ = native.quicked_batch(big, big, **CASCADE)
    assert calls == [1] and list(sc) == [0, 0]
    native.banded_score_batch([dna.encode(x) for x in big],
                              [dna.encode(x) for x in big], [64, 64],
                              [140_000, 140_000])
    assert calls == [1, 1]


@needs_host_c
def test_torch_windowed_native_batch_matches_jax():
    """The windowed bound's host C lane, a pair a thread, against the JAX
    package's over str and pre-encoded input."""
    pairs = _pairs(5, 1_500, 48, indels_num=2, indels_length=100)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    for ws, ovl in ((2, 1), (9, 1), (16, 2)):
        got = cs._windowed_native_batch(pats, txts, 40, ws, ovl)
        want = jax_cascade._windowed_native_batch(pats, txts, 40, ws, ovl)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    enc_p = [dna.encode(p) for p in pats]
    enc_t = [dna.encode(t) for t in txts]
    got = cs._windowed_native_batch(enc_p, enc_t, 40, 9, 1)
    want = jax_cascade._windowed_native_batch(enc_p, enc_t, 40, 9, 1)
    np.testing.assert_array_equal(got[0], want[0])


def test_torch_utils_bitmap_heatmap_mm_stack_match_jax():
    """The cases of tests/test_utils.py through both packages' copies of
    utils/{bitmap,heatmap,mm_stack}."""
    from quicked_tpu.utils import bitmap as jb, heatmap as jh
    from quicked_tpu.utils import mm_stack as jm
    from quicked_tpu_torch.utils import bitmap, heatmap, mm_stack

    def heat(mod):
        out = []
        for mode in (mod.HEATMAP_MAX, mod.HEATMAP_MIN, mod.HEATMAP_VALUE):
            hm = mod.Heatmap(4, 4, 0, 100, 0, 100, mode=mode)
            for i, j, v in ((10, 10, 5), (12, 12, 9), (99, 3, 7),
                            (50, 60, 1)):
                hm.set(i, j, v)
            buf = io.StringIO()
            hm.print(buf)
            out.append((hm.values.tolist(), buf.getvalue()))
        return out

    def bits(mod):
        bm = mod.Bitmap(300)
        for pos in (0, 1, 63, 64, 130, 299):
            bm.set_bit(pos)
        bm.update_counters()
        return ([bm.is_set(i) for i in range(300)],
                [bm.erank(i) for i in range(300)])

    def stack(mod):
        st = mod.MMStack(segment_size=64)
        st.push()
        shapes = [st.allocate(16, zero=True).shape, st.allocate(40).shape,
                  st.allocate(100).shape]
        st.push()
        st.allocate(30)
        st.pop()
        shapes.append(st.allocate(30).shape)
        st.pop()
        shapes.append(st.allocate(8).shape)
        return shapes

    assert heat(heatmap) == heat(jh)
    assert heat(heatmap)[0][0][0][0] == 9 and heat(heatmap)[1][0][0][0] == 5
    assert bits(bitmap) == bits(jb)
    assert bits(bitmap)[1][64] == 3 and bits(bitmap)[1][299] == 5
    assert stack(mm_stack) == stack(jm) == [(16,), (40,), (100,), (30,),
                                            (8,)]
