"""The port's copies of the JAX package's host-only code against their
originals: the same seeded inputs through both, outputs identical."""

import dataclasses
import io
import os
import tempfile

import numpy as np
import pytest

from quicked_tpu import api as jax_api
from quicked_tpu import cigar as jax_cigar
from quicked_tpu import generate as jax_generate
from quicked_tpu import native as jax_native
from quicked_tpu.aligner import batch as jax_batch
from quicked_tpu.ops import batch_prep as jax_prep
from quicked_tpu.ops import myers_np as jax_np
from quicked_tpu.params import QuickedAlgo as JaxAlgo
from quicked_tpu.params import QuickedParams as JaxParams
from quicked_tpu_torch import api, cigar, dna, generate, native
from quicked_tpu_torch.ops import batch_prep, myers_np
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams


@pytest.fixture(scope="module", autouse=True)
def jax_warmup_inline():
    """Run the JAX package's cold bucket shapes inline for this module,
    not on its warmup thread, and leave that thread idle at the end, so
    that no compile queued here is still running when another module's
    test waits on the thread. Deferral only changes where a batch runs,
    never its result. The port's test modules that call the JAX package
    import this fixture."""
    from quicked_tpu.utils import warmup

    old = os.environ.get("QUICKED_TPU_ASYNC_WARMUP")
    os.environ["QUICKED_TPU_ASYNC_WARMUP"] = "0"
    yield
    if old is None:
        del os.environ["QUICKED_TPU_ASYNC_WARMUP"]
    else:
        os.environ["QUICKED_TPU_ASYNC_WARMUP"] = old
    warmup.wait_idle()


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
    both = jax_batch.banded_score_results(
        pats + [p[::-1] for p in pats], txts + [t[::-1] for t in txts],
        cos + cos, text_finish=mids + [len(t) - m for t, m in
                                       zip(txts, mids)])
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
    from quicked_tpu.ops.banded_native import run_banded_native
    from quicked_tpu_torch.ops import banded_native
    got = banded_native.run_banded_native(b)
    want = run_banded_native(jax_prep.prepare_banded_batch(
        pats, txts, [300] * len(pats), full=False))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def check_native_windowed():
    """The host C windowed bound through the port's loader and the JAX
    package's: ws 2 and 9 over pairs with large indels (HEWs > 0)."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    pairs = list(generate.generate_pairs(6, 1500, error=0.15, seed=13,
                                         indels_num=2, indels_length=150))
    hews = 0
    for ws in (2, 9):
        for p, t in pairs:
            args = (dna.encode(p), p.encode(), dna.encode(t), t.encode(),
                    ws, 1, 40)
            got = native.windowed_score(*args)
            assert got == jax_native.windowed_score(*args), (ws, p[:20])
            hews += got[1]
    assert hews > 0


def check_native_windowed_full():
    """The host C windowed full-CIGAR mode through the port's loader and
    the JAX package's: ws 1 (ovl 0), 2 and 9 over pairs with large indels
    and N characters."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    pairs = list(generate.generate_pairs(5, 1200, error=0.15, seed=14,
                                         indels_num=2, indels_length=150))
    pairs.append(("ACGTNNACGT" * 30, "ACGTACGTNN" * 28))
    for ws, ovl in ((1, 0), (2, 1), (9, 1)):
        for p, t in pairs:
            args = (dna.encode(p), p.encode(), dna.encode(t), t.encode(),
                    ws, ovl)
            got = native.windowed_full(*args)
            assert got == jax_native.windowed_full(*args), (ws, p[:20])
            assert got.count("M") + got.count("X") + got.count("I") == \
                len(t)


def check_expand_window_records():
    """The port's copy of expand_window_records against the original on
    random records: zero and non-zero opcodes and runs, negative and
    positive final cursors."""
    from quicked_tpu.ops import windowed_jax
    from quicked_tpu_torch.ops import windowed_cuda

    rng = np.random.default_rng(15)
    for MW, COLS, B in ((3, 64, 5), (7, 128, 2), (1, 64, 1)):
        runs = rng.integers(0, 4, (MW, COLS, B)).astype(np.int16)
        opcs = rng.choice(np.array([0, 1, 3, 4], np.int8), (MW, COLS, B))
        pos_v = rng.integers(-1, 30, B).astype(np.int32)
        pos_h = rng.integers(-1, 30, B).astype(np.int32)
        for n in (None, B - 1):
            assert windowed_cuda.expand_window_records(
                runs, opcs, pos_v, pos_h, n=n) == \
                windowed_jax.expand_window_records(runs, opcs, pos_v, pos_h,
                                                   n=n)


def check_seqio():
    """read_seq_pairs, write_seq_pairs, read_seq_batches over byte ranges
    from pair_start_at, and record_marker, on a LF file, a CRLF file and a
    flipped ('<' first) file; the line formatters."""
    from quicked_tpu import seqio as jax_seqio
    from quicked_tpu_torch import seqio

    pairs = _pairs(7, 120, seed=21) + [("", "ACGT"), ("NNAC", "")]
    with tempfile.TemporaryDirectory() as td:
        seqio_cases(seqio, jax_seqio, pairs, td)
    for args in ((3, "2M1X"), (4, None)):
        assert seqio.format_output_lite(*args) == \
            jax_seqio.format_output_lite(*args)
    for only_score in (False, True):
        assert seqio.format_output_error(only_score) == \
            jax_seqio.format_output_error(only_score)
    assert seqio.format_output_full("AC", "AG", 1, "1M1X") == \
        jax_seqio.format_output_full("AC", "AG", 1, "1M1X")


def seqio_cases(seqio, jax_seqio, pairs, td):
    lf = os.path.join(td, "lf.seq")
    seqio.write_seq_pairs(lf, pairs)
    want = os.path.join(td, "want.seq")
    jax_seqio.write_seq_pairs(want, pairs)
    with open(lf, "rb") as f, open(want, "rb") as g:
        data = f.read()
        assert data == g.read()
    crlf = os.path.join(td, "crlf.seq")
    with open(crlf, "wb") as f:
        f.write(data.replace(b"\n", b"\r\n"))
    flip = os.path.join(td, "flip.seq")
    with open(flip, "wb") as f:
        f.write(b"".join(b"<" + line[1:] + b"\n" if line[:1] == b">" else
                         b">" + line[1:] + b"\n"
                         for line in data.splitlines()))
    for path in (lf, crlf, flip):
        assert list(seqio.read_seq_pairs(path)) == \
            list(jax_seqio.read_seq_pairs(path))
        marker = seqio.record_marker(path)
        assert marker == jax_seqio.record_marker(path)
        size = os.path.getsize(path)
        cuts = [seqio.pair_start_at(path, pos, chunk_bytes=37,
                                    marker=marker)
                for pos in (0, size // 3, size // 2, size)]
        assert cuts == [jax_seqio.pair_start_at(path, pos, chunk_bytes=37,
                                                marker=marker)
                        for pos in (0, size // 3, size // 2, size)]
        for bs in (1, 3, 100):
            for start, end in ((0, None), (cuts[1], cuts[2]),
                               (cuts[2], cuts[3])):
                got = list(seqio.read_seq_batches(path, bs, start=start,
                                                  end=end))
                assert got == list(jax_seqio.read_seq_batches(
                    path, bs, start=start, end=end)), (path, bs, start)
    assert list(seqio.read_seq_pairs(crlf))[0][0].endswith("\r")
    assert seqio.record_marker(flip) == b"<"


def check_edit_dp():
    """Distances (encoded and raw), full and banded matrices, and the
    traceback on seeded pairs, N and lower-case characters among them."""
    from quicked_tpu.ops import edit_dp as jax_dp
    from quicked_tpu_torch.ops import edit_dp

    pairs = _pairs(4, 150, seed=23) + [("ACGTNacgt", "ACGTTACGN"),
                                       ("A", "ACGTACGT"), ("", "AC")]
    for p, t in pairs:
        for enc in (True, False):
            assert edit_dp.edit_distance(p, t, encoded=enc) == \
                jax_dp.edit_distance(p, t, encoded=enc)
        D = edit_dp.edit_dp_matrix(p, t)
        np.testing.assert_array_equal(D, jax_dp.edit_dp_matrix(p, t))
        assert edit_dp.edit_dp_traceback(D, p, t) == \
            jax_dp.edit_dp_traceback(D, p, t)
        for bk in (0, 5, 40):
            Db = edit_dp.edit_dp_matrix_banded(p, t, bk)
            np.testing.assert_array_equal(
                Db, jax_dp.edit_dp_matrix_banded(p, t, bk))
            assert edit_dp.edit_dp_traceback(Db, p, t) == \
                jax_dp.edit_dp_traceback(Db, p, t)


def check_profiler():
    """Counter.print, Timer.print and _human_time byte-equal for the same
    samples; add_repeat bit-exact with the loop it replaces."""
    from quicked_tpu.utils import profiler as jp
    from quicked_tpu_torch.utils import profiler

    rng = np.random.default_rng(27)
    for samples in ([], [1] * 5, rng.integers(0, 5000, 40).tolist(),
                    [3_000_000_000, 7]):
        c, jc = profiler.Counter(), jp.Counter()
        tot, jtot = profiler.Counter(), jp.Counter()
        for s in samples:
            c.add(s)
            jc.add(s)
        tot.add(sum(samples) * 3)
        jtot.add(sum(samples) * 3)
        for args, jargs in (((None, "bases     "), (None, "bases     ")),
                            ((tot, "alg       "), (jtot, "alg       ")),
                            ((profiler.Counter(), ""), (jp.Counter(), ""))):
            out, jout = io.StringIO(), io.StringIO()
            c.print(out, *args)
            jc.print(jout, *jargs)
            assert out.getvalue() == jout.getvalue()
    c, jc = profiler.Counter(), jp.Counter()
    c.add(3)
    jc.add(3)
    c.add_repeat(2, 4)
    jc.add_repeat(2, 4)
    c.add_repeat(1, 0)
    assert (c.total, c.samples, c.min, c.max, c.mean(), c.stddev()) == \
        (jc.total, jc.samples, jc.min, jc.max, jc.mean(), jc.stddev())
    for ns in (0, 999, 1_500, 2_000_000, 3_000_000_000, 90_000_000_000):
        assert profiler._human_time(ns) == jp._human_time(ns)
        t, jt = profiler.Timer(), jp.Timer()
        ref, jref = profiler.Timer(), jp.Timer()
        t.time_ns, jt.time_ns = ns, ns
        ref.time_ns, jref.time_ns = 2 * ns, 2 * ns
        for a, b in ((None, None), (ref, jref), (profiler.Timer(),
                                                  jp.Timer())):
            out, jout = io.StringIO(), io.StringIO()
            t.print(out, a)
            jt.print(jout, b)
            assert out.getvalue() == jout.getvalue()


def check_shard_lanes():
    """parallel.mesh.shard_lanes: the padded batch (lane count, every
    plane and lane vector with its pad values) for lane counts that do
    and do not divide the shards, score and full batches."""
    from quicked_tpu.parallel import mesh as jax_mesh
    from quicked_tpu_torch.parallel import mesh

    pairs = _pairs(10, 180, seed=25)
    cos = [max(len(p), len(t)) * 30 // 100 for p, t in pairs]
    fields = ("peq_lo", "peq_hi", "lm_lo", "lm_hi", "text", "init_scores",
              "cutoff", "prolog", "nbr", "finish_v", "tfinish", "first0",
              "last0", "plen", "tlen")
    for full in (False, True):
        for n_shards in (1, 3, 5, 8):
            args = ([p for p, _ in pairs], [t for _, t in pairs], cos)
            got = mesh.shard_lanes(batch_prep.prepare_banded_batch(
                *args, full=full), n_shards)
            want = jax_mesh.shard_lanes(jax_prep.prepare_banded_batch(
                *args, full=full), n_shards)
            assert (got.B, got.EBB, got.NB, got.K) == \
                (want.B, want.EBB, want.NB, want.K)
            for f in fields:
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)


def check_distributed_merge():
    """parallel.distributed's shard barrier (`_wait_for_shards`, done and
    timed out) and merges (`_merge_chunk_runs`, `_merge_shards` keyed and
    not) on the same shard files: equal output bytes and errors."""
    import shutil

    from quicked_tpu.parallel import distributed as jax_dist
    from quicked_tpu_torch.parallel import distributed as dist

    shards = {  # interleaved chunk runs of 5 chunks over 2 processes
        "chunks": ["#0\n1\t2M\n2\t3M\n#2\n#4\n5\t1X\n",
                   "#1\n3\t4M\n#3\n4\t1M1I\n"],
        "keyed": ["0\t1\t2M\n2\t3\t4M\n3\t4\t1M1I\n",
                  "1\t2\t3M\n4\t5\t1X\n"],
        "range": ["1\t2M\n2\t3M\n", "3\t4M\n"],
    }
    for kind, texts in shards.items():
        outs = []
        for mod in (dist, jax_dist):
            with tempfile.TemporaryDirectory() as td:
                out = os.path.join(td, "out.tsv")
                for i, text in enumerate(texts):
                    with open(f"{out}.shard{i:05d}", "w") as f:
                        f.write(text)
                    with open(f"{out}.shard{i:05d}.done", "w") as f:
                        f.write("nonce")
                mod._wait_for_shards(out, 2, "nonce", timeout_s=5)
                with pytest.raises(TimeoutError) as err:
                    mod._wait_for_shards(out, 3, "nonce", timeout_s=0)
                if kind == "chunks":
                    mod._merge_chunk_runs(out, 2, 5)
                else:
                    mod._merge_shards(out, 2, keyed=kind == "keyed")
                with open(out, "rb") as f:
                    outs.append((f.read(), str(err.value),
                                 sorted(os.listdir(td))))
                shutil.rmtree(td, ignore_errors=True)
        assert outs[0] == outs[1], kind
        assert outs[0][2] == ["out.tsv"], kind


def check_host_threads():
    """utils.host_threads.map_lanes and the loader's thread controls
    (`default_threads`: the thread budget, then QUICKED_TPU_CPU_THREADS,
    then every usable core) against the JAX package's."""
    from quicked_tpu.utils import host_threads as jax_threads
    from quicked_tpu_torch.utils import host_threads

    for n, workers in ((0, None), (1, None), (7, 3), (40, None), (5, 9)):
        outs = []
        for mod in (host_threads, jax_threads):
            out = np.zeros(max(n, 1), np.int64)

            def fn(i, out=out):
                out[i] = i * i + 1

            mod.map_lanes(fn, n, workers)
            outs.append(out)
        np.testing.assert_array_equal(*outs)
    old = os.environ.pop("QUICKED_TPU_CPU_THREADS", None)
    try:
        assert native.default_threads() == jax_native.default_threads()
        os.environ["QUICKED_TPU_CPU_THREADS"] = "3"
        assert native.default_threads() == jax_native.default_threads() == 3
        with native.thread_budget(2), jax_native.thread_budget(2):
            assert native.default_threads() == \
                jax_native.default_threads() == 2
            with native.thread_budget(0):
                assert native.default_threads() == 1
            assert native.default_threads() == 2
        assert native.default_threads() == 3
    finally:
        os.environ.pop("QUICKED_TPU_CPU_THREADS", None)
        if old is not None:
            os.environ["QUICKED_TPU_CPU_THREADS"] = old


def check_banded_native():
    """ops.banded_native (the host C full alignment, threaded over pairs,
    and the score pass with its band state) against the JAX package's,
    on string and pre-encoded inputs."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    from quicked_tpu.ops import banded_native as jax_bn
    from quicked_tpu_torch.ops import banded_native as bn

    pairs = _pairs(7, 700, seed=31)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    assert bn.native_available() == jax_bn.native_available()
    for args, kw in (((pats, txts, cos), {}),
                     ((pats, txts, cos, 2), {}),
                     (([dna.encode(p) for p in pats],
                       [dna.encode(t) for t in txts], cos),
                      dict(raws=([p.encode() for p in pats],
                                 [t.encode() for t in txts])))):
        got = bn.run_banded_full_native(*args, **kw)
        want = jax_bn.run_banded_full_native(*args, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    mids = [(len(t) + 1) // 2 for t in txts]
    for kw in (dict(), dict(text_finish=mids, pad_to_b=8, min_nb=16,
                            min_ebb=4)):
        got = bn.run_banded_native(batch_prep.prepare_banded_batch(
            pats, txts, cos, full=False, **kw))
        want = jax_bn.run_banded_native(jax_prep.prepare_banded_batch(
            pats, txts, cos, full=False, **kw))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def check_native_banded_align_full():
    """The loader's banded_align_full against the JAX package's, pair by
    pair; its ops equal the port's full fill and traceback (their plain
    versions) on the same pairs."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    from quicked_tpu_torch.aligner.batch import banded_align_batch

    pairs = _pairs(4, 300, seed=33)
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    full = []
    for (p, t), c in zip(pairs, cos):
        args = (dna.encode(p), p.encode(), dna.encode(t), t.encode(), c)
        got = native.banded_align_full(*args)
        assert got == jax_native.banded_align_full(*args)
        full.append(got)
    scores, ops = banded_align_batch(pats, txts, cos, only_score=False,
                                     device="cpu")
    assert [s for s, _ in full] == [int(x) for x in scores]
    assert [o for _, o in full] == ops


def check_native_force_scalar():
    """set_force_scalar / get_force_scalar / simd_pass_count through both
    loaders (one C runtime each): the vector passes count only without
    force_scalar, and the scores do not change."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no C compiler for the host C runtime")
    pairs = _pairs(4, 2000, seed=35)
    kw = dict(bandwidth=15, window_size=9, overlap_size=1,
              hew_threshold=(40, 40), hew_percentage=(15, 15),
              budget=16 << 20)
    for mod in (native, jax_native):
        res, passes = [], []
        for scalar in (False, True):
            mod.set_force_scalar(scalar)
            assert mod.get_force_scalar() is scalar
            before = mod.simd_pass_count()
            st, sc, ops = mod.quicked_batch([p for p, _ in pairs],
                                            [t for _, t in pairs], **kw)
            passes.append(mod.simd_pass_count() - before)
            res.append((list(st), list(sc), list(ops)))
        mod.set_force_scalar(False)
        assert passes[0] > 0 and passes[1] == 0, passes
        assert res[0] == res[1]


CASES = {f.__name__[len("check_"):]: f for f in (
    check_generate, check_prepare_banded_batch, check_band_geometry,
    check_hirschberg_split_fast, check_cigar, check_align_one_np,
    check_native, check_native_windowed, check_native_windowed_full,
    check_expand_window_records, check_seqio, check_edit_dp,
    check_profiler, check_shard_lanes, check_distributed_merge,
    check_host_threads, check_banded_native, check_native_banded_align_full,
    check_native_force_scalar)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_torch_copy_matches_original(name):
    CASES[name]()
