"""The port's boundaries: it loads neither jax nor anything of the JAX
package, it never runs on the CPU unless asked to, and (on a machine with
a card) each CUDA kernel agrees with its plain PyTorch version."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quicked_tpu_torch import api, generate
from quicked_tpu_torch.ops import banded_cscan_cuda as cc
from quicked_tpu_torch.ops import banded_cuda as bc
from quicked_tpu_torch.ops import banded_sysband_cuda as sb
from quicked_tpu_torch.ops import banded_traceback_cuda as btc
from quicked_tpu_torch.ops.batch_prep import prepare_banded_batch
from quicked_tpu_torch.ops import hirschberg_split_cuda as hs
from quicked_tpu_torch.ops import windowed_cuda as wc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import quicked_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'quicked_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 37, names\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'quicked_tpu', 'tests'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_torch_chip_smoke_imports_no_jax_package():
    """chip_smoke.py, the port's proof on the card, imports nothing of
    the JAX package, of jax or of the repository's tests, at any depth of
    the file."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, "chip_smoke.py imports nothing"
    bad = [n for n in names
           if n.split(".")[0] in ("quicked_tpu", "jax", "tests")]
    assert not bad, bad


def test_torch_package_surface_matches_jax():
    """quicked_tpu_torch exports what quicked_tpu exports: the JAX
    package's __all__, read from its source by ast so that nothing of it
    is imported, equals the port's, and every name resolves."""
    import quicked_tpu_torch

    with open(os.path.join(ROOT, "quicked_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign) and
                any(getattr(t, "id", None) == "__all__"
                    for t in node.targets))
    assert quicked_tpu_torch.__all__ == want
    for name in want:
        assert getattr(quicked_tpu_torch, name) is not None, name
    assert quicked_tpu_torch.WINDOWED == quicked_tpu_torch.QuickedAlgo.WINDOWED
    assert quicked_tpu_torch.BatchAligner is api.BatchAligner


def test_torch_cuda_device_raises_without_card(monkeypatch):
    """device="cuda" (the default) raises when no card is present instead
    of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        api.align_batch([("ACGT", "ACGT")])
    with pytest.raises(RuntimeError, match="cuda"):
        api.BatchAligner().align([("ACGT", "ACGT")])
    batch = prepare_banded_batch(["ACGT"], ["ACGT"], [65], full=False)
    with pytest.raises(RuntimeError, match="cuda"):
        bc.run_banded_cuda(batch)


def test_torch_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA launch paths take CUDA tensors only."""
    batch = prepare_banded_batch(["ACGT"], ["ACGT"], [65], full=False)
    st = bc.stage_banded(batch, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        bc._launch_fill(st)
    assert bc.FILL.launches == 0


def test_torch_kernel_ab_loads_the_other_checkout(tmp_path):
    """kernel_ab.load_other imports another checkout's windowed,
    traceback and deep-band wrappers (and its staging) under the port's
    name, with their own modules, and puts this checkout's modules
    back."""
    import shutil

    from quicked_tpu_torch import kernel_ab

    shutil.copytree(os.path.join(ROOT, "quicked_tpu_torch"),
                    tmp_path / "quicked_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))

    def ours():
        return {k: v for k, v in sys.modules.items()
                if k.split(".")[0] == "quicked_tpu_torch"}

    before = ours()
    other = kernel_ab.load_other(str(tmp_path))
    assert ours() == before
    assert set(other) == set(kernel_ab.MODULES)
    for fn in other.values():
        assert fn.__globals__["__file__"].startswith(str(tmp_path))
    windowed = other["windowed_score_staged"]
    assert windowed.__globals__["WINDOWED"] is not wc.WINDOWED
    b = wc.prepare_windowed_batch(["ACGTACGTTA"], ["ACGTTCGTA"],
                                  window_size=2)
    got = windowed(wc.stage_windowed(b, "cpu"), 2, 1, 0)
    want = wc.windowed_score_staged(wc.stage_windowed(b, "cpu"), 2, 1, 0)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    batch = prepare_banded_batch(["ACGTACGTTA"], ["ACGTTCGTA"], [65],
                                 full=False)
    st = other["stage_banded"](batch, "cpu")
    assert type(st) is not bc.StagedBanded
    want = cc.cscan_staged(bc.stage_banded(batch, "cpu"))
    got = other["cscan_staged"](st)
    assert all(torch.equal(got[k], want[k]) for k in want)


def tb_args(pats, txts, cutoff):
    """(the plain runs, then the traceback's inputs) of a full fill of
    the pairs on the host."""
    b = prepare_banded_batch(pats, txts, [cutoff] * len(pats), full=True)
    st = bc.stage_banded(b, "cpu")
    out = bc.banded_scan_torch(st)
    praw, traw = btc.prep_raw_frames([p.encode() for p in pats],
                                     [t.encode() for t in txts],
                                     out["mat_pv"].shape[0],
                                     max(map(len, pats)))
    lane = st.lanes["prolog"]
    runs = btc.traceback_records_torch(
        out["mat_pv"], out["mat_mv"], torch.from_numpy(praw),
        torch.from_numpy(traw), lane.new_tensor([len(p) for p in pats]),
        lane.new_tensor([len(t) for t in txts]), lane)[0]
    return (runs, out["mat_pv"], out["mat_mv"], torch.from_numpy(praw),
            torch.from_numpy(traw), lane.new_tensor([len(p) for p in pats]),
            lane.new_tensor([len(t) for t in txts]), lane)


def synthetic_planes(EBB, T, B, seed, ones=0.93):
    """(runs, then the traceback's inputs) over random planes: Pv bits
    one at the rate `ones` (long D-runs), random Mv, characters, band
    offsets and lengths (a pattern of the band's full depth, a text of T
    columns, an empty text). The walk is defined on any planes, so this
    reaches depths the fill's geometry never gives (EBB 1)."""
    rng = np.random.default_rng(seed)
    bits = rng.random((T, EBB, B, 64)) < ones
    pv = torch.from_numpy((bits * (1 << np.arange(64, dtype=np.uint64)))
                          .sum(-1).astype(np.uint64).view(np.int64))
    mv = torch.from_numpy(rng.integers(0, 2**63, (T, EBB, B),
                                       dtype=np.int64))
    PP = EBB * 64 + 100
    acgt = np.frombuffer(b"ACGT", np.uint8)
    praw = torch.from_numpy(rng.choice(acgt, (PP, B)))
    traw = torch.from_numpy(rng.choice(acgt, (T, B)))
    plen = torch.tensor(rng.integers(0, PP + 1, B), dtype=torch.int32)
    tlen = torch.tensor(rng.integers(0, T + 1, B), dtype=torch.int32)
    plen[0], tlen[1], tlen[-1] = PP, T, 0
    prolog = torch.tensor(rng.integers(0, min(EBB, 3) + 1, B),
                          dtype=torch.int32)
    args = (pv, mv, praw, traw, plen, tlen, prolog)
    return (btc.traceback_records_torch(*args)[0],) + args


def test_torch_synthetic_planes_walk_deep_runs():
    """The synthetic planes of the card test give D-runs that cross
    words, and finish walks both by the pattern and by the text."""
    runs, *args = synthetic_planes(4, 120, 5, seed=2, ones=0.99)
    assert int(runs.max()) > 64
    _, _, v_fin, h_fin = btc.traceback_records_torch(*args)
    assert (v_fin < 0).any() and (h_fin < 0).any()


@pytest.mark.cuda
def test_torch_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the same CUDA
    inputs, bit-exact (the systolic pass under its contract). Runs on a
    machine with a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    pairs = list(generate.generate_pairs(8, 300, error=0.1, seed=3,
                                         indels_num=2, indels_length=30))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cos = [max(len(p), len(t)) * 15 // 100 for p, t in pairs]
    for kw in (dict(full=False), dict(full=True),
               dict(full=False, text_finish=[len(t) // 2 for t in txts])):
        st = bc.stage_banded(prepare_banded_batch(pats, txts, cos, **kw),
                             "cuda")
        kern, plain = bc.fill_staged(st), bc.banded_scan_torch(st)
        for k in plain:
            assert torch.equal(kern[k], plain[k]), k

    # the fill at each stripe width (EBB <= 32, 64, 128: 1, 2 and 4 band
    # blocks per thread), past 128 blocks (2 and 8 warps per pair) and
    # past 2048 (the band walked in rounds), score, full and stopped at
    # text-finish midpoints; the deep bands on texts of one 64-column
    # block, so that the plain version (on a host copy) stays cheap
    for n, length, cut, cutoff, lo, hi in ((6, 600, None, 1500, 17, 32),
                                           (6, 600, None, 3000, 33, 64),
                                           (6, 600, None, 7000, 65, 128),
                                           (6, 600, None, 12000, 129, 256),
                                           (2, 80, 64, 64_000, 897, 1024),
                                           (2, 80, 64, 140_000, 2049, 4096)):
        wide = list(generate.generate_pairs(n, length, error=0.1, seed=5,
                                            indels_num=2,
                                            indels_length=length // 15))
        wp = [p for p, _ in wide]
        wt = [t[:cut] for _, t in wide]
        mids = [(len(t) + 1) // 2 for t in wt]
        for kw in (dict(full=False), dict(full=True),
                   dict(full=False, text_finish=mids)):
            b = prepare_banded_batch(wp, wt, [cutoff] * n, **kw)
            assert lo <= b.EBB <= hi, (cutoff, b.EBB)
            kern = bc.fill_staged(bc.stage_banded(b, "cuda"))
            plain = bc.banded_scan_torch(bc.stage_banded(b, "cpu"))
            for k in plain:
                assert torch.equal(kern[k].cpu(), plain[k]), (cutoff, kw, k)
    st = bc.stage_banded(prepare_banded_batch(pats, txts, cos, full=True),
                         "cuda")
    out = bc.fill_staged(st)
    praw, traw = btc.prep_raw_frames([p.encode() for p in pats],
                                     [t.encode() for t in txts],
                                     out["mat_pv"].shape[0],
                                     max(map(len, pats)))
    lane = st.lanes["prolog"]
    args = (out["mat_pv"], out["mat_mv"], torch.from_numpy(praw).cuda(),
            torch.from_numpy(traw).cuda(),
            lane.new_tensor([len(p) for p in pats]),
            lane.new_tensor([len(t) for t in txts]), lane)
    for a, b in zip(btc.traceback_records(*args),
                    btc.traceback_records_torch(*args)):
        assert torch.equal(a, b)
    # the traceback at B = 1, on a D-run of 500 rows (eight words, past
    # the staged window), at EBB 1, 128 and 7300 (D-runs reaching band
    # words far below the cursor)
    rng = np.random.default_rng(5)
    s = "".join(rng.choice(list("ACGT"), 1400))
    z = "".join(rng.choice(list("ACGT"), 500))
    cases = [tb_args([pats[0]], [txts[0]], 45),
             tb_args([s + z], [s], 600)]
    cases += [synthetic_planes(ebb, 200, 5, seed=ebb, ones=o)
              for ebb in (1, 128) for o in (0.93, 0.99)]
    cases.append(synthetic_planes(7300, 64, 2, seed=3))
    assert int(cases[1][0].max()) == 500
    for host in cases:
        tb = btc.traceback_records(*(x.cuda() for x in host[1:]))
        for a, b in zip(tb, btc.traceback_records_torch(*host[1:])):
            assert torch.equal(a.cpu(), b)

    # the windowed bound at ws 1 (ovl 0), 2 and 9, at the shared/scratch
    # cutover (ws 14, 15), at 20 and past one warp (33); batches of 1, 17
    # and more than 132 pairs (1, 4 and 32 pairs per warp); the plain
    # version on a host copy
    small = list(generate.generate_pairs(140, 150, error=0.1, seed=4))
    tiny = list(generate.generate_pairs(4300, 90, error=0.1, seed=6))
    wcases = [(ws, 1, pats, txts) for ws in (2, 9, 14, 15, 20, 33)]
    wcases += [(1, 0, pats, txts), (9, 1, pats[:1], txts[:1]),
               (2, 1, [p for p, _ in small[:17]], [t for _, t in small[:17]]),
               (2, 1, [p for p, _ in small], [t for _, t in small]),
               (2, 1, [p for p, _ in small] * 5, [t for _, t in small] * 5),
               (1, 0, [p for p, _ in tiny], [t for _, t in tiny])]
    for ws, ovl, wp, wt in wcases:
        b = wc.prepare_windowed_batch(wp, wt, window_size=ws)
        cells = wc.hew_cell_threshold(ws, ovl, 40)
        got = wc.windowed_score_staged(wc.stage_windowed(b, "cuda"), ws, ovl,
                                       cells)
        want = wc.windowed_scan_torch(wc.stage_windowed(b, "cpu"), ws, ovl,
                                      cells)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (ws, len(wp))

    # deep-band passes: carry-scan (all keys) and systolic (ABORT flags,
    # then scores/first/last and pv/mv on [first, last] of the others);
    # cutoffs 150, 3000 and 7000 give the carry-scan kernel's one-warp
    # stripes (1, 2 and 4 band blocks per thread) and the systolic
    # kernel's words in registers; 108000 its words in shared memory (8
    # rows per thread) and the carry-scan kernel's several warps; 510000
    # its PEQ words from device memory (16 rows per thread) and the
    # carry-scan kernel's rounds
    for n, cutoff in ((8, 150), (8, 3000), (8, 7000), (2, 108_000),
                      (2, 510_000)):
        st = bc.stage_banded(prepare_banded_batch(
            pats[:n], txts[:n], [cutoff] * n, full=False), "cuda")
        assert torch.equal(st.text_pm, st.text.t())
        kern, plain = cc.cscan_staged(st), cc.banded_cscan_torch(st)
        for k in plain:
            assert torch.equal(kern[k], plain[k]), (cutoff, k)
        (kern, k_abort), (plain, p_abort) = (sb.sysband_raw(st),
                                             sb.banded_sysband_torch(st))
        assert torch.equal(k_abort, p_abort)
        for j in (~p_abort).nonzero()[:, 0].tolist():
            for k in ("scores_by_k", "first", "last"):
                assert torch.equal(kern[k][..., j], plain[k][..., j]), k
            lo = max(int(plain["first"][j]), 0)
            hi = min(int(plain["last"][j]) + 1, st.EBB)
            for k in ("pv", "mv"):
                assert torch.equal(kern[k][lo:hi, j],
                                   plain[k][lo:hi, j]), (cutoff, k)

    # split epilogue over an interleaved forward/reverse level batch
    il = [(s, s[::-1]) for s in pats], [(s, s[::-1]) for s in txts]
    b = prepare_banded_batch(
        [x for pr in il[0] for x in pr], [x for pr in il[1] for x in pr],
        [100] * 16, full=False,
        text_finish=[m for t in txts for m in ((len(t) + 1) // 2,
                                               len(t) - (len(t) + 1) // 2)])
    st = bc.stage_banded(b, "cuda")
    task = [torch.tensor(a[0::2], dtype=torch.int32, device="cuda")
            for a in (b.prolog, b.plen, b.tlen)]
    # on the fill's outputs, and on the deep-band passes' (the systolic
    # one exact on [first, last] only)
    for out in (bc.fill_staged(st), cc.cscan_staged(st),
                sb.sysband_staged(st)):
        for a, b_ in zip(hs.hirschberg_split(out, *task),
                         hs.hirschberg_split_torch(out, *task)):
            assert torch.equal(a, b_)
    # deeper levels (EBB 48 and 142: 1 and 2 warps a task)
    for length, cutoff in ((4000, 3000), (6000, 9000)):
        pl = list(generate.generate_pairs(3, length, error=0.1, seed=8,
                                          indels_num=2, indels_length=200))
        db = prepare_banded_batch(
            [x for p, _ in pl for x in (p, p[::-1])],
            [x for _, t in pl for x in (t, t[::-1])], [cutoff] * 6,
            full=False, text_finish=[m for _, t in pl for m in (
                (len(t) + 1) // 2, len(t) - (len(t) + 1) // 2)])
        out = cc.cscan_staged(bc.stage_banded(db, "cuda"))
        task = [torch.tensor(a[0::2], dtype=torch.int32, device="cuda")
                for a in (db.prolog, db.plen, db.tlen)]
        want = hs.hirschberg_split_torch(
            {k: v.cpu() for k, v in out.items()}, *[x.cpu() for x in task])
        assert int(want[3].sum()) == 3
        for a, b_ in zip(hs.hirschberg_split(out, *task), want):
            assert torch.equal(a.cpu(), b_)

    # the windowed full mode at ws 1 (ovl 0), 2, 9, 14, 15 (the scratch
    # window) and 20, with a pure-deletion and a pure-insertion pair
    rng = np.random.default_rng(9)
    d = "".join(rng.choice(list("ACGT"), 700))
    fp, ft = pats + [d, d[200:260]], txts + [d[200:260], d]
    for ws, ovl in ((1, 0), (2, 1), (9, 1), (14, 1), (15, 1), (20, 1)):
        b = wc.prepare_windowed_batch(fp, ft, window_size=ws)
        got = wc.windowed_full_staged(wc.stage_windowed(b, "cuda"), ws, ovl)
        want = wc.windowed_full_torch(wc.stage_windowed(b, "cpu"), ws, ovl)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), ws
