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
        "assert len(names) >= 23, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'quicked_tpu' or "
        "m.startswith('quicked_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_torch_chip_smoke_imports_no_jax_package():
    """chip_smoke.py, the port's proof on the card, imports nothing of
    the JAX package or of jax, at any depth of the file."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, "chip_smoke.py imports nothing"
    bad = [n for n in names if n.split(".")[0] in ("quicked_tpu", "jax")]
    assert not bad, bad


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
    for ws in (2, 9, 20):
        stw = wc.stage_windowed(
            wc.prepare_windowed_batch(pats, txts, window_size=ws), "cuda")
        got = wc.windowed_score_staged(stw, ws, 1, 204)
        want = wc.windowed_scan_torch(stw, ws, 1, 204)
        np.testing.assert_array_equal(got[0].cpu(), want[0].cpu())
        np.testing.assert_array_equal(got[1].cpu(), want[1].cpu())

    # deep-band passes: carry-scan (all keys) and systolic (ABORT flags,
    # then scores/first/last and pv/mv on [first, last] of the others);
    # cutoffs 108000 and 510000 give the systolic kernel's 4- and
    # 16-rows-per-thread windows and the carry-scan kernel's 4- and
    # 16-blocks-per-thread stripes
    for n, cutoff in ((8, 150), (2, 108_000), (2, 510_000)):
        st = bc.stage_banded(prepare_banded_batch(
            pats[:n], txts[:n], [cutoff] * n, full=False), "cuda")
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
    out = bc.fill_staged(bc.stage_banded(b, "cuda"))
    task = [torch.tensor(a[0::2], dtype=torch.int32, device="cuda")
            for a in (b.prolog, b.plen, b.tlen)]
    for a, b_ in zip(hs.hirschberg_split(out, *task),
                     hs.hirschberg_split_torch(out, *task)):
        assert torch.equal(a, b_)
