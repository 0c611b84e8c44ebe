"""The port's command-line tools against the JAX package's, on the CPU:
align_benchmark's TSV lines and stderr blocks byte for byte for every
algorithm and mode, generate_dataset's files, the harness, the pyquicked
module and the memory report."""

import io
import os
import re
import subprocess
import sys

import pytest
import torch

from quicked_tpu.tools import align_benchmark as jax_cli
from quicked_tpu.tools import generate_dataset as jax_gen
from quicked_tpu_torch import generate, seqio
from quicked_tpu_torch.tools import align_benchmark as cli
from quicked_tpu_torch.tools import generate_dataset as gen

from .test_torch_copies import jax_warmup_inline  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALGOS = [
    ("quicked", []),
    ("edit-banded", ["--bandwidth", "15"]),
    ("edit-windowed", ["--window-size", "9", "--overlap-size", "1"]),
    ("edit-banded-hirschberg", ["--bandwidth", "15"]),
    ("edit-dp", []),
    ("edit-dp-banded", ["--bandwidth", "10"]),
    ("edit-bpm", []),
]
EXTRA = dict(ALGOS)
# a time or a rate on a [Benchmark] or progress line
_TIMES = re.compile(r"(=> Time\.[A-Za-z]+(?: [A-Z][a-z]+)?|alignment = ).*$",
                    re.MULTILINE)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """name -> .seq path: the 8 x 180 bp set of the JAX CLI's tests, 3
    pairs x 400 bp with two 60 bp indels each, and pairs with an empty
    pattern and an empty text."""
    td = tmp_path_factory.mktemp("torch_cli")
    sets = {
        "cli": list(generate.generate_pairs(8, 180, error=0.1, seed=55)),
        "indels": list(generate.generate_pairs(3, 400, error=0.1, seed=56,
                                               indels_num=2,
                                               indels_length=60)),
        "empty": [("ACGTACGTAC", "ACGTTCGTAC"), ("", "ACGT"),
                  ("ACGGT", ""), ("ACGTAAAC", "ACGTCAC")],
    }
    paths = {}
    for name, pairs in sets.items():
        paths[name] = str(td / f"{name}.seq")
        seqio.write_seq_pairs(paths[name], pairs)
    return paths


def run_both(monkeypatch, capsys, tmp_path, argv, out_flag="-o"):
    """(port, jax): each side's (exit code, output file text, stderr) for
    the same arguments; the port on the CPU, the JAX CLI in-process with
    its compile cache in the tests' own directory."""
    monkeypatch.setenv("QUICKED_TPU_CACHE", os.path.join(REPO, ".jax_cache"))
    res = []
    for side, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        out = str(tmp_path / f"{side}.tsv")
        rc = main([*argv, out_flag, out, *extra])
        err = capsys.readouterr().err
        text = None
        if os.path.exists(out):
            with open(out) as f:
                text = f.read()
        res.append((rc, text, err))
    return res


@pytest.mark.parametrize("dataset", ["cli", "indels", "empty"])
@pytest.mark.parametrize("algo", [a for a, _ in ALGOS])
def test_torch_cli_tsv_matches_jax(datasets, algo, dataset, monkeypatch,
                                   capsys, tmp_path):
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", algo, "-i", datasets[dataset], "-q",
                          *EXTRA[algo]])
    assert port[0] == jax[0] == 0, port[2]
    assert port[1] == jax[1]
    assert port[1].count("\n") == {"cli": 8, "indels": 3, "empty": 4}[dataset]


@pytest.mark.parametrize("dataset", ["cli", "indels"])
@pytest.mark.parametrize("algo", ["quicked", "edit-banded", "edit-windowed",
                                  "edit-bpm"])
def test_torch_cli_only_score_matches_jax(datasets, algo, dataset,
                                          monkeypatch, capsys, tmp_path):
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", algo, "-i", datasets[dataset], "-q",
                          "--only-score", *EXTRA[algo]])
    assert port[0] == jax[0] == 0, port[2]
    assert port[1] == jax[1]
    # quicked bypasses align_batch_full, so its CIGARs stay, as the JAX
    # CLI's do
    assert all(line.endswith("\t-") != (algo == "quicked")
               for line in port[1].splitlines())


@pytest.mark.parametrize("algo", ["quicked", "edit-banded", "edit-bpm"])
def test_torch_cli_output_full_matches_jax(datasets, algo, monkeypatch,
                                           capsys, tmp_path):
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", algo, "-i", datasets["empty"], "-q",
                          *EXTRA[algo]], out_flag="--output-full")
    assert port[0] == jax[0] == 0, port[2]
    assert port[1] == jax[1]
    assert [len(line.split("\t")) for line in port[1].splitlines()] == \
        [6] * 4


@pytest.mark.parametrize("algo", ["quicked", "edit-banded-hirschberg",
                                  "edit-bpm"])
def test_torch_cli_batches_stream_the_same_bytes(datasets, algo,
                                                 monkeypatch, capsys,
                                                 tmp_path):
    """--batch-size 3 over 8 pairs: three batches, the same TSV as one
    batch and as the JAX CLI's, and the same progress lines apart from
    their rates."""
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", algo, "-i", datasets["cli"],
                          "--batch-size", "3", "-P", "3", *EXTRA[algo]])
    assert port[0] == jax[0] == 0, port[2]
    assert port[1] == jax[1]
    assert _TIMES.sub(r"\1", port[2]) == _TIMES.sub(r"\1", jax[2])
    assert port[2].count("...processed") == 2
    one = str(tmp_path / "one.tsv")
    assert cli.main(["-a", algo, "-i", datasets["cli"], "-o", one, "-q",
                     "--device", "cpu", *EXTRA[algo]]) == 0
    with open(one) as f:
        assert f.read() == port[1]


@pytest.mark.parametrize("mode", ["display", "correct", "score",
                                  "alignment"])
@pytest.mark.parametrize("algo", ["quicked", "edit-bpm"])
def test_torch_cli_check_blocks_match_jax(datasets, algo, mode, monkeypatch,
                                          capsys, tmp_path):
    """--check: the [Accuracy] block (and display's pretty alignments)
    byte for byte; the [Benchmark] block, -v's stage lines with it, apart
    from the times."""
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", algo, "-i", datasets["indels"], "-c", mode,
                          "-v"])
    assert port[0] == jax[0] == 0, port[2]
    assert port[1] == jax[1]
    head, _, acc = port[2].partition("[Accuracy]")
    jhead, _, jacc = jax[2].partition("[Accuracy]")
    assert acc == jacc
    assert _TIMES.sub(r"\1", head) == _TIMES.sub(r"\1", jhead)
    if mode == "display":
        assert "PATTERN/TEXT lengths" in port[2] and not acc
    else:
        assert "(100.00 %)" in acc
    if algo == "quicked":
        assert "Time.Windowed Small" in head


def test_torch_cli_missing_input_matches_jax(tmp_path, capsys):
    missing = str(tmp_path / "none.seq")
    assert cli.main(["-a", "quicked", "-i", missing, "--device", "cpu"]) == 1
    port = capsys.readouterr().err
    assert jax_cli.main(["-a", "quicked", "-i", missing]) == 1
    assert port == capsys.readouterr().err
    assert "not found" in port


def test_torch_cli_edlib_without_the_oracle(datasets, capsys):
    from quicked_tpu_torch.tools._edlib_oracle import find_edlib_oracle

    if find_edlib_oracle() is not None:
        pytest.skip("the edlib oracle is built here")
    rc = cli.main(["-a", "edlib", "-i", datasets["cli"], "-q", "--device",
                   "cpu"])
    assert rc == 1
    assert "edlib" in capsys.readouterr().err


def test_torch_cli_cuda_without_a_card(datasets, tmp_path, capsys,
                                       monkeypatch):
    """The default device is the card: without one the CLI exits non-zero
    with resolve_device's message, and writes no output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.tsv")
    assert cli.main(["-a", "quicked", "-i", datasets["cli"], "-o", out]) != 0
    assert "device 'cuda' requested" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_torch_cli_profile_and_memory_report(datasets, tmp_path, capsys,
                                             monkeypatch):
    """--profile writes a torch.profiler Chrome trace (stopped and written
    when a batch raises too); --memory-report prints the port's block with
    the full fill's plane bytes."""
    from quicked_tpu_torch.utils import memreport

    memreport.reset()
    prof = tmp_path / "prof"
    assert cli.main(["-a", "edit-banded", "-i", datasets["empty"], "-q",
                     "--device", "cpu", "--profile", str(prof)]) == 0
    assert os.listdir(prof) == ["align_benchmark.trace.json"]
    assert cli.main(["-a", "edit-banded", "-i", datasets["indels"],
                     "--device", "cpu", "--memory-report"]) == 0
    err = capsys.readouterr().err
    assert "[Memory]" in err and "FullFill.Planes" in err
    assert err.index("[Memory]") < err.index("[Benchmark]")

    def boom(*a, **kw):
        raise RuntimeError("batch failed")

    monkeypatch.setattr(cli, "_run_batch", boom)
    prof2 = tmp_path / "prof2"
    with pytest.raises(RuntimeError, match="batch failed"):
        cli.main(["-a", "quicked", "-i", datasets["cli"], "--device", "cpu",
                  "--profile", str(prof2)])
    assert os.listdir(prof2) == ["align_benchmark.trace.json"]
    memreport.reset()


def test_torch_cli_num_threads_is_accepted(datasets, monkeypatch, capsys,
                                           tmp_path):
    """-t is the reference's flag; it caps the host C lanes' threads for
    the run (through a thread budget, not the environment), so the lines
    are those of a run without it and the environment is unchanged."""
    port, jax = run_both(monkeypatch, capsys, tmp_path,
                         ["-a", "quicked", "-i", datasets["cli"], "-q"])
    assert port[0] == jax[0] == 0, port[2]
    out = str(tmp_path / "threads.tsv")
    env = dict(os.environ)
    assert cli.main(["-a", "quicked", "-i", datasets["cli"], "-q",
                     "--device", "cpu", "-t", "3", "-o", out]) == 0
    with open(out) as f:
        assert f.read() == port[1] == jax[1]
    assert dict(os.environ) == env


def test_torch_cli_num_threads_caps_the_host_lanes(datasets, monkeypatch,
                                                  tmp_path):
    """-t 2 caps `native.default_threads()` (the host C lanes' threads)
    inside the run and nowhere after it; the lines equal those of a run
    without it."""
    from quicked_tpu_torch import native

    seen = {}
    real = native.set_force_scalar

    def spy(v):
        seen.setdefault(key, set()).add(native.default_threads())
        real(v)

    monkeypatch.setattr(native, "set_force_scalar", spy)
    outside = native.default_threads()
    lines = {}
    for key, extra in (("default", []), ("t2", ["-t", "2"])):
        out = str(tmp_path / f"{key}.tsv")
        assert cli.main(["-a", "quicked", "-i", datasets["indels"], "-q",
                         "--device", "cpu", *extra, "-o", out]) == 0
        with open(out) as f:
            lines[key] = f.read()
    assert lines["default"] == lines["t2"] and lines["t2"]
    assert seen == {"default": {outside}, "t2": {2}}
    assert native.default_threads() == outside


@pytest.mark.parametrize("argv", [
    ["-n", "5", "-l", "100", "-e", "0.08", "--seed", "3"],
    ["-n", "3", "-l", "100", "-e", "0.05", "--length-diff", "0.8",
     "--seed", "4"],
    ["-n", "4", "-l", "300", "-e", "0.1", "--indels", "2,40", "--seed",
     "5"],
], ids=["plain", "flipped", "indels"])
def test_torch_generate_dataset_matches_jax(argv, tmp_path):
    files = []
    for side, main in (("port", gen.main), ("jax", jax_gen.main)):
        out = str(tmp_path / f"{side}.seq")
        assert main([*argv, "-o", out]) == 0
        with open(out, "rb") as f:
            files.append(f.read())
    assert files[0] == files[1]
    assert files[0].count(b"\n") == 2 * int(argv[1])


def run_harness(*argv):
    env = dict(os.environ, QUICKED_HARNESS_DEVICE="cpu", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "quicked_tpu_torch.tools.quicked_harness",
         *argv], capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO)


@pytest.mark.parametrize("argv,rc,out,err", [
    (("", "ACGT"), 1, "", "ERROR: Tried to align an empty sequence"),
    (("GATC", "GATO", "1"), 0, "Got score: 1\nExpected score: 1", ""),
    (("GATC", "GATC", "7"), 1,
     "Got score: 0\nExpected score: 7<FAIL>\n", ""),
], ids=["empty", "nonDNA", "score-check-fail"])
def test_torch_harness(argv, rc, out, err):
    r = run_harness(*argv)
    assert r.returncode == rc, r.stderr
    assert r.stdout == out
    assert err in r.stderr


def test_torch_pyquicked_surface():
    from quicked_tpu_torch import pyquicked

    a = pyquicked.QuickedAligner(device="cpu")
    a.setAlgorithm(pyquicked.BANDED)
    a.setBandwidth(10)
    a.align("ACGT", "ACTT")
    assert a.getScore() == 1
    assert a.getCigar() == "2M1X1M"
    assert pyquicked.QUICKED_OK == pyquicked.QuickedStatus.QUICKED_OK
    assert issubclass(pyquicked.QuickedException, Exception)
    assert pyquicked.QuickedAligner().device == "cuda"


def test_torch_memreport_records_and_reports():
    from quicked_tpu_torch.utils import memreport

    memreport.reset()
    memreport.record("FullFill.Planes", 1 << 20)
    memreport.record("FullFill.Planes", 1 << 22)
    rep = memreport.memory_report()
    st = rep["recorded"]["FullFill.Planes"]
    assert st["count"] == 2
    assert st["bytes"] == (1 << 20) + (1 << 22)
    assert st["peak"] == 1 << 22
    assert rep["budgets"]["full_fill_bytes_budget"] > 0
    assert rep["host"].get("vmrss", 0) > 0
    assert rep["devices"] == []        # no CUDA device in a CPU run
    buf = io.StringIO()
    memreport.print_report(buf)
    out = buf.getvalue()
    assert "[Memory]" in out and "FullFill.Planes" in out
    memreport.reset()


def test_torch_memreport_captures_engine_allocations(monkeypatch):
    """A full-alignment batch records its band-plane bytes, lane by lane
    of each chunk; a Hirschberg run over its budget records its split
    levels' band words."""
    from quicked_tpu_torch.aligner import batch, hirschberg
    from quicked_tpu_torch.utils import memreport

    memreport.reset()
    pairs = list(generate.generate_pairs(4, 200, error=0.1, seed=3))
    pats = [p for p, _ in pairs]
    txts = [t for _, t in pairs]
    cutoffs = [max(len(p), len(t)) * 20 // 100 for p, t in pairs]
    sc, ops = batch.banded_align_batch(pats, txts, cutoffs,
                                       only_score=False, device="cpu")
    assert all(o for o in ops)
    keys = batch.bucket_keys(map(len, pats), map(len, txts), cutoffs,
                             full=True)
    st = memreport.memory_report()["recorded"]["FullFill.Planes"]
    assert st["bytes"] == sum(nb * batch.W * ebb * 16 for nb, ebb in keys)
    assert st["count"] == len(set(keys))
    memreport.reset()
    monkeypatch.setattr(hirschberg, "HIRSCHBERG_BUFFER_SIZE", 1 << 14)
    long = list(generate.generate_pairs(2, 1500, error=0.1, seed=3))
    res = hirschberg.hirschberg_batch(
        [t for _, t in long], [p for p, _ in long],
        [max(len(p), len(t)) * 15 // 100 for p, t in long], device="cpu")
    assert all(int(st) == 0 for st, _ in res)
    rec = memreport.memory_report()["recorded"]
    assert rec["Hirschberg.LevelPlanes"]["bytes"] > 0
    assert rec["FullFill.Planes"]["count"] > 0
    memreport.reset()
