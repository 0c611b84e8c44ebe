"""The port's multi-process driver (quicked_tpu_torch.parallel.
distributed) on the CPU: N processes over the same input produce the
ordered output of 1 process, byte for byte, in every sharding mode, and
the same bytes as the JAX package's driver (quicked_tpu.parallel.
distributed) on the same .seq file. Mirrors tests/test_distributed.py;
the real multi-process runs start `torch.distributed` (gloo) processes
from the environment `torchrun` sets."""

import os
import socket
import subprocess
import sys

import pytest
import torch

from quicked_tpu.parallel.distributed import \
    distributed_align as jax_distributed_align
from quicked_tpu.params import QuickedAlgo as JaxAlgo
from quicked_tpu.params import QuickedParams as JaxParams
from quicked_tpu_torch import generate, seqio
from quicked_tpu_torch.parallel import distributed as dist
from quicked_tpu_torch.params import QuickedAlgo, QuickedParams

from .test_torch_copies import jax_warmup_inline  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)


def _align(seq, out, **kw):
    return dist.distributed_align(seq, out, PARAMS, device="cpu", **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _jax_tsv(seq, tmp_path, name="jax.tsv"):
    """The JAX package's one-process merged TSV of the same file."""
    out = str(tmp_path / name)
    jax_distributed_align(seq, out, JaxParams(algo=JaxAlgo.BANDED,
                                              bandwidth=30),
                          process_index=0, process_count=1)
    return _read(out)


def _seq(tmp_path, pairs, name="in.seq"):
    seq = str(tmp_path / name)
    seqio.write_seq_pairs(seq, pairs)
    return seq


def test_torch_shard_equivalence(tmp_path):
    pairs = list(generate.generate_pairs(12, 150, error=0.1, seed=77))
    seq = _seq(tmp_path, pairs)
    out1 = str(tmp_path / "out1.tsv")
    assert _align(seq, out1, process_index=0, process_count=1) == 12
    ref = _read(out1)
    assert ref == _jax_tsv(seq, tmp_path)
    # 3 processes in turn over the same shared directory (the
    # coordinator last, so that its merge sees every shard), in every
    # sharding mode: byte-range chunks, byte-range slices, strided ids
    for mode in ("interleaved", "range", "stride"):
        out3 = str(tmp_path / f"out3_{mode}.tsv")
        total = sum(_align(seq, out3, process_index=pi, process_count=3,
                           sharding=mode) for pi in (1, 2, 0))
        assert total == 12
        assert _read(out3) == ref, mode


def test_torch_interleaved_many_small_chunks(tmp_path, monkeypatch):
    # chunks smaller than a record: empty chunks, chunk runs split
    # across processes; the ordered merge still gives the input order
    monkeypatch.setattr(dist, "CHUNK_BYTES", 64)
    pairs = list(generate.generate_pairs(10, 90, error=0.1, seed=80))
    seq = _seq(tmp_path, pairs)
    out1 = str(tmp_path / "out1.tsv")
    _align(seq, out1, process_index=0, process_count=1, sharding="stride")
    out3 = str(tmp_path / "out3.tsv")
    total = sum(_align(seq, out3, process_index=pi, process_count=3,
                       sharding="interleaved") for pi in (2, 1, 0))
    assert total == 10
    assert _read(out1) == _read(out3) == _jax_tsv(seq, tmp_path)


def test_torch_pair_start_at(tmp_path):
    pairs = [("ACGT" * k, "ACGA" * k) for k in range(1, 6)]
    seq = _seq(tmp_path, pairs)
    size = os.path.getsize(seq)
    data = _read(seq)
    starts = [0] + [i for i, ch in enumerate(data)
                    if ch == ord(">") and data[i - 1] == ord("\n")]
    # every byte position maps to the next true record start
    for pos in range(size + 2):
        expect = next((s for s in starts if s >= pos), size)
        assert seqio.pair_start_at(seq, pos) == expect
    # a tiny chunk size exercises the cross-chunk "\n>" boundary carry
    assert seqio.pair_start_at(seq, starts[2] - 1,
                               chunk_bytes=1) == starts[2]


def test_torch_flipped_dataset_sharding(tmp_path):
    # length_diff < 1 datasets are written '<pattern/>text', so record
    # starts are marked '<': byte-range sharding must find the marker or
    # it would cut records in half
    pairs = list(generate.generate_pairs(10, 120, error=0.1, seed=83,
                                         length_diff=0.8))
    assert all(len(p) > len(t) for p, t in pairs)
    seq = str(tmp_path / "flipped.seq")
    with open(seq, "w") as f:
        for p, t in pairs:
            f.write(f"<{p}\n>{t}\n")
    assert seqio.record_marker(seq) == b"<"
    out1 = str(tmp_path / "o1.tsv")
    _align(seq, out1, process_index=0, process_count=1)
    assert _read(out1) == _jax_tsv(seq, tmp_path)
    for mode in ("interleaved", "range"):
        outn = str(tmp_path / f"on_{mode}.tsv")
        total = sum(_align(seq, outn, process_index=pi, process_count=3,
                           sharding=mode) for pi in (2, 1, 0))
        assert total == 10
        assert _read(out1) == _read(outn), mode


def test_torch_ambiguous_marker_falls_back_to_stride(tmp_path):
    # both lines marked '>': no local record-start signal, so the
    # byte-range modes fall back to stride instead of mispairing records
    pairs = list(generate.generate_pairs(6, 80, error=0.1, seed=84))
    seq = str(tmp_path / "ambig.seq")
    with open(seq, "w") as f:
        for p, t in pairs:
            f.write(f">{p}\n>{t}\n")
    assert seqio.record_marker(seq) is None
    out1 = str(tmp_path / "o1.tsv")
    _align(seq, out1, process_index=0, process_count=1, sharding="stride")
    outn = str(tmp_path / "on.tsv")
    total = sum(_align(seq, outn, process_index=pi, process_count=2,
                       sharding="interleaved") for pi in (1, 0))
    assert total == 6
    assert _read(out1) == _read(outn) == _jax_tsv(seq, tmp_path)


def test_torch_range_sharding_more_processes_than_pairs(tmp_path):
    pairs = list(generate.generate_pairs(3, 80, error=0.05, seed=79))
    seq = _seq(tmp_path, pairs)
    out1 = str(tmp_path / "out1.tsv")
    _align(seq, out1, process_index=0, process_count=1)
    outn = str(tmp_path / "outn.tsv")
    total = sum(_align(seq, outn, process_index=pi, process_count=5)
                for pi in (4, 3, 2, 1, 0))
    assert total == 3
    assert _read(out1) == _read(outn)


def test_torch_crlf_input_shard_accounting(tmp_path):
    # CRLF line endings: byte-offset shard budgets count raw bytes, so no
    # boundary pair is duplicated; the '\r' stays inside the sequence
    pairs = list(generate.generate_pairs(8, 60, error=0.1, seed=82))
    seq = str(tmp_path / "crlf.seq")
    with open(seq, "wb") as f:
        for p, t in pairs:
            f.write(f">{p}\r\n<{t}\r\n".encode())
    out1 = str(tmp_path / "o1.tsv")
    assert _align(seq, out1, process_index=0, process_count=1,
                  sharding="range") == 8
    out3 = str(tmp_path / "o3.tsv")
    total = sum(_align(seq, out3, process_index=pi, process_count=3,
                       sharding="range") for pi in (2, 1, 0))
    assert total == 8
    assert _read(out1) == _read(out3)


def _script(body: str) -> str:
    return ("import sys; sys.path.insert(0, {repo!r});"
            "from quicked_tpu_torch.parallel.distributed import ("
            "distributed_align, maybe_initialize_distributed);"
            "from quicked_tpu_torch.params import QuickedParams, "
            "QuickedAlgo;" + body)


def _params_src():
    return "QuickedParams(algo=QuickedAlgo.BANDED, bandwidth=30)"


def test_torch_concurrent_processes(tmp_path):
    # real concurrent processes over a shared directory, ranks given as
    # arguments: the coordinator blocks on the shard barrier until every
    # worker is done
    pairs = list(generate.generate_pairs(9, 120, error=0.1, seed=78))
    seq = _seq(tmp_path, pairs)
    out = str(tmp_path / "out.tsv")
    script = _script(
        f"distributed_align({seq!r}, {out!r}, {_params_src()}, "
        "process_index=int(sys.argv[1]), process_count=3, device='cpu')"
    ).format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(pi)],
                              cwd=REPO, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for pi in range(3)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()[-2000:]
    lines = _read(out).decode().strip().split("\n")
    assert len(lines) == 9 and not any("ERROR" in x for x in lines)
    assert _read(out) == _jax_tsv(seq, tmp_path)


def _run_torch_distributed(tmp_path, n_procs: int, n_pairs: int,
                           seed: int) -> bytes:
    """Launch a real n-process torch.distributed (gloo) run on the CPU:
    each process learns its rank and the world size from the environment
    torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) through maybe_initialize_distributed, not from
    arguments. Returns the merged output bytes."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    pairs = list(generate.generate_pairs(n_pairs, 100, error=0.1,
                                         seed=seed))
    seq = _seq(tmp_path, pairs, f"in{n_procs}.seq")
    out = str(tmp_path / f"out{n_procs}.tsv")
    script = _script(
        "pi, pc = maybe_initialize_distributed();"
        f"assert pc == {n_procs}, (pi, pc);"
        f"distributed_align({seq!r}, {out!r}, {_params_src()}, "
        "device='cpu')").format(repo=REPO)
    env = dict(os.environ, WORLD_SIZE=str(n_procs), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              cwd=REPO, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE)
             for r in range(n_procs)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()[-2000:]
    text = _read(out)
    lines = text.decode().strip().split("\n")
    assert len(lines) == n_pairs and not any("ERROR" in x for x in lines)
    assert text == _jax_tsv(seq, tmp_path, f"jax{n_procs}.tsv")
    return text


def test_torch_two_process_torch_distributed(tmp_path):
    _run_torch_distributed(tmp_path, 2, 8, seed=91)


def test_torch_three_process_torch_distributed_uneven(tmp_path):
    """3 real torch.distributed processes over 10 pairs (uneven shards)
    give the byte-identical ordered merge of a 1-process run."""
    out3 = _run_torch_distributed(tmp_path, 3, 10, seed=92)
    pairs = list(generate.generate_pairs(10, 100, error=0.1, seed=92))
    seq = _seq(tmp_path, pairs, "in_ref.seq")
    out1 = str(tmp_path / "out_ref.tsv")
    _align(seq, out1, process_index=0, process_count=1)
    assert _read(out1) == out3


def test_torch_distributed_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    """device=None takes the process's card and raises without one, before
    any shard file is written; without the torchrun environment the
    process is rank 0 of 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert dist.maybe_initialize_distributed() == (0, 1)
    seq = _seq(tmp_path, [("ACGT", "ACGA")])
    out = str(tmp_path / "out.tsv")
    with pytest.raises(RuntimeError, match="cuda"):
        dist.distributed_align(seq, out, PARAMS, process_index=0,
                               process_count=1)
    assert os.listdir(tmp_path) == ["in.seq"]
    assert _align(seq, out, process_index=0, process_count=1) == 1
