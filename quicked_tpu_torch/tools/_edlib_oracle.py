"""edlib ground-truth oracle access for the benchmark CLI.

The counterpart of quicked_tpu/tools/_edlib_oracle.py. The reference
vendors edlib in-process as its `--check` oracle and its `-a edlib`
comparison algorithm (benchmark_check.c:117-158,
benchmark_edit.c:339-372). Here the equivalent is an out-of-process
shim (tools/oracle_src/edlib_oracle.cpp, built against the reference's
vendored edlib) found at `<repo>/.oracle/bin/edlib_oracle`; the port
never builds it. When it is absent, callers fall back to the exact-DP
oracle for scores.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

from quicked_tpu_torch import seqio

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_edlib_oracle() -> str | None:
    p = os.path.join(_REPO, ".oracle", "bin", "edlib_oracle")
    return p if os.path.exists(p) else None


def edlib_batch(pairs, bandwidth: int = -1):
    """Align a batch with edlib; returns list[(score, rle_cigar)] in
    input order, or None when the oracle is unavailable."""
    exe = find_edlib_oracle()
    if not exe:
        return None
    with tempfile.TemporaryDirectory() as td:
        seq = os.path.join(td, "in.seq")
        seqio.write_seq_pairs(seq, pairs)
        try:
            out = subprocess.run([exe, seq, str(bandwidth)],
                                 check=True, capture_output=True,
                                 text=True).stdout
        except subprocess.CalledProcessError:
            return None
    res = []
    for line in out.splitlines():
        score_s, cigar = line.split("\t", 1)
        res.append((int(score_s), cigar))
    if len(res) != len(pairs):
        return None
    return res
