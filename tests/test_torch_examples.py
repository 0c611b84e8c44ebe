"""The port's examples (examples_torch/), each run as a script on the CPU
(`--device cpu`, the kernels' plain versions) in a subprocess; the
counterpart of tests/test_examples.py, which runs examples/ with JAX."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples_torch", "*.py")))


def test_torch_examples_mirror_examples():
    """One counterpart for each example of the JAX package, importing
    nothing of it or of jax."""
    names = [os.path.basename(p) for p in EXAMPLES]
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "examples", "*.py")))
    for path in EXAMPLES:
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in
                    ("jax", "quicked_tpu")], (path, mods)


@pytest.fixture(scope="module")
def runs():
    """Every example started at once: path -> (exit code, stdout,
    stderr)."""
    procs = {path: subprocess.Popen(
        [sys.executable, path, "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO) for path in EXAMPLES}
    try:
        outs = {path: p.communicate(timeout=300)
                for path, p in procs.items()}
        return {path: (procs[path].returncode,) + outs[path]
                for path in procs}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_torch_example_runs(path, runs):
    rc, out, err = runs[path]
    assert rc == 0, err[-2000:]
    assert "Score:" in out or "scores" in out or "aligned" in out
