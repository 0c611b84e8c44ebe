"""Build and load the port's CUDA kernels.

The kernels in `csrc/` have a plain C interface. Each source is compiled
with `nvcc` for Hopper (`sm_90a`), all of them at once in parallel, and
the objects are linked into one shared library loaded with `ctypes`. The
build runs at first use, never at import: it needs the CUDA toolkit,
which only a machine with a card has. The library lands in
`build/quicked_tpu_torch/` at the repository root, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads what is already there.

Every C entry launches on the stream it is given, allocates nothing and
returns `cudaGetLastError()`; `Kernel.launch` raises if that is not 0.
`Kernel.launch` calls the entry with the card of the kernel's tensors as
the current CUDA device and that card's current stream: the runtime
launches on the current device, and an entry's `cudaFuncSetAttribute`
(the shared-memory opt-in) applies to the current device only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from quicked_tpu_torch.device import stream_ptr

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "quicked_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: seconds the last build (or load of a cached build) took
build_seconds: float | None = None
#: source file name -> what `-Xptxas -v` printed for it (registers, shared
#: memory, spills per kernel), filled when this process built the library
ptxas_report: dict[str, str] = {}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "quicked_tpu_torch need the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libqtt_{h.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}"
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for src, proc in zip((s for s in _sources() if s.endswith(".cu")),
                         procs):
        out, _ = proc.communicate()
        ptxas_report[os.path.basename(src)] = out
        if proc.returncode != 0:
            errors.append(out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    proc = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.so", *objs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + proc.stdout + proc.stderr)
    for obj in objs:
        os.remove(obj)
    os.replace(f"{tmp}.so", path)


def register_report(name: str) -> str:
    """What `nvcc -Xptxas -v` prints for the source `name` in `csrc/`
    (registers, shared memory and spills per kernel): kept from this
    process's build, else compiled once more to no output."""
    if name not in ptxas_report:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", os.devnull,
             os.path.join(CSRC_DIR, name)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                               f"{proc.stderr}")
        ptxas_report[name] = proc.stdout + proc.stderr
    return ptxas_report[name]


def load() -> ctypes.CDLL:
    """Build the kernel library if needed and load it (once per process)."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _compile(path)
        lib = ctypes.CDLL(path)
        lib.qtt_error_string.restype = ctypes.c_char_p
        lib.qtt_error_string.argtypes = [ctypes.c_int]
        build_seconds = time.perf_counter() - t0
        _lib = lib
        return _lib


P = ctypes.c_void_p     # device pointer or stream
I = ctypes.c_int


class Kernel:
    """One C entry of the kernel library and its count of launches.

    `launches` grows by one each time the kernel is launched and by
    nothing else; a run resets it to see which kernels it went through.
    `fallbacks` counts the lanes a kernel handed to its exact fallback
    (the systolic kernel's ABORT lanes).
    """

    def __init__(self, symbol: str, argtypes: list):
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.fallbacks = 0
        self._fn = None

    def launch(self, device, *args) -> None:
        """Launch on `device`, the card that holds the kernel's tensors:
        under a `torch.cuda.device` guard of that card, with its current
        stream as the entry's last argument."""
        if self._fn is None:
            lib = load()
            fn = getattr(lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        with torch.cuda.device(device):
            err = self._fn(*args, stream_ptr(device))
        self.launches += 1
        if err != 0:
            msg = load().qtt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
