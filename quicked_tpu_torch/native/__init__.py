"""Host C runtime of the port: ctypes bindings over libquicked_host.

The port's copy of quicked_tpu/native/__init__.py, every entry of it: the
record expansion of the on-device traceback (`expand_colruns`), the host
walk of band planes read back from the full fill (`traceback_banded`,
`traceback_banded_batch`), the CIGAR helpers (`cigar_score_edit`,
`cigar_sprint`, `cigar_check`, `cigar_sam`), the banded, windowed and
Hirschberg kernels (`banded_score`, `banded_score_batch`,
`banded_align_full`, `windowed_score`, `windowed_full`, `hirschberg`),
the one-call cascade (`quicked_batch`, pipelined in chunks and returning
a `LazyOpsList`; `align_one` for one pair), the `.seq` parser
(`read_seq_batch`), `encode_dna`, and the process-wide controls of the
host lanes (`thread_budget`, `default_threads`, `set_force_scalar`,
`simd_pass_count`).

Heap settings. The JAX package raises glibc's mmap and trim thresholds at
load (`_retain_large_allocations`) and touches 128 MiB of heap once before
the first large batch (`_ensure_prefault`), so that the batch lanes'
scratch buffers are reused warm instead of being faulted in afresh by
their worker threads. Both are settings of the whole process, and torch's
host tensors come from the same glibc heap, so here both are off unless
MALLOC_RETAIN is set: on the H100 card's host a fresh process's first
cascade call was as close to its warm calls without them as with them
(chip_smoke phase 10(d), PERF.md). Likewise `quicked_batch` runs one call
unless a batch exceeds 2 x BATCH_CHUNK_BASES bases: its pipelined chunks
saved no peak RSS there and mostly ran slower than one call. The JAX package's switches for these
(QUICKED_TPU_MALLOC_RETAIN, QUICKED_TPU_MALLOC_PREFAULT_MB,
QUICKED_TPU_BATCH_CHUNK_BASES) are the module constants MALLOC_RETAIN,
MALLOC_PREFAULT_MB and BATCH_CHUNK_BASES here.

`src/quicked_host.c` is a copy of quicked_tpu/native/src/quicked_host.c.
The shared library is built at first use with the system C compiler into
`build/quicked_tpu_torch/` at the repository root, named by a hash of the
source, the compiler flags and the host's CPU (the build is tuned with
`-march=native`, so a library built on another host is never loaded), and
published there by an atomic rename; it is never built inside the
package. `available()` is False where no C compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading

import numpy as np

from quicked_tpu_torch._build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "quicked_host.c")

_lock = threading.Lock()
_lib = None
_tried = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)

# Retain large heap allocations and pre-fault the heap (off: see the
# module docstring); the megabytes touched once before the first large
# batch when they are on; the bases of a `quicked_batch` chunk, past twice
# which a batch is pipelined (the JAX package's is 8 MiB; here only a
# batch whose packed input alone is gigabytes is chunked).
MALLOC_RETAIN = False
MALLOC_PREFAULT_MB = 128
BATCH_CHUNK_BASES = 1 << 30


# tried in order: -march=native roughly doubles the SIMD banded kernel;
# the portable build is for toolchains that reject it
_FLAG_SETS = (("-O3", "-march=native"), ("-O3",))


def _host_cpu() -> str:
    """The host's CPU model and feature flags, as -march=native sees them."""
    lines = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                lines.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    return "|".join((platform.machine(), lines.get("model name", ""),
                     lines.get("flags", "")))


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(repr(_FLAG_SETS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR,
                        f"libquicked_host_{h.hexdigest()[:16]}.so")


# Per-thread default-thread-count override (see thread_budget): lets a
# caller bound the host lanes of its native calls without touching the
# process environment.
_tls = threading.local()


def usable_cores() -> int:
    """Cores this process may run on (affinity-aware: a process pinned to
    2 of 64 cores must not size its pools for 64)."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def default_threads() -> int:
    """Threads of a batched native call: the active thread_budget if set,
    else QUICKED_TPU_CPU_THREADS, else every usable core."""
    budget = getattr(_tls, "budget", None)
    if budget is not None:
        return budget
    env = os.environ.get("QUICKED_TPU_CPU_THREADS")
    if env is not None:
        return int(env)
    return usable_cores()


class thread_budget:
    """Context manager bounding this thread's native-call thread use."""

    def __init__(self, n: int):
        self._n = max(int(n), 1)

    def __enter__(self):
        self._prev = getattr(_tls, "budget", None)
        _tls.budget = self._n
        return self

    def __exit__(self, *exc):
        _tls.budget = self._prev
        return False


def _build(path: str) -> bool:
    # Compile to a private temp path and publish with an atomic rename: a
    # timed-out cc or a concurrent build in another process must never
    # leave a partial .so at the final path.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.build{os.getpid()}"
    for cc in ("cc", "gcc", "clang"):
        for flags in _FLAG_SETS:
            try:
                subprocess.run(
                    [cc, *flags, "-shared", "-fPIC", "-pthread", "-o", tmp,
                     _SRC], check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
                return True
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired, OSError):
                continue
    try:
        os.remove(tmp)
    except OSError:
        pass
    return False


def _retain_large_allocations():
    """Raise glibc's mmap and trim thresholds to 1 GiB, so that the batch
    lanes' large scratch buffers (packed sequences, op buffers, RLE text)
    are reused from the heap instead of unmapped on every free: pages
    touched for the first time fault in slowly, and erratically, on a
    virtual machine, and retained pages make warm batch calls steady.
    Process-wide; a no-op without glibc's mallopt or when MALLOC_RETAIN is
    False, the default."""
    if not MALLOC_RETAIN:
        return
    try:
        libc = ctypes.CDLL(None)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):
        pass


_prefaulted = False


def _ensure_prefault():
    """Touch MALLOC_PREFAULT_MB of heap once, in order, from this thread:
    the batch workers faulting the same pages later, in random order and
    all at once, contend on the address space's lock, and that was the
    largest cost of a cold large batch in the JAX package. Called before
    the first large batch, so small calls never pay it; a no-op unless
    MALLOC_RETAIN is set."""
    global _prefaulted
    if _prefaulted:
        return
    _prefaulted = True
    if not MALLOC_RETAIN or MALLOC_PREFAULT_MB <= 0:
        return
    try:
        libc = ctypes.CDLL(None)
        libc.malloc.restype = ctypes.c_void_p
        p = libc.malloc(MALLOC_PREFAULT_MB << 20)
        if p:
            ctypes.memset(p, 0, MALLOC_PREFAULT_MB << 20)
            libc.free(ctypes.c_void_p(p))
    except (OSError, AttributeError):
        pass


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        _retain_large_allocations()
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            print("quicked_tpu_torch: host C library unavailable (no C "
                  "compiler)", file=sys.stderr)
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.qh_encode_dna.argtypes = [_u8p, _i64, _u8p]
        lib.qh_traceback_banded.restype = _i64
        lib.qh_traceback_banded.argtypes = [
            _u32p, _u32p, _u32p, _u32p, _i64, _i64, _i64,
            _u8p, _i64, _u8p, _i64, _i64, ctypes.c_char_p]
        lib.qh_traceback_banded_batch.restype = _i64
        lib.qh_traceback_banded_batch.argtypes = [
            _u32p, _u32p, _u32p, _u32p, _i64, _i64, _i64,
            _u8p, _i64p, _i64p, _u8p, _i64p, _i64p,
            _i64p, _i64, ctypes.c_char_p, _i64p, _i64p, _i64]
        lib.qh_cigar_sam.restype = _i64
        lib.qh_cigar_sam.argtypes = [ctypes.c_char_p, _i64, _u32p]
        # the buffer is a c_void_p, so that a caller can pass an address
        # into a bytes object without slicing it
        lib.qh_read_seq_batch.restype = _i64
        lib.qh_read_seq_batch.argtypes = [
            ctypes.c_void_p, _i64, _i64, ctypes.c_char_p, _i64,
            _i64p, _i64p, _i64p]
        lib.qh_banded_score_mt.restype = _i64
        lib.qh_banded_score_mt.argtypes = [
            _u8p, _i64, _u8p, _i64, _i64, _i64,
            _u64p, _u64p, _i64p, _i64p, _i64p, _i64p, _i64]
        lib.qh_align.restype = _i64
        lib.qh_align.argtypes = [
            _i64, _u8p, _i64, _u8p, _i64,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _i64p, ctypes.c_char_p, _i64p]
        lib.qh_cigar_score_edit.restype = _i64
        lib.qh_cigar_score_edit.argtypes = [ctypes.c_char_p, _i64]
        lib.qh_cigar_check.restype = ctypes.c_int
        lib.qh_cigar_check.argtypes = [ctypes.c_char_p, _i64, _u8p, _i64,
                                       _u8p, _i64]
        lib.qh_cigar_sprint.restype = _i64
        lib.qh_cigar_sprint.argtypes = [ctypes.c_char_p, _i64,
                                        ctypes.c_int, ctypes.c_char_p]
        lib.qh_quicked_batch.restype = _i64
        lib.qh_quicked_batch.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64,
            _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64, _i64,
            _i64p, _i64p, ctypes.c_char_p, _i64p, _i64p]
        lib.qh_cigar_sprint_batch.restype = _i64
        lib.qh_cigar_sprint_batch.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64, _i64,
            ctypes.c_char_p, _i64p, _i64p, _i64]
        lib.qh_banded_score_batch.restype = _i64
        lib.qh_banded_score_batch.argtypes = [
            _u8p, _i64p, _i64p, _i64p, _i64p, _i64p, _i64p,
            _i64, _i64, _i64, _i64p,
            _u64p, _u64p, _i64, _i64p, _i64p, _i64p, _i64, _i64p]
        lib.qh_hirschberg.restype = _i64
        lib.qh_hirschberg.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64,
            ctypes.c_char_p, _i64p]
        lib.qh_windowed_score.restype = _i64
        lib.qh_windowed_score.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64, _i64, _i64p]
        lib.qh_windowed_full.restype = _i64
        lib.qh_windowed_full.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64, _i64,
            ctypes.c_char_p]
        _u16p = ctypes.POINTER(ctypes.c_uint16)
        _i8p = ctypes.POINTER(ctypes.c_int8)
        _i32p = ctypes.POINTER(ctypes.c_int32)
        lib.qh_expand_colruns_batch.restype = _i64
        lib.qh_expand_colruns_batch.argtypes = [
            _u16p, _i8p, _i32p, _i32p, _i64, _i64,
            ctypes.c_char_p, _i64p, _i64p]
        lib.qh_banded_align_full.restype = _i64
        lib.qh_banded_align_full.argtypes = [
            _u8p, _u8p, _i64, _u8p, _u8p, _i64, _i64,
            ctypes.c_char_p, _i64p]
        lib.qh_set_force_scalar.restype = None
        lib.qh_set_force_scalar.argtypes = [ctypes.c_int]
        lib.qh_get_force_scalar.restype = ctypes.c_int
        lib.qh_get_force_scalar.argtypes = []
        lib.qh_simd_pass_count.restype = _i64
        lib.qh_simd_pass_count.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8bytes(s: bytes):
    return ctypes.cast(ctypes.c_char_p(s), _u8p)


def _u32arr(a: np.ndarray):
    assert a.dtype == np.uint32 and a.flags.c_contiguous
    return a.ctypes.data_as(_u32p)


def traceback_banded(mat_pv_lo, mat_pv_hi, mat_mv_lo, mat_mv_hi,
                     lane: int, pattern_raw: bytes, text_raw: bytes,
                     prolog: int) -> str:
    """Traceback one lane of the batched (T, EBB, B) u32 band planes."""
    lib = _load()
    T, ebb, nlanes = mat_pv_lo.shape
    plen, tlen = len(pattern_raw), len(text_raw)
    out = ctypes.create_string_buffer(plen + tlen + 1)
    n = lib.qh_traceback_banded(
        _u32arr(mat_pv_lo), _u32arr(mat_pv_hi),
        _u32arr(mat_mv_lo), _u32arr(mat_mv_hi),
        ebb, nlanes, lane,
        _u8bytes(pattern_raw), plen, _u8bytes(text_raw), tlen,
        prolog, out)
    return out.raw[:n].decode("ascii")


def traceback_banded_batch(mats_tiled, lanes: int, praws: list,
                           traws: list, prologs) -> list:
    """Traceback EVERY pair of a lane-tiled plane set in one native call
    (pthread pool inside): the four u32 planes are (P, T, EBB, lanes), and
    pair i walks tile i // lanes, lane i % lanes. praws/traws are the
    pairs' raw byte strings (str is encoded with dna-text semantics:
    non-ASCII to the replacement byte); returns op strings in order."""
    lib = _load()
    pv_lo, pv_hi, mv_lo, mv_hi = mats_tiled
    P, T, ebb, nlanes = pv_lo.shape
    assert nlanes == lanes
    praws = [p.encode("ascii", "replace") if isinstance(p, str) else p
             for p in praws]
    traws = [t.encode("ascii", "replace") if isinstance(t, str) else t
             for t in traws]
    n = len(praws)
    pat_len = np.fromiter((len(p) for p in praws), np.int64, n)
    txt_len = np.fromiter((len(t) for t in traws), np.int64, n)
    pat_off = np.zeros(n, np.int64)
    np.cumsum(pat_len[:-1], out=pat_off[1:])
    txt_off = np.zeros(n, np.int64)
    np.cumsum(txt_len[:-1], out=txt_off[1:])
    caps = pat_len + txt_len
    ops_off = np.zeros(n, np.int64)
    np.cumsum(caps[:-1], out=ops_off[1:])
    pat_blob = b"".join(praws)
    txt_blob = b"".join(traws)
    ops_blob = ctypes.create_string_buffer(int(caps.sum()) + 1)
    ops_len = np.zeros(n, np.int64)
    prolog_arr = np.asarray(prologs, dtype=np.int64)

    def i64p(a):
        return a.ctypes.data_as(_i64p)

    _ensure_prefault()
    planes = [np.ascontiguousarray(a).reshape(P * T, ebb, nlanes)
              for a in (pv_lo, pv_hi, mv_lo, mv_hi)]
    rc = lib.qh_traceback_banded_batch(
        _u32arr(planes[0][0]), _u32arr(planes[1][0]),
        _u32arr(planes[2][0]), _u32arr(planes[3][0]),
        T * ebb * nlanes, ebb, nlanes,
        _u8bytes(pat_blob), i64p(pat_off), i64p(pat_len),
        _u8bytes(txt_blob), i64p(txt_off), i64p(txt_len),
        i64p(prolog_arr), n,
        ops_blob, i64p(ops_off), i64p(ops_len),
        default_threads())
    assert rc == 0, rc
    raw = ops_blob.raw
    return [raw[int(ops_off[i]):int(ops_off[i]) + int(ops_len[i])]
            .decode("ascii") for i in range(n)]


def expand_colruns(runs_bt: np.ndarray, opcs_bt: np.ndarray,
                   v_fin: np.ndarray, h_fin: np.ndarray):
    """Expand (n, T) device-traceback records into one packed op-byte
    buffer + per-lane (offset, length) (numpy fallback:
    ops/banded_traceback_cuda.records_to_packed). Returns
    (flat uint8, offs int64, lens int64) or None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    runs_bt = np.ascontiguousarray(runs_bt, dtype=np.uint16)
    opcs_bt = np.ascontiguousarray(opcs_bt, dtype=np.int8)
    v_fin = np.ascontiguousarray(v_fin, dtype=np.int32)
    h_fin = np.ascontiguousarray(h_fin, dtype=np.int32)
    n, T = runs_bt.shape
    offs = np.empty(n, dtype=np.int64)
    lens = np.empty(n, dtype=np.int64)
    _u16 = ctypes.POINTER(ctypes.c_uint16)
    _i8 = ctypes.POINTER(ctypes.c_int8)
    _i32 = ctypes.POINTER(ctypes.c_int32)
    args = (runs_bt.ctypes.data_as(_u16), opcs_bt.ctypes.data_as(_i8),
            v_fin.ctypes.data_as(_i32), h_fin.ctypes.data_as(_i32),
            n, T)
    total = lib.qh_expand_colruns_batch(
        *args, None, offs.ctypes.data_as(_i64p),
        lens.ctypes.data_as(_i64p))
    flat = np.empty(int(total), dtype=np.uint8)
    lib.qh_expand_colruns_batch(
        *args, flat.ctypes.data_as(ctypes.c_char_p),
        offs.ctypes.data_as(_i64p), lens.ctypes.data_as(_i64p))
    return flat, offs, lens


def set_force_scalar(v: bool) -> None:
    """Runtime SIMD toggle of the host C banded kernels (the reference's
    force_scalar, bpm_banded.c:1049-1059): the scalar column loop instead
    of the 4-column vector pipeline. Process-wide; a no-op when the
    library is unavailable."""
    lib = _load()
    if lib is not None:
        lib.qh_set_force_scalar(1 if v else 0)


def get_force_scalar() -> bool:
    lib = _load()
    return bool(lib.qh_get_force_scalar()) if lib is not None else False


def simd_pass_count() -> int:
    """Vector 4-column passes run so far in this process: the observable
    that shows force_scalar switched the kernels' path."""
    lib = _load()
    return int(lib.qh_simd_pass_count()) if lib is not None else 0


def banded_align_full(pattern_enc: np.ndarray, pattern_raw: bytes,
                      text_enc: np.ndarray, text_raw: bytes,
                      cutoff_score: int):
    """Host-native BandEd full alignment (fill + traceback).
    Returns (score, ops_str)."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    score = ctypes.c_int64()
    n = lib.qh_banded_align_full(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        cutoff_score, ops, ctypes.byref(score))
    if n < 0:
        raise MemoryError("qh_banded_align_full: allocation failed")
    return int(score.value), ops.raw[:n].decode("ascii")


def cigar_score_edit(ops: str) -> int:
    lib = _load()
    b = ops.encode("ascii")
    return int(lib.qh_cigar_score_edit(b, len(b)))


def cigar_check(ops: str, pattern: bytes, text: bytes) -> bool:
    lib = _load()
    b = ops.encode("ascii")
    return bool(lib.qh_cigar_check(b, len(b), _u8bytes(pattern),
                                   len(pattern), _u8bytes(text), len(text)))


def cigar_sprint(ops: str, print_matches: bool) -> str:
    lib = _load()
    b = ops.encode("ascii")
    out = ctypes.create_string_buffer(12 * max(len(b), 1))
    n = lib.qh_cigar_sprint(b, len(b), int(print_matches), out)
    return out.raw[:n].decode("ascii")


def cigar_sam(ops: str) -> np.ndarray:
    """The SAM CIGAR of an op string as packed u32 (length << 4 | op)."""
    lib = _load()
    b = ops.encode("ascii")
    out = np.empty(max(len(b), 1), dtype=np.uint32)
    n = lib.qh_cigar_sam(b, len(b), _u32arr(out))
    return out[:n].copy()


def banded_score(pattern_enc: np.ndarray, text_enc: np.ndarray,
                 cutoff_score: int, text_len: int, text_finish: int,
                 want_state: bool = False, n_threads: int = 1):
    """Host-native BandEd score-only for one pair. Returns the score, or
    with want_state a dict of the lane's state as the fill outputs it (pv/mv
    u64 band words, first/last, scores by shifted row). n_threads > 1 runs
    the bit-exact threaded wavefront (row strips) inside the pair's
    band."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    if not want_state:
        return int(lib.qh_banded_score_mt(
            p.ctypes.data_as(_u8p), len(p), t.ctypes.data_as(_u8p),
            text_finish, text_len, cutoff_score,
            None, None, None, None, None, None, int(n_threads)))
    # conservative capacities (see qh_banded_score)
    k_end = abs(text_len - len(p)) + 1
    cutoff = max(k_end, cutoff_score, 65)
    ebb_cap = cutoff // 64 + 2
    diff = len(p) - text_len
    rel = -(-(cutoff - abs(diff)) // 2)
    prolog = -(-rel // 64) if diff >= 0 else -(-(rel - diff) // 64)
    nb_total = max(-(-text_finish // 64), 1)
    n_rows = prolog + nb_total + ebb_cap + 2
    # the C kernel extends its rows to cover the pattern's final block
    # (init-valued) when text_finish << plen; size the buffer to match
    plen = len(p)
    fb = plen // 64 if plen % 64 else max(plen - 1, 0) // 64
    n_rows = max(n_rows, fb + prolog + 1)
    pv = np.empty(ebb_cap, dtype=np.uint64)
    mv = np.empty(ebb_cap, dtype=np.uint64)
    # pre-filled with the kernel's own init formula (r - prolog + 1) * 64:
    # ebb_cap can exceed its row count by one, and an np.empty tail row
    # would leak into the scores
    scores = ((np.arange(n_rows, dtype=np.int64) - prolog + 1) * 64)
    first = ctypes.c_int64()
    last = ctypes.c_int64()
    ebb = ctypes.c_int64()
    score = int(lib.qh_banded_score_mt(
        p.ctypes.data_as(_u8p), len(p), t.ctypes.data_as(_u8p),
        text_finish, text_len, cutoff_score,
        pv.ctypes.data_as(_u64p), mv.ctypes.data_as(_u64p),
        ctypes.byref(first), ctypes.byref(last),
        scores.ctypes.data_as(_i64p), ctypes.byref(ebb), int(n_threads)))
    return dict(score=score, pv=pv[:ebb.value], mv=mv[:ebb.value],
                first=int(first.value), last=int(last.value),
                scores=scores, prolog=prolog, ebb=int(ebb.value))


def banded_score_batch(enc_patterns, enc_texts, cutoffs, tfinishes,
                       want_state: bool = False,
                       n_threads: int | None = None):
    """Batched score-only BandEd through ONE native call (pthread pool
    inside). Returns scores int64 (n,), or with want_state a dict of
    strided per-lane state arrays:
      pv/mv (n, ebb_stride) u64, first/last/ebb (n,),
      scores (n, rows_stride) indexed by row + prolog_i.
    """
    lib = _load()
    n = len(enc_patterns)
    if n_threads is None:
        n_threads = default_threads()
    enc_list = [np.ascontiguousarray(e, dtype=np.uint8)
                for pair in zip(enc_patterns, enc_texts) for e in pair]
    lens = np.fromiter(map(len, enc_list), np.int64, 2 * n)
    if int(lens.sum()) > 1 << 18:
        _ensure_prefault()
    offs = np.zeros(2 * n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    buf = b"".join(e.tobytes() for e in enc_list)
    p_off = np.ascontiguousarray(offs[0::2])
    t_off = np.ascontiguousarray(offs[1::2])
    p_len = np.ascontiguousarray(lens[0::2])
    t_len = np.ascontiguousarray(lens[1::2])
    cutoff = np.asarray(cutoffs, dtype=np.int64)
    tfin = np.asarray(tfinishes, dtype=np.int64)
    scores = np.zeros(n, dtype=np.int64)

    def arr(a):
        return a.ctypes.data_as(_i64p)

    if not want_state:
        lib.qh_banded_score_batch(
            _u8bytes(buf), arr(p_off), arr(p_len), arr(t_off), arr(t_len),
            arr(cutoff), arr(tfin), n, n_threads, 0, arr(scores),
            None, None, 0, None, None, None, 0, None)
        return scores
    # strided state buffers sized like the per-pair wrapper (banded_score)
    k_end = np.abs(t_len - p_len) + 1
    eff = np.maximum(np.maximum(k_end, cutoff), 65)
    ebb_cap = int((eff // 64 + 2).max())
    diff = p_len - t_len
    rel = -(-(eff - np.abs(diff)) // 2)
    prolog = np.where(diff >= 0, -(-rel // 64), -(-(rel - diff) // 64))
    nb_total = np.maximum(-(-tfin // 64), 1)
    fb = np.where(p_len % 64 != 0, p_len // 64,
                  np.maximum(p_len - 1, 0) // 64)
    n_rows = np.maximum(prolog + nb_total + ebb_cap + 2,
                        fb + prolog + 1)
    rows_stride = int(n_rows.max())
    pv = np.empty((n, ebb_cap), dtype=np.uint64)
    mv = np.empty((n, ebb_cap), dtype=np.uint64)
    first = np.zeros(n, dtype=np.int64)
    last = np.zeros(n, dtype=np.int64)
    sc_rows = np.empty((n, rows_stride), dtype=np.int64)
    # pre-fill with the init formula so rows beyond a pair's own n_rows
    # hold the deterministic defaults (the C kernel writes its exact
    # row count per pair)
    sc_rows[:] = ((np.arange(rows_stride, dtype=np.int64)[None, :]
                   - prolog[:, None] + 1) * 64)
    ebb = np.zeros(n, dtype=np.int64)
    lib.qh_banded_score_batch(
        _u8bytes(buf), arr(p_off), arr(p_len), arr(t_off), arr(t_len),
        arr(cutoff), arr(tfin), n, n_threads, 1, arr(scores),
        pv.ctypes.data_as(_u64p), mv.ctypes.data_as(_u64p), ebb_cap,
        arr(first), arr(last), arr(sc_rows), rows_stride, arr(ebb))
    return dict(score=scores, pv=pv, mv=mv, first=first, last=last,
                scores=sc_rows, prolog=prolog.astype(np.int64), ebb=ebb)


def windowed_score(pattern_enc: np.ndarray, pattern_raw: bytes,
                   text_enc: np.ndarray, text_raw: bytes,
                   window_size: int, overlap_size: int,
                   hew_threshold: int):
    """Host-native WindowEd score bound. Returns (score, hew)."""
    if window_size > 16:
        raise ValueError(
            f"native windowed kernel supports window_size <= 16 "
            f"(got {window_size}); use the device/python path")
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    hew = ctypes.c_int64()
    score = int(lib.qh_windowed_score(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        window_size, overlap_size, hew_threshold, ctypes.byref(hew)))
    return score, int(hew.value)


def windowed_full(pattern_enc: np.ndarray, pattern_raw: bytes,
                  text_enc: np.ndarray, text_raw: bytes,
                  window_size: int, overlap_size: int) -> str:
    """Host-native WindowEd full-CIGAR mode. Returns the op string."""
    if window_size > 16:
        raise ValueError(
            f"native windowed kernel supports window_size <= 16 "
            f"(got {window_size}); use the device/python path")
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    n = lib.qh_windowed_full(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        window_size, overlap_size, ops)
    return ops.raw[:n].decode("ascii")


class LazyOpsList:
    """Per-pair op or RLE strings decoded lazily from the packed C output
    buffers: building a str a pair for a 100k-pair batch costs more than
    the C alignment of short reads, and a caller that never reads the ops
    (score-only, a benchmark row) skips it. The first access decodes every
    element (one comprehension beats 100k __getitem__ calls); from then on
    it behaves as a plain list. An element is the str for status 0 ("" for
    an empty op string) and None otherwise."""

    __slots__ = ("_segs", "_list", "_n", "_empty_as_none")

    def __init__(self, segs, empty_as_none=False):
        # segs: list of (ops uint8 array, offsets, lengths, status)
        self._segs = segs
        self._n = sum(len(s[3]) for s in segs)
        self._list = None
        self._empty_as_none = empty_as_none

    def _materialize(self):
        if self._list is None:
            out = []
            for arr, off, ln, status in self._segs:
                raw = arr.tobytes()
                if self._empty_as_none:
                    out.extend(
                        (raw[o:o + k].decode("ascii") if k else None)
                        if s == 0 else None
                        for o, k, s in zip(off.tolist(), ln.tolist(),
                                           status.tolist()))
                else:
                    out.extend(
                        raw[o:o + k].decode("ascii") if s == 0 else None
                        for o, k, s in zip(off.tolist(), ln.tolist(),
                                           status.tolist()))
            self._list = out
            self._segs = None
        return self._list

    def segments(self):
        """(ops uint8 array, int64 offsets, int64 lengths) of every element
        as the packed buffers hold them, without decoding; None once
        decoded, or where an element is None (a status other than 0)."""
        if self._segs is None or any(np.any(st) for *_, st in self._segs):
            return None
        if len(self._segs) == 1:
            arr, off, ln, _ = self._segs[0]
            return arr, np.asarray(off, np.int64), np.asarray(ln, np.int64)
        base = np.cumsum([0] + [len(a) for a, *_ in self._segs[:-1]])
        return (np.concatenate([a for a, *_ in self._segs]),
                np.concatenate([np.asarray(o, np.int64) + b for (_, o, *_), b
                                in zip(self._segs, base)]),
                np.concatenate([np.asarray(k, np.int64)
                                for _, _, k, _ in self._segs]))

    def with_empty_as_none(self):
        """The view with the cascade's `x if x else None` normalization."""
        if self._list is not None:
            return [x if x else None for x in self._list]
        return LazyOpsList(self._segs, empty_as_none=True)

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, LazyOpsList):
            other = other._materialize()
        return self._materialize() == other

    def __repr__(self):
        return (f"LazyOpsList(n={self._n}, "
                f"materialized={self._list is not None})")


def _seqs_as_bytes(seqs):
    """A batch of sequences (str, bytes or uint8 arrays) as a list of bytes
    with dna-text semantics (non-ASCII to the replacement byte, which the
    encode table buckets as 'N'): one comprehension for a batch of one
    kind, element by element for a mixed one."""
    if not seqs:
        return []
    first = seqs[0]
    try:
        if isinstance(first, str):
            return [s.encode("ascii", "replace") for s in seqs]
        if isinstance(first, (bytes, bytearray)):
            return [bytes(s) for s in seqs]
    except (AttributeError, TypeError):
        pass            # mixed kinds: element by element below
    return [s.encode("ascii", "replace") if isinstance(s, str)
            else bytes(s) if isinstance(s, (bytes, bytearray))
            else np.asarray(s, dtype=np.uint8).tobytes() for s in seqs]


def quicked_batch(patterns, texts, *, bandwidth: int, window_size: int,
                  overlap_size: int, hew_threshold, hew_percentage,
                  budget: int, n_threads: int | None = None,
                  rle: bool = False):
    """Full QuickEd cascade over a batch through the host C runtime
    (pthread pool inside, no Python per pair).

    Returns (status int64 array, scores int64 array, ops LazyOpsList).
    status 0: fully aligned in C (ops = the op string, or its RLE text with
    `rle`; score = edit score); status 1: the band exceeded the Hirschberg
    budget, score holds the proven bound and the op is None.

    A batch of more than 2 x BATCH_CHUNK_BASES bases runs as chunks of
    about BATCH_CHUNK_BASES, pipelined: chunk k's sequences are packed on
    this thread (the GIL held) while chunk k-1 aligns in C on a worker (the
    GIL released), so that the packed input of only two chunks is held at a
    time."""
    lib = _load()
    n = len(patterns)
    if n_threads is None:
        n_threads = default_threads()
    # lengths from the inputs themselves (ascii-replace is a byte a char);
    # chunks index the packed buffer by offsets
    lengths = np.empty(2 * n, dtype=np.int64)
    lengths[0::2] = np.fromiter(map(len, patterns), np.int64, n)
    lengths[1::2] = np.fromiter(map(len, texts), np.int64, n)
    offsets = np.zeros(2 * n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    kw = dict(bandwidth=bandwidth, window_size=window_size,
              overlap_size=overlap_size, hew_threshold=hew_threshold,
              hew_percentage=hew_percentage, budget=budget,
              n_threads=n_threads, rle=rle)
    chunk_bases = BATCH_CHUNK_BASES
    total_bases = int(lengths.sum())
    if total_bases > 1 << 18:
        _ensure_prefault()
    if n > 1 and total_bases > 2 * chunk_bases:
        from concurrent.futures import ThreadPoolExecutor

        status = np.zeros(n, dtype=np.int64)
        scores = np.zeros(n, dtype=np.int64)
        pair_bases = lengths[0::2] + lengths[1::2]
        ranges = []
        lo = 0
        while lo < n:
            hi, acc = lo, 0
            while hi < n and (hi == lo or acc < chunk_bases):
                acc += int(pair_bases[hi])
                hi += 1
            ranges.append((lo, hi))
            lo = hi
        segs: list = [None] * len(ranges)

        def collect(k, fut):
            c_st, c_sc, c_seg = fut.result()
            l0, h0 = ranges[k]
            status[l0:h0] = c_st
            scores[l0:h0] = c_sc
            segs[k] = c_seg

        with ThreadPoolExecutor(1) as ex:
            fut, fut_k = None, -1
            for k, (lo, hi) in enumerate(ranges):
                cbuf = _pack_pairs_interleaved(patterns[lo:hi],
                                               texts[lo:hi])
                coffs = offsets[2 * lo:2 * hi] - offsets[2 * lo]
                if fut is not None:
                    collect(fut_k, fut)
                fut = ex.submit(_quicked_batch_run, lib, cbuf, coffs,
                                lengths[2 * lo:2 * hi], **kw)
                fut_k = k
            collect(fut_k, fut)
        return status, scores, LazyOpsList(segs)
    st, sc, seg = _quicked_batch_run(
        lib, _pack_pairs_interleaved(patterns, texts), offsets, lengths,
        **kw)
    return st, sc, LazyOpsList([seg])


def _pack_pairs_interleaved(patterns, texts) -> bytes:
    """Pack pattern/text pairs interleaved into ONE bytes buffer with
    dna-text semantics (non-ASCII -> replacement, 1 byte per char): one
    join and one encode for a batch of str."""
    from itertools import chain

    if patterns and isinstance(patterns[0], str):
        try:
            return "".join(chain.from_iterable(zip(patterns, texts))) \
                .encode("ascii", "replace")
        except TypeError:
            pass            # mixed input kinds: per-element path
    pb = _seqs_as_bytes(patterns)
    tb = _seqs_as_bytes(texts)
    return b"".join(b for pair in zip(pb, tb) for b in pair)


def _quicked_batch_run(lib, buf, offsets, lengths, *, bandwidth,
                       window_size, overlap_size, hew_threshold,
                       hew_percentage, budget, n_threads, rle):
    """One native cascade call over a chunk: `offsets`/`lengths` are
    contiguous (2*n,) arrays with offsets into `buf`. Returns (status,
    scores, (ops array, offsets, lengths, status))."""
    n = len(lengths) // 2
    pair_caps = lengths[0::2] + lengths[1::2]
    ops_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(pair_caps[:-1], out=ops_off[1:])
    total_cap = int(pair_caps.sum())
    ops_arr = np.empty(max(total_cap, 1), dtype=np.uint8)
    ops_buf = ops_arr.ctypes.data_as(ctypes.c_char_p)
    scores = np.zeros(n, dtype=np.int64)
    status = np.zeros(n, dtype=np.int64)
    ops_len = np.zeros(n, dtype=np.int64)

    def arr(a):
        return a.ctypes.data_as(_i64p)

    lib.qh_quicked_batch(
        buf, arr(offsets), arr(lengths), n,
        bandwidth, window_size, overlap_size,
        hew_threshold[0], hew_threshold[1],
        hew_percentage[0], hew_percentage[1],
        budget, n_threads,
        arr(scores), arr(status), ops_buf, arr(ops_off), arr(ops_len))
    if rle:
        # one more C pass: RLE-print every CIGAR into a second buffer
        return status, scores, (*_sprint_batch(
            lib, ops_buf, ops_off, ops_len, 1, n_threads), status)
    return status, scores, (ops_arr, ops_off, ops_len, status)


def _sprint_batch(lib, ops_buf, ops_off, ops_len, print_matches: int,
                  n_threads: int):
    """`qh_cigar_sprint_batch` over packed op strings (`ops_buf` a
    c_char_p, `ops_off`/`ops_len` int64 arrays): (out uint8 array,
    offsets, lengths) of every RLE CIGAR. A run of r ops prints its
    count's digits and the op, at most two characters an op."""
    n = len(ops_len)
    out_caps = 3 * ops_len + 16
    out_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(out_caps[:-1], out=out_off[1:])
    out_arr = np.empty(max(int(out_caps.sum()), 1), dtype=np.uint8)
    out_len = np.zeros(n, dtype=np.int64)
    lib.qh_cigar_sprint_batch(
        ops_buf, ops_off.ctypes.data_as(_i64p), ops_len.ctypes.data_as(_i64p),
        n, print_matches, out_arr.ctypes.data_as(ctypes.c_char_p),
        out_off.ctypes.data_as(_i64p), out_len.ctypes.data_as(_i64p),
        n_threads)
    return out_arr, out_off, out_len


def cigar_sprint_packed(ops: np.ndarray, off, lens,
                        print_matches: bool = True) -> LazyOpsList:
    """The RLE CIGAR (`cigar_sprint`) of every op string of a packed
    buffer (`ops` uint8, int64 offsets and lengths into it) in one call
    (threads inside), as a LazyOpsList whose empty strings read as None
    (the cascade's `x if x else None`)."""
    lib = _load()
    ops = np.ascontiguousarray(ops, dtype=np.uint8)
    off = np.ascontiguousarray(off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    out = _sprint_batch(lib, ops.ctypes.data_as(ctypes.c_char_p), off, lens,
                        int(print_matches), default_threads())
    return LazyOpsList([(*out, np.zeros(len(lens), dtype=np.int64))],
                       empty_as_none=True)


def hirschberg(pattern_enc: np.ndarray, pattern_raw: bytes,
               text_enc: np.ndarray, text_raw: bytes,
               cutoff_score: int, budget: int):
    """Host-native Hirschberg full alignment. Returns (status, ops_str):
    status 0 ok, -2 non-convergence (ops = the partial right side)."""
    lib = _load()
    p = np.ascontiguousarray(pattern_enc, dtype=np.uint8)
    t = np.ascontiguousarray(text_enc, dtype=np.uint8)
    ops = ctypes.create_string_buffer(len(p) + len(t) + 1)
    n = ctypes.c_int64()
    st = int(lib.qh_hirschberg(
        p.ctypes.data_as(_u8p), _u8bytes(pattern_raw), len(p),
        t.ctypes.data_as(_u8p), _u8bytes(text_raw), len(t),
        cutoff_score, budget, ops, ctypes.byref(n)))
    return st, ops.raw[:n.value].decode("ascii")


def align_one(algo: int, pattern_raw: bytes, text_raw: bytes, *,
              only_score: bool = False, bandwidth: int = 15,
              window_size: int = 9, overlap_size: int = 1,
              hew_threshold=(40, 40), hew_percentage=(15, 15),
              budget: int = 16 * 1024 * 1024):
    """One pair through the host C runtime's quicked_align (qh_align).
    Returns (status, score, ops str or None)."""
    lib = _load()
    ops = ctypes.create_string_buffer(len(pattern_raw) + len(text_raw) + 1)
    score = ctypes.c_int64()
    n = ctypes.c_int64()
    st = int(lib.qh_align(
        algo, _u8bytes(pattern_raw), len(pattern_raw),
        _u8bytes(text_raw), len(text_raw),
        int(only_score), bandwidth, window_size, overlap_size,
        hew_threshold[0], hew_threshold[1],
        hew_percentage[0], hew_percentage[1], budget,
        ctypes.byref(score), ops, ctypes.byref(n)))
    op_str = ops.raw[:n.value].decode("ascii") if n.value > 0 else None
    return st, int(score.value), op_str


def read_seq_batch(data: bytes, max_pairs: int, offset: int = 0):
    """Parse up to max_pairs two-line .seq records from `data[offset:]`.
    Returns (list of (pattern, text) str pairs, bytes consumed). `offset`
    spares the caller a slice of a multi-megabyte buffer per call."""
    lib = _load()
    remaining = len(data) - offset
    offsets = np.empty(2 * max_pairs, dtype=np.int64)
    lengths = np.empty(2 * max_pairs, dtype=np.int64)
    consumed = ctypes.c_int64(0)
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
    # a modest out buffer first (the parser stops cleanly when it is
    # full); the whole remainder only if one record does not fit
    cap = min(remaining, 4 << 20) + 2
    while True:
        out = ctypes.create_string_buffer(cap)
        n = lib.qh_read_seq_batch(
            ctypes.c_void_p(base + offset), remaining, max_pairs,
            out, cap, offsets.ctypes.data_as(_i64p),
            lengths.ctypes.data_as(_i64p), ctypes.byref(consumed))
        if n > 0 or consumed.value > 0 or cap >= remaining + 2:
            break
        cap = remaining + 2
    pairs = []
    for i in range(n):
        po, pl = int(offsets[2 * i]), int(lengths[2 * i])
        to, tl = int(offsets[2 * i + 1]), int(lengths[2 * i + 1])
        pairs.append((out[po:po + pl].decode("ascii"),
                      out[to:to + tl].decode("ascii")))
    return pairs, int(consumed.value)


def encode_dna(raw: bytes) -> np.ndarray:
    """The host C runtime's 5-letter encoding of `raw` (uint8 codes)."""
    lib = _load()
    out = np.empty(len(raw), dtype=np.uint8)
    lib.qh_encode_dna(_u8bytes(raw), len(raw), out.ctypes.data_as(_u8p))
    return out
