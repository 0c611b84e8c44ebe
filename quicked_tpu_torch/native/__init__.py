"""Host C runtime of the port: ctypes bindings over libquicked_host.

The port's copy of quicked_tpu/native/__init__.py, carrying only the
entries the port and `chip_smoke.py` use: the record expansion of the
on-device traceback (`expand_colruns`), the CIGAR helpers of `cigar.Cigar`
(`cigar_score_edit`, `cigar_sprint`, `cigar_check`), and the host C
cascade that `chip_smoke.py` holds the port to (`quicked_batch`,
`hirschberg`, `banded_score_batch` through `run_banded_native`, and its
windowed bound `windowed_score`).

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
_i64 = ctypes.c_int64
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)


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


def default_threads() -> int:
    """Threads of a batched native call: every core this process may use."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except (AttributeError, OSError):
        return os.cpu_count() or 1


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


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            print("quicked_tpu_torch: host C library unavailable (no C "
                  "compiler)", file=sys.stderr)
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
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
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8bytes(s: bytes):
    return ctypes.cast(ctypes.c_char_p(s), _u8p)


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


def run_banded_native(batch):
    """The score-only banded pass of a BandedBatch through the C kernel
    (quicked_tpu/ops/banded_native.py:run_banded_native): ONE native call
    for the whole batch, then a vectorised scatter into the fill's output
    layout, as u32 lo/hi planes."""
    assert not batch.full, "native path is score-only"
    assert batch.enc_patterns is not None, "batch lacks host sequences"
    B, EBB, K = batch.B, batch.EBB, batch.K
    n = len(batch.enc_patterns)

    scores_by_k = np.empty((K + 1, B), dtype=np.int32)
    # padded lanes / untouched rows: the init formula (k - prolog + 1)*64
    k_idx = np.arange(K + 1, dtype=np.int64)[:, None]
    scores_by_k[:] = ((k_idx - batch.prolog[None, :] + 1) * 64)
    pv_lo = np.full((EBB, B), 0xFFFFFFFF, dtype=np.uint32)
    pv_hi = np.full((EBB, B), 0xFFFFFFFF, dtype=np.uint32)
    mv_lo = np.zeros((EBB, B), dtype=np.uint32)
    mv_hi = np.zeros((EBB, B), dtype=np.uint32)
    first = batch.first0.astype(np.int32).copy()
    last = batch.last0.astype(np.int32).copy()

    res = banded_score_batch(
        batch.enc_patterns, batch.enc_texts,
        batch.cutoff[:n].astype(np.int64), batch.tfinish[:n],
        want_state=True)
    first[:n] = res["first"]
    last[:n] = res["last"]
    # per-pair ebb can differ; scatter with a column mask
    ebb = res["ebb"]
    rows = np.arange(res["pv"].shape[1], dtype=np.int64)
    live = rows[None, :] < ebb[:, None]          # (n, ebb_cap)
    m_rows = min(res["pv"].shape[1], EBB)
    lv = live[:, :m_rows].T                      # (m_rows, n)
    pvT = res["pv"][:, :m_rows].T
    mvT = res["mv"][:, :m_rows].T
    np.copyto(pv_lo[:m_rows, :n], (pvT & np.uint64(0xFFFFFFFF))
              .astype(np.uint32), where=lv)
    np.copyto(pv_hi[:m_rows, :n], (pvT >> np.uint64(32))
              .astype(np.uint32), where=lv)
    np.copyto(mv_lo[:m_rows, :n], (mvT & np.uint64(0xFFFFFFFF))
              .astype(np.uint32), where=lv)
    np.copyto(mv_hi[:m_rows, :n], (mvT >> np.uint64(32))
              .astype(np.uint32), where=lv)
    m = min(res["scores"].shape[1], K + 1)
    scores_by_k[:m, :n] = res["scores"][:, :m].T

    return dict(scores_by_k=scores_by_k, pv_lo=pv_lo, pv_hi=pv_hi,
                mv_lo=mv_lo, mv_hi=mv_hi, first=first, last=last)


def _pack_pairs_interleaved(patterns, texts) -> bytes:
    """Pack pattern/text pairs interleaved into ONE bytes buffer with
    dna-text semantics (non-ASCII -> replacement, 1 byte per char)."""
    from itertools import chain

    def as_bytes(s):
        if isinstance(s, str):
            return s.encode("ascii", "replace")
        if isinstance(s, (bytes, bytearray)):
            return bytes(s)
        return np.asarray(s, dtype=np.uint8).tobytes()

    if patterns and isinstance(patterns[0], str):
        try:
            return "".join(chain.from_iterable(zip(patterns, texts))) \
                .encode("ascii", "replace")
        except TypeError:
            pass            # mixed input kinds: per-element path
    return b"".join(as_bytes(s) for pair in zip(patterns, texts)
                    for s in pair)


def quicked_batch(patterns, texts, *, bandwidth: int, window_size: int,
                  overlap_size: int, hew_threshold, hew_percentage,
                  budget: int, n_threads: int | None = None,
                  rle: bool = False):
    """Full QuickEd cascade over a batch in ONE native call (pthread pool
    inside).

    Returns (status int64 array, scores int64 array, ops list). status 0:
    fully aligned in C (ops = the op string, or its RLE text with `rle`;
    score = edit score); status 1: band footprint exceeded the Hirschberg
    budget, score holds the proven bound and ops is None.
    """
    lib = _load()
    n = len(patterns)
    lengths = np.empty(2 * n, dtype=np.int64)
    lengths[0::2] = np.fromiter(map(len, patterns), np.int64, n)
    lengths[1::2] = np.fromiter(map(len, texts), np.int64, n)
    offsets = np.zeros(2 * n, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    status, scores, (arr, off, ln) = _quicked_batch_run(
        lib, _pack_pairs_interleaved(patterns, texts), offsets, lengths,
        bandwidth=bandwidth, window_size=window_size,
        overlap_size=overlap_size, hew_threshold=hew_threshold,
        hew_percentage=hew_percentage, budget=budget,
        n_threads=n_threads or default_threads(), rle=rle)
    raw = arr.tobytes()
    ops = [raw[o:o + k].decode("ascii") if st == 0 else None
           for o, k, st in zip(off.tolist(), ln.tolist(), status.tolist())]
    return status, scores, ops


def _quicked_batch_run(lib, buf, offsets, lengths, *, bandwidth,
                       window_size, overlap_size, hew_threshold,
                       hew_percentage, budget, n_threads, rle):
    """One native cascade call over a chunk: `offsets`/`lengths` are
    contiguous (2*n,) arrays with offsets into `buf`."""
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
        out_caps = 3 * pair_caps + 16
        out_off = np.zeros(n, dtype=np.int64)
        if n > 1:
            np.cumsum(out_caps[:-1], out=out_off[1:])
        out_arr = np.empty(max(int(out_caps.sum()), 1), dtype=np.uint8)
        out_len = np.zeros(n, dtype=np.int64)
        lib.qh_cigar_sprint_batch(
            ops_buf, arr(ops_off), arr(ops_len), n, 1,
            out_arr.ctypes.data_as(ctypes.c_char_p), arr(out_off),
            arr(out_len), n_threads)
        return status, scores, (out_arr, out_off, out_len)
    return status, scores, (ops_arr, ops_off, ops_len)


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
