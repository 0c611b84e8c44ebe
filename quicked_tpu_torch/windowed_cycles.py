"""Where the windowed full-CIGAR kernel spends its cycles, per pair.

    python3 -m quicked_tpu_torch.windowed_cycles [--pairs N] [--length L]

Run from the repository root on a machine with a CUDA card. It copies
`csrc/windowed_score.cu` with `clock64()` read around each window's fill
(the characters staged and the planes filled), its walk, and the walk's
chunk staging, and with the windows, walked columns, staged chunks and
D-runs counted; builds the copy with the package's own nvcc flags into
build/quicked_tpu_torch/cycles/; and launches it on chip_smoke's 10 kbp
pairs (N pairs x L bp, ws 9, ovl 1, its seeds) with the window in the
scratch and in shared memory. It prints, a line each, the kernel's CUDA-
event time (median of 5), whether its op strings equal the package's
kernel's, and the means per pair of those counts: the cycles are each
warp's own clock, so they include the time its SM spent on other warps.
Exits non-zero if the instrumented kernel's ops differ.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

# (anchor in the full-mode kernel, text put after it): the counters
PROBES = (
    ("  OpRing r{smem, a.ops + (size_t)b * a.LD, a.LD, a.LD};\n",
     "  unsigned long long T0 = clock64(), tf = 0, tw = 0, ts = 0, nwin = 0,"
     " ncol = 0, nst = 0, nd = 0, t1 = 0, t2 = 0;\n"),
    ("  for (int it = 0; it < max_windows && pos_v >= 0 && pos_h >= 0; ++it)"
     " {\n", "    const unsigned long long t0 = clock64();\n"),
    ("    const uint64_t *pv = cur.pv, *mv = cur.mv;\n"
     "    const int32_t *tr = cur.tr, *pr = cur.pr;\n",
     "    t1 = clock64();\n    tf += t1 - t0;\n    ++nwin;\n"),
    ("        wb = vr >> 6;\n", "        t2 = clock64();\n        ++nst;\n"),
    ("        chunk[2 * CHUNK + lane] = mw & ~m_l;\n        __syncwarp();\n",
     "        ts += clock64() - t2;\n"),
    ("            const int bit = vr & 63;\n", "            ++ncol;\n"),
    ("          // a D at the cursor: the D-run, down to the highest zero of"
     " the\n", "          ++ncol;\n          ++nd;\n"),
    ("    pos_h = h_min + hr;\n    __syncwarp();\n",
     "    tw += clock64() - t1;\n"),
    ("  if (lane == 0) a.start[b] = r.lo;\n",
     "  if (lane == 0 && b < QTT_CYCLES_PAIRS) {\n"
     "    unsigned long long* c = qtt_cycles[b];\n"
     "    c[0] = clock64() - T0; c[1] = tf; c[2] = tw; c[3] = ts;\n"
     "    c[4] = nwin; c[5] = ncol; c[6] = nst; c[7] = nd;\n  }\n"),
)
FIELDS = ("total", "fill", "walk", "staging", "windows", "columns", "chunks",
          "druns")


def instrument(src: str, pairs: int) -> str:
    """The source with the counters of PROBES and an entry that copies them
    out (qtt_cycles_read)."""
    for anchor, text in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    head = (f"#define QTT_CYCLES_PAIRS {pairs}\n__device__ unsigned long long "
            f"qtt_cycles[QTT_CYCLES_PAIRS][{len(FIELDS)}];\n")
    tail = ('\nextern "C" int qtt_cycles_read(void* host) {\n'
            "  return (int)cudaMemcpyFromSymbol(host, qtt_cycles, "
            "sizeof(qtt_cycles));\n}\n")
    return head + src + tail


def build(pairs: int) -> ctypes.CDLL:
    from quicked_tpu_torch import _build

    out = os.path.join(_build.BUILD_DIR, "cycles")
    os.makedirs(out, exist_ok=True)
    for name in ("qtt_common.cuh", "windowed_score.cu"):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        if name.endswith(".cu"):
            src = instrument(src, pairs)
        with open(os.path.join(out, name), "w") as f:
            f.write(src)
    lib = os.path.join(out, "libqtt_cycles.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
         os.path.join(out, "windowed_score.cu")], capture_output=True,
        text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    return ctypes.CDLL(lib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=1000)
    ap.add_argument("--length", type=int, default=10_000)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("windowed_cycles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from quicked_tpu_torch import generate
    from quicked_tpu_torch.device import stream_ptr
    from quicked_tpu_torch.ops import windowed_cuda as wc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or "nvidia-smi: no output")
    pairs = cs.make_pairs(generate, args.pairs, args.length, cs.SEED + 10)
    st = wc.stage_windowed(wc.prepare_windowed_batch(
        [p for p, _ in pairs], [t for _, t in pairs], window_size=9), "cuda")
    lib = build(len(pairs))
    fn = lib.qtt_windowed_full
    fn.argtypes, fn.restype = wc.WINDOWED_FULL.argtypes, ctypes.c_int
    lib.qtt_cycles_read.argtypes = [ctypes.c_void_p]
    dev = st.peq.device
    ok = True
    for shared in (False, True):
        want = wc.decode_ops(*wc.ops_to_host(*wc._launch_windowed_full(
            st, 9, 1, shared)))
        fl = wc._full_launch(st, 9, 1, shared)
        err = fn(*fl.args, stream_ptr(dev))
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"instrumented kernel: CUDA error {err}")
        same = wc.decode_ops(*wc.ops_to_host(fl.ops, fl.start)) == want
        ok &= same
        counts = np.zeros((len(pairs), len(FIELDS)), dtype=np.uint64)
        lib.qtt_cycles_read(counts.ctypes.data)
        ms = cs.cuda_ms(lambda: fn(*fl.args, stream_ptr(dev)), 5)
        mean = dict(zip(FIELDS, counts.astype(np.float64).mean(0)))
        per_win = {k: round(mean[k] / mean["windows"])
                   for k in ("fill", "walk", "staging")}
        per_col = (mean["walk"] - mean["staging"]) / mean["columns"]
        print(f"[cycles] window in {'shared memory' if shared else 'scratch'}"
              f": {ms:.3f} ms, ops {'equal' if same else 'DIFFER'}; per pair "
              + ", ".join(f"{k} {v:.1f}" for k, v in mean.items())
              + f"; per window {per_win}; walk cycles a column, staging "
              f"excluded, {per_col:.1f}")
        del fl
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
