"""Host-side lane-loop threading for the host C kernels.

The port's copy of quicked_tpu/utils/host_threads.py. ctypes releases the
GIL during C calls, so per-pair kernels thread across lanes (the host
analogue of the reference's OpenMP batch loop, align_benchmark.c:232-306).
Coarse contiguous chunks keep the pool's dispatch cost small. The worker
count is `native.default_threads()`: an active `native.thread_budget`,
else `QUICKED_TPU_CPU_THREADS`, else every usable core.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor


def map_lanes(fn, n: int, workers: int | None = None) -> None:
    """Run fn(i) for i in range(n), threaded in contiguous chunks."""
    if workers is None:
        from quicked_tpu_torch.native import default_threads

        workers = min(default_threads(), max(n, 1))
    if workers <= 1 or n <= 1:
        for i in range(n):
            fn(i)
        return
    step = -(-n // workers)

    def chunk(w):
        for i in range(w * step, min((w + 1) * step, n)):
            fn(i)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(chunk, range(workers)))
