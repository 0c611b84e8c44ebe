"""Runtime memory observability — the port's analogue of the reference's
allocator occupancy report (mm_allocator.c:573-604, which prints
used/free/segment counts per allocator).

The counterpart of quicked_tpu/utils/memreport.py. Device memory here is
PyTorch's caching allocator's, so instead of allocator segments the
report surfaces the quantities the engine budgets against:

- full-fill band-plane bytes per kernel launch (chunked against
  aligner/batch.FULL_FILL_BYTES_BUDGET), count + peak + total;
- the Hirschberg split levels' band words, which stay on the card;
- the Hirschberg base-case buffer budget (params.HIRSCHBERG_BUFFER_SIZE);
- host process RSS / high-water mark (/proc/self/status);
- the CUDA device's allocated, peak and free memory.

Engine sites call record(kind, nbytes); memory_report() snapshots, and
print_report() renders the reference-style block (align_benchmark's
--memory-report flag)."""

from __future__ import annotations

import sys
import threading

_LOCK = threading.Lock()
_STATS: dict = {}          # kind -> {count, bytes, peak}


def record(kind: str, nbytes: int) -> None:
    """Record one budgeted allocation of `nbytes` under `kind`."""
    with _LOCK:
        st = _STATS.setdefault(kind, {"count": 0, "bytes": 0, "peak": 0})
        st["count"] += 1
        st["bytes"] += int(nbytes)
        st["peak"] = max(st["peak"], int(nbytes))


def reset() -> None:
    with _LOCK:
        _STATS.clear()


def _host_rss() -> dict:
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmHWM:")):
                    k, v = line.split(":", 1)
                    out[k.lower()] = int(v.split()[0]) * 1024
    except OSError:
        pass
    return out


def _device_stats() -> list:
    """The current CUDA device's memory: PyTorch's allocated and peak
    bytes, and the card's total (mem_get_info). Empty on a host without
    a card, or where CUDA was never initialised (a CPU run)."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    dev = torch.cuda.current_device()
    _, total = torch.cuda.mem_get_info(dev)
    return [{
        "device": f"cuda:{dev} {torch.cuda.get_device_name(dev)}",
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_limit": total,
    }]


def memory_report() -> dict:
    from quicked_tpu_torch.aligner.batch import FULL_FILL_BYTES_BUDGET
    from quicked_tpu_torch.params import HIRSCHBERG_BUFFER_SIZE

    with _LOCK:
        recorded = {k: dict(v) for k, v in _STATS.items()}
    return {
        "budgets": {
            "full_fill_bytes_budget": FULL_FILL_BYTES_BUDGET,
            "hirschberg_buffer_size": HIRSCHBERG_BUFFER_SIZE,
        },
        "recorded": recorded,
        "host": _host_rss(),
        "devices": _device_stats(),
    }


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} GiB"


def print_report(file=None) -> None:
    """Human-readable block (the mm_allocator_print analogue)."""
    file = file or sys.stderr
    rep = memory_report()
    print("[Memory]", file=file)
    b = rep["budgets"]
    print(f"  Budget.FullFill        "
          f"{_fmt_bytes(b['full_fill_bytes_budget'])}", file=file)
    print(f"  Budget.Hirschberg      "
          f"{_fmt_bytes(b['hirschberg_buffer_size'])}", file=file)
    for kind, st in sorted(rep["recorded"].items()):
        print(f"  {kind:<22} {st['count']} allocs, total "
              f"{_fmt_bytes(st['bytes'])}, peak {_fmt_bytes(st['peak'])}",
              file=file)
    h = rep["host"]
    if h:
        print(f"  Host.RSS               {_fmt_bytes(h.get('vmrss'))} "
              f"(HWM {_fmt_bytes(h.get('vmhwm'))})", file=file)
    for d in rep["devices"]:
        print(f"  {d['device']:<22} in use "
              f"{_fmt_bytes(d['bytes_in_use'])}, peak "
              f"{_fmt_bytes(d['peak_bytes_in_use'])}, limit "
              f"{_fmt_bytes(d['bytes_limit'])}", file=file)
