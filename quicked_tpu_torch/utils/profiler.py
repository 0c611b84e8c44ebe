"""Profiling: phase timers and statistics counters.

The port's copy of quicked_tpu/utils/profiler.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Re-expresses the reference profiling surface
(quicked_utils/src/profiler_timer.c, profiler_counter.c):

  - Timer: ns-resolution start/stop/pause/continue accumulating timer
    (timer_start/stop/pause/continue, profiler_timer.c:53-73) with the
    reference's print format (timer_print, including percent-of-total).
  - Counter: running total/min/max/mean/variance via Welford's update
    (counter_add, profiler_counter.h:34-43 m_oldM..m_newS fields).

The aligner carries five phase timers — total, windowed_s, windowed_l,
banded, align (quicked.h:62-66) — started/stopped around each cascade
stage; `torch.profiler` traces cover the device side.
"""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Counter:
    """Statistics counter (profiler_counter.h:30-49)."""

    total: int = 0
    samples: int = 0
    min: int = 0
    max: int = 0
    _old_m: float = 0.0
    _new_m: float = 0.0
    _old_s: float = 0.0
    _new_s: float = 0.0

    def add(self, amount: int) -> None:
        """counter_add (profiler_counter.c)."""
        if self.samples == 0:
            self.min = amount
            self.max = amount
            self._old_m = self._new_m = float(amount)
            self._old_s = 0.0
        else:
            self.min = min(self.min, amount)
            self.max = max(self.max, amount)
            self._new_m = self._old_m + (amount - self._old_m) / (self.samples + 1)
            self._new_s = self._old_s + \
                (amount - self._old_m) * (amount - self._new_m)
            self._old_m = self._new_m
            self._old_s = self._new_s
        self.total += amount
        self.samples += 1

    def add_repeat(self, amount: int, k: int) -> None:
        """k successive add(amount) calls in O(1), bit-exact with the
        sequential loop when every prior sample also equals `amount`
        (the per-op CIGAR-breakdown pattern: all adds are 1) — the
        Welford recurrence is then a fixed point (delta = 0). Falls
        back to the loop otherwise."""
        if k <= 0:
            return
        if self.samples > 0 and (self._old_m != float(amount)
                                 or self._old_s != 0.0):
            for _ in range(k):
                self.add(amount)
            return
        if self.samples == 0:
            self.min = amount
            self.max = amount
            self._old_m = self._new_m = float(amount)
            self._old_s = self._new_s = 0.0
        self.total += amount * k
        self.samples += k

    def mean(self) -> float:
        # counter_get_mean is total/samples (profiler_counter.c:70-72),
        # NOT the Welford running mean (which drifts in float over many
        # samples)
        return self.total / self.samples if self.samples else 0.0

    def variance(self) -> float:
        return self._new_s / (self.samples - 1) if self.samples > 1 else 0.0

    def stddev(self) -> float:
        return math.sqrt(self.variance())

    def reset(self) -> None:
        self.__init__()

    @staticmethod
    def _scaled(val: float, prefix: str, suffix: str = "") -> str:
        """The reference's K/M/G metric scaling (profiler_counter.c)."""
        for factor, tag in ((1000000000, "G"), (1000000, "M"),
                            (1000, "K")):
            if val >= factor:
                return f"{prefix}{val / factor:.2f}{tag}{suffix}"
        return f"{prefix}{val:.2f}{suffix}"

    def print(self, stream, total: "Counter | None" = None,
              units: str = "") -> None:
        """Byte-exact counter_print(full_report=True)
        (profiler_counter.c:91-223)."""
        t = self.total
        if t >= 1000000000:
            stream.write(f"{t / 1e9:7.2f} G{units}")
        elif t >= 1000000:
            stream.write(f"{t / 1e6:7.2f} M{units}")
        elif t >= 1000:
            stream.write(f"{t / 1e3:7.2f} K{units}")
        else:
            stream.write(f"{float(t):7.2f} {units} ")
        if total is not None:
            if t == 0:
                stream.write(" (  0.00 %)")
            elif total.total == 0:
                stream.write(" (  n/a  %)")
            else:
                stream.write(f" ({t * 100 / total.total:6.2f} %)")
        else:
            stream.write(" " * 11)
        ns = self.samples
        if ns >= 1000000000:
            stream.write(f" (samples={ns // 1000000000}G")
        elif ns >= 1000000:
            stream.write(f" (samples={ns // 1000000}M")
        elif ns >= 1000:
            stream.write(f" (samples={ns // 1000}K")
        else:
            stream.write(f" (samples={ns}")
            if ns == 0:
                stream.write(",--n/a--)}\n")
                return
        stream.write(self._scaled(t / ns, "{mean"))
        stream.write(self._scaled(float(self.min), ",min"))
        stream.write(self._scaled(float(self.max), ",Max"))
        # the reference truncates variance/stddev to uint64 before
        # scaling (profiler_counter.c:143-163)
        stream.write(self._scaled(float(int(self.variance())), ",Var"))
        stream.write(self._scaled(float(int(self.stddev())),
                                  ",StdDev", ")}\n"))


class Timer:
    """ns-resolution accumulating phase timer (profiler_timer.c:53-73)."""

    def __init__(self):
        self.time_ns = 0
        self._begin = None
        self.count = Counter()

    def start(self) -> None:
        self.time_ns = 0
        self._begin = time.perf_counter_ns()

    def stop(self) -> None:
        """timer_stop: pause, record the accumulated lap as ONE sample,
        reset the accumulator (profiler_timer.c:57-61) — so a
        start/pause/stop cycle still records its lap, and a later
        resume/stop cycle cannot double-count it."""
        if self._begin is not None:
            self.time_ns += time.perf_counter_ns() - self._begin
            self._begin = None
        elif self.time_ns == 0:
            return  # never started: avoid a spurious 0 sample
        self.count.add(self.time_ns)
        self.time_ns = 0

    def pause(self) -> None:
        """timer_pause: accumulate without closing the sample."""
        if self._begin is None:
            return
        self.time_ns += time.perf_counter_ns() - self._begin
        self._begin = None

    def resume(self) -> None:
        """timer_continue."""
        self._begin = time.perf_counter_ns()

    def total_ns(self) -> int:
        """timer_get_current_total_ns: recorded samples + the
        accumulated open lap (+ the running lap when started)."""
        acc = self.count.total + self.time_ns
        if self._begin is not None:
            acc += time.perf_counter_ns() - self._begin
        return acc

    def print(self, stream, total: "Timer | None" = None) -> None:
        """timer_print format (profiler_timer.c:121-140): human time +
        percent of a reference timer (0.00% when this timer is 0,
        n/a when the reference is 0)."""
        ns = self.count.total + self.time_ns   # timer_get_total_ns
        pct = ""
        if total is not None:
            if ns == 0:
                pct = " (  0.00 %)"
            else:
                ref = total.count.total + total.time_ns
                pct = " (  n/a  %)" if ref == 0 else \
                    f" ({100.0 * ns / ref:6.2f} %)"
        stream.write(f"{_human_time(ns)}{pct}\n")


def _human_time(ns: int) -> str:
    """timer_print_total unit selection (profiler_timer.c:103-119):
    width 7, minutes as the largest unit."""
    if ns >= 60 * 1_000_000_000:
        return f"{ns / 60_000_000_000:7.2f} m "
    if ns >= 1_000_000_000:
        return f"{ns / 1_000_000_000:7.2f} s "
    if ns >= 1_000_000:
        return f"{ns / 1_000_000:7.2f} ms"
    if ns >= 1_000:
        return f"{ns / 1_000:7.2f} us"
    return f"{ns:7d} ns"


@dataclasses.dataclass
class PhaseTimers:
    """The aligner's five phase timers (quicked.h:62-66)."""

    total: Timer = dataclasses.field(default_factory=Timer)
    windowed_s: Timer = dataclasses.field(default_factory=Timer)
    windowed_l: Timer = dataclasses.field(default_factory=Timer)
    banded: Timer = dataclasses.field(default_factory=Timer)
    align: Timer = dataclasses.field(default_factory=Timer)
