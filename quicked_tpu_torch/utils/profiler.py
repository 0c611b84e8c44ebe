"""Profiling: phase timers and statistics counters.

The port's copy of quicked_tpu/utils/profiler.py
(the port imports nothing of the JAX package, so it keeps its own
copy, unchanged in what it computes).

Re-expresses the reference profiling surface
(quicked_utils/src/profiler_timer.c, profiler_counter.c):

  - Timer: ns-resolution start/stop/pause/continue accumulating timer
    (timer_start/stop/pause/continue, profiler_timer.c:53-73).
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

@dataclasses.dataclass
class PhaseTimers:
    """The aligner's five phase timers (quicked.h:62-66)."""

    total: Timer = dataclasses.field(default_factory=Timer)
    windowed_s: Timer = dataclasses.field(default_factory=Timer)
    windowed_l: Timer = dataclasses.field(default_factory=Timer)
    banded: Timer = dataclasses.field(default_factory=Timer)
    align: Timer = dataclasses.field(default_factory=Timer)
