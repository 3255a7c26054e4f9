"""High-resolution timers and interval statistics.

Copy of ``ompi_tpu/base/timer.py`` (after the reference's timer framework,
``opal/mca/timer/``, and its ``OPAL_TIMING`` instrumentation macros):
``now_ns``/``now`` read the monotonic ``perf_counter`` clock, and
:class:`IntervalStats` accumulates count, total, min and max over timed
intervals.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


def now_ns() -> int:
    return time.perf_counter_ns()


def now() -> float:
    return time.perf_counter()


@dataclass
class IntervalStats:
    """Accumulates min/max/mean over timed intervals."""

    count: int = 0
    total_ns: int = 0
    min_ns: int = field(default=2**63 - 1)
    max_ns: int = 0
    _start: int = 0

    def start(self) -> None:
        self._start = now_ns()

    def stop(self) -> int:
        dt = now_ns() - self._start
        self.record(dt)
        return dt

    def record(self, dt_ns: int) -> None:
        self.count += 1
        self.total_ns += dt_ns
        self.min_ns = min(self.min_ns, dt_ns)
        self.max_ns = max(self.max_ns, dt_ns)

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    def __enter__(self) -> "IntervalStats":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
