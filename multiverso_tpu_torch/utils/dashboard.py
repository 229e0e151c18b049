"""Monitor / Dashboard metrics aggregation (port of
``multiverso_tpu/utils/dashboard.py``).

Named ``Monitor``s accumulate call counts, cumulative elapsed milliseconds
and a log-scale latency histogram in a process-global ``Dashboard``;
``display()`` prints the same report as the JAX package at shutdown.

CUDA work is queued asynchronously, so a monitor around a kernel launch
measures the launch unless the caller synchronizes: ``table[...].add``
times the dispatch of the update (as in the JAX package), while
``table[...].get`` includes the device -> host copy.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator

from multiverso_tpu_torch.telemetry.histogram import Histogram


@dataclass(frozen=True)
class MonitorSnapshot:
    """Immutable point-in-time view of one Monitor."""

    name: str
    count: int
    total_ms: float
    min_ms: float
    max_ms: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    timed: int                       # samples with a duration

    @property
    def average_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def info_string(self) -> str:
        s = (f"[{self.name}] count = {self.count}, "
             f"total = {self.total_ms:.3f} ms, "
             f"average = {self.average_ms:.3f} ms")
        if self.timed:
            s += (f", p50 = {self.p50_ms:.3f} ms, "
                  f"p90 = {self.p90_ms:.3f} ms, "
                  f"p99 = {self.p99_ms:.3f} ms, "
                  f"max = {self.max_ms:.3f} ms")
        return s


class Monitor:
    """Count + cumulative-ms accumulator with a latency histogram."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_ms = 0.0
        self._hist = Histogram()
        self._lock = threading.Lock()

    def observe_ms(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            self._hist.observe(ms)

    def incr(self, n: int = 1) -> None:
        """Pure event counter: bump ``count`` by ``n`` without touching the
        timing sum or the histogram (cache hits: events with no duration
        worth recording)."""
        with self._lock:
            self.count += n

    def snapshot(self) -> MonitorSnapshot:
        """Consistent immutable view (one lock hold)."""
        with self._lock:
            h = self._hist
            p50, p90, p99 = h.percentiles((50, 90, 99))
            return MonitorSnapshot(
                name=self.name, count=self.count, total_ms=self.total_ms,
                min_ms=h.min if h.count else 0.0, max_ms=h.max,
                p50_ms=p50, p90_ms=p90, p99_ms=p99, timed=h.count)

    def info_string(self) -> str:
        return self.snapshot().info_string()


class Dashboard:
    """Process-global registry of Monitors."""

    _monitors: Dict[str, Monitor] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, name: str) -> Monitor:
        with cls._lock:
            mon = cls._monitors.get(name)
            if mon is None:
                mon = cls._monitors[name] = Monitor(name)
            return mon

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._monitors.clear()

    @classmethod
    def snapshot(cls) -> Dict[str, MonitorSnapshot]:
        with cls._lock:
            mons = list(cls._monitors.values())
        return {m.name: m.snapshot() for m in mons}

    @classmethod
    def display(cls, print_fn=print) -> None:
        with cls._lock:
            mons = list(cls._monitors.values())
        if not mons:
            return
        print_fn("--------------Dashboard--------------------")
        for m in sorted(mons, key=lambda m: m.name):
            print_fn(m.info_string())
        print_fn("-------------------------------------------")


@contextmanager
def monitor(name: str) -> Iterator[Monitor]:
    """MONITOR_BEGIN/END pair as a context manager."""
    mon = Dashboard.get(name)
    start = time.perf_counter()
    try:
        yield mon
    finally:
        mon.observe_ms((time.perf_counter() - start) * 1e3)
