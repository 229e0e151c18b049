"""Monitor / Dashboard metrics aggregation (port of
``multiverso_tpu/utils/dashboard.py``).

Named ``Monitor``s accumulate call counts, cumulative elapsed milliseconds
and a log-scale latency histogram in a process-global ``Dashboard``;
``display()`` prints the same report as the JAX package at shutdown. The
paired ``begin()``/``end()`` API keeps its start stamp per thread;
``monitor(name)`` is the context-manager form and ``monitored(name)`` the
decorator. ``MonitorSnapshot.hist_dict()`` is the exporter / MSG_STATS
wire shape, the same keys as ``Histogram.as_dict()``.

CUDA work is queued asynchronously, so a monitor around a kernel launch
measures the launch unless the caller synchronizes: ``table[...].add``
times the dispatch of the update (as in the JAX package), while
``table[...].get`` includes the device -> host copy.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, Tuple

from multiverso_tpu_torch.telemetry.histogram import Histogram


@dataclass(frozen=True)
class MonitorSnapshot:
    """Immutable point-in-time view of one Monitor. Exporters, tests,
    and the MSG_STATS reply consume THIS — never the live Monitor, whose
    fields keep mutating under them (``Dashboard.snapshot()`` used to
    hand out live objects; an exporter iterating one raced the hot
    path)."""

    name: str
    count: int
    total_ms: float
    min_ms: float
    max_ms: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    timed: int                       # samples with a duration (not incr)
    buckets: Tuple[Tuple[float, int], ...] = field(default=())

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

    def brief_dict(self, digits: int = 5) -> Dict:
        """Compact count + p50/p90/p99/max summary — THE shape bench
        records and worker RESULT lines share (one definition instead
        of hand-built literals at every call site)."""
        return {"count": self.count,
                "p50_ms": round(self.p50_ms, digits),
                "p90_ms": round(self.p90_ms, digits),
                "p99_ms": round(self.p99_ms, digits),
                "max_ms": round(self.max_ms, digits)}

    def hist_dict(self) -> Dict:
        """JSON-safe dict (exporter / MSG_STATS wire shape) — SAME key
        set as ``telemetry.histogram.Histogram.as_dict()``; keep the two
        in lockstep."""
        return {
            "count": self.count,
            "sum_ms": round(self.total_ms, 6),
            "min_ms": round(self.min_ms, 6) if self.timed else 0.0,
            "max_ms": round(self.max_ms, 6),
            "p50_ms": round(self.p50_ms, 6),
            "p90_ms": round(self.p90_ms, 6),
            "p99_ms": round(self.p99_ms, 6),
            "timed": self.timed,
            "buckets": [[b, c] for b, c in self.buckets],
        }


class Monitor:
    """Count + cumulative-ms accumulator with a latency histogram
    (ref dashboard.h Monitor, upgraded — see module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_ms = 0.0
        self._hist = Histogram()
        # per-thread begin stamp: the paired begin/end API must not share
        # one slot across threads (satellite fix; prefer monitor())
        self._tls = threading.local()
        self._lock = threading.Lock()

    def begin(self) -> None:
        self._tls.begin = time.perf_counter()

    def end(self) -> None:
        begin = getattr(self._tls, "begin", None)
        if begin is None:
            return
        self._tls.begin = None
        self.observe_ms((time.perf_counter() - begin) * 1e3)

    def observe_ms(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            self._hist.observe(ms)

    def incr(self, n: int = 1) -> None:
        """Pure event counter: bump ``count`` by ``n`` without touching
        the timing sum or histogram (window flushes, merged rows —
        events with no meaningful per-event duration)."""
        with self._lock:
            self.count += n

    @property
    def average_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Latency quantile estimate over the timed samples (bucket
        interpolation; ~one bucket width of relative error)."""
        with self._lock:
            return self._hist.percentile(q)

    @property
    def p50_ms(self) -> float:
        return self.percentile(50)

    @property
    def p99_ms(self) -> float:
        return self.percentile(99)

    @property
    def max_ms(self) -> float:
        with self._lock:
            return self._hist.max

    def snapshot(self) -> MonitorSnapshot:
        """Consistent immutable view (one lock hold)."""
        with self._lock:
            h = self._hist
            p50, p90, p99 = h.percentiles((50, 90, 99))
            return MonitorSnapshot(
                name=self.name, count=self.count, total_ms=self.total_ms,
                min_ms=h.min if h.count else 0.0, max_ms=h.max,
                p50_ms=p50, p90_ms=p90, p99_ms=p99, timed=h.count,
                buckets=tuple(h.nonzero()))

    def info_string(self) -> str:
        return self.snapshot().info_string()


class Dashboard:
    """Process-global registry of Monitors (ref dashboard.h Dashboard)."""

    _monitors: Dict[str, Monitor] = {}
    _notes: Dict[str, str] = {}
    _lock = threading.Lock()

    @classmethod
    def get(cls, name: str) -> Monitor:
        with cls._lock:
            mon = cls._monitors.get(name)
            if mon is None:
                mon = cls._monitors[name] = Monitor(name)
            return mon

    @classmethod
    def note(cls, name: str, text: str) -> None:
        """Free-form counter line for work the Monitor timers never see
        (e.g. ops served inside the native transport)."""
        with cls._lock:
            cls._notes[name] = text

    @classmethod
    def notes(cls) -> Dict[str, str]:
        with cls._lock:
            return dict(cls._notes)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._monitors.clear()
            cls._notes.clear()

    @classmethod
    def snapshot(cls) -> Dict[str, MonitorSnapshot]:
        """Immutable per-monitor snapshots (safe to hold across the hot
        path; see MonitorSnapshot)."""
        with cls._lock:
            mons = list(cls._monitors.values())
        return {m.name: m.snapshot() for m in mons}

    @classmethod
    def display(cls, print_fn=print) -> None:
        with cls._lock:   # one hold: monitors+notes are an atomic view
            mons = list(cls._monitors.values())
            notes = dict(cls._notes)
        if not mons and not notes:
            return
        print_fn("--------------Dashboard--------------------")
        for m in sorted(mons, key=lambda m: m.name):
            print_fn(m.info_string())
        for name in sorted(notes):
            print_fn(f"[{name}] {notes[name]}")
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


def monitored(name: str):
    """Decorator form of :func:`monitor` (``functools.wraps`` so the
    instrumented function keeps its docstring/signature/module)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with monitor(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
