"""The benchmark's own spans and clocks, and the reduction of a profiler
trace to what the per-layer readers and the breakdown need.

Spans are ``torch.profiler.record_function`` ranges named ``bench.*``
around the calls the benchmark's loop makes: ``bench.window`` (the traced
window), ``bench.step``, ``bench.sync`` and ``bench.handoff`` (taking the
next batch from the pool). Time outside them is the loop's own (``loop``:
in the LM's worker, ``train_ps`` reading each step's loss back). They
cost nothing in an untraced run, where ``Spans(False)`` opens none.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


class Phases:
    """Host seconds of set-up's phases: each call closes the phase it
    names, which began where the last one closed; a name closed twice
    adds up."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now


class Spans:
    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"bench.{name}")


class Marks:
    """Timestamps in one stream: CUDA events on the card (recorded, read
    after the window), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        return a.elapsed_time(b)


class Trace:
    """A traced window: device time by operation name, the union of device
    activity (``busy_s``), the window's length, and its idle gaps named by
    the span the host was in."""

    def __init__(self, ops: Dict[str, List[float]], busy_s: float,
                 window_s: float, gaps: List[Tuple[str, float]]):
        self.ops = ops            # name -> [count, seconds]
        self.busy_s = busy_s
        self.window_s = window_s
        self.gaps = gaps          # (span, seconds), longest first

    def time_of(self, *parts: str) -> Tuple[int, float]:
        """(calls, seconds) of the operations whose name holds any part."""
        n, s = 0, 0.0
        for name, (c, t) in self.ops.items():
            if any(p in name for p in parts):
                n, s = n + int(c), s + t
        return n, s

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time; the idle time by
        what the host was doing (the span it was in, ``loop`` between
        spans), summed, then the longest single gaps (``<span>.max``)."""
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:10]
        total: Dict[str, float] = defaultdict(float)
        for k, s in self.gaps:
            total[k] += s
        idle = sorted(total.items(), key=lambda kv: -kv[1])
        idle += [[f"{k}.max", s] for k, s in self.gaps[:10 - len(idle)]]
        return {"device_ops": [[n[:160], t] for n, (_, t) in top],
                "idle_gaps": [list(g) for g in idle[:10]]}


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def reduce(events) -> Trace:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)."""
    spans: List[Tuple[int, int, str]] = []
    window = None
    dev: List[Tuple[int, int]] = []
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for ev in events:
        name = ev.name()
        on_device = "CPU" not in str(ev.device_type())
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if name.startswith("bench."):
            if not on_device:
                if name == "bench.window":
                    window = (start, start + dur)
                else:
                    spans.append((start, start + dur, name[6:]))
            continue
        if on_device:
            dev.append((start, start + dur))
            rec = ops[name]
            rec[0] += 1
            rec[1] += dur * 1e-9
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    lo, hi = window
    dev.sort()
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s, cur_e = None, None
    for s, e in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None:
            if s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < hi:
            gaps.append((cur_e, hi))
    else:
        gaps.append((lo, hi))
    spans.sort()
    starts = [s for s, _, _ in spans]
    named: List[Tuple[str, float]] = []
    for s, e in gaps:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        what = spans[i][2] if i >= 0 and spans[i][1] >= mid else "loop"
        named.append((what, (e - s) * 1e-9))
    named.sort(key=lambda g: -g[1])
    return Trace(dict(ops), busy * 1e-9, (hi - lo) * 1e-9, named)


def traced(fn, device: torch.device):
    """Run ``fn`` under the profiler inside a ``bench.window`` span;
    returns (its result, the reduced ``Trace``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
    return out, reduce(prof.profiler.kineto_results.events())


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    i = int(pos)
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (pos - i)
