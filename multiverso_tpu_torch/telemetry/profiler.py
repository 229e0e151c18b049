"""Per-step critical-path profiler: compute vs wire vs stall (port of
``multiverso_tpu/telemetry/profiler.py``, the same record format).

The app brackets each training **step** (:func:`step`) and marks
**phases** inside it (:func:`phase` — ``prepare``, ``compute``,
``ps_wait``, ``io_wait``, ...; phases nest, and nested time is
attributed to the innermost mark). In-flight PS ops are **async spans**
(:func:`async_begin`/:meth:`AsyncSpan.end`, or the retroactive
:func:`note_async`): intervals that may start on the step's thread and
end on a peer's receive thread. At step exit the profiler computes, with
interval-union math:

* **wall** — step exit minus step entry;
* **per-phase exclusive time** — each phase's own interval minus its
  nested children;
* **attributed fraction** — ``|union(all phase + async intervals)| /
  wall``;
* **overlap credit** — per async span, ``|span ∩ union(phase
  intervals)|``: wire time hidden under marked host work;
* **stall fraction** — ``(wall - |union(everything)|) / wall``.

CUDA work is queued asynchronously, so a phase holds device time only
where the app synchronizes inside it; the apps synchronize at the points
where the JAX apps block on the device (WE's ``compute`` reads its loss
back), so device time lands in the same phase on both packages.

Every record carries the JAX package's ``"jax"`` counter block, with the
keys it has there; :class:`_BuildCounters` says what each counts here
(native library builds at first use in place of XLA compiles). Build
events inside a steady step count as ``steady_recompiles``.

Cost: everything is off unless the ``step_profile`` flag is set — the
hot-path gate is one attribute read and :func:`step`/:func:`phase`
return a shared null context. Step records sit in a bounded
drain-on-dump buffer; the exporter appends them to
``profile-rank<r>.jsonl`` under ``metrics_dir``, and
``python -m multiverso_tpu_torch.tools.mvprof`` reports them.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from multiverso_tpu_torch.utils import config

config.define_bool(
    "step_profile", False,
    "per-step critical-path profiler (telemetry/profiler.py): apps "
    "bracket steps and mark prepare/compute/ps_wait/io_wait phases + "
    "async PS spans; records per-step wall, per-phase exclusive time, "
    "overlap credit and stall fraction (interval-union math) plus native "
    "build counters sampled at step boundaries. Off by default: one "
    "attribute read on the hot path. Records dump to metrics_dir as "
    "profile-rank<r>.jsonl; multiverso_tpu_torch.tools.mvprof reports")

# bounded record buffer: a forgotten always-on profiler must cap memory
# (same rule as the tracer); 4096 steps is hours of block-scale training
_MAX_RECORDS = 4096
# per-step interval detail cap: mvprof's timeline needs the raw spans,
# but a step that marks thousands of phases (a tight io_wait loop) must
# not grow its record without bound — past the cap only the aggregate
# numbers keep accumulating and the record says how many were dropped
_MAX_SPANS_PER_STEP = 512


# ---------------------------------------------------------------------- #
# interval math (pure; tests run these against brute-force oracles)
# ---------------------------------------------------------------------- #
def union_intervals(intervals: Sequence[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Merge ``(t0, t1)`` intervals into a disjoint sorted union."""
    ivs = sorted((float(a), float(b)) for a, b in intervals if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union — THE anti-sum-of-averages primitive:
    two phases covering the same wall-clock second count it once."""
    return sum(b - a for a, b in union_intervals(intervals))


def _intersect_disjoint(span: Tuple[float, float],
                        merged: Sequence[Tuple[float, float]]) -> float:
    """``|span ∩ merged|`` for an ALREADY disjoint sorted union —
    finalize intersects one precomputed phase union against every
    async span, and re-merging per span would be pure wasted work."""
    a0, b0 = span
    if b0 <= a0:
        return 0.0
    total = 0.0
    for a, b in merged:
        lo, hi = max(a, a0), min(b, b0)
        if hi > lo:
            total += hi - lo
    return total


def intersect_length(span: Tuple[float, float],
                     intervals: Sequence[Tuple[float, float]]) -> float:
    """``|span ∩ union(intervals)|`` — the overlap-credit primitive."""
    return _intersect_disjoint(span, union_intervals(intervals))


def _clip(t0: float, t1: float, lo: float, hi: float
          ) -> Optional[Tuple[float, float]]:
    a, b = max(t0, lo), min(t1, hi)
    return (a, b) if b > a else None


# ---------------------------------------------------------------------- #
# step-record readers (pure; tools/mvprof.py and tools/dump_metrics.py
# both render step JSONL — ONE aggregation definition, the same rule
# that makes aggregator.merge_cluster shared by mvtop)
# ---------------------------------------------------------------------- #
def step_top_phase(rec: Dict[str, Any]
                   ) -> Tuple[Optional[str], float]:
    """(name, exclusive ms) of a step record's critical-path phase —
    (None, 0.0) for a phaseless step."""
    name, ms = None, 0.0
    for n, d in (rec.get("phases") or {}).items():
        v = float(d.get("ms", 0.0))
        if v > ms:
            name, ms = n, v
    return name, ms


def aggregate_step_records(records: Sequence[Dict[str, Any]]
                           ) -> Dict[str, Any]:
    """Aggregate a list of ``kind == "step"`` records: wall/stall/
    attributed/overlap sums, per-phase exclusive totals, critical-path
    win counts, and the recompile table (steps with compiles + summed
    per-function retraces)."""
    steps = [r for r in records if r.get("kind") == "step"]
    out: Dict[str, Any] = {
        "steps": len(steps),
        "wall_ms": sum(float(r.get("wall_ms", 0.0)) for r in steps),
        "stall_ms": sum(float(r.get("stall_ms", 0.0)) for r in steps),
        "attributed_ms": sum(float(r.get("attributed_ms", 0.0))
                             for r in steps),
        "overlap_ms": sum(float(r.get("overlap_ms", 0.0))
                          for r in steps),
    }
    phases: Dict[str, float] = {}
    wins: Dict[str, int] = {}
    recompile_steps: List[Dict[str, Any]] = []
    retraces: Dict[str, int] = {}
    for r in steps:
        for n, d in (r.get("phases") or {}).items():
            phases[n] = phases.get(n, 0.0) + float(d.get("ms", 0.0))
        top, _ = step_top_phase(r)
        if top:
            wins[top] = wins.get(top, 0) + 1
        j = r.get("jax") or {}
        if j.get("compiles"):
            recompile_steps.append(
                {"step": r.get("step"), "name": r.get("name"),
                 "compiles": j.get("compiles"),
                 "compile_s": j.get("compile_s"),
                 "by_fn": j.get("retraces_by_fn", {})})
        for fn, k in (j.get("retraces_by_fn") or {}).items():
            retraces[fn] = retraces.get(fn, 0) + int(k)
    out["phases_ms"] = {n: round(v, 4) for n, v in sorted(phases.items())}
    out["critical_path_wins"] = dict(
        sorted(wins.items(), key=lambda kv: -kv[1]))
    out["recompile_steps"] = recompile_steps
    out["retraces_by_fn"] = retraces
    return out


# ---------------------------------------------------------------------- #
# build counter hook (global monotonic counters; steps take deltas)
# ---------------------------------------------------------------------- #
class _BuildCounters:
    """Process-global counters behind every step record's ``"jax"``
    block. The block keeps the JAX package's name and keys so that
    ``aggregate_step_records`` and the tools read either package's
    records; this package has no jit, so on it the keys mean:

    * ``compiles`` — native libraries built at first use (one ``nvcc``
      per CUDA source in ``ops/_build.py``, one ``g++`` per host C++
      source in ``native/__init__.py``); a build inside a steady step is
      a steady-state recompile, as a retrace is on the JAX package;
    * ``compile_s`` — seconds spent in those builds;
    * ``traces`` — native libraries loaded (built or found on disk);
    * ``donation_rejected`` — always 0 (PyTorch has no buffer donation);
    * ``transfer_bytes`` — host->device bytes reported by the
      instrumented pipelines (:func:`note_transfer`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.installed = True      # nothing to register: builds report
        self.compiles = 0
        self.compile_s = 0.0
        self.traces = 0
        self.donation_rejected = 0
        self.transfer_bytes = 0
        # invoked (OUTSIDE this lock — the profiler's own lock nests
        # the other way) once per build, so the steady-state
        # classification can be per EVENT, not per window delta
        self.on_compile: Optional[Callable[[], None]] = None

    def install(self) -> None:
        """No-op kept for the JAX package's call shape: builds report
        through :meth:`note_compile` whether or not profiling is on."""

    def note_compile(self, seconds: float) -> None:
        with self._lock:
            self.compiles += 1
            self.compile_s += float(seconds)
            cb = self.on_compile
        if cb is not None:
            cb()   # off this lock: the callback takes the profiler's

    def note_load(self) -> None:
        with self._lock:
            self.traces += 1

    def note_transfer(self, nbytes: int) -> None:
        with self._lock:
            self.transfer_bytes += int(nbytes)

    def note_donation_rejected(self, n: int = 1) -> None:
        with self._lock:
            self.donation_rejected += int(n)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"compiles": self.compiles,
                    "compile_s": round(self.compile_s, 6),
                    "traces": self.traces,
                    "donation_rejected": self.donation_rejected,
                    "transfer_bytes": self.transfer_bytes}

    def reset(self) -> None:
        with self._lock:
            self.compiles = 0
            self.compile_s = 0.0
            self.traces = 0
            self.donation_rejected = 0
            self.transfer_bytes = 0


class AsyncSpan:
    """One in-flight async interval (a PS round-trip). ``end()`` may run
    on any thread (peer recv callbacks); idempotent — racing closers
    (reply callback vs. the wait() fallback) record one interval."""

    __slots__ = ("name", "t0", "t1", "_step", "trace")

    def __init__(self, name: str, step: "Step",
                 trace: Optional[int] = None):
        self.name = name
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self._step = step
        self.trace = trace

    def end(self, t: Optional[float] = None) -> None:
        step = self._step
        if step is None:
            return
        self._step = None
        self.t1 = time.time() if t is None else t
        step._async_done(self)


class Step:
    """One profiled step (per-thread; see module docstring). Created by
    :func:`step` — apps never construct one directly, but MAY pass the
    object to ``phase(..., step=s)`` / ``note_async(..., step=s)`` from
    OTHER threads (producer threads contributing to a consumer's step:
    the cross-thread attribution surface)."""

    __slots__ = ("name", "index", "t0", "t1", "_lock", "_intervals",
                 "_dropped", "_excl", "_counts", "_open_async",
                 "_async_done_list", "_jax0", "_watch0", "_finalized",
                 "_warmup", "record")

    def __init__(self, name: str, index: int):
        self.name = name
        self.index = index
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self._lock = threading.Lock()
        # closed phase/async intervals: (kind, name, t0, t1)
        self._intervals: List[Tuple[str, str, float, float]] = []
        self._dropped = 0
        self._excl: Dict[str, float] = {}     # phase -> exclusive secs
        self._counts: Dict[str, int] = {}     # phase/async -> marks
        self._open_async: List[AsyncSpan] = []
        self._async_done_list: List[AsyncSpan] = []
        self._jax0: Dict[str, Any] = {}
        self._watch0: Dict[str, int] = {}
        self._finalized = False
        self._warmup = False   # first step on its thread (set by begin)
        self.record: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ #
    def _add_interval(self, kind: str, name: str, t0: float, t1: float,
                      excl: Optional[float] = None) -> None:
        with self._lock:
            if self._finalized:
                return
            if len(self._intervals) < _MAX_SPANS_PER_STEP:
                self._intervals.append((kind, name, t0, t1))
            else:
                self._dropped += 1
            self._counts[name] = self._counts.get(name, 0) + 1
            if excl is not None:
                self._excl[name] = self._excl.get(name, 0.0) + excl

    def _async_begin(self, span: AsyncSpan) -> None:
        with self._lock:
            if self._finalized:
                span._step = None
                return
            self._open_async.append(span)

    def _async_done(self, span: AsyncSpan) -> None:
        with self._lock:
            if self._finalized:
                return
            try:
                self._open_async.remove(span)
            except ValueError:
                pass
            self._async_done_list.append(span)

    # ------------------------------------------------------------------ #
    def _finalize(self, jax_now: Dict[str, Any],
                  watch_now: Dict[str, int], rank: int) -> Dict[str, Any]:
        t1 = time.time()
        with self._lock:
            self._finalized = True
            self.t1 = t1
            # in-flight async ops at step end: clip at the boundary —
            # their overlap up to here was real; the remainder belongs
            # to no step (recorded as open so mvprof can say so)
            open_spans = list(self._open_async)
            done_spans = list(self._async_done_list)
            intervals = list(self._intervals)
            dropped = self._dropped
            excl = dict(self._excl)
            counts = dict(self._counts)
        wall = max(t1 - self.t0, 1e-9)
        phase_ivs = [(a, b) for k, _n, a, b in intervals if k == "phase"]
        phase_union = union_intervals(
            [iv for iv in (
                _clip(a, b, self.t0, t1) for a, b in phase_ivs)
             if iv])
        async_detail: Dict[str, Dict[str, Any]] = {}
        all_ivs = list(phase_union)
        overlap_s = 0.0
        for span, open_ in ([(s, False) for s in done_spans]
                            + [(s, True) for s in open_spans]):
            s1 = t1 if span.t1 is None else span.t1
            iv = _clip(span.t0, s1, self.t0, t1)
            if iv is None:
                continue
            all_ivs.append(iv)
            ov = _intersect_disjoint(iv, phase_union)
            overlap_s += ov
            d = async_detail.setdefault(
                span.name, {"ms": 0.0, "overlap_ms": 0.0, "count": 0,
                            "open": 0})
            d["ms"] += (iv[1] - iv[0]) * 1e3
            d["overlap_ms"] += ov * 1e3
            d["count"] += 1
            if open_:
                d["open"] += 1
        attributed = union_length(all_ivs)
        stall = max(wall - attributed, 0.0)
        phases = {n: {"ms": round(s * 1e3, 4),
                      "count": counts.get(n, 0)}
                  for n, s in sorted(excl.items())}
        for d in async_detail.values():
            for k in ("ms", "overlap_ms"):
                d[k] = round(d[k], 4)
        jax_delta: Dict[str, Any] = {}
        for k, v in jax_now.items():
            v0 = self._jax0.get(k, 0)
            jax_delta[k] = (round(v - v0, 6)
                            if isinstance(v, float) else int(v - v0))
        retr = {n: int(watch_now.get(n, 0) - c0)
                for n, c0 in sorted(self._watch0.items())
                if watch_now.get(n, 0) - c0 > 0}
        if retr:
            jax_delta["retraces_by_fn"] = retr
        spans_out = []
        for k, n, a, b in intervals:
            iv = _clip(a, b, self.t0, t1)
            if iv:
                spans_out.append([k, n, round((iv[0] - self.t0) * 1e6),
                                  round((iv[1] - self.t0) * 1e6)])
        for span, open_ in ([(s, False) for s in done_spans]
                            + [(s, True) for s in open_spans]):
            s1 = t1 if span.t1 is None else span.t1
            iv = _clip(span.t0, s1, self.t0, t1)
            if iv and len(spans_out) < 2 * _MAX_SPANS_PER_STEP:
                spans_out.append(
                    ["async", span.name,
                     round((iv[0] - self.t0) * 1e6),
                     round((iv[1] - self.t0) * 1e6)]
                    + (["open"] if open_ else []))
        rec = {
            "kind": "step", "name": self.name, "step": self.index,
            "rank": rank, "ts": round(self.t0, 6),
            "wall_ms": round(wall * 1e3, 4),
            "attributed_ms": round(attributed * 1e3, 4),
            "attributed_fraction": round(min(attributed / wall, 1.0), 4),
            "overlap_ms": round(overlap_s * 1e3, 4),
            "stall_ms": round(stall * 1e3, 4),
            "stall_fraction": round(stall / wall, 4),
            "phases": phases,
            "async": async_detail,
            "jax": jax_delta,
            "spans": spans_out,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if dropped:
            rec["spans_dropped"] = dropped
        self.record = rec
        return rec


class _NullCtx:
    """Shared no-op context (the flag-off path allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _PhaseCtx:
    """One phase mark on one thread. Nesting: a per-thread stack debits
    the parent's exclusive time by the child's span, so exclusive times
    sum to <= the union and never double-count."""

    __slots__ = ("_name", "_step", "_t0", "_child", "_tls")

    def __init__(self, name: str, step: "Step", tls):
        self._name = name
        self._step = step
        self._tls = tls
        self._child = 0.0

    def __enter__(self):
        stack = getattr(self._tls, "phase_stack", None)
        if stack is None:
            stack = self._tls.phase_stack = []
        stack.append(self)
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        t1 = time.time()
        span = t1 - self._t0
        stack = self._tls.phase_stack
        try:
            stack.remove(self)
        except ValueError:
            pass
        if stack:
            stack[-1]._child += span
        self._step._add_interval(
            "phase", self._name, self._t0, t1,
            excl=max(span - self._child, 0.0))
        return False


class _StepCtx:
    __slots__ = ("_prof", "_name", "_step")

    def __init__(self, prof: "StepProfiler", name: str):
        self._prof = prof
        self._name = name

    def __enter__(self) -> Step:
        self._step = self._prof._begin_step(self._name)
        return self._step

    def __exit__(self, *exc):
        self._prof._end_step(self._step)
        return False


class StepProfiler:
    """Process-global profiler (one per process, like Tracer/Recorder);
    in-process multi-rank worlds share it, attributed to the first
    configured rank — the same documented collapse as trace IDs."""

    def __init__(self) -> None:
        self.enabled = False      # plain attribute: THE hot-path gate
        self.rank = 0
        self._rank_pinned = False
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=_MAX_RECORDS)
        self._tls = threading.local()
        self._next_index = 0
        self._steps_total = 0
        # last-begun still-open step, any thread: the attach="any"
        # fallback for producer threads that hold no step of their own
        self._current_any: Optional[Step] = None
        self.jax = _BuildCounters()
        # name -> watched fn (strong ref is fine: watched fns are
        # module/app-lifetime objects; the dict is small and explicit)
        self._watched: Dict[str, Any] = {}
        # aggregate totals that survive the drain-on-dump record buffer
        self._agg_phase_ms: Dict[str, float] = {}
        self._agg_stall_ms = 0.0
        self._agg_wall_ms = 0.0
        self._agg_attr_ms = 0.0
        self._agg_overlap_ms = 0.0
        # steady-state recompiles, classified per compile EVENT (the
        # build hook calls _note_compile_event outside its own lock): a
        # compile counts as steady iff at that moment at least one step
        # is open and NO open step is a warmup step (each thread's
        # FIRST step). Window-delta classification would turn one
        # shared warm compile into a phantom steady recompile on every
        # concurrently-open step (the 2-trainer DLRM shape).
        self._steady_recompiles = 0
        self._open_count = 0
        self._open_warmup = 0
        self.jax.on_compile = self._note_compile_event

    def _note_compile_event(self) -> None:
        with self._lock:
            if self._open_count > 0 and self._open_warmup == 0:
                self._steady_recompiles += 1

    # ------------------------------------------------------------------ #
    def configure(self, rank: Optional[int] = None) -> None:
        """Adopt the ``step_profile`` flag (PSService init / Zoo.start);
        idempotent, first caller's rank sticks."""
        if rank is not None and not self._rank_pinned:
            self.rank = int(rank)
            self._rank_pinned = True
        self.enabled = bool(config.get_flag("step_profile"))
        if self.enabled:
            self.jax.install()

    # ------------------------------------------------------------------ #
    # marking API (module-level wrappers below are the call-site idiom)
    # ------------------------------------------------------------------ #
    def step(self, name: str = "step"):
        if not self.enabled:
            return _NULL
        return _StepCtx(self, name)

    def _begin_step(self, name: str) -> Step:
        begun = getattr(self._tls, "steps_begun", 0)
        self._tls.steps_begun = begun + 1
        with self._lock:
            idx = self._next_index
            self._next_index += 1
            self._open_count += 1
            if begun == 0:
                self._open_warmup += 1
        s = Step(name, idx)
        s._warmup = begun == 0
        s._jax0 = self.jax.snapshot()
        s._watch0 = self._watch_sizes()
        self._tls.step = s
        self._current_any = s
        return s

    def _end_step(self, s: Step) -> Dict[str, Any]:
        rec = s._finalize(self.jax.snapshot(), self._watch_sizes(),
                          self.rank)
        if getattr(self._tls, "step", None) is s:
            self._tls.step = None
        with self._lock:
            if self._current_any is s:
                self._current_any = None
            self._open_count = max(self._open_count - 1, 0)
            if s._warmup:
                self._open_warmup = max(self._open_warmup - 1, 0)
            self._records.append(rec)
            self._steps_total += 1
            for n, d in rec["phases"].items():
                self._agg_phase_ms[n] = (self._agg_phase_ms.get(n, 0.0)
                                         + d["ms"])
            self._agg_stall_ms += rec["stall_ms"]
            self._agg_wall_ms += rec["wall_ms"]
            self._agg_attr_ms += rec["attributed_ms"]
            self._agg_overlap_ms += rec["overlap_ms"]
        return rec

    def current_step(self) -> Optional[Step]:
        return getattr(self._tls, "step", None)

    def phase(self, name: str, step: Optional[Step] = None):
        """Phase mark on the calling thread, attributed to its active
        step (or an explicit ``step`` handle from another thread);
        no-op context when disabled or no step is active."""
        if not self.enabled:
            return _NULL
        s = step if step is not None else getattr(self._tls, "step", None)
        if s is None or s._finalized:
            return _NULL
        return _PhaseCtx(name, s, self._tls)

    def async_begin(self, name: str, step: Optional[Step] = None,
                    attach: str = "thread",
                    trace: Optional[int] = None) -> Optional[AsyncSpan]:
        """Open an async span (a PS round-trip). ``attach="any"`` falls
        back to the process's last-begun open step when the calling
        thread holds none (producer threads). Returns None when nothing
        to attach to — callers guard with ``if span is not None``."""
        if not self.enabled:
            return None
        s = step if step is not None else getattr(self._tls, "step", None)
        if s is None and attach == "any":
            s = self._current_any
        if s is None or s._finalized:
            return None
        span = AsyncSpan(name, s, trace=trace)
        s._async_begin(span)
        return span

    def note_async(self, name: str, t0: float, t1: float,
                   step: Optional[Step] = None,
                   attach: str = "thread") -> None:
        """Retroactive async span (``time.time()`` seconds) — for call
        sites that only learn the interval after the fact (a producer
        thread's per-batch parse)."""
        if not self.enabled or t1 <= t0:
            return
        s = step if step is not None else getattr(self._tls, "step", None)
        if s is None and attach == "any":
            s = self._current_any
        if s is None or s._finalized:
            return
        span = AsyncSpan(name, s)
        span.t0 = t0
        s._async_begin(span)
        span.end(t1)

    # ------------------------------------------------------------------ #
    # build counters (the record's "jax" block)
    # ------------------------------------------------------------------ #
    def watch_jit(self, name: str, fn: Any) -> None:
        """Register a function for per-function retrace attribution
        (``_cache_size()`` deltas per step, recorded under
        ``jax.retraces_by_fn``). Kept with the JAX package's name and
        record keys so the tools read either package's records; a
        PyTorch function has no compile cache, so it is skipped (and the
        key stays absent) unless the object offers ``_cache_size``.
        Idempotent by name."""
        if getattr(fn, "_cache_size", None) is None:
            return
        with self._lock:
            self._watched.setdefault(name, fn)

    def _watch_sizes(self) -> Dict[str, int]:
        with self._lock:
            watched = list(self._watched.items())
        out = {}
        for n, fn in watched:
            try:
                out[n] = int(fn._cache_size())
            except Exception:   # noqa: BLE001 — a dead/exotic fn must
                out[n] = 0      # not break step finalize
        return out

    def jax_counters(self) -> Dict[str, Any]:
        """Current global counter snapshot (the ``"jax"`` block's
        counters, see :class:`_BuildCounters`) plus watched sizes."""
        self.jax.install()
        out = self.jax.snapshot()
        out["watched"] = self._watch_sizes()
        return out

    def note_transfer(self, nbytes: int) -> None:
        if self.enabled:
            self.jax.note_transfer(nbytes)

    # ------------------------------------------------------------------ #
    # reads / dumps
    # ------------------------------------------------------------------ #
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def summary(self) -> Dict[str, Any]:
        """Aggregate across every finalized step THIS process ran
        (survives the drain-on-dump buffer): per-phase exclusive totals,
        attributed/stall fractions over the summed wall clock, overlap
        credit, and the steady-state recompile count — compile EVENTS
        that fired while steps were open and every thread's FIRST step
        had already closed (warmup compiles are expected; these are
        not). Per-step ``jax`` deltas are process-global counter
        windows: concurrently-open steps each see a compile that fired
        during their overlap — the steady count here is per-event and
        does not double-count."""
        with self._lock:
            wall = self._agg_wall_ms
            return {
                "steps": self._steps_total,
                "wall_ms": round(wall, 3),
                "attributed_fraction": (
                    round(self._agg_attr_ms / wall, 4) if wall else 0.0),
                "stall_fraction": (
                    round(self._agg_stall_ms / wall, 4) if wall else 0.0),
                "overlap_ms": round(self._agg_overlap_ms, 3),
                "phases": {n: round(v, 3) for n, v in
                           sorted(self._agg_phase_ms.items())},
                "steady_recompiles": self._steady_recompiles,
                "jax": self.jax.snapshot(),
            }

    def stats_snapshot(self) -> Optional[Dict[str, Any]]:
        """Compact block for MSG_STATS payloads / mvtop's per-rank
        columns; None when profiling never ran (payloads stay
        unchanged)."""
        if not self._steps_total:
            return None
        s = self.summary()
        return {"steps": s["steps"],
                "stall_fraction": s["stall_fraction"],
                "attributed_fraction": s["attributed_fraction"],
                "steady_recompiles": s["steady_recompiles"],
                "compiles": s["jax"]["compiles"],
                "phases": s["phases"]}

    def profile_path(self, directory: str,
                     rank: Optional[int] = None) -> str:
        r = self.rank if rank is None else rank
        return os.path.join(directory, f"profile-rank{r}.jsonl")

    def dump_to(self, directory: str) -> int:
        """Append buffered step records as JSONL and drain (the
        exporter streams without duplicating — same contract as
        Tracer.dump)."""
        with self._lock:
            recs, n = list(self._records), len(self._records)
            self._records.clear()
        if not recs:
            return 0
        os.makedirs(directory, exist_ok=True)
        with open(self.profile_path(directory), "a") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
        return n

    def reset(self) -> None:
        """Test isolation: drop records/aggregates and unpin; the build
        counters rewind."""
        with self._lock:
            self._records.clear()
            self._next_index = 0
            self._steps_total = 0
            self._current_any = None
            self._watched.clear()
            self._agg_phase_ms.clear()
            self._agg_stall_ms = 0.0
            self._agg_wall_ms = 0.0
            self._agg_attr_ms = 0.0
            self._agg_overlap_ms = 0.0
            self._steady_recompiles = 0
            self._open_count = 0
            self._open_warmup = 0
            self._rank_pinned = False
            self.rank = 0
        self._tls = threading.local()
        self.jax.reset()
        self.enabled = False


PROFILER = StepProfiler()


# module-level wrappers (the call-site idiom, like telemetry.trace)
def enabled() -> bool:
    """THE hot-path gate (attribute read, no locks)."""
    return PROFILER.enabled


def configure(rank: Optional[int] = None) -> None:
    PROFILER.configure(rank)


def step(name: str = "step"):
    return PROFILER.step(name)


def phase(name: str, step: Optional[Step] = None):
    return PROFILER.phase(name, step=step)


def current_step() -> Optional[Step]:
    return PROFILER.current_step()


def async_begin(name: str, step: Optional[Step] = None,
                attach: str = "thread",
                trace: Optional[int] = None) -> Optional[AsyncSpan]:
    return PROFILER.async_begin(name, step=step, attach=attach,
                                trace=trace)


def note_async(name: str, t0: float, t1: float,
               step: Optional[Step] = None, attach: str = "thread"
               ) -> None:
    PROFILER.note_async(name, t0, t1, step=step, attach=attach)


def note_transfer(nbytes: int) -> None:
    PROFILER.note_transfer(nbytes)


def watch_jit(name: str, fn: Any) -> None:
    PROFILER.watch_jit(name, fn)


def note_compile(seconds: float) -> None:
    """A native library was built (``ops/_build.py``,
    ``native/__init__.py``); counted whether or not profiling is on."""
    PROFILER.jax.note_compile(seconds)


def note_load() -> None:
    """A native library was loaded."""
    PROFILER.jax.note_load()


def jax_counters() -> Dict[str, Any]:
    return PROFILER.jax_counters()


def records() -> List[Dict[str, Any]]:
    return PROFILER.records()


def summary() -> Dict[str, Any]:
    return PROFILER.summary()


def stats_snapshot() -> Optional[Dict[str, Any]]:
    return PROFILER.stats_snapshot()


def dump_to(directory: str) -> int:
    return PROFILER.dump_to(directory)


def reset() -> None:
    PROFILER.reset()
