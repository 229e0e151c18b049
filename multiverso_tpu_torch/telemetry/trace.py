"""Wire-correlated trace spans for the async PS plane (port of
``multiverso_tpu/telemetry/trace.py``, the same span format and ID
layout, so the two packages' spans stitch into one chain).

One logical op (say a windowed ``add_rows_async``) crosses four threads
and two processes: caller enqueue -> window flusher -> peer socket ->
shard apply wave. A per-request **trace ID** minted at the client rides
the frame meta (``ps/wire.TRACE_META_KEY``, and each MSG_BATCH inner
frame's own meta), so spans recorded independently on the client
(enqueue, window flush, ack) and on the owning shard (serve, wave apply)
stitch into one causal chain by ID.

Spans are Chrome ``trace_event`` complete events (``"ph": "X"``) with
``ts``/``dur`` in microseconds of ``time.time()`` — an absolute clock, so
events from every rank of a single-host run land on one Perfetto
timeline (``pid`` = PS rank, ``tid`` = OS thread). Files are JSONL (one
event per line, append-friendly across crashes);
``python -m multiverso_tpu_torch.tools.dump_metrics to-perfetto in.jsonl
out.json`` wraps them into the ``{"traceEvents": [...]}`` envelope
viewers expect, and they sit next to the ``torch.profiler`` traces from
``utils/profiling.py`` for side-by-side timelines.

Cost discipline: everything is OFF unless the ``trace_ids`` flag is set.
The hot-path check is one module function returning a plain bool
attribute — no flag-registry lock, no allocation. Natively-served ops
(zero-Python C++ fast path) are not traced by design: the punt path
(MSG_BATCH, compressed wires, MSG_STATS) and the pure-Python plane are.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from multiverso_tpu_torch.utils import config

config.define_bool(
    "trace_ids", False,
    "mint per-request trace IDs on async-PS client ops, carry them in "
    "frame meta, and record trace_event spans on both endpoints "
    "(telemetry/trace.py). Off by default: tracing must cost nothing "
    "when unused. Spans dump to metrics_dir as trace-rank<r>.jsonl")

# bounded span buffer: a forgotten always-on tracer must cap memory, not
# OOM a training run; 200k events is hours of windowed PS traffic
_MAX_EVENTS = 200_000


class Tracer:
    """Process-global span recorder (one per process, like Dashboard)."""

    def __init__(self) -> None:
        self.enabled = False     # plain attribute: the hot-path gate
        self.rank = 0
        self._rank_pinned = False
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=_MAX_EVENTS)
        self._next_id = 0

    # ------------------------------------------------------------------ #
    def configure(self, rank: Optional[int] = None) -> None:
        """Adopt the ``trace_ids`` flag (called from PSService init and
        Zoo.start — the points where flags are settled); idempotent.
        The FIRST caller's rank sticks: a process holding several
        PSContexts (bench workers, test fixtures) must not have the
        last-constructed rank clobber the pid/ID-space of spans already
        attributed to the first — in-process multi-rank spans then all
        carry the first rank, a known (and documented) collapse."""
        if rank is not None and not self._rank_pinned:
            self.rank = int(rank)
            self._rank_pinned = True
        self.enabled = bool(config.get_flag("trace_ids"))

    def new_id(self) -> int:
        """Mint a trace ID unique across processes: the pinned rank in
        the high bits, a process-local counter below (fits JSON's
        exact-int range). Several in-process ranks share one tracer and
        therefore one ID space — still unique, attributed to the first
        rank (see :meth:`configure`)."""
        with self._lock:
            self._next_id += 1
            n = self._next_id
        return ((self.rank & 0xFFFF) << 32) | (n & 0xFFFFFFFF)

    # ------------------------------------------------------------------ #
    def add_span(self, name: str, t0: float, t1: float,
                 trace: Optional[int] = None, cat: str = "ps",
                 args: Optional[Dict] = None) -> None:
        """Record a complete span; ``t0``/``t1`` are ``time.time()``
        seconds. No-op when disabled (callers usually pre-check
        :func:`enabled` to skip even the clock reads)."""
        if not self.enabled:
            return
        a = dict(args) if args else {}
        if trace is not None:
            a["trace"] = trace
        ev = {
            "name": name, "cat": cat, "ph": "X",
            "ts": int(t0 * 1e6), "dur": max(int((t1 - t0) * 1e6), 0),
            "pid": self.rank, "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": a,
        }
        # append under the lock: dump()'s snapshot-then-clear would
        # otherwise drop a span landing between its two steps
        with self._lock:
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, trace: Optional[int] = None,
             cat: str = "ps", **args) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.time()
        try:
            yield
        finally:
            self.add_span(name, t0, time.time(), trace=trace, cat=cat,
                          args=args or None)

    # ------------------------------------------------------------------ #
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._next_id = 0
        self._rank_pinned = False

    def dump(self, path: str, append: bool = True) -> int:
        """Write buffered spans as JSONL; returns the event count. The
        buffer drains (a second dump appends only NEW spans), so the
        periodic exporter can stream without duplicating. The file write
        stays under the lock: two concurrent dumps to the same path
        (exporter tick racing a context-close flush) must not interleave
        their lines mid-record."""
        with self._lock:
            events, n = list(self._events), len(self._events)
            self._events.clear()
            if not events:
                return 0
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "a" if append else "w") as f:
                for e in events:
                    f.write(json.dumps(e) + "\n")
        return n


TRACER = Tracer()


def enabled() -> bool:
    """THE hot-path gate (attribute read, no locks)."""
    return TRACER.enabled


def configure(rank: Optional[int] = None) -> None:
    TRACER.configure(rank)


def new_id() -> int:
    return TRACER.new_id()


def add_span(name: str, t0: float, t1: float, trace: Optional[int] = None,
             cat: str = "ps", args: Optional[Dict] = None) -> None:
    TRACER.add_span(name, t0, t1, trace=trace, cat=cat, args=args)


def span(name: str, trace: Optional[int] = None, cat: str = "ps", **args):
    return TRACER.span(name, trace=trace, cat=cat, **args)


def trace_path(directory: str, rank: Optional[int] = None) -> str:
    """Canonical per-rank trace file path under a metrics dir."""
    r = TRACER.rank if rank is None else rank
    return os.path.join(directory, f"trace-rank{r}.jsonl")


def dump_to(directory: str) -> int:
    """Dump buffered spans to the canonical per-rank file (no-op and 0
    when tracing never recorded anything)."""
    return TRACER.dump(trace_path(directory))
