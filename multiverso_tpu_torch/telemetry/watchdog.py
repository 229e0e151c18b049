"""Watchdog: per-request deadlines over the flight recorder's in-flight
table (port of ``multiverso_tpu/telemetry/watchdog.py``).

The PS plane's failure bound today is ``ps_timeout`` (300 s default —
generous because a cold shard's first apply jit-compiles). A wedged
``_SendWindow`` flush or a silently stopped peer therefore costs minutes
of wall-clock before ANYTHING complains, and when it finally does, the
evidence is one timeout string. The watchdog closes that gap with two
earlier thresholds over the recorder's live in-flight ops:

* older than ``watchdog_slow_ms`` — log ONE structured slow-request
  record (JSON: the op, its age, the recorder's recent event window) per
  offending op, and record EV_SLOW in the ring.
* older than ``watchdog_stuck_s`` — the plane is wedged: dump the full
  ring PLUS per-thread Python stacks (``sys._current_frames`` —
  faulthandler-style, but into the same JSONL artifact postmortem
  merges) and record EV_STUCK. Dumps rate-limit to one per
  ``watchdog_stuck_s`` so a long hang produces a fresh artifact, not a
  disk flood.

The verdict of the last check (``last_verdict()``) is the liveness
summary ``MSG_HEALTH`` serves and ``elastic.Heartbeat`` beacons as
``last_health`` — the bit that lets a supervisor distinguish "dead"
from "alive but stuck". One daemon thread per process, started by the
first PSService (flag ``watchdog``); ``check_once()`` is separable so
tests drive thresholds deterministically.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from multiverso_tpu_torch.telemetry import flightrec
from multiverso_tpu_torch.utils import config, log

config.define_bool(
    "watchdog", True,
    "run the PS watchdog thread (per-request slow/stuck deadlines over "
    "the flight recorder; docs/OBSERVABILITY.md). The thread wakes "
    "every watchdog_interval_s and costs nothing between wakeups")
config.define_float(
    "watchdog_slow_ms", 1000.0,
    "in-flight request age (ms) past which the watchdog logs one "
    "structured slow-request record with the recorder's recent window")
config.define_float(
    "watchdog_stuck_s", 30.0,
    "in-flight request age (s) past which the watchdog declares the "
    "plane stuck: full flight-recorder dump + per-thread Python stacks "
    "(rate-limited to one dump per this interval)")
config.define_float(
    "watchdog_interval_s", 0.5,
    "watchdog wakeup period in seconds")


class Watchdog:
    """One per process; see module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._verdict: Dict[str, Any] = {
            "status": "ok", "oldest_inflight_s": 0.0, "inflight": 0,
            "checked": False}
        # (peer, msg_id) keys already slow-logged — one structured
        # record per offending op, not one per wakeup
        self._reported: set = set()
        # -inf, not 0.0: time.monotonic() is seconds-since-boot on
        # Linux, and a 0.0 sentinel would rate-limit away the FIRST
        # stuck dump on any box wedging within watchdog_stuck_s of boot
        self._last_stuck_dump = float("-inf")

    # ------------------------------------------------------------------ #
    def check_once(self) -> Dict[str, Any]:
        """One deadline sweep; returns (and stores) the verdict."""
        slow_s = config.get_flag("watchdog_slow_ms") / 1e3
        stuck_s = config.get_flag("watchdog_stuck_s")
        snap = flightrec.RECORDER.inflight_snapshot()
        oldest = max((e[2] for e in snap), default=0.0)
        status = "ok"
        if snap and oldest >= stuck_s:
            status = "stuck"
            self._trip_stuck(snap, oldest, stuck_s)
        elif snap and oldest >= slow_s:
            status = "slow"
        if snap:
            self._report_slow(snap, slow_s)
        # memory leak verdicts ride the same sweep (telemetry/memstats):
        # an aged read-epoch pin hoarding retired COW buffers is a wedge
        # the in-flight table cannot see — the byte ledger can. Late
        # import (memstats imports flightrec; the watchdog must stay
        # importable standalone) and fault-isolated like everything
        # else in this loop.
        try:
            from multiverso_tpu_torch.telemetry import memstats as _memstats
            _memstats.LEDGER.check_verdicts()
        except Exception as e:   # noqa: BLE001 — verdicts must never
            log.debug("memstats verdict sweep failed: %s", e)  # kill it
        # live keys only: an op that completed may reuse its msg id much
        # later on a reconnected peer and must be reportable again
        live = {(p, mid) for p, mid, _, _, _ in snap}
        verdict = {"status": status,
                   "oldest_inflight_s": round(oldest, 3),
                   "inflight": len(snap), "checked": True,
                   "ts": round(time.time(), 3)}
        with self._lock:
            self._reported &= live
            self._verdict = verdict
        return dict(verdict)

    def _report_slow(self, snap, slow_s: float) -> None:
        # claim under the lock: check_once's prune (`&= live`) runs
        # under it too, and an unlocked add from a concurrent on-demand
        # check_once could be discarded mid-intersection — the same op
        # would then structured-log twice (off the hot path; cheap)
        with self._lock:
            fresh = [e for e in snap
                     if e[2] >= slow_s
                     and (e[0], e[1]) not in self._reported]
            for e in fresh:
                self._reported.add((e[0], e[1]))
        if not fresh:
            return
        # ONE bounded snapshot per sweep, not per offending op: the
        # copy runs under the recorder's lock — the hot path's lock —
        # so it must touch 10 slots, not the whole 4096-slot ring
        recent = [{"ev": flightrec.EV_NAMES.get(s[2], s[2]),
                   "peer": s[3], "msg_id": s[5],
                   "mono": round(s[1], 3)}
                  for s in flightrec.RECORDER.snapshot(last=10)]
        for p, mid, age, mt, nb in fresh:
            flightrec.record(flightrec.EV_SLOW, peer=p, msg_type=mt,
                             msg_id=mid, nbytes=nb)
            log.error("watchdog: slow request %s", json.dumps({
                "peer": p, "msg_id": mid, "type": mt,
                "age_s": round(age, 3), "nbytes": nb, "recent": recent}))

    def _trip_stuck(self, snap, oldest: float, stuck_s: float) -> None:
        now = time.monotonic()
        with self._lock:
            if now - self._last_stuck_dump < stuck_s:
                return
            self._last_stuck_dump = now
        age, p, mid, mt = flightrec.RECORDER.oldest_inflight() or (
            oldest, -1, -1, 0)
        flightrec.record(flightrec.EV_STUCK, peer=p, msg_type=mt,
                         msg_id=mid)
        path = flightrec.dump_global(
            f"watchdog stuck: oldest in-flight op {age:.1f}s "
            f"(peer {p}, msg {mid})", stacks=True)
        log.error("watchdog: PS plane STUCK — oldest in-flight op "
                  "%.1fs old (peer %d, msg %d, %d in flight); %s",
                  age, p, mid, len(snap),
                  f"dumped {path}" if path else
                  "no flightrec_dir/metrics_dir configured, dump skipped")

    # ------------------------------------------------------------------ #
    def last_verdict(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._verdict)

    def start(self) -> "Watchdog":
        with self._lock:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, name="mv-watchdog", daemon=True)
                self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(
                max(config.get_flag("watchdog_interval_s"), 0.05)):
            try:
                self.check_once()
            except Exception as e:   # noqa: BLE001 — the watchdog must
                log.error("watchdog check failed: %s", e)  # outlive bugs

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def reset(self) -> None:
        """Test isolation: stop the thread and forget verdicts."""
        self.stop()
        with self._lock:
            self._verdict = {"status": "ok", "oldest_inflight_s": 0.0,
                             "inflight": 0, "checked": False}
            self._reported.clear()
            self._last_stuck_dump = float("-inf")


WATCHDOG = Watchdog()


def ensure_started() -> Optional[Watchdog]:
    """Start the process watchdog if the flag allows (idempotent; the
    first PSService calls this)."""
    if not config.get_flag("watchdog"):
        return None
    return WATCHDOG.start()


def check_once() -> Dict[str, Any]:
    return WATCHDOG.check_once()


def last_verdict() -> Dict[str, Any]:
    return WATCHDOG.last_verdict()


def stop_global() -> None:
    WATCHDOG.stop()


def reset() -> None:
    WATCHDOG.reset()
