"""Admission control for the serving plane: token buckets + priorities
(port of ``multiverso_tpu/serving/admission.py``).

The overload failure mode this prevents: an inference storm (zipf-hot
users, retry amplification) saturates the process serving reads, and
the *training* write path — the thing that must never stall, or the
model stops improving — degrades behind it. The standard fix is to
shed load at the door, by priority class: a read refused in
microseconds costs one client a retry; a read admitted into an
overloaded plane costs every op behind it.

* :class:`TokenBucket` — the classic rate limiter: ``rate`` tokens/s
  refill up to ``burst``; an acquire that can't be covered fails
  immediately (never blocks — shedding must be cheap precisely when
  the plane is busiest).
* :class:`AdmissionController` — per-``(table, class)`` buckets with
  two priority classes: ``"train"`` (optimizer traffic; admitted
  unconditionally unless an explicit limit is set — training writes
  are never starved by inference reads) and ``"infer"`` (the serving
  tier; limited by ``serving_infer_qps`` or per-table overrides).
  Decisions are counted per (table, class) and surfaced through the
  MSG_STATS ``serving`` block (ps/service.stats_payload) next to the
  replica counters; the reader-facing ``table[X].get.shed`` Dashboard
  counter is bumped by the caller that owns the read path
  (serving/replica.py), so one shed is never double-counted.

Shedding raises :class:`SheddingError` (via the caller) rather than
queueing: bounded-staleness replicas make retries cheap, and a queue
in front of an overloaded server is just a slower way to time out.

Not ported (ROADMAP.md §A, Telemetry and tools): the per-tenant budgets
(``set_tenant_limit``, ``tenant_stats``); ``admit`` with a named tenant
raises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from multiverso_tpu_torch.utils import config

config.define_float(
    "serving_infer_qps", 0.0,
    "default per-table admission rate (queries/s) for the 'infer' "
    "priority class on the serving read plane (serving/replica.py); "
    "reads over the budget are shed immediately with SheddingError. "
    "0 = unlimited. Per-table overrides via "
    "AdmissionController.set_limit")
config.define_float(
    "serving_burst_s", 1.0,
    "token-bucket burst depth, in seconds of the configured rate "
    "(burst = rate * serving_burst_s, floored at 1 token): how big an "
    "instantaneous spike is absorbed before shedding starts")

#: priority classes, highest first. "train" is the optimizer's traffic
#: (writes AND the trainer's own reads): admitted unconditionally
#: unless an explicit limit is installed for it. "infer" is the
#: serving tier: limited, shed first.
CLASSES = ("train", "infer")


class SheddingError(RuntimeError):
    """A read refused by admission control (over the class's QPS
    budget). Deliberately NOT a PSError: the PS plane is healthy —
    the caller asked for more than its class is budgeted, and should
    back off and retry, not fail over."""


class TokenBucket:
    """``rate`` tokens/s refilling up to ``burst``; ``try_acquire``
    never blocks. Thread-safe; refill is computed lazily from the
    monotonic clock on each acquire (no timer thread)."""

    __slots__ = ("rate", "burst", "_tokens", "_at", "_lock")

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError("TokenBucket rate must be positive")
        self.rate = float(rate)
        if burst is None:
            burst = max(rate * config.get_flag("serving_burst_s"), 1.0)
        self.burst = float(burst)
        self._tokens = self.burst   # start full: a fresh limiter must
        self._at: Optional[float] = None   # not shed the first burst;
        #                                    anchored on first acquire so
        #                                    an injected clock (tests)
        #                                    needs no epoch agreement
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0,
                    now: Optional[float] = None) -> bool:
        """Take ``n`` tokens if available; False = shed. ``now`` is an
        injectable monotonic timestamp (tests); out-of-order stamps
        never rewind the refill anchor (no negative minting)."""
        with self._lock:
            t = time.monotonic() if now is None else float(now)
            if self._at is None:
                self._at = t
            elif t > self._at:
                self._tokens = min(self.burst,
                                   self._tokens + (t - self._at) * self.rate)
                self._at = t
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class AdmissionController:
    """Per-(table, class) admission decisions. One controller per
    serving process (the replica holds one); stateless consumers may
    share it across tables."""

    def __init__(self):
        # (table, cls) -> TokenBucket, or None = EXPLICITLY unlimited
        # (an operator's set_limit(..., 0) tombstone — absence means
        # "fall back to the serving_infer_qps flag default", and the
        # two must stay distinguishable or a removal is silently
        # undone by the lazy default on the next admit)
        self._buckets: Dict[Tuple[str, str],
                            Optional[TokenBucket]] = {}
        self._counts: Dict[Tuple[str, str], Dict[str, int]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def set_limit(self, table: str, cls: str, qps: float,
                  burst: Optional[float] = None) -> None:
        """Install (or with ``qps <= 0`` remove) a QPS limit for
        ``(table, cls)``. Removal is an explicit exemption: it also
        overrides the ``serving_infer_qps`` flag default for this
        table, not just a previously installed limit. Installing a
        limit for ``"train"`` is legal but unusual — the default
        priority contract is that training traffic is never shed."""
        if cls not in CLASSES:
            raise ValueError(f"unknown admission class {cls!r} "
                             f"(one of {CLASSES})")
        with self._lock:
            if qps <= 0:
                self._buckets[(table, cls)] = None   # tombstone
            else:
                self._buckets[(table, cls)] = TokenBucket(qps, burst)

    def _bucket(self, table: str, cls: str) -> Optional[TokenBucket]:
        with self._lock:
            key = (table, cls)
            if key in self._buckets:    # explicit limit OR exemption
                return self._buckets[key]
            if cls == "infer":
                # lazy default from the flag, so a flag set after the
                # controller exists still takes effect on first use
                qps = config.get_flag("serving_infer_qps")
                if qps > 0:
                    b = self._buckets[key] = TokenBucket(qps)
                    return b
            return None

    def admit(self, table: str, cls: str = "infer",
              n: float = 1.0, tenant: Optional[str] = None) -> bool:
        """One admission decision (``n`` tokens = usually 1 request —
        QPS budgets queries, not rows). ``"train"`` with no explicit
        limit is always admitted: the priority contract. Never blocks;
        the caller owns what a shed means (raise SheddingError, drop,
        retry-after)."""
        if tenant:
            raise NotImplementedError(
                f"admission for tenant {tenant!r}: per-tenant budgets are "
                "not ported to multiverso_tpu_torch yet (ROADMAP.md §A "
                "Telemetry and tools)")
        bucket = self._bucket(table, cls)
        ok = bucket is None or bucket.try_acquire(n)
        key = (table, cls)
        with self._lock:
            c = self._counts.setdefault(key, {"admitted": 0, "shed": 0})
            c["admitted" if ok else "shed"] += 1
        return ok

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Dict]:
        """JSON-safe per-(table, class) decision counters + limits —
        the MSG_STATS ``serving.admission`` shape."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for (table, cls), c in self._counts.items():
                b = self._buckets.get((table, cls))
                out[f"{table}/{cls}"] = {
                    "admitted": c["admitted"], "shed": c["shed"],
                    "qps_limit": (round(b.rate, 3)
                                  if b is not None else None),
                }
            for (table, cls), b in self._buckets.items():
                if b is None:
                    continue   # explicit exemption: no limit to report
                out.setdefault(f"{table}/{cls}", {
                    "admitted": 0, "shed": 0,
                    "qps_limit": round(b.rate, 3)})
        return out
