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
"""

from __future__ import annotations

import threading
import time
import weakref
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
        # per-(table, tenant, cls) budgets (telemetry/tenants.py): the
        # noisy-neighbor containment knob — a NAMED tenant's bucket is
        # checked BEFORE the table-wide one, so a storm tenant's shed
        # never burns aggregate tokens the victim needed. Same
        # tombstone discipline as the aggregate buckets; the lazy
        # default comes from the tenant_infer_qps flag.
        self._tbuckets: Dict[Tuple[str, str, str],
                             Optional[TokenBucket]] = {}
        self._tcounts: Dict[Tuple[str, str, str], Dict[str, int]] = {}
        self._lock = threading.Lock()
        _CONTROLLERS.add(self)

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

    def set_tenant_limit(self, table: str, tenant: str, cls: str,
                         qps: float,
                         burst: Optional[float] = None) -> None:
        """Install (or with ``qps <= 0`` remove) a QPS budget for
        ``(table, tenant, cls)``. Removal is an explicit exemption
        overriding the ``tenant_infer_qps`` flag default, same
        discipline as :meth:`set_limit`."""
        if cls not in CLASSES:
            raise ValueError(f"unknown admission class {cls!r} "
                             f"(one of {CLASSES})")
        if not tenant:
            raise ValueError("per-tenant limits need a named tenant "
                             "(use set_limit for the table-wide budget)")
        with self._lock:
            key = (table, tenant, cls)
            if qps <= 0:
                self._tbuckets[key] = None   # tombstone
            else:
                self._tbuckets[key] = TokenBucket(qps, burst)

    def _tenant_bucket(self, table: str, tenant: str,
                       cls: str) -> Optional[TokenBucket]:
        with self._lock:
            key = (table, tenant, cls)
            if key in self._tbuckets:   # explicit limit OR exemption
                return self._tbuckets[key]
            if cls == "infer":
                # lazy flag default for NAMED tenants only — the
                # default tenant is governed by the table-wide budget
                qps = (config.get_flag("tenant_infer_qps")
                       if config.has_flag("tenant_infer_qps") else 0.0)
                if qps > 0:
                    b = self._tbuckets[key] = TokenBucket(qps)
                    return b
            return None

    def admit(self, table: str, cls: str = "infer",
              n: float = 1.0, tenant: Optional[str] = None) -> bool:
        """One admission decision (``n`` tokens = usually 1 request —
        QPS budgets queries, not rows). ``"train"`` with no explicit
        limit is always admitted: the priority contract. A NAMED
        tenant's budget is judged first — a tenant-shed request never
        draws down the table-wide bucket. Never raises, never blocks;
        the caller owns what a shed means (raise SheddingError, drop,
        retry-after)."""
        if tenant:
            tb = self._tenant_bucket(table, tenant, cls)
            if tb is not None:
                ok_t = tb.try_acquire(n)
                tkey = (table, tenant, cls)
                with self._lock:
                    c = self._tcounts.setdefault(
                        tkey, {"admitted": 0, "shed": 0})
                    c["admitted" if ok_t else "shed"] += 1
                if not ok_t:
                    return False
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

    def tenant_stats(self) -> Dict[str, Dict]:
        """Per-(table, tenant, class) decision counters + limits — the
        MSG_STATS ``tenants.admission`` shape (keys
        ``"<table>/<tenant>/<cls>"``). Empty when no tenant budget was
        ever installed or exercised."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for (table, tn, cls), c in self._tcounts.items():
                b = self._tbuckets.get((table, tn, cls))
                out[f"{table}/{tn}/{cls}"] = {
                    "admitted": c["admitted"], "shed": c["shed"],
                    "qps_limit": (round(b.rate, 3)
                                  if b is not None else None),
                }
            for (table, tn, cls), b in self._tbuckets.items():
                if b is None:
                    continue
                out.setdefault(f"{table}/{tn}/{cls}", {
                    "admitted": 0, "shed": 0,
                    "qps_limit": round(b.rate, 3)})
        return out


# every live controller, so the process-global MSG_STATS "tenants"
# block (telemetry/tenants.py stats_snapshot) can gather tenant budget
# decisions without the ledger holding controller references — a
# replica pool closing drops out of the block automatically
_CONTROLLERS: "weakref.WeakSet[AdmissionController]" = weakref.WeakSet()


def tenant_stats_all() -> Dict[str, Dict]:
    """Merged :meth:`AdmissionController.tenant_stats` across every
    live controller in the process (sums counters for a key two
    controllers share; keeps the first non-None limit)."""
    out: Dict[str, Dict] = {}
    for ctl in list(_CONTROLLERS):
        try:
            for k, v in ctl.tenant_stats().items():
                e = out.get(k)
                if e is None:
                    out[k] = dict(v)
                else:
                    e["admitted"] += v["admitted"]
                    e["shed"] += v["shed"]
                    if e.get("qps_limit") is None:
                        e["qps_limit"] = v.get("qps_limit")
        except Exception:
            continue
    return out
