"""Tenant attribution plane: who is doing what to the PS fleet (port of
``multiverso_tpu/telemetry/tenants.py``, the same flags, blocks and
verdicts).

"Millions of users" means unequal workloads sharing one fleet; without
attribution every counter, histogram, sketch and admission bucket is
tenant-blind — a zipf storm from one tenant is indistinguishable from
organic load.  This module is the merge point for three accounting
surfaces that all key on one tenant id:

* **Identity** — ``current()`` resolves the effective tenant for a call:
  the innermost :func:`tenant_scope` override, else the ``tenant_id``
  flag, else ``None`` (the default tenant).  The id rides wire meta
  under ``wire.TENANT_META_KEY`` and — like every modern meta key — is
  unknown to the native C++ server's whitelist, so stamped frames punt
  to the Python plane: one implementation on both wire planes.  Frames
  are stamped ONLY for non-default tenants, so default traffic keeps
  the cached meta bytes and the native fast path untouched.

* **Shard side** — each shard owns a :class:`TenantMeter`: per-tenant
  op/byte counters plus a Space-Saving sketch (reusing
  ``telemetry/hotkeys.py``) for ranking past the exact-entry cap.  The
  default-tenant path is ONE attribute read + ONE dict increment per
  op (benign-race, the same tolerance as the shard's ``_stat_gets``);
  named tenants pay a small lock and cap at ``tenant_track_max`` exact
  entries (overflow folds into ``"~other"``, the sketch keeps ranking).

* **Serve side** — the process-global :data:`LEDGER` records per-
  ``(table, tenant)`` served/shed/deferred counts, a latency
  histogram, and served staleness at the pool/replica boundary, and
  runs the NOISY-NEIGHBOR verdict sweep: one tenant's interval traffic
  share crosses ``tenant_storm_share`` while ANOTHER tenant degrades
  (sheds, defers, or serves near its staleness bound) -> one structured
  log + one flightrec event per episode (the watchdog's verdict discipline),
  deduped until the condition clears.

``stats_snapshot()`` is the MSG_STATS ``"tenants"`` block; the
aggregator dedupes it per process and sums the shard meters per rank,
``mvtop``/``dump_metrics`` render it, the exporter emits ``mv_tenant_*``
gauges, and the chaos matrix's ``noisy_neighbor`` scenario
(``examples/chaos.py``) gates on it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.telemetry import hotkeys as _hotkeys
from multiverso_tpu_torch.telemetry.histogram import Histogram
from multiverso_tpu_torch.utils import config, log

config.define_string(
    "tenant_id", "",
    "Process-default tenant id stamped on PS traffic (wire meta key "
    "'tn'). Empty = the default tenant: frames stay unstamped and keep "
    "the native fast path + cached meta bytes. Per-call overrides via "
    "tenants.tenant_scope() win over this flag.")
config.define_float(
    "tenant_storm_share", 0.6,
    "Noisy-neighbor verdict threshold: a tenant whose share of the "
    "interval's serve traffic crosses this (with >= 2 tenants active) "
    "is a storm candidate; the verdict fires when another tenant "
    "degrades (sheds, defers, or serves near its staleness bound) in "
    "the same interval.")
config.define_float(
    "tenant_infer_qps", 0.0,
    "Default per-(table, tenant) infer admission budget (qps) applied "
    "lazily to NAMED tenants with no explicit set_tenant_limit. 0 = "
    "no per-tenant bucket (the table-wide budget still applies).")
config.define_float(
    "tenant_add_qps", 0.0,
    "Per-(table, tenant) client-side add budget (qps) at the send "
    "window. Over-budget train adds are COUNTED as deferred, never "
    "dropped (writes are sacred); 0 disables the bucket.")
config.define_int(
    "tenant_track_max", 32,
    "Exact per-tenant entries kept per shard meter and per serve-ledger "
    "table; tenants past the cap fold into '~other' (the Space-Saving "
    "sketch still ranks them).")
config.define_float(
    "tenant_stale_frac", 0.9,
    "Fraction of a read's staleness bound at which a tenant's served "
    "age counts as degraded for the noisy-neighbor verdict sweep.")

# the unnamed tenant's display key in every stats block
DEFAULT_TENANT = "default"
# fold-in key once a meter passes tenant_track_max exact entries
OTHER_TENANT = "~other"

_tls = threading.local()
_tenant_id = config.reader("tenant_id")   # read on every PS op


def current() -> Optional[str]:
    """Effective tenant id for this call: innermost :func:`tenant_scope`
    override > ``tenant_id`` flag > ``None`` (default tenant). An
    override of ``""`` explicitly selects the default tenant."""
    tn = getattr(_tls, "tenant", None)
    if tn is not None:
        return tn or None
    return _tenant_id() or None


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[None]:
    """Per-call override: every PS op issued inside the block is
    attributed (and wire-stamped) as ``tenant``. Nests; ``None``/``""``
    select the default tenant explicitly."""
    prev = getattr(_tls, "tenant", None)
    _tls.tenant = tenant or ""
    try:
        yield
    finally:
        _tls.tenant = prev


def label(tenant: Optional[str]) -> str:
    """Stats-block display key for a resolved tenant id."""
    return tenant if tenant else DEFAULT_TENANT


# ---------------------------------------------------------------------- #
# shard-side meter
# ---------------------------------------------------------------------- #
class TenantMeter:
    """Per-shard per-tenant op/byte counters + Space-Saving ranking.

    The default-tenant path (the overwhelmingly common one) is one
    attribute read and one dict increment — benign-race by design, the
    same tolerance the shard's ``_stat_gets`` documents. Named tenants
    take a lock: they are the minority traffic attribution exists for,
    and exactness there is what the two-tenant oracle test checks.
    """

    __slots__ = ("default", "_named", "_cap", "_sketch", "_lock")

    def __init__(self, track_max: Optional[int] = None,
                 sketch_capacity: int = 64) -> None:
        self.default = {"ops": 0, "add_bytes": 0, "get_bytes": 0}
        self._named: Dict[str, Dict[str, int]] = {}
        self._cap = int(config.get_flag("tenant_track_max")
                        if track_max is None else track_max)
        self._sketch = (_hotkeys.SpaceSaving(sketch_capacity)
                        if sketch_capacity > 0 else None)
        self._lock = threading.Lock()

    def note(self, tenant: Optional[str], ops: int = 1,
             add_bytes: int = 0, get_bytes: int = 0) -> None:
        if not tenant:
            d = self.default
            d["ops"] += ops
            if add_bytes:
                d["add_bytes"] += add_bytes
            if get_bytes:
                d["get_bytes"] += get_bytes
            return
        with self._lock:
            e = self._named.get(tenant)
            if e is None:
                key = (tenant if len(self._named) < self._cap
                       else OTHER_TENANT)
                e = self._named.get(key)
                if e is None:
                    e = self._named[key] = {
                        "ops": 0, "add_bytes": 0, "get_bytes": 0}
            e["ops"] += ops
            e["add_bytes"] += add_bytes
            e["get_bytes"] += get_bytes
        if self._sketch is not None:
            self._sketch.offer_key(tenant, ops)

    def to_dict(self) -> Dict[str, Any]:
        """The shard-stats ``"tenants"`` sub-entry: {tenant: counters},
        plus the ranking sketch once named traffic exists. Empty dict
        when the meter never counted (the shard omits the key)."""
        out: Dict[str, Any] = {}
        d = self.default
        if d["ops"] or d["add_bytes"] or d["get_bytes"]:
            out[DEFAULT_TENANT] = dict(d)
        with self._lock:
            for k, v in self._named.items():
                out[k] = dict(v)
        if out and self._sketch is not None and self._sketch.total:
            out["~sketch"] = self._sketch.to_dict()
        return out


# ---------------------------------------------------------------------- #
# serve-side ledger + verdict engine
# ---------------------------------------------------------------------- #
class TenantLedger:
    """Process-global per-(table, tenant) serve accounting + the
    noisy-neighbor verdict sweep (see module docstring). One instance
    per process (:data:`LEDGER`), shared by every pool/replica."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # table -> tenant -> entry
        self._tables: Dict[str, Dict[str, Dict[str, Any]]] = {}
        # sweep state: (table, tenant) -> (served, shed, deferred)
        self._prev: Dict[tuple, tuple] = {}
        self._shares: Dict[str, float] = {}
        self._episode_open = False
        self._episodes = 0
        self._verdicts: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ #
    def _entry(self, table: str, tenant: Optional[str]) -> Dict[str, Any]:
        t = self._tables.get(table)
        if t is None:
            t = self._tables[table] = {}
        key = tenant if tenant else DEFAULT_TENANT
        e = t.get(key)
        if e is None:
            if (key != DEFAULT_TENANT
                    and len(t) >= int(config.get_flag("tenant_track_max"))):
                key = OTHER_TENANT
                e = t.get(key)
            if e is None:
                e = t[key] = {"served": 0, "shed": 0, "deferred": 0,
                              "hist": Histogram(), "max_age_s": 0.0,
                              "win_age_frac": 0.0}
        return e

    def note_serve(self, table: str, tenant: Optional[str],
                   ms: Optional[float] = None,
                   age_s: Optional[float] = None,
                   bound_s: Optional[float] = None) -> None:
        """One served read at the pool/replica boundary."""
        with self._lock:
            e = self._entry(table, tenant)
            e["served"] += 1
            if ms is not None:
                e["hist"].observe(ms)
            if age_s is not None:
                if age_s > e["max_age_s"]:
                    e["max_age_s"] = age_s
                if bound_s and bound_s > 0:
                    frac = age_s / bound_s
                    if frac > e["win_age_frac"]:
                        e["win_age_frac"] = frac

    def note_shed(self, table: str, tenant: Optional[str],
                  n: int = 1) -> None:
        """A shed read (admission refused it). One flightrec record per
        shed — sheds are rare by construction (the budget already
        throttled the caller) and each is forensic signal."""
        with self._lock:
            self._entry(table, tenant)["shed"] += n
        _flight.record(_flight.EV_TENANT_SHED,
                       note=f"{table}:{label(tenant)}"[:120])

    def note_deferred(self, table: str, tenant: Optional[str],
                      n: int = 1) -> None:
        """A deferred op: a read that forced a synchronous freshness
        refresh, or an over-budget train add that was counted (never
        dropped) at the send window."""
        with self._lock:
            self._entry(table, tenant)["deferred"] += n

    # ------------------------------------------------------------------ #
    # noisy-neighbor verdict sweep
    # ------------------------------------------------------------------ #
    def sweep(self, now: Optional[float] = None) -> Optional[Dict]:
        """One verdict interval: per-tenant traffic shares from the
        served+shed deltas since the last sweep; fires/clears the
        noisy-neighbor episode (one structured log + one flightrec
        event per episode). Runs on every ``stats_snapshot`` pull —
        the same pull-driven cadence as the memstats gauges."""
        storm_share = float(config.get_flag("tenant_storm_share"))
        stale_frac = float(config.get_flag("tenant_stale_frac"))
        fired: Optional[Dict] = None
        with self._lock:
            d_ops: Dict[str, int] = {}
            degraded: Dict[str, List[str]] = {}
            for table, tens in self._tables.items():
                for tn, e in tens.items():
                    key = (table, tn)
                    ps, pk, pd = self._prev.get(key, (0, 0, 0))
                    ds = e["served"] - ps
                    dk = e["shed"] - pk
                    dd = e["deferred"] - pd
                    self._prev[key] = (e["served"], e["shed"],
                                       e["deferred"])
                    d_ops[tn] = d_ops.get(tn, 0) + ds + dk
                    why = []
                    if dk > 0:
                        why.append("shed")
                    if dd > 0:
                        why.append("deferred")
                    if e["win_age_frac"] >= stale_frac > 0:
                        why.append("stale")
                    e["win_age_frac"] = 0.0
                    if why:
                        degraded.setdefault(tn, []).extend(
                            w for w in why if w not in
                            degraded.get(tn, []))
            total = sum(d_ops.values())
            active = [tn for tn, d in d_ops.items() if d > 0]
            if total > 0:
                self._shares = {tn: round(d / total, 4)
                                for tn, d in d_ops.items()}
            storm = None
            if total > 0 and len(active) >= 2:
                top = max(active, key=lambda tn: d_ops[tn])
                if d_ops[top] / total >= storm_share:
                    storm = top
            victims = sorted(tn for tn in degraded if tn != storm)
            cond = storm is not None and bool(victims)
            if cond and not self._episode_open:
                self._episode_open = True
                self._episodes += 1
                fired = {
                    "kind": "noisy-neighbor",
                    "tenant": storm,
                    "share": round(d_ops[storm] / total, 4),
                    "victims": victims,
                    "why": sorted({w for v in victims
                                   for w in degraded[v]}),
                    "ts": round(time.time() if now is None else now, 3),
                }
                self._verdicts.append(fired)
                del self._verdicts[:-16]
            elif not cond and self._episode_open:
                self._episode_open = False
                log.info("tenants: noisy-neighbor episode cleared")
        if fired is not None:
            _flight.record(
                _flight.EV_TENANT_VERDICT,
                note=(f"noisy-neighbor {fired['tenant']} "
                      f"share={fired['share']:.2f}")[:120])
            log.error("tenants: noisy-neighbor verdict %s",
                      json.dumps(fired))
        return fired

    # ------------------------------------------------------------------ #
    # consumer shapes
    # ------------------------------------------------------------------ #
    def stats_snapshot(self) -> Dict[str, Any]:
        """The MSG_STATS ``"tenants"`` block. Process-global like the
        serving block (the aggregator dedupes by (host, pid)); empty
        dict (block omitted) on processes that never served. Pulling a
        snapshot runs one verdict sweep."""
        self.sweep()
        from multiverso_tpu_torch.serving import admission as _admission
        with self._lock:
            tables: Dict[str, Any] = {}
            for table, tens in self._tables.items():
                tt: Dict[str, Any] = {}
                for tn, e in tens.items():
                    tt[tn] = {
                        "served": e["served"],
                        "shed": e["shed"],
                        "deferred": e["deferred"],
                        "max_age_s": round(e["max_age_s"], 4),
                        "infer": e["hist"].as_dict(),
                    }
                tables[table] = tt
            out: Dict[str, Any] = {}
            if tables:
                out["tables"] = tables
                out["shares"] = dict(self._shares)
                out["episodes"] = self._episodes
                out["active"] = self._episode_open
                if self._verdicts:
                    out["verdict"] = dict(self._verdicts[-1])
        adm = _admission.tenant_stats_all()
        if adm:
            out["admission"] = adm
            out.setdefault("episodes", self._episodes)
            out.setdefault("active", self._episode_open)
        return out

    def episodes(self) -> int:
        with self._lock:
            return self._episodes

    def verdicts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._verdicts)

    def reset(self) -> None:
        """Test isolation helper (mirrors memstats.LEDGER.reset)."""
        with self._lock:
            self._tables.clear()
            self._prev.clear()
            self._shares.clear()
            self._episode_open = False
            self._episodes = 0
            self._verdicts.clear()


LEDGER = TenantLedger()


def stats_snapshot() -> Dict[str, Any]:
    return LEDGER.stats_snapshot()


def reset() -> None:
    """Test isolation: drop the ledger AND this thread's scope override
    (a test that crashed inside tenant_scope must not re-attribute its
    neighbors' traffic)."""
    LEDGER.reset()
    _tls.tenant = None
