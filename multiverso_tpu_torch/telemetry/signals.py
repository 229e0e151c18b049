"""Typed autoscaling signal bus (port of
``multiverso_tpu/telemetry/signals.py``, the same signals): every
signal an autoscaler needs (shed rate, hot-key mass, replica lag, queue
depth, burn rates, warm-spare counts) is surfaced by mvtop's panels as
rendered text. This module derives them from the SAME merged cluster
record as typed :class:`Signal` values and publishes them on a
subscribable bus, so a policy loop
(``multiverso_tpu_torch/tools/mvautoscale.py``) consumes exactly what
the operator sees — no second measurement path to drift.

* :func:`from_record` is pure: one aggregator record -> the signal
  list (tested directly, like mvtop's ``render``);
* :class:`SignalBus` keeps the latest value per (name, table) and
  fans each publish out to subscribers (exceptions swallowed + logged
  — telemetry never takes the poller down);
* the aggregator publishes every poll through :func:`publish_record`,
  so ``BUS.snapshot()`` is always one poll fresh.

Signal names are a closed set (:data:`SIGNAL_NAMES`):
``multiverso_tpu_torch/tools/check_obs_surface.py`` lint 7 reads the
tuple by ast and
requires every name to render in mvtop/dump_metrics — a signal the
bus carries but no pane of glass shows is an autoscaler input nobody
can audit.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from multiverso_tpu_torch.utils import log

# the closed signal vocabulary (ast-read by check_obs_surface lint 7)
SIGNAL_NAMES = (
    "shed_rate",            # windowed shed fraction of serve demand
    "hot_key_mass",         # top-8 sketched rows' share of served ops
    "replica_lag_epochs",   # max shard version - min replica epoch
    "replica_lag_s",        # worst replica/member staleness seconds
    "queue_depth",          # server apply backlog per table
    "burn_rate",            # worst fast-window SLO burn (slo block)
    "spares_left",          # warm spares a pool could still promote
    "active_replicas",      # pool members currently serving
    "stall_fraction",       # worst profiled rank's unattributed wall
)


class Signal(NamedTuple):
    name: str
    table: Optional[str]
    value: float
    ts: float
    detail: Dict[str, Any]


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) \
        and not isinstance(v, bool) else None


def from_record(rec: Dict[str, Any]) -> List[Signal]:
    """One merged cluster record -> every derivable signal (pure).
    Absent blocks contribute nothing — the bus carries evidence, not
    placeholders."""
    ts = float(rec.get("ts") or 0.0)
    out: List[Signal] = []

    def emit(name, table, value, **detail):
        v = _num(value)
        if v is not None:
            out.append(Signal(name, table, v, ts, detail))

    tables = rec.get("tables") or {}
    for t, tb in tables.items():
        if isinstance(tb, dict):
            emit("queue_depth", t, tb.get("queue_depth"))
    for t, s in (rec.get("serving") or {}).items():
        if not isinstance(s, dict):
            continue
        r = s.get("rates") or {}
        served, shed = _num(r.get("served_per_s")), _num(r.get("shed_per_s"))
        if served is not None and shed is not None and served + shed > 0:
            emit("shed_rate", t, shed / (served + shed),
                 served_per_s=served, shed_per_s=shed)
        ages = [_num(e.get("age_s"))
                for e in (s.get("replicas") or {}).values()
                if isinstance(e, dict)]
        epochs = [_num(e.get("epoch"))
                  for e in (s.get("replicas") or {}).values()
                  if isinstance(e, dict)]
        spares = active = 0
        have_pool = False
        for p in (s.get("pools") or {}).values():
            if not isinstance(p, dict):
                continue
            have_pool = True
            spares += int(p.get("spares_left") or 0)
            active += int(p.get("active") or 0)
            for m in p.get("members", []):
                if isinstance(m, dict) and m.get("active"):
                    ages.append(_num(m.get("age_s")))
                    epochs.append(_num(m.get("epoch")))
        ages = [a for a in ages if a is not None]
        if ages:
            emit("replica_lag_s", t, max(ages))
        epochs = [e for e in epochs if e is not None]
        versions = [_num(sh.get("version"))
                    for sh in (tables.get(t, {}).get("shards")
                               or {}).values() if isinstance(sh, dict)]
        versions = [v for v in versions if v is not None]
        if epochs and versions:
            emit("replica_lag_epochs", t,
                 max(0.0, max(versions) - min(epochs)),
                 head_version=max(versions), min_epoch=min(epochs))
        if have_pool:
            emit("spares_left", t, spares)
            emit("active_replicas", t, active)
    for t, h in (rec.get("hotkeys") or {}).items():
        if not isinstance(h, dict):
            continue
        total = _num(h.get("total"))
        top = h.get("top") or []
        if total and top:
            mass = sum(c for _k, c, *_ in top[:8]
                       if isinstance(c, (int, float))) / total
            emit("hot_key_mass", t, mass, top_k=min(len(top), 8))
    stalls = [_num(p.get("stall_fraction"))
              for p in (rec.get("profile") or {}).values()
              if isinstance(p, dict)]
    stalls = [s for s in stalls if s is not None]
    if stalls:
        emit("stall_fraction", None, max(stalls))
    slo = rec.get("slo")
    if isinstance(slo, dict):
        burns = {name: _num(o.get("burn_fast"))
                 for name, o in (slo.get("objectives") or {}).items()
                 if isinstance(o, dict)}
        burns = {n: b for n, b in burns.items() if b is not None}
        if burns:
            worst = max(burns, key=burns.get)
            emit("burn_rate", None, burns[worst],
                 objective=worst, firing=list(slo.get("firing") or []))
    return out


class SignalBus:
    """Latest-value store + subscriber fan-out. ``subscribe(fn)`` gets
    every signal; ``subscribe(fn, name=...)`` filters. Subscriber
    exceptions are logged and swallowed — a broken policy loop must
    not stall the aggregator's poll."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._latest: Dict[tuple, Signal] = {}
        self._subs: List[tuple] = []   # (fn, name-or-None)

    def subscribe(self, fn: Callable[[Signal], None],
                  name: Optional[str] = None) -> Callable[[], None]:
        """Register; returns the unsubscribe callable."""
        entry = (fn, name)
        with self._lock:
            self._subs.append(entry)

        def unsubscribe() -> None:
            with self._lock:
                if entry in self._subs:
                    self._subs.remove(entry)
        return unsubscribe

    def publish(self, signals: List[Signal]) -> None:
        with self._lock:
            for s in signals:
                self._latest[(s.name, s.table)] = s
            subs = list(self._subs)
        for s in signals:
            for fn, name in subs:
                if name is not None and name != s.name:
                    continue
                try:
                    fn(s)
                except Exception as e:   # noqa: BLE001
                    log.error("signal subscriber failed on %s: %s",
                              s.name, e)

    def latest(self, name: str,
               table: Optional[str] = None) -> Optional[Signal]:
        with self._lock:
            return self._latest.get((name, table))

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """{name: {table-or-"": {"value", "ts", "detail"}}} — the
        shape ``tools/mvautoscale.py`` recommends from."""
        with self._lock:
            out: Dict[str, Dict[str, Dict[str, Any]]] = {}
            for (name, table), s in self._latest.items():
                out.setdefault(name, {})[table or ""] = {
                    "value": s.value, "ts": s.ts,
                    "detail": dict(s.detail)}
            return out

    def reset(self) -> None:
        with self._lock:
            self._latest = {}
            self._subs = []


BUS = SignalBus()


def publish_record(rec: Dict[str, Any]) -> List[Signal]:
    """Derive + publish one record's signals on the process bus (the
    aggregator calls this every poll)."""
    signals = from_record(rec)
    BUS.publish(signals)
    return signals


def snapshot() -> Dict[str, Dict[str, Dict[str, Any]]]:
    return BUS.snapshot()


def reset() -> None:
    BUS.reset()
