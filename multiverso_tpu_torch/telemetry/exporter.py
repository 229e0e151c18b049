"""Periodic metrics exporter: Dashboard + shard snapshots to disk (port
of ``multiverso_tpu/telemetry/exporter.py``, the same files and text).

Flag-gated (``metrics_interval_s`` > 0 and a ``metrics_dir``): a daemon
thread wakes every interval and writes

* ``metrics-rank<r>.jsonl`` — one JSON object per interval (append):
  ``{"ts": epoch_s, "rank": r, "monitors": {name: hist-dict}, "shards":
  {table: stats-dict}, "notes": {...}}`` — the same shape MSG_STATS
  returns, so ``multiverso_tpu_torch.tools.dump_metrics`` prints/diffs
  either source.
* ``metrics-rank<r>.prom`` — Prometheus text exposition (atomically
  replaced each interval), for scrape-style consumption.
* buffered trace spans (telemetry/trace.py) appended to
  ``trace-rank<r>.jsonl`` when tracing is on.

Off by default: with ``metrics_interval_s=0`` nothing starts and the
hot path never sees this module. One exporter per process (started by
the first PSService or Zoo.start, whichever comes first); ``stop()``
writes a final snapshot so short runs still leave a record.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, Optional

from multiverso_tpu_torch.utils import config, log

config.define_string(
    "metrics_dir", "",
    "directory for telemetry output (metrics-rank<r>.jsonl JSONL "
    "snapshots, metrics-rank<r>.prom Prometheus text, trace-rank<r>."
    "jsonl spans); empty disables file output")
config.define_float(
    "metrics_interval_s", 0.0,
    "seconds between background metrics exports to metrics_dir; "
    "0 disables the exporter thread (a final snapshot is still written "
    "at shutdown when metrics_dir is set)")


def _prom_name(name: str) -> str:
    """Monitor name -> a Prometheus-safe label value (names like
    ``table[we].add_rows`` keep their structure inside the label)."""
    return name.replace('"', "'").replace("\\", "/")


# monitor names of the forms ``table[X].op`` / ``ps[X].op`` carry the
# table identity inside the name; surface it as a first-class label
_NAME_TABLE_RE = re.compile(r"^(?:table|ps)\[([^\]]*)\]")


def _monitor_labels(name: str, rank) -> str:
    """Label set for one monitor line: ``name`` always, plus a ``table``
    label when the name embeds one, plus ``rank`` — so ONE scrape config
    covers an N-rank run (and the aggregator's rank="cluster" output)
    with aggregation by (table, rank) instead of regex-parsing names or
    output filenames."""
    parts = [f'name="{_prom_name(name)}"']
    m = _NAME_TABLE_RE.match(name)
    if m:
        parts.append(f'table="{_prom_name(m.group(1))}"')
    parts.append(f'rank="{rank}"')
    return "{" + ",".join(parts) + "}"


def prometheus_text(payload: Dict) -> str:
    """Render a stats payload (exporter record / MSG_STATS reply meta)
    as Prometheus text exposition."""
    lines = [
        "# HELP mv_monitor_count samples observed per monitor",
        "# TYPE mv_monitor_count counter",
        "# TYPE mv_monitor_total_ms counter",
        "# TYPE mv_monitor_p50_ms gauge",
        "# TYPE mv_monitor_p99_ms gauge",
        "# TYPE mv_monitor_max_ms gauge",
    ]
    rank = payload.get("rank", 0)
    for name in sorted(payload.get("monitors", {})):
        m = payload["monitors"][name]
        lbl = _monitor_labels(name, rank)
        lines.append(f"mv_monitor_count{lbl} {m.get('count', 0)}")
        lines.append(f"mv_monitor_total_ms{lbl} {m.get('sum_ms', 0.0)}")
        # percentile gauges only for monitors with TIMED samples: an
        # incr-only counter (count>0, timed=0) must show "no latency
        # data", not a fake 0.0 ms latency
        if m.get("timed", m.get("count")):
            for k in ("p50_ms", "p99_ms", "max_ms"):
                lines.append(f"mv_monitor_{k}{lbl} {m.get(k, 0.0)}")
    for table in sorted(payload.get("shards", {})):
        s = payload["shards"][table]
        for k, v in sorted(s.items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(
                    f'mv_shard_{k}{{table="{_prom_name(table)}",'
                    f'rank="{rank}"}} {v}')
    # memory plane (telemetry/memstats.py): process gauges + per-
    # component byte gauges off the MSG_STATS "memory" block
    mem = payload.get("memory")
    if isinstance(mem, dict):
        lines.append("# TYPE mv_mem_rss_mb gauge")
        lines.append("# TYPE mv_mem_component gauge")
        for k in ("rss_mb", "hwm_mb", "device_bytes", "samples"):
            v = mem.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f'mv_mem_{k}{{rank="{rank}"}} {v}')
        for k, v in sorted((mem.get("totals") or {}).items()):
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f'mv_mem_total_{k}{{rank="{rank}"}} {v}')
        for comp in sorted(mem.get("components") or {}):
            g = mem["components"][comp]
            if not isinstance(g, dict):
                continue
            for k, v in sorted(g.items()):
                if (isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    lines.append(
                        f'mv_mem_component{{component='
                        f'"{_prom_name(comp)}",field="{_prom_name(k)}",'
                        f'rank="{rank}"}} {v}')
    # device plane (telemetry/devstats.py): transfer/collective/compile
    # counters + the per-device live-buffer rollup off the MSG_STATS
    # "devices" block. Absent block (older peer, no device activity) =
    # no lines — the scrape simply lacks the series, never errors.
    dev = payload.get("devices")
    if isinstance(dev, dict):
        lines.append("# TYPE mv_dev_transfer_bytes counter")
        lines.append("# TYPE mv_dev_collective_calls counter")
        lines.append("# TYPE mv_dev_collective_bytes counter")
        lines.append("# TYPE mv_dev_compiles counter")
        lines.append("# TYPE mv_dev_live_bytes gauge")
        for direction, g in sorted((dev.get("transfers") or {}).items()):
            if not isinstance(g, dict):
                continue
            lbl = (f'{{direction="{_prom_name(direction)}",'
                   f'rank="{rank}"}}')
            lines.append(f"mv_dev_transfer_bytes{lbl} "
                         f"{g.get('bytes', 0)}")
            lines.append(f"mv_dev_transfer_ops{lbl} {g.get('ops', 0)}")
        for op, c in sorted((dev.get("collectives") or {}).items()):
            if not isinstance(c, dict):
                continue
            lbl = f'{{op="{_prom_name(op)}",rank="{rank}"}}'
            lines.append(f"mv_dev_collective_calls{lbl} "
                         f"{c.get('calls', 0)}")
            lines.append(f"mv_dev_collective_bytes{lbl} "
                         f"{c.get('bytes', 0)}")
            lines.append(f"mv_dev_collective_ms{lbl} {c.get('ms', 0.0)}")
        for label, c in sorted(
                (dev.get("compiles_by_mesh") or {}).items()):
            if not isinstance(c, dict):
                continue
            lbl = f'{{mesh="{_prom_name(label)}",rank="{rank}"}}'
            lines.append(f"mv_dev_compiles{lbl} {c.get('compiles', 0)}")
            lines.append(f"mv_dev_compile_seconds{lbl} "
                         f"{c.get('compile_s', 0.0)}")
        for device, g in sorted((dev.get("per_device") or {}).items()):
            if not isinstance(g, dict):
                continue
            lbl = f'{{device="{_prom_name(device)}",rank="{rank}"}}'
            lines.append(f"mv_dev_live_bytes{lbl} {g.get('bytes', 0)}")
            lines.append(f"mv_dev_live_arrays{lbl} {g.get('arrays', 0)}")
        if dev.get("hygiene_findings"):
            lines.append(f'mv_dev_hygiene_findings{{rank="{rank}"}} '
                         f"{dev['hygiene_findings']}")
    # tenant attribution plane (telemetry/tenants.py): per-(table,
    # tenant) serve counters + latency gauges + verdict state off the
    # MSG_STATS "tenants" block. Absent block = no series, like the
    # device plane.
    ten = payload.get("tenants")
    if isinstance(ten, dict):
        lines.append("# TYPE mv_tenant_served_total counter")
        lines.append("# TYPE mv_tenant_shed_total counter")
        lines.append("# TYPE mv_tenant_deferred_total counter")
        lines.append("# TYPE mv_tenant_p99_ms gauge")
        lines.append("# TYPE mv_tenant_share gauge")
        lines.append("# TYPE mv_tenant_episodes counter")
        for table in sorted(ten.get("tables") or {}):
            tt = ten["tables"][table]
            if not isinstance(tt, dict):
                continue
            for tn in sorted(tt):
                e = tt[tn]
                if not isinstance(e, dict):
                    continue
                lbl = (f'{{table="{_prom_name(table)}",'
                       f'tenant="{_prom_name(tn)}",rank="{rank}"}}')
                lines.append(f"mv_tenant_served_total{lbl} "
                             f"{e.get('served', 0)}")
                lines.append(f"mv_tenant_shed_total{lbl} "
                             f"{e.get('shed', 0)}")
                lines.append(f"mv_tenant_deferred_total{lbl} "
                             f"{e.get('deferred', 0)}")
                lines.append(f"mv_tenant_max_age_s{lbl} "
                             f"{e.get('max_age_s', 0)}")
                h = e.get("infer") or {}
                if h.get("timed"):
                    lines.append(f"mv_tenant_p50_ms{lbl} "
                                 f"{h.get('p50_ms', 0.0)}")
                    lines.append(f"mv_tenant_p99_ms{lbl} "
                                 f"{h.get('p99_ms', 0.0)}")
        for tn, sh in sorted((ten.get("shares") or {}).items()):
            if isinstance(sh, (int, float)):
                lines.append(f'mv_tenant_share{{tenant='
                             f'"{_prom_name(tn)}",rank="{rank}"}} {sh}')
        for k, a in sorted((ten.get("admission") or {}).items()):
            if not isinstance(a, dict):
                continue
            lbl = f'{{budget="{_prom_name(k)}",rank="{rank}"}}'
            lines.append(f"mv_tenant_budget_admitted{lbl} "
                         f"{a.get('admitted', 0)}")
            lines.append(f"mv_tenant_budget_shed{lbl} "
                         f"{a.get('shed', 0)}")
        lines.append(f'mv_tenant_episodes{{rank="{rank}"}} '
                     f"{ten.get('episodes', 0)}")
        lines.append(f'mv_tenant_verdict_active{{rank="{rank}"}} '
                     f"{1 if ten.get('active') else 0}")
    # SLO sentinel (telemetry/slo.py): per-objective burn-rate gauges +
    # firing state + episode counters off the MSG_STATS "slo" block.
    # Absent block (sentinel disarmed) = no series, like every plane.
    slo = payload.get("slo")
    if isinstance(slo, dict):
        lines.append("# TYPE mv_slo_firing gauge")
        lines.append("# TYPE mv_slo_burn_fast gauge")
        lines.append("# TYPE mv_slo_burn_slow gauge")
        lines.append("# TYPE mv_slo_value gauge")
        lines.append("# TYPE mv_slo_objective_episodes counter")
        lines.append("# TYPE mv_slo_episodes counter")
        for name in sorted(slo.get("objectives") or {}):
            o = slo["objectives"][name]
            if not isinstance(o, dict):
                continue
            lbl = (f'{{objective="{_prom_name(name)}",'
                   f'kind="{_prom_name(o.get("kind") or "?")}",'
                   f'table="{_prom_name(o.get("table") or "")}",'
                   f'rank="{rank}"}}')
            lines.append(f"mv_slo_firing{lbl} "
                         f"{1 if o.get('firing') else 0}")
            lines.append(f"mv_slo_burn_fast{lbl} "
                         f"{o.get('burn_fast', 0.0)}")
            lines.append(f"mv_slo_burn_slow{lbl} "
                         f"{o.get('burn_slow', 0.0)}")
            v = o.get("value")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                lines.append(f"mv_slo_value{lbl} {v}")
            lines.append(f"mv_slo_objective_episodes{lbl} "
                         f"{o.get('episodes', 0)}")
        lines.append(f'mv_slo_episodes{{rank="{rank}"}} '
                     f"{slo.get('episodes', 0)}")
        s = slo.get("straggler")
        if isinstance(s, dict) and isinstance(s.get("rank"), int):
            lines.append(
                f'mv_slo_straggler_rank{{attribution='
                f'"{_prom_name(s.get("attribution") or "?")}",'
                f'rank="{rank}"}} {s["rank"]}')
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """One per process; see module docstring."""

    def __init__(self, rank: int, directory: str, interval_s: float,
                 stats_fn: Callable[[], Dict]):
        self.rank = int(rank)
        self.directory = directory
        self.interval_s = float(interval_s)
        self._stats_fn = stats_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes export_once: the periodic thread and export_global
        # (PSContext.close) share the JSONL/.prom/.tmp files — two
        # unsynchronized appends can interleave mid-line and corrupt a
        # record
        self._io_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def start(self) -> "MetricsExporter":
        if self.interval_s > 0 and self.directory and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="mv-metrics", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.export_once()
            except Exception as e:  # noqa: BLE001 — telemetry must not
                log.error("metrics export failed: %s", e)  # kill the run

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.directory:
            try:
                self.export_once()   # final snapshot, even interval=0
            except Exception as e:  # noqa: BLE001
                log.error("final metrics export failed: %s", e)

    # ------------------------------------------------------------------ #
    def export_once(self) -> Dict:
        """One snapshot -> JSONL append + .prom replace (+ trace drain).
        Returns the record (tests consume it directly). Serialized on
        ``_io_lock`` — see __init__."""
        payload = dict(self._stats_fn())
        payload["ts"] = round(time.time(), 3)
        payload.setdefault("rank", self.rank)
        if not self.directory:
            return payload
        with self._io_lock:
            os.makedirs(self.directory, exist_ok=True)
            jpath = os.path.join(self.directory,
                                 f"metrics-rank{self.rank}.jsonl")
            with open(jpath, "a") as f:
                f.write(json.dumps(payload) + "\n")
            ppath = os.path.join(self.directory,
                                 f"metrics-rank{self.rank}.prom")
            tmp = ppath + ".tmp"
            with open(tmp, "w") as f:
                f.write(prometheus_text(payload))
            os.replace(tmp, ppath)
        from multiverso_tpu_torch.telemetry import trace as _trace
        _trace.dump_to(self.directory)
        # step-profiler records stream alongside the spans (same
        # drain-on-dump contract): profile-rank<r>.jsonl feeds
        # tools/mvprof.py and dump_metrics show/diff
        from multiverso_tpu_torch.telemetry import profiler as _profiler
        _profiler.dump_to(self.directory)
        return payload


# ------------------------------------------------------------------ #
# process-global lifecycle (first starter wins; idempotent stop)
# ------------------------------------------------------------------ #
_global: Optional[MetricsExporter] = None
_global_lock = threading.Lock()


def default_stats_fn() -> Dict:
    """Dashboard-only payload for processes without a PSService (the
    service installs a richer one that adds its shard registry).
    ``pid`` identifies the OS process: Dashboard monitors are
    PROCESS-global, so a cluster merge over in-process multi-rank
    worlds (test fixtures, bench workers) must pool each process's
    monitors once, not once per rank (aggregator.merge_cluster keys on
    the addr host + pid)."""
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    out = {
        "monitors": {name: snap.hist_dict()
                     for name, snap in Dashboard.snapshot().items()},
        "notes": Dashboard.notes(),
        "shards": {},
        "pid": os.getpid(),
    }
    # device plane: same additive "devices" block PSService.stats_payload
    # carries, so a Zoo-only process (no PS) still exports mv_dev_*
    try:
        from multiverso_tpu_torch.telemetry import devstats as _devstats
        devices = _devstats.stats_snapshot()
        if devices:
            out["devices"] = devices
    except Exception:   # noqa: BLE001 — telemetry never breaks export
        pass
    return out


def ensure_started(rank: int,
                   stats_fn: Optional[Callable[[], Dict]] = None
                   ) -> Optional[MetricsExporter]:
    """Start the process exporter if flags enable it (idempotent; the
    first caller's ``stats_fn`` wins — a PSService starting after Zoo
    upgrades the Dashboard-only exporter to its richer payload)."""
    global _global
    directory = config.get_flag("metrics_dir")
    interval = config.get_flag("metrics_interval_s")
    if not directory:
        return None
    with _global_lock:
        if _global is None:
            _global = MetricsExporter(
                rank, directory, interval,
                stats_fn or default_stats_fn).start()
        elif stats_fn is not None and \
                _global._stats_fn is default_stats_fn:
            _global._stats_fn = stats_fn
        return _global


def export_global() -> None:
    """Write one snapshot through the process exporter WITHOUT stopping
    it — the per-context shutdown hook (a process may hold several
    PSContexts; one closing must not kill telemetry for the rest; the
    daemon thread dies with the process or at :func:`stop_global`)."""
    with _global_lock:
        exp = _global
    if exp is not None and exp.directory:
        try:
            exp.export_once()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks
            log.error("metrics export at context close failed: %s", e)


def stop_global() -> None:
    global _global
    with _global_lock:
        exp, _global = _global, None
    if exp is not None:
        exp.stop()
