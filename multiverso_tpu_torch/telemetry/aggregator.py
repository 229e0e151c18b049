"""Controller-side cluster observability: one rank polls every rank
(port of ``multiverso_tpu/telemetry/aggregator.py``, the same records
and files, so either package's tools read the other's).

MSG_STATS and MSG_HEALTH answer questions about ONE
process; every scale-out question — which shard is skewed, which rows
are hot, which rank is falling behind — needs the merged view. This
module is that aggregation layer:

* :class:`ClusterAggregator` — a background poller (flag
  ``stats_poll_interval_s``, default off) on the controller rank (PS
  rank 0) that pulls MSG_STATS + MSG_HEALTH from every rank over
  **one-shot probe connections** (a fresh conn gets a
  fresh handler thread, so a wedged data plane cannot stall the poll,
  and the reply wait is ``ps_health_timeout``-scale, not ``ps_timeout``).
* :func:`merge_cluster` — one poll's payloads -> one cluster record:
  log2 histograms merged EXACTLY (identical fixed buckets everywhere,
  ``telemetry/histogram.py``), per-table shard stats summed with a
  **shard-skew metric** (max/mean row-traffic imbalance), and the
  per-shard Space-Saving sketches merged into a cluster top-K with an
  estimated cache-hit-rate-if-cached curve (``telemetry/hotkeys.py``).
* :func:`derive_rates` — consecutive records -> windowed rates
  (applies/s, gets/s, wire bytes/s), queue-depth deltas, and the
  windowed skew over just that interval's traffic.

The rolling time series appends to ``cluster.jsonl`` (+ an atomically
replaced ``cluster.prom`` reusing the exporter's label scheme) alongside
the per-rank exporter output in ``metrics_dir``; with no directory
set the in-memory history still accumulates (bench/mvtop consume it).
``tools/mvtop.py`` renders the same records live; the merge functions
here are pure so both consumers share one definition.

Lifecycle: the first PSService with rank 0 starts the global aggregator
when the flag enables it (:func:`ensure_started`); ``PSService.close``
stops an aggregator bound to it (:func:`stop_if_bound`) and ``Zoo.stop``
stops whatever remains (:func:`stop_global`), each with a final
short-timeout poll so short runs still leave a record.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch.telemetry import hotkeys as _hotkeys
from multiverso_tpu_torch.telemetry import signals as _signals
from multiverso_tpu_torch.telemetry import slo as _slo
from multiverso_tpu_torch.telemetry.histogram import Histogram
from multiverso_tpu_torch.utils import config, log

config.define_float(
    "stats_poll_interval_s", 0.0,
    "controller-side cluster observability: seconds between aggregator "
    "polls of every rank's MSG_STATS + MSG_HEALTH over one-shot probe "
    "connections (PS rank 0 only). Appends merged cluster records to "
    "cluster.jsonl (+ cluster.prom) under metrics_dir when set. "
    "0 disables the poller entirely")

# per-shard scalar fields copied into a cluster record's per-table
# "shards" map (the summable traffic/occupancy view; histograms and
# sketches are merged separately)
_SHARD_SCALARS = ("kind", "lo", "rows", "adds", "applies", "gets",
                  "get_bytes", "add_bytes", "queue_depth",
                  "pending_bytes", "version", "keys", "dirty_rows",
                  "cow_applies",
                  # stacked-group placement block (ps/spmd.py of either
                  # package): slot -> device + grouped-apply share,
                  # passed through whole when present; the port's
                  # grouped shards emit it as the JAX package's do
                  "spmd")
# fields summed into the per-table cluster totals
_TABLE_SUMS = ("adds", "applies", "gets", "get_bytes", "add_bytes",
               "queue_depth", "rows")


def merge_hist_dicts(dicts: List[Optional[Dict]]) -> Dict:
    """Exactly merge hist-dicts (the MSG_STATS / exporter wire shape):
    every histogram in the system shares one fixed bucket table, so the
    merge is elementwise addition — cluster percentiles are computed on
    the true pooled distribution, not averaged per-rank quantiles."""
    merged = Histogram()
    count = timed = 0
    for d in dicts:
        if not d:
            continue
        t = int(d.get("timed", d.get("count", 0)) or 0)
        h = Histogram.from_nonzero(
            d.get("buckets", []), count=t,
            total=float(d.get("sum_ms", 0.0) or 0.0),
            min_ms=d.get("min_ms") if t else None,
            max_ms=d.get("max_ms") if t else None)
        merged.merge(h)
        timed += t
        count += int(d.get("count", 0) or 0)
    out = merged.as_dict()
    # count keeps incr-only (untimed) events like the source dicts do;
    # timed is the bucket mass percentiles were computed over
    out["count"] = count
    out["timed"] = timed
    return out


def _proc_key(st: Dict, rank) -> tuple:
    """The (addr host, pid) process identity used to dedupe PROCESS-
    global payload blocks (monitors, serving, profile, memory) when
    several in-process ranks report the same registry; payloads
    without a pid (older peers) fall back to per-rank identity. ONE
    definition — four merge sections key on it."""
    pid = st.get("pid")
    if pid is None:
        return ("rank", rank)
    return ((st.get("addr") or "").rsplit(":", 1)[0], pid)


def _skew(traffic: List[float]) -> float:
    """Max/mean imbalance of per-shard traffic; 1.0 = perfectly even
    (and the degenerate empty/zero cases, where no imbalance exists)."""
    vals = [float(v) for v in traffic if v is not None]
    if not vals:
        return 1.0
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return 1.0
    return max(vals) / mean


def merge_cluster(stats_by_rank: Dict[int, Any],
                  health_by_rank: Dict[int, Any],
                  world: Optional[int] = None) -> Dict:
    """One poll's per-rank payloads -> the merged cluster record. Pure
    function (the aggregator thread and ``tools/mvtop.py`` share it).
    Values may be Exceptions — an unreachable rank becomes a per-rank
    error entry, never a failed poll: partial visibility of a degraded
    cluster is exactly when this record matters most."""
    rec: Dict[str, Any] = {"kind": "cluster", "ts": round(time.time(), 3)}
    ranks: Dict[str, Dict] = {}
    for r in sorted(set(stats_by_rank) | set(health_by_rank)):
        h = health_by_rank.get(r)
        if isinstance(h, BaseException) or h is None:
            ent: Dict[str, Any] = {"status": "unreachable"}
            if h is not None:
                ent["error"] = f"{type(h).__name__}: {h}"[:200]
        else:
            ent = {"status": h.get("status", "?"), "addr": h.get("addr"),
                   # incarnation generation (failover plane): a
                   # restarted shard reports its predecessor's + 1
                   "gen": h.get("gen"),
                   "native": h.get("native"),
                   "queue_depth": h.get("queue_depth"),
                   "inflight": h.get("inflight"),
                   "oldest_inflight_s": h.get("oldest_inflight_s"),
                   "serve_age_s": h.get("serve_age_s"),
                   "apply_age_s": h.get("apply_age_s")}
        st = stats_by_rank.get(r)
        if isinstance(st, BaseException):
            ent["stats_error"] = f"{type(st).__name__}: {st}"[:200]
        ranks[str(r)] = ent
    rec["ranks"] = ranks
    rec["world"] = int(world or len(ranks))
    rec["polled"] = sum(1 for st in stats_by_rank.values()
                        if isinstance(st, dict))

    # monitors: pooled histogram per name across every answering
    # PROCESS. Dashboard monitors are process-global, so two ranks
    # served from one OS process (in-process test fixtures, bench
    # workers) return the SAME registry — pooling per rank would double
    # every count. Dedupe by (addr host, pid); payloads without a pid
    # (older peers) fall back to per-rank pooling.
    by_name: Dict[str, List[Dict]] = {}
    seen_procs: set = set()
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        if st.get("pid") is not None:
            proc = _proc_key(st, r)
            if proc in seen_procs:
                continue
            seen_procs.add(proc)
        for name, m in st.get("monitors", {}).items():
            by_name.setdefault(name, []).append(m)
    rec["monitors"] = {n: merge_hist_dicts(ds)
                       for n, ds in sorted(by_name.items())}

    # tables: per-shard scalars keyed by rank, cluster sums, merged
    # apply histogram, skew, merged hot-key sketch. The apply histogram
    # is the shard's ps[<table>].apply Dashboard monitor — PROCESS-
    # global like every monitor, so same-named shards served from one
    # OS process report the SAME pooled distribution: merge it once per
    # (process, table), or the in-process fixtures/bench would record
    # apply.count at 2x the 'applies' scalar beside it. Scalars and
    # sketches are per-shard objects and never dedupe.
    tables: Dict[str, Dict] = {}
    applies_h: Dict[str, List] = {}
    hot: Dict[str, List] = {}
    seen_apply: set = set()
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        proc = _proc_key(st, r)
        for tname, sh in st.get("shards", {}).items():
            if not isinstance(sh, dict) or "error" in sh:
                tables.setdefault(tname, {"shards": {}})["shards"][
                    str(r)] = dict(sh or {})
                continue
            t = tables.setdefault(tname, {"shards": {}})
            t["shards"][str(r)] = {k: sh[k] for k in _SHARD_SCALARS
                                   if k in sh}
            if (proc, tname) not in seen_apply:
                seen_apply.add((proc, tname))
                applies_h.setdefault(tname, []).append(sh.get("apply"))
            if sh.get("hotkeys"):
                hot.setdefault(tname, []).append(sh["hotkeys"])
    for tname, t in tables.items():
        shards = [s for s in t["shards"].values() if "error" not in s]
        for k in _TABLE_SUMS:
            t[k] = sum(int(s.get(k) or 0) for s in shards)
        t["apply"] = merge_hist_dicts(applies_h.get(tname, []))
        t["skew"] = round(_skew(
            [int(s.get("adds") or 0) + int(s.get("gets") or 0)
             for s in shards]), 3)
    rec["tables"] = tables

    # serving plane (read replicas + admission, docs/SERVING.md): the
    # MSG_STATS "serving" block is PROCESS-global like the monitors
    # (serving/replica.stats_snapshot walks a per-process registry), so
    # in-process multi-rank worlds dedupe by (host, pid) the same way;
    # per-replica detail stays keyed by the reporting rank, counters
    # sum across replica processes.
    serving: Dict[str, Dict] = {}
    seen_srv: set = set()
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        srv = st.get("serving")
        if not isinstance(srv, dict):
            continue
        proc = _proc_key(st, r)
        if proc in seen_srv:
            continue
        seen_srv.add(proc)
        for tname, rep in srv.items():
            if not isinstance(rep, dict):
                continue
            ent = serving.setdefault(tname, {
                "replicas": {}, "served": 0, "shed": 0, "deferred": 0,
                "cache_hits": 0, "cache_misses": 0})
            ent["replicas"][str(r)] = {
                k: rep.get(k) for k in
                ("epoch", "age_s", "bound_s", "refresh_ms",
                 "cache_rows", "cache_hit_rate")}
            # ReplicaPool detail (serving/pool.py): passed through per
            # reporting process — per-member route share / staleness
            # lag / degraded flag feed mvtop's pool panel
            if isinstance(rep.get("pool"), dict):
                ent["replicas"][str(r)]["pool"] = rep["pool"]
                ent.setdefault("pools", {})[str(r)] = rep["pool"]
            for k in ("served", "shed", "deferred", "cache_hits",
                      "cache_misses"):
                ent[k] += int(rep.get(k) or 0)
    if serving:
        for ent in serving.values():
            tot = ent["cache_hits"] + ent["cache_misses"]
            ent["cache_hit_rate"] = (round(ent["cache_hits"] / tot, 4)
                                     if tot else None)
            dem = ent["served"] + ent["shed"]
            ent["shed_rate"] = (round(ent["shed"] / dem, 4)
                                if dem else None)
        rec["serving"] = serving
    # step-profiler blocks (flag step_profile): passed through
    # per reporting rank like the serving block, plus two at-a-glance
    # fields folded into the rank entries (mvtop's stall%/recompiles
    # columns). Process-global like the monitors — in-process
    # multi-rank worlds report one process's summary under each of its
    # ranks, the same documented collapse.
    profile: Dict[str, Dict] = {}
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        p = st.get("profile")
        if not isinstance(p, dict):
            continue
        profile[str(r)] = p
        ent = ranks.get(str(r))
        if ent is not None:
            sf = p.get("stall_fraction")
            ent["stall_pct"] = (round(100.0 * sf, 1)
                                if isinstance(sf, (int, float)) else None)
            ent["recompiles"] = p.get("steady_recompiles")
    if profile:
        rec["profile"] = profile
    # memory plane (telemetry/memstats.py): per-rank ledger digests +
    # cluster totals. The block is PROCESS-global like the monitors
    # (one ledger per OS process), so totals dedupe by (host, pid) —
    # an in-process multi-rank world reports the same process under
    # each of its ranks but is summed once.
    memory: Dict[str, Dict] = {}
    mem_totals: Dict[str, float] = {}
    seen_mem: set = set()
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        m = st.get("memory")
        if not isinstance(m, dict):
            continue
        t = m.get("totals") or {}
        ent = {
            "rss_mb": m.get("rss_mb"), "hwm_mb": m.get("hwm_mb"),
            "device_bytes": m.get("device_bytes"),
            "table_bytes": t.get("table_bytes"),
            "retained_bytes": t.get("retained_bytes"),
            "pending_bytes": t.get("pending_bytes"),
            "pinned_epochs": t.get("pinned_epochs"),
            "retired_bytes": t.get("retired_bytes"),
            "samples": m.get("samples"),
            "verdicts": [v.get("kind") for v in (m.get("verdicts") or [])
                         if isinstance(v, dict)][-4:],
        }
        memory[str(r)] = ent
        proc = _proc_key(st, r)
        if proc in seen_mem:
            continue
        seen_mem.add(proc)
        for k in ("rss_mb", "device_bytes", "table_bytes",
                  "retained_bytes", "pending_bytes", "retired_bytes",
                  "pinned_epochs"):
            v = ent.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                mem_totals[k] = mem_totals.get(k, 0) + v
    if memory:
        rec["memory"] = {
            "ranks": memory,
            "totals": {k: (round(v, 3) if k == "rss_mb" else int(v))
                       for k, v in sorted(mem_totals.items())},
        }
    # device plane (telemetry/devstats.py): per-rank "devices" blocks
    # passed through + cluster totals. PROCESS-global like the monitors
    # (one DevStats per OS process), so totals dedupe by (host, pid).
    # The block is ADDITIVE: a payload without it (an older peer in a
    # mixed-version cluster, or a rank with no device activity) simply
    # contributes nothing — no consumer may require it.
    devices: Dict[str, Dict] = {}
    dev_totals: Dict[str, float] = {}
    seen_dev: set = set()
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        d = st.get("devices")
        if not isinstance(d, dict):
            continue
        devices[str(r)] = d
        proc = _proc_key(st, r)
        if proc in seen_dev:
            continue
        seen_dev.add(proc)
        for direction, g in (d.get("transfers") or {}).items():
            if isinstance(g, dict):
                dev_totals[f"{direction}_bytes"] = (
                    dev_totals.get(f"{direction}_bytes", 0)
                    + int(g.get("bytes") or 0))
        for c in (d.get("collectives") or {}).values():
            if isinstance(c, dict):
                dev_totals["coll_calls"] = (
                    dev_totals.get("coll_calls", 0)
                    + int(c.get("calls") or 0))
                dev_totals["coll_bytes"] = (
                    dev_totals.get("coll_bytes", 0)
                    + int(c.get("bytes") or 0))
        for c in (d.get("compiles_by_mesh") or {}).values():
            if isinstance(c, dict):
                dev_totals["compiles"] = (
                    dev_totals.get("compiles", 0)
                    + int(c.get("compiles") or 0))
                dev_totals["compile_s"] = round(
                    dev_totals.get("compile_s", 0.0)
                    + float(c.get("compile_s") or 0.0), 3)
        for g in (d.get("per_device") or {}).values():
            if isinstance(g, dict):
                dev_totals["device_bytes"] = (
                    dev_totals.get("device_bytes", 0)
                    + int(g.get("bytes") or 0))
        if d.get("hygiene_findings"):
            dev_totals["hygiene_findings"] = (
                dev_totals.get("hygiene_findings", 0)
                + int(d["hygiene_findings"]))
    if devices:
        rec["devices"] = {"ranks": devices, "totals": dev_totals}
    # tenant attribution plane (telemetry/tenants.py): the MSG_STATS
    # "tenants" block is PROCESS-global like serving (one ledger per OS
    # process), so serve counters/episodes dedupe by (host, pid);
    # latency histograms merge exactly (shared bucket table). Shard-side
    # meters (shards[<table>]["tenants"]) are per-shard objects like the
    # hot-key sketches: summed per rank, never deduped. ADDITIVE — a
    # payload without the block contributes nothing.
    ten_tables: Dict[str, Dict] = {}
    ten_hists: Dict[tuple, List] = {}
    ten_adm: Dict[str, Dict] = {}
    ten_episodes = 0
    ten_active = False
    ten_verdict: Optional[Dict] = None
    seen_ten: set = set()
    wire_tenants: Dict[str, Dict[str, int]] = {}
    wire_sketches: List[Dict] = []
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if not isinstance(st, dict):
            continue
        # shard meters: per-shard, per-rank — no proc dedupe
        for tname, sh in st.get("shards", {}).items():
            tm = sh.get("tenants") if isinstance(sh, dict) else None
            if not isinstance(tm, dict):
                continue
            for tn, c in tm.items():
                if tn == "~sketch":
                    if isinstance(c, dict):
                        wire_sketches.append(c)
                    continue
                if not isinstance(c, dict):
                    continue
                w = wire_tenants.setdefault(
                    tn, {"ops": 0, "add_bytes": 0, "get_bytes": 0})
                for k in ("ops", "add_bytes", "get_bytes"):
                    w[k] += int(c.get(k) or 0)
        ten = st.get("tenants")
        if not isinstance(ten, dict):
            continue
        proc = _proc_key(st, r)
        if proc in seen_ten:
            continue
        seen_ten.add(proc)
        ten_episodes += int(ten.get("episodes") or 0)
        ten_active = ten_active or bool(ten.get("active"))
        v = ten.get("verdict")
        if isinstance(v, dict) and (ten_verdict is None
                                    or (v.get("ts") or 0)
                                    > (ten_verdict.get("ts") or 0)):
            ten_verdict = v
        for tname, tens in (ten.get("tables") or {}).items():
            if not isinstance(tens, dict):
                continue
            tt = ten_tables.setdefault(tname, {})
            for tn, e in tens.items():
                if not isinstance(e, dict):
                    continue
                ent = tt.setdefault(tn, {"served": 0, "shed": 0,
                                         "deferred": 0, "max_age_s": 0.0})
                for k in ("served", "shed", "deferred"):
                    ent[k] += int(e.get(k) or 0)
                age = float(e.get("max_age_s") or 0.0)
                if age > ent["max_age_s"]:
                    ent["max_age_s"] = age
                ten_hists.setdefault((tname, tn), []).append(
                    e.get("infer"))
        for k, a in (ten.get("admission") or {}).items():
            if not isinstance(a, dict):
                continue
            e = ten_adm.get(k)
            if e is None:
                ten_adm[k] = dict(a)
            else:
                e["admitted"] += int(a.get("admitted") or 0)
                e["shed"] += int(a.get("shed") or 0)
                if e.get("qps_limit") is None:
                    e["qps_limit"] = a.get("qps_limit")
    if ten_tables or wire_tenants or ten_adm:
        share_ops: Dict[str, int] = {}
        for tname, tt in ten_tables.items():
            for tn, ent in tt.items():
                ent["infer"] = merge_hist_dicts(
                    ten_hists.get((tname, tn), []))
                dem = ent["served"] + ent["shed"]
                ent["shed_rate"] = (round(ent["shed"] / dem, 4)
                                    if dem else None)
                share_ops[tn] = share_ops.get(tn, 0) + dem
        tot_ops = sum(share_ops.values())
        tblock: Dict[str, Any] = {
            "tables": ten_tables,
            "shares": ({tn: round(d / tot_ops, 4)
                        for tn, d in sorted(share_ops.items())}
                       if tot_ops else {}),
            "episodes": ten_episodes,
            "active": ten_active,
        }
        if ten_verdict is not None:
            tblock["verdict"] = ten_verdict
        if ten_adm:
            tblock["admission"] = ten_adm
        if wire_tenants:
            tblock["wire"] = wire_tenants
        if wire_sketches:
            merged = _hotkeys.merge_sketches(wire_sketches, key=str)
            tblock["sketch"] = {"total": merged["total"],
                                "observed": merged["observed"],
                                "top": merged["items"][:32]}
        rec["tenants"] = tblock
    if hot:
        rec["hotkeys"] = {}
        for tname, sketches in hot.items():
            merged = _hotkeys.merge_sketches(sketches)
            rec["hotkeys"][tname] = {
                "total": merged["total"],
                "observed": merged["observed"],
                "top": merged["items"][:32],
                "hit_rate_curve": _hotkeys.hit_rate_curve(merged),
            }
    # SLO sentinel passthrough (telemetry/slo.py): the block is judged
    # by ONE sentinel (rank 0's process) and identical wherever it
    # appears — first answering rank wins. A locally-armed sentinel
    # overwrites this with a fresher snapshot right after the merge
    # (poll_once), so the passthrough is what remote pollers (mvtop
    # against another process's cluster) render.
    for r in sorted(stats_by_rank):
        st = stats_by_rank[r]
        if isinstance(st, dict) and isinstance(st.get("slo"), dict):
            rec["slo"] = st["slo"]
            break
    return rec


def derive_rates(prev: Optional[Dict], cur: Dict) -> Optional[Dict]:
    """Windowed view between two consecutive cluster records, written
    into ``cur["rates"]``: per-table applies/s, gets/s, adds/s, wire
    bytes/s, the queue-depth delta, and ``skew_window`` — the imbalance
    of JUST this interval's traffic (the cumulative ``skew`` forgives a
    workload that went skewed after a long even warmup; the windowed one
    does not).

    All deltas are computed PER SHARD over the ranks present (and
    error-free) in BOTH records, then summed — never from the table
    totals. A rank whose stats probe failed in one poll and answered
    the next would otherwise dump its entire cumulative counter history
    into one interval: a phantom rate/skew burst in the time series at
    exactly the degraded moment the plane exists to observe. Such a
    rank simply sits the interval out and rejoins on the next pair of
    clean polls."""
    if not prev or prev.get("kind") != "cluster":
        return None
    dt = float(cur.get("ts", 0)) - float(prev.get("ts", 0))
    if dt <= 0:
        return None
    rates: Dict[str, Any] = {"_interval_s": round(dt, 3)}
    for tname, t in cur.get("tables", {}).items():
        pt = prev.get("tables", {}).get(tname)
        if not pt:
            continue
        # shards observed cleanly at BOTH ends of the interval
        pairs = []
        for r, s in t.get("shards", {}).items():
            ps_ = pt.get("shards", {}).get(r)
            if (ps_ is not None and "error" not in s
                    and "error" not in ps_):
                pairs.append((s, ps_))
        if not pairs:
            continue

        def delta(key):
            return sum(max(int(s.get(key) or 0) - int(ps_.get(key) or 0),
                           0) for s, ps_ in pairs)

        d = {"adds_per_s": round(delta("adds") / dt, 2),
             "gets_per_s": round(delta("gets") / dt, 2),
             "applies_per_s": round(delta("applies") / dt, 2),
             "wire_bytes_per_s": round(
                 (delta("add_bytes") + delta("get_bytes")) / dt, 1),
             "queue_depth_delta": sum(
                 int(s.get("queue_depth") or 0)
                 - int(ps_.get("queue_depth") or 0)
                 for s, ps_ in pairs),
             "skew_window": round(_skew(
                 [max((int(s.get("adds") or 0) + int(s.get("gets") or 0))
                      - (int(ps_.get("adds") or 0)
                         + int(ps_.get("gets") or 0)), 0)
                  for s, ps_ in pairs]), 3)}
        rates[tname] = d
    # serving plane: per-table replica-served / shed rates over the
    # interval, written INTO the serving entries (not the shard-rate
    # block — a serving-only table must not fabricate shard rates)
    prev_srv = prev.get("serving") or {}
    for tname, ent in (cur.get("serving") or {}).items():
        p = prev_srv.get(tname)
        if not isinstance(p, dict):
            continue
        ent["rates"] = {
            "served_per_s": round(
                max(ent.get("served", 0) - p.get("served", 0), 0) / dt,
                2),
            "shed_per_s": round(
                max(ent.get("shed", 0) - p.get("shed", 0), 0) / dt, 2),
        }
    # tenant plane: per-(table, tenant) interval rates, written INTO
    # the merged tenant entries (same discipline as serving — counters
    # absent from either end of the interval sit it out)
    prev_ten = (prev.get("tenants") or {}).get("tables") or {}
    for tname, tt in ((cur.get("tenants") or {}).get("tables")
                      or {}).items():
        pt = prev_ten.get(tname)
        if not isinstance(pt, dict):
            continue
        for tn, ent in tt.items():
            p = pt.get(tn)
            if not isinstance(p, dict):
                continue
            ent["rates"] = {
                "served_per_s": round(
                    max(ent.get("served", 0)
                        - p.get("served", 0), 0) / dt, 2),
                "shed_per_s": round(
                    max(ent.get("shed", 0)
                        - p.get("shed", 0), 0) / dt, 2),
            }
    cur["rates"] = rates
    return rates


def compact_record(rec: Dict, top: int = 8,
                   max_monitors: int = 64) -> Dict:
    """Bench-extra-sized digest of a cluster record: per-table op
    counts/skew/apply percentiles, hot-key heads + hit-rate curves, and
    the merged monitor histograms in brief form — what ``bench.py``
    records as ``extra.cluster`` and ``tools/run_bench.py`` compares
    run-over-run."""
    out: Dict[str, Any] = {
        "ts": rec.get("ts"), "world": rec.get("world"),
        "polled": rec.get("polled"),
        "ranks": {r: e.get("status")
                  for r, e in rec.get("ranks", {}).items()},
        "tables": {},
    }
    for tname, t in rec.get("tables", {}).items():
        a = t.get("apply") or {}
        out["tables"][tname] = {
            "shards": len(t.get("shards", {})),
            "adds": t.get("adds"), "gets": t.get("gets"),
            "applies": t.get("applies"),
            "queue_depth": t.get("queue_depth"), "skew": t.get("skew"),
            "apply_p50_ms": a.get("p50_ms"),
            "apply_p99_ms": a.get("p99_ms"),
        }
    if rec.get("hotkeys"):
        out["hotkeys"] = {
            tname: {"total": h.get("total"),
                    "top": list(h.get("top", []))[:top],
                    "hit_rate_curve": h.get("hit_rate_curve")}
            for tname, h in rec["hotkeys"].items()}
    if rec.get("rates"):
        out["rates"] = rec["rates"]
    if rec.get("serving"):
        # replica lag/hit-rate/shed summary (already compact)
        out["serving"] = rec["serving"]
    if rec.get("profile"):
        # per-rank step-profiler summaries (already compact)
        out["profile"] = rec["profile"]
    if rec.get("memory"):
        # per-rank RSS/device/ledger digests + cluster totals (already
        # compact) — run_bench compares peak figures run-over-run
        out["memory"] = rec["memory"]
    if rec.get("tenants"):
        # per-tenant serve/shed/share digest + verdict state (already
        # merged compact) — run_bench compares victim-tenant p99/shed
        out["tenants"] = rec["tenants"]
    if rec.get("slo"):
        # sentinel verdict block (already compact): per-objective burn
        # rates + firing state, episode totals, the named straggler
        out["slo"] = rec["slo"]
    mons: Dict[str, Any] = {}
    for n, m in sorted(rec.get("monitors", {}).items()):
        if not m.get("timed"):
            continue
        if len(mons) >= max_monitors:
            mons["_truncated"] = True
            break
        mons[n] = {k: m.get(k)
                   for k in ("count", "p50_ms", "p90_ms", "p99_ms",
                             "max_ms")}
    out["monitors"] = mons
    return out


# ---------------------------------------------------------------------- #
# the poller
# ---------------------------------------------------------------------- #
def probe_all(ranks, probe_one, deadline_s: float):
    """Run ``probe_one(rank, stats, health)`` for every rank
    CONCURRENTLY (one short-lived thread each) under ONE poll-wide
    deadline, returning frozen ``(stats, health)`` dict copies. A rank
    whose probe overruns the deadline gets TimeoutError placeholders
    and its daemon thread is abandoned (it writes into the originals,
    which are no longer read). Shared by :meth:`ClusterAggregator.
    poll_once` and ``tools/mvtop.py``: a degraded cluster — several
    frozen ranks each costing the full probe timeout — is exactly when
    the poll matters, and a serial sweep would take world x 2 timeouts
    there (and hold PSService.close's final poll just as long)."""
    stats: Dict[int, Any] = {}
    health: Dict[int, Any] = {}
    threads = []
    for r in ranks:
        th = threading.Thread(target=probe_one, args=(r, stats, health),
                              name=f"mv-probe-{r}", daemon=True)
        th.start()
        threads.append((r, th))
    deadline = time.monotonic() + deadline_s
    for _, th in threads:
        th.join(max(deadline - time.monotonic(), 0.0))
    for r, th in threads:
        if th.is_alive():
            err = TimeoutError("probe exceeded the poll deadline")
            health.setdefault(r, err)
            stats.setdefault(r, err)
    return dict(stats), dict(health)


class ClusterAggregator:
    """Background cluster poller bound to one PSService (rank 0's). See
    module docstring; ``poll_once()`` is the synchronous unit (tests,
    bench, and the final flush use it directly)."""

    def __init__(self, service, interval_s: float = 0.0,
                 directory: str = "", history: int = 720):
        self.service = service
        self.interval_s = float(interval_s)
        self.directory = directory
        self._history: collections.deque = collections.deque(
            maxlen=history)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes poll_once: the interval thread and a final flush /
        # bench pull share the history's prev-record chaining and the
        # cluster.jsonl append
        self._poll_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def start(self) -> "ClusterAggregator":
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="mv-cluster-agg", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — telemetry must not
                log.error("cluster stats poll failed: %s", e)  # kill runs

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final:
            try:
                # short-timeout final poll: teardown must not hang a
                # ps_health_timeout per unreachable rank
                self.poll_once(timeout=1.0)
            except Exception as e:  # noqa: BLE001
                log.error("final cluster poll failed: %s", e)

    # ------------------------------------------------------------------ #
    def poll_once(self, timeout: Optional[float] = None) -> Dict:
        """Probe every rank (one-shot conns, CONCURRENT via
        :func:`probe_all` — errors/overruns become per-rank entries),
        merge, derive rates vs the previous record, append to the
        rolling history, and write the JSONL/.prom files. Bounded by
        one poll-wide deadline of ~2 probe timeouts regardless of how
        many ranks are frozen."""
        t = timeout or config.get_flag("ps_health_timeout")

        def probe_one(r, stats, health):
            try:
                health[r] = self.service.health(r, timeout=timeout)
            except Exception as e:  # noqa: BLE001 — per-rank entry
                health[r] = e
            try:
                stats[r] = self.service.stats_oneshot(r, timeout=timeout)
            except Exception as e:  # noqa: BLE001
                stats[r] = e

        stats, health = probe_all(range(self.service.world), probe_one,
                                  deadline_s=2.0 * t + 1.0)
        with self._poll_lock:
            rec = merge_cluster(stats, health, world=self.service.world)
            derive_rates(self.last(), rec)
            self._history.append(rec)
            # SLO sentinel + signal bus ride every poll (telemetry/slo.py,
            # telemetry/signals.py): judge the fresh record against the
            # rolling history, refresh rec["slo"], publish the typed
            # autoscaling signals. Telemetry never breaks the poll.
            try:
                snap = _slo.SENTINEL.on_poll(rec, list(self._history),
                                             self.directory)
                if snap is not None:
                    rec["slo"] = snap
            except Exception as e:   # noqa: BLE001
                log.error("SLO sentinel poll failed: %s", e)
            try:
                _signals.publish_record(rec)
            except Exception as e:   # noqa: BLE001
                log.error("signal bus publish failed: %s", e)
            try:
                self._write(rec)
            except OSError as e:
                log.error("cluster record write failed: %s", e)
        return rec

    def last(self) -> Optional[Dict]:
        return self._history[-1] if self._history else None

    def history(self) -> List[Dict]:
        return list(self._history)

    # ------------------------------------------------------------------ #
    def _write(self, rec: Dict) -> None:
        if not self.directory:
            return
        from multiverso_tpu_torch.telemetry.exporter import prometheus_text
        os.makedirs(self.directory, exist_ok=True)
        with open(os.path.join(self.directory, "cluster.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec) + "\n")
        # Prometheus view reuses the exporter's exact label scheme with
        # rank="cluster": merged monitors render as mv_monitor_* lines,
        # per-table cluster sums + skew (+ the windowed rates, flattened
        # in) as mv_shard_*{table=...}; one scrape config covers the
        # per-rank files AND this one
        shards: Dict[str, Dict] = {}
        for tname, t in rec.get("tables", {}).items():
            flat = {k: v for k, v in t.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
            for k, v in (rec.get("rates", {}).get(tname) or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    flat[k] = v
            shards[tname] = flat
        payload = {"rank": "cluster", "monitors": rec.get("monitors", {}),
                   "shards": shards}
        if isinstance(rec.get("slo"), dict):
            payload["slo"] = rec["slo"]    # mv_slo_* gauges
        ppath = os.path.join(self.directory, "cluster.prom")
        tmp = ppath + ".tmp"
        with open(tmp, "w") as f:
            f.write(prometheus_text(payload))
        os.replace(tmp, ppath)


# ---------------------------------------------------------------------- #
# process-global lifecycle (controller rank only; idempotent stop)
# ---------------------------------------------------------------------- #
_global: Optional[ClusterAggregator] = None
_global_lock = threading.Lock()


def ensure_started(service) -> Optional[ClusterAggregator]:
    """Start the global aggregator when flags enable it and ``service``
    is the controller rank (PS rank 0 — the rank that already owns
    registration/barrier duties). Idempotent; returns the live
    aggregator or None."""
    global _global
    interval = config.get_flag("stats_poll_interval_s")
    if interval <= 0 or service.rank != 0:
        return None
    with _global_lock:
        if _global is None:
            _global = ClusterAggregator(
                service, interval,
                config.get_flag("metrics_dir")).start()
        return _global


def global_aggregator() -> Optional[ClusterAggregator]:
    with _global_lock:
        return _global


def stop_if_bound(service) -> None:
    """Stop the global aggregator iff it polls THROUGH ``service`` —
    called from PSService.close so the final poll runs while the
    service's probe path is still alive (a poll through a closed service
    would just record every rank unreachable)."""
    global _global
    with _global_lock:
        if _global is None or _global.service is not service:
            return
        agg, _global = _global, None
    agg.stop()


def stop_global(final: bool = True) -> None:
    """``final=False`` skips the last flush poll — for teardown paths
    (test isolation) where the bound service may already be gone and
    waiting out probe timeouts buys nothing."""
    global _global
    with _global_lock:
        agg, _global = _global, None
    if agg is not None:
        agg.stop(final=final)
