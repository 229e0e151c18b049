#!/usr/bin/env python
"""mvtop — one pane of glass over a live async-PS cluster.

    python -m multiverso_tpu_torch.tools.mvtop --rdv RDV_DIR [--world N] --once [--json]
    python -m multiverso_tpu_torch.tools.mvtop --rdv RDV_DIR --watch [SECONDS]

Reads rank addresses from the file-rendezvous directory (``<rank>.addr``,
the same files the PS plane itself rendezvouses through), probes each
rank's MSG_HEALTH + MSG_STATS over **one-shot connections** (the
probe path: answers even when a rank's data plane is wedged, bounded by
``ps_health_timeout``-scale waits), merges the payloads through
``telemetry/aggregator.py`` (exact histogram merge, shard skew, hot-key
top-K), and renders:

* per-rank health verdicts (ok/slow/stuck/unreachable, queue depth,
  oldest in-flight op age);
* per-table cluster totals and — in ``--watch`` mode, from consecutive
  polls — rates (adds/s, gets/s, wire MB/s), queue-depth deltas, and
  the windowed shard skew;
* merged p50/p99 latency percentiles for the serve/apply planes;
* the cluster hot-key table with the estimated
  cache-hit-rate-if-cached curve.

* the SLO panel (when a rank carries an armed ``telemetry/slo.py``
  sentinel): per-objective burn rates + firing state, recent episodes,
  the named straggler, and the typed autoscaling signal bus.

``--once`` prints a single snapshot and exits 0 when at least one rank
answered (scripts/tests); ``--watch`` refreshes in place until ^C.
``--json`` emits the raw merged cluster record instead of the table.
``--assert-slo`` (with ``--once``) exits 3 iff any SLO objective is
firing — the one-line CI gate on the sentinel's verdict.

This is the port's copy of the JAX package's ``tools/mvtop.py``: it
imports ``multiverso_tpu_torch``, never the JAX package, and reads the
ranks and ``cluster.jsonl`` records of either package, which share one
format.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def read_addrs(rdv_dir: str,
               world: Optional[int] = None) -> Dict[int, str]:
    """rank -> published address from a file-rendezvous directory
    (``world`` limits the scan; default: every ``<rank>.addr`` found)."""
    out: Dict[int, str] = {}
    try:
        names = os.listdir(rdv_dir)
    except OSError:
        return out
    for n in names:
        if not n.endswith(".addr") or n.startswith("."):
            continue
        stem = n[: -len(".addr")]
        if not stem.isdigit():
            continue
        rank = int(stem)
        if world is not None and rank >= world:
            continue
        try:
            with open(os.path.join(rdv_dir, n)) as f:
                addr = f.read().strip()
        except OSError:
            continue
        if addr:
            out[rank] = addr
    return out


def poll(addrs: Dict[int, str], timeout: float = 2.0) -> Dict:
    """Probe every rank once (one-shot conns, CONCURRENT — failures and
    deadline overruns become per-rank entries) and return the merged
    cluster record. One poll is bounded by ~2 probe timeouts total, not
    per dead rank: a --watch refresh against a half-down cluster must
    not stall world x 2 timeouts."""
    from multiverso_tpu_torch.ps import service as svc
    from multiverso_tpu_torch.telemetry import aggregator

    def probe_one(r, stats, health):
        addr = addrs[r]
        try:
            health[r] = svc.oneshot_probe(addr, svc.MSG_HEALTH, timeout)
        except Exception as e:  # noqa: BLE001 — per-rank entry
            health[r] = e
        try:
            stats[r] = svc.oneshot_probe(addr, svc.MSG_STATS, timeout)
        except Exception as e:  # noqa: BLE001
            stats[r] = e

    stats, health = aggregator.probe_all(sorted(addrs), probe_one,
                                         deadline_s=2.0 * timeout + 1.0)
    return aggregator.merge_cluster(stats, health, world=len(addrs))


def _fmt(v, nd: int = 3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


# objective kind -> the unit its SLI value renders in (the SLO panel's
# value column; check_obs_surface lint 7 requires every slo.py kind to
# appear here or in dump_metrics — a kind no pane can show is a verdict
# into the void)
_SLO_KIND_UNITS = {
    "serve_latency_p99": "ms", "add_latency_p99": "ms",
    "staleness": "s", "shed_rate": "frac", "availability": "frac",
    "stall_fraction": "frac", "steady_recompiles": "n",
    "recovery_s": "s", "scale_efficiency": "E",
}

# signal name -> cell formatter for the SLO panel's signal-bus line
# (telemetry/signals.py; same lint-7 rule — every bus signal renders)
_SIGNAL_FMT = {
    "shed_rate": lambda v: f"{v * 100:.1f}%",
    "hot_key_mass": lambda v: f"{v * 100:.0f}%",
    "replica_lag_epochs": lambda v: f"{v:.0f}ep",
    "replica_lag_s": lambda v: f"{v:.2f}s",
    "queue_depth": lambda v: f"{v:.0f}",
    "burn_rate": lambda v: f"{v:.1f}x",
    "spares_left": lambda v: f"{v:.0f}",
    "active_replicas": lambda v: f"{v:.0f}",
    "stall_fraction": lambda v: f"{v * 100:.1f}%",
}


def _signal_cells(rec: Dict) -> list:
    """The typed signal bus derived from THIS record (pure — the same
    signals.from_record the aggregator publishes each poll), rendered
    as "name[table]=value" cells in the bus's declared name order."""
    from multiverso_tpu_torch.telemetry import signals as _signals
    cells = []
    by_name: Dict[str, list] = {}
    for s in _signals.from_record(rec):
        by_name.setdefault(s.name, []).append(s)
    for name in _signals.SIGNAL_NAMES:
        fmt = _SIGNAL_FMT.get(name, _fmt)
        for s in by_name.get(name, []):
            scope = f"[{s.table}]" if s.table else ""
            cells.append(f"{name}{scope}={fmt(s.value)}")
    return cells


def _mb(v) -> str:
    return f"{(v or 0) / 1e6:.2f} MB/s"


def render(rec: Dict, prev: Optional[Dict] = None,
           topk: int = 8) -> str:
    """Cluster record -> the operator screen (pure; tested directly).
    ``prev`` (the previous poll) turns counters into rates."""
    from multiverso_tpu_torch.telemetry import aggregator
    if prev is not None and "rates" not in rec:
        aggregator.derive_rates(prev, rec)
    up = sum(1 for e in rec.get("ranks", {}).values()
             if e.get("status") not in (None, "unreachable"))
    lines = [f"mvtop  {time.strftime('%H:%M:%S', time.localtime(rec.get('ts', 0)))}"
             f"  ranks {up}/{rec.get('world', '?')} up"
             f"  (stats from {rec.get('polled', 0)})"]
    lines.append(f"{'rank':<5} {'status':<12} {'gen':>4} "
                 f"{'addr':<22} {'queue':>6} "
                 f"{'infl':>5} {'oldest_s':>9} {'serve_age':>10} "
                 f"{'stall%':>7} {'recomp':>6}")
    for r in sorted(rec.get("ranks", {}), key=int):
        e = rec["ranks"][r]
        status = e.get("status", "?")
        if e.get("stats_error"):
            status += "*"       # health answered, stats did not
        # incarnation generation: gen>0 = this rank was respawned by
        # the failover plane (the at-a-glance restarted-shard signal).
        # stall% / recomp come from the step profiler's MSG_STATS block
        # (flag step_profile): wall time no phase claimed, and
        # steady-state recompiles past step 1 — "-" when not profiling
        lines.append(
            f"{r:<5} {status:<12} {_fmt(e.get('gen')):>4} "
            f"{_fmt(e.get('addr')):<22} "
            f"{_fmt(e.get('queue_depth')):>6} {_fmt(e.get('inflight')):>5} "
            f"{_fmt(e.get('oldest_inflight_s')):>9} "
            f"{_fmt(e.get('serve_age_s')):>10} "
            f"{_fmt(e.get('stall_pct'), 1):>7} "
            f"{_fmt(e.get('recompiles')):>6}")
        if e.get("error"):
            lines.append(f"      {e['error']}")
    # memory panel (telemetry/memstats.py, MSG_STATS "memory" block):
    # per-rank RSS / device bytes / live table bytes / replay-retained
    # bytes / pinned read epochs, plus the (host, pid)-deduped cluster
    # totals. "-" = the rank's payload carried no memory block (an
    # older peer) or the figure is unavailable (no /proc, no sampler).
    mem = rec.get("memory")
    if mem:

        def _mmb(v):
            return "-" if not isinstance(v, (int, float)) \
                else f"{v / 1e6:.2f}"

        t = mem.get("totals", {})
        lines.append("")
        lines.append(
            f"memory: rss {_fmt(t.get('rss_mb'), 1)} MB"
            f"  device {_mmb(t.get('device_bytes'))} MB"
            f"  tables {_mmb(t.get('table_bytes'))} MB"
            f"  retained {_mmb(t.get('retained_bytes'))} MB"
            f"  pinned epochs {t.get('pinned_epochs', 0)}")
        lines.append(f"  {'rank':<5} {'rss_mb':>8} {'device_mb':>10} "
                     f"{'table_mb':>9} {'retained_mb':>12} {'pins':>5} "
                     f"{'verdicts':<20}")
        for r in sorted(mem.get("ranks", {}), key=str):
            e = mem["ranks"][r]
            vd = ",".join(e.get("verdicts") or []) or "-"
            lines.append(
                f"  {r:<5} {_fmt(e.get('rss_mb'), 1):>8} "
                f"{_mmb(e.get('device_bytes')):>10} "
                f"{_mmb(e.get('table_bytes')):>9} "
                f"{_mmb(e.get('retained_bytes')):>12} "
                f"{_fmt(e.get('pinned_epochs')):>5} {vd:<20}")
    # device panel (telemetry/devstats.py, MSG_STATS "devices" block):
    # per-rank host<->device transfer bytes, collective calls/bytes,
    # mesh-keyed compiles, per-device live bytes, and SPMD hygiene
    # findings. The block is ADDITIVE — a rank whose payload lacks it
    # (an older peer in a mixed-version cluster, or no device activity)
    # renders "-", never a KeyError.
    dev = rec.get("devices")
    if dev:

        def _dmb(v):
            return "-" if not isinstance(v, (int, float)) \
                else f"{v / 1e6:.2f}"

        t = dev.get("totals", {})
        lines.append("")
        lines.append(
            f"devices: h2d {_dmb(t.get('h2d_bytes'))} MB"
            f"  d2h {_dmb(t.get('d2h_bytes'))} MB"
            f"  coll {t.get('coll_calls', 0)} calls"
            f"/{_dmb(t.get('coll_bytes'))} MB"
            f"  compiles {t.get('compiles', 0)}"
            f" ({_fmt(t.get('compile_s'), 2)} s)"
            f"  live {_dmb(t.get('device_bytes'))} MB"
            + (f"  HYGIENE FINDINGS {t['hygiene_findings']}"
               if t.get("hygiene_findings") else ""))
        lines.append(f"  {'rank':<5} {'h2d_mb':>8} {'d2h_mb':>8} "
                     f"{'coll':>6} {'coll_mb':>8} {'compiles':>8} "
                     f"{'mesh shapes':<28}")
        for r in sorted(dev.get("ranks", {}), key=str):
            d = dev["ranks"][r]
            tr = d.get("transfers") or {}
            colls = d.get("collectives") or {}
            comp = d.get("compiles_by_mesh") or {}
            lines.append(
                f"  {r:<5} "
                f"{_dmb((tr.get('h2d') or {}).get('bytes')):>8} "
                f"{_dmb((tr.get('d2h') or {}).get('bytes')):>8} "
                f"{sum(int(c.get('calls') or 0) for c in colls.values() if isinstance(c, dict)):>6} "
                f"{_dmb(sum(int(c.get('bytes') or 0) for c in colls.values() if isinstance(c, dict))):>8} "
                f"{sum(int(c.get('compiles') or 0) for c in comp.values() if isinstance(c, dict)):>8} "
                f"{','.join(sorted(comp)) or '-':<28}")
            ops = {op: c.get("calls") for op, c in sorted(colls.items())
                   if isinstance(c, dict)}
            if ops:
                lines.append("        coll ops: " + "  ".join(
                    f"{op}:{n}" for op, n in ops.items()))
    # tenant panel (telemetry/tenants.py, MSG_STATS "tenants" block):
    # per-(table, tenant) served/shed/deferred + latency percentiles,
    # interval traffic shares, per-tenant budget decisions, and the
    # noisy-neighbor verdict state. ADDITIVE like the device block — a
    # cluster with no tenant traffic renders nothing.
    ten = rec.get("tenants")
    if ten:
        lines.append("")
        head = (f"tenants: episodes {ten.get('episodes', 0)}"
                + ("  NOISY-NEIGHBOR ACTIVE" if ten.get("active")
                   else ""))
        shares = ten.get("shares") or {}
        if shares:
            head += "  share " + "  ".join(
                f"{tn}:{sh * 100:.0f}%" for tn, sh in
                sorted(shares.items(), key=lambda kv: -kv[1])[:topk])
        lines.append(head)
        v = ten.get("verdict")
        if v:
            lines.append(
                f"  verdict: {v.get('kind')} tenant={v.get('tenant')}"
                f" share={_fmt(v.get('share'))}"
                f" victims={','.join(v.get('victims') or [])}"
                f" why={','.join(v.get('why') or [])}")
        lines.append(f"  {'table/tenant':<28} {'served':>8} {'shed':>7} "
                     f"{'shed%':>6} {'defer':>6} {'qps':>8} "
                     f"{'p99_ms':>8} {'age_s':>7}")
        for tname in sorted(ten.get("tables") or {}):
            tt = ten["tables"][tname]
            for tn in sorted(tt):
                e = tt[tn]
                h = e.get("infer") or {}
                er = e.get("rates") or {}
                sr = e.get("shed_rate")
                lines.append(
                    f"  {tname + '/' + tn:<28} {e.get('served', 0):>8} "
                    f"{e.get('shed', 0):>7} "
                    f"{('-' if sr is None else f'{sr * 100:.1f}'):>6} "
                    f"{e.get('deferred', 0):>6} "
                    f"{_fmt(er.get('served_per_s'), 1):>8} "
                    f"{_fmt(h.get('p99_ms')):>8} "
                    f"{_fmt(e.get('max_age_s')):>7}")
        adm = ten.get("admission") or {}
        if adm:
            cells = [
                f"{k} {a.get('admitted', 0)}/{a.get('shed', 0)}"
                + (f"@{a['qps_limit']}qps" if a.get("qps_limit")
                   else "")
                for k, a in sorted(adm.items())]
            lines.append("  budgets (admitted/shed): "
                         + "  ".join(cells[:topk]))
        wire = ten.get("wire") or {}
        if wire:
            cells = [
                f"{tn}:{w.get('ops', 0)}op/"
                f"{(w.get('add_bytes', 0) + w.get('get_bytes', 0)) / 1e6:.2f}MB"
                for tn, w in sorted(wire.items())]
            lines.append("  wire ops: " + "  ".join(cells[:topk]))
    # SLO panel (telemetry/slo.py, MSG_STATS "slo" block): per-objective
    # burn-rate verdicts (fast/slow window), firing state, episode
    # counts, the named straggler, and the typed signal bus — the
    # objective-first line an operator reads before any raw gauge.
    # ADDITIVE like the device block: a cluster with no slo_spec
    # renders nothing.
    slo = rec.get("slo")
    if slo:
        firing = slo.get("firing") or []
        lines.append("")
        lines.append(
            f"slo: objectives {len(slo.get('objectives') or {})}"
            f"  episodes {slo.get('episodes', 0)}"
            f"  evals {slo.get('evals', 0)}"
            + (f"  FIRING {','.join(firing)}" if firing else "  ok"))
        objs = slo.get("objectives") or {}
        if objs:
            lines.append(f"  {'objective':<26} {'kind':<19} {'state':<7} "
                         f"{'value':>10} {'burn_f':>7} {'burn_s':>7} "
                         f"{'eps':>4}")
            for name in sorted(objs):
                o = objs[name]
                kind = o.get("kind") or "?"
                unit = _SLO_KIND_UNITS.get(kind, "")
                val = o.get("value")
                cell = ("-" if val is None
                        else f"{_fmt(val)}{unit and ' ' + unit}")
                lines.append(
                    f"  {name:<26} {kind:<19} "
                    f"{'FIRING' if o.get('firing') else 'ok':<7} "
                    f"{cell:>10} {_fmt(o.get('burn_fast'), 1):>7} "
                    f"{_fmt(o.get('burn_slow'), 1):>7} "
                    f"{o.get('episodes', 0):>4}")
        s = slo.get("straggler")
        if s:
            lines.append(
                f"  straggler: rank {s.get('rank')} "
                f"({s.get('attribution')}"
                + (f", top phase {s['top_phase']}"
                   if s.get("top_phase") else "")
                + f")  score {_fmt(s.get('score'), 2)}")
        for ev in (slo.get("recent") or [])[-4:]:
            lines.append(
                f"  {ev.get('kind')}: {ev.get('objective')} "
                f"ep{ev.get('episode')} value={_fmt(ev.get('value'))} "
                f"burn={_fmt(ev.get('burn_fast'), 1)}"
                f"/{_fmt(ev.get('burn_slow'), 1)}")
        cells = _signal_cells(rec)
        if cells:
            lines.append("  signals: " + "  ".join(cells[:topk]))
    mons = rec.get("monitors", {})
    rates = rec.get("rates", {})
    serving = rec.get("serving", {})

    def _serving_lines(tname: str) -> list:
        """Serving panel for one table: per-replica lag (epochs +
        seconds vs the advertised bound), cache hit rate, shed rate,
        and served QPS when consecutive polls derived rates."""
        s = serving.get(tname)
        if not s:
            return []
        sr = s.get("rates") or {}
        head = (f"  serving: replicas={len(s.get('replicas', {}))}"
                f"  served {s.get('served', 0)}"
                + (f" ({_fmt(sr.get('served_per_s'), 1)}/s)"
                   if sr else "")
                + f"  shed {s.get('shed', 0)}"
                + (f" ({_fmt(sr.get('shed_per_s'), 1)}/s)" if sr else "")
                + (f"  shed_rate {s['shed_rate'] * 100:.1f}%"
                   if s.get("shed_rate") is not None else "")
                + (f"  cache_hit {s['cache_hit_rate'] * 100:.1f}%"
                   if s.get("cache_hit_rate") is not None else ""))
        out = [head]
        for r in sorted(s.get("replicas", {}), key=str):
            e = s["replicas"][r]
            out.append(
                f"    replica@rank{r}: epoch {_fmt(e.get('epoch'))}"
                f"  lag {_fmt(e.get('age_s'))}s"
                f"/{_fmt(e.get('bound_s'))}s bound"
                f"  refresh {_fmt(e.get('refresh_ms'), 1)} ms"
                f"  cache {_fmt(e.get('cache_rows'))} rows"
                + (f" ({e['cache_hit_rate'] * 100:.1f}% hit)"
                   if e.get("cache_hit_rate") is not None else ""))
        # pool panel (serving/pool.py via the aggregator's serving
        # merge): per-member route share, staleness lag, degraded flag
        for r in sorted(s.get("pools", {}), key=str):
            p = s["pools"][r]
            out.append(
                f"    pool@rank{r}: active {_fmt(p.get('active'))}"
                f"  degraded {_fmt(p.get('degraded'))}"
                f"  spares {_fmt(p.get('spares_left'))}"
                f"  failovers {_fmt(p.get('failovers'))}"
                f"  demotions {_fmt(p.get('demotions'))}")
            for m in p.get("members", []):
                share = m.get("share")
                state = ("DEGRADED" if m.get("degraded")
                         else "active" if m.get("active") else "spare")
                out.append(
                    f"      member {m.get('idx')}: {state}"
                    + ("  share -" if share is None
                       else f"  share {share * 100:.1f}%")
                    + f"  lag {_fmt(m.get('age_s'))}s"
                    + f"  routed {_fmt(m.get('routed'))}"
                    + f"  pull_fail {_fmt(m.get('pull_failures'))}")
        return out

    for tname in sorted(rec.get("tables", {})):
        t = rec["tables"][tname]
        lines.append("")
        lines.append(f"table[{tname}]  shards={len(t.get('shards', {}))}"
                     f"  skew={_fmt(t.get('skew'))}"
                     f"  queue={t.get('queue_depth', 0)}")
        tr = rates.get(tname)
        if tr:
            lines.append(
                f"  rates: adds {tr['adds_per_s']}/s  gets "
                f"{tr['gets_per_s']}/s  applies {tr['applies_per_s']}/s  "
                f"wire {_mb(tr['wire_bytes_per_s'])}  "
                f"queue Δ{tr['queue_depth_delta']}"
                + (f"  skew(window) {tr['skew_window']}"
                   if "skew_window" in tr else ""))
        lines.append(f"  totals: adds {t.get('adds', 0)}  gets "
                     f"{t.get('gets', 0)}  applies {t.get('applies', 0)}  "
                     f"wire {((t.get('add_bytes', 0) or 0) + (t.get('get_bytes', 0) or 0)) / 1e6:.2f} MB")
        # merged latency percentiles: shard apply + the serve monitor
        a = t.get("apply") or {}
        parts = []
        if a.get("timed"):
            parts.append(f"apply p50 {_fmt(a.get('p50_ms'))} "
                         f"p99 {_fmt(a.get('p99_ms'))} ms")
        srv = mons.get(f"ps[{tname}].serve")
        if srv and srv.get("timed"):
            parts.append(f"serve p50 {_fmt(srv.get('p50_ms'))} "
                         f"p99 {_fmt(srv.get('p99_ms'))} ms")
        if parts:
            lines.append("  " + "  |  ".join(parts))
        # shard-placement panel (mesh data plane, ps/spmd.py): shard ->
        # rank / row range / device + each shard's share of the table's
        # applies, so skew from bad placement is visible live. The
        # "spmd" block (stacked groups) names the slot's device and its
        # share of grouped SPMD dispatches; classic shards render their
        # apply share from the plain per-shard counters.
        shards = t.get("shards") or {}
        srows = [(r, s) for r, s in shards.items()
                 if isinstance(s, dict) and s.get("kind") == "row"]
        if len(srows) > 1:
            tot = sum(int(s.get("applies") or 0) for _r, s in srows)
            cells = []
            for r, s in sorted(srows, key=lambda kv: str(kv[0])):
                sp = s.get("spmd") or {}
                lo = s.get("lo", 0)
                hi = lo + (s.get("rows") or 0)
                ap = int(s.get("applies") or 0)
                share = f"{ap / tot * 100:.0f}%" if tot else "-"
                dev = sp.get("device") or "classic"
                slot = (f" slot{sp.get('slot')}"
                        if sp.get("slot") is not None else "")
                # a stacked slot also shows its share of the group's
                # grouped applies
                grp = (f" (grouped {sp.get('apply_share', 0) * 100:.0f}%)"
                       if sp else "")
                cells.append(f"r{r}[{lo}-{hi}]@{dev}{slot} {share}{grp}")
            lines.append("  placement: " + "  ".join(cells))
            sp0 = next((s.get("spmd") for _r, s in srows
                        if s.get("spmd")), None)
            if sp0:
                lines.append(
                    f"  spmd group: {sp0.get('members')} shards stacked"
                    f" ({sp0.get('group')})"
                    f"  dispatches {sp0.get('dispatches')}"
                    f"  stack {(sp0.get('stack_bytes') or 0) / 1e6:.2f}"
                    " MB")
        hk = rec.get("hotkeys", {}).get(tname)
        if hk and hk.get("top"):
            head = "  ".join(f"{k}:{c}" for k, c, _ in hk["top"][:topk])
            lines.append(f"  hot rows (of {hk.get('total', 0)} sketched): "
                         f"{head}")
            curve = hk.get("hit_rate_curve") or []
            if curve:
                lines.append("  cache-hit-if-cached: " + "  ".join(
                    f"top{k}={r * 100:.0f}%" for k, r in curve))
        lines.extend(_serving_lines(tname))
    # replicas of tables with no shard visible in this poll (a serving
    # sidecar whose owners did not answer) still render
    for tname in sorted(set(serving) - set(rec.get("tables", {}))):
        lines.append("")
        lines.append(f"table[{tname}]  (serving only)")
        lines.extend(_serving_lines(tname))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mvtop", description="live async-PS cluster view")
    ap.add_argument("--rdv", required=True,
                    help="file-rendezvous directory (<rank>.addr files)")
    ap.add_argument("--world", type=int, default=None,
                    help="rank count (default: every published addr)")
    ap.add_argument("--once", action="store_true",
                    help="one snapshot, then exit (scripts/tests)")
    ap.add_argument("--watch", type=float, nargs="?", const=2.0,
                    default=None, metavar="SECONDS",
                    help="refresh every SECONDS (default 2) until ^C")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw merged cluster record")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-rank probe timeout seconds")
    ap.add_argument("--topk", type=int, default=8,
                    help="hot keys shown per table")
    ap.add_argument("--assert-slo", action="store_true",
                    help="with --once: exit 3 iff any SLO objective is "
                         "firing (CI gate on the sentinel verdict)")
    args = ap.parse_args(argv)

    addrs = read_addrs(args.rdv, args.world)
    if not addrs:
        print(f"mvtop: no <rank>.addr files under {args.rdv}",
              file=sys.stderr)
        return 2
    if args.once or args.watch is None:
        rec = poll(addrs, args.timeout)
        print(json.dumps(rec) if args.json
              else render(rec, topk=args.topk))
        up = sum(1 for e in rec.get("ranks", {}).values()
                 if e.get("status") not in (None, "unreachable"))
        if args.assert_slo:
            firing = (rec.get("slo") or {}).get("firing") or []
            if firing:
                print("mvtop: SLO firing: " + ",".join(firing),
                      file=sys.stderr)
                return 3
        return 0 if up else 1
    prev = None
    try:
        while True:
            addrs = read_addrs(args.rdv, args.world) or addrs
            rec = poll(addrs, args.timeout)
            # rates belong to the RECORD, not the renderer: --json
            # consumers get the same consecutive-poll rates block the
            # table view shows
            if prev is not None:
                from multiverso_tpu_torch.telemetry import aggregator
                aggregator.derive_rates(prev, rec)
            if args.json:
                # machine-readable stream: one record per line, no
                # screen-clear escapes corrupting the JSON
                out = json.dumps(rec)
                sys.stdout.write(out + "\n")
            else:
                sys.stdout.write("\x1b[2J\x1b[H"
                                 + render(rec, topk=args.topk) + "\n")
            sys.stdout.flush()
            prev = rec
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
