"""Pretty-print / diff telemetry JSONL metric snapshots, and wrap JSONL
trace files for Perfetto.

The exporter (multiverso_tpu_torch/telemetry/exporter.py) appends one JSON
record per interval to ``metrics-rank<r>.jsonl``; MSG_STATS replies and
``table.server_stats(rank)`` return the same shape. This tool makes those
records comparable across bench runs:

  python -m multiverso_tpu_torch.tools.dump_metrics show  <metrics.jsonl> [--record N]
  python -m multiverso_tpu_torch.tools.dump_metrics diff  <a.jsonl> <b.jsonl>
  python -m multiverso_tpu_torch.tools.dump_metrics to-perfetto <trace.jsonl> <out.json>

``show`` prints the chosen record (default: last) as a monitor table
(count / mean / p50 / p90 / p99 / max) plus the shard stats. ``diff``
aligns two records by monitor name and reports count deltas and p50/p99
ratios — the "did this bench run regress the tail" question in one
screen. ``to-perfetto`` wraps a JSONL trace-event file into the
``{"traceEvents": [...]}`` envelope the Perfetto UI / chrome://tracing
expect (events from several ranks' files may be concatenated first; the
spans carry ``pid`` = rank).

Both commands also accept the cluster aggregator's time series
(``cluster.jsonl``, records with ``kind: "cluster"`` — see
``telemetry/aggregator.py``): ``show`` adds the per-rank health block,
per-table cluster totals/rates/skew, and the hot-key table; ``diff`` of
two cluster records prints per-table RATE and SKEW deltas between the
two runs alongside the merged-monitor comparison.

The exporter's Prometheus text (``metrics-rank<r>.prom``) reads back
through :func:`load_prom`, one ``(metric, labels, value)`` per sample.

Step-profiler files (``profile-rank<r>.jsonl``, records with
``kind: "step"`` — telemetry/profiler.py) are recognized too: ``show``
prints the per-step critical-path table (top phase, stall %, compile
counts) and ``diff`` compares per-phase mean times and stall fractions
between two runs. The deeper merge (profile + trace spans on one
Perfetto timeline) is ``tools/mvprof.py``.

This is the port's copy of the JAX package's ``tools/dump_metrics.py``: it
imports ``multiverso_tpu_torch``, never the JAX package, and reads
the files of either package, which share one format.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# shared step-record aggregation (telemetry/profiler.py) — the step
# tables here and tools/mvprof.py's report must never drift
from multiverso_tpu_torch.telemetry.profiler import (  # noqa: E402
    aggregate_step_records, step_top_phase)


def load_records(path: str) -> List[Dict]:
    """All JSON records of a JSONL file (blank lines skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    if not out:
        raise ValueError(f"{path}: no records")
    return out


_PROM_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def load_prom(path: str) -> List[Tuple[str, Dict[str, str], float]]:
    """The samples of an exporter ``.prom`` file: ``(metric, labels,
    value)`` per sample line (``#`` lines skipped). Raises ValueError on
    a line that is not ``name{label="v",...} number``."""
    out = []
    with open(path) as f:
        for n, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            m = _PROM_LINE.match(line)
            if m is None:
                raise ValueError(f"{path}:{n}: not a sample line: {line!r}")
            labels = dict(_PROM_LABEL.findall(m.group(3) or ""))
            out.append((m.group(1), labels, float(m.group(4))))
    return out


def pick_record(records: List[Dict], index: Optional[int] = None) -> Dict:
    return records[-1 if index is None else index]


def _fmt(v: float) -> str:
    return f"{v:>9.3f}"


def _monitor_table(mons: Dict) -> List[str]:
    """The monitor table lines (shared by per-rank and cluster shows)."""
    lines = [f"{'monitor':<44} {'count':>8} {'mean':>9} "
             f"{'p50':>9} {'p90':>9} {'p99':>9} {'max':>9}"]
    for name in sorted(mons):
        m = mons[name]
        count = m.get("count", 0)
        mean = m.get("sum_ms", 0.0) / count if count else 0.0
        row = f"{name:<44} {count:>8}"
        if m.get("timed", m.get("count")):
            row += (f" {_fmt(mean)} {_fmt(m.get('p50_ms', 0))}"
                    f" {_fmt(m.get('p90_ms', 0))}"
                    f" {_fmt(m.get('p99_ms', 0))}"
                    f" {_fmt(m.get('max_ms', 0))}")
        lines.append(row)
    return lines


def _mb(v) -> str:
    return "-" if not isinstance(v, (int, float)) else f"{v / 1e6:.2f}"


def _memory_lines(mem: Dict) -> List[str]:
    """Per-rank MSG_STATS ``memory`` block -> the component byte table
    (shared by show; telemetry/memstats.py defines the shape)."""
    lines = [
        "memory: rss %s MB (hwm %s)  device %s MB  samples %s"
        % (mem.get("rss_mb", "-"), mem.get("hwm_mb", "-"),
           _mb(mem.get("device_bytes")), mem.get("samples", 0))]
    comps = mem.get("components") or {}
    if comps:
        lines.append(f"  {'component':<34} {'bytes':>12} {'detail'}")
        for name in sorted(comps):
            g = comps[name]
            if not isinstance(g, dict):
                continue
            main = sum(v for k, v in g.items()
                       if k.endswith("_bytes")
                       and isinstance(v, (int, float))
                       and not isinstance(v, bool))
            detail = ", ".join(
                f"{k}={v}" for k, v in sorted(g.items())
                if not isinstance(v, dict))
            lines.append(f"  {name:<34} {int(main):>12} {detail}")
    for v in (mem.get("verdicts") or [])[-4:]:
        if isinstance(v, dict):
            lines.append("  verdict[%s] %s: " % (v.get("kind"),
                                                 v.get("component"))
                         + ", ".join(f"{k}={x}" for k, x in sorted(
                             v.items())
                             if k not in ("kind", "component")))
    return lines


def _devices_lines(dev: Dict) -> List[str]:
    """Per-rank MSG_STATS ``devices`` block (telemetry/devstats.py) ->
    transfer/collective/compile tables. Shared by per-rank and cluster
    shows; every field is optional — an older peer's payload without
    the block never reaches here, and a partial block renders what it
    has."""
    lines = []
    tr = dev.get("transfers") or {}
    if tr:
        lines.append("devices.transfers: " + "  ".join(
            f"{d}={_mb((g or {}).get('bytes'))} MB"
            f"/{(g or {}).get('ops', 0)} ops"
            for d, g in sorted(tr.items())))
    colls = dev.get("collectives") or {}
    if colls:
        lines.append(f"  {'collective':<24} {'calls':>7} {'mb':>9} "
                     f"{'ms':>9}")
        for op in sorted(colls):
            c = colls[op]
            if not isinstance(c, dict):
                continue
            lines.append(f"  {op:<24} {c.get('calls', 0):>7} "
                         f"{_mb(c.get('bytes')):>9} "
                         f"{c.get('ms', 0):>9}")
    comp = dev.get("compiles_by_mesh") or {}
    if comp:
        lines.append("  compiles by mesh: " + "  ".join(
            f"{label}={c.get('compiles', 0)}"
            f"/{c.get('compile_s', 0)}s"
            for label, c in sorted(comp.items())
            if isinstance(c, dict)))
    per = dev.get("per_device") or {}
    if per:
        lines.append("  live buffers: " + "  ".join(
            f"{d}={_mb(g.get('bytes'))} MB/{g.get('arrays', 0)}"
            for d, g in sorted(per.items()) if isinstance(g, dict)))
    if dev.get("hygiene_findings"):
        lines.append(f"  HYGIENE FINDINGS: {dev['hygiene_findings']} "
                     "(see compile-hygiene-rank*.json / mvprof)")
    return lines


def _tenants_lines(ten: Dict) -> List[str]:
    """MSG_STATS ``tenants`` block (telemetry/tenants.py) -> the
    per-(table, tenant) accounting table + budget decisions + verdict
    state. One renderer for both the per-rank payload and the
    aggregator's merged cluster shape (extra merged-only fields like
    ``wire`` render when present)."""
    lines = ["tenants: episodes=%s active=%s" % (
        ten.get("episodes", 0), ten.get("active", False))]
    shares = ten.get("shares") or {}
    if shares:
        lines.append("  shares: " + "  ".join(
            f"{tn}={sh}" for tn, sh in
            sorted(shares.items(), key=lambda kv: -kv[1])))
    v = ten.get("verdict")
    if isinstance(v, dict):
        lines.append("  verdict[%s] tenant=%s: " % (v.get("kind"),
                                                    v.get("tenant"))
                     + ", ".join(f"{k}={x}" for k, x in sorted(v.items())
                                 if k not in ("kind", "tenant")))
    tables = ten.get("tables") or {}
    if tables:
        lines.append(f"  {'table/tenant':<30} {'served':>8} {'shed':>7} "
                     f"{'deferred':>9} {'max_age_s':>10} {'p50':>9} "
                     f"{'p99':>9}")
        for tname in sorted(tables):
            tt = tables[tname]
            if not isinstance(tt, dict):
                continue
            for tn in sorted(tt):
                e = tt[tn]
                if not isinstance(e, dict):
                    continue
                h = e.get("infer") or {}
                lines.append(
                    f"  {tname + '/' + tn:<30} {e.get('served', 0):>8} "
                    f"{e.get('shed', 0):>7} {e.get('deferred', 0):>9} "
                    f"{e.get('max_age_s', 0):>10} "
                    f"{h.get('p50_ms', 0):>9} {h.get('p99_ms', 0):>9}")
    adm = ten.get("admission") or {}
    for k in sorted(adm):
        a = adm[k]
        if isinstance(a, dict):
            lines.append(
                f"  budget[{k}]: admitted={a.get('admitted', 0)} "
                f"shed={a.get('shed', 0)} "
                f"qps_limit={a.get('qps_limit')}")
    wire = ten.get("wire") or {}
    if wire:
        lines.append("  wire: " + "  ".join(
            f"{tn}={w.get('ops', 0)}op"
            f"/{_mb(w.get('add_bytes', 0) + w.get('get_bytes', 0))}MB"
            for tn, w in sorted(wire.items()) if isinstance(w, dict)))
    return lines


# objective kind -> SLI unit for the value column (check_obs_surface
# lint 7: every telemetry/slo.py objective kind must render here or in
# mvtop — an objective no renderer can show is a verdict into the void)
_SLO_KIND_UNITS = {
    "serve_latency_p99": "ms", "add_latency_p99": "ms",
    "staleness": "s", "shed_rate": "", "availability": "",
    "stall_fraction": "", "steady_recompiles": "",
    "recovery_s": "s", "scale_efficiency": "",
}


def _slo_lines(slo: Dict) -> List[str]:
    """MSG_STATS ``slo`` block (telemetry/slo.py sentinel snapshot) ->
    the per-objective burn-rate table + straggler + recent episodes.
    One renderer for both the per-rank payload and the aggregator's
    merged cluster record (identical shape — the merge passes the
    armed rank's snapshot through)."""
    firing = slo.get("firing") or []
    lines = ["slo: evals=%s episodes=%s %s" % (
        slo.get("evals", 0), slo.get("episodes", 0),
        ("FIRING " + ",".join(firing)) if firing else "ok")]
    objs = slo.get("objectives") or {}
    if objs:
        lines.append(f"  {'objective':<26} {'kind':<19} {'state':<7} "
                     f"{'value':>12} {'burn_f':>7} {'burn_s':>7} "
                     f"{'eps':>4}")
        for name in sorted(objs):
            o = objs[name]
            kind = o.get("kind") or "?"
            val = o.get("value")
            unit = _SLO_KIND_UNITS.get(kind, "")
            cell = "-" if val is None else f"{val:.4g}{unit}"
            bf, bs = o.get("burn_fast"), o.get("burn_slow")
            lines.append(
                f"  {name:<26} {kind:<19} "
                f"{'FIRING' if o.get('firing') else 'ok':<7} "
                f"{cell:>12} "
                f"{'-' if bf is None else format(bf, '.1f'):>7} "
                f"{'-' if bs is None else format(bs, '.1f'):>7} "
                f"{o.get('episodes', 0):>4}")
    s = slo.get("straggler")
    if isinstance(s, dict):
        lines.append(
            "  straggler: rank %s (%s%s) score=%.2f" % (
                s.get("rank"), s.get("attribution"),
                ", top phase " + s["top_phase"]
                if s.get("top_phase") else "",
                s.get("score") or 0.0))
    for ev in (slo.get("recent") or [])[-6:]:
        lines.append(
            "  %s: %s ep%s value=%s burn=%s/%s" % (
                ev.get("kind"), ev.get("objective"), ev.get("episode"),
                ev.get("value"), ev.get("burn_fast"),
                ev.get("burn_slow")))
    return lines


def format_record(rec: Dict) -> str:
    """One record -> the human table (pure function; tested directly).
    Cluster records (``kind: "cluster"``) dispatch to
    :func:`format_cluster_record`."""
    if rec.get("kind") == "cluster":
        return format_cluster_record(rec)
    lines = [f"rank {rec.get('rank', '?')}  ts {rec.get('ts', '?')}  "
             f"addr {rec.get('addr', '-')}"]
    mons = rec.get("monitors", {})
    if mons:
        lines.extend(_monitor_table(mons))
    for table in sorted(rec.get("shards", {})):
        s = dict(rec["shards"][table])
        apply_h = s.pop("apply", None)
        hot = s.pop("hotkeys", None)
        stm = s.pop("tenants", None)
        lines.append(f"shard[{table}]: " + ", ".join(
            f"{k}={v}" for k, v in sorted(s.items())))
        if isinstance(stm, dict):
            cells = [
                f"{tn}={c.get('ops', 0)}op"
                f"/+{c.get('add_bytes', 0)}B/-{c.get('get_bytes', 0)}B"
                for tn, c in sorted(stm.items())
                if tn != "~sketch" and isinstance(c, dict)]
            if cells:
                lines.append("  tenants: " + "  ".join(cells))
        if apply_h and apply_h.get("count"):
            lines.append(
                f"  apply: count={apply_h['count']} "
                f"p50={apply_h['p50_ms']:.3f} p99={apply_h['p99_ms']:.3f} "
                f"max={apply_h['max_ms']:.3f} ms")
        if hot and hot.get("items"):
            head = "  ".join(f"{k}:{c}" for k, c, _ in hot["items"][:8])
            lines.append(f"  hot rows (of {hot.get('total', 0)}): {head}")
    prof = rec.get("profile")
    if isinstance(prof, dict):
        lines.append(
            "profile: steps=%s stall=%.1f%% attributed=%.1f%% "
            "recompiles=%s" % (
                prof.get("steps"),
                100.0 * (prof.get("stall_fraction") or 0.0),
                100.0 * (prof.get("attributed_fraction") or 0.0),
                prof.get("steady_recompiles")))
        phases = prof.get("phases") or {}
        if phases:
            lines.append("  phases(ms): " + "  ".join(
                f"{n}={v}" for n, v in sorted(phases.items())))
    mem = rec.get("memory")
    if isinstance(mem, dict):
        lines.extend(_memory_lines(mem))
    dev = rec.get("devices")
    if isinstance(dev, dict):
        lines.extend(_devices_lines(dev))
    ten = rec.get("tenants")
    if isinstance(ten, dict):
        lines.extend(_tenants_lines(ten))
    slo = rec.get("slo")
    if isinstance(slo, dict):
        lines.extend(_slo_lines(slo))
    for name in sorted(rec.get("notes", {})):
        lines.append(f"note[{name}] {rec['notes'][name]}")
    return "\n".join(lines)


def format_profile_records(records: List[Dict]) -> str:
    """Step-profiler JSONL (``profile-rank<r>.jsonl``, records with
    ``kind: "step"``) -> a per-step critical-path table plus the
    aggregate phase breakdown."""
    steps = [r for r in records if r.get("kind") == "step"]
    if not steps:
        return "(no step records)"
    lines = [f"{'step':>5} {'name':<18} {'wall_ms':>9} {'top phase':<22} "
             f"{'stall%':>7} {'overlap':>8} {'compiles':>8}"]
    for r in steps:
        top_n, top_ms = step_top_phase(r)
        top_s = f"{top_n} ({top_ms:.1f} ms)" if top_n else "-"
        lines.append(
            f"{r.get('step', '?'):>5} {r.get('name', '?'):<18} "
            f"{r.get('wall_ms', 0):>9.2f} {top_s:<22} "
            f"{100 * r.get('stall_fraction', 0):>6.1f}% "
            f"{r.get('overlap_ms', 0):>8.2f} "
            f"{r.get('jax', {}).get('compiles', 0):>8}")
    agg = aggregate_step_records(steps)
    wall, stall = agg["wall_ms"], agg["stall_ms"]
    lines.append("")
    lines.append(f"{agg['steps']} steps, {wall:.1f} ms wall; exclusive "
                 "phase totals: " + "  ".join(
                     f"{n}={v:.1f}ms" for n, v in
                     sorted(agg["phases_ms"].items(),
                            key=lambda kv: -kv[1]))
                 + f"  stall={stall:.1f}ms"
                 + (f" ({100 * stall / wall:.1f}%)" if wall else ""))
    return "\n".join(lines)


def diff_profile_records(a: List[Dict], b: List[Dict]) -> str:
    """Two profile JSONL files -> per-phase mean-ms ratios and the
    stall-fraction comparison (b relative to a)."""

    def agg(records):
        g = aggregate_step_records(records)
        n = max(g["steps"], 1)
        return ({k: v / n for k, v in g["phases_ms"].items()},
                (g["stall_ms"] / g["wall_ms"] if g["wall_ms"] else 0.0),
                g["steps"])

    pa, sa, na = agg(a)
    pb, sb, nb = agg(b)
    lines = [f"{'phase':<24} {'mean ms a':>10} {'mean ms b':>10} "
             f"{'b/a':>6}"]
    for name in sorted(set(pa) | set(pb)):
        va, vb = pa.get(name), pb.get(name)
        if va is None or vb is None:
            lines.append(f"{name:<24} "
                         f"{'-' if va is None else round(va, 3):>10} "
                         f"{'-' if vb is None else round(vb, 3):>10} "
                         f"{'only ' + ('b' if va is None else 'a'):>6}")
            continue
        ratio = f"{vb / va:>6.2f}" if va else f"{'-':>6}"
        lines.append(f"{name:<24} {va:>10.3f} {vb:>10.3f} {ratio}")
    lines.append(f"stall fraction: {sa:.3f} ({na} steps) -> "
                 f"{sb:.3f} ({nb} steps)")
    return "\n".join(lines)


def format_cluster_record(rec: Dict) -> str:
    """One aggregator record -> per-rank health, per-table totals/rates/
    skew, hot keys, and the merged-monitor table."""
    lines = [f"cluster  ts {rec.get('ts', '?')}  world "
             f"{rec.get('world', '?')}  stats from {rec.get('polled', 0)}"]
    for r in sorted(rec.get("ranks", {}), key=int):
        e = rec["ranks"][r]
        lines.append(f"rank {r}: " + ", ".join(
            f"{k}={v}" for k, v in sorted(e.items()) if v is not None))
    rates = rec.get("rates", {})
    for tname in sorted(rec.get("tables", {})):
        t = dict(rec["tables"][tname])
        apply_h = t.pop("apply", None)
        t.pop("shards", None)
        lines.append(f"table[{tname}]: " + ", ".join(
            f"{k}={v}" for k, v in sorted(t.items())))
        tr = rates.get(tname)
        if tr:
            lines.append("  rates: " + ", ".join(
                f"{k}={v}" for k, v in sorted(tr.items())))
        if apply_h and apply_h.get("count"):
            lines.append(
                f"  apply(merged): count={apply_h['count']} "
                f"p50={apply_h['p50_ms']:.3f} p99={apply_h['p99_ms']:.3f} "
                f"max={apply_h['max_ms']:.3f} ms")
    for tname in sorted(rec.get("serving", {})):
        s = dict(rec["serving"][tname])
        reps = s.pop("replicas", {})
        s.pop("rates", None)
        lines.append(f"serving[{tname}]: " + ", ".join(
            f"{k}={v}" for k, v in sorted(s.items()) if v is not None))
        for r in sorted(reps, key=str):
            e = reps[r]
            lines.append(f"  replica@rank{r}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(e.items())
                if v is not None))
    for r in sorted(rec.get("profile", {}), key=str):
        p = rec["profile"][r]
        lines.append(
            "profile@rank%s: steps=%s stall=%.1f%% recompiles=%s"
            % (r, p.get("steps"),
               100.0 * (p.get("stall_fraction") or 0.0),
               p.get("steady_recompiles")))
    mem = rec.get("memory")
    if isinstance(mem, dict):
        t = mem.get("totals", {})
        lines.append("memory(cluster): " + ", ".join(
            f"{k}={v}" for k, v in sorted(t.items())))
        for r in sorted(mem.get("ranks", {}), key=str):
            e = mem["ranks"][r]
            lines.append(f"  memory@rank{r}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(e.items())
                if v not in (None, [])))
    dev = rec.get("devices")
    if isinstance(dev, dict):
        t = dev.get("totals", {})
        if t:
            lines.append("devices(cluster): " + ", ".join(
                f"{k}={v}" for k, v in sorted(t.items())))
        for r in sorted(dev.get("ranks", {}), key=str):
            d = dev["ranks"][r]
            if isinstance(d, dict):
                lines.extend("  " + ln for ln in _devices_lines(d))
    ten = rec.get("tenants")
    if isinstance(ten, dict):
        lines.extend(_tenants_lines(ten))
    slo = rec.get("slo")
    if isinstance(slo, dict):
        lines.extend(_slo_lines(slo))
    for tname in sorted(rec.get("hotkeys", {})):
        h = rec["hotkeys"][tname]
        head = "  ".join(f"{k}:{c}" for k, c, _ in h.get("top", [])[:8])
        lines.append(f"hot[{tname}] total={h.get('total', 0)} top: {head}")
        curve = h.get("hit_rate_curve") or []
        if curve:
            lines.append("  cache-hit-if-cached: " + "  ".join(
                f"top{k}={r * 100:.0f}%" for k, r in curve))
    mons = rec.get("monitors", {})
    if mons:
        lines.extend(_monitor_table(mons))
    return "\n".join(lines)


def diff_cluster_records(a: Dict, b: Dict) -> str:
    """Two cluster records (typically the last record of two runs'
    ``cluster.jsonl``) -> per-table rate and skew deltas, then the
    merged-monitor comparison."""
    at, bt = a.get("tables", {}), b.get("tables", {})
    ar, br = a.get("rates", {}), b.get("rates", {})
    names = sorted(set(at) | set(bt))
    lines = [f"{'table':<24} {'adds a':>10} {'adds b':>10} "
             f"{'gets a':>10} {'gets b':>10} {'skew a':>7} {'skew b':>7} "
             f"{'skew b/a':>8}"]
    for name in names:
        ta, tb = at.get(name), bt.get(name)
        if ta is None or tb is None:
            lines.append(f"{name:<24} {'only ' + ('b' if ta is None else 'a')}")
            continue
        sa, sb = ta.get("skew"), tb.get("skew")
        ratio = (f"{sb / sa:>8.2f}" if sa and sb else f"{'-':>8}")
        lines.append(f"{name:<24} {ta.get('adds', 0):>10} "
                     f"{tb.get('adds', 0):>10} {ta.get('gets', 0):>10} "
                     f"{tb.get('gets', 0):>10} {sa or 0:>7.2f} "
                     f"{sb or 0:>7.2f} {ratio}")
        ra, rb = ar.get(name), br.get(name)
        if ra and rb:
            deltas = []
            for k in ("adds_per_s", "gets_per_s", "applies_per_s",
                      "wire_bytes_per_s", "skew_window"):
                if k in ra or k in rb:
                    deltas.append(f"{k}: {ra.get(k, 0)} -> {rb.get(k, 0)}")
            if deltas:
                lines.append("  " + ", ".join(deltas))
    ma, mb_ = a.get("memory") or {}, b.get("memory") or {}
    if ma or mb_:
        ta, tb = ma.get("totals") or {}, mb_.get("totals") or {}
        deltas = []
        for k in sorted(set(ta) | set(tb)):
            va, vb = ta.get(k, 0), tb.get(k, 0)
            if va != vb and isinstance(va, (int, float)) \
                    and isinstance(vb, (int, float)):
                deltas.append(f"{k}: {va} -> {vb} ({vb - va:+g})")
        if deltas:
            lines.append("memory totals deltas: " + ", ".join(deltas))
    lines.append("")
    lines.append(diff_records({"monitors": a.get("monitors", {})},
                              {"monitors": b.get("monitors", {})}))
    return "\n".join(lines)


def diff_records(a: Dict, b: Dict) -> str:
    """Align two records by monitor name; report count delta and
    p50/p99 ratios (b relative to a — >1 means b is slower). Two
    cluster records dispatch to :func:`diff_cluster_records`."""
    if a.get("kind") == "cluster" and b.get("kind") == "cluster":
        return diff_cluster_records(a, b)
    mem_lines = diff_memory(a.get("memory"), b.get("memory"))
    am, bm = a.get("monitors", {}), b.get("monitors", {})
    names = sorted(set(am) | set(bm))
    lines = [f"{'monitor':<44} {'count a':>8} {'count b':>8} "
             f"{'p50 b/a':>8} {'p99 b/a':>8}"]
    for name in names:
        ma, mb = am.get(name), bm.get(name)
        if ma is None or mb is None:
            lines.append(f"{name:<44} "
                         f"{'-' if ma is None else ma.get('count', 0):>8} "
                         f"{'-' if mb is None else mb.get('count', 0):>8} "
                         f"{'only ' + ('b' if ma is None else 'a'):>8}")
            continue
        row = (f"{name:<44} {ma.get('count', 0):>8} "
               f"{mb.get('count', 0):>8}")
        if ma.get("p50_ms") and mb.get("p50_ms") is not None:
            row += f" {mb['p50_ms'] / ma['p50_ms']:>8.2f}"
            if ma.get("p99_ms"):
                row += f" {mb['p99_ms'] / ma['p99_ms']:>8.2f}"
        lines.append(row)
    lines.extend(mem_lines)
    return "\n".join(lines)


def diff_memory(ma: Optional[Dict], mb: Optional[Dict]) -> List[str]:
    """RSS / device / ledger-total deltas between two records' memory
    blocks (b relative to a); [] when either side lacks the block."""
    if not isinstance(ma, dict) or not isinstance(mb, dict):
        return []
    lines = ["memory deltas (b - a):"]
    for k, scale, unit in (("rss_mb", 1.0, "MB"),
                           ("device_bytes", 1e-6, "MB")):
        va, vb = ma.get(k), mb.get(k)
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            lines.append(f"  {k}: {va} -> {vb} "
                         f"({(vb - va) * scale:+.2f} {unit})")
    ta, tb = ma.get("totals") or {}, mb.get("totals") or {}
    for k in sorted(set(ta) | set(tb)):
        va, vb = ta.get(k, 0), tb.get(k, 0)
        if va != vb and isinstance(va, (int, float)) \
                and isinstance(vb, (int, float)):
            lines.append(f"  totals.{k}: {va} -> {vb} ({vb - va:+g})")
    return lines if len(lines) > 1 else []


def is_history_record(rec: Dict) -> bool:
    """BENCH_HISTORY.jsonl entries (tools/run_bench.py history_entry):
    the trajectory index a run appends one line to per recorded run."""
    return isinstance(rec, dict) and "record" in rec \
        and "metrics" in rec and "regressions" in rec


def format_history_records(records: List[Dict],
                           last: int = 20) -> str:
    """The bench trajectory as one table: per run the headline value,
    completeness, flag count, and every run_bench-tracked metric that
    moved — the arc BENCH_r*.json mtime-globbing used to be the only
    way to reconstruct."""
    rows = records[-last:]
    lines = [f"{'#':>3} {'record':<20} {'complete':>8} {'value':>10} "
             f"{'vs_base':>8} {'flags':>5}  tracked metrics"]
    base = len(records) - len(rows)
    for i, r in enumerate(rows):
        mets = r.get("metrics") or {}
        brief = "  ".join(f"{k}={v}" for k, v in sorted(mets.items())[:4])
        if len(mets) > 4:
            brief += f"  (+{len(mets) - 4} more)"
        lines.append(
            f"{base + i:>3} {str(r.get('record'))[:20]:<20} "
            f"{'yes' if r.get('complete') else ('TRUNC' if r.get('truncated') else 'no'):>8} "
            f"{r.get('value') if r.get('value') is not None else '-':>10} "
            f"{r.get('vs_baseline') if r.get('vs_baseline') is not None else '-':>8} "
            f"{len(r.get('regressions') or []):>5}  {brief}")
        for flag in (r.get("regressions") or [])[:3]:
            lines.append(f"      FLAG: {flag}")
    return "\n".join(lines)


def diff_history_records(a: Dict, b: Dict) -> str:
    """Two trajectory entries (default: the last two) -> every tracked
    metric's movement, b relative to a."""
    ma, mb = a.get("metrics") or {}, b.get("metrics") or {}
    lines = [f"{a.get('record')} -> {b.get('record')}",
             f"{'metric':<40} {'a':>12} {'b':>12} {'b/a':>7}"]
    for k in sorted(set(ma) | set(mb)):
        va, vb = ma.get(k), mb.get(k)
        if va is None or vb is None:
            lines.append(f"{k:<40} "
                         f"{'-' if va is None else va:>12} "
                         f"{'-' if vb is None else vb:>12} "
                         f"{'only ' + ('b' if va is None else 'a'):>7}")
            continue
        ratio = f"{vb / va:>7.2f}" if va else f"{'-':>7}"
        lines.append(f"{k:<40} {va:>12} {vb:>12} {ratio}")
    for side, r in (("a", a), ("b", b)):
        for flag in (r.get("regressions") or []):
            lines.append(f"  {side} FLAG: {flag}")
    return "\n".join(lines)


def to_perfetto(trace_jsonl: str, out_path: str) -> int:
    """JSONL trace events -> Perfetto/chrome JSON envelope; returns the
    event count."""
    events = load_records(trace_jsonl)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def main(argv: List[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "show":
        idx = None
        if "--record" in rest:
            i = rest.index("--record")
            idx = int(rest[i + 1])
            rest = rest[:i] + rest[i + 2:]
        records = load_records(rest[0])
        if records[-1].get("kind") == "step":
            # step-profiler JSONL: the per-step table IS the show (a
            # single step record says little; --record still narrows)
            if idx is not None:
                records = [records[idx]]
            print(format_profile_records(records))
            return 0
        if is_history_record(records[-1]):
            # BENCH_HISTORY.jsonl: the whole trajectory IS the show
            print(format_history_records(
                records if idx is None else records[: idx + 1]))
            return 0
        print(format_record(pick_record(records, idx)))
        return 0
    if cmd == "diff":
        ra, rb = load_records(rest[0]), load_records(rest[1])
        if (ra[-1].get("kind") == "step"
                and rb[-1].get("kind") == "step"):
            print(diff_profile_records(ra, rb))
            return 0
        if is_history_record(ra[-1]) and is_history_record(rb[-1]):
            # diffing a history file against itself compares the last
            # two runs of the trajectory; two files compare their tails
            if rest[0] == rest[1] and len(ra) >= 2:
                print(diff_history_records(ra[-2], ra[-1]))
            else:
                print(diff_history_records(pick_record(ra),
                                           pick_record(rb)))
            return 0
        print(diff_records(pick_record(ra), pick_record(rb)))
        return 0
    if cmd == "to-perfetto":
        n = to_perfetto(rest[0], rest[1])
        print(f"wrote {n} events to {rest[1]}")
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
