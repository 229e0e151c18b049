#!/usr/bin/env python
"""Merge per-rank flight-recorder dumps into one timeline and answer
"who was stuck on whom".

Every rank's flight recorder (multiverso_tpu_torch/telemetry/flightrec.py)
dumps ``flightrec-rank<r>.jsonl`` at fault time: a header (with the
rank's monotonic->wall anchor), the event ring, the in-flight request
table, and — on watchdog trips/signals — per-thread Python stacks. This
tool is the read side: point it at the dump directory (or explicit
files) and it

* merges every rank's events onto ONE wall-clock timeline (each rank's
  monotonic stamps shifted by its own header anchor), interleaving any
  structured JSONL log files (``utils/log.py`` ``jsonl=True`` sink —
  records carrying a ``level`` field) found alongside;
* reports the oldest unacked (src, dst, msg id) per rank pair from the
  in-flight tables — the "rank 0 has been waiting 12 s on rank 3's
  msg 41" line that localizes a hang without a repro;
* names suspect ranks: peers that appear as the dst of unacked traffic
  or in peer-death events but produced no dump of their own (a rank
  that died hard never got to write one — its absence IS the finding).

    python -m multiverso_tpu_torch.tools.postmortem DIR_OR_FILES... [--json] [--tail N]

Exit status: 0 with a report, 1 when no dumps were found.

This is the port's copy of the JAX package's ``tools/postmortem.py``: it
imports ``multiverso_tpu_torch``, never the JAX package, and reads
the files of either package, which share one format.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, _REPO)


def _msg_names() -> Dict[int, str]:
    """MSG_* code -> name map off ps/service.py (jax-free import); falls
    back to raw codes if the package is unimportable (e.g. the tool is
    run against dumps on a bare host)."""
    try:
        from multiverso_tpu_torch.ps import service as svc
        return {v: k for k, v in vars(svc).items()
                if k.startswith("MSG_") and isinstance(v, int)}
    except Exception:   # noqa: BLE001
        return {}


def load_dump(path: str) -> Optional[Dict]:
    """One dump file -> {"header", "events", "inflight", "stacks",
    "memory", "memsamples"}; None for an unreadable/foreign file. The
    memory records are the memstats dump provider's ledger snapshot +
    bounded sample history (telemetry/memstats.py) — the memory
    timeline rendered next to the wire timeline."""
    header, events, inflight, stacks = None, [], [], []
    memory, memsamples = [], []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.get("kind")
                if kind == "header":
                    header = rec
                elif kind == "event":
                    events.append(rec)
                elif kind == "inflight":
                    inflight.append(rec)
                elif kind == "stack":
                    stacks.append(rec)
                elif kind == "memory":
                    memory.append(rec)
                elif kind == "memsample":
                    memsamples.append(rec)
    except (OSError, json.JSONDecodeError):
        return None
    if header is None:
        return None
    return {"header": header, "events": events, "inflight": inflight,
            "stacks": stacks, "memory": memory,
            "memsamples": memsamples, "path": path}


def _expand(args: List[str]) -> (List[str], List[str]):
    """Paths/dirs -> (dump files, jsonl log files). A directory
    contributes its flightrec-rank*.jsonl dumps plus any other *.jsonl
    whose first record carries a ``level`` field (the structured log
    sink); trace/metrics JSONL files are skipped by that probe."""
    dumps, logs = [], []
    for a in args:
        if os.path.isdir(a):
            dumps.extend(sorted(glob.glob(
                os.path.join(a, "flightrec-rank*.jsonl"))))
            for p in sorted(glob.glob(os.path.join(a, "*.jsonl"))):
                if os.path.basename(p).startswith(
                        ("flightrec-rank", "trace-rank", "metrics-rank")):
                    continue
                if _is_log_file(p):
                    logs.append(p)
        elif os.path.basename(a).startswith("flightrec-"):
            dumps.append(a)
        elif _is_log_file(a):
            logs.append(a)
        else:
            dumps.append(a)   # explicit file: trust the caller
    return dumps, logs


def _is_log_file(path: str) -> bool:
    try:
        with open(path) as f:
            first = f.readline().strip()
        return bool(first) and "level" in json.loads(first)
    except (OSError, json.JSONDecodeError):
        return False


def load_dumps(args) -> List[Dict]:
    if isinstance(args, str):
        args = [args]
    paths, _ = _expand(list(args))
    return [d for d in (load_dump(p) for p in paths) if d is not None]


def load_log_lines(path: str) -> List[Dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "level" in rec and "ts" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


def timeline(dumps: List[Dict], log_lines: List[Dict] = ()
             ) -> List[Dict]:
    """All ranks' events + log lines, one list sorted by wall time.
    Events gain ``ts`` (wall seconds) via their dump's monotonic
    anchor and ``rank``; log lines pass through (they already carry
    wall ``ts`` and ``rank``)."""
    rows: List[Dict] = []
    for d in dumps:
        anchor = float(d["header"].get("mono_to_wall", 0.0))
        rank = d["header"].get("rank", -1)
        for e in d["events"]:
            r = dict(e)
            r["ts"] = round(float(e.get("mono", 0.0)) + anchor, 6)
            r["rank"] = rank
            rows.append(r)
    for rec in log_lines:
        r = dict(rec)
        r.setdefault("ev", f"log.{rec.get('level', '?').lower()}")
        rows.append(r)
    rows.sort(key=lambda r: r.get("ts", 0.0))
    return rows


def stuck_pairs(dumps: List[Dict]) -> List[Dict]:
    """Oldest unacked request per (src, dst) rank pair, oldest first."""
    best: Dict[tuple, Dict] = {}
    for d in dumps:
        src = d["header"].get("rank", -1)
        for e in d["inflight"]:
            key = (src, e.get("peer", -1))
            if key not in best or e.get("age_s", 0) > best[key]["age_s"]:
                best[key] = {"src": src, "dst": e.get("peer", -1),
                             "msg_id": e.get("msg_id", -1),
                             "type": e.get("type", 0),
                             "age_s": float(e.get("age_s", 0.0)),
                             "nbytes": e.get("nbytes", 0)}
    return sorted(best.values(), key=lambda p: -p["age_s"])


def dead_suspects(dumps: List[Dict]) -> List[Dict]:
    """Ranks implicated without a dump of their own: the dst of unacked
    traffic, or named in a peer-death event. A hard-killed rank never
    writes a dump — its absence plus a survivor's pointer is the
    verdict."""
    have = {d["header"].get("rank", -1) for d in dumps}
    why: Dict[int, set] = {}
    for p in stuck_pairs(dumps):
        if p["dst"] not in have:
            why.setdefault(p["dst"], set()).add(
                f"rank {p['src']} has unacked traffic to it "
                f"(oldest msg {p['msg_id']}, {p['age_s']:.1f}s)")
    for d in dumps:
        src = d["header"].get("rank", -1)
        for e in d["events"]:
            if e.get("ev") == "peer.dead" and e.get("peer", -1) not in have:
                why.setdefault(e["peer"], set()).add(
                    f"rank {src} observed its connection die")
    return [{"rank": r, "evidence": sorted(v)}
            for r, v in sorted(why.items())]


def memory_report(dumps: List[Dict]) -> Dict:
    """The memory forensics view across every rank's dump: each rank's
    LAST ledger snapshot (RSS, device census total, component bytes,
    verdicts) plus the merged sample timeline — RSS/device readings on
    one wall clock (memstats samples carry wall ``ts`` directly, no
    monotonic anchor needed). ``{"ranks": {}, "timeline": []}`` when no
    dump carried memory records (pre-memstats artifacts)."""
    ranks: Dict[str, Dict] = {}
    timeline: List[Dict] = []
    for d in dumps:
        rank = d["header"].get("rank", -1)
        mems = d.get("memory") or []
        if mems:
            m = mems[-1]
            census = m.get("census") or {}
            ranks[str(rank)] = {
                "ts": m.get("ts"), "rss_mb": m.get("rss_mb"),
                "hwm_mb": m.get("hwm_mb"),
                "device_bytes": census.get("bytes"),
                "totals": m.get("totals", {}),
                "components": m.get("components", {}),
                "verdicts": m.get("verdicts", []),
            }
        for s in d.get("memsamples") or []:
            r = dict(s)
            r["rank"] = rank
            timeline.append(r)
    timeline.sort(key=lambda r: r.get("ts") or 0.0)
    return {"ranks": ranks, "timeline": timeline}


_RECOVERY_EVS = ("failover.detect", "failover.respawn",
                 "failover.restore", "failover.replay",
                 "failover.rejoin")


def recovery_timeline(dumps: List[Dict], log_lines: List[Dict] = ()
                      ) -> List[Dict]:
    """The failover lifecycle (detect → respawn → restore → replay →
    rejoin) across every rank's dump, on one wall clock, each phase
    stamped with its delay since the episode's first detect — the
    "how long was the shard dark, and where did the time go" view."""
    rows = [r for r in timeline(dumps, log_lines)
            if r.get("ev") in _RECOVERY_EVS]
    t0: Optional[float] = None
    out = []
    for r in rows:
        phase = r["ev"].split(".", 1)[1]
        if phase == "detect":
            t0 = r.get("ts", 0.0)
        entry = {"ts": r.get("ts", 0.0), "phase": phase,
                 "rank": r.get("rank", -1)}
        if r.get("peer", -1) != -1:
            entry["about_rank"] = r["peer"]
        if r.get("note"):
            entry["note"] = r["note"]
        if t0 is not None:
            entry["t_plus_s"] = round(entry["ts"] - t0, 3)
        out.append(entry)
    return out


def injected_faults(dumps: List[Dict]) -> Dict:
    """Chaos-plane evidence (ps/faults.py): every ``fault.inject`` /
    ``fault.plane`` event across the merged dumps, plus per-kind
    counts — the view that separates INJECTED faults from organic
    ones, so a chaos run's peer deaths and timeouts read as scenario,
    not incident. The kind is the note's first token
    ("drop"/"delay:…"/"duplicate"/…)."""
    events = [r for r in timeline(dumps)
              if r.get("ev") in ("fault.inject", "fault.plane")]
    counts: Dict[str, int] = {}
    for r in events:
        if r["ev"] != "fault.inject":
            continue
        kind = str(r.get("note") or "?").split()[0].split(":")[0]
        counts[kind] = counts.get(kind, 0) + 1
    return {"injected": sum(counts.values()), "by_kind": counts,
            "events": events}


def tenant_timeline(dumps: List[Dict]) -> List[Dict]:
    """The tenant attribution plane's events (telemetry/tenants.py):
    every ``tenant.shed`` (a per-tenant budget refusing a read) and
    ``tenant.verdict`` (a noisy-neighbor episode opening) across the
    merged dumps, on one wall clock — rendered beside the injected
    faults so a chaos run's storm reads as scenario. The note carries
    ``table:tenant`` for sheds and the storm tenant + share for
    verdicts."""
    return [r for r in timeline(dumps)
            if r.get("ev") in ("tenant.shed", "tenant.verdict")]


def slo_timeline(dumps: List[Dict]) -> List[Dict]:
    """The SLO sentinel's episodes (telemetry/slo.py): every
    ``slo.fired`` / ``slo.cleared`` event across the merged dumps, on
    one wall clock — rendered beside the injected faults and tenant
    verdicts so an objective's burn reads against the scenario that
    caused it. The note carries the objective name, episode number,
    and the burn rates at the transition."""
    return [r for r in timeline(dumps)
            if r.get("ev") in ("slo.fired", "slo.cleared")]


def render_report(dumps: List[Dict], log_lines: List[Dict] = (),
                  tail: int = 40) -> str:
    names = _msg_names()

    def mname(t):
        return names.get(t, f"0x{t:X}" if isinstance(t, int) else str(t))

    lines = []
    ranks = sorted(d["header"].get("rank", -1) for d in dumps)
    lines.append(f"postmortem over {len(dumps)} dump(s): ranks {ranks}")
    for d in dumps:
        h = d["header"]
        lines.append(
            f"  rank {h.get('rank')}: reason={h.get('reason')!r} "
            f"events={len(d['events'])} inflight={len(d['inflight'])} "
            f"stacks={len(d['stacks'])} ({d['path']})")
    suspects = dead_suspects(dumps)
    if suspects:
        lines.append("suspect dead/stuck ranks (no dump of their own):")
        for s in suspects:
            lines.append(f"  rank {s['rank']}:")
            for ev in s["evidence"]:
                lines.append(f"    - {ev}")
    inj = injected_faults(dumps)
    if inj["injected"] or inj["events"]:
        # chaos plane armed: say so FIRST — every organic-looking
        # fault below (peer deaths, timeouts, stuck ops) must be read
        # against the scenario that provoked it
        lines.append(
            "INJECTED faults (chaos plane, ps/faults.py): "
            + (", ".join(f"{k}={n}" for k, n
                         in sorted(inj["by_kind"].items()))
               or "plane armed, none fired"))
        for e in inj["events"][-8:]:
            lines.append(
                f"  {e.get('ts', 0.0):.6f} rank{e.get('rank', -1)} "
                f"{e['ev']} peer={e.get('peer', -1)} "
                f"{e.get('note') or ''}")
    tten = tenant_timeline(dumps)
    if tten:
        # tenant plane: verdicts print whole, sheds summarize by
        # table:tenant — one budget's refusals are one line, not a
        # page, and the verdict stays beside the faults it co-occurred
        # with
        shed_counts: Dict[str, int] = {}
        for e in tten:
            if e["ev"] == "tenant.shed":
                key = str(e.get("note") or "?")
                shed_counts[key] = shed_counts.get(key, 0) + 1
        lines.append(
            "tenant plane (telemetry/tenants.py): sheds "
            + (", ".join(f"{k}={n}" for k, n
                         in sorted(shed_counts.items())) or "none"))
        for e in tten:
            if e["ev"] != "tenant.verdict":
                continue
            lines.append(
                f"  {e.get('ts', 0.0):.6f} rank{e.get('rank', -1)} "
                f"VERDICT {e.get('note') or ''}")
    tslo = slo_timeline(dumps)
    if tslo:
        fired = sum(1 for e in tslo if e["ev"] == "slo.fired")
        lines.append(
            f"SLO episodes (telemetry/slo.py): {fired} fired, "
            f"{len(tslo) - fired} cleared")
        for e in tslo:
            lines.append(
                f"  {e.get('ts', 0.0):.6f} rank{e.get('rank', -1)} "
                f"{'FIRED' if e['ev'] == 'slo.fired' else 'cleared'} "
                f"{e.get('note') or ''}")
    rec = recovery_timeline(dumps, log_lines)
    if rec:
        lines.append("recovery timeline (failover plane):")
        for e in rec:
            about = (f" rank {e['about_rank']}"
                     if "about_rank" in e else "")
            note = f"  {e['note']!r}" if e.get("note") else ""
            tplus = (f"  (+{e['t_plus_s']:.3f}s)"
                     if "t_plus_s" in e else "")
            lines.append(f"  {e['ts']:.6f} rank{e['rank']} "
                         f"{e['phase']}{about}{note}{tplus}")
    mem = memory_report(dumps)
    if mem["ranks"]:
        lines.append("memory at dump time (byte ledger):")
        for r in sorted(mem["ranks"], key=str):
            e = mem["ranks"][r]
            dev = e.get("device_bytes")
            lines.append(
                f"  rank {r}: rss {e.get('rss_mb', '-')} MB "
                f"(hwm {e.get('hwm_mb', '-')})  device "
                + ("-" if not isinstance(dev, (int, float))
                   else f"{dev / 1e6:.1f} MB"))
            comps = e.get("components") or {}
            for name in sorted(comps):
                g = comps[name]
                if not isinstance(g, dict):
                    continue
                nb = sum(v for k, v in g.items()
                         if k.endswith("_bytes")
                         and isinstance(v, (int, float))
                         and not isinstance(v, bool))
                lines.append(f"    {name}: {int(nb)} bytes")
            for v in (e.get("verdicts") or [])[-4:]:
                if isinstance(v, dict):
                    lines.append(f"    VERDICT {v.get('kind')} "
                                 f"({v.get('component')})")
    if mem["timeline"]:
        tl = mem["timeline"]
        lines.append(f"memory timeline (last {min(tail, len(tl))} of "
                     f"{len(tl)} samples):")
        for s in tl[-tail:]:
            dev = s.get("device_bytes")
            lines.append(
                f"  {s.get('ts', 0):.3f} rank{s.get('rank', '?')} "
                f"rss {s.get('rss_mb', '-')} MB  device "
                + ("-" if not isinstance(dev, (int, float))
                   else f"{dev / 1e6:.1f} MB")
                + "  " + " ".join(
                    f"{k}={v}" for k, v in sorted(
                        (s.get("totals") or {}).items()) if v))
    pairs = stuck_pairs(dumps)
    if pairs:
        lines.append("oldest unacked request per (src, dst):")
        for p in pairs:
            lines.append(
                f"  rank {p['src']} -> rank {p['dst']}: "
                f"msg {p['msg_id']} ({mname(p['type'])}, "
                f"{p['age_s']:.1f}s unacked, {p['nbytes']} bytes)")
    else:
        lines.append("no unacked requests at dump time")
    tl = timeline(dumps, log_lines)
    if tl:
        lines.append(f"timeline (last {min(tail, len(tl))} of "
                     f"{len(tl)} records):")
        for r in tl[-tail:]:
            what = r.get("ev", "?")
            detail = ""
            if r.get("msg_id", -1) != -1:
                detail += f" msg={r['msg_id']}"
            if r.get("peer", -1) != -1:
                detail += f" peer={r['peer']}"
            if r.get("type"):
                detail += f" {mname(r['type'])}"
            if r.get("note"):
                detail += f" note={r['note']!r}"
            if r.get("msg"):
                detail += f" {r['msg']}"
            lines.append(f"  {r.get('ts', 0):.6f} rank{r.get('rank', '?')}"
                         f" {what}{detail}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="dump directory or flightrec/log JSONL files")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report")
    ap.add_argument("--tail", type=int, default=40,
                    help="timeline records to print")
    args = ap.parse_args(argv)
    dump_paths, log_paths = _expand(args.paths)
    dumps = [d for d in (load_dump(p) for p in dump_paths)
             if d is not None]
    if not dumps:
        print("no flight-recorder dumps found", file=sys.stderr)
        return 1
    log_lines = [rec for p in log_paths for rec in load_log_lines(p)]
    if args.json:
        print(json.dumps({
            "ranks": sorted(d["header"].get("rank", -1) for d in dumps),
            "suspects": dead_suspects(dumps),
            "stuck_pairs": stuck_pairs(dumps),
            "recovery": recovery_timeline(dumps, log_lines),
            "injected_faults": injected_faults(dumps),
            "tenant_timeline": tenant_timeline(dumps),
            "slo_timeline": slo_timeline(dumps),
            "memory": memory_report(dumps),
            "timeline": timeline(dumps, log_lines)[-args.tail:],
        }, indent=1))
    else:
        print(render_report(dumps, log_lines, tail=args.tail))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
