#!/usr/bin/env python
"""mvprof — per-step critical-path report over step-profiler records.

The step profiler (``multiverso_tpu_torch/telemetry/profiler.py``, flag
``step_profile``) writes one JSON record per training step to
``profile-rank<r>.jsonl`` under ``metrics_dir``; the tracer writes
request spans to ``trace-rank<r>.jsonl`` beside them. This tool is the
read side — point it at the metrics directory (or explicit files):

    python -m multiverso_tpu_torch.tools.mvprof DIR_OR_FILES... [--report] [--json]
    python -m multiverso_tpu_torch.tools.mvprof DIR_OR_FILES... --to-perfetto OUT.json

``--report`` (the default) prints, per rank:

* the per-step table — wall, top (critical-path) phase, stall %,
  overlap credit, compile count — and which phase won the critical
  path across steps (the "prepare dominates block" headline, measured
  instead of inferred);
* a stall-fraction histogram (how much wall time NO instrument
  claimed, bucketed across steps);
* the recompile table: every step whose boundary sampling attributed
  a jit compile, with per-function retrace counts where ``watch_jit``
  was registered — a silent mid-run recompile names its step.

``--to-perfetto`` writes a Chrome/Perfetto ``traceEvents`` envelope
with **one track per phase per rank** (pid = rank, named tids): step
spans, phase marks, and async PS spans from the profile records, plus
every trace span found alongside — the wire's serve/apply spans
land on the same wall-clock timeline as the steps that issued them.

Exit status: 0 with output, 1 when no step records were found.

This is the port's copy of the JAX package's ``tools/mvprof.py``: it
imports ``multiverso_tpu_torch``, never the JAX package, and reads
the files of either package, which share one format.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _load_jsonl(path: str) -> List[Dict]:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        return []
    return out


def collect(paths: List[str]) -> Tuple[List[Dict], List[Dict]]:
    """(step records, trace events) from directories and/or explicit
    files. A directory contributes every ``profile-rank*.jsonl`` and
    ``trace-rank*.jsonl`` under it."""
    steps: List[Dict] = []
    spans: List[Dict] = []
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(glob.glob(os.path.join(p, "profile-rank*.jsonl")))
            files += sorted(glob.glob(os.path.join(p, "trace-rank*.jsonl")))
        else:
            files.append(p)
    for f in files:
        for rec in _load_jsonl(f):
            if rec.get("kind") == "step":
                steps.append(rec)
            elif "ph" in rec and "ts" in rec:
                spans.append(rec)
    steps.sort(key=lambda r: (r.get("rank", 0), r.get("ts", 0.0)))
    return steps, spans


def collect_hygiene(paths: List[str]) -> List[Dict]:
    """SPMD compile-hygiene reports (``compile-hygiene-rank<r>.json``,
    written by ``devstats.dump_hygiene`` — tools/bench_scale.py dumps
    one per run) from directories and/or explicit files."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(glob.glob(
                os.path.join(p, "compile-hygiene-rank*.json")))
        elif "compile-hygiene" in os.path.basename(p):
            files.append(p)
    out: List[Dict] = []
    for f in files:
        try:
            with open(f) as fh:
                rep = json.load(fh)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rep, dict) and "findings" in rep:
            rep.setdefault("_file", os.path.basename(f))
            out.append(rep)
    return out


def render_hygiene(reports: List[Dict]) -> str:
    """Compile-hygiene section: per rank the checked-scope log and
    every classified SPMD finding (clean reports say so explicitly —
    a silent section reads as 'not checked', which is the opposite)."""
    lines = []
    for rep in reports:
        head = (f"compile hygiene rank {rep.get('rank', '?')}: "
                + ("CLEAN" if rep.get("clean") else
                   f"{len(rep.get('findings') or [])} FINDING(S)")
                + f"  ({len(rep.get('checked') or [])} scoped compiles)")
        lines.append(head)
        for c in rep.get("checked") or []:
            lines.append(f"  checked {c.get('fn')} @ {c.get('mesh')}: "
                         f"{c.get('captured', 0)} captured, "
                         f"{c.get('findings', 0)} classified")
        for e in rep.get("findings") or []:
            lines.append(f"  FINDING [{e.get('category')}] "
                         f"{e.get('fn')} @ {e.get('mesh')}: "
                         f"{e.get('message')}")
    return "\n".join(lines)


# ---------------------------------------------------------------------- #
# report
# ---------------------------------------------------------------------- #
def _stall_histogram(steps: List[Dict], buckets=(5, 10, 20, 40, 100)
                     ) -> List[Tuple[str, int]]:
    """Stall-fraction distribution across steps, percent buckets."""
    out = []
    lo = 0
    for hi in buckets:
        n = sum(1 for r in steps
                if lo <= 100.0 * r.get("stall_fraction", 0.0) < hi)
        out.append((f"{lo:>3}-{hi:<3}%", n))
        lo = hi
    return out


def report_data(steps: List[Dict]) -> Dict:
    """The report as data (--json; the text renderer consumes this).
    Per-rank aggregation is ``profiler.aggregate_step_records`` — the
    ONE definition dump_metrics' step renderers share."""
    from multiverso_tpu_torch.telemetry.profiler import aggregate_step_records
    by_rank: Dict[int, List[Dict]] = {}
    for r in steps:
        by_rank.setdefault(int(r.get("rank", 0)), []).append(r)
    out: Dict = {"ranks": {}}
    for rank, recs in sorted(by_rank.items()):
        agg = aggregate_step_records(recs)
        wall = agg["wall_ms"]
        out["ranks"][str(rank)] = {
            "steps": agg["steps"],
            "wall_ms": round(wall, 2),
            "attributed_fraction": (round(agg["attributed_ms"] / wall, 4)
                                    if wall else 0.0),
            "stall_fraction": (round(agg["stall_ms"] / wall, 4)
                               if wall else 0.0),
            "overlap_ms": round(agg["overlap_ms"], 2),
            "phases_ms": {n: round(v, 2)
                          for n, v in agg["phases_ms"].items()},
            "critical_path_wins": agg["critical_path_wins"],
            "stall_histogram": _stall_histogram(recs),
            "recompile_steps": agg["recompile_steps"],
            "retraces_by_fn": agg["retraces_by_fn"],
        }
    return out


def render_report(steps: List[Dict], max_steps: int = 20) -> str:
    data = report_data(steps)
    lines: List[str] = []
    for rank, d in sorted(data["ranks"].items(), key=lambda kv: int(kv[0])):
        lines.append(f"== rank {rank}: {d['steps']} steps, "
                     f"{d['wall_ms']:.1f} ms wall, "
                     f"attributed {100 * d['attributed_fraction']:.1f}%, "
                     f"stall {100 * d['stall_fraction']:.1f}%, "
                     f"overlap credit {d['overlap_ms']:.1f} ms ==")
        wins = d["critical_path_wins"]
        if wins:
            total = sum(wins.values())
            lines.append("critical path: " + "  ".join(
                f"{n} {c}/{total}" for n, c in wins.items()))
        lines.append("phase totals (exclusive ms): " + "  ".join(
            f"{n}={v}" for n, v in d["phases_ms"].items()))
        lines.append("stall histogram: " + "  ".join(
            f"{b}:{n}" for b, n in d["stall_histogram"]))
        if d["recompile_steps"]:
            lines.append("recompiles (step: compiles / by fn):")
            for e in d["recompile_steps"][:16]:
                by = ("  " + ", ".join(f"{f}+{k}"
                                       for f, k in e["by_fn"].items())
                      if e["by_fn"] else "")
                lines.append(f"  step {e['step']} [{e['name']}]: "
                             f"{e['compiles']}{by}")
        else:
            lines.append("recompiles: none")
        recs = [r for r in steps if str(r.get("rank", 0)) == rank]
        lines.append("")
        lines.append(f"{'step':>5} {'name':<18} {'wall_ms':>9} "
                     f"{'top phase':<24} {'stall%':>7} {'overlap':>8}")
        from multiverso_tpu_torch.telemetry.profiler import step_top_phase
        for r in recs[:max_steps]:
            top_n, top_ms = step_top_phase(r)
            top_s = f"{top_n} ({top_ms:.1f} ms)" if top_n else "-"
            lines.append(
                f"{r.get('step', '?'):>5} {r.get('name', '?'):<18} "
                f"{r.get('wall_ms', 0):>9.2f} {top_s:<24} "
                f"{100 * r.get('stall_fraction', 0):>6.1f}% "
                f"{r.get('overlap_ms', 0):>8.2f}")
        if len(recs) > max_steps:
            lines.append(f"  ... {len(recs) - max_steps} more steps "
                         "(--steps N to widen)")
        lines.append("")
    return "\n".join(lines).rstrip()


# ---------------------------------------------------------------------- #
# perfetto timeline
# ---------------------------------------------------------------------- #
def to_perfetto(steps: List[Dict], spans: List[Dict],
                out_path: Optional[str]) -> Dict:
    """Profile records + trace spans -> one traceEvents envelope. One
    track per phase per rank: pid = rank, tid = a small stable index
    per track name with thread_name metadata, so Perfetto renders
    "step", each phase, and each async-span name as parallel lanes.
    Trace spans keep their own (pid=rank, tid=thread) tracks —
    same wall-clock microsecond timebase, one timeline."""
    events: List[Dict] = []
    tids: Dict[Tuple[int, str], int] = {}

    def tid_for(rank: int, track: str) -> int:
        key = (rank, track)
        t = tids.get(key)
        if t is None:
            t = tids[key] = len([k for k in tids if k[0] == rank]) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": rank,
                           "tid": t, "args": {"name": track}})
        return t

    for r in steps:
        rank = int(r.get("rank", 0))
        t0_us = int(float(r.get("ts", 0.0)) * 1e6)
        events.append({
            "name": f"{r.get('name', 'step')}#{r.get('step')}",
            "cat": "profile", "ph": "X", "ts": t0_us,
            "dur": int(float(r.get("wall_ms", 0.0)) * 1e3),
            "pid": rank, "tid": tid_for(rank, "step"),
            "args": {"stall_fraction": r.get("stall_fraction"),
                     "attributed_fraction": r.get("attributed_fraction"),
                     "compiles": r.get("jax", {}).get("compiles", 0)}})
        for span in r.get("spans", []):
            kind, name, a_us, b_us = span[0], span[1], span[2], span[3]
            track = name if kind == "phase" else f"async:{name}"
            ev = {"name": name, "cat": kind, "ph": "X",
                  "ts": t0_us + int(a_us),
                  "dur": max(int(b_us) - int(a_us), 1),
                  "pid": rank, "tid": tid_for(rank, track)}
            if len(span) > 4 and span[4] == "open":
                ev["args"] = {"open_at_step_end": True}
            events.append(ev)
    events.extend(spans)   # trace spans: already trace_event shaped
    envelope = {"traceEvents": events, "displayTimeUnit": "ms"}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(envelope, f)
    return envelope


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mvprof",
        description="per-step critical-path report / Perfetto timeline")
    ap.add_argument("paths", nargs="+",
                    help="metrics dir(s) and/or profile/trace JSONL files")
    ap.add_argument("--report", action="store_true",
                    help="print the critical-path report (default)")
    ap.add_argument("--to-perfetto", metavar="OUT.json", default=None,
                    help="write a Perfetto/chrome traceEvents envelope")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    ap.add_argument("--steps", type=int, default=20,
                    help="per-rank step rows shown in the report")
    args = ap.parse_args(argv)

    steps, spans = collect(args.paths)
    hygiene = collect_hygiene(args.paths)
    if not steps and not hygiene:
        print("mvprof: no step records found (is step_profile on and "
              "metrics_dir set?)", file=sys.stderr)
        return 1
    did = False
    if args.to_perfetto:
        if not steps:
            # an explicitly requested export must fail loudly, not
            # exit 0 with the output file silently never written
            print("mvprof: --to-perfetto needs step records; the "
                  "given paths hold only compile-hygiene reports",
                  file=sys.stderr)
            return 1
        env = to_perfetto(steps, spans, args.to_perfetto)
        print(f"wrote {len(env['traceEvents'])} events "
              f"({len(steps)} steps, {len(spans)} trace spans) to "
              f"{args.to_perfetto}")
        did = True
    if args.report or args.json or not did:
        if args.json:
            data = report_data(steps) if steps else {}
            if hygiene:
                data["hygiene"] = hygiene
            print(json.dumps(data))
        else:
            parts = []
            if steps:
                parts.append(render_report(steps, args.steps))
            if hygiene:
                parts.append(render_hygiene(hygiene))
            print("\n\n".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
