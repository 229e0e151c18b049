#!/usr/bin/env python
"""mvautoscale — the autoscaling seam over the typed signal bus.

    python -m multiverso_tpu_torch.tools.mvautoscale --rdv RDV_DIR --dry-run [--json]

Polls a live cluster twice (mvtop's one-shot probe path, so it answers
even when the data plane is wedged), derives windowed rates between the
polls, runs the record through ``telemetry/signals.from_record`` — the
SAME pure derivation the aggregator publishes on every poll — and feeds
the resulting signal snapshot to :func:`recommend`, the one policy
function that turns bus signals into a ReplicaPool grow/shrink/hold
verdict.

This tool NEVER actuates (actuation stays behind an explicit
controller); ``--dry-run`` is mandatory and the exit code carries the
verdict for scripts: 0 = hold, 10 = grow, 11 = shrink, 2 = no cluster.

The policy is deliberately small and legible:

* **grow** — shed pressure (any table shedding above ``shed_max``, an
  SLO burn rate at/above ``burn_fire``, or a queue above ``queue_max``)
  AND at least one warm spare to promote (``spares_left > 0``). A
  pressured pool with no spares is a **hold** with
  ``actionable: false`` — the recommendation a capacity planner reads,
  not one a controller can execute.
* **shrink** — more than ``min_active`` replicas while every pressure
  signal is quiet (no shed, burn ≈ 0, empty queues): the cluster is
  paying replica fan-out for serving demand that is not there.
* **hold** — anything else, including "no signals at all".

:func:`recommend` is pure (snapshot dict in, verdict dict out) and is
what the chaos harness and tests call directly; the CLI exists so an
operator can point it at any rendezvous directory.

This is the port's copy of the JAX package's ``tools/mvautoscale.py``:
it imports ``multiverso_tpu_torch``, never the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# grow/shrink thresholds — see module docstring for what each gates
DEFAULT_POLICY = {
    "shed_max": 0.02,    # tolerated shed fraction before grow pressure
    "burn_fire": 1.0,    # SLO burn rate that counts as pressure
    "queue_max": 256.0,  # queue depth that counts as pressure
    "burn_quiet": 0.1,   # burn rate below this is "quiet" for shrink
    "min_active": 1,     # never recommend shrinking below this
}

_EXIT_BY_ACTION = {"hold": 0, "grow": 10, "shrink": 11}


def _values(snapshot: Dict, name: str) -> List[Tuple[str, float]]:
    """(table, value) pairs for one signal name; non-numeric entries
    are skipped (a malformed payload must not crash the policy)."""
    out: List[Tuple[str, float]] = []
    for table, ent in sorted((snapshot.get(name) or {}).items()):
        v = ent.get("value") if isinstance(ent, dict) else None
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append((table, float(v)))
    return out


def recommend(snapshot: Dict, policy: Optional[Dict] = None) -> Dict:
    """Signal-bus snapshot (``signals.SignalBus.snapshot()`` shape:
    ``{name: {table-or-"": {"value", "ts", "detail"}}}``) -> one
    verdict dict ``{"action", "actionable", "reason", "signals"}``.
    Pure — no I/O, no clocks — so tests drive it on synthetic
    snapshots and the chaos harness on live ones."""
    pol = dict(DEFAULT_POLICY)
    if policy:
        pol.update(policy)
    sheds = _values(snapshot, "shed_rate")
    burns = _values(snapshot, "burn_rate")
    queues = _values(snapshot, "queue_depth")
    spares = max((v for _, v in _values(snapshot, "spares_left")),
                 default=None)
    active = max((v for _, v in _values(snapshot, "active_replicas")),
                 default=None)
    used = {
        "shed_rate": {t: v for t, v in sheds},
        "burn_rate": {t: v for t, v in burns},
        "queue_depth": {t: v for t, v in queues},
        "spares_left": spares,
        "active_replicas": active,
    }

    pressure = []
    for t, v in sheds:
        if v > pol["shed_max"]:
            pressure.append(f"shed_rate[{t}]={v:.3f}>{pol['shed_max']}")
    for t, v in burns:
        if v >= pol["burn_fire"]:
            pressure.append(f"burn_rate[{t}]={v:.1f}>={pol['burn_fire']}")
    for t, v in queues:
        if v > pol["queue_max"]:
            pressure.append(f"queue_depth[{t}]={v:.0f}>{pol['queue_max']}")

    if pressure:
        if spares is not None and spares > 0:
            return {"action": "grow", "actionable": True,
                    "reason": "; ".join(pressure)
                    + f"; spares_left={spares:.0f}",
                    "signals": used}
        return {"action": "hold", "actionable": False,
                "reason": "; ".join(pressure)
                + "; no warm spares to promote",
                "signals": used}

    quiet = (all(v <= 0.0 for _, v in sheds)
             and all(v < pol["burn_quiet"] for _, v in burns)
             and all(v <= 0.0 for _, v in queues))
    if (quiet and active is not None and active > pol["min_active"]
            and (sheds or burns or queues)):
        return {"action": "shrink", "actionable": True,
                "reason": f"active_replicas={active:.0f}>"
                f"{pol['min_active']} with no shed/burn/queue pressure",
                "signals": used}
    return {"action": "hold", "actionable": False,
            "reason": "no pressure and no idle surplus",
            "signals": used}


def snapshot_from_record(rec: Dict) -> Dict:
    """One merged cluster record -> the bus-snapshot shape
    :func:`recommend` consumes, via the same pure
    ``signals.from_record`` the aggregator publishes."""
    from multiverso_tpu_torch.telemetry import signals as _signals
    snap: Dict[str, Dict] = {}
    for s in _signals.from_record(rec):
        snap.setdefault(s.name, {})[s.table or ""] = {
            "value": s.value, "ts": s.ts, "detail": s.detail}
    return snap


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mvautoscale",
        description="recommend ReplicaPool grow/shrink from the "
                    "telemetry signal bus (never actuates)")
    ap.add_argument("--rdv", required=True,
                    help="file-rendezvous directory (<rank>.addr files)")
    ap.add_argument("--world", type=int, default=None,
                    help="rank count (default: every published addr)")
    ap.add_argument("--dry-run", action="store_true",
                    help="required: print the recommendation, touch "
                         "nothing (actuation lives behind a future "
                         "controller, not this tool)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="seconds between the two rate-derivation polls")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-rank probe timeout seconds")
    ap.add_argument("--json", action="store_true",
                    help="emit the verdict as one JSON object")
    args = ap.parse_args(argv)
    if not args.dry_run:
        print("mvautoscale: refusing to run without --dry-run "
              "(this tool only recommends; it never actuates)",
              file=sys.stderr)
        return 2

    from multiverso_tpu_torch.telemetry import aggregator
    from multiverso_tpu_torch.tools import mvtop
    addrs = mvtop.read_addrs(args.rdv, args.world)
    if not addrs:
        print(f"mvautoscale: no <rank>.addr files under {args.rdv}",
              file=sys.stderr)
        return 2
    prev = mvtop.poll(addrs, args.timeout)
    time.sleep(max(args.interval, 0.05))
    rec = mvtop.poll(addrs, args.timeout)
    aggregator.derive_rates(prev, rec)
    verdict = recommend(snapshot_from_record(rec))
    if args.json:
        print(json.dumps(verdict))
    else:
        print(f"mvautoscale: {verdict['action'].upper()}"
              f"{'' if verdict['actionable'] else ' (not actionable)'}"
              f" — {verdict['reason']}")
    return _EXIT_BY_ACTION.get(verdict["action"], 0)


if __name__ == "__main__":
    raise SystemExit(main())
