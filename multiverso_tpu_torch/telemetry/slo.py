"""SLO sentinel — declarative objectives judged on every cluster poll
(port of ``multiverso_tpu/telemetry/slo.py``, the same spec, episodes
and stats block).

The telemetry plane measures everything (histograms, flight recorder,
cluster aggregator, profiler, memstats, devstats, tenant ledger); this
module is the judging layer every real fleet has between metrics and
action:

* a **declarative spec** (flag ``slo_spec``, JSON path-or-inline like
  ``faults_spec``) declares per-(table, class, tenant) objectives —
  serve/add latency p99, served staleness, shed rate, availability,
  stall fraction, steady recompiles, chaos recovery, scale-efficiency
  floors;
* every objective is evaluated on each aggregator poll via
  **multi-window burn-rate math** (a fast and a slow window over the
  aggregator's rolling history; pure functions, oracle-testable):
  ``burn = (bad_polls / measured_polls) / error_budget`` per window,
  where ``error_budget = 1 - target``. An episode FIRES when the fast
  burn reaches ``fast_burn`` AND the slow burn reaches ``slow_burn``
  (the classic fast+slow guard: pages on real sustained burn, not one
  noisy poll), HOLDS while firing, and CLEARS when the fast window is
  back inside budget (fast burn < 1). Polls where an objective has no
  evidence (no traffic, block absent) sit out — silence is not a
  violation;
* the **episode lifecycle**: fire once -> hold -> clear,
  one structured ``log.error`` JSON + one flightrec ``slo.fired`` /
  ``slo.cleared`` EV pair per episode, a line appended to
  ``<metrics_dir>/alerts.jsonl``, ``mv_slo_*`` gauges in the exporter,
  an mvtop SLO panel, and a postmortem "SLO episodes" section;
* a **straggler detector** (:func:`straggler`) merges the per-rank
  profile + health blocks of one cluster record to name the slowest
  rank with attribution (compute vs wire vs stall).

The availability SLI deserves a note: one-shot health probes answer
even when a rank's data plane is wedged (by design), so
reachability alone cannot see a partition. Availability here is
reachability AND progress-vs-demand: with every probed rank answering,
a table is *unavailable* only when its windowed rates show no progress
WHILE demand is provably pent (replay-retained / pending client bytes,
or a server apply backlog). No demand and no progress is idle, not an
outage — the poll sits out.

Spec format (:func:`load_spec` accepts a path or inline JSON)::

    {"fast_window_s": 60, "slow_window_s": 300,
     "fast_burn": 6.0, "slow_burn": 1.0,
     "objectives": [
       {"name": "embed-serve-p99", "kind": "serve_latency_p99",
        "table": "embed", "target": 0.99, "max": 5.0},
       {"name": "embed-avail", "kind": "availability",
        "table": "embed", "target": 0.95, "min": 1.0},
       {"name": "embed-staleness", "kind": "staleness",
        "table": "embed", "max": 2.0}]}

Every objective: ``name`` (unique), ``kind`` (one of
:data:`OBJECTIVE_KINDS`), optional ``table`` / ``tenant`` / ``monitor``
scoping, ``target`` (the SLO fraction, default 0.99 -> 1% error
budget), and a ``min`` (floor kinds: availability, scale_efficiency)
or ``max`` threshold (everything else; ``threshold_ms`` is accepted as
an alias for the latency kinds). Per-objective ``fast_burn`` /
``slow_burn`` / window overrides win over the spec-level ones.

Zero cost while disarmed: one cached flag read per poll, no state.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.utils import config, log

config.define_string(
    "slo_spec", "",
    "declarative SLO spec for the sentinel (telemetry/slo.py): a JSON "
    "file path, or inline JSON when it starts with '{'. Declares "
    "per-(table, tenant) objectives judged on every cluster poll via "
    "fast+slow burn-rate windows; episodes land in alerts.jsonl, the "
    "flight recorder, and mv_slo_* gauges. Empty = sentinel disarmed "
    "(one flag read per poll, nothing else runs). docs/OBSERVABILITY.md "
    "'SLO view'")

# every judgeable SLI. tools/check_obs_surface.py lint 7 reads this
# tuple by ast and requires each kind to render in mvtop/dump_metrics —
# an objective kind no pane of glass can show is a verdict into the
# void.
OBJECTIVE_KINDS = (
    "serve_latency_p99",    # merged serve monitor p99_ms vs max
    "add_latency_p99",      # merged add_rows monitor p99_ms vs max
    "staleness",            # worst serving replica/member age_s vs max
    "shed_rate",            # windowed shed fraction of serve demand
    "availability",         # reachability AND progress-vs-demand floor
    "stall_fraction",       # worst profiled rank's stall vs max
    "steady_recompiles",    # recompiles past step 1 (max, usually 0)
    "recovery_s",           # externally noted chaos recovery seconds
    "scale_efficiency",     # externally noted E_n floor (bench_scale)
)

# floor kinds violate when the value drops BELOW "min"; every other
# kind violates when it rises ABOVE "max"
_MIN_KINDS = ("availability", "scale_efficiency")

_DEFAULTS = {"fast_window_s": 60.0, "slow_window_s": 300.0,
             "fast_burn": 6.0, "slow_burn": 1.0}


def load_spec(spec) -> Dict[str, Any]:
    """A dict passes through; a string is inline JSON (starts with
    '{') or a file path — the ``faults_spec`` convention."""
    if isinstance(spec, dict):
        return spec
    s = str(spec).strip()
    if s.startswith("{"):
        return json.loads(s)
    with open(s) as f:
        return json.load(f)


def normalize_spec(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Validate + default-fill a raw spec. Raises ValueError on an
    unknown kind, a duplicate/missing name, or a floor/threshold
    mismatch — a mis-declared objective must fail at arm time, not
    judge garbage forever."""
    spec = {k: float(raw.get(k, v)) for k, v in _DEFAULTS.items()}
    objectives: List[Dict[str, Any]] = []
    seen = set()
    for o in raw.get("objectives") or []:
        kind = o.get("kind")
        if kind not in OBJECTIVE_KINDS:
            raise ValueError(f"unknown SLO objective kind {kind!r} "
                             f"(known: {', '.join(OBJECTIVE_KINDS)})")
        name = o.get("name") or kind
        if name in seen:
            raise ValueError(f"duplicate SLO objective name {name!r}")
        seen.add(name)
        obj = dict(o)
        obj["name"], obj["kind"] = name, kind
        obj["target"] = float(o.get("target", 0.99))
        if not 0.0 < obj["target"] < 1.0:
            raise ValueError(f"objective {name!r}: target must be in "
                             f"(0, 1), got {obj['target']}")
        if kind in _MIN_KINDS:
            obj["min"] = float(o.get("min", 1.0))
        else:
            # threshold_ms is the natural spelling for the latency
            # kinds; "max" is canonical for everything
            mx = o.get("max", o.get("threshold_ms"))
            obj["max"] = float(0.0 if mx is None else mx)
        for k in _DEFAULTS:
            obj[k] = float(o.get(k, spec[k]))
        objectives.append(obj)
    spec["objectives"] = objectives
    return spec


# ---------------------------------------------------------------------- #
# the pure SLI layer: one cluster record -> one measurement (or None)
# ---------------------------------------------------------------------- #
def measure(obj: Dict[str, Any], rec: Dict[str, Any],
            external: Optional[Dict[str, float]] = None
            ) -> Optional[float]:
    """One objective's SLI value out of one cluster record; ``None``
    when the record carries no evidence for it (the poll sits out of
    the burn windows — silence is not a violation). ``external`` maps
    objective name -> a value noted out-of-band (chaos recovery_s,
    bench scale efficiency) via :meth:`SLOSentinel.note_value`."""
    kind, table = obj["kind"], obj.get("table")
    if kind in ("recovery_s", "scale_efficiency"):
        v = (external or {}).get(obj["name"])
        return None if v is None else float(v)
    if kind in ("serve_latency_p99", "add_latency_p99"):
        default = (f"ps[{table}].serve" if kind == "serve_latency_p99"
                   else f"table[{table}].add_rows")
        m = (rec.get("monitors") or {}).get(obj.get("monitor") or default)
        if not isinstance(m, dict) or not m.get("timed") \
                or not m.get("count"):
            return None
        v = m.get("p99_ms")
        return float(v) if isinstance(v, (int, float)) else None
    if kind == "staleness":
        s = (rec.get("serving") or {}).get(table)
        if not isinstance(s, dict):
            return None
        ages = [e.get("age_s") for e in (s.get("replicas") or {}).values()
                if isinstance(e, dict)]
        for p in (s.get("pools") or {}).values():
            ages += [m.get("age_s") for m in (p or {}).get("members", [])
                     if isinstance(m, dict) and m.get("active")]
        ages = [a for a in ages if isinstance(a, (int, float))]
        return max(ages) if ages else None
    if kind == "shed_rate":
        s = (rec.get("serving") or {}).get(table)
        if not isinstance(s, dict):
            return None
        r = s.get("rates") or {}
        served, shed = r.get("served_per_s"), r.get("shed_per_s")
        if isinstance(served, (int, float)) \
                and isinstance(shed, (int, float)):
            total = served + shed
            # a windowed fraction that CLEARS when the storm stops —
            # the cumulative shed_rate counter never forgets
            return shed / total if total > 0 else None
        return None
    if kind == "stall_fraction":
        vals = [p.get("stall_fraction")
                for p in (rec.get("profile") or {}).values()
                if isinstance(p, dict)]
        vals = [v for v in vals if isinstance(v, (int, float))]
        return max(vals) if vals else None
    if kind == "steady_recompiles":
        vals = [p.get("steady_recompiles")
                for p in (rec.get("profile") or {}).values()
                if isinstance(p, dict)]
        vals = [v for v in vals if isinstance(v, (int, float))]
        return float(max(vals)) if vals else None
    if kind == "availability":
        return _availability(obj, rec)
    return None


def _availability(obj: Dict[str, Any], rec: Dict[str, Any]
                  ) -> Optional[float]:
    """Reachability AND progress-vs-demand (module docstring): probes
    answer through a wedged data plane, so a partition shows up as
    pent demand with zero windowed progress, not as probe failures."""
    ranks = rec.get("ranks") or {}
    if not ranks:
        return None
    world = rec.get("world") or len(ranks)
    up = sum(1 for e in ranks.values()
             if isinstance(e, dict)
             and e.get("status") not in (None, "unreachable"))
    frac = up / max(world, 1)
    if frac < 1.0:
        return frac        # hard unreachability needs no demand proof
    table = obj.get("table")
    if not table:
        return 1.0
    rates = (rec.get("rates") or {}).get(table)
    if not isinstance(rates, dict):
        return None        # first poll: no interval, no evidence
    progress = sum(rates.get(k) or 0.0
                   for k in ("adds_per_s", "gets_per_s",
                             "applies_per_s"))
    if progress > float(obj.get("progress_min", 0.5)):
        return 1.0
    tot = (rec.get("memory") or {}).get("totals") or {}
    pent = ((tot.get("retained_bytes") or 0)
            + (tot.get("pending_bytes") or 0)
            + ((rec.get("tables") or {}).get(table, {})
               .get("queue_depth") or 0))
    if pent > 0:
        return 0.0         # demand provably stuck: the outage signal
    return None            # idle is not an outage


def violates(obj: Dict[str, Any], value: float) -> bool:
    """Does one measured value breach the objective's floor/threshold?
    Pure; the burn-rate oracle test drives it on an integer grid."""
    if obj["kind"] in _MIN_KINDS:
        return value < float(obj["min"])
    return value > float(obj["max"])


def burn_rates(obj: Dict[str, Any], history: List[Dict[str, Any]],
               now: Optional[float] = None,
               external: Optional[Dict[str, float]] = None
               ) -> Dict[str, Any]:
    """Fast+slow window burn rates for one objective over the
    aggregator's rolling history. ``burn = bad_fraction /
    error_budget`` per window; a window with no measured polls burns
    0.0. ``now`` defaults to the newest record's ``ts`` (explicit in
    tests — the math is a pure function of the grid)."""
    if now is None:
        now = history[-1].get("ts", 0.0) if history else 0.0
    budget = max(1.0 - obj["target"], 1e-4)
    out: Dict[str, Any] = {"value": None}
    cache: List[tuple] = []      # (ts, value) for records in the slow
    slow_cut = now - obj["slow_window_s"]
    for rec in history:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)) or ts < slow_cut or ts > now:
            continue
        cache.append((ts, measure(obj, rec, external)))
    if cache:
        vals = [v for _ts, v in cache if v is not None]
        if vals:
            out["value"] = vals[-1]
    for label, window in (("fast", obj["fast_window_s"]),
                          ("slow", obj["slow_window_s"])):
        cut = now - window
        n = bad = 0
        for ts, v in cache:
            if ts < cut or v is None:
                continue
            n += 1
            bad += bool(violates(obj, v))
        out[label] = round((bad / n) / budget, 4) if n else 0.0
        out[f"n_{label}"], out[f"bad_{label}"] = n, bad
    return out


# ---------------------------------------------------------------------- #
# straggler detection: one record -> the named slowest rank
# ---------------------------------------------------------------------- #
def straggler(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Name the slowest rank of one cluster record, with attribution:
    ``compute`` (largest exclusive profile-phase total), ``stall``
    (wall time no phase claimed), or ``wire`` (apply backlog + aged
    in-flight ops). Each component is normalized to its cluster-wide
    sum so the scales compose; the rank with the largest combined
    share is the straggler and its dominant component is the
    attribution. ``None`` below 2 ranks or when no component moved —
    a quiet cluster has no straggler."""
    ranks = rec.get("ranks") or {}
    if len(ranks) < 2:
        return None
    profile = rec.get("profile") or {}
    comp: Dict[str, Dict[str, float]] = {}
    for r, e in ranks.items():
        if not isinstance(e, dict) or e.get("status") == "unreachable":
            continue
        p = profile.get(r) or profile.get(str(r)) or {}
        phases = p.get("phases") or {}
        comp[str(r)] = {
            "compute": float(sum(v for v in phases.values()
                                 if isinstance(v, (int, float)))),
            "stall": float(p.get("stall_fraction") or 0.0),
            "wire": float((e.get("queue_depth") or 0)
                          + (e.get("oldest_inflight_s") or 0.0)),
        }
    if len(comp) < 2:
        return None
    sums = {k: sum(c[k] for c in comp.values())
            for k in ("compute", "stall", "wire")}
    if not any(sums.values()):
        return None
    scores: Dict[str, Dict[str, float]] = {}
    for r, c in comp.items():
        scores[r] = {k: (c[k] / sums[k] if sums[k] else 0.0)
                     for k in sums}
    slowest = max(scores, key=lambda r: sum(scores[r].values()))
    attribution = max(scores[slowest], key=scores[slowest].get)
    p = profile.get(slowest) or profile.get(int(slowest)
                                            if slowest.isdigit()
                                            else slowest) or {}
    phases = {n: v for n, v in (p.get("phases") or {}).items()
              if isinstance(v, (int, float))}
    top_phase = max(phases, key=phases.get) if phases else None
    return {
        "rank": int(slowest) if slowest.isdigit() else slowest,
        "attribution": attribution,
        "top_phase": top_phase,
        "score": round(sum(scores[slowest].values()), 4),
        "components": {k: round(v, 4) for k, v in comp[slowest].items()},
    }


# ---------------------------------------------------------------------- #
# the sentinel: episode lifecycle over the aggregator's poll stream
# ---------------------------------------------------------------------- #
class SLOSentinel:
    """Per-process sentinel (module-level :data:`SENTINEL` is the one
    the aggregator drives). Lazy-arms from the ``slo_spec`` flag /
    ``$MV_SLO_SPEC`` on the first poll; one cached read while
    disarmed."""

    def __init__(self, spec=None) -> None:
        self._lock = threading.Lock()
        self._spec: Optional[Dict[str, Any]] = (
            normalize_spec(load_spec(spec)) if spec else None)
        self._flag_tried = False
        self._state: Dict[str, Dict[str, Any]] = {}
        self._external: Dict[str, float] = {}
        self._episodes: List[Dict[str, Any]] = []
        self._evals = 0
        self._straggler: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ #
    @property
    def armed(self) -> bool:
        return self._spec is not None

    def arm(self, spec) -> "SLOSentinel":
        """Bind a spec (path / inline JSON / dict), resetting episode
        state — a new contract starts a new ledger."""
        normalized = normalize_spec(load_spec(spec))
        with self._lock:
            self._spec = normalized
            self._state = {}
            self._episodes = []
        log.info("SLO sentinel armed: %d objective(s)",
                 len(normalized["objectives"]))
        return self

    def _maybe_arm_from_flag(self) -> None:
        if self._spec is not None or self._flag_tried:
            return
        spec = config.get_flag("slo_spec") or os.environ.get(
            "MV_SLO_SPEC", "")
        if not spec:
            return
        self._flag_tried = True     # a bad spec must be loud ONCE,
        try:                        # not every poll — and never fatal
            self.arm(spec)
        except Exception as e:   # noqa: BLE001
            log.error("SLO sentinel arm failed (%s: %s); sentinel "
                      "stays disarmed", type(e).__name__, e)

    def note_value(self, name: str, value: float) -> None:
        """Feed an out-of-band SLI (chaos ``recovery_s``, bench
        ``scale_efficiency``) — measured where it happens, judged on
        the next poll like everything else."""
        with self._lock:
            self._external[name] = float(value)

    # ------------------------------------------------------------------ #
    def on_poll(self, rec: Dict[str, Any],
                history: List[Dict[str, Any]],
                directory: str = "") -> Optional[Dict[str, Any]]:
        """Judge every objective against the rolling history (which
        already includes ``rec``), run the episode lifecycle, and
        return the ``slo`` stats block (None while disarmed). Ring
        writes / structured logs / alerts.jsonl happen OUTSIDE the
        lock — the tenant-ledger discipline."""
        self._maybe_arm_from_flag()
        fired: List[Dict[str, Any]] = []
        cleared: List[Dict[str, Any]] = []
        with self._lock:
            spec = self._spec
            if spec is None:
                return None
            self._evals += 1
            now = rec.get("ts")
            objectives: Dict[str, Any] = {}
            for obj in spec["objectives"]:
                br = burn_rates(obj, history, now=now,
                                external=self._external)
                st = self._state.setdefault(
                    obj["name"], {"firing": False, "episodes": 0})
                if (not st["firing"] and br["fast"] >= obj["fast_burn"]
                        and br["slow"] >= obj["slow_burn"]):
                    st["firing"] = True
                    st["episodes"] += 1
                    fired.append(self._episode(
                        "slo.fired", obj, br, st["episodes"], now))
                elif st["firing"] and br["fast"] < 1.0:
                    # clear on the FAST window back inside budget: the
                    # slow window keeps the outage's polls for its full
                    # span, and holding an alert on history alone would
                    # page long after recovery
                    st["firing"] = False
                    cleared.append(self._episode(
                        "slo.cleared", obj, br, st["episodes"], now))
                st["burn_fast"], st["burn_slow"] = br["fast"], br["slow"]
                st["value"] = br["value"]
                objectives[obj["name"]] = {
                    "kind": obj["kind"], "table": obj.get("table"),
                    "firing": st["firing"], "episodes": st["episodes"],
                    "burn_fast": br["fast"], "burn_slow": br["slow"],
                    "value": br["value"],
                }
            self._episodes.extend(fired + cleared)
            del self._episodes[:-16]
            self._straggler = straggler(rec)
            snapshot = self._snapshot_locked(objectives)
        for ev in fired:
            _flight.record(_flight.EV_SLO_FIRED,
                           note=self._note(ev)[:120])
            log.error("SLO fired: %s", json.dumps(ev))
        for ev in cleared:
            _flight.record(_flight.EV_SLO_CLEARED,
                           note=self._note(ev)[:120])
            log.info("SLO cleared: %s", json.dumps(ev))
        if directory and (fired or cleared):
            try:
                os.makedirs(directory, exist_ok=True)
                with open(os.path.join(directory, "alerts.jsonl"),
                          "a") as f:
                    for ev in fired + cleared:
                        f.write(json.dumps(ev) + "\n")
            except OSError as e:
                log.error("alerts.jsonl append failed: %s", e)
        return snapshot

    @staticmethod
    def _episode(kind: str, obj, br, episode: int, now) -> Dict[str, Any]:
        return {"kind": kind, "objective": obj["name"],
                "objective_kind": obj["kind"], "table": obj.get("table"),
                "episode": episode, "value": br["value"],
                "burn_fast": br["fast"], "burn_slow": br["slow"],
                "ts": now}

    @staticmethod
    def _note(ev: Dict[str, Any]) -> str:
        return (f"{ev['objective']} kind={ev['objective_kind']} "
                f"ep={ev['episode']} value={ev['value']} "
                f"burn={ev['burn_fast']}/{ev['burn_slow']}")

    # ------------------------------------------------------------------ #
    def _snapshot_locked(self, objectives=None) -> Dict[str, Any]:
        if objectives is None:
            objectives = {
                name: {"firing": st.get("firing", False),
                       "episodes": st.get("episodes", 0),
                       "burn_fast": st.get("burn_fast", 0.0),
                       "burn_slow": st.get("burn_slow", 0.0),
                       "value": st.get("value")}
                for name, st in self._state.items()}
        return {
            "objectives": objectives,
            "firing": sorted(n for n, o in objectives.items()
                             if o.get("firing")),
            "episodes": sum(st.get("episodes", 0)
                            for st in self._state.values()),
            "evals": self._evals,
            "straggler": self._straggler,
            "recent": list(self._episodes[-8:]),
        }

    def stats_snapshot(self) -> Optional[Dict[str, Any]]:
        """The MSG_STATS ``slo`` block (None while disarmed — the
        payload stays additive, an un-speced cluster grows no key)."""
        with self._lock:
            if self._spec is None:
                return None
            return self._snapshot_locked()

    def reset(self) -> None:
        """Disarm + forget everything (test isolation; re-arms from
        the flag on the next poll)."""
        with self._lock:
            self._spec = None
            self._flag_tried = False
            self._state = {}
            self._external = {}
            self._episodes = []
            self._evals = 0
            self._straggler = None


SENTINEL = SLOSentinel()


def arm(spec) -> SLOSentinel:
    return SENTINEL.arm(spec)


def enabled() -> bool:
    return SENTINEL.armed


def note_value(name: str, value: float) -> None:
    SENTINEL.note_value(name, value)


def stats_snapshot() -> Optional[Dict[str, Any]]:
    return SENTINEL.stats_snapshot()


def reset() -> None:
    SENTINEL.reset()
