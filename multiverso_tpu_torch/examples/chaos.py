"""Chaos scenario matrix on the async PS plane (the counterpart of the JAX
package's ``tools/bench_chaos.py``): the fault-injection wire plane
(``ps/faults.py``), exactly-once replay, the replica pool
(``serving/pool.py``) and the failover supervisor (``ps/failover.py``)
driven through the fault shapes they claim to survive, each scenario with
the tool's in-run gates.

* ``partition_heal`` — a one-way client→shard partition for seconds, then
  heal: every add issued before and during the cut lands exactly once
  (replay), and add throughput recovers to ≥90% of pre-fault. The SLO
  sentinel's availability objective fires during the cut and clears
  after the heal.
* ``dup_reorder`` — duplicate and bounded-reorder injection on the
  windowed add frames: the shard's sequence channels apply every frame
  exactly once (ledger vs the acked-op oracle, bit for bit), with the
  injected counts nonzero so a disarmed plane cannot pass; the sentinel
  stays quiet (no stall, no episode).
* ``slow_shard_shed`` — slow-serve injection on one shard while a
  ReplicaPool serves a read storm: no served read exceeds the staleness
  bound, served QPS recovers after the heal, the autoscaler's verdict
  off the signal bus mid-slow is GROW, and the sentinel ends clear.
* ``replica_kill`` — one pool member killed mid-storm: the pool demotes
  it, routes around, activates the warm spare, and served QPS recovers.
* ``noisy_neighbor`` — two tenants share one pool, each over its own
  per-tenant budget: the storm tenant is capped at its budget, the
  victim's p99 holds, and the ledger's sweep opens exactly one
  noisy-neighbor episode and clears it.
* ``combined`` — two OS processes (each shard on its own process's
  device): SIGKILL of the rank-1 shard and a replica kill at the same
  instant, under training writes and an inference storm; the parent's
  FailoverSupervisor respawns rank 1 at the next generation, which
  restores its newest committed per-shard checkpoint before it publishes.
  Each worker's flight recorder dumps under ``flightrec/gen<g>/`` of the
  scenario's directory (``flightrec_dir`` in the result): the survivor's
  dump names the killed rank with its unacked requests, for the
  postmortem tool.

The in-process scenarios run two ranks in one process with both shards on
``device``; every scenario runs the Python wire plane (``ps_native``
off, as the JAX tool does): the fault plane hooks the Python peer and
serve boundaries, which the native plane's C++ threads bypass. Workers of ``combined`` start as ``python -m
multiverso_tpu_torch.examples.chaos worker ...``, never as a fork of a
process that holds a CUDA context.

The shared math (``rate_buckets``, ``_recovery_core``: the 90% bar over a
1 s rolling window) and every gate below are the tool's. The sentinel's
scenarios drive an explicit in-process aggregator (nothing polls in the
background) and disarm the process-global sentinel and signal bus on
exit; the noisy-neighbor sweeps run only on the scenario's own
``stats_snapshot`` pulls.

    python -m multiverso_tpu_torch.examples.chaos [seconds] [rows] [dim]
        [threads] [--scenario NAME] [--device cpu]

prints ``RESULT <json>`` and exits 3 when any scenario's gate fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BUCKET_S = 0.25
TABLE = "chaos"


# ---------------------------------------------------------------------- #
# shared math (tools/bench_chaos.py, unchanged)
# ---------------------------------------------------------------------- #
def rate_buckets(stamps, t0: float, t_end: float):
    """Completion stamps -> per-BUCKET_S counts from t0 to t_end."""
    nb = max(int((t_end - t0) / BUCKET_S) + 1, 1)
    if not len(stamps):
        return np.zeros(nb, np.int64)
    s = np.sort(np.asarray(stamps, np.float64))
    return np.bincount(((s - t0) / BUCKET_S).astype(np.int64),
                       minlength=nb)[:nb]


def _recovery_core(rates, t0: float, bucket_s: float,
                   fault_wall: float, recover_from: float):
    """The ONE recovery detector every scenario uses: pre = mean rate
    over the 3 s before the fault (skipping warmup bucket 0); recovery_s
    = first 1 s ROLLING-window mean at/after ``recover_from`` sustaining
    ≥90% of pre, measured from ``recover_from`` and floored at 0. No
    pre-fault rate (``pre <= 0``) returns None, which fails the gate."""
    rates = np.asarray(rates, np.float64)
    kb = int((fault_wall - t0) / bucket_s)
    rb = max(int((recover_from - t0) / bucket_s), 0)
    pre_lo = max(kb - int(3.0 / bucket_s), 1)
    pre = float(np.mean(rates[pre_lo:kb])) if kb > pre_lo else 0.0
    post = float(np.mean(rates[-max(int(2.0 / bucket_s), 1):]))
    win = max(int(1.0 / bucket_s), 1)
    if pre <= 0.0:
        return pre, post, None
    recovery_s = None
    for i in range(rb, len(rates) - win + 1):
        if np.mean(rates[i:i + win]) >= 0.9 * pre:
            recovery_s = round(
                max((t0 + i * bucket_s) - recover_from, 0.0), 3)
            break
    return pre, post, recovery_s


def recovery_from_stamps(stamps, t0: float, t_end: float,
                         fault_wall: float,
                         recover_from: Optional[float] = None):
    """Completion stamps -> (pre_rate, post_rate, recovery_s). Heal-style
    scenarios count recovery from the heal (``recover_from``), kill-style
    from the kill (the default)."""
    rates = rate_buckets(stamps, t0, t_end) / BUCKET_S
    return _recovery_core(rates, t0, BUCKET_S, fault_wall,
                          fault_wall if recover_from is None
                          else recover_from)


# ---------------------------------------------------------------------- #
# in-process world: 2 ranks, Python wire plane, replay armed
# ---------------------------------------------------------------------- #
class World:
    """Two in-process PSServices and one replay-armed windowed table, both
    shards on ``device`` (None = the card). Rank 0 hosts the client plane:
    its shard-0 traffic is the local short-circuit, its shard-1 traffic
    rides the real socket, where the fault plane hooks."""

    def __init__(self, tmp: str, rows: int = 32, dim: int = 8,
                 staleness_s: float = 2.0, device=None):
        from multiverso_tpu_torch.ps.service import (FileRendezvous,
                                                     PSContext, PSService)
        from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
        from multiverso_tpu_torch.utils import config
        config.set_flag("ps_native", False)   # the fault plane's wire
        config.set_flag("ps_replay", True)
        config.set_flag("ps_timeout", 60.0)
        config.set_flag("ps_connect_timeout", 5.0)
        config.set_flag("ps_reconnect_backoff", 0.2)
        config.set_flag("ps_replay_backoff", 0.1)
        config.set_flag("ps_replay_backoff_cap", 0.5)
        self.rows, self.dim = rows, dim
        self.staleness_s = staleness_s
        self.tmp = tmp or tempfile.mkdtemp(prefix="mv_chaos_")
        # the failover checkpointer advances the shards' durable replay
        # floor; without it the retained-frame tails grow all run long
        config.set_flag("failover_dir", os.path.join(self.tmp, "ck"))
        config.set_flag("failover_ckpt_interval_s", 0.5)
        rdv = FileRendezvous(os.path.join(self.tmp, "rdv"))
        self.ctx0 = PSContext(0, 2, PSService(0, 2, rdv), device=device)
        self.ctx1 = PSContext(1, 2, PSService(1, 2, rdv), device=device)
        self.t0 = AsyncMatrixTable(rows, dim, name=TABLE,
                                   send_window_ms=1.0, ctx=self.ctx0)
        self.t1 = AsyncMatrixTable(rows, dim, name=TABLE,
                                   send_window_ms=1.0, ctx=self.ctx1)
        self.pool = None

    def make_pool(self, replicas=2, spares=0, refresh_s=0.15,
                  admission=None):
        from multiverso_tpu_torch.serving.pool import ReplicaPool
        self.pool = ReplicaPool(
            self.t0, replicas=replicas, spares=spares,
            refresh_s=refresh_s, staleness_s=self.staleness_s,
            admission=admission, probe_s=0.2, start=True)
        return self.pool

    def close(self):
        from multiverso_tpu_torch.ps import faults
        from multiverso_tpu_torch.utils import config
        faults.disarm()
        if self.pool is not None:
            self.pool.close()
        self.ctx0.close()
        self.ctx1.close()
        config.set_flag("failover_ckpt_interval_s", 0.0)
        config.set_flag("failover_dir", "")


class Traffic:
    """N blocking-windowed-add threads over disjoint rows spanning both
    shards, stamping each acked completion — the exactly-once oracle's
    acked side AND the recovery detector's completion series."""

    def __init__(self, world: World, n_threads: int = 3):
        self.w = world
        self.n = n_threads
        self.counts = [np.zeros(world.rows, np.int64)
                       for _ in range(n_threads)]
        self.stamps = [[] for _ in range(n_threads)]
        self.errors = [0] * n_threads
        self._stop = threading.Event()
        half = world.rows // 2

        def run(j):
            # thread j's disjoint rows: one on each shard
            mine = [j % half, half + (j % half)]
            ones = np.ones((1, world.dim), np.float32)
            i = 0
            while not self._stop.is_set():
                row = mine[i % len(mine)]
                try:
                    self.w.t0.add_rows([row], ones)   # blocking = acked
                except Exception:   # noqa: BLE001 — replay exhausted
                    self.errors[j] += 1
                    time.sleep(0.05)
                    continue
                self.counts[j][row] += 1
                self.stamps[j].append(time.time())
                i += 1

        self._threads = [threading.Thread(target=run, args=(j,),
                                          daemon=True)
                         for j in range(n_threads)]

    def start(self):
        self.t_start = time.time()
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 90.0):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        self.t_end = time.time()

    def ledger(self):
        """Drain the window, read the final table, settle the exactly-once
        ledger against the acked oracle."""
        self.w.t0.flush()
        final = self.w.t0.get_rows(np.arange(self.w.rows))
        acked = np.zeros(self.w.rows, np.int64)
        for c in self.counts:
            acked += c
        return _ledger(final, acked, self.w.dim, sum(self.errors))

    def all_stamps(self):
        return np.concatenate(
            [np.asarray(s) for s in self.stamps if s] or [np.zeros(0)])


def _ledger(final: np.ndarray, acked: np.ndarray, dim: int,
            errors: int) -> dict:
    oracle = np.repeat(acked[:, None], dim, axis=1).astype(np.float32)
    per_row = final[:, 0].astype(np.int64)
    return {
        "acked_ops": int(acked.sum()),
        "ops_lost": int(np.maximum(acked - per_row, 0).sum()),
        "ops_double_applied": int(np.maximum(per_row - acked, 0).sum()),
        "parity_bit_for_bit": bool(np.array_equal(final, oracle)),
        "add_errors": int(errors),
    }


class InferStorm:
    """M reader threads against the pool: hot-set reads with
    ``with_age=True`` — every SERVED read's age is evidence for the
    staleness gate; every refusal (shed, over bound, outage) counts but
    never violates it."""

    def __init__(self, pool, rows: int, n_threads: int = 2,
                 pace_s: float = 0.002):
        self.pool = pool
        self._stop = threading.Event()
        self.stamps = [[] for _ in range(n_threads)]
        self.max_age = [0.0] * n_threads
        self.over_bound = [0] * n_threads
        self.refused = [0] * n_threads
        self.shed = [0] * n_threads
        hot = np.arange(min(8, rows))

        def run(j):
            from multiverso_tpu_torch.serving.admission import SheddingError
            rng = np.random.default_rng(j)
            while not self._stop.is_set():
                ids = (hot[rng.integers(0, len(hot), 3)]
                       if rng.random() < 0.8
                       else rng.integers(0, rows, 3))
                try:
                    _rows, age = self.pool.get_rows(
                        np.unique(ids), with_age=True)
                except SheddingError:
                    self.shed[j] += 1
                    time.sleep(0.005)
                    continue
                except Exception:   # noqa: BLE001 — outage / over
                    self.refused[j] += 1     # bound: refused, not stale
                    time.sleep(0.02)
                    continue
                self.max_age[j] = max(self.max_age[j], age)
                if age > self.pool.staleness_s + 1e-9:
                    self.over_bound[j] += 1
                self.stamps[j].append(time.time())
                if pace_s:
                    time.sleep(pace_s)

        self._threads = [threading.Thread(target=run, args=(j,),
                                          daemon=True)
                         for j in range(n_threads)]

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)

    def report(self):
        return {
            "served": int(sum(len(s) for s in self.stamps)),
            "refused": int(sum(self.refused)),
            "shed": int(sum(self.shed)),
            "max_served_age_s": round(max(self.max_age), 3),
            "over_bound_serves": int(sum(self.over_bound)),
        }

    def all_stamps(self):
        return np.concatenate(
            [np.asarray(s) for s in self.stamps if s] or [np.zeros(0)])


def _replay_counts() -> dict:
    from multiverso_tpu_torch.utils.dashboard import Dashboard
    return {k: Dashboard.get(f"table[{TABLE}].replay.{k}").count
            for k in ("frames", "dups", "dropped")}


def _exactly_once(led: dict) -> bool:
    return (led["ops_lost"] == 0 and led["ops_double_applied"] == 0
            and led["parity_bit_for_bit"])


# ---------------------------------------------------------------------- #
# SLO sentinel plumbing (tools/bench_chaos.py): scenarios arm a
# scenario-scoped spec and drive an EXPLICIT in-process aggregator —
# nothing else in this process polls, so the judge schedule (and hence
# the episode lifecycle) is deterministic
# ---------------------------------------------------------------------- #
AVAIL_OBJECTIVE = {
    "name": "chaos_availability", "kind": "availability",
    "table": TABLE, "target": 0.9, "min": 1.0}


_health_saved: list = []   # ps_health_timeout before each _arm_sentinel


def _arm_sentinel(w: "World", objectives,
                  fast_window_s: float = 3.0):
    """Reset sentinel + bus, arm the scenario spec, and return
    (aggregator, metrics_dir). fast_burn=1.0 (one bad poll in the fast
    window pages — the scenario owns the schedule), slow_burn low so
    the 60 s slow window confirms rather than delays. Pair with
    :func:`_disarm_sentinel` in the scenario's finally — the matrix
    (and the tests) share one process."""
    from multiverso_tpu_torch.telemetry import aggregator
    from multiverso_tpu_torch.telemetry import signals as sgn
    from multiverso_tpu_torch.telemetry import slo as slo_mod
    from multiverso_tpu_torch.utils import config
    slo_mod.reset()
    sgn.reset()
    # probes must stay snappy while a partition wedges the data plane
    # (one poll is bounded by ~2 health timeouts); _disarm_sentinel puts
    # the caller's timeout back
    _health_saved.append(config.get_flag("ps_health_timeout"))
    config.set_flag("ps_health_timeout", 1.0)
    slo_mod.arm({"fast_window_s": fast_window_s, "slow_window_s": 60.0,
                 "fast_burn": 1.0, "slow_burn": 0.1,
                 "objectives": list(objectives)})
    mdir = os.path.join(w.tmp, "metrics")
    agg = aggregator.ClusterAggregator(w.ctx0.service, directory=mdir)
    return agg, mdir


def _disarm_sentinel() -> None:
    """Scenario-exit cleanup: a still-armed process-global sentinel
    would judge (and tag ``slo`` blocks onto) every later poll in this
    process, and so would the 1 s health timeout."""
    from multiverso_tpu_torch.telemetry import signals as sgn
    from multiverso_tpu_torch.telemetry import slo as slo_mod
    from multiverso_tpu_torch.utils import config
    slo_mod.reset()
    sgn.reset()
    if _health_saved:
        config.set_flag("ps_health_timeout", _health_saved.pop())


def _sleep_poll(agg, seconds: float, cadence: float = 0.5,
                seqs: dict = None) -> None:
    """Sleep ``seconds`` while polling every ``cadence`` — each poll is
    one sentinel judgment. ``seqs``: scan the flight recorder for SLO
    events right after EVERY poll (post-heal traffic wraps the ring in
    well under a phase)."""
    end = time.monotonic() + float(seconds)
    while True:
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(cadence, left))
        try:
            agg.poll_once()
        except Exception:   # noqa: BLE001 — telemetry never kills chaos
            pass
        if seqs is not None:
            _scan_slo_events(seqs)


def _scan_slo_events(seqs: dict) -> None:
    """Ring-scan dedup by seq (the ring wraps many times in a matrix
    run, so scan at every poll, not once at the end)."""
    from multiverso_tpu_torch.telemetry import flightrec as flight
    for s in flight.RECORDER.snapshot():
        if s[2] in (flight.EV_SLO_FIRED, flight.EV_SLO_CLEARED):
            seqs[s[0]] = {"ev": flight.EV_NAMES.get(s[2]),
                          "note": s[7]}


def _read_alerts(mdir: str) -> list:
    """alerts.jsonl lines (the sentinel's episode log) as dicts."""
    out = []
    try:
        with open(os.path.join(mdir, "alerts.jsonl")) as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    out.append(json.loads(ln))
    except (OSError, ValueError):
        pass
    return out


def _slo_block(agg) -> dict:
    """The scenario result's ``slo`` summary: per-objective episode
    counts, the eval count and what is firing."""
    snap = ((agg.last() or {}).get("slo")) or {}
    return {
        "episodes": {name: int(o.get("episodes") or 0)
                     for name, o in (snap.get("objectives")
                                     or {}).items()},
        "evals": snap.get("evals", 0),
        "firing": list(snap.get("firing") or []),
    }


def _episodes(mdir: str) -> list:
    """Each alert line reduced to what the chaos phase prints: the
    objective, fired or cleared, the burns and the judging poll's
    wall clock."""
    return [{"objective": a.get("objective"), "kind": a.get("kind"),
             "burn_fast": a.get("burn_fast"),
             "burn_slow": a.get("burn_slow"), "ts": a.get("ts")}
            for a in _read_alerts(mdir)]


class TenantReader:
    """One tenant's paced read loop against the pool (the noisy-neighbor
    scenario's unit): every admitted read's wall latency and served age
    is per-tenant evidence for the p99/staleness gates, every shed is
    the per-tenant budget doing its job. ``pace_s`` bounds the ATTEMPT
    rate (sheds sleep it too)."""

    def __init__(self, pool, rows: int, tenant: str,
                 pace_s: float = 0.0, n_threads: int = 1):
        self.pool = pool
        self.tenant = tenant
        self._stop = threading.Event()
        self.lat = [[] for _ in range(n_threads)]   # (wall_ts, ms)
        self.shed = [0] * n_threads
        self.refused = [0] * n_threads
        self.over_bound = [0] * n_threads
        self.max_age = [0.0] * n_threads
        hot = np.arange(min(8, rows))

        def run(j):
            from multiverso_tpu_torch.serving.admission import SheddingError
            rng = np.random.default_rng(97 + j)
            while not self._stop.is_set():
                ids = np.unique(hot[rng.integers(0, len(hot), 3)])
                t0 = time.perf_counter()
                try:
                    _rows, age = self.pool.get_rows(
                        ids, with_age=True, tenant=self.tenant)
                except SheddingError:
                    self.shed[j] += 1
                    time.sleep(pace_s or 0.001)
                    continue
                except Exception:   # noqa: BLE001 — outage/over bound
                    self.refused[j] += 1
                    time.sleep(0.02)
                    continue
                ms = (time.perf_counter() - t0) * 1e3
                self.max_age[j] = max(self.max_age[j], age)
                if age > self.pool.staleness_s + 1e-9:
                    self.over_bound[j] += 1
                self.lat[j].append((time.time(), ms))
                if pace_s:
                    time.sleep(pace_s)

        self._threads = [threading.Thread(target=run, args=(j,),
                                          daemon=True)
                         for j in range(n_threads)]

    def start(self):
        for t in self._threads:
            t.start()
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)

    def all_lat(self):
        return [p for l in self.lat for p in l]

    def report(self):
        return {
            "served": int(sum(len(l) for l in self.lat)),
            "shed": int(sum(self.shed)),
            "refused": int(sum(self.refused)),
            "max_served_age_s": round(max(self.max_age), 3),
            "over_bound_serves": int(sum(self.over_bound)),
        }


# ---------------------------------------------------------------------- #
# in-process scenarios
# ---------------------------------------------------------------------- #
def scenario_partition_heal(seconds: float = 10.0, tmp: str = "",
                            device=None) -> dict:
    """One-way 0→1 partition under windowed-add traffic, then heal.
    The SLO sentinel judges a chaos-table availability objective on
    every explicit poll: the cut stalls every add thread on its shard-1
    row while replay retains their frames — zero windowed progress
    against provably pent demand — so the objective must FIRE during
    the cut and CLEAR after the heal, on both evidence surfaces (the
    flight recorder and alerts.jsonl)."""
    from multiverso_tpu_torch.ps import faults
    w = World(tmp, rows=32, dim=8, device=device)
    slo_seqs: dict = {}
    try:
        rep0 = _replay_counts()
        agg, mdir = _arm_sentinel(w, [AVAIL_OBJECTIVE])
        plane = faults.arm({"seed": 11, "rules": [
            {"kind": "partition", "src": 0, "dst": 1,
             "phase": "cut"}]}, rank=0)
        tr = Traffic(w, n_threads=3).start()
        pre_s = min(max(seconds * 0.3, 2.5), 4.0)
        # >= 2.2 s cut: the judge needs two in-cut polls (the first
        # cut interval can still hold pre-cut acks)
        cut_s = max(min(max(seconds * 0.2, 1.5), 3.0), 2.2)
        _sleep_poll(agg, pre_s, seqs=slo_seqs)
        fault_wall = time.time()
        plane.set_phase("cut")
        _sleep_poll(agg, cut_s, seqs=slo_seqs)
        heal_wall = time.time()
        plane.set_phase(None)
        _sleep_poll(agg, max(seconds - pre_s - cut_s, 4.5),
                    seqs=slo_seqs)
        _scan_slo_events(slo_seqs)
        tr.stop()
        led = tr.ledger()
        pre, post, rec = recovery_from_stamps(
            tr.all_stamps(), tr.t_start, tr.t_end, fault_wall,
            recover_from=heal_wall)
        inj = plane.stats()["injected"]
        alerts = _read_alerts(mdir)
        a_fired = [a for a in alerts
                   if a.get("kind") == "slo.fired"
                   and a.get("objective") == "chaos_availability"]
        a_cleared = [a for a in alerts
                     if a.get("kind") == "slo.cleared"
                     and a.get("objective") == "chaos_availability"]
        ring_fired = sum(1 for e in slo_seqs.values()
                         if e["ev"] == "slo.fired")
        ring_cleared = sum(1 for e in slo_seqs.values()
                           if e["ev"] == "slo.cleared")
        return {
            "recovery_s": rec, "recovered_to_90pct": rec is not None,
            "pre_fault_ops_per_s": round(pre, 1),
            "post_fault_ops_per_s": round(post, 1),
            "partition_s": round(heal_wall - fault_wall, 2),
            "fault_wall": fault_wall, "heal_wall": heal_wall,
            "injected": inj,
            "replay": _delta(_replay_counts(), rep0),
            "slo": {**_slo_block(agg),
                    "alerts_fired": len(a_fired),
                    "alerts_cleared": len(a_cleared),
                    "ring_fired": ring_fired,
                    "ring_cleared": ring_cleared,
                    "episodes_log": _episodes(mdir)},
            **led,
            "gates": {
                "exactly_once": _exactly_once(led),
                "recovery": rec is not None,
                "injected_nonzero": inj.get("partition", 0) > 0,
                # the alert carries the judging poll's wall clock: the
                # fire must land inside the cut (small slack for the
                # poll that straddles the heal), the clear after it
                "slo_fired_during_cut": ring_fired > 0 and any(
                    fault_wall <= (a.get("ts") or 0)
                    <= heal_wall + 0.75 for a in a_fired),
                "slo_cleared_after_heal": ring_cleared > 0 and any(
                    (a.get("ts") or 0) >= heal_wall
                    for a in a_cleared),
            },
        }
    finally:
        _disarm_sentinel()
        w.close()


def scenario_dup_reorder(seconds: float = 8.0, tmp: str = "",
                         device=None) -> dict:
    """Duplicate and bounded-reorder injection on the replay-stamped add
    frames: the shard's sequence channels must hold exactly-once. A
    QUIET scenario for the SLO sentinel: dups and reorders never stall
    progress, so the availability objective that fires under a
    partition must log ZERO episodes here — the false-fire guard."""
    from multiverso_tpu_torch.ps import faults
    w = World(tmp, rows=32, dim=8, device=device)
    try:
        rep0 = _replay_counts()
        agg, mdir = _arm_sentinel(w, [AVAIL_OBJECTIVE])
        plane = faults.arm({"seed": 7, "rules": [
            {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.35,
             "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]},
            {"kind": "reorder", "src": 0, "dst": 1, "p": 0.25,
             "depth": 2, "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]},
        ]}, rank=0)
        tr = Traffic(w, n_threads=3).start()
        _sleep_poll(agg, max(seconds, 4.0))
        tr.stop()
        faults.disarm()   # the settle flush runs clean
        led = tr.ledger()
        slo_blk = _slo_block(agg)
        dup_frames = 0
        try:
            dup_frames = int(w.t0.server_stats(1)["shards"][TABLE]
                             .get("dup_frames") or 0)
        except Exception:   # noqa: BLE001 — stats are best-effort
            pass
        inj = plane.stats()["injected"]
        return {
            "recovery_s": None,   # no heal phase in this scenario
            "injected": inj, "dup_frames_deduped": dup_frames,
            "replay": _delta(_replay_counts(), rep0),
            "slo": {**slo_blk, "episodes_log": _episodes(mdir)},
            **led,
            "gates": {
                "exactly_once": _exactly_once(led),
                "injected_nonzero": inj.get("duplicate", 0) > 0
                and inj.get("reorder", 0) > 0,
                "dups_reached_shard": dup_frames > 0,
                # false-fire guard: the sentinel judged every poll and
                # nothing fired
                "slo_quiet": slo_blk["evals"] > 0
                and sum(slo_blk["episodes"].values()) == 0
                and not _read_alerts(mdir),
            },
        }
    finally:
        _disarm_sentinel()
        w.close()


def scenario_slow_shard_shed(seconds: float = 12.0, tmp: str = "",
                             device=None) -> dict:
    """Slow-serve injection on shard 1 under a pooled read storm and
    training writes: the staleness bound holds on every served read while
    the slow phase sheds or defers, and QPS recovers after the heal. The
    pool carries one warm spare so the autoscaling seam closes end to
    end: mid-slow, the storm's admission shedding rides the signal bus
    (``shed_rate`` far over policy, ``spares_left`` = 1) and
    ``tools/mvautoscale.recommend`` must say GROW — without actuating.
    Also a QUIET scenario for the availability objective (reads slow,
    writes never stall)."""
    from multiverso_tpu_torch.ps import faults
    from multiverso_tpu_torch.serving.admission import AdmissionController
    from multiverso_tpu_torch.tools import mvautoscale
    w = World(tmp, rows=32, dim=8, staleness_s=2.0, device=device)
    try:
        rep0 = _replay_counts()
        agg, mdir = _arm_sentinel(w, [AVAIL_OBJECTIVE])
        adm = AdmissionController()
        adm.set_limit(TABLE, "infer", 400.0)
        plane = faults.arm({"seed": 13, "rules": [
            {"kind": "slow_serve", "rank": 1, "delay_ms": 350,
             "jitter_ms": 100, "phase": "slow"}]}, rank=0)
        pool = w.make_pool(replicas=2, spares=1, refresh_s=0.15,
                           admission=adm)
        tr = Traffic(w, n_threads=2).start()
        storm = InferStorm(pool, w.rows, n_threads=2).start()
        # >= 4.5 s pre: the admission bucket opens FULL, so the storm's
        # first ~1.25 s is a token burst that must stay out of the 3 s
        # pre-fault window
        pre_s = min(max(seconds * 0.25, 4.5), 6.0)
        slow_s = min(max(seconds * 0.3, 2.5), 4.0)
        _sleep_poll(agg, pre_s)
        fault_wall = time.time()
        plane.set_phase("slow")
        _sleep_poll(agg, slow_s)
        # mid-storm verdict off the freshest record (rates derived vs
        # the poll one cadence earlier): the autoscaler's exact input
        verdict = mvautoscale.recommend(
            mvautoscale.snapshot_from_record(agg.last() or {}))
        heal_wall = time.time()
        plane.set_phase(None)
        _sleep_poll(agg, max(seconds - pre_s - slow_s, 4.0))
        storm.stop()
        tr.stop()
        led = tr.ledger()
        srv = storm.report()
        slo_blk = _slo_block(agg)
        pre, post, rec = recovery_from_stamps(
            storm.all_stamps(), tr.t_start, time.time(), fault_wall,
            recover_from=heal_wall)
        inj = plane.stats()["injected"]
        return {
            "recovery_s": rec, "recovered_to_90pct": rec is not None,
            "pre_fault_qps": round(pre, 1),
            "post_fault_qps": round(post, 1),
            "slow_s": round(heal_wall - fault_wall, 2),
            "fault_wall": fault_wall, "heal_wall": heal_wall,
            "injected": inj,
            "serving": srv, "pool": pool.stats_entry()["pool"],
            "replay": _delta(_replay_counts(), rep0),
            "slo": {**slo_blk, "episodes_log": _episodes(mdir)},
            "autoscale": {"action": verdict["action"],
                          "actionable": verdict["actionable"],
                          "reason": verdict["reason"]},
            **led,
            "gates": {
                "exactly_once": _exactly_once(led),
                "served_nonzero": srv["served"] > 0,
                "staleness": srv["over_bound_serves"] == 0,
                "recovery": rec is not None,
                "injected_nonzero": inj.get("slow_serve", 0) > 0,
                "autoscale_grow": verdict["action"] == "grow"
                and verdict["actionable"],
                # the injected slow-serve genuinely stalls the data
                # plane, so the availability objective MAY fire during
                # the slow phase — but the sentinel must judge
                # throughout and be CLEAR again once the heal's polls
                # age the stall out of the fast window
                "slo_judged_and_clear": slo_blk["evals"] > 0
                and slo_blk["firing"] == [],
            },
        }
    finally:
        _disarm_sentinel()
        w.close()


def scenario_replica_kill(seconds: float = 10.0, tmp: str = "",
                          device=None) -> dict:
    """Kill one pool member mid-storm: demotion and warm-spare activation
    keep served QPS up; the bound holds throughout."""
    w = World(tmp, rows=32, dim=8, staleness_s=2.0, device=device)
    try:
        rep0 = _replay_counts()
        pool = w.make_pool(replicas=2, spares=1, refresh_s=0.15)
        tr = Traffic(w, n_threads=2).start()
        storm = InferStorm(pool, w.rows, n_threads=2).start()
        pre_s = min(max(seconds * 0.3, 2.5), 4.0)
        time.sleep(pre_s)
        kill_wall = time.time()
        pool.kill_replica(0)
        time.sleep(max(seconds - pre_s, 5.0))
        storm.stop()
        tr.stop()
        led = tr.ledger()
        srv = storm.report()
        pre, post, rec = recovery_from_stamps(
            storm.all_stamps(), tr.t_start, time.time(), kill_wall)
        return {
            "recovery_s": rec, "recovered_to_90pct": rec is not None,
            "pre_fault_qps": round(pre, 1),
            "post_fault_qps": round(post, 1),
            "serving": srv, "pool": pool.stats_entry()["pool"],
            "pool_events": [{"ts": ts, "phase": p, "member": m}
                            for ts, p, m in pool.events],
            "replay": _delta(_replay_counts(), rep0),
            **led,
            "gates": {
                "exactly_once": _exactly_once(led),
                "served_nonzero": srv["served"] > 0,
                "staleness": srv["over_bound_serves"] == 0,
                "recovery": rec is not None,
                "spare_activated": any(
                    p == "spare_activated" for _, p, _ in pool.events),
            },
        }
    finally:
        w.close()


def scenario_noisy_neighbor(seconds: float = 12.0, tmp: str = "",
                            device=None) -> dict:
    """Two tenants share one pool: the storm tenant drives far past its
    per-tenant infer budget while the victim is paced modestly over its
    own. The quiet phase (victim alone) measures the victim's baseline
    p99 on ADMITTED reads — with one active tenant no verdict can fire,
    by construction. The storm phase adds the storm tenant; the sweep
    must open exactly one noisy-neighbor episode and clear it after the
    cool-down. Sweeps run only on the explicit ``stats_snapshot`` pulls
    here — nothing else in this process asks for MSG_STATS — so the
    episode lifecycle is deterministic."""
    from multiverso_tpu_torch.serving.admission import AdmissionController
    from multiverso_tpu_torch.telemetry import flightrec as flight
    from multiverso_tpu_torch.telemetry import tenants
    w = World(tmp, rows=32, dim=8, staleness_s=2.0, device=device)
    # flight-recorder verdict records deduped by ring seq across scans:
    # the Python wire plane wraps the ring many times in a run
    verdict_seqs = {}

    def scan_verdicts():
        for s in flight.RECORDER.snapshot():
            if s[2] == flight.EV_TENANT_VERDICT:
                verdict_seqs[s[0]] = s[7]

    try:
        # the matrix runs scenarios in ONE process: drop the neighbors'
        # ledger entries and tape before the verdict gates
        tenants.reset()
        flight.reset()
        VICTIM_QPS, STORM_QPS = 30.0, 50.0
        STORM_BURST = 10.0
        adm = AdmissionController()
        adm.set_tenant_limit(TABLE, "victim", "infer", VICTIM_QPS,
                             burst=8.0)
        adm.set_tenant_limit(TABLE, "storm", "infer", STORM_QPS,
                             burst=STORM_BURST)
        pool = w.make_pool(replicas=2, refresh_s=0.15, admission=adm)
        quiet_s = min(max(seconds * 0.3, 2.5), 4.0)
        storm_s = min(max(seconds * 0.4, 3.0), 5.0)
        # victim: ~90 attempts/s vs a 30 qps budget — sheds steadily in
        # BOTH phases, so the storm interval always has a degraded
        # second tenant (the verdict's victim condition)
        victim = TenantReader(pool, w.rows, "victim",
                              pace_s=1.0 / 90.0).start()
        time.sleep(quiet_s)
        tenants.stats_snapshot()   # sweep 1: quiet interval — victim
        scan_verdicts()            # alone, no verdict possible
        storm_wall = time.time()
        # storm: 2 threads ~250 attempts/s each vs a 50 qps budget
        storm = TenantReader(pool, w.rows, "storm", pace_s=0.004,
                             n_threads=2).start()
        time.sleep(max(storm_s * 0.6, 1.5))
        snap_mid = tenants.stats_snapshot()   # sweep 2: verdict fires
        scan_verdicts()
        time.sleep(max(storm_s * 0.4, 1.0))
        tenants.stats_snapshot()   # sweep 3: episode stays open (dedup)
        scan_verdicts()
        storm.stop()
        storm_end = time.time()
        victim.stop()
        tenants.stats_snapshot()   # sweep 4: residual deltas
        time.sleep(0.25)
        final = tenants.stats_snapshot()   # sweep 5: zero deltas clear
        scan_verdicts()            # the episode

        v_lat = victim.all_lat()
        base = [ms for ts, ms in v_lat if ts < storm_wall]
        stormp = [ms for ts, ms in v_lat if ts >= storm_wall]
        base_p99 = float(np.percentile(base, 99)) if base else 0.0
        storm_p99 = (float(np.percentile(stormp, 99)) if stormp
                     else float("inf"))
        # sub-ms baselines on the in-process pool are scheduler noise,
        # not a serving-latency statement: floor before the 2x gate
        p99_bound = 2.0 * max(base_p99, 1.5)
        T = storm_end - storm_wall
        srv_v, srv_s = victim.report(), storm.report()
        # the budget cap: served <= qps*T + burst + slack (one second
        # of rate + a constant for sweep/timing jitter)
        allowed = STORM_QPS * T + STORM_BURST + STORM_QPS + 20.0
        ver = final.get("verdict") or {}
        return {
            "recovery_s": None,   # no heal phase: caps + verdicts gate
            "quiet_s": round(quiet_s, 2), "storm_s": round(T, 2),
            "victim": {
                "qps_limit": VICTIM_QPS, **srv_v,
                "base_p99_ms": round(base_p99, 3),
                "storm_p99_ms": round(storm_p99, 3),
                "storm_served": len(stormp),
            },
            "storm": {
                "qps_limit": STORM_QPS, **srv_s,
                "allowed_at_budget": round(allowed, 1),
            },
            "storm_share": (snap_mid.get("shares") or {}).get("storm"),
            "tenants_block": {k: final.get(k) for k in
                              ("shares", "episodes", "active",
                               "verdict")},
            "flight_verdicts": len(verdict_seqs),
            "episodes": tenants.LEDGER.episodes(),
            "gates": {
                "served_nonzero": len(base) > 0 and srv_s["served"] > 0,
                "storm_capped": srv_s["served"] <= allowed,
                "storm_shed_nonzero": srv_s["shed"] > 0,
                "victim_admitted": len(stormp) > 0,
                "victim_p99": storm_p99 <= p99_bound,
                "staleness": srv_v["over_bound_serves"] == 0
                and srv_s["over_bound_serves"] == 0,
                "verdict_once": tenants.LEDGER.episodes() == 1
                and len(verdict_seqs) == 1,
                "verdict_in_stats": final.get("episodes") == 1
                and final.get("active") is False
                and ver.get("tenant") == "storm",
            },
        }
    finally:
        tenants.reset()
        w.close()


def _delta(now: dict, before: dict) -> dict:
    return {k: now[k] - before.get(k, 0) for k in now}


# ---------------------------------------------------------------------- #
# combined scenario: OS-process SIGKILL of a shard + a replica kill,
# under training writes and an inference storm
# ---------------------------------------------------------------------- #
def worker(argv) -> None:
    """Worker body (both ranks): ``python -m
    multiverso_tpu_torch.examples.chaos worker <rdv> <hb> <ck> <world>
    <rank> <rows> <dim> <threads> <device>`` (device ``-`` = the card)."""
    rdv_dir, hb_dir, ck_dir = argv[0], argv[1], argv[2]
    world, rank = int(argv[3]), int(argv[4])
    rows, dim, n_threads = int(argv[5]), int(argv[6]), int(argv[7])
    device = None if argv[8] == "-" else argv[8]

    from multiverso_tpu_torch import checkpoint, elastic
    from multiverso_tpu_torch.ps import failover
    from multiverso_tpu_torch.ps.service import (FileRendezvous, PSContext,
                                                 PSService)
    from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
    from multiverso_tpu_torch.serving.pool import ReplicaPool
    from multiverso_tpu_torch.utils import config

    restarted = os.environ.get("MV_RESTARTED") == "1"
    config.set_flag("ps_native", False)   # the fault plane's wire
    config.set_flag("ps_timeout", 60.0)
    config.set_flag("ps_connect_timeout", 5.0)
    config.set_flag("ps_reconnect_backoff", 0.3)
    config.set_flag("ps_replay", True)
    config.set_flag("ps_replay_backoff", 0.2)
    config.set_flag("ps_replay_backoff_cap", 1.0)
    config.set_flag("ps_generation",
                    int(os.environ.get("MV_PS_GENERATION", "0")))
    config.set_flag("failover_dir", ck_dir)
    # a RESTARTED rank must restore BEFORE its first periodic save — an
    # empty-shard save racing the restore would become the newest
    # committed tag; its checkpointer starts after the rejoin
    config.set_flag("failover_ckpt_interval_s", 0.0 if restarted else 0.5)
    # restarted ranks defer the rendezvous publish: the restore must
    # complete before any survivor can discover the fresh address
    svc = PSService(rank, world, FileRendezvous(rdv_dir),
                    defer_publish=restarted)
    ctx = PSContext(rank, world, svc, device=device)
    hb = elastic.Heartbeat(hb_dir, interval=0.2, rank=rank, addr=svc.addr)
    elastic.bind_ps(hb_dir, ctx)
    t = AsyncMatrixTable(rows, dim, name=TABLE, send_window_ms=1.0,
                         ctx=ctx)
    rejoined = None
    if restarted:
        tag = checkpoint.latest_shard_tag(ck_dir, rank)
        t_r = time.perf_counter()
        n = failover.rejoin(ck_dir, rank, [t], heartbeat=hb, service=svc)
        rejoined = {"restored": n, "tag": tag,
                    "restore_ms": (time.perf_counter() - t_r) * 1e3,
                    "version": t._shard.stats()["version"]}
        config.set_flag("failover_ckpt_interval_s", 0.5)
    ck = failover.ensure_checkpointer(svc)
    hb.start()

    if rank != 0:
        # server only: hold the shard up until rank 0 is done
        done = os.path.join(rdv_dir, "done")
        while not os.path.exists(done):
            time.sleep(0.05)
        hb.stop()
        saves = ck.saves if ck is not None else 0
        ctx.close()
        print("RESULT " + json.dumps(
            {"rank": rank, "restarted": restarted, "gen": svc.generation,
             "device": str(t.device), "ckpt_saves": saves,
             "rejoin": rejoined}), flush=True)
        return

    # ------------------------- traffic plane -------------------------- #
    half = rows // world
    stop = threading.Event()
    per_thread_counts = [np.zeros(rows, np.int64)
                         for _ in range(n_threads)]
    per_thread_stamps = [[] for _ in range(n_threads)]
    errs = [0] * n_threads

    def run_traffic(j: int) -> None:
        # even threads hammer shard 0's rows, odd threads shard 1's —
        # disjoint per-thread row sets, so the oracle is exact
        base = 0 if j % 2 == 0 else half
        mine = [base + (j // 2) + k * (n_threads // 2 + 1)
                for k in range(3)]
        mine = [r for r in mine if base <= r < base + half]
        ones = np.ones((1, dim), np.float32)
        counts, stamps = per_thread_counts[j], per_thread_stamps[j]
        i = 0
        while not stop.is_set():
            row = mine[i % len(mine)]
            try:
                t.add_rows([row], ones)   # blocking = acked
            except Exception:   # noqa: BLE001 — replay window exhausted
                errs[j] += 1
                time.sleep(0.05)
                continue
            counts[row] += 1
            stamps.append(time.time())
            i += 1

    # ------------------------- serving plane -------------------------- #
    # 2 actives + 1 warm spare; the parent's kill_replica marker fells
    # member 0 at the same instant it SIGKILLs the rank-1 shard
    pool = ReplicaPool(t, replicas=2, spares=1, refresh_s=0.2,
                       staleness_s=2.5, probe_s=0.3, start=True)
    storm = InferStorm(pool, rows, n_threads=2, pace_s=0.004).start()
    kill_marker = os.path.join(rdv_dir, "kill_replica")

    def watch_kill():
        while not stop.is_set():
            if os.path.exists(kill_marker):
                pool.kill_replica(0)
                return
            time.sleep(0.05)

    threads = [threading.Thread(target=run_traffic, args=(j,),
                                daemon=True) for j in range(n_threads)]
    killer = threading.Thread(target=watch_kill, daemon=True)
    t0 = time.time()
    for th in threads:
        th.start()
    killer.start()
    open(os.path.join(rdv_dir, "traffic_started"), "w").close()
    stop_marker = os.path.join(rdv_dir, "stop_traffic")
    while not os.path.exists(stop_marker):
        time.sleep(0.05)
    stop.set()
    storm.stop()
    for th in threads:
        th.join(timeout=90)
    # drain every retained and replayed frame before the parity read
    t.flush()
    final = t.get_rows(np.arange(rows))
    acked = np.zeros(rows, np.int64)
    for c in per_thread_counts:
        acked += c
    led = _ledger(final, acked, dim, sum(errs))
    t_end = time.time()
    stamps = np.concatenate(
        [np.asarray(s) for s in per_thread_stamps if s] or [np.zeros(0)])
    victim_stats = {}
    try:
        victim_stats = t.server_stats(1)["shards"][TABLE]
        victim_stats = {k: victim_stats.get(k) for k in
                        ("dup_frames", "replay_clients", "adds",
                         "applies", "version", "device")}
    except Exception as e:   # noqa: BLE001 — stats are best-effort
        victim_stats = {"error": f"{type(e).__name__}: {e}"[:120]}
    out = {
        "rank": 0, "t0": t0, "bucket_s": BUCKET_S,
        "buckets": rate_buckets(stamps, t0, t_end).tolist(),
        "serve_buckets": rate_buckets(storm.all_stamps(), t0,
                                      t_end).tolist(),
        "serving": storm.report(),
        "pool": pool.stats_entry()["pool"],
        "pool_events": [{"ts": ts, "phase": p, "member": m}
                        for ts, p, m in pool.events],
        **led,
        "replay": _replay_counts(), "victim_shard": victim_stats,
        "device": str(t.device),
        "ckpt_saves": ck.saves if ck is not None else 0,
    }
    open(os.path.join(rdv_dir, "done"), "w").close()
    pool.close()
    hb.stop()
    ctx.close()
    print("RESULT " + json.dumps(out), flush=True)


def _spawn_worker(rdv, hb, ck, fr, world, rank, rows, dim, threads, device,
                  gen: int = 0, restarted: bool = False):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MV_PS_GENERATION"] = str(gen)
    # one flight-recorder directory per incarnation: a respawned rank's
    # dumps must not replace its predecessor's
    env["MV_FLIGHTREC_DIR"] = os.path.join(fr, f"gen{gen}")
    if restarted:
        env["MV_RESTARTED"] = "1"
    else:
        env.pop("MV_RESTARTED", None)
    return subprocess.Popen(
        [sys.executable, "-m", "multiverso_tpu_torch.examples.chaos",
         "worker", rdv, hb, ck, str(world), str(rank), str(rows), str(dim),
         str(threads), device or "-"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=_REPO)


def _result_line(out: str) -> Optional[dict]:
    res = None
    for line in (out or "").splitlines():
        if line.startswith("RESULT "):
            res = json.loads(line[len("RESULT "):])
    return res


def _recovery_from_buckets(res: dict, kill_wall: float,
                           key: str = "buckets"):
    """The combined worker's bucket series -> the shared recovery
    detector (recovery measured from the kill)."""
    bs = res["bucket_s"]
    return _recovery_core(np.asarray(res[key], np.float64) / bs,
                          res["t0"], bs, kill_wall, kill_wall)


def scenario_combined(seconds: float = 18.0, rows: int = 64, dim: int = 8,
                      threads: int = 4, device=None) -> dict:
    """SIGKILL the rank-1 shard (a real OS process) AND kill a pool
    replica at the same instant, mid-storm; the FailoverSupervisor
    respawns the shard, the pool activates its spare."""
    from multiverso_tpu_torch.ps import failover

    t_wall0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mv_chaos_")
    rdv = os.path.join(tmp, "rdv")
    hb = os.path.join(tmp, "hb")
    ck = os.path.join(tmp, "ck")
    # the workers' flight-recorder dumps (the survivor's names the killed
    # rank with its unacked requests), one directory per generation
    fr = os.path.join(tmp, "flightrec")
    os.makedirs(rdv)
    world = 2
    procs = {}
    killed, respawns = [], []
    procs[1] = _spawn_worker(rdv, hb, ck, fr, world, 1, rows, dim, threads,
                             device)
    procs[0] = _spawn_worker(rdv, hb, ck, fr, world, 0, rows, dim, threads,
                             device)

    def kill_rank(rank: int) -> None:
        p = procs.get(rank)
        if p is not None and p.poll() is None:
            p.kill()
            killed.append(p)

    def spawn_rank(rank: int, gen: int) -> None:
        procs[rank] = _spawn_worker(rdv, hb, ck, fr, world, rank, rows,
                                    dim, threads, device, gen=gen,
                                    restarted=True)
        respawns.append(procs[rank])

    sup = failover.FailoverSupervisor(
        hb, world, rendezvous_dir=rdv, spawn=spawn_rank, kill=kill_rank,
        timeout=2.0, poll_s=0.2, ranks=[1])
    outs = {}
    try:
        deadline = time.time() + 180
        started = os.path.join(rdv, "traffic_started")
        while not os.path.exists(started):
            if time.time() > deadline:
                raise RuntimeError("traffic never started")
            for p in procs.values():
                if p.poll() not in (None, 0):
                    raise RuntimeError("worker died during startup")
            time.sleep(0.05)
        t_started = time.perf_counter()
        sup.start()
        pre_s = min(max(seconds * 0.3, 3.0), 8.0)
        time.sleep(pre_s)
        # chaos: SIGKILL the victim server shard AND fell a pool replica,
        # mid-traffic, at the same instant
        kill_wall = time.time()
        kill_rank(1)
        open(os.path.join(rdv, "kill_replica"), "w").close()
        # the respawn's time varies (a torch import and the card's
        # context): anchor the end of the run to the OBSERVED rejoin, so
        # the 90% detector always sees seconds of post-recovery traffic
        rejoin_deadline = time.time() + 60
        while not any(p == "rejoin" for _, p, _ in sup.events):
            if time.time() > rejoin_deadline:
                break
            time.sleep(0.2)
        time.sleep(max(seconds - pre_s - (time.time() - kill_wall), 6.0))
        # the chaos window is over: stop watching before rank 0's own
        # shutdown closes its connections, which its death hook reports
        # as a peer death (a respawn then would restart a rank that is
        # only being told to exit)
        sup.stop()
        open(os.path.join(rdv, "stop_traffic"), "w").close()
        out0 = outs[0] = procs[0].communicate(timeout=180)[0]
        if procs[0].returncode != 0:
            sys.stderr.write(out0[-2000:])
            raise RuntimeError(f"rank 0 rc={procs[0].returncode}")
        res = _result_line(out0)
        if res is None:
            raise RuntimeError("rank 0 produced no RESULT line")
    finally:
        sup.stop()
        open(os.path.join(rdv, "done"), "w").close()
        for r, p in procs.items():
            if r not in outs:
                try:
                    outs[r] = p.communicate(timeout=30)[0]
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for p in killed + respawns:
            if p.poll() is None:
                p.kill()
            p.wait()
    respawned = _result_line(outs.get(1, "")) or {}

    pre, post, train_rec = _recovery_from_buckets(res, kill_wall)
    srv_pre, srv_post, srv_rec = _recovery_from_buckets(
        res, kill_wall, key="serve_buckets")
    srv = res.get("serving", {})
    return {
        "recovery_s": srv_rec,
        "recovered_to_90pct": srv_rec is not None,
        "train_recovery_s": train_rec,
        "train_recovered_to_90pct": train_rec is not None,
        "pre_fault_qps": round(srv_pre, 1),
        "post_fault_qps": round(srv_post, 1),
        "pre_fault_ops_per_s": round(pre, 1),
        "post_fault_ops_per_s": round(post, 1),
        "acked_ops": res["acked_ops"],
        "ops_lost": res["ops_lost"],
        "ops_double_applied": res["ops_double_applied"],
        "parity_bit_for_bit": res["parity_bit_for_bit"],
        "add_errors": res["add_errors"],
        "serving": srv, "pool": res.get("pool"),
        "pool_events": res.get("pool_events"),
        "replay": res["replay"],
        "victim_shard": res["victim_shard"],
        "respawned": respawned,
        "ckpt_saves": {"rank0": res.get("ckpt_saves"),
                       "rank1_respawned": respawned.get("ckpt_saves")},
        "devices": {"rank0": res.get("device"),
                    "rank1_respawned": respawned.get("device")},
        "supervisor": {
            "events": [{"ts": ts, "phase": ph, "rank": r}
                       for ts, ph, r in sup.events],
            "spans": sup.recovery_spans(),
        },
        "respawns": len(respawns),
        "flightrec_dir": fr,
        "startup_s": round(t_started - t_wall0, 2),
        "world": world, "rows": rows, "dim": dim, "threads": threads,
        "gates": {
            "exactly_once": _exactly_once(res),
            "served_nonzero": srv.get("served", 0) > 0,
            "staleness": srv.get("over_bound_serves", 0) == 0,
            "recovery": srv_rec is not None and train_rec is not None,
            "spare_activated": any(
                e.get("phase") == "spare_activated"
                for e in res.get("pool_events") or []),
        },
    }


# ---------------------------------------------------------------------- #
SCENARIOS = {
    "partition_heal": scenario_partition_heal,
    "dup_reorder": scenario_dup_reorder,
    "slow_shard_shed": scenario_slow_shard_shed,
    "replica_kill": scenario_replica_kill,
    "noisy_neighbor": scenario_noisy_neighbor,
}


def main(argv) -> int:
    args, only, device = [], None, None
    it = iter(argv)
    for a in it:
        if a.startswith("--scenario"):
            only = a.split("=", 1)[1] if "=" in a else next(it, None)
        elif a.startswith("--device"):
            device = a.split("=", 1)[1] if "=" in a else next(it, None)
        elif not a.startswith("--"):
            args.append(a)
    if (only is not None and only != "combined"
            and only not in SCENARIOS):
        print(f"unknown scenario {only!r} (one of "
              f"{sorted(SCENARIOS) + ['combined']})", file=sys.stderr)
        return 2
    seconds = float(args[0]) if args else 18.0
    rows = int(args[1]) if len(args) > 1 else 64
    dim = int(args[2]) if len(args) > 2 else 8
    threads = int(args[3]) if len(args) > 3 else 4

    scenarios, failed = {}, []
    run_list = ([only] if only and only != "combined"
                else list(SCENARIOS) if only is None else [])
    for name in run_list:
        t0 = time.time()
        try:
            rec = SCENARIOS[name](seconds=max(seconds * 0.6, 8.0),
                                  device=device)
        except Exception as e:   # noqa: BLE001 — one scenario's crash
            rec = {"error": f"{type(e).__name__}: {e}"[:300],
                   "gates": {"ran": False}}
        rec["wall_s"] = round(time.time() - t0, 1)
        scenarios[name] = rec
        bad = [g for g, ok in rec.get("gates", {}).items() if not ok]
        if bad:
            failed.append(f"{name}: {','.join(bad)}")
        print(f"# scenario {name}: "
              + ("FAILED " + ",".join(bad) if bad else "ok")
              + f" ({rec['wall_s']}s)", file=sys.stderr, flush=True)
    if only in (None, "combined"):
        t0 = time.time()
        try:
            rec = scenario_combined(seconds=seconds, rows=rows, dim=dim,
                                    threads=threads, device=device)
        except Exception as e:   # noqa: BLE001
            rec = {"error": f"{type(e).__name__}: {e}"[:300],
                   "gates": {"ran": False}}
        rec["wall_s"] = round(time.time() - t0, 1)
        scenarios["combined"] = rec
        bad = [g for g, ok in rec.get("gates", {}).items() if not ok]
        if bad:
            failed.append(f"combined: {','.join(bad)}")
        print("# scenario combined: "
              + ("FAILED " + ",".join(bad) if bad else "ok")
              + f" ({rec['wall_s']}s)", file=sys.stderr, flush=True)
    print("RESULT " + json.dumps({"scenarios": scenarios,
                                  "gates_failed": failed}), flush=True)
    return 3 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(sys.argv[2:])
    else:
        raise SystemExit(main(sys.argv[1:]))
