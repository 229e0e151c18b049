"""ReplicaPool: N read replicas per table that survive chaos (port of
``multiverso_tpu/serving/pool.py``).

Several :class:`~multiverso_tpu_torch.serving.replica.ReadReplica` of one
table behind one read surface, with routing, health and spare capacity,
so that losing a replica — or the shard it pulls from — degrades QPS
briefly instead of zeroing it.

* **Least-staleness routing** — each read goes to the healthy active
  member with the freshest adopted snapshot (ties by the routed count),
  so a member mid-refresh or mid-outage sheds load to its siblings
  before any error is raised. Per-member route counts ride the stats
  block.

* **Health-aware demotion** — a member whose reads fail
  (:class:`~multiverso_tpu_torch.serving.replica.BoundUnsatisfiableError`,
  peer errors) or whose background pulls keep failing
  (``pull_health()["consecutive"] >= serving_pool_demote_after``) is
  DEMOTED: routed around, probed by the health loop, and only
  re-promoted after a successful in-bound refresh.

* **Warm spares** — ``spares`` extra members are constructed cold (no
  refresh thread, no snapshot) and activated on demotion: one
  synchronous priming pull, then they serve.

* **Bound-unsatisfiable failover** — a single replica raises after 3
  over-bound pulls; the pool catches the typed error, demotes the
  member, and tries every sibling (spares included). Only when the
  WHOLE pool is over bound does the caller see the error.

The pool registers a merged per-table stats entry with the serving
block (``serving/replica.register_pool_provider``): summed counters plus
a ``"pool"`` detail block (per-member age, degraded flag, route share).

Not ported (ROADMAP.md §A): ``bind_failover`` (failover, faults and
replay) raises, and a read naming a tenant raises (Telemetry and
tools).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np

from multiverso_tpu_torch.serving import replica as _replica_mod
from multiverso_tpu_torch.serving.admission import (AdmissionController,
                                                    SheddingError)
from multiverso_tpu_torch.serving.replica import (BoundUnsatisfiableError,
                                                  ReadReplica)
from multiverso_tpu_torch.utils import config, log

config.define_int(
    "serving_pool_replicas", 2,
    "active ReadReplicas per ReplicaPool (least-staleness routed); "
    "the pool survives N-1 member losses without refusing reads as "
    "long as one member stays within the staleness bound")
config.define_int(
    "serving_pool_spares", 0,
    "warm spare replicas per pool: constructed cold (no refresh "
    "thread, no snapshot) and activated — one priming pull, then "
    "serving — when an active member is demoted")
config.define_int(
    "serving_pool_demote_after", 3,
    "consecutive failed pulls (background refresh or serve-path "
    "failures) before a pool member is demoted — routed around and "
    "probed by the health loop rather than retried into")
config.define_float(
    "serving_pool_probe_s", 1.0,
    "pool health-loop cadence seconds: probes demoted members with a "
    "refresh and re-promotes them after a successful in-bound pull")

# pool registry for the serving stats block (weak, like _REPLICAS)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def _pools_snapshot() -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    for pool in list(_POOLS):
        try:
            out[pool.name] = pool.stats_entry()
        except Exception:   # noqa: BLE001 — telemetry never raises
            pass
    return out


_replica_mod.register_pool_provider(_pools_snapshot)


class _Member:
    """One pool slot: the replica + its routing/health bookkeeping."""

    __slots__ = ("idx", "replica", "active", "degraded", "routed",
                 "serve_failures", "demotions")

    def __init__(self, idx: int, replica: ReadReplica, active: bool):
        self.idx = idx
        self.replica = replica
        self.active = active       # False = cold spare
        self.degraded = False
        self.routed = 0            # reads routed here (share basis)
        self.serve_failures = 0    # consecutive serve-path failures
        self.demotions = 0


class ReplicaPool:
    """N bounded-staleness read replicas of one async table behind a
    single :meth:`get_rows` surface. Construct like a ReadReplica —
    from the table object or standalone from a ctx + spec::

        pool = ReplicaPool(table, replicas=3, spares=1)
        rows = pool.get_rows([1, 2, 3])

    ``start=True`` runs each active member's refresh thread and the
    pool health loop; :meth:`close` stops everything.
    """

    def __init__(self, table=None, *, ctx=None,
                 name: Optional[str] = None,
                 num_row: Optional[int] = None,
                 num_col: Optional[int] = None, dtype=np.float32,
                 replicas: Optional[int] = None,
                 spares: Optional[int] = None,
                 refresh_s: Optional[float] = None,
                 staleness_s: Optional[float] = None,
                 cache_rows: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 demote_after: Optional[int] = None,
                 probe_s: Optional[float] = None,
                 start: bool = True):
        n_active = (config.get_flag("serving_pool_replicas")
                    if replicas is None else int(replicas))
        n_spare = (config.get_flag("serving_pool_spares")
                   if spares is None else int(spares))
        if n_active < 1:
            raise ValueError("a pool needs at least one active replica")
        self.demote_after = max(
            config.get_flag("serving_pool_demote_after")
            if demote_after is None else int(demote_after), 1)
        self.probe_s = (config.get_flag("serving_pool_probe_s")
                        if probe_s is None else float(probe_s))
        # admission is enforced ONCE at the pool surface (member
        # replicas are constructed without it): per-member admission
        # would multiply the budget by however many members a failover
        # sweep tries
        self.admission = admission

        def make(active: bool, i: int) -> _Member:
            rep = ReadReplica(
                table, ctx=ctx, name=name, num_row=num_row,
                num_col=num_col, dtype=dtype, refresh_s=refresh_s,
                staleness_s=staleness_s, cache_rows=cache_rows,
                admission=None, start=False)
            return _Member(i, rep, active)

        self._members: List[_Member] = (
            [make(True, i) for i in range(n_active)]
            + [make(False, n_active + i) for i in range(n_spare)])
        first = self._members[0].replica
        self.name = first.name
        self.num_row, self.num_col = first.num_row, first.num_col
        self.staleness_s = first.staleness_s
        self._lock = threading.Lock()
        self._rr = 0                      # round-robin tie-breaker
        self._shed = 0
        self._failovers = 0               # serve-path sibling failovers
        # recovery log: (wall_ts, phase, member idx), phase in
        # demote|promote|spare_activated
        self.events: List = []
        self._closed = False
        self._health_thread: Optional[threading.Thread] = None
        _POOLS.add(self)
        if start:
            self.start()

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "ReplicaPool":
        for m in self._members:
            if m.active:
                m.replica.start()
        if self._health_thread is None:
            self._stop = threading.Event()
            self._health_thread = threading.Thread(
                target=self._health_loop, daemon=True,
                name=f"mv-pool-{self.name}")
            self._health_thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        if self._health_thread is not None:
            self._stop.set()
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        for m in self._members:
            m.replica.close()

    def bind_failover(self, supervisor) -> None:
        """Watching a failover supervisor's shard rejoins is not ported:
        the supervisor is not (ROADMAP.md §A)."""
        from multiverso_tpu_torch.ps.service import REPLAY_ITEM
        raise NotImplementedError(
            "ReplicaPool.bind_failover: the failover supervisor is not "
            f"ported to multiverso_tpu_torch yet (ROADMAP.md §A "
            f"{REPLAY_ITEM})")

    # ------------------------------------------------------------------ #
    # health machinery
    # ------------------------------------------------------------------ #
    def _health_loop(self) -> None:
        while not self._stop.wait(self.probe_s):
            if self._closed:
                return
            try:
                self.check_health()
            except Exception as e:   # noqa: BLE001 — the loop survives
                log.debug("pool[%s] health check failed: %s: %s",
                          self.name, type(e).__name__, e)

    def check_health(self) -> None:
        """One health pass (the loop's body; tests drive it directly):
        demote actives whose background pulls keep failing, and probe
        demoted members for re-promotion."""
        for m in list(self._members):
            if m.active and not m.degraded:
                if (m.replica.pull_health()["consecutive"]
                        >= self.demote_after):
                    self._demote(m, "background pulls failing")
            elif m.degraded:
                # probe, never on the serve path: one refresh attempt;
                # an in-bound snapshot re-promotes
                try:
                    m.replica.refresh(need_from=time.monotonic()
                                      - self.staleness_s)
                except Exception:   # noqa: BLE001 — still sick
                    continue
                if m.replica.age_s() <= self.staleness_s:
                    self._promote(m)

    def _demote(self, m: _Member, why: str) -> None:
        with self._lock:
            if m.degraded:
                return
            m.degraded = True
            m.demotions += 1
            self.events.append((time.time(), "demote", m.idx))
        log.info("pool[%s]: replica %d demoted (%s)", self.name,
                 m.idx, why)
        self._activate_spare()

    def _promote(self, m: _Member) -> None:
        with self._lock:
            if not m.degraded:
                return
            m.degraded = False
            m.serve_failures = 0
            self.events.append((time.time(), "promote", m.idx))
        log.info("pool[%s]: replica %d re-promoted", self.name, m.idx)

    def _activate_spare(self) -> None:
        with self._lock:
            spare = next((m for m in self._members if not m.active),
                         None)
            if spare is None:
                return
            spare.active = True
            self.events.append((time.time(), "spare_activated",
                                spare.idx))
        log.info("pool[%s]: spare replica %d activated", self.name,
                 spare.idx)
        spare.replica.start()
        try:
            spare.replica.refresh()   # priming pull: serve immediately
        except Exception as e:   # noqa: BLE001 — the health loop
            # keeps probing; the member serves as soon as a pull lands
            log.debug("pool[%s]: spare %d priming pull failed: %s",
                      self.name, spare.idx, e)

    # ------------------------------------------------------------------ #
    # the read path
    # ------------------------------------------------------------------ #
    def _candidates(self) -> List[_Member]:
        """Serve order: healthy actives by least staleness (ties by
        route count — cheap round-robin), then degraded actives as the
        last resort (a degraded member within bound still beats
        refusing the read), spares never (no snapshot until
        activated)."""
        with self._lock:
            active = [m for m in self._members if m.active]
            healthy = [m for m in active if not m.degraded]
            sick = [m for m in active if m.degraded]
        healthy.sort(key=lambda m: (m.replica.age_s(), m.routed))
        return healthy + sick

    def get_rows(self, row_ids, cls: str = "infer",
                 out: Optional[np.ndarray] = None,
                 with_age: bool = False,
                 tenant: Optional[str] = None):
        """Serve rows from the least-stale healthy member, failing
        over across the pool. Admission (``cls="infer"`` budgets) is
        enforced once, up front — a shed is a policy decision, never a
        health signal, and must not trigger failover. Raises the last
        member's error only when EVERY member refused: the whole pool is
        over bound (or unreachable). ``tenant``: only the default (None
        or ``""``) is ported."""
        if tenant:
            raise NotImplementedError(
                f"pool read for tenant {tenant!r}: tenant attribution is "
                "not ported to multiverso_tpu_torch yet (ROADMAP.md §A "
                "Telemetry and tools)")
        if self.admission is not None and not self.admission.admit(
                self.name, cls):
            with self._lock:
                self._shed += 1
            raise SheddingError(
                f"pool[{self.name}]: {cls} read shed by admission "
                "control")
        candidates = self._candidates()
        last: Optional[BaseException] = None
        for i, m in enumerate(candidates):
            try:
                res = m.replica.get_rows(row_ids, cls="train", out=out,
                                         with_age=with_age)
            except (ValueError, IndexError, TypeError):
                # caller input errors (empty/out-of-range row_ids) are
                # not replica health events: propagate untouched — a
                # buggy caller must not demote healthy members and
                # burn the warm spare
                raise
            except Exception as e:   # noqa: BLE001 — every member
                # HEALTH failure (bound unsatisfiable, peer errors,
                # closed replica) is a failover trigger; the LAST one
                # re-raises
                # health failure: count it, demote at the threshold,
                # try the next sibling. (cls="train" above bypasses
                # the members' own admission — the pool already
                # admitted this read.)
                last = e
                m.serve_failures += 1
                if i + 1 < len(candidates) or self._spare_left():
                    with self._lock:
                        self._failovers += 1
                if m.serve_failures >= self.demote_after or isinstance(
                        e, BoundUnsatisfiableError):
                    self._demote(m, f"serve failed: {type(e).__name__}")
                continue
            m.serve_failures = 0
            with self._lock:
                m.routed += 1
            return res
        # every active member refused; a just-activated spare may
        # still save the read (activation primes synchronously)
        spare = next((m for m in self._members
                      if m.active and m not in candidates), None)
        if spare is not None:
            try:
                res = spare.replica.get_rows(row_ids, cls="train",
                                             out=out, with_age=with_age)
                with self._lock:
                    spare.routed += 1
                return res
            except Exception as e:   # noqa: BLE001
                last = e
        raise last if last is not None else RuntimeError(
            f"pool[{self.name}]: no active replicas")

    def _spare_left(self) -> bool:
        return any(not m.active for m in self._members)

    # chaos surface (the replica-kill lever): close one member as if its
    # process died — reads fail over, health demotes, a spare activates
    def kill_replica(self, idx: int) -> None:
        m = self._members[idx]
        m.replica.close()
        self._demote(m, "killed")

    # ------------------------------------------------------------------ #
    def spares_left(self) -> int:
        """Warm spares this pool could still promote."""
        with self._lock:
            return sum(1 for m in self._members if not m.active)

    def stats_entry(self) -> Dict[str, Any]:
        """The merged serving-block entry for this table: summed member
        counters under the replica entry's keys + the ``"pool"`` detail
        block."""
        members = []
        served = shed = deferred = hits = misses = 0
        unchanged = 0
        total_routed = 0
        with self._lock:
            snap = [(m.idx, m.active, m.degraded, m.routed,
                     m.demotions, m.replica) for m in self._members]
            failovers = self._failovers
            pool_shed = self._shed
        for _idx, _active, _deg, routed, _dem, _rep in snap:
            total_routed += routed
        best_age = None
        epoch = 0
        for idx, active, degraded, routed, demotions, rep in snap:
            s = rep.stats()
            epoch = max(epoch, s["epoch"])
            served += s["served"]
            shed += s["shed"]
            deferred += s["deferred"]
            hits += s["cache_hits"]
            misses += s["cache_misses"]
            unchanged += s["unchanged_pulls"]
            age = s["age_s"]
            if active and age is not None and (best_age is None
                                               or age < best_age):
                best_age = age
            members.append({
                "idx": idx, "active": active, "degraded": degraded,
                "routed": routed,
                "share": (round(routed / total_routed, 4)
                          if total_routed else None),
                "age_s": age,
                "demotions": demotions,
                "pull_failures": s["pull_failures"],
                "pull_failures_consecutive":
                    s["pull_failures_consecutive"],
            })
        total = hits + misses
        ent: Dict[str, Any] = {
            "table": self.name,
            "epoch": epoch,
            "age_s": best_age,
            "bound_s": round(self.staleness_s, 3),
            "served": served, "shed": shed + pool_shed,
            "deferred": deferred,
            "unchanged_pulls": unchanged,
            "cache_hits": hits, "cache_misses": misses,
            "cache_hit_rate": (round(hits / total, 4) if total
                               else None),
            "pool": {
                "members": members,
                "active": sum(1 for m in members if m["active"]),
                "degraded": sum(1 for m in members if m["degraded"]),
                "spares_left": sum(1 for m in members
                                   if not m["active"]),
                "failovers": failovers,
                "demotions": sum(m["demotions"] for m in members),
            },
        }
        if self.admission is not None:
            ent["admission"] = self.admission.stats()
        return ent

    def recovery_spans(self) -> List[Dict]:
        """demote→promote/spare durations per episode, for pool
        members."""
        out: List[Dict] = []
        open_at: Dict[int, float] = {}
        for ts, phase, idx in list(self.events):
            if phase == "demote":
                open_at.setdefault(idx, ts)
            elif phase in ("promote", "spare_activated"):
                t0 = open_at.pop(idx, None)
                if phase == "spare_activated" and open_at:
                    # a spare recovers the OLDEST open demotion
                    k = min(open_at, key=open_at.get)
                    t0 = open_at.pop(k)
                if t0 is not None:
                    out.append({"member": idx, "phase": phase,
                                "recovered_in_s": round(ts - t0, 3)})
        return out
