"""``serving/pool.py``: the port's ReplicaPool (after the pool cases of
``tests/test_chaos.py``): least-staleness routing with parity against the
shards, a killed replica demoted and routed around with a warm spare
activated, failover past a member whose bound cannot be met, demotion on
failing background pulls and re-promotion, admission enforced once at the
pool's surface, the merged serving block, named tenants' reads against
the JAX pool's, and ``bind_failover``'s rejoin re-sync.
Two ranks in one process, on the CPU."""

import gc
import time

import numpy as np
import pytest

from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.serving.admission import (AdmissionController,
                                                    SheddingError)
from multiverso_tpu_torch.serving.pool import ReplicaPool
from multiverso_tpu_torch.serving.replica import BoundUnsatisfiableError
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard


@pytest.fixture
def world(tmp_path):
    tconfig.set_flag("ps_timeout", 10.0)
    tconfig.set_flag("ps_connect_timeout", 3.0)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    t0, _ = [ttables.AsyncMatrixTable(16, 4, name="pl", ctx=c)
             for c in ctxs]
    pools = []

    def make(**kw):
        args = dict(replicas=2, refresh_s=0.1, staleness_s=2.0,
                    probe_s=0.1, start=True)
        args.update(kw)
        pools.append(ReplicaPool(t0, **args))
        return pools[-1]

    yield t0, make
    for p in pools:
        p.close()
    for c in ctxs:
        c.close()
    tconfig.reset_flags()
    TDashboard.reset()


def _written(t0, rows, val=1.0):
    t0.add_rows(rows, np.full((len(rows), 4), val, np.float32))
    t0.flush()
    time.sleep(0.3)


def test_least_staleness_routing_and_parity(world):
    t0, make = world
    pool = make()
    t0.add_rows(np.arange(16), np.arange(64, dtype=np.float32).reshape(16,
                                                                        4))
    t0.flush()
    time.sleep(0.3)
    rows, age = pool.get_rows(np.arange(16), with_age=True)
    np.testing.assert_array_equal(rows, t0.get_rows(np.arange(16)))
    assert age <= pool.staleness_s
    ent = pool.stats_entry()
    assert ent["pool"]["active"] == 2
    assert sum(m["routed"] for m in ent["pool"]["members"]) == 1
    # the freshest member serves: its age is the pool's minimum
    best = min(pool._members, key=lambda m: m.replica.age_s())
    pool.get_rows([0])
    assert best.routed >= 1


def test_kill_replica_demotes_and_routes_around(world):
    t0, make = world
    pool = make(spares=1)
    _written(t0, [3])
    pool.kill_replica(0)
    for _ in range(5):
        assert float(pool.get_rows([3])[0, 0]) == 1.0
    phases = [p for _, p, _ in pool.events]
    assert "demote" in phases and "spare_activated" in phases
    ent = pool.stats_entry()["pool"]
    assert ent["degraded"] == 1 and ent["spares_left"] == 0
    routed_before = ent["members"][0]["routed"]
    pool.get_rows([3])
    assert pool.stats_entry()["pool"]["members"][0]["routed"] == \
        routed_before
    assert pool.spares_left() == 0
    spans = pool.recovery_spans()
    assert spans and spans[0]["phase"] == "spare_activated"


def test_bound_unsatisfiable_fails_over_to_sibling(world):
    t0, make = world
    pool = make()
    _written(t0, [5])
    pool._members[0].replica.staleness_s = 1e-9
    for _ in range(3):   # whichever member is asked first, one serves
        assert float(pool.get_rows([5])[0, 0]) == 1.0
    for m in pool._members:
        m.replica.staleness_s = 1e-9
    pool.staleness_s = 1e-9
    with pytest.raises((BoundUnsatisfiableError, RuntimeError)):
        for _ in range(4):
            pool.get_rows([5])


def test_health_loop_demotes_on_pull_failures_and_repromotes(world):
    t0, make = world
    pool = make(demote_after=2, probe_s=999.0)
    _written(t0, [2])
    m0 = pool._members[0]
    m0.replica._consec_pull_failures = 5
    pool.check_health()
    assert m0.degraded
    m0.replica._consec_pull_failures = 0
    pool.check_health()
    assert not m0.degraded
    assert [p for _, p, _ in pool.events] == ["demote", "promote"]


def test_caller_errors_are_not_health_events(world):
    t0, make = world
    pool = make()
    _written(t0, [1])
    with pytest.raises(IndexError):
        pool.get_rows([16])
    assert pool.stats_entry()["pool"]["degraded"] == 0


def test_admission_enforced_once_at_pool_surface(world):
    t0, make = world
    adm = AdmissionController()
    adm.set_limit("pl", "infer", 0.001, burst=1.0)
    pool = make(admission=adm)
    _written(t0, [1])
    pool.get_rows([1])
    with pytest.raises(SheddingError):
        for _ in range(50):
            pool.get_rows([1])
    ent = pool.stats_entry()
    assert ent["pool"]["degraded"] == 0
    assert ent["shed"] == 1 and ent["admission"]["pl/infer"]["shed"] == 1
    # members never see the shed read
    assert ent["served"] == 1


def test_pool_entry_replaces_its_members_in_the_serving_block(world):
    gc.collect()   # pools of earlier tests, closed, leave the block
    t0, make = world
    pool = make()
    _written(t0, [4])
    pool.get_rows([4])
    block = t0.ctx.service.stats_payload()["serving"]
    assert block["pl"]["pool"]["active"] == 2
    assert block["pl"]["served"] == 1


def _pool_tenant_reads(svc, tables, Pool, adm_mod, ten, rdv, **ctx_kw):
    """Named tenants' pool reads in one package's two-rank world, one
    tenant over its own budget: the ledger's counters afterwards."""
    ctxs = [svc.PSContext(r, 2, svc.PSService(r, 2, svc.FileRendezvous(rdv)),
                          **ctx_kw) for r in range(2)]
    pool = None
    try:
        t0, _ = [tables.AsyncMatrixTable(16, 4, name="pl", ctx=c)
                 for c in ctxs]
        t0.add_rows([1], np.ones((1, 4), np.float32))
        t0.flush()
        adm = adm_mod.AdmissionController()
        adm.set_tenant_limit("pl", "storm", "infer", 1.0, burst=1.0)
        pool = Pool(t0, replicas=2, staleness_s=30.0, probe_s=999.0,
                    admission=adm, start=False)
        for m in pool._members:   # primed: no read pays a refresh
            m.replica.refresh()
        ten.reset()
        rows = pool.get_rows([1], tenant="victim")
        np.testing.assert_array_equal(rows, t0.get_rows([1]))
        pool.get_rows([1], tenant="storm")
        with pytest.raises(adm_mod.SheddingError):
            pool.get_rows([1], tenant="storm")
        block = ten.LEDGER.stats_snapshot()
        return ({tn: {k: e[k] for k in ("served", "shed", "deferred")}
                 for tn, e in block["tables"]["pl"].items()},
                block["admission"])
    finally:
        ten.reset()
        if pool is not None:
            pool.close()
        for c in ctxs:
            c.close()


def test_refusals_name_their_items(world, tmp_path):
    """A named tenant's pool read (once refused) serves and is metered as
    the JAX pool's is — the over-budget tenant shed at the pool, the
    member's serve in the ledger; ``bind_failover`` (once refused) binds
    a supervisor, whose rejoin kicks a pull."""
    t0, make = world
    pool = make(probe_s=999.0)   # check_health is driven by hand
    _written(t0, [7])
    # quiesce the background refreshes: only the kick may advance the
    # epoch below
    for m in pool._members:
        m.replica._stop.set()
        m.replica._thread.join(timeout=5)

    class _Sup:   # supervisor-shaped: an events list
        events = [(time.time(), "detect", 1)]

    pool.bind_failover(_Sup())
    assert pool._sup_seen == 1
    e0 = pool._members[0].replica._epoch
    pool.check_health()   # no rejoin: no kick
    assert pool._members[0].replica._epoch == e0
    _Sup.events.append((time.time(), "rejoin", 1))
    pool.check_health()   # a FRESH pull though the snapshot is in bound
    assert pool._members[0].replica._epoch > e0
    with pytest.raises(ValueError, match="active replica"):
        ReplicaPool(t0, replicas=0, start=False)
    from multiverso_tpu.ps import service as jsvc
    from multiverso_tpu.ps import tables as jtables
    from multiverso_tpu.serving import admission as jadm
    from multiverso_tpu.serving.pool import ReplicaPool as JPool
    from multiverso_tpu.telemetry import tenants as jten
    from multiverso_tpu.utils import config as jconfig
    from multiverso_tpu_torch.serving import admission as tadm
    from multiverso_tpu_torch.telemetry import tenants as tten
    jconfig.set_flag("ps_native", False)
    got = _pool_tenant_reads(tsvc, ttables, ReplicaPool, tadm, tten,
                             str(tmp_path / "trdv"), device="cpu")
    want = _pool_tenant_reads(jsvc, jtables, JPool, jadm, jten,
                              str(tmp_path / "jrdv"))
    assert got == want
    assert got[0] == {"victim": {"served": 1, "shed": 0, "deferred": 0},
                      "storm": {"served": 1, "shed": 1, "deferred": 0}}


def _pool_script(svc, tables, pool_cls, rdv):
    """One script on a pool of one package: two ranks, a table written
    with the same rows, reads, a kill, a demotion on failing pulls and a
    health pass that re-promotes. Returns the rows served, the events,
    the recovery spans and the stats entry."""
    ctxs = [svc.PSContext(r, 2, svc.PSService(r, 2, svc.FileRendezvous(rdv)),
                          **({"device": "cpu"} if svc is tsvc else {}))
            for r in range(2)]
    pool = None
    try:
        t0, _ = [tables.AsyncMatrixTable(16, 4, name="plx", ctx=c)
                 for c in ctxs]
        t0.add_rows(np.arange(16),
                    np.arange(64, dtype=np.float32).reshape(16, 4))
        t0.flush()
        pool = pool_cls(t0, replicas=2, spares=1, refresh_s=0.1,
                        staleness_s=30.0, probe_s=999.0, demote_after=2,
                        start=False)
        served = [pool.get_rows(np.arange(16)) for _ in range(3)]
        pool.kill_replica(0)
        served += [pool.get_rows(np.arange(16)) for _ in range(3)]
        m1 = pool._members[1]
        m1.replica._consec_pull_failures = 5
        pool.check_health()
        served += [pool.get_rows([2, 9]) for _ in range(2)]
        m1.replica._consec_pull_failures = 0
        pool.check_health()
        served += [pool.get_rows([2, 9]) for _ in range(2)]
        events = [(phase, idx) for _, phase, idx in pool.events]
        spans = [(s["member"], s["phase"]) for s in pool.recovery_spans()]
        return served, events, spans, pool.stats_entry()
    finally:
        if pool is not None:
            pool.close()
        for c in ctxs:
            c.close()


def _counts(ent):
    """The stats entry without its clock readings (ages)."""
    if isinstance(ent, dict):
        return {k: _counts(v) for k, v in ent.items() if k != "age_s"}
    if isinstance(ent, list):
        return [_counts(v) for v in ent]
    return ent


def test_pool_script_matches_jax(tmp_path):
    """The JAX package's ReplicaPool and the port's through the same
    kill/demote/spare/re-promote script: the same rows, the same event
    phases in the same order, the same recovery spans, and a stats entry
    (the wire-visible ``serving`` block's) with the same keys and
    counts."""
    from multiverso_tpu.ps import service as jsvc
    from multiverso_tpu.ps import tables as jtables
    from multiverso_tpu.serving.pool import ReplicaPool as JReplicaPool
    from multiverso_tpu.utils import config as jconfig
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    try:
        j = _pool_script(jsvc, jtables, JReplicaPool, str(tmp_path / "j"))
        t = _pool_script(tsvc, ttables, ReplicaPool, str(tmp_path / "t"))
    finally:
        jconfig.reset_flags()
        tconfig.reset_flags()
        TDashboard.reset()
    for jr, tr in zip(j[0], t[0]):
        np.testing.assert_array_equal(np.asarray(tr), np.asarray(jr))
    assert len(j[0]) == len(t[0]) == 10
    assert t[1] == j[1]
    assert t[1][:2] == [("demote", 0), ("spare_activated", 2)]
    assert ("demote", 1) in t[1] and ("promote", 1) in t[1]
    assert t[2] == j[2]
    assert _counts(t[3]) == _counts(j[3])
    assert t[3]["pool"]["members"][2]["active"]
