"""Port parity, the chaos matrix (``examples/chaos.py``, the port's copy of
``tools/bench_chaos.py``): the shared recovery math against the tool's on
the same numpy series, the in-process ``partition_heal``, ``dup_reorder``,
``slow_shard_shed``, ``replica_kill`` and ``noisy_neighbor`` smokes at the
tool's shape (32 x 8, a 1 ms send window, replay on, two ranks on the
CPU) with ``tests/test_chaos.py``'s weather rule — the SLO sentinel's
gates (``slo_*``) and the autoscaler's (``autoscale_grow``) among the
strict ones — and ``ReplicaPool.bind_failover``'s rejoin re-sync driven
by a real FailoverSupervisor.

The weather rule (``tests/test_chaos.py:775-793``): the correctness gates
(exactly-once, staleness, injection, spare) are strict on every run; the
recovery-to-90% gate compares rates measured seconds apart on a shared
host, so that one gate gets a second attempt before it fails.

The OS-process ``combined`` scenario runs on the CPU only as a ``slow``
test: it starts three processes (two ranks and the respawn) and takes
~25 s; ``chip_smoke.py``'s ``chaos`` phase runs it on the card.
"""

import os
import sys
import time

import numpy as np
import pytest

from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.examples import chaos
from multiverso_tpu_torch.ps import failover
from multiverso_tpu_torch.ps import faults
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
from multiverso_tpu_torch.serving.pool import ReplicaPool
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(autouse=True)
def _clean():
    # the fault plane hooks the Python wire (ps_native off, as the JAX
    # package's chaos bench runs)
    config.set_flag("ps_native", False)
    yield
    faults.disarm()
    failover.stop_global(final=False)
    config.reset_flags()
    TDashboard.reset()


@pytest.fixture
def tool():
    sys.path.insert(0, TOOLS)
    try:
        import bench_chaos
        yield bench_chaos
    finally:
        sys.path.remove(TOOLS)


@pytest.mark.parametrize("seed", range(6))
def test_recovery_math_equals_the_tools(tool, seed):
    rng = np.random.default_rng(seed)
    t0 = 1000.0
    n = int(rng.integers(20, 120))
    stamps = t0 + np.sort(rng.uniform(0, n * 0.25, int(rng.integers(0,
                                                                     900))))
    if seed == 0:
        stamps = stamps[:0]   # no completions at all
    t_end = t0 + n * 0.25
    fault = t0 + float(rng.uniform(0.5, n * 0.25))
    heal = fault + float(rng.uniform(0, 3))
    np.testing.assert_array_equal(chaos.rate_buckets(stamps, t0, t_end),
                                  tool.rate_buckets(stamps, t0, t_end))
    for rf in (None, heal):
        assert chaos.recovery_from_stamps(stamps, t0, t_end, fault, rf) == \
            tool.recovery_from_stamps(stamps, t0, t_end, fault, rf)
    rates = rng.uniform(0, 50, n)
    rates[int(n * 0.4):int(n * 0.6)] = 0.0   # an outage
    assert chaos._recovery_core(rates, t0, 0.25, fault, heal) == \
        tool._recovery_core(rates, t0, 0.25, fault, heal)


def _weather(fn, tmp_path, seconds):
    """Strict gates on every run; the recovery gate gets one more run."""
    last = None
    for attempt in range(2):
        r = fn(seconds=seconds,
               tmp=os.path.join(str(tmp_path), str(attempt)),
               device="cpu")
        strict = {g: ok for g, ok in r["gates"].items() if g != "recovery"}
        assert all(strict.values()), r["gates"]
        last = r
        if r["gates"].get("recovery", True):
            break
    assert last["gates"].get("recovery", True), last["gates"]
    return last


def test_partition_heal_smoke(tmp_path):
    r = _weather(chaos.scenario_partition_heal, tmp_path, seconds=9.0)
    assert r["ops_lost"] == 0 and r["ops_double_applied"] == 0
    assert r["parity_bit_for_bit"]
    assert isinstance(r["recovery_s"], float)
    assert r["injected"]["partition"] > 0 and r["replay"]["frames"] > 0


def test_dup_reorder_smoke(tmp_path):
    r = chaos.scenario_dup_reorder(seconds=5.0, tmp=str(tmp_path),
                                   device="cpu")
    assert all(r["gates"].values()), r["gates"]
    assert r["dup_frames_deduped"] > 0 and r["acked_ops"] > 0


def test_replica_kill_smoke(tmp_path):
    r = _weather(chaos.scenario_replica_kill, tmp_path, seconds=8.0)
    assert r["serving"]["over_bound_serves"] == 0
    assert r["serving"]["served"] > 0
    assert [e["phase"] for e in r["pool_events"]][:2] == [
        "demote", "spare_activated"]


def test_partition_heal_slo_episode(tmp_path):
    """The sentinel's availability objective fires inside the cut and
    clears after the heal, on the flight recorder and in alerts.jsonl,
    and the sentinel is disarmed, with the caller's health timeout put
    back, when the scenario returns."""
    from multiverso_tpu_torch.telemetry import slo
    health = config.get_flag("ps_health_timeout")
    r = _weather(chaos.scenario_partition_heal, tmp_path, seconds=8.0)
    assert config.get_flag("ps_health_timeout") == health != 1.0
    assert r["gates"]["slo_fired_during_cut"]
    assert r["gates"]["slo_cleared_after_heal"]
    kinds = [e["kind"] for e in r["slo"]["episodes_log"]]
    assert kinds[:2] == ["slo.fired", "slo.cleared"]
    assert not slo.enabled()


def test_slow_shard_shed_autoscale_and_slo_smoke(tmp_path):
    """Mid-slow, the signal bus says GROW (shedding with a warm spare);
    the sentinel judged every poll and ends clear."""
    r = _weather(chaos.scenario_slow_shard_shed, tmp_path, seconds=9.0)
    assert r["gates"]["autoscale_grow"], r["autoscale"]
    assert r["gates"]["slo_judged_and_clear"], r["slo"]
    assert r["autoscale"]["action"] == "grow"


def test_noisy_neighbor_smoke(tmp_path):
    """The tool's gates, strict on every run; the victim's p99 compares
    latencies seconds apart on a shared host, so that one gate gets a
    second run (the JAX package's tier-1 smoke does the same)."""
    last = None
    for attempt in range(2):
        r = chaos.scenario_noisy_neighbor(
            seconds=8.0, tmp=os.path.join(str(tmp_path), str(attempt)),
            device="cpu")
        strict = {g: ok for g, ok in r["gates"].items()
                  if g != "victim_p99"}
        assert all(strict.values()), r["gates"]
        last = r
        if r["gates"]["victim_p99"]:
            break
    assert last["gates"]["victim_p99"], last["gates"]
    assert last["episodes"] == 1 and last["flight_verdicts"] == 1
    assert last["tenants_block"]["verdict"]["tenant"] == "storm"
    assert last["tenants_block"]["active"] is False
    assert set(chaos.SCENARIOS) == {"partition_heal", "dup_reorder",
                                    "slow_shard_shed", "replica_kill",
                                    "noisy_neighbor"}


def test_bind_failover_rejoin_kicks_resync(tmp_path):
    """A FailoverSupervisor's rejoin (a fresh beacon clearing the victim's
    tombstone) makes the bound pool pull at once, though its snapshot is
    comfortably inside the bound."""
    config.set_flag("ps_timeout", 10.0)
    config.set_flag("ps_connect_timeout", 3.0)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    t0, _ = [AsyncMatrixTable(16, 4, name="ch", ctx=c) for c in ctxs]
    pool = ReplicaPool(t0, replicas=2, refresh_s=0.1, staleness_s=2.0,
                       probe_s=999.0, start=True)
    hb = str(tmp_path / "hb")
    try:
        t0.add_rows([7], np.ones((1, 4), np.float32))
        time.sleep(0.3)
        for m in pool._members:   # only the kick may advance the epoch
            m.replica._stop.set()
            m.replica._thread.join(timeout=5)
        elastic.Heartbeat(hb, rank=1, addr="h:1").beat()
        spawned = []
        sup = failover.FailoverSupervisor(
            hb, 2, spawn=lambda r, g: spawned.append((r, g)),
            confirm=False, timeout=1e9, poll_s=60, ranks=[1])
        sup.check_once()
        pool.bind_failover(sup)
        # each replica counts only its own pulls, and the stopped
        # threads may leave one member a pull behind the other: every
        # member is held to its OWN epoch before the rejoin
        e0 = {m.idx: m.replica._epoch for m in pool._members}
        elastic.mark_failed(hb, 1)
        sup.check_once()                       # detect + respawn
        pool.check_health()
        assert {m.idx: m.replica._epoch
                for m in pool._members} == e0  # no rejoin yet
        elastic.Heartbeat(hb, rank=1, addr="h:2").beat()
        sup.check_once()                       # the rejoin
        pool.check_health()
        assert spawned == [(1, 1)]
        assert all(m.replica._epoch > e0[m.idx] for m in pool._members
                   if m.active), (e0, [m.replica._epoch
                                       for m in pool._members])
    finally:
        pool.close()
        for c in ctxs:
            c.close()


@pytest.mark.slow
def test_combined_os_processes_on_the_cpu():
    """The OS-process scenario at the tool's shape, workers on the CPU:
    SIGKILL of rank 1 and a replica kill, the supervisor's respawn at
    generation 1 restoring its newest committed tag, every gate."""
    last = None
    for _ in range(2):
        r = chaos.scenario_combined(seconds=16.0, device="cpu")
        strict = {g: ok for g, ok in r["gates"].items() if g != "recovery"}
        assert all(strict.values()), r["gates"]
        assert r["respawned"]["gen"] == 1
        assert r["respawned"]["rejoin"]["restored"] == 1
        assert r["respawns"] == 1
        last = r
        if r["gates"]["recovery"]:
            break
    assert last["gates"]["recovery"], last["gates"]
