"""Port parity, ``ps/faults.py``: the fault-injection wire plane of
multiverso_tpu_torch against the JAX package's (after
``tests/test_chaos.py``'s determinism, null-path and live-injection
cases).

* decisions: for the same spec, seed and per-(src, dst) message sequence
  the port's ``FaultPlane`` plans every send and serve exactly as the JAX
  one does (drop, delay to the float, duplicate, reorder depth and hold,
  reset, the kinds noted, the injected log and counts), including the
  recorded golden sequence of ``tests/test_chaos.py:76``;
* a bad spec fails at arm time; the disarmed plane is the null object and
  a live wire with it disarmed records nothing;
* live injection on two port ranks on the CPU, Python wire, replay on:
  duplicates and reorders apply exactly once, a partition heals with
  every add applied once, injected resets replay, slow-serve slows, a
  dropped reply's retry dedupes, and the disarmed hook costs nothing
  measurable.
"""

import json
import socket
import time

import numpy as np
import pytest

from multiverso_tpu.ps import faults as jfaults
from multiverso_tpu.ps import service as jsvc
from multiverso_tpu_torch.ps import faults
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    faults.disarm()
    jfaults.disarm()
    config.reset_flags()
    TDashboard.reset()


# ---------------------------------------------------------------------- #
# the decision streams, against the JAX plane
# ---------------------------------------------------------------------- #
SPEC = {"seed": 5, "rules": [
    {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.4},
    {"kind": "drop", "src": 0, "dst": 1, "p": 0.2,
     "msg_types": ["MSG_ADD_ROWS"]},
]}

SPECS = [
    SPEC,
    {"seed": 7, "rules": [
        {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.35,
         "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]},
        {"kind": "reorder", "src": 0, "dst": 1, "p": 0.25, "depth": 2,
         "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]}]},
    {"seed": 3, "rules": [
        {"kind": "delay", "src": "*", "dst": "*", "p": 0.5,
         "delay_ms": 4.0, "jitter_ms": 3.0},
        {"kind": "reset", "src": 1, "dst": 0, "p": 0.1, "max_count": 3},
        {"kind": "reorder", "dst": 2, "p": 0.3, "delay_ms": 40.0,
         "depth": 3},
        {"kind": "partition", "src": 2, "dst": 1, "phase": "cut"}]},
    {"seed": 13, "rules": [
        {"kind": "slow_serve", "rank": 1, "delay_ms": 350,
         "jitter_ms": 100, "p": 0.6},
        {"kind": "drop_reply", "rank": 0, "p": 0.3,
         "msg_types": [0x11, "MSG_BATCH"]},
        {"kind": "drop", "p": 0.05}]},
]

_TYPES = [tsvc.MSG_ADD_ROWS, tsvc.MSG_GET_ROWS, tsvc.MSG_BATCH,
          tsvc.MSG_SNAPSHOT, tsvc.MSG_PING]


def _plan_fields(p):
    if p is None:
        return None
    return (p.drop, p.delay_s, p.duplicate, p.reorder, p.hold_s, p.depth,
            p.reset, tuple(p.kinds))


@pytest.mark.parametrize("spec_i", range(len(SPECS)))
def test_plans_equal_the_jax_planes(spec_i):
    spec = SPECS[spec_i]
    tp = faults.FaultPlane(spec, rank=0)
    jp = jfaults.FaultPlane(spec, rank=0)
    rng = np.random.default_rng(spec_i)
    for i in range(400):
        if i == 150:
            tp.phase = jp.phase = "cut"   # direct: set_phase is the same
        if i == 300:
            tp.phase = jp.phase = None
        src, dst = (int(x) for x in rng.integers(0, 3, 2))
        mt = int(rng.choice(_TYPES))
        if rng.random() < 0.7:
            assert _plan_fields(tp.plan_send(dst, mt, i, src=src)) == \
                _plan_fields(jp.plan_send(dst, mt, i, src=src)), i
        else:
            assert tp.plan_serve(mt, i, rank=dst) == \
                jp.plan_serve(mt, i, rank=dst), i
    assert tp.log_snapshot() == jp.log_snapshot()
    assert tp.stats() == jp.stats()
    assert tp.stats()["logged"] > 0


def test_golden_sequence():
    """The recorded golden of tests/test_chaos.py:76, from this plane."""
    plane = faults.FaultPlane(SPEC, rank=0)
    for _ in range(16):
        plane.plan_send(1, tsvc.MSG_ADD_ROWS)
    add = tsvc.MSG_ADD_ROWS
    assert plane.log_snapshot() == [
        (0, "duplicate", 0, 1, add), (1, "duplicate", 0, 1, add),
        (2, "drop", 0, 1, add), (4, "duplicate", 0, 1, add),
        (5, "duplicate", 0, 1, add), (6, "drop", 0, 1, add),
        (7, "duplicate", 0, 1, add), (9, "duplicate", 0, 1, add),
        (14, "duplicate", 0, 1, add), (15, "duplicate", 0, 1, add),
    ]


@pytest.mark.parametrize("seed,key", [(0, (0, 0, 0, 0)), (5, (1, 0, 1, 6)),
                                      (2 ** 31, (3, 2, 1, 10 ** 6))])
def test_draws_equal_the_jax_draws(seed, key):
    assert faults._draw(seed, *key) == jfaults._draw(seed, *key)


def test_seed_and_activation_rules():
    def drive(plane, n=64):
        for _ in range(n):
            plane.plan_send(1, tsvc.MSG_ADD_ROWS)
        return plane.log_snapshot()

    assert drive(faults.FaultPlane(SPEC, rank=0)) == \
        drive(faults.FaultPlane(SPEC, rank=0))
    assert drive(faults.FaultPlane(SPEC, rank=0)) != \
        drive(faults.FaultPlane(dict(SPEC, seed=6), rank=0))
    # a phased rule flipping active never shifts another rule's stream
    spec = {"seed": 5, "rules": [
        {"kind": "delay", "src": 0, "dst": 1, "p": 0.3, "delay_ms": 0.01,
         "phase": "on"},
        {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.4}]}
    p1, p2 = faults.FaultPlane(spec, rank=0), faults.FaultPlane(spec, rank=0)
    p2.set_phase("on")
    drive(p1), drive(p2)
    dups = [[e for e in p.log_snapshot() if e[1] == "duplicate"]
            for p in (p1, p2)]
    assert dups[0] == dups[1]
    assert any(e[1] == "delay" for e in p2.log_snapshot())
    assert not any(e[1] == "delay" for e in p1.log_snapshot())


def test_msg_type_names_resolve_as_in_jax():
    names = ["MSG_ADD_ROWS", "MSG_BATCH", "MSG_SNAPSHOT", "MSG_MULTI"]
    assert faults._msg_type_ids(names) == jfaults._msg_type_ids(names)
    assert faults._msg_type_ids(names) == frozenset(
        getattr(jsvc, n) for n in names)


@pytest.mark.parametrize("spec", [
    {"rules": [{"kind": "nope"}]},
    {"rules": [{"kind": "drop", "msg_types": ["MSG_NOT_A_THING"]}]},
    {"rules": []}, {}])
def test_bad_spec_fails_at_arm(spec):
    with pytest.raises(ValueError):
        faults.arm(spec)
    assert faults.PLANE is faults.NULL


# ---------------------------------------------------------------------- #
# the null path
# ---------------------------------------------------------------------- #
def test_disarmed_plane_is_the_null_object():
    assert faults.PLANE is faults.NULL and not faults.enabled()
    assert not hasattr(faults.NULL, "plan_send")
    assert not hasattr(faults.NULL, "plan_serve")
    faults.configure(3)
    assert faults.PLANE is faults.NULL
    assert faults.NULL.stats() == {}


def test_arm_from_flag_spec_and_bad_flag_spec():
    config.set_flag("faults_spec", json.dumps(
        {"seed": 2, "rules": [{"kind": "drop", "p": 0.0}]}))
    faults.configure(4)
    assert faults.enabled() and faults.PLANE.seed == 2
    assert faults.PLANE.rank == 4
    faults.disarm()
    config.set_flag("faults_spec", "{not json")
    faults.configure(0)   # loud, not fatal
    assert faults.PLANE is faults.NULL


def test_faults_seed_flag_is_the_default_seed():
    config.set_flag("faults_seed", 77)
    assert faults.FaultPlane({"rules": [{"kind": "drop"}]}).seed == 77
    assert faults.FaultPlane({"seed": 1,
                              "rules": [{"kind": "drop"}]}).seed == 1


# ---------------------------------------------------------------------- #
# live injection on two port ranks
# ---------------------------------------------------------------------- #
def _world(tmp_path, replay=True, **flags):
    base = dict(ps_timeout=30.0, ps_connect_timeout=5.0,
                ps_reconnect_backoff=0.2, ps_replay=replay,
                ps_replay_backoff=0.1, ps_replay_backoff_cap=0.5)
    base.update(flags)
    for k, v in base.items():
        config.set_flag(k, v)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    t0, _ = [AsyncMatrixTable(16, 4, name="ch", send_window_ms=1.0, ctx=c)
             for c in ctxs]
    return ctxs, t0


def _close(ctxs):
    for c in ctxs:
        c.close()


def test_flag_off_live_wire_records_nothing(tmp_path):
    ctxs, t0 = _world(tmp_path, replay=False)
    try:
        ones = np.ones((1, 4), np.float32)
        for _ in range(20):
            t0.add_rows([9], ones)
        assert float(t0.get_rows([9])[0, 0]) == 20.0
        assert faults.PLANE.stats() == {}
        with ctxs[0].service._peers_lock:
            assert all(not p._held
                       for p in ctxs[0].service._peers.values())
    finally:
        _close(ctxs)


def test_dup_reorder_exactly_once(tmp_path):
    ctxs, t0 = _world(tmp_path)
    try:
        plane = faults.arm({"seed": 3, "rules": [
            {"kind": "duplicate", "src": 0, "dst": 1, "p": 0.5,
             "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]},
            {"kind": "reorder", "src": 0, "dst": 1, "p": 0.3,
             "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]},
        ]}, rank=0)
        ones = np.ones((1, 4), np.float32)
        for i in range(80):
            t0.add_rows([8 + (i % 4)], ones)   # rank 1's rows
        t0.flush()
        final = t0.get_rows(np.arange(16))
        np.testing.assert_array_equal(
            final, np.repeat([[0.0]] * 8 + [[20.0]] * 4 + [[0.0]] * 4, 4,
                             axis=1).astype(np.float32))
        assert t0.server_stats(1)["shards"]["ch"]["dup_frames"] > 0
        inj = plane.stats()["injected"]
        assert inj.get("duplicate", 0) > 0 and inj.get("reorder", 0) > 0
    finally:
        _close(ctxs)


def test_partition_heal_exactly_once(tmp_path):
    ctxs, t0 = _world(tmp_path)
    try:
        plane = faults.arm({"seed": 9, "rules": [
            {"kind": "partition", "src": 0, "dst": 1,
             "phase": "cut"}]}, rank=0)
        ones = np.ones((1, 4), np.float32)
        for _ in range(10):
            t0.add_rows([9], ones)
        plane.set_phase("cut")
        mids = [t0.add_rows_async([9], ones) for _ in range(4)]
        time.sleep(0.5)
        plane.set_phase(None)   # partitioned acks pend (replay armed)
        for m in mids:
            t0.wait(m)
        t0.flush()
        assert float(t0.get_rows([9])[0, 0]) == 14.0
        assert plane.stats()["injected"].get("partition", 0) > 0
        assert any(e[1] == "partition" for e in plane.log_snapshot())
    finally:
        _close(ctxs)


def test_reset_injection_replays(tmp_path):
    ctxs, t0 = _world(tmp_path)
    try:
        faults.arm({"seed": 1, "rules": [
            {"kind": "reset", "src": 0, "dst": 1, "max_count": 2,
             "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]}]}, rank=0)
        ones = np.ones((1, 4), np.float32)
        for _ in range(20):
            t0.add_rows([10], ones)
        t0.flush()
        assert float(t0.get_rows([10])[0, 0]) == 20.0
        assert faults.PLANE.stats()["injected"]["reset"] == 2
    finally:
        _close(ctxs)


def test_slow_serve_injection(tmp_path):
    ctxs, t0 = _world(tmp_path, replay=False)
    try:
        t0.add_rows([8], np.ones((1, 4), np.float32))
        t1 = time.perf_counter()
        t0.get_rows([8])
        fast = time.perf_counter() - t1
        faults.arm({"seed": 2, "rules": [
            {"kind": "slow_serve", "rank": 1, "delay_ms": 120,
             "msg_types": ["MSG_GET_ROWS"]}]}, rank=0)
        t2 = time.perf_counter()
        t0.get_rows([8])
        assert time.perf_counter() - t2 > fast + 0.1
        assert faults.PLANE.stats()["injected"]["slow_serve"] >= 1
    finally:
        _close(ctxs)


def test_drop_reply_applies_once_under_replay(tmp_path):
    """An ack lost after the apply: the client's replayed frame dedupes at
    the shard, so the op lands once though it was served twice."""
    ctxs, t0 = _world(tmp_path, ps_replay_backoff_cap=0.3,
                      ps_replay_timeout=20.0, ps_timeout=3.0)
    try:
        faults.arm({"seed": 4, "rules": [
            {"kind": "drop_reply", "rank": 1, "max_count": 1,
             "msg_types": ["MSG_ADD_ROWS", "MSG_BATCH"]}]}, rank=0)
        mid = t0.add_rows_async([8], np.ones((1, 4), np.float32))
        time.sleep(0.3)   # the reply-dropped serve applies
        with ctxs[0].service._peers_lock:
            peer = ctxs[0].service._peers.get(1)
        assert peer is not None
        peer._sock.shutdown(socket.SHUT_RDWR)   # the conn dies: replay
        peer._sock.close()                      # re-arms
        t0.wait(mid)
        t0.flush()
        assert float(t0.get_rows([8])[0, 0]) == 1.0   # once, not twice
        assert t0.server_stats(1)["shards"]["ch"]["dup_frames"] >= 1
    finally:
        _close(ctxs)


def test_injection_hook_cost_when_disarmed(tmp_path):
    ctxs, t0 = _world(tmp_path, replay=False)
    try:
        ones = np.ones((1, 4), np.float32)
        for _ in range(5):
            t0.add_rows([8], ones)
        t1 = time.perf_counter()
        for _ in range(50):
            t0.add_rows([8], ones)
        assert (time.perf_counter() - t1) / 50 < 0.05   # a sanity ceiling
    finally:
        _close(ctxs)
