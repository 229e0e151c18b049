"""Port parity, shard failover: exactly-once replay dedupe, per-shard
checkpoints with durable pruning, the stale-tombstone incarnation rule,
the failover supervisor, and the in-process kill → respawn → restore →
replay smoke — the port's versions of ``tests/test_failover.py:36-446``
on its Python plane, two ranks in one process on the CPU — plus mixed
worlds: a JAX client with ``ps_replay`` against a port shard that is
killed and rejoined, and a port client against a JAX shard, each ending
equal to the numpy oracle bit for bit.

``ps_timeout`` and ``ps_connect_timeout`` are seconds in both packages,
so no test can wait out the 300 s default.
"""

import json
import os
import time

import numpy as np
import pytest

from multiverso_tpu.ps import failover as jfailover
from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import shard as jshard
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch import checkpoint
from multiverso_tpu_torch import elastic
from multiverso_tpu_torch.ps import failover
from multiverso_tpu_torch.ps import service as svc
from multiverso_tpu_torch.ps import shard as tshard
from multiverso_tpu_torch.ps import wire
from multiverso_tpu_torch.ps.tables import (AsyncMatrixTable,
                                            AsyncSparseKVTable)
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard


@pytest.fixture(autouse=True)
def _flags():
    for cfg in (config, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 5.0)
    jconfig.set_flag("ps_native", False)
    yield
    failover.stop_global(final=False)
    config.reset_flags()
    TDashboard.reset()


@pytest.fixture
def two_ranks(tmp_path):
    rdv = svc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [svc.PSContext(r, 2, svc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


def _stamped_meta(table, cl, seq, extra=None):
    meta = {"table": table, "opt": {},
            wire.REPLAY_CLIENT_KEY: cl, wire.REPLAY_SEQ_KEY: seq}
    meta.update(extra or {})
    return meta


def _wait_drained(win, owner=1, timeout=10.0):
    deadline = time.monotonic() + timeout
    while win._replay.pending_send.get(owner, 0) > 0:
        assert time.monotonic() < deadline
        time.sleep(0.05)


# ---------------------------------------------------------------------- #
class TestReplayDedupe:
    def test_plain_frame_applies_once(self, two_ranks):
        t0 = AsyncMatrixTable(8, 2, name="dd", ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="dd", ctx=two_ranks[1])
        meta = _stamped_meta("dd", "c1", 0)
        arrays = [np.array([5], np.int64), np.ones((1, 2), np.float32)]
        r1, _ = two_ranks[0].service.request(
            1, svc.MSG_ADD_ROWS, meta, arrays).result(15)
        assert not r1.get(wire.REPLAY_DUP_KEY)
        assert wire.REPLAY_DURABLE_KEY in r1
        r2, _ = two_ranks[0].service.request(
            1, svc.MSG_ADD_ROWS, meta, arrays).result(15)
        assert r2.get(wire.REPLAY_DUP_KEY) is True
        assert float(t0.get_rows([5])[0, 0]) == 1.0
        st = t0.server_stats(1)["shards"]["dd"]
        assert st["dup_frames"] >= 1 and st["replay_clients"] == 1

    def test_batch_frame_applies_once(self, two_ranks):
        t0 = AsyncMatrixTable(8, 2, name="db", ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="db", ctx=two_ranks[1])
        blobs = [wire.encode(svc.MSG_ADD_ROWS, i,
                             {"table": "db", "opt": {}},
                             [np.array([4 + i], np.int64),
                              np.ones((1, 2), np.float32)])
                 for i in range(2)]
        meta = _stamped_meta("db", "c1", 7, {"n": 2})
        arrays = wire.pack_batch(blobs)
        r1, _ = two_ranks[0].service.request(
            1, svc.MSG_BATCH, meta, arrays).result(15)
        assert not r1.get(wire.REPLAY_DUP_KEY)
        r2, _ = two_ranks[0].service.request(
            1, svc.MSG_BATCH, meta, arrays).result(15)
        assert r2.get(wire.REPLAY_DUP_KEY) is True
        np.testing.assert_array_equal(t0.get_rows([4, 5]),
                                      np.ones((2, 2), np.float32))

    def test_failed_sub_ops_repeat_in_the_dup_ack(self, two_ranks):
        """A batch that applied with a failing sub-op: the duplicate's ack
        names the same failed index, so a replay never turns it into a
        success."""
        # adam never wave-merges: each sub-op applies on its own
        AsyncMatrixTable(8, 2, name="df", updater="adam",
                         ctx=two_ranks[0])
        t1 = AsyncMatrixTable(8, 2, name="df", updater="adam",
                              ctx=two_ranks[1])
        blobs = [wire.encode(svc.MSG_ADD_ROWS, i,
                             {"table": "df", "opt": {}},
                             [np.array([4 + i], np.int64),
                              np.ones((1, 2), np.float32)])
                 for i in range(2)]
        shard = t1._shard
        real = shard._apply_rows

        def flaky(local, vals, opt):
            if np.asarray(local).tolist() == [1]:   # global row 5
                raise RuntimeError("boom")
            return real(local, vals, opt)

        shard._apply_rows = flaky
        meta = _stamped_meta("df", "c5", 0, {"n": 2})
        r1, _ = shard.handle(svc.MSG_BATCH, meta, wire.pack_batch(blobs))
        r2, _ = shard.handle(svc.MSG_BATCH, meta, wire.pack_batch(blobs))
        assert r1["failed"] == [1] and r2["failed"] == [1]
        assert r2[wire.REPLAY_DUP_KEY] is True

    def test_hash_shard_dedupes_too(self, two_ranks):
        t0 = AsyncSparseKVTable(2, name="dk", ctx=two_ranks[0])
        AsyncSparseKVTable(2, name="dk", ctx=two_ranks[1])
        meta = _stamped_meta("dk", "c2", 3)
        arrays = [np.array([11], np.int64), np.ones((1, 2), np.float32)]
        two_ranks[0].service.request(1, svc.MSG_ADD_ROWS, meta,
                                     arrays).result(15)
        r2, _ = two_ranks[0].service.request(
            1, svc.MSG_ADD_ROWS, meta, arrays).result(15)
        assert r2.get(wire.REPLAY_DUP_KEY) is True
        assert float(t0.get_rows([11])[0, 0]) == 1.0

    def test_out_of_order_replay_not_lost(self, two_ranks):
        t0 = AsyncMatrixTable(8, 2, name="oo", ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="oo", ctx=two_ranks[1])
        arrays = [np.array([6], np.int64), np.ones((1, 2), np.float32)]
        req = two_ranks[0].service.request
        req(1, svc.MSG_ADD_ROWS, _stamped_meta("oo", "c3", 2),
            arrays).result(15)
        r, _ = req(1, svc.MSG_ADD_ROWS, _stamped_meta("oo", "c3", 1),
                   arrays).result(15)
        assert not r.get(wire.REPLAY_DUP_KEY)
        assert float(t0.get_rows([6])[0, 0]) == 2.0
        r, _ = req(1, svc.MSG_ADD_ROWS, _stamped_meta("oo", "c3", 1),
                   arrays).result(15)
        assert r.get(wire.REPLAY_DUP_KEY) is True

    @pytest.mark.parametrize("seed", range(4))
    def test_seq_channels_match_jax(self, seed):
        """The gap-set channel's floor, gaps and memoized failures follow
        the JAX package's under a shuffled, duplicated commit order."""
        rng = np.random.default_rng(seed)
        seqs = rng.permutation(np.repeat(np.arange(60), 2))
        tc, jc = tshard._SeqChannel(), jshard._SeqChannel()
        for s in seqs.tolist():
            assert tc.seen(s) == jc.seen(s)
            if not tc.seen(s):
                tc.commit(s)
                jc.commit(s)
                if s % 7 == 0:
                    tc.note_failed(s, {"failed": [0], "error": "e"})
                    jc.note_failed(s, {"failed": [0], "error": "e"})
            assert tc.to_dict() == jc.to_dict()
        assert tc.floor == 59 and not tc.above
        back = tshard._SeqChannel.from_dict(jc.to_dict())
        assert back.to_dict() == jc.to_dict()

    def test_windowed_reflush_to_live_shard_is_noop(self, two_ranks):
        config.set_flag("ps_replay", True)
        t0 = AsyncMatrixTable(8, 2, name="rf", send_window_ms=1.0,
                              ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="rf", send_window_ms=1.0,
                         ctx=two_ranks[1])
        for _ in range(4):
            t0.add_rows([5], np.ones((1, 2), np.float32))
        assert float(t0.get_rows([5])[0, 0]) == 4.0
        win = t0._window
        assert win._replay is not None
        win._on_owner_death(1)   # every retained frame re-arms...
        _wait_drained(win)       # ...and lands on the same incarnation
        t0.flush()
        assert float(t0.get_rows([5])[0, 0]) == 4.0
        assert t0.server_stats(1)["shards"]["rf"]["dup_frames"] >= 1
        assert win._replay.mon_replayed.count >= 1

    def test_old_acked_frame_gets_full_retry_budget(self, two_ranks):
        config.set_flag("ps_replay", True)
        config.set_flag("ps_replay_backoff", 0.05)
        t0 = AsyncMatrixTable(8, 2, name="ob", send_window_ms=1.0,
                              ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="ob", send_window_ms=1.0,
                         ctx=two_ranks[1])
        t0.add_rows([4], np.ones((1, 2), np.float32))
        win = t0._window
        q = win._replay.retained.get(1, {})
        assert q
        for fr in q.values():
            fr.created -= 10 * config.get_flag("ps_replay_timeout")
        win._on_owner_death(1)
        _wait_drained(win)
        assert win._replay.mon_dropped.count == 0
        assert float(t0.get_rows([4])[0, 0]) == 1.0
        assert t0.server_stats(1)["shards"]["ob"]["dup_frames"] >= 1

    def test_retention_cap_drops_the_oldest_acked(self, two_ranks):
        config.set_flag("ps_replay", True)
        config.set_flag("ps_replay_max_frames", 3)
        t0 = AsyncMatrixTable(8, 2, name="cap", send_window_ms=1.0,
                              ctx=two_ranks[0])
        AsyncMatrixTable(8, 2, name="cap", send_window_ms=1.0,
                         ctx=two_ranks[1])
        for _ in range(6):
            t0.add_rows([6], np.ones((1, 2), np.float32))
        rp = t0._window._replay
        assert list(rp.retained[1]) == [3, 4, 5]
        assert rp.mon_dropped.count == 3
        assert float(t0.get_rows([6])[0, 0]) == 6.0


# ---------------------------------------------------------------------- #
class TestShardCheckpoint:
    def test_roundtrip_and_durable_pruning(self, two_ranks, tmp_path):
        config.set_flag("ps_replay", True)
        t0 = AsyncMatrixTable(8, 2, name="ck", send_window_ms=1.0,
                              ctx=two_ranks[0])
        t1 = AsyncMatrixTable(8, 2, name="ck", send_window_ms=1.0,
                              ctx=two_ranks[1])
        ckdir = str(tmp_path / "ck")
        for _ in range(3):
            t0.add_rows([6], np.ones((1, 2), np.float32))
        path = checkpoint.save_shard_state(ckdir, 1, [t1])
        assert checkpoint.is_committed(path)
        assert checkpoint.latest_shard_tag(ckdir, 1) is not None
        # acks now carry the durable floor: retained frames prune
        t0.add_rows([6], np.ones((1, 2), np.float32))
        win = t0._window
        deadline = time.monotonic() + 10
        while len(win._replay.retained.get(1, {})) > 1:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert float(t0.get_rows([6])[0, 0]) == 4.0
        assert checkpoint.restore_shard_state(ckdir, 1, [t1]) == 1
        assert float(t0.get_rows([6])[0, 0]) == 3.0

    @pytest.mark.parametrize("updater", ["adagrad", "adam", "momentum_sgd",
                                         "ftrl"])
    def test_updater_state_roundtrips(self, two_ranks, tmp_path, updater):
        t0 = AsyncMatrixTable(8, 2, name="cs", updater=updater,
                              ctx=two_ranks[0])
        t1 = AsyncMatrixTable(8, 2, name="cs", updater=updater,
                              ctx=two_ranks[1])
        opt = AddOption(learning_rate=0.1, rho=0.1, momentum=0.9)
        t0.add_rows([5], np.ones((1, 2), np.float32), opt)
        before = t0.get_rows([5]).copy()
        ckdir = str(tmp_path / "ck")
        checkpoint.save_shard_state(ckdir, 1, [t1])
        t0.add_rows([5], np.ones((1, 2), np.float32), opt)
        after_two = t0.get_rows([5]).copy()
        checkpoint.restore_shard_state(ckdir, 1, [t1])
        np.testing.assert_array_equal(t0.get_rows([5]), before)
        # the restored state steps exactly like the original's 2nd step
        t0.add_rows([5], np.ones((1, 2), np.float32), opt)
        np.testing.assert_array_equal(t0.get_rows([5]), after_two)

    def test_torn_tag_invisible(self, two_ranks, tmp_path):
        t1 = AsyncMatrixTable(8, 2, name="tt", ctx=two_ranks[1])
        AsyncMatrixTable(8, 2, name="tt", ctx=two_ranks[0])
        ckdir = str(tmp_path / "ck")
        checkpoint.save_shard_state(ckdir, 1, [t1])
        p2 = checkpoint.save_shard_state(ckdir, 1, [t1])
        os.remove(os.path.join(p2, checkpoint.COMMIT_MARKER))
        assert checkpoint.latest_shard_tag(ckdir, 1) == "v000000000"
        checkpoint.save_shard_state(ckdir, 1, [t1])
        checkpoint.prune_shard_tags(ckdir, 1, keep=2)
        assert os.path.basename(p2) not in os.listdir(os.path.dirname(p2))

    def test_partition_mismatch_raises(self, two_ranks):
        t1 = AsyncMatrixTable(8, 2, name="pm", ctx=two_ranks[1])
        meta, arrays = t1._shard.checkpoint_state()
        with pytest.raises(svc.PSError):
            t1._shard.restore_checkpoint(dict(meta, lo=0), arrays)
        with pytest.raises(svc.PSError, match="not a row shard"):
            t1._shard.restore_checkpoint(dict(meta, kind="hash"), arrays)

    def test_snapshot_copies_are_owned(self, two_ranks):
        """The snapshot's arrays share no memory with the shard: an apply
        right after must not change the bytes being written."""
        t0 = AsyncMatrixTable(8, 2, name="ow", updater="adagrad",
                              ctx=two_ranks[0])
        t1 = AsyncMatrixTable(8, 2, name="ow", updater="adagrad",
                              ctx=two_ranks[1])
        t0.add_rows([5], np.ones((1, 2), np.float32))
        meta, arrays = t1._shard.checkpoint_state()
        saved = [a.copy() for a in arrays]
        t0.add_rows([5], np.ones((1, 2), np.float32))
        for a, b in zip(arrays, saved):
            np.testing.assert_array_equal(a, b)
        assert meta["n_leaves"] == 1 and meta["version"] == 1

    def test_checkpointer_cadence_and_final_save(self, two_ranks,
                                                 tmp_path):
        config.set_flag("failover_dir", str(tmp_path / "ck"))
        config.set_flag("failover_ckpt_interval_s", 0.05)
        config.set_flag("failover_ckpt_keep", 2)
        rdv = svc.FileRendezvous(str(tmp_path / "rdv2"))
        s = svc.PSService(0, 1, rdv)
        ctx = svc.PSContext(0, 1, s, device="cpu")
        t = AsyncMatrixTable(4, 2, name="cad", ctx=ctx)
        t.add_rows([1], np.ones((1, 2), np.float32))
        ck = failover.ensure_checkpointer(s)
        assert ck is failover.ensure_checkpointer(s)   # one per service
        deadline = time.monotonic() + 10
        while ck.saves < 3:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        ctx.close()   # the final save lands at close
        base = str(tmp_path / "ck" / "shard-r0")
        assert len([n for n in os.listdir(base)
                    if os.path.exists(os.path.join(
                        base, n, checkpoint.COMMIT_MARKER))]) == 2


# ---------------------------------------------------------------------- #
class TestStaleTombstone:
    def test_fresh_incarnation_clears_out_stamped_tombstone(self,
                                                           tmp_path):
        hb = str(tmp_path / "hb")
        pred = elastic.Heartbeat(hb, rank=3, addr="10.0.0.1:7001")
        pred.beat()
        with open(pred.path) as f:
            raw = json.load(f)
        raw["ts"] = time.time() + 1000.0
        with open(pred.path, "w") as f:
            json.dump(raw, f)
        elastic.mark_failed(hb, 3)
        assert 3 in elastic.failed(hb, timeout=1e9)
        elastic.Heartbeat(hb, rank=3, addr="10.0.0.1:7002").beat()
        assert 3 not in elastic.failed(hb, timeout=1e9)
        assert elastic.health(hb, timeout=1e9)[3] == "ok"

    def test_addr_less_beacons_keep_timestamp_rule(self, tmp_path):
        hb = str(tmp_path / "hb")
        b = elastic.Heartbeat(hb, rank=2)
        b.beat()
        elastic.mark_failed(hb, 2)
        assert 2 in elastic.failed(hb, timeout=1e9)
        time.sleep(0.01)
        b.beat()
        assert 2 not in elastic.failed(hb, timeout=1e9)

    def test_tombstone_records_beacon_addr(self, tmp_path):
        hb = str(tmp_path / "hb")
        elastic.Heartbeat(hb, rank=1, addr="h:1").beat()
        elastic.mark_failed(hb, 1)
        assert elastic._tombstones(hb)[1]["addr"] == "h:1"


# ---------------------------------------------------------------------- #
class TestSupervisor:
    def test_detect_respawn_rejoin(self, tmp_path):
        hb = str(tmp_path / "hb")
        calls = {"spawn": [], "kill": []}
        elastic.Heartbeat(hb, rank=0, addr="h:1").beat()
        elastic.Heartbeat(hb, rank=1, addr="h:2").beat()
        sup = failover.FailoverSupervisor(
            hb, 2, spawn=lambda r, g: calls["spawn"].append((r, g)),
            kill=lambda r: calls["kill"].append(r),
            timeout=1e9, poll_s=60, confirm=False, respawn_grace=0.2)
        assert sup.check_once()[1] == "ok"
        assert calls["spawn"] == []
        elastic.mark_failed(hb, 1)
        assert sup.check_once()[1] == "dead"
        assert calls["kill"] == [1] and calls["spawn"] == [(1, 1)]
        assert [p for _, p, _ in sup.events] == ["detect", "respawn"]
        assert sup.check_once()[1] == "dead"   # inside the grace
        assert calls["spawn"] == [(1, 1)]
        elastic.Heartbeat(hb, rank=1, addr="h:3").beat()
        assert sup.check_once()[1] == "ok"
        assert [p for _, p, _ in sup.events] == ["detect", "respawn",
                                                 "rejoin"]
        spans = sup.recovery_spans()
        assert len(spans) == 1 and spans[0]["rank"] == 1
        # past the grace a rank still dead is respawned again, at gen 2
        time.sleep(0.25)
        elastic.mark_failed(hb, 1)
        sup.check_once()
        assert calls["spawn"] == [(1, 1), (1, 2)]

    def test_confirm_probe_vetoes_false_positive(self, tmp_path):
        rdv_dir = str(tmp_path / "rdv")
        service = svc.PSService(1, 1, svc.FileRendezvous(rdv_dir))
        try:
            hb = str(tmp_path / "hb")
            elastic.Heartbeat(hb, rank=1, addr=service.addr).beat()
            calls = []
            sup = failover.FailoverSupervisor(
                hb, 2, rendezvous_dir=rdv_dir,
                spawn=lambda r, g: calls.append((r, g)),
                timeout=0.0, poll_s=60, confirm=True, ranks=[1])
            time.sleep(0.05)   # the beacon goes stale at timeout=0
            sup.check_once()
            assert calls == []   # the probe answered: vetoed
            assert failover.read_addr(rdv_dir, 1) == service.addr
        finally:
            service.close()
        sup.check_once()   # now nothing answers: confirmed, recovered
        assert calls == [(1, 1)]

    def test_never_seen_rank_not_respawned(self, tmp_path):
        calls = []
        sup = failover.FailoverSupervisor(
            str(tmp_path / "hb"), 4, spawn=lambda r, g: calls.append(r),
            confirm=False, timeout=1e9, poll_s=60)
        sup.check_once()
        assert calls == []

    def test_reads_jax_beacons(self, tmp_path):
        """A supervisor of this package watching ranks of the JAX
        package: the same files, the same verdicts."""
        from multiverso_tpu import elastic as jel
        hb = str(tmp_path / "hb")
        jel.Heartbeat(hb, rank=1, addr="h:2").beat()
        calls = []
        sup = failover.FailoverSupervisor(
            hb, 2, spawn=lambda r, g: calls.append((r, g)),
            confirm=False, timeout=1e9, poll_s=60, respawn_grace=60)
        sup.check_once()
        jel.mark_failed(hb, 1)
        sup.check_once()
        jel.Heartbeat(hb, rank=1, addr="h:9").beat()
        sup.check_once()
        assert calls == [(1, 1)]
        assert [p for _, p, _ in sup.events] == ["detect", "respawn",
                                                 "rejoin"]


# ---------------------------------------------------------------------- #
class TestInProcessFailoverSmoke:
    def test_kill_respawn_restore_replay(self, tmp_path):
        config.set_flag("ps_replay", True)
        config.set_flag("ps_reconnect_backoff", 0.2)
        config.set_flag("ps_replay_backoff", 0.1)
        rdv = svc.FileRendezvous(str(tmp_path / "rdv"))
        ckdir = str(tmp_path / "ck")
        ctx0 = svc.PSContext(0, 2, svc.PSService(0, 2, rdv), device="cpu")
        ctx1 = svc.PSContext(1, 2, svc.PSService(1, 2, rdv), device="cpu")
        ctx1b = None
        try:
            t = AsyncMatrixTable(8, 2, name="sm", send_window_ms=1.0,
                                 ctx=ctx0)
            t1 = AsyncMatrixTable(8, 2, name="sm", send_window_ms=1.0,
                                  ctx=ctx1)
            ck = failover.ShardCheckpointer(ckdir, 1, [t1],
                                            interval_s=999)
            for _ in range(3):
                t.add_rows([5], np.ones((1, 2), np.float32))
            ck.checkpoint_now()
            for _ in range(2):   # acked but NOT durable
                t.add_rows([5], np.ones((1, 2), np.float32))
            assert float(t.get_rows([5])[0, 0]) == 5.0
            ctx1.service.close()   # the "crash"
            mids = [t.add_rows_async([5], np.ones((1, 2), np.float32))
                    for _ in range(2)]   # issued mid-outage
            time.sleep(0.3)
            config.set_flag("ps_generation", 1)
            svc1b = svc.PSService(1, 2, rdv, defer_publish=True)
            assert not svc1b._published
            ctx1b = svc.PSContext(1, 2, svc1b, device="cpu")
            t1b = AsyncMatrixTable(8, 2, name="sm", send_window_ms=1.0,
                                   ctx=ctx1b)
            assert failover.rejoin(ckdir, 1, [t1b], service=svc1b) == 1
            assert svc1b._published
            for m in mids:
                t.wait(m)
            t.flush()
            # 3 checkpointed + 2 acked-replayed + 2 mid-outage, exactly
            assert float(t.get_rows([5])[0, 0]) == 7.0
            assert svc1b.health_payload()["gen"] == 1
            assert t.server_health(1)["gen"] == 1
            # the replica token: a restored shard at generation 1
            meta, _ = t1b._shard.export_snapshot({})
            assert meta["gen"] == 1
        finally:
            ctx0.close()
            if ctx1b is not None:
                ctx1b.close()


# ---------------------------------------------------------------------- #
# mixed worlds: one package's client replays to the other's restored shard
# ---------------------------------------------------------------------- #
def _mixed(tmp_path, client):
    """Rank 0 (the client) of ``client``'s package, rank 1 (the victim
    shard) of the other; replay on both sides. Returns the client table,
    the victim's context and table and a respawn function."""
    rdv_dir = str(tmp_path / "rdv")
    ckdir = str(tmp_path / "ck")
    for cfg in (config, jconfig):
        cfg.set_flag("ps_replay", True)
        cfg.set_flag("ps_reconnect_backoff", 0.2)
        cfg.set_flag("ps_replay_backoff", 0.1)
    if client == "jax":
        cctx = jsvc.PSContext(0, 2, jsvc.PSService(
            0, 2, jsvc.FileRendezvous(rdv_dir)))
        vmk = lambda defer=False: svc.PSContext(1, 2, svc.PSService(
            1, 2, svc.FileRendezvous(rdv_dir), defer_publish=defer),
            device="cpu")
        ctab = jtables.AsyncMatrixTable
        vtab = AsyncMatrixTable
        vcfg, vfail = config, failover
    else:
        cctx = svc.PSContext(0, 2, svc.PSService(
            0, 2, svc.FileRendezvous(rdv_dir)), device="cpu")
        vmk = lambda defer=False: jsvc.PSContext(1, 2, jsvc.PSService(
            1, 2, jsvc.FileRendezvous(rdv_dir), defer_publish=defer))
        ctab = AsyncMatrixTable
        vtab = jtables.AsyncMatrixTable
        vcfg, vfail = jconfig, jfailover
    return cctx, vmk, ctab, vtab, vcfg, vfail, ckdir


@pytest.mark.parametrize("client", ["jax", "torch"])
def test_mixed_world_kill_rejoin_replay(tmp_path, client):
    cctx, vmk, ctab, vtab, vcfg, vfail, ckdir = _mixed(tmp_path, client)
    vctx = vmk()
    vctx_b = None
    rows, cols = 10, 3
    rng = np.random.default_rng(4)
    model = np.zeros((rows, cols), np.float32)
    try:
        t = ctab(rows, cols, name="mw", send_window_ms=1.0, ctx=cctx)
        v = vtab(rows, cols, name="mw", send_window_ms=1.0, ctx=vctx)
        ck = vfail.ShardCheckpointer(ckdir, 1, [v], interval_s=999)

        def add(n):
            for _ in range(n):
                ids = rng.choice(rows, 3, replace=False)
                vals = rng.normal(size=(3, cols)).astype(np.float32)
                t.add_rows(ids, vals)
                model[ids] += vals

        add(4)
        ck.checkpoint_now()
        add(3)                          # acked, not durable
        vctx.service.close()            # the victim dies
        mids = []
        for _ in range(2):              # issued mid-outage
            ids = np.array([6, 8, 9])   # rank 1's rows
            vals = rng.normal(size=(3, cols)).astype(np.float32)
            mids.append(t.add_rows_async(ids, vals))
            model[ids] += vals
        time.sleep(0.3)
        vcfg.set_flag("ps_generation", 1)
        vctx_b = vmk(defer=True)
        vb = vtab(rows, cols, name="mw", send_window_ms=1.0, ctx=vctx_b)
        assert vfail.rejoin(ckdir, 1, [vb], service=vctx_b.service) == 1
        for m in mids:
            t.wait(m)
        t.flush()
        np.testing.assert_array_equal(t.get_rows(np.arange(rows)), model)
        np.testing.assert_array_equal(vb.get_rows(np.arange(rows)), model)
        assert t.server_health(1)["gen"] == 1
    finally:
        cctx.close()
        if vctx_b is not None:
            vctx_b.close()
