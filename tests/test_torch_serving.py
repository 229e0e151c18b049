"""Port parity, the serving plane: ``serving/replica.py``,
``serving/admission.py``, the ``serving`` block of the service's stats and
``apps/dlrm_serving.py``, mirroring ``tests/test_serving.py``.

* the ``MSG_SNAPSHOT`` RPC (since-version dedupe, chunked streams, hash
  shards refused) and the replica on it: parity with the shards bit for
  bit, versions, unchanged pulls, the staleness bound enforced with
  single-flight deferred refreshes, reads never torn by writes;
* the hot-row cache: seeded from the shards' sketch, on the table's
  device, following the snapshot's epoch, dropped when a swap moves the
  content without a rebuild, and no tensor census growth across
  refreshes;
* admission decisions under an injected clock, and the replica shedding;
* mixed worlds: a port replica subscribed to a JAX shard and a JAX
  replica subscribed to a port shard, each equal to the shards' rows bit
  for bit (the frames are the same bytes);
* ``DLRMServing``: the first 4 ``train_step``s against the JAX app's from
  the same start (the loss within 1e-5 relative, the table within 1e-5
  of max |x|), inference through the replica, and train-while-serve.

Two ranks in one process over a ``FileRendezvous``, on the CPU.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from multiverso_tpu.apps import dlrm_serving as japp
from multiverso_tpu.models import dlrm as jd
from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.serving import replica as jreplica
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.apps import dlrm_serving as tapp
from multiverso_tpu_torch.models import dlrm as td
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.serving import (AdmissionController, ReadReplica,
                                          SheddingError, TokenBucket)
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _short_timeouts():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 10.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    yield
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture
def ranks(tmp_path):
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


def _tables(ctxs, rows=64, cols=4, name="srv", mod=ttables, **kw):
    return [mod.AsyncMatrixTable(rows, cols, name=name, ctx=c, seed=0,
                                 init_scale=0.1, **kw) for c in ctxs]


def _snapshot(ctx, meta, sink=None):
    return tsvc.await_reply(ctx.service.request(1, tsvc.MSG_SNAPSHOT, meta,
                                                chunk_sink=sink),
                            10.0, "snapshot")


# ---------------------------------------------------------------------- #
# MSG_SNAPSHOT
# ---------------------------------------------------------------------- #
def test_snapshot_versions_and_rows(ranks):
    t0, _ = _tables(ranks)
    meta, arrays = _snapshot(ranks[0], {"table": "srv", "since": -1})
    assert meta["lo"] == 32 and meta["rows"] == 32
    v0 = meta["version"]
    np.testing.assert_array_equal(
        np.asarray(arrays[0], np.float32).reshape(32, 4),
        t0.get_rows(np.arange(32, 64)))
    meta2, arrays2 = _snapshot(ranks[0], {"table": "srv", "since": v0,
                                          "since_gen": meta["gen"]})
    assert meta2["unchanged"] and meta2["version"] == v0
    assert len(arrays2) == 0
    t0.add_rows([40], np.ones((1, 4), np.float32))
    meta3, arrays3 = _snapshot(ranks[0], {"table": "srv", "since": v0,
                                          "since_gen": meta["gen"]})
    assert meta3["version"] > v0 and not meta3.get("unchanged")
    np.testing.assert_array_equal(
        np.asarray(arrays3[0], np.float32).reshape(32, 4),
        t0.get_rows(np.arange(32, 64)))
    sh = t0.server_stats(1)["shards"]["srv"]
    assert sh["snapshots"] == 3 and sh["snapshots_unchanged"] == 1


def test_snapshot_chunked_stream(ranks):
    t0, _ = _tables(ranks, rows=200, cols=3, name="srv_big")
    buf = np.empty((100, 3), np.float32)

    def sink(cmeta, arrays):
        r0, n = int(cmeta["row0"]), int(cmeta["rows"])
        buf[r0:r0 + n] = np.asarray(arrays[0], np.float32).reshape(n, 3)

    meta, _ = _snapshot(ranks[0], {"table": "srv_big", "since": -1,
                                   "chunk": 16}, sink)
    assert meta["chunks"] == -(-100 // 16)
    np.testing.assert_array_equal(buf, t0.get_rows(np.arange(100, 200)))


def test_hash_shard_refuses_snapshot(ranks):
    ttables.AsyncSparseKVTable(4, name="srv_kv", ctx=ranks[0])
    fut = ranks[0].service.request(0, tsvc.MSG_SNAPSHOT,
                                   {"table": "srv_kv", "since": -1})
    with pytest.raises(tsvc.PSError, match="row-partitioned"):
        tsvc.await_reply(fut, 10.0, "snapshot")


# ---------------------------------------------------------------------- #
# ReadReplica
# ---------------------------------------------------------------------- #
def test_parity_and_versions(ranks):
    t0, _ = _tables(ranks)
    rep = ReadReplica(t0, start=False, staleness_s=30.0)
    rep.refresh()
    ids = np.arange(64)
    np.testing.assert_array_equal(rep.get_rows(ids), t0.get_rows(ids))
    t0.add_rows([3, 40], np.full((2, 4), 0.25, np.float32))
    rep.refresh()
    np.testing.assert_array_equal(rep.get_rows(ids), t0.get_rows(ids))
    st = rep.stats()
    for rank in (0, 1):
        shard_v = t0.server_stats(rank)["shards"]["srv"]["version"]
        assert st["versions"][str(rank)] == shard_v
    rep.close()


def test_standalone_replica_from_a_spec(ranks):
    t0, _ = _tables(ranks, name="srv_sa")
    rep = ReadReplica(ctx=ranks[1], name="srv_sa", num_row=64, num_col=4,
                      start=False, staleness_s=30.0)
    rep.refresh()
    np.testing.assert_array_equal(rep.get_rows(np.arange(64)),
                                  t0.get_rows(np.arange(64)))
    with pytest.raises(ValueError, match="standalone"):
        ReadReplica(ctx=ranks[1], name="srv_sa", start=False)
    rep.close()


def test_unchanged_pulls_are_deduped(ranks):
    t0, _ = _tables(ranks)
    rep = ReadReplica(t0, start=False, staleness_s=30.0)
    rep.refresh()
    data = rep._data
    rep.refresh()
    assert rep.stats()["unchanged_pulls"] == 2
    assert rep.stats()["epoch"] == 2
    assert rep._data is data   # an all-unchanged epoch reuses the buffer
    t0.add_rows([3], np.ones((1, 4), np.float32))
    rep.refresh()
    # a snapshot is never mutated in place: a change builds a fresh one
    assert rep._data is not data
    assert rep.stats()["unchanged_pulls"] == 3   # rank 1's shard only


def test_staleness_bound_enforced(ranks):
    t0, _ = _tables(ranks)
    rep = ReadReplica(t0, start=False, staleness_s=0.5)
    rep.refresh()
    t0.add_rows([5], np.ones((1, 4), np.float32))
    time.sleep(0.7)
    rows, age = rep.get_rows([5], with_age=True)
    assert age <= 0.5
    np.testing.assert_array_equal(rows, t0.get_rows([5]))
    assert rep.stats()["deferred"] >= 1
    assert TDashboard.get("table[srv].get.deferred").count >= 1
    rep.close()


def test_concurrent_stale_readers_share_one_pull(ranks):
    t0, _ = _tables(ranks, name="srv_share")
    rep = ReadReplica(t0, start=False, staleness_s=0.5)
    rep.refresh()
    time.sleep(0.7)
    e0 = rep.stats()["epoch"]
    errs = []

    def read():
        try:
            rep.get_rows([1], cls="train")
        except Exception as e:   # noqa: BLE001
            errs.append(e)

    ths = [threading.Thread(target=read) for _ in range(6)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in ths)
    assert not errs, errs[:2]
    assert rep.stats()["epoch"] - e0 <= 2
    assert rep.stats()["deferred"] >= 1
    rep.close()


def test_background_refresh_thread(ranks):
    t0, _ = _tables(ranks)
    rep = ReadReplica(t0, refresh_s=0.05, staleness_s=5.0)
    try:
        t0.add_rows([9], np.ones((1, 4), np.float32))
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if rep.stats()["epoch"] >= 2 and np.array_equal(
                    rep.get_rows([9]), t0.get_rows([9])):
                break
            time.sleep(0.05)
        else:
            pytest.fail("the background refresh never caught up")
    finally:
        rep.close()
    assert rep._thread is None
    with pytest.raises(RuntimeError, match="closed"):
        rep.get_rows([1])


def test_out_buffer_and_bad_ids(ranks):
    t0, _ = _tables(ranks)
    rep = ReadReplica(t0, start=False, staleness_s=30.0)
    rep.refresh()
    out = np.empty((5, 4), np.float32)
    assert rep.get_rows([1, 2, 33, 40, 63], out=out) is out
    np.testing.assert_array_equal(out, t0.get_rows([1, 2, 33, 40, 63]))
    with pytest.raises(IndexError):
        rep.get_rows([64])
    with pytest.raises(ValueError):
        rep.get_rows([])
    with pytest.raises(NotImplementedError, match="Telemetry and tools"):
        rep.get_rows([1], tenant="storm")
    rep.close()


def test_reads_served_while_writes_flow(ranks):
    t0, _ = _tables(ranks, rows=16, cols=2, name="srv_tear")
    t0.set_rows([2], np.zeros((1, 2), np.float32))
    rep = ReadReplica(t0, start=False, staleness_s=30.0)
    rep.refresh()
    stop = threading.Event()
    errs = []

    def writer():
        k = 0.0
        while not stop.is_set():
            k += 1.0
            t0.set_rows([2], np.full((1, 2), k, np.float32))
            rep.refresh()

    def reader():
        while not stop.is_set():
            r = rep.get_rows([2], cls="train")
            if r[0, 0] != r[0, 1]:
                errs.append(r.copy())

    ths = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for th in ths:
        th.start()
    time.sleep(0.7)
    stop.set()
    for th in ths:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in ths)
    assert not errs, errs[:3]
    rep.close()


# ---------------------------------------------------------------------- #
# the hot-row cache
# ---------------------------------------------------------------------- #
def test_cache_seeded_and_counted(ranks):
    t0, _ = _tables(ranks, name="srv_hot", updater="adagrad")
    for _ in range(20):
        t0.get_rows([7, 50])
    rep = ReadReplica(t0, start=False, staleness_s=30.0, cache_rows=8)
    rep.refresh()
    assert rep.stats()["cache_rows"] > 0
    assert {7, 50} <= set(rep._cache.ids().tolist())
    dev = rep.cache_lookup([7, 50])
    assert isinstance(dev, torch.Tensor) and dev.device == t0.device
    np.testing.assert_array_equal(dev.numpy(), t0.get_rows([7, 50]))
    cold = int(np.setdiff1d(np.arange(64), rep._cache.ids())[0])
    assert rep.cache_lookup([7, cold]) is None
    h0, m0 = rep.stats()["cache_hits"], rep.stats()["cache_misses"]
    rep.get_rows([7, 50, cold])
    st = rep.stats()
    assert (st["cache_hits"] - h0, st["cache_misses"] - m0) == (2, 1)
    assert TDashboard.get("table[srv_hot].get.cache_hit").count == 2
    assert TDashboard.get("table[srv_hot].get.cache_miss").count == 1
    rep.close()


def test_cache_follows_snapshot_epoch(ranks):
    t0, _ = _tables(ranks, name="srv_hot2", updater="adagrad")
    for _ in range(10):
        t0.get_rows([3])
    rep = ReadReplica(t0, start=False, staleness_s=30.0, cache_rows=4)
    rep.refresh()
    assert rep.cache_lookup([3]) is not None
    t0.add_rows([3], np.ones((1, 4), np.float32))
    rep.refresh()
    np.testing.assert_array_equal(rep.cache_lookup([3]).numpy(),
                                  t0.get_rows([3]))
    rep.close()


def test_stale_device_cache_dropped_at_swap_commit(ranks):
    t0, _ = _tables(ranks, name="srv_hot3", updater="adagrad")
    for _ in range(10):
        t0.get_rows([3])
    rep = ReadReplica(t0, start=False, staleness_s=30.0, cache_rows=4)
    rep.refresh()
    assert rep._cache.memory_stats()["device_bytes"] > 0
    rep._hot_ids = None
    rep.refresh()   # unchanged epoch: keeping the cache is safe
    assert rep._cache.memory_stats()["device_bytes"] > 0
    t0.add_rows([3], np.ones((1, 4), np.float32))
    rep.refresh()   # content moved and no rebuild: the cache goes
    assert (rep._cache.memory_stats()["device_bytes"] == 0
            and len(rep._cache) == 0)
    assert rep.cache_lookup([3]) is None
    rep.close()


def test_tensor_census_flat_across_refreshes(ranks):
    """3 refreshes with content changes and cache rebuilds hold the
    census of live tensors flat: each swap releases the previous epoch's
    cache tensor."""
    t0, _ = _tables(ranks, name="srv_gc", updater="adagrad")
    for _ in range(10):
        t0.get_rows([5, 9])
    rep = ReadReplica(t0, start=False, staleness_s=30.0, cache_rows=4)
    rep.refresh()

    def census():
        gc.collect()
        return sum(1 for o in gc.get_objects() if torch.is_tensor(o))

    base = census()
    for i in range(3):
        t0.add_rows([5], np.full((1, 4), float(i + 1), np.float32))
        rep.refresh()
        assert census() <= base, i
    rep.close()


# ---------------------------------------------------------------------- #
# admission
# ---------------------------------------------------------------------- #
def test_token_bucket_refill_under_an_injected_clock():
    b = TokenBucket(10.0, burst=2.0)
    t = 1000.0
    assert b.try_acquire(now=t) and b.try_acquire(now=t)
    assert not b.try_acquire(now=t)
    assert b.try_acquire(now=t + 0.1)
    assert not b.try_acquire(now=t + 0.1)
    assert b.try_acquire(now=t + 100.0, n=2.0)
    assert not b.try_acquire(now=t + 100.0)
    c = TokenBucket(10.0, burst=1.0)
    assert c.try_acquire(now=1000.0)
    assert not c.try_acquire(now=999.0)   # no refill from a rewound clock
    assert c.try_acquire(now=1000.2)
    with pytest.raises(ValueError):
        TokenBucket(0.0)


def test_admission_decisions_match_jax():
    """The same limits and the same injected clock give the same admit
    sequence in both packages."""
    from multiverso_tpu.serving.admission import TokenBucket as JBucket
    for rate, burst in ((10.0, 2.0), (3.0, 1.0), (250.0, 25.0)):
        tb, jb = TokenBucket(rate, burst), JBucket(rate, burst)
        clock = np.cumsum(np.random.default_rng(int(rate)).exponential(
            1.0 / (2 * rate), 300)) + 5.0
        got = [tb.try_acquire(now=float(t)) for t in clock]
        want = [jb.try_acquire(now=float(t)) for t in clock]
        assert got == want and 0 < sum(got) < len(got)


def test_priority_classes_and_flag_default():
    adm = AdmissionController()
    adm.set_limit("t", "infer", 1.0, burst=1.0)
    assert adm.admit("t", "infer")
    assert not adm.admit("t", "infer")
    for _ in range(50):
        assert adm.admit("t", "train")
    st = adm.stats()
    assert st["t/infer"] == {"admitted": 1, "shed": 1, "qps_limit": 1.0}
    assert st["t/train"]["shed"] == 0 and st["t/train"]["qps_limit"] is None
    tconfig.set_flag("serving_infer_qps", 1.0)
    adm = AdmissionController()
    assert adm.admit("x", "infer") and not adm.admit("x", "infer")
    assert adm.admit("x", "train")
    adm.set_limit("y", "infer", 0)   # an exemption beats the flag
    assert all(adm.admit("y", "infer") for _ in range(20))
    with pytest.raises(ValueError, match="admission class"):
        adm.set_limit("t", "batch", 1.0)
    with pytest.raises(NotImplementedError, match="Telemetry and tools"):
        adm.admit("t", "infer", tenant="storm")


def test_replica_sheds_and_counts(ranks):
    t0, _ = _tables(ranks, name="srv_adm")
    adm = AdmissionController()
    adm.set_limit("srv_adm", "infer", 1.0, burst=1.0)
    rep = ReadReplica(t0, start=False, staleness_s=30.0, admission=adm)
    rep.refresh()
    rep.get_rows([1])
    with pytest.raises(SheddingError):
        rep.get_rows([1])
    rep.get_rows([1], cls="train")
    st = rep.stats()
    assert st["shed"] == 1 and st["served"] == 2
    assert st["admission"]["srv_adm/infer"]["shed"] == 1
    assert TDashboard.get("table[srv_adm].get.shed").count == 1
    assert TDashboard.get("table[srv_adm].get.replica").count == 2
    rep.close()


def test_stats_payload_and_msg_stats(ranks):
    t0, _ = _tables(ranks, name="srv_tel")
    rep = ReadReplica(t0, start=False, staleness_s=30.0)
    rep.refresh()
    rep.get_rows([1], cls="train")
    assert ranks[0].service.stats_payload()["serving"]["srv_tel"][
        "served"] == 1
    remote = ranks[1].service.stats(0)
    assert remote["serving"]["srv_tel"]["epoch"] == 1
    assert remote["serving"]["srv_tel"]["bound_s"] == 30.0
    rep.close()


# ---------------------------------------------------------------------- #
# mixed worlds: the frames are the JAX package's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("replica_side", ["port", "jax"])
def test_replica_across_packages(tmp_path, replica_side):
    """Rank 0 runs the replica's package, rank 1 the other's shard; the
    replica's snapshot equals both shards' rows bit for bit."""
    rdv = str(tmp_path / "mixed")
    if replica_side == "port":
        c0 = tsvc.PSContext(0, 2, tsvc.PSService(0, 2,
                                                 tsvc.FileRendezvous(rdv)),
                            device="cpu")
        c1 = jsvc.PSContext(1, 2, jsvc.PSService(1, 2,
                                                 jsvc.FileRendezvous(rdv)))
        m0, m1, Rep = ttables, jtables, ReadReplica
    else:
        c0 = jsvc.PSContext(0, 2, jsvc.PSService(0, 2,
                                                 jsvc.FileRendezvous(rdv)))
        c1 = tsvc.PSContext(1, 2, tsvc.PSService(1, 2,
                                                 tsvc.FileRendezvous(rdv)),
                            device="cpu")
        m0, m1, Rep = jtables, ttables, jreplica.ReadReplica
    try:
        rows, cols = 40, 3
        t0 = m0.AsyncMatrixTable(rows, cols, name="mx_rep", ctx=c0, seed=1,
                                 init_scale=0.1, updater="adagrad")
        t1 = m1.AsyncMatrixTable(rows, cols, name="mx_rep", ctx=c1, seed=1,
                                 init_scale=0.1, updater="adagrad")
        for _ in range(5):
            t0.get_rows([25, 31])   # hot on rank 1's sketch
        rep = Rep(t0, start=False, staleness_s=30.0, cache_rows=4)
        rep.refresh()
        ids = np.arange(rows)
        np.testing.assert_array_equal(rep.get_rows(ids, cls="train"),
                                      t0.get_rows(ids))
        rng = np.random.default_rng(2)
        t1.add_rows([22, 39, 5], rng.normal(size=(3, cols)).astype(
            np.float32))
        rep.refresh()
        got = rep.get_rows(ids, cls="train")
        np.testing.assert_array_equal(got, t0.get_rows(ids))
        np.testing.assert_array_equal(got, t1.get_rows(ids))
        assert {25, 31} <= set(np.asarray(rep._cache.ids()).tolist())
        assert rep.stats()["unchanged_pulls"] == 0
        rep.refresh()
        assert rep.stats()["unchanged_pulls"] == 2
        rep.close()
    finally:
        c0.close()
        c1.close()


# ---------------------------------------------------------------------- #
# DLRMServing
# ---------------------------------------------------------------------- #
CFG = dict(vocab_sizes=(32, 16), embed_dim=8, dense_dim=4, bottom_mlp=(8,),
           top_mlp=(8, 1))


def test_train_steps_match_jax():
    """The first 4 train_steps from one start (the seeded table and MLP):
    the loss within 1e-5 relative, the table within 1e-5 of max |x|, the
    MLP within 1e-5 of max |x|."""
    import jax
    jc, tc = jd.DLRMConfig(**CFG), td.DLRMConfig(**CFG)
    jctx = jsvc.PSContext(0, 1, jsvc.PSService(0, 1))
    tctx = tsvc.PSContext(0, 1, tsvc.PSService(0, 1), device="cpu")
    try:
        ja = japp.DLRMServing(jc, ctx=jctx, name="app_p", lr=0.2,
                              staleness_s=30.0, start_replica=False)
        ta = tapp.DLRMServing(tc, ctx=tctx, name="app_p", lr=0.2,
                              staleness_s=30.0, start_replica=False)
        ids = np.arange(td.total_rows(tc))
        np.testing.assert_array_equal(ta.emb.get_rows(ids),
                                      ja.emb.get_rows(ids))
        cat, dense, labels = jd.synthetic_ctr(jc, 256, seed=3)
        for i in range(4):
            sl = slice(i * 64, (i + 1) * 64)
            with jax.default_matmul_precision("float32"):
                jl, _ = ja.train_step(cat[sl], dense[sl], labels[sl])
            tl, ms = ta.train_step(cat[sl], dense[sl], labels[sl])
            assert ms >= 0
            assert abs(tl - jl) <= RTOL * abs(jl), (i, tl, jl)
        want = ja.emb.get_rows(ids)
        got = ta.emb.get_rows(ids)
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
        jf, _ = jd.flatten_mlp(ja.mlp)
        tf, _ = td.flatten_mlp(ta.mlp)
        assert np.abs(tf - jf).max() <= RTOL * np.abs(jf).max()
        ja.close()
        ta.close()
    finally:
        jctx.close()
        tctx.close()


def test_train_while_serve(ranks):
    tc = td.DLRMConfig(**CFG)
    app = tapp.DLRMServing(tc, ctx=ranks[0], name="app_t", lr=0.2,
                           staleness_s=30.0, start_replica=False)
    peer = ttables.AsyncMatrixTable(td.total_rows(tc), tc.embed_dim,
                                    updater="adagrad", seed=0,
                                    init_scale=0.05, name=app.emb.name,
                                    ctx=ranks[1])
    cat, dense, labels = td.synthetic_ctr(tc, 512, seed=3)
    losses = []
    for i in range(8):
        sl = slice(i * 64, (i + 1) * 64)
        loss, write_ms = app.train_step(cat[sl], dense[sl], labels[sl])
        assert write_ms >= 0
        losses.append(loss)
    assert losses[-1] < losses[0], losses
    app.replica.refresh()
    scores = app.infer(cat[:16], dense[:16])
    assert scores.shape == (16,)
    assert np.all((scores >= 0) & (scores <= 1))
    # the scores equal the model on the shards' own rows
    rows = app.emb.get_rows(app._ids(cat[:16])).reshape(16, 2, 8)
    want = torch.sigmoid(td.forward(app.mlp, torch.from_numpy(rows),
                                    torch.from_numpy(dense[:16]), tc))
    np.testing.assert_allclose(scores, want.numpy(), rtol=1e-6)
    ids = np.arange(td.total_rows(tc))
    np.testing.assert_array_equal(app.replica.get_rows(ids, cls="train"),
                                  app.emb.get_rows(ids))
    assert app.serving_stats()["served"] >= 2
    app.close()
    del peer


def test_mlp_carried_from_jax_serves_the_same_scores(ranks):
    jc, tc = jd.DLRMConfig(**CFG), td.DLRMConfig(**CFG)
    jp = jd.init_mlp_params(jc, 7)
    app = tapp.DLRMServing(tc, ctx=ranks[0], name="app_c",
                           staleness_s=30.0, start_replica=False)
    app.mlp = td.mlp_from_jax(jp, device=app.device)
    ttables.AsyncMatrixTable(td.total_rows(tc), tc.embed_dim,
                             updater="adagrad", seed=0, init_scale=0.05,
                             name=app.emb.name, ctx=ranks[1])
    app.replica.refresh()
    cat, dense, _ = jd.synthetic_ctr(jc, 16, seed=1)
    rows = app.emb.get_rows(app._ids(cat)).reshape(16, 2, 8)
    import jax
    import jax.numpy as jnp
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.nn.sigmoid(jd.forward(
            jp, jnp.asarray(rows), jnp.asarray(dense), jc)))
    np.testing.assert_allclose(app.infer(cat, dense), want, rtol=RTOL,
                               atol=1e-7)
    app.close()
