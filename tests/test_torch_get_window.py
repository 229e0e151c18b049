"""Port parity, the client get window (``ps/tables._GetWindow``): the
port's coalesced gets against plain gets and against the JAX package's
get window, mirroring ``tests/test_get_path.py``'s window tests.

* single flight: with the owner's serve slowed, concurrent gets reach the
  shard as fewer serves, and every caller gets its own rows exactly;
* serial gets, unsorted ids and duplicates, across owners, return what a
  window-off get returns, bit for bit, and what the JAX package's
  windowed get returns on the same table;
* the send and get windows compose (read-your-writes), a coalesced fetch
  streams chunked, a dead owner fails its waiters instead of hanging
  them, and a port client's coalesced fetches read a JAX shard.

Two ranks in one process over a ``FileRendezvous``, on the CPU.
"""

import gc
import threading
import time

import numpy as np
import pytest

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard


@pytest.fixture(autouse=True)
def _short_timeouts():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 5.0)
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


@pytest.fixture
def py_ranks(tmp_path):
    """``ranks`` on the Python wire plane (ps_native off), as the JAX
    package's get-path tests pin it: a test that slows the Python serve
    path is bypassed by the native C++ one."""
    tconfig.set_flag("ps_native", False)
    rdv = tsvc.FileRendezvous(str(tmp_path / "rdv"))
    ctxs = [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


def _pair(ctxs, rows, cols, name, mod=ttables, **kw):
    return (mod.AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[0], **kw),
            mod.AsyncMatrixTable(rows, cols, name=name, ctx=ctxs[1], **kw))


def _values(rows, cols, seed=1):
    return np.random.default_rng(seed).normal(size=(rows, cols)).astype(
        np.float32)


def test_get_window_single_flight(py_ranks):
    rows, cols = 64, 4
    vals = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
    t, t2 = _pair(py_ranks, rows, cols, "sf", get_window_ms=50.0)
    t.set_rows(np.arange(rows), vals)
    t.get_rows([40])   # warm the conn
    orig = t2._shard._gather_rows

    def slow(local, data=None):
        time.sleep(0.08)
        return orig(local, data=data)

    t2._shard._gather_rows = slow
    served_before = t2._shard._stat_gets
    results = [None] * 8
    start = threading.Barrier(8)

    def getter(i):
        start.wait()
        results[i] = t.get_rows(np.array([40 + (i % 4)]))

    ths = [threading.Thread(target=getter, args=(i,)) for i in range(8)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in ths)
    for i in range(8):
        np.testing.assert_array_equal(results[i][0], vals[40 + (i % 4)])
    served = t2._shard._stat_gets - served_before
    assert served < 8, f"the coalescer shipped {served} frames for 8 gets"
    assert TDashboard.get("table[sf].get_rows.fetches").count < 9
    assert TDashboard.get("table[sf].get_rows.merged_rows").count > 0


@pytest.mark.parametrize("ids", [[30, 17, 2, 17, 30], [31, 1, 16, 0],
                                 [5], list(range(32))],
                         ids=["dups", "cross_owner", "one", "all"])
def test_get_window_serial_gets_match_plain_and_jax(ranks, tmp_path, ids):
    rows, cols = 32, 3
    vals = _values(rows, cols)
    ids = np.array(ids)
    tw, _ = _pair(ranks, rows, cols, "swd", get_window_ms=5.0)
    tp, _ = _pair(ranks, rows, cols, "spl")
    for t in (tw, tp):
        t.set_rows(np.arange(rows), vals)
    got = tw.get_rows(ids)
    np.testing.assert_array_equal(got, vals[ids])
    np.testing.assert_array_equal(got, tp.get_rows(ids))
    jrdv = jsvc.FileRendezvous(str(tmp_path / "jrdv"))
    jctxs = [jsvc.PSContext(r, 2, jsvc.PSService(r, 2, jrdv))
             for r in range(2)]
    try:
        jt, _ = _pair(jctxs, rows, cols, "jwd", mod=jtables,
                      get_window_ms=5.0)
        jt.set_rows(np.arange(rows), vals)
        np.testing.assert_array_equal(got, jt.get_rows(ids))
    finally:
        for c in jctxs:
            c.close()


def test_get_window_read_your_writes(ranks):
    t, _ = _pair(ranks, 16, 2, "ryw", send_window_ms=50.0,
                 get_window_ms=50.0)
    for i in range(4):
        t.add_rows_async([12], np.full((1, 2), 1.0, np.float32))
        assert t.get_rows([12])[0, 0] == float(i + 1)


def test_concurrent_windowed_gets_each_get_their_rows(py_ranks):
    """Many threads with overlapping, unsorted id sets over both owners:
    each result equals the table's rows in that caller's order."""
    rows, cols = 48, 5
    vals = _values(rows, cols, seed=4)
    t, t2 = _pair(py_ranks, rows, cols, "cc", get_window_ms=2.0)
    t.set_rows(np.arange(rows), vals)
    orig = t2._shard._gather_rows

    def slow(local, data=None):
        time.sleep(0.01)
        return orig(local, data=data)

    t2._shard._gather_rows = slow
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(10):
            ids = rng.choice(rows, int(rng.integers(1, 12)), replace=False)
            got = t.get_rows(ids)
            if not np.array_equal(got, vals[ids]):
                errors.append((seed, ids))

    ths = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in ths)
    assert not errors, errors[:3]


def test_coalesced_fetch_streams_chunked(ranks):
    tconfig.set_flag("get_chunk_rows", 4)
    rows, cols = 40, 3
    vals = _values(rows, cols, seed=5)
    t, t2 = _pair(ranks, rows, cols, "chk", get_window_ms=5.0)
    t.set_rows(np.arange(rows), vals)
    ids = np.arange(39, 1, -1)   # both owners, rank 1's part > 4 rows
    np.testing.assert_array_equal(t.get_rows(ids), vals[ids])
    assert t2._shard.stats()["get_chunks"] > 0


def test_dead_owner_fails_the_waiters(ranks):
    t, _ = _pair(ranks, 8, 2, "dd", get_window_ms=5.0)
    t.get_rows([6])
    ranks[1].close()
    with pytest.raises(tsvc.PSError):
        t.get_rows([5, 6])
    # the flight was dropped: the local owner still serves
    np.testing.assert_array_equal(t.get_rows([1]), np.zeros((1, 2)))


def test_port_get_window_reads_a_jax_shard(tmp_path):
    rdv = str(tmp_path / "mixed")
    tctx = tsvc.PSContext(0, 2, tsvc.PSService(0, 2,
                                               tsvc.FileRendezvous(rdv)),
                          device="cpu")
    jctx = jsvc.PSContext(1, 2, jsvc.PSService(1, 2,
                                               jsvc.FileRendezvous(rdv)))
    try:
        rows, cols = 20, 4
        vals = _values(rows, cols, seed=6)
        tt = ttables.AsyncMatrixTable(rows, cols, name="mg", ctx=tctx,
                                      get_window_ms=5.0)
        jtables.AsyncMatrixTable(rows, cols, name="mg", ctx=jctx)
        tt.set_rows(np.arange(rows), vals)
        ids = np.array([19, 3, 12, 12, 0])
        np.testing.assert_array_equal(tt.get_rows(ids), vals[ids])
    finally:
        tctx.close()
        jctx.close()


def test_get_window_thread_exits_with_table(py_ranks, monkeypatch):
    monkeypatch.setattr(ttables._GetWindow, "_IDLE_WAIT_S", 0.05)
    t, t2 = _pair(py_ranks, 8, 2, "gx", get_window_ms=5.0)
    orig = t2._shard._gather_rows

    def slow(local, data=None):
        time.sleep(0.05)
        return orig(local, data=data)

    t2._shard._gather_rows = slow
    ths = [threading.Thread(target=t.get_rows, args=([5],))
           for _ in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=20)
    flusher = t._get_window._thread
    assert flusher is not None and flusher.is_alive()
    del t, ths
    gc.collect()
    deadline = time.monotonic() + 5.0
    while flusher.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not flusher.is_alive()
