"""Port parity, the client send window (``ps/tables._SendWindow``): the
port's window against window-off and against the JAX package's window,
mirroring ``tests/test_send_window.py``.

* windowed adds equal window-off adds bit for bit, for each updater
  (merged sub-ops: the default adder, SGD, momentum, AdaGrad; never
  merged: Adam) and each wire (none, bf16, 1bit), on the matrix and the
  hash-keyed tables;
* the port's windowed table equals the JAX package's windowed table on
  the same add sequence (bit for bit for the default updater; AdaGrad
  within the async plane's stated rtol 1e-5, atol 1e-6), and a port
  window ships its MSG_BATCH frames to a JAX shard in a mixed world;
* the window's contract: read-your-writes through the fences, the op
  bound, per-sub-op failures, owned value buffers, a flusher thread that
  exits with its table;
* the refusals that stay: ``ps_replay`` and ``tenant_add_qps``.

Two ranks in one process over a ``FileRendezvous`` (real loopback
sockets), on the CPU; ``ps_timeout`` a few seconds in both packages.
"""

import concurrent.futures as cf
import gc
import time
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu.utils.dashboard import Dashboard as JDashboard
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.ps import wire as twire
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard

ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
# stateful updaters on the async shards, card or CPU against JAX: the
# async plane's stated bound (ROADMAP C.4)
STATEFUL_RTOL, STATEFUL_ATOL = 1e-5, 1e-6
HUGE_MS = 60_000.0   # a window that only the fences and bounds close


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
def jranks(tmp_path):
    rdv = jsvc.FileRendezvous(str(tmp_path / "jrdv"))
    ctxs = [jsvc.PSContext(r, 2, jsvc.PSService(r, 2, rdv))
            for r in range(2)]
    yield ctxs
    for c in ctxs:
        c.close()


def _pair(mod, ctxs, *args, **kw):
    """The table on rank 0 (the client) and its peer shard on rank 1."""
    kw1 = {k: v for k, v in kw.items() if k != "send_window_ms"}
    return (getattr(mod, args[0])(*args[1:], ctx=ctxs[0], **kw),
            getattr(mod, args[0])(*args[1:], ctx=ctxs[1], **kw1))


def _add_sequence(seed: int, rows: int, cols: int, n: int = 40):
    """Small adds over both shards: disjoint runs (which merge), repeats
    of one row (which cannot), several AddOptions."""
    rng = np.random.default_rng(seed)
    seq = []
    for i in range(n):
        k = int(rng.integers(1, 5)) if i % 5 else 1
        ids = (rng.choice(rows, k, replace=False) if i % 5
               else np.full(1, i % rows))
        vals = rng.normal(size=(k, cols)).astype(np.float32)
        seq.append((ids, vals, AddOption(worker_id=i % 2,
                                         learning_rate=0.1 + 0.1 * (i % 3),
                                         rho=0.1)))
    return seq


def _drive(table, seq, get_every: int = 0):
    """Issue ``seq`` as async adds; with ``get_every`` a full get every so
    often (a fence mid-window). Returns the gets and the final table."""
    gets = []
    for i, (ids, vals, opt) in enumerate(seq):
        table.add_rows_async(ids, vals, opt)
        if get_every and i % get_every == get_every - 1:
            gets.append(table.get_rows(np.arange(table.num_row)))
    table.flush()
    gets.append(table.get_rows(np.arange(table.num_row)))
    return gets


# ---------------------------------------------------------------------- #
# windowed == window-off, bit for bit
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad", "adam"])
@pytest.mark.parametrize("wire", ["none", "bf16", "1bit"])
def test_windowed_equals_window_off(ranks, updater, wire):
    rows, cols = 16, 3
    seq = _add_sequence(3, rows, cols)
    out = {}
    for label, wm in (("on", HUGE_MS), ("off", 0.0)):
        t, _peer = _pair(ttables, ranks, "AsyncMatrixTable", rows, cols,
                         updater=updater, wire=wire, name=f"we_{label}",
                         send_window_ms=wm)
        assert (t._window is not None) == (label == "on")
        out[label] = _drive(t, seq, get_every=7)
    assert len(out["on"]) == len(out["off"]) == 6
    for a, b in zip(out["on"], out["off"]):
        np.testing.assert_array_equal(a, b)
    assert np.abs(out["on"][-1]).max() > 0


@pytest.mark.parametrize("updater", ["default", "adagrad"])
def test_windowed_merges_only_when_exact(ranks, updater):
    """Disjoint single-row adds to one owner merge into one sub-op (rows
    counted in ``merged_rows``); a repeated row starts a new sub-op, so
    one frame carries several (MSG_BATCH) and the shard applies them as
    waves."""
    t, peer = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2,
                    updater=updater, name="mg", send_window_ms=HUGE_MS)
    one = np.ones((1, 2), np.float32)
    for row in (4, 5, 6, 5):   # rank 1's rows: 4, 5, 6 merge; 5 conflicts
        t.add_rows_async([row], one)
    t.flush()
    snap = TDashboard.snapshot()
    assert snap["table[mg].add_rows.merged_rows"].count == 2
    assert snap["table[mg].add_rows.flushes"].count == 1
    st = peer._shard.stats()
    assert st["adds"] == 2 and st["applies"] == 2


def test_kv_window_parity(ranks):
    """The hash-keyed table windows too: keyed adds land bit for bit as on
    the window-off table."""
    rng = np.random.default_rng(11)
    tw, _ = _pair(ttables, ranks, "AsyncSparseKVTable", 3, name="kvw",
                  send_window_ms=HUGE_MS)
    tr, _ = _pair(ttables, ranks, "AsyncSparseKVTable", 3, name="kvr")
    keys = np.unique(rng.integers(0, 5000, 40))
    for i in range(30):
        k = rng.choice(keys, rng.integers(1, 6), replace=False)
        v = rng.normal(size=(k.size, 3)).astype(np.float32)
        tw.add_rows_async(k, v)
        tr.add_rows_async(k, v)
        if i % 9 == 0:
            np.testing.assert_array_equal(tw.get_rows(keys),
                                          tr.get_rows(keys))
    tw.flush()
    tr.flush()
    np.testing.assert_array_equal(tw.get_rows(keys), tr.get_rows(keys))


# ---------------------------------------------------------------------- #
# the port's window against the JAX package's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("updater", ["default", "adagrad"])
def test_port_window_matches_jax_window(ranks, jranks, updater):
    rows, cols = 16, 3
    seq = _add_sequence(7, rows, cols)
    jt, _ = _pair(jtables, jranks, "AsyncMatrixTable", rows, cols,
                  updater=updater, name=f"jw_{updater}",
                  send_window_ms=HUGE_MS)
    tt, _ = _pair(ttables, ranks, "AsyncMatrixTable", rows, cols,
                  updater=updater, name=f"tw_{updater}",
                  send_window_ms=HUGE_MS)
    jopts = [(i, v, JAddOption(**o._asdict())) for i, v, o in seq]
    jg, tg = _drive(jt, jopts, get_every=9), _drive(tt, seq, get_every=9)
    assert len(jg) == len(tg) == 5
    for a, b in zip(tg, jg):
        if updater == "default":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=STATEFUL_RTOL,
                                       atol=STATEFUL_ATOL)
    # both windows merged the same rows and shipped the same frames
    for k in ("merged_rows", "flushes", "windowed"):
        assert (TDashboard.get(f"table[tw_{updater}].add_rows.{k}").count
                == JDashboard.get(f"table[jw_{updater}].add_rows.{k}")
                .count), k
    merged = TDashboard.get(f"table[tw_{updater}].add_rows.merged_rows")
    assert (merged.count > 0) == (updater == "default")


def test_port_window_batches_reach_a_jax_shard(tmp_path):
    """A mixed world: the port's client (rank 0, window on) ships
    MSG_BATCH frames to a JAX rank's shard, which applies them exactly."""
    rdv = str(tmp_path / "mixed")
    tctx = tsvc.PSContext(0, 2, tsvc.PSService(0, 2,
                                               tsvc.FileRendezvous(rdv)),
                          device="cpu")
    jctx = jsvc.PSContext(1, 2, jsvc.PSService(1, 2,
                                               jsvc.FileRendezvous(rdv)))
    try:
        rows, cols = 16, 3
        tt = ttables.AsyncMatrixTable(rows, cols, name="mxw", ctx=tctx,
                                      send_window_ms=HUGE_MS)
        jt = jtables.AsyncMatrixTable(rows, cols, name="mxw", ctx=jctx)
        model = np.zeros((rows, cols), np.float32)
        for ids, vals, opt in _add_sequence(9, rows, cols):
            tt.add_rows_async(ids, vals, opt)
            model[ids] += vals
        tt.flush()
        np.testing.assert_array_equal(tt.get_rows(np.arange(rows)), model)
        np.testing.assert_array_equal(jt.get_rows(np.arange(rows)), model)
        # one frame for each owner, the JAX one holding several sub-ops
        assert TDashboard.get("table[mxw].add_rows.flushes").count == 2
        assert jt._shard.stat_adds > 1
    finally:
        tctx.close()
        jctx.close()


# ---------------------------------------------------------------------- #
# the window's contract (tests/test_send_window.py)
# ---------------------------------------------------------------------- #
def test_window_off_by_default(ranks):
    t = ttables.AsyncMatrixTable(8, 2, name="nw", ctx=ranks[0])
    assert t._window is None and t._get_window is None


def test_flag_installs_window(ranks):
    tconfig.set_flag("batch_window_ms", 1.5)
    t = ttables.AsyncMatrixTable(8, 2, name="fw", ctx=ranks[0])
    assert t._window is not None
    assert t._window.window_s == pytest.approx(1.5e-3)
    # the table's own value beats the flag, including turning it off
    t2 = ttables.AsyncMatrixTable(8, 2, name="fw2", send_window_ms=0.0,
                                  ctx=ranks[0])
    assert t2._window is None


def test_windowed_adds_read_your_writes(ranks):
    """A get right after windowed adds observes them: the fence ships the
    queue before the get's own frame, with no flush by the caller."""
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 16, 3, name="ryw",
                 send_window_ms=HUGE_MS)
    ones = np.ones((1, 3), np.float32)
    for row in (1, 9, 9, 15):   # both shards, a duplicate
        t.add_rows_async([row], ones)
    expect = np.zeros((16, 3), np.float32)
    for row in (1, 9, 9, 15):
        expect[row] += 1.0
    np.testing.assert_array_equal(t.get_rows(np.arange(16)), expect)
    # the whole-table read fences too
    t.add_rows_async([2], ones)
    expect[2] += 1.0
    np.testing.assert_array_equal(t.get(), expect)


def test_window_counters_surface_in_dashboard(ranks):
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="wc",
                 send_window_ms=HUGE_MS)
    names = [f"table[wc].add_rows.{k}"
             for k in ("windowed", "flushes", "merged_rows")]
    snap = TDashboard.snapshot()
    assert all(n in snap for n in names)   # registered eagerly
    t.add_rows_async([2], np.ones((1, 2), np.float32))
    t.add_rows_async([3], np.ones((1, 2), np.float32))
    t.flush()
    snap = TDashboard.snapshot()
    assert snap["table[wc].add_rows.windowed"].count == 2
    assert snap["table[wc].add_rows.flushes"].count == 1
    assert snap["table[wc].add_rows.merged_rows"].count == 1


def test_window_op_bound_ships_inline(ranks):
    tconfig.set_flag("batch_window_ops", 4)
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="ob",
                 send_window_ms=HUGE_MS)
    flushes = TDashboard.get("table[ob].add_rows.flushes")
    for row in range(4):   # rank 0 owns rows [0, 4)
        t.add_rows_async([row], np.ones((1, 2), np.float32))
    assert flushes.count == 1
    t.flush()


def test_window_byte_bound_ships_inline(ranks):
    tconfig.set_flag("batch_window_bytes", 64)
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="bb",
                 send_window_ms=HUGE_MS)
    flushes = TDashboard.get("table[bb].add_rows.flushes")
    t.add_rows_async([0, 1], np.ones((2, 2), np.float32))   # 32 bytes
    assert flushes.count == 0
    t.add_rows_async([2, 3], np.ones((2, 2), np.float32))   # 64: ships
    assert flushes.count == 1
    t.flush()


def test_window_timer_ships_without_a_fence(ranks):
    t, peer = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="tm",
                    send_window_ms=20.0)
    t.add_rows_async([5], np.full((1, 2), 3.0, np.float32))
    deadline = time.monotonic() + 5.0
    while peer._shard.stat_adds == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert peer._shard.stat_adds == 1
    np.testing.assert_array_equal(peer.get_rows([5]), [[3.0, 3.0]])


def test_wait_completes_windowed_add(ranks):
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="ww",
                 send_window_ms=HUGE_MS)
    mid = t.add_rows_async([5], np.ones((1, 2), np.float32))
    t.wait(mid)
    assert t.get_rows([5])[0, 0] == 1.0


def test_batch_partial_failure_reports_per_subop(ranks):
    """A sub-op failing mid-batch fails ONLY its own future; the deltas
    that applied are never reported lost."""
    t, t1 = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="pf",
                  send_window_ms=HUGE_MS)
    shard = t1._shard   # rank 1 owns rows [4, 8)
    orig = type(shard)._apply_rows

    def boom(self, local, vals, opt):
        if (5 - self.lo) in np.asarray(local):
            raise RuntimeError("synthetic apply failure")
        return orig(self, local, vals, opt)

    shard._apply_rows = boom.__get__(shard)
    ones = np.ones((1, 2), np.float32)
    m_ok1 = t.add_rows_async([4], ones)
    m_bad = t.add_rows_async([4, 5], np.ones((2, 2), np.float32))
    m_ok2 = t.add_rows_async([4], ones)
    t.wait(m_ok1)
    t.wait(m_ok2)
    with pytest.raises(tsvc.PSError, match="batched add failed"):
        t.wait(m_bad)
    shard._apply_rows = orig.__get__(shard)
    np.testing.assert_array_equal(t.get_rows([4, 5]),
                                  np.array([[2.0, 2.0], [0.0, 0.0]],
                                           np.float32))


def test_windowed_add_failure_surfaces_at_flush(ranks):
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="wf",
                 send_window_ms=HUGE_MS)
    tconfig.set_flag("ps_timeout", 4.0)
    ranks[1].close()   # rank 1 (rows [4, 8)) goes away
    t.add_rows_async([6], np.ones((1, 2), np.float32))
    with pytest.raises((tsvc.PSPeerError, cf.TimeoutError)):
        t.flush()


def test_window_ops_knob_clamped_to_wire_bound(ranks):
    tconfig.set_flag("batch_window_ops", twire.MAX_BATCH_OPS * 2)
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="clamp",
                 send_window_ms=HUGE_MS)
    assert t._window.max_ops == twire.MAX_BATCH_OPS
    for _ in range(40):   # one row again and again: nothing merges
        t.add_rows_async([0], np.ones((1, 2), np.float32))
    t.flush()
    assert t.get_rows([0])[0, 0] == 40.0


def test_windowed_add_owns_values_buffer(ranks):
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="alias",
                 send_window_ms=HUGE_MS)
    buf = np.ones((1, 2), np.float32)
    t.add_rows_async([1], buf)
    buf[:] = 100.0            # the caller reuses its scratch buffer
    t.add_rows_async([2], buf)
    buf[:] = -5.0
    np.testing.assert_array_equal(
        t.get_rows([1, 2]), np.array([[1.0, 1.0], [100.0, 100.0]],
                                     np.float32))


def test_whole_table_ops_fence_the_window(ranks):
    """add (whole table), set_rows and store each ship the queued row
    adds first, so they land in program order."""
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="wt",
                 send_window_ms=HUGE_MS)
    t.add_rows_async([1, 6], np.ones((2, 2), np.float32))
    t.add(np.full((8, 2), 2.0, np.float32))
    t.add_rows_async([6], np.ones((1, 2), np.float32))
    t.set_rows([1], np.full((1, 2), 7.0, np.float32))
    want = np.full((8, 2), 2.0, np.float32)
    want[1] = 7.0
    want[6] = 4.0
    np.testing.assert_array_equal(t.get(), want)


def test_flusher_thread_exits_with_table(ranks, monkeypatch):
    """The flusher holds its window only by weakref: once the table is
    garbage the thread exits at its next bounded wakeup."""
    monkeypatch.setattr(ttables._SendWindow, "_IDLE_WAIT_S", 0.05)
    t, _ = _pair(ttables, ranks, "AsyncMatrixTable", 8, 2, name="thx",
                 send_window_ms=HUGE_MS)
    t.add_rows_async([1], np.ones((1, 2), np.float32))
    t.flush()
    th = t._window._thread
    assert th is not None and th.is_alive()
    del t
    gc.collect()
    deadline = time.monotonic() + 5.0
    while th.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not th.is_alive()


# ---------------------------------------------------------------------- #
# what stays refused
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["matrix", "kv"])
def test_tenant_add_budget_raises_naming_its_item(ranks, kind):
    tconfig.set_flag("tenant_add_qps", 10.0)
    with pytest.raises(NotImplementedError, match="Telemetry and tools"):
        if kind == "kv":
            ttables.AsyncSparseKVTable(2, name="tq", ctx=ranks[0],
                                       send_window_ms=1.0)
        else:
            ttables.AsyncMatrixTable(4, 2, name="tq", ctx=ranks[0],
                                     send_window_ms=1.0)
    assert tsvc.TELEMETRY_ITEM in ROADMAP


def test_replay_still_raises_with_a_window(ranks):
    tconfig.set_flag("ps_replay", True)
    with pytest.raises(NotImplementedError, match="failover, faults and "
                                                  "replay"):
        ttables.AsyncMatrixTable(4, 2, name="rw", ctx=ranks[0],
                                 send_window_ms=1.0)
