"""The PS half of the mesh data plane on the port (``ps/spmd.py``):
process-coalesced fan-out routing, multi-owner super-frames and stacked
shard groups, class by class as ``tests/test_spmd_plane.py`` holds the JAX
package, on the CPU (``device="cpu"``).

Every port-against-port check is bit-exact: with the plane armed, a
result equals the 1-shard classic world's on the same stream. Against the
JAX package, a 4-shard stacked world of each package runs the same seeded
stream: the default updater and SGD match bit for bit, the stateful
updaters within ``STATEFUL_RTOL``/``STATEFUL_ATOL`` (their sqrt and divide
differ by a few ulp between XLA's CPU backend and torch).
"""

import threading

import numpy as np
import pytest
import torch

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import spmd as jspmd
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.ps import wire as jwire
from multiverso_tpu.updaters import AdaGradUpdater as JAdaGrad
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.ps import spmd
from multiverso_tpu_torch.ps import wire as wire_mod
from multiverso_tpu_torch.ps.service import (MSG_ADD_FULL, MSG_ADD_ROWS,
                                             MSG_GET_ROWS, MSG_MULTI,
                                             MSG_REPLY_ERR, MSG_REPLY_OK,
                                             MSG_SET_STATE, FileRendezvous,
                                             PSContext, PSError, PSPeerError,
                                             PSService)
from multiverso_tpu_torch.ps.shard import RowShard
from multiverso_tpu_torch.ps.tables import AsyncMatrixTable
from multiverso_tpu_torch.updaters import (ROW_LOCAL_STATE, AdaGradUpdater,
                                           AddOption, get_updater)
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import Dashboard

STATEFUL_RTOL = 1e-5
STATEFUL_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_plane():
    """The port's flags and colocation registry, reset around each test
    (the JAX side's flags are the repository conftest's; its registry is
    reset here too, for the cross-package worlds)."""
    for cfg in (config, jconfig):
        cfg.set_flag("ps_timeout", 5.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    yield
    config.reset_flags()
    spmd.reset_registry()
    jspmd.reset_registry()
    Dashboard.reset()


def _world(tmp_path, n, sub="rdv"):
    rdv = FileRendezvous(str(tmp_path / sub))
    return [PSContext(r, n, PSService(r, n, rdv), device="cpu")
            for r in range(n)]


def _close(ctxs):
    for c in ctxs:
        c.close()


def _stream(rows, dim, steps=12, seed=7, sort_ids=True):
    """A deterministic add stream (mixed batch shapes, spanning every
    shard)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        k = int(rng.integers(3, rows // 2))
        ids = rng.choice(rows, size=k, replace=False)
        if sort_ids:
            ids = np.sort(ids)
        out.append((ids, rng.normal(size=(k, dim)).astype(np.float32)))
    return out


def _drive(table, rows, dim, steps=12, seed=7, sort_ids=True):
    for ids, vals in _stream(rows, dim, steps, seed, sort_ids):
        table.add_rows(ids, vals)


def _oracle(tmp_path, rows, dim, updater=None, steps=12, seed=7,
            sort_ids=True, sub="oracle"):
    """The 1-shard classic world's final table for the same stream."""
    config.set_flag("ps_fanout", False)
    config.set_flag("ps_spmd_stack", False)
    ctxs = _world(tmp_path, 1, sub=sub)
    t = AsyncMatrixTable(rows, dim, name="oracle_t", updater=updater,
                         ctx=ctxs[0])
    _drive(t, rows, dim, steps=steps, seed=seed, sort_ids=sort_ids)
    out = t.get_rows(np.arange(rows))
    _close(ctxs)
    return out


class TestRegistry:
    def test_register_and_colocated_ranks(self, tmp_path):
        ctxs = _world(tmp_path, 3)
        key = ctxs[0].service._proc_key
        assert key == FileRendezvous(str(tmp_path / "rdv")).identity
        assert spmd.colocated_ranks(key) == [0, 1, 2]
        assert spmd.colocated_service(key, 1) is ctxs[1].service
        ctxs[1].close()
        # a closed service leaves the registry (its death is observable)
        assert spmd.colocated_service(key, 1) is None
        assert spmd.colocated_ranks(key) == [0, 2]
        _close([ctxs[0], ctxs[2]])

    def test_closed_service_is_pruned(self, tmp_path):
        ctxs = _world(tmp_path, 2)
        key = ctxs[0].service._proc_key
        ctxs[1].service._closed = True   # a crash-shaped teardown
        assert spmd.colocated_ranks(key) == [0]
        assert spmd.colocated_service(key, 1) is None
        assert (key, 1) not in spmd._SERVICES
        ctxs[1].service._closed = False
        _close(ctxs)

    def test_deferred_publish_registers_at_publish(self, tmp_path):
        rdv = FileRendezvous(str(tmp_path / "dp"))
        svc = PSService(0, 2, rdv, defer_publish=True)
        assert spmd.colocated_ranks(svc._proc_key) == []
        svc.publish_addr()
        assert spmd.colocated_service(svc._proc_key, 0) is svc
        svc.close()

    def test_worlds_never_cross_route(self, tmp_path):
        """Two independent in-process worlds (different rendezvous) never
        see each other: same ranks, different keys."""
        config.set_flag("ps_fanout", True)
        a = _world(tmp_path, 2, sub="a")
        b = _world(tmp_path, 2, sub="b")
        ka = a[0].service._proc_key
        kb = b[0].service._proc_key
        assert ka != kb
        assert spmd.colocated_service(ka, 1) is a[1].service
        assert spmd.colocated_service(kb, 1) is b[1].service
        ta = [AsyncMatrixTable(8, 2, name="x", ctx=c) for c in a]
        tb = [AsyncMatrixTable(8, 2, name="x", ctx=c) for c in b]
        assert ta[0]._routed_set == {1} and tb[0]._routed_set == {1}
        ta[0].add_rows(np.arange(8), np.ones((8, 2), np.float32))
        np.testing.assert_array_equal(tb[1].get_rows(np.arange(8)),
                                      np.zeros((8, 2), np.float32))
        np.testing.assert_array_equal(ta[1].get_rows(np.arange(8)),
                                      np.ones((8, 2), np.float32))
        _close(a)
        _close(b)


    def test_fanout_is_read_once_per_service(self, tmp_path):
        """A world keeps the ps_fanout value its services were built
        with: flipping the flag later changes neither the routing, nor
        the inline dispatch, nor a new table's copy decision, so one
        owner's ops never split between the executor and inline
        dispatch."""
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 2, sub="once")
        config.set_flag("ps_fanout", False)
        tabs = [AsyncMatrixTable(8, 2, name="once_t", ctx=c) for c in ctxs]
        assert all(c.service._fanout for c in ctxs)
        assert tabs[0]._inline and tabs[0]._routed_set == {1}
        svc0 = ctxs[0].service
        assert svc0._route(1) == (ctxs[1].service, None)
        # inline: the future is done on return, no executor hop
        fut = svc0._dispatch_inproc(ctxs[1].service, MSG_GET_ROWS,
                                    {"table": "once_t"}, [np.arange(4, 8)],
                                    None)
        assert fut.done()
        tabs[0].add_rows(np.arange(8), np.ones((8, 2), np.float32))
        np.testing.assert_array_equal(tabs[1].get_rows(np.arange(8)),
                                      np.ones((8, 2), np.float32))
        _close(ctxs)
        # and the other way: a world built with the flag off never routes
        other = _world(tmp_path, 2, sub="once_off")
        config.set_flag("ps_fanout", True)
        t2 = AsyncMatrixTable(8, 2, name="once_u", ctx=other[0])
        AsyncMatrixTable(8, 2, name="once_u", ctx=other[1])
        assert not other[0].service._fanout
        assert not t2._inline and t2._routed_set == frozenset()
        assert other[0].service._route(1) == (None, None)
        _close(other)


class TestOwnerSlices:
    """The vectorized partition: every shape partitions as the per-owner
    mask reference does."""

    @pytest.fixture()
    def table(self, tmp_path):
        ctxs = _world(tmp_path, 8)
        t = AsyncMatrixTable(100_000, 4, name="part", ctx=ctxs[0])
        yield t
        _close(ctxs)

    def _ref(self, t, uids):
        owners = uids // t._rows_per
        return {int(r): uids[owners == r].tolist()
                for r in np.unique(owners)}

    @pytest.mark.parametrize("make", [
        lambda rng: np.unique(rng.integers(0, 100_000, 5000)),
        lambda rng: rng.permutation(
            np.unique(rng.integers(0, 100_000, 5000))),
        lambda rng: (np.arange(256) * 390 + 3) % 100_000,
        lambda rng: np.array([7]),
        lambda rng: np.array([12_500]),       # single non-zero owner
        lambda rng: np.array([0, 99_999]),    # extremes
    ])
    def test_matches_mask_reference(self, table, make):
        uids = np.asarray(make(np.random.default_rng(3)), np.int64)
        got = {r: uids[ix].tolist()
               for r, ix in table._owner_slices(uids)}
        assert got == self._ref(table, uids)

    def test_empty(self, table):
        assert table._owner_slices(np.array([], np.int64)) == []

    def test_sorted_batches_get_zero_copy_slices(self, table):
        uids = np.unique(np.random.default_rng(0).integers(0, 100_000,
                                                           4000))
        assert all(isinstance(ix, slice)
                   for _r, ix in table._owner_slices(uids))


class TestFanoutRouting:
    """Flag ps_fanout: in-process routing and multi-owner super-frames,
    bit-identical to the classic plane."""

    @pytest.mark.parametrize("plane", ["native", "python"])
    def test_fanout_parity_four_shards(self, tmp_path, plane):
        rows, dim = 80, 6
        want = _oracle(tmp_path, rows, dim)
        config.set_flag("ps_native", plane == "native")
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 4, sub="fan")
        tabs = [AsyncMatrixTable(rows, dim, name="fan_t", ctx=c)
                for c in ctxs]
        assert tabs[0]._fanout and tabs[0]._routed_set == {1, 2, 3}
        assert not tabs[0]._native_ok   # routing pins python ordering
        # a fan-out world registers nothing with the C++ server
        assert all(t._shard._native_ref is None for t in tabs)
        rng = np.random.default_rng(7)
        for step in range(12):
            k = int(rng.integers(3, rows // 2))
            ids = np.sort(rng.choice(rows, size=k, replace=False))
            vals = rng.normal(size=(k, dim)).astype(np.float32)
            tabs[step % 4].add_rows(ids, vals)
        got = tabs[1].get_rows(np.arange(rows))
        np.testing.assert_array_equal(got, want)
        # multi-owner get with caller-order duplicate ids and out=
        ids = np.array([71, 3, 25, 3, 60, 71])
        out = np.empty((ids.size, dim), np.float32)
        res = tabs[2].get_rows(ids, out=out)
        np.testing.assert_array_equal(res, want[ids])
        assert res is out
        np.testing.assert_array_equal(tabs[3].get(), want)
        _close(ctxs)

    def test_fanout_unsorted_caller_order_ids(self, tmp_path):
        """_prep's no-dup fast path keeps caller order: the fan-out
        partition must still route and reassemble exactly."""
        rows, dim = 64, 5
        want = _oracle(tmp_path, rows, dim, sort_ids=False)
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 4, sub="uns")
        tabs = [AsyncMatrixTable(rows, dim, name="uns_t", ctx=c)
                for c in ctxs]
        _drive(tabs[0], rows, dim, sort_ids=False)
        got = tabs[3].get_rows(np.arange(rows))
        np.testing.assert_array_equal(got, want)
        _close(ctxs)

    def test_read_your_writes_inline(self, tmp_path):
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 4, sub="ryw")
        tabs = [AsyncMatrixTable(40, 3, name="ryw_t", ctx=c)
                for c in ctxs]
        ids = np.arange(40)
        ones = np.ones((40, 3), np.float32)
        for k in range(5):
            tabs[0].add_rows_async(ids, ones)
            got = tabs[0].get_rows(ids)
            np.testing.assert_array_equal(
                got, np.full((40, 3), float(k + 1), np.float32))
        _close(ctxs)

    def test_routed_rank_death_fails_fast_and_fires_hooks(self,
                                                         tmp_path):
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 2, sub="die")
        tabs = [AsyncMatrixTable(40, 3, name="die_t", ctx=c)
                for c in ctxs]
        deaths = []
        ctxs[0].service.add_death_hook(deaths.append)
        ids = np.arange(40)
        tabs[0].add_rows(ids, np.ones((40, 3), np.float32))
        ctxs[1].close()
        with pytest.raises(PSPeerError):
            # rows 20..39 belong to the dead rank 1
            tabs[0].get_rows(np.arange(20, 40))
        assert deaths == [1]
        # a MULTI-owner op spanning the dead rank keeps the TYPED peer
        # error through the super-frame, and the hook fired once
        with pytest.raises(PSPeerError):
            tabs[0].get_rows(np.arange(40))
        assert deaths == [1]
        # rank 0's own shard keeps serving
        got = tabs[0].get_rows(np.arange(0, 20))
        np.testing.assert_array_equal(got,
                                      np.ones((20, 3), np.float32))
        ctxs[0].close()

    def test_respawned_rank_routes_again(self, tmp_path):
        """A fresh incarnation of a dead routed rank clears its tombstone:
        routing resumes, and its second death fires the hooks again."""
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 2, sub="re")
        tabs = [AsyncMatrixTable(40, 3, name="re_t", ctx=c) for c in ctxs]
        deaths = []
        ctxs[0].service.add_death_hook(deaths.append)
        tabs[0].add_rows(np.arange(40), np.ones((40, 3), np.float32))
        ctxs[1].close()
        with pytest.raises(PSPeerError):
            tabs[0].get_rows(np.arange(20, 40))
        fresh = PSContext(1, 2, PSService(1, 2, FileRendezvous(
            str(tmp_path / "re"))), device="cpu")
        AsyncMatrixTable(40, 3, name="re_t", ctx=fresh)
        np.testing.assert_array_equal(tabs[0].get_rows(np.arange(20, 40)),
                                      np.zeros((20, 3), np.float32))
        assert 1 not in ctxs[0].service._dead_ranks
        fresh.close()
        with pytest.raises(PSPeerError):
            tabs[0].get_rows(np.arange(40))
        assert deaths == [1, 1]
        ctxs[0].close()

    def test_multi_local_per_sub_error_independence(self, tmp_path):
        config.set_flag("ps_fanout", True)
        ctxs = _world(tmp_path, 2, sub="err")
        tabs = [AsyncMatrixTable(40, 3, name="err_t", ctx=c)
                for c in ctxs]
        ones = np.ones((3, 3), np.float32)
        subs = [
            (MSG_ADD_ROWS,
             {"table": "err_t", "opt": {}, "ow": 0},
             [np.array([1, 2, 3]), ones]),
            (MSG_ADD_ROWS,
             {"table": "err_t", "opt": {}, "ow": 1},
             [np.array([999, 1000, 1001]), ones]),   # out of range
        ]
        futs = ctxs[0].service.multi_local(subs)
        futs[0].result(timeout=10)
        with pytest.raises(PSError):
            futs[1].result(timeout=10)
        got = tabs[0].get_rows(np.array([1, 2, 3]))
        np.testing.assert_array_equal(got, ones)
        _close(ctxs)

    def test_flags_off_keep_the_socket_path(self, tmp_path):
        """With ps_fanout off nothing routes: a remote rank's request
        crosses the socket, and tables see no routed ranks."""
        ctxs = _world(tmp_path, 2, sub="off")
        tabs = [AsyncMatrixTable(40, 3, name="off_t", ctx=c)
                for c in ctxs]
        assert tabs[0]._routed_set == frozenset() and not tabs[0]._fanout
        assert ctxs[0].service._route(1) == (None, None)
        tabs[0].add_rows(np.arange(40), np.ones((40, 3), np.float32))
        assert ctxs[0].service._peers   # a socket peer was opened
        assert tabs[0]._shard._plane is None
        _close(ctxs)


class TestWireMulti:
    """MSG_MULTI over a REAL socket (the cross-process form): the native
    server punts it like MSG_BATCH; the Python server serves it in
    _serve_conn. Sub-ops resolve by owner meta."""

    @pytest.mark.parametrize("plane", ["native", "python"])
    def test_super_frame_over_socket(self, tmp_path, plane):
        config.set_flag("ps_native", plane == "native")
        ctxs = _world(tmp_path, 2, sub="wire")
        [AsyncMatrixTable(40, 4, name="wire_t", ctx=c) for c in ctxs]
        ids = np.array([25, 30])          # rank 1's rows
        vals = np.ones((2, 4), np.float32)
        blobs = [wire_mod.encode(
            MSG_ADD_ROWS, 0,
            {"table": "wire_t", "opt": {},
             wire_mod.OWNER_META_KEY: 1}, [ids, vals]),
            wire_mod.encode(
            MSG_GET_ROWS, 1,
            {"table": "wire_t", "wire": "none",
             wire_mod.OWNER_META_KEY: 1}, [ids])]
        # rank 0 -> rank 1 over the real socket (no routing armed)
        fut = ctxs[0].service.request(1, MSG_MULTI, {"n": 2},
                                      wire_mod.pack_batch(blobs))
        rmeta, rarrays = fut.result(timeout=20)
        assert rmeta["n"] == 2
        subs = wire_mod.unpack_batch(rarrays)
        assert len(subs) == 2
        assert subs[0][0] != MSG_REPLY_ERR
        rows = np.asarray(subs[1][2][0], np.float32).reshape(2, 4)
        np.testing.assert_array_equal(rows, vals)
        _close(ctxs)

    @pytest.mark.parametrize("sender", ["jax", "torch"])
    def test_super_frame_crosses_packages(self, tmp_path, sender):
        """A JAX rank and a port rank in one rendezvous directory: each
        sends the other a MSG_MULTI over the socket, with sub-ops owned by
        the receiver, and reads its inner replies."""
        rdv_dir = str(tmp_path / "mixed")
        jctx = jsvc.PSContext(0, 2, jsvc.PSService(
            0, 2, jsvc.FileRendezvous(rdv_dir)))
        tctx = PSContext(1, 2, PSService(1, 2, FileRendezvous(rdv_dir)),
                         device="cpu")
        try:
            jtables.AsyncMatrixTable(20, 3, name="xm", ctx=jctx)
            AsyncMatrixTable(20, 3, name="xm", ctx=tctx)
            if sender == "jax":
                svc, dst, ids, wmod = jctx.service, 1, np.array([12, 17]), \
                    jwire
            else:
                svc, dst, ids, wmod = tctx.service, 0, np.array([2, 7]), \
                    wire_mod
            vals = np.full((2, 3), 2.5, np.float32)
            blobs = [wmod.encode(MSG_ADD_ROWS, 0,
                                 {"table": "xm", "opt": {},
                                  wmod.OWNER_META_KEY: dst}, [ids, vals]),
                     wmod.encode(MSG_ADD_ROWS, 1,
                                 {"table": "xm", "opt": {},
                                  wmod.OWNER_META_KEY: dst},
                                 [np.array([999]), vals[:1]]),
                     wmod.encode(MSG_GET_ROWS, 2,
                                 {"table": "xm", "wire": "none",
                                  wmod.OWNER_META_KEY: dst}, [ids])]
            rmeta, rarrays = svc.request(dst, MSG_MULTI, {"n": 3},
                                         wmod.pack_batch(blobs)).result(20)
            assert rmeta["n"] == 3
            replies = wmod.unpack_batch(rarrays)
            assert [r[0] for r in replies] == [MSG_REPLY_OK, MSG_REPLY_ERR,
                                               MSG_REPLY_OK]
            np.testing.assert_array_equal(
                np.asarray(replies[2][2][0], np.float32).reshape(2, 3),
                vals)
        finally:
            tctx.close()
            jctx.close()


def _stack_world(tmp_path, n, rows, dim, updater="adagrad", sub="st",
                 name="st_t"):
    config.set_flag("ps_fanout", True)
    config.set_flag("ps_spmd_stack", True)
    ctxs = _world(tmp_path, n, sub=sub)
    tabs = [AsyncMatrixTable(rows, dim, name=name, updater=updater,
                             ctx=c) for c in ctxs]
    return ctxs, tabs


def _shards(updater, n, rows, dim, seed=3):
    """``n`` RowShards of a ``rows x dim`` table on the CPU, rows split as
    the async tables split them, with random rows."""
    per = -(-rows // n)
    init = np.random.default_rng(seed).normal(
        size=(rows, dim)).astype(np.float32)
    return [RowShard(r * per, min((r + 1) * per, rows), dim, np.float32,
                     updater, "sh", init=init[r * per:(r + 1) * per],
                     device="cpu")
            for r in range(n) if r * per < rows]


def _rows_of(shards):
    return np.concatenate([s._full_rows(s._data) for s in shards])


class TestMeshStack:
    """The stacked shard groups (flag ps_spmd_stack)."""

    @pytest.mark.parametrize("updater", ["adagrad", "momentum_sgd", "ftrl"])
    def test_grouped_parity_vs_oracle(self, tmp_path, updater):
        rows, dim = 96, 5
        want = _oracle(tmp_path, rows, dim, updater=updater)
        ctxs, tabs = _stack_world(tmp_path, 4, rows, dim,
                                  updater=updater)
        sh = tabs[0]._shard
        assert sh._plane is not None and sh._plane.active
        assert sh._plane.device == torch.device("cpu")
        for i, t in enumerate(tabs):
            assert t._shard._plane is sh._plane
            assert t._shard._plane_slot == i
        _drive(tabs[0], rows, dim)
        got = tabs[2].get_rows(np.arange(rows))
        np.testing.assert_array_equal(got, want)
        _close(ctxs)

    @pytest.mark.parametrize("updater", ["default", "sgd"])
    def test_linear_stack_parity(self, updater):
        """The plain adder and SGD group on the card only (on the CPU they
        are _np_mode); admitted by hand here, the stack takes the classic
        path's one signed index_add_ over the flat view, bit for bit."""
        rows, dim = 70, 4
        upd = get_updater(updater)
        classic = _shards(upd, 4, rows, dim)
        grouped = _shards(upd, 4, rows, dim)
        plane = spmd.MeshStack("lin")
        for s in grouped:
            plane.admit(s, None)
        assert plane.active and all(s._plane is plane for s in grouped)
        for ids, vals in _stream(rows, dim, seed=11):
            for owner in (classic, grouped):
                for s in owner:
                    m = (ids >= s.lo) & (ids < s.hi)
                    if m.any():
                        s.handle(MSG_ADD_ROWS, {"table": "sh"},
                                 [ids[m], vals[m]])
        np.testing.assert_array_equal(_rows_of(grouped), _rows_of(classic))

    def test_per_worker_adagrad_parity(self, tmp_path):
        """Per-worker AdaGrad's (W, R, C) leaf stacks as (W, S, R, C):
        adds from the clients of different ranks (worker_id = rank) equal
        the 1-shard classic world's."""
        rows, dim, n = 64, 4, 4
        stream = _stream(rows, dim, seed=5)

        def run(tabs):
            for step, (ids, vals) in enumerate(stream):
                tabs[step % len(tabs)].add_rows(
                    ids, vals, AddOption(worker_id=step % n,
                                         learning_rate=0.5, rho=0.2))
            return tabs[0].get_rows(np.arange(rows))

        octx = _world(tmp_path, 1, sub="pwo")
        want = run([AsyncMatrixTable(
            rows, dim, name="pw_o", ctx=octx[0],
            updater=AdaGradUpdater(num_workers=n, per_worker=True))])
        _close(octx)
        ctxs, tabs = _stack_world(
            tmp_path, n, rows, dim, sub="pw", name="pw_t",
            updater=AdaGradUpdater(num_workers=n, per_worker=True))
        plane = tabs[0]._shard._plane
        assert plane is not None and plane.active
        assert tuple(plane.ustate["g_sqr"].shape) == (n, n, 17, dim)
        got = run(tabs)
        np.testing.assert_array_equal(got, want)
        _close(ctxs)

    def test_apply_grouped_splits_by_option(self):
        """One round whose shards carry different AddOptions: one updater
        call per distinct option, and the result equals the shards
        applied one after another."""
        rows, dim = 40, 3
        upd = AdaGradUpdater(num_workers=2, per_worker=True)
        classic = _shards(upd, 4, rows, dim)
        grouped = _shards(upd, 4, rows, dim)
        plane = spmd.MeshStack("opt")
        for s in grouped:
            plane.admit(s, None)
        opts = [AddOption(worker_id=0, learning_rate=0.5),
                AddOption(worker_id=1, learning_rate=0.25, rho=0.3),
                AddOption(worker_id=0, learning_rate=0.5),
                AddOption(worker_id=1, learning_rate=0.25, rho=0.3)]
        rng = np.random.default_rng(4)
        for _ in range(3):
            entries = []
            for s, c, o in zip(grouped, classic, opts):
                local = np.sort(rng.choice(s.n, 4, replace=False))
                vals = rng.normal(size=(4, dim)).astype(np.float32)
                entries.append((s, local, vals, o))
                with c._lock:
                    c._apply_rows(local, vals, o)
            before = plane._dispatches
            assert plane.apply_grouped(entries) == []
            assert plane._dispatches == before + 2
        np.testing.assert_array_equal(_rows_of(grouped), _rows_of(classic))
        for s, c in zip(grouped, classic):
            np.testing.assert_array_equal(
                s._ustate["g_sqr"][:, : s.n].numpy(),
                c._ustate["g_sqr"][:, : c.n].numpy())

    def test_evicted_member_leaves_the_round(self, tmp_path):
        """A shard evicted after a caller grouped it (a concurrent
        set_rows) comes back unapplied from the grouped apply and gather,
        and the super-frame engine serves it through its classic path."""
        shards = _shards(get_updater("adagrad"), 2, 20, 3)
        plane = spmd.MeshStack("st")
        for s in shards:
            plane.admit(s, None)
        local, vals = np.array([1, 2]), np.ones((2, 3), np.float32)
        before = _rows_of(shards)
        plane.evict(shards[1])
        strays = plane.apply_grouped([(s, local, vals, AddOption())
                                      for s in shards])
        assert [st[0] for st in strays] == [shards[1]]
        after = _rows_of(shards)
        assert not np.array_equal(after[1:3], before[1:3])
        np.testing.assert_array_equal(after[10:], before[10:])
        blocks = plane.gather_grouped([(s, local) for s in shards])
        assert blocks[1] is None
        np.testing.assert_array_equal(blocks[0], after[1:3])
        # the engine: the eviction lands between grouping and the apply
        rows, dim = 40, 3
        want = _oracle(tmp_path, rows, dim, updater="adagrad", steps=2)
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim, sub="sy",
                                  name="sy_t")
        plane = tabs[0]._shard._plane
        grouped = plane.apply_grouped

        def racing(entries):
            plane.evict(tabs[1]._shard)
            return grouped(entries)

        plane.apply_grouped = racing
        _drive(tabs[0], rows, dim, steps=2)
        assert tabs[1]._shard._plane is None
        np.testing.assert_array_equal(tabs[1].get_rows(np.arange(rows)),
                                      want)
        _close(ctxs)

    def test_uneven_last_shard_parity(self, tmp_path):
        """Rows not divisible by the world: the last shard is smaller and
        its slab pads to the group's largest; ids near the boundary still
        route and apply exactly."""
        rows, dim = 70, 3   # 4 shards: 18/18/18/16
        want = _oracle(tmp_path, rows, dim, updater="adagrad")
        ctxs, tabs = _stack_world(tmp_path, 4, rows, dim, sub="odd",
                                  name="odd_t")
        assert tabs[3]._shard.n == 16
        assert tabs[3]._shard._padded == (19, dim)
        _drive(tabs[0], rows, dim)
        np.testing.assert_array_equal(
            tabs[1].get_rows(np.arange(rows)), want)
        _close(ctxs)

    def test_np_shards_never_group(self, tmp_path):
        ctxs, tabs = _stack_world(tmp_path, 2, 40, 3,
                                  updater="default", sub="np",
                                  name="np_t")
        assert tabs[0]._shard._plane is None   # np_mode stays classic
        assert not spmd.shard_eligible(tabs[0]._shard)
        _close(ctxs)

    def test_ineligible_shards_stay_classic(self, tmp_path):
        """A dirty-bit (sparse) shard, Adam (not row-local) and a hash
        shard never group; a failed admit logs and stays classic."""
        config.set_flag("ps_spmd_stack", True)
        sparse = RowShard(0, 8, 3, np.float32, get_updater("adagrad"),
                          "sp", num_workers=2, device="cpu")
        adam = RowShard(0, 8, 3, np.float32, get_updater("adam"), "ad",
                        device="cpu")
        assert not spmd.shard_eligible(sparse)
        assert not spmd.shard_eligible(adam)
        plane = spmd.MeshStack("mix")
        a = RowShard(0, 8, 3, np.float32, get_updater("adagrad"), "a",
                     device="cpu")
        plane.admit(a, None)
        with pytest.raises(ValueError, match="incompatible"):
            plane.admit(RowShard(8, 16, 4, np.float32,
                                 get_updater("adagrad"), "b",
                                 device="cpu"), None)
        assert not plane.active and a._plane is None

    def test_grouped_dispatch_counts(self, tmp_path):
        """A multi-owner fan-out add lands as ONE plane dispatch, not one
        per shard."""
        rows, dim = 64, 4
        ctxs, tabs = _stack_world(tmp_path, 4, rows, dim, sub="disp",
                                  name="disp_t")
        plane = tabs[0]._shard._plane
        before = plane._dispatches
        ids = np.arange(rows)   # spans all 4 shards
        tabs[0].add_rows(ids, np.ones((rows, dim), np.float32))
        assert plane._dispatches == before + 1
        sp = tabs[0].server_stats()["shards"]["disp_t"]["spmd"]
        assert sp["members"] == 4 and sp["dispatches"] >= 1
        assert sp["applies"] >= 1 and sp["device"] == "cpu"
        assert sp["apply_share"] == 0.25
        # the per-shard counters count the grouped add as one each
        assert all(t._shard._stat_applies == 1 for t in tabs)
        _close(ctxs)

    @pytest.mark.parametrize("mutation", ["set_rows", "add_full",
                                          "set_state"])
    def test_eviction_on_exotic_mutations(self, tmp_path, mutation):
        rows, dim = 48, 3
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim, sub="ev",
                                  name="ev_t")
        sh0 = tabs[0]._shard
        plane = sh0._plane
        assert plane is not None
        ids = np.arange(rows)
        ones = np.ones((rows, dim), np.float32)

        def scenario(t_add, t_set):
            t_add.add_rows(ids, ones)
            if mutation == "set_rows":
                t_set.set_rows(np.arange(0, 10),
                               np.zeros((10, dim), np.float32))
            elif mutation == "add_full":
                t_set.add(np.full((rows, dim), 0.5, np.float32))
            else:
                sh = t_set._shard
                state = sh.handle(
                    0x18, {"table": t_set.name}, [])[1]   # MSG_GET_STATE
                sh.handle(MSG_SET_STATE, {"table": t_set.name},
                          [a * 2 for a in state])
            t_add.add_rows(ids, ones)           # post-evict apply
            return t_add.get_rows(ids)

        got = scenario(tabs[0], tabs[1] if mutation != "set_state"
                       else tabs[0])
        # the mutation reached shard 0: IT evicted; for set_rows the
        # sibling stays grouped
        assert sh0._plane is None
        if mutation == "set_rows":
            assert tabs[1]._shard._plane is plane
        # oracle: the same op sequence on a 1-shard classic world (the
        # state mutation doubles the 1-shard table's state alike)
        config.set_flag("ps_fanout", False)
        config.set_flag("ps_spmd_stack", False)
        octx = _world(tmp_path, 1, sub="evo")
        ot = AsyncMatrixTable(rows, dim, name="ev_o",
                              updater="adagrad", ctx=octx[0])
        want = scenario(ot, ot)
        _close(octx)
        if mutation == "set_state":
            # only shard 0's state doubled in the 2-shard world
            np.testing.assert_array_equal(got[: sh0.n], want[: sh0.n])
        else:
            np.testing.assert_array_equal(got, want)
        _close(ctxs)

    def test_pinned_view_survives_grouped_apply(self, tmp_path):
        """The aliasing check: a reader's pinned epoch of a grouped shard
        is its own tensor, and a grouped apply never writes it; then
        set_rows evicts that member alone, and the table still equals the
        oracle with the same set_rows."""
        rows, dim = 48, 3
        ctxs, tabs = _stack_world(tmp_path, 4, rows, dim, sub="al",
                                  name="al_t")
        _drive(tabs[0], rows, dim, steps=4)
        sh = tabs[1]._shard
        plane = sh._plane
        pin = sh._pin_data()
        before = pin.data.clone()
        assert pin.data.data_ptr() != plane.stack.data_ptr()
        tabs[0].add_rows(np.arange(rows), np.ones((rows, dim), np.float32))
        assert torch.equal(pin.data, before)
        assert not torch.equal(sh._data, before)   # the live slab moved
        sh._release_data(pin)
        tabs[2].set_rows(np.array([sh.lo, sh.lo + 3]),
                         np.full((2, dim), 7.0, np.float32))
        assert sh._plane is None
        assert all(t._shard._plane is plane for i, t in enumerate(tabs)
                   if i != 1)
        got = tabs[3].get_rows(np.arange(rows))
        config.set_flag("ps_fanout", False)
        config.set_flag("ps_spmd_stack", False)
        octx = _world(tmp_path, 1, sub="alo")
        ot = AsyncMatrixTable(rows, dim, name="al_o", updater="adagrad",
                              ctx=octx[0])
        _drive(ot, rows, dim, steps=4)
        ot.add_rows(np.arange(rows), np.ones((rows, dim), np.float32))
        ot.set_rows(np.array([sh.lo, sh.lo + 3]),
                    np.full((2, dim), 7.0, np.float32))
        want = ot.get_rows(np.arange(rows))
        _close(octx)
        np.testing.assert_array_equal(got, want)
        _close(ctxs)

    def test_grouped_checkpoint_roundtrip(self, tmp_path):
        """checkpoint_state of a grouped shard is an OWNED consistent
        snapshot; the restore lands in classic storage and serves the
        same bytes."""
        rows, dim = 48, 3
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim,
                                  updater="adagrad", sub="ck",
                                  name="ck_t")
        _drive(tabs[0], rows, dim, steps=6)
        sh = tabs[0]._shard
        before = tabs[0].get_rows(np.arange(rows))
        meta, arrays = sh.checkpoint_state()
        # mutate, then restore: the shard returns to the snapshot
        tabs[0].add_rows(np.arange(rows),
                         np.ones((rows, dim), np.float32))
        sh.restore_checkpoint(meta, arrays)
        assert sh._plane is None   # restore evicts
        after = tabs[0].get_rows(np.arange(rows))
        np.testing.assert_array_equal(after[: sh.n], before[: sh.n])
        assert sh.checkpoint_state()[0]["version"] == meta["version"]
        _close(ctxs)

    def test_concurrent_mixed_clients_sum_exactly(self, tmp_path):
        """Two client threads hammering a grouped table through the
        fan-out plane: the total is exact (the plane lock serializes
        grouped dispatches; each shard's rounds stay ordered)."""
        rows, dim = 64, 4
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim,
                                  updater="adagrad", sub="hm",
                                  name="hm_t")
        # adagrad is deterministic only per order: disjoint rows per
        # thread, so the order across threads cannot matter
        halves = [np.arange(0, 32), np.arange(32, 64)]
        ones = np.ones((32, dim), np.float32)

        def work(w):
            for _ in range(10):
                tabs[w].add_rows(halves[w], ones)

        ths = [threading.Thread(target=work, args=(w,))
               for w in range(2)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        got = tabs[0].get_rows(np.arange(rows))
        config.set_flag("ps_fanout", False)
        config.set_flag("ps_spmd_stack", False)
        octx = _world(tmp_path, 1, sub="hmo")
        ot = AsyncMatrixTable(rows, dim, name="hm_o",
                              updater="adagrad", ctx=octx[0])
        for w in range(2):
            for _ in range(10):
                ot.add_rows(halves[w], ones)
        want = ot.get_rows(np.arange(rows))
        _close(octx)
        np.testing.assert_array_equal(got, want)
        _close(ctxs)

    def test_strided_clients_sum_exactly(self, tmp_path):
        """Four clients, each adding ones to its own strided rows (every
        batch spans every shard) and reading them back: a row's value is
        exactly its count of adds (the chip smoke's curve check)."""
        rows, dim, n = 64, 4, 4
        ctxs, tabs = _stack_world(tmp_path, n, rows, dim,
                                  updater="default", sub="str",
                                  name="str_t")
        counts = [0] * 4

        def work(w):
            ids = np.arange(16) * 4 + w
            for _ in range(8):
                tabs[w % n].add_rows_async(ids, np.ones((16, dim),
                                                        np.float32))
                tabs[w % n].get_rows(ids)
                counts[w] += 1

        ths = [threading.Thread(target=work, args=(w,)) for w in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        for t in tabs:
            t.flush()
        want = np.repeat(np.tile(np.asarray(counts, np.float32), 16),
                         dim).reshape(rows, dim)
        np.testing.assert_array_equal(tabs[0].get(), want)
        _close(ctxs)

    def test_snapshot_rpc_on_grouped_shard(self, tmp_path):
        """MSG_SNAPSHOT over a grouped shard: the advertised version and
        the copied rows are read under the plane lock (one epoch, exact
        rows), and the since-version dedupe still answers 'unchanged'."""
        rows, dim = 48, 3
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim,
                                  updater="adagrad", sub="sn",
                                  name="sn_t")
        _drive(tabs[0], rows, dim, steps=5)
        sh = tabs[0]._shard
        assert sh._plane is not None
        meta, payload = sh.export_snapshot({})
        want = tabs[0].get_rows(np.arange(sh.lo, sh.hi))
        got = np.asarray(payload[0], np.float32).reshape(sh.n, dim)
        np.testing.assert_array_equal(got, want)
        meta2, _ = sh.export_snapshot(
            {"since": meta["version"], "since_gen": meta["gen"]})
        assert meta2.get("unchanged") is True
        _close(ctxs)

    def test_memory_gauges(self, tmp_path):
        rows, dim = 64, 4
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim, sub="mem",
                                  name="mem_t")
        sh = tabs[0]._shard
        ms = sh.memory_stats()
        assert ms["table_bytes"] == 33 * dim * 4 and ms.get("spmd") is True
        assert ms["ustate_bytes"] == 33 * dim * 4   # AdaGrad's one leaf
        pm = sh._plane.memory_stats()
        assert pm["stack_bytes"] == 2 * 33 * dim * 4
        assert pm["live_slots"] == 2 and pm["slots"] == 2
        from multiverso_tpu_torch.telemetry import memstats
        comps = memstats.LEDGER.snapshot()["components"]
        assert any(k.startswith("spmd[mem_t]") for k in comps)
        _close(ctxs)

    def test_close_releases_the_plane(self, tmp_path):
        rows, dim = 32, 2
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim, sub="rel",
                                  name="rel_t")
        plane = tabs[0]._shard._plane
        tabs[0].add_rows(np.arange(rows), np.ones((rows, dim), np.float32))
        before = tabs[0].get_rows(np.arange(16))
        ctxs[0].close()
        # the closing rank's shard left the plane and keeps its rows
        assert tabs[0]._shard._plane is None
        np.testing.assert_array_equal(
            tabs[0]._shard._full_rows(tabs[0]._shard._data), before)
        ctxs[1].close()
        assert plane.stack is None and not spmd._PLANES


class TestWindowFanout:
    """Windowed adds through the coalesced multi-owner flush."""

    @pytest.mark.parametrize("updater", ["default", "adagrad"])
    def test_windowed_fanout_parity(self, tmp_path, updater):
        rows, dim = 80, 4
        want = _oracle(tmp_path, rows, dim, updater=updater)
        config.set_flag("ps_fanout", True)
        config.set_flag("ps_spmd_stack", True)
        ctxs = _world(tmp_path, 4, sub="win")
        tabs = [AsyncMatrixTable(rows, dim, name="win_t", updater=updater,
                                 send_window_ms=4.0, ctx=c)
                for c in ctxs]
        # ONE client drives the stream (cross-CLIENT arrival order was
        # never promised; per-client window order is the contract the
        # coalesced multi-owner flush must preserve)
        t = tabs[0]
        rng = np.random.default_rng(7)
        for step in range(12):
            k = int(rng.integers(3, rows // 2))
            ids = np.sort(rng.choice(rows, size=k, replace=False))
            vals = rng.normal(size=(k, dim)).astype(np.float32)
            t.add_rows_async(ids, vals)
            if step % 3 == 2:
                t.flush()
        t.flush()
        got = tabs[1].get_rows(np.arange(rows))
        np.testing.assert_array_equal(got, want)
        _close(ctxs)


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad", "ftrl"])
def test_stacked_world_matches_jax(tmp_path, updater):
    """The same seeded stream through a 4-shard world of each package with
    both flags armed: the full tables agree (default and SGD bit for bit,
    the stateful updaters within the stated tolerance)."""
    rows, dim, n = 72, 5, 4
    stream = _stream(rows, dim, seed=21)
    for cfg in (config, jconfig):
        cfg.set_flag("ps_fanout", True)
        cfg.set_flag("ps_spmd_stack", True)
    jrdv = jsvc.FileRendezvous(str(tmp_path / "jx"))
    jctx = [jsvc.PSContext(r, n, jsvc.PSService(r, n, jrdv))
            for r in range(n)]
    tctx = _world(tmp_path, n, sub="tx")
    try:
        jt = [jtables.AsyncMatrixTable(rows, dim, name="xj",
                                       updater=updater, ctx=c)
              for c in jctx]
        tt = [AsyncMatrixTable(rows, dim, name="xt", updater=updater,
                               ctx=c) for c in tctx]
        if type(tt[0]._shard.updater) in ROW_LOCAL_STATE and \
                not tt[0]._shard._np_mode:
            assert tt[0]._shard._plane is not None
        for step, (ids, vals) in enumerate(stream):
            jt[step % n].add_rows(ids, vals)
            tt[step % n].add_rows(ids, vals)
        jget = jt[1].get_rows(np.arange(rows))
        tget = tt[1].get_rows(np.arange(rows))
    finally:
        _close(tctx)
        _close(jctx)
    if updater in ("default", "sgd"):
        np.testing.assert_array_equal(tget, jget)
    else:
        np.testing.assert_allclose(tget, jget, rtol=STATEFUL_RTOL,
                                   atol=STATEFUL_ATOL)


def test_per_worker_adagrad_stack_matches_jax(tmp_path):
    """Per-worker AdaGrad, a 4-shard stacked world of each package, adds
    from every rank's client under its own worker id."""
    rows, dim, n = 64, 4, 4
    stream = _stream(rows, dim, seed=9)
    for cfg in (config, jconfig):
        cfg.set_flag("ps_fanout", True)
        cfg.set_flag("ps_spmd_stack", True)
    jrdv = jsvc.FileRendezvous(str(tmp_path / "jx"))
    jctx = [jsvc.PSContext(r, n, jsvc.PSService(r, n, jrdv))
            for r in range(n)]
    tctx = _world(tmp_path, n, sub="tx")
    try:
        jt = [jtables.AsyncMatrixTable(
            rows, dim, name="pj", ctx=c,
            updater=JAdaGrad(num_workers=n, per_worker=True))
            for c in jctx]
        tt = [AsyncMatrixTable(
            rows, dim, name="pt", ctx=c,
            updater=AdaGradUpdater(num_workers=n, per_worker=True))
            for c in tctx]
        assert tt[0]._shard._plane is not None
        for step, (ids, vals) in enumerate(stream):
            jt[step % n].add_rows(ids, vals)
            tt[step % n].add_rows(ids, vals)
        jget = jt[0].get_rows(np.arange(rows))
        tget = tt[0].get_rows(np.arange(rows))
    finally:
        _close(tctx)
        _close(jctx)
    np.testing.assert_allclose(tget, jget, rtol=STATEFUL_RTOL,
                               atol=STATEFUL_ATOL)


class TestPlacementSurfaces:
    def test_mvtop_placement_panel(self, tmp_path):
        from multiverso_tpu_torch.telemetry import aggregator
        from multiverso_tpu_torch.tools import mvtop
        rows, dim = 64, 4
        ctxs, tabs = _stack_world(tmp_path, 2, rows, dim, sub="top",
                                  name="top_t")
        tabs[0].add_rows(np.arange(rows),
                         np.ones((rows, dim), np.float32))
        stats = {c.rank: c.service.stats_payload() for c in ctxs}
        health = {c.rank: c.service.health_payload() for c in ctxs}
        rec = aggregator.merge_cluster(stats, health, world=2)
        txt = mvtop.render(rec)
        assert "placement:" in txt
        assert "@cpu slot0" in txt and "@cpu slot1" in txt
        assert "spmd group: 2 shards stacked" in txt
        _close(ctxs)

    def test_placement_panel_renders_without_spmd(self, tmp_path):
        """Classic multi-shard tables render the panel too (apply share
        from the plain counters; device 'classic')."""
        from multiverso_tpu_torch.telemetry import aggregator
        from multiverso_tpu_torch.tools import mvtop
        ctxs = _world(tmp_path, 2, sub="cls")
        tabs = [AsyncMatrixTable(40, 3, name="cls_t", ctx=c)
                for c in ctxs]
        tabs[0].add_rows(np.arange(40), np.ones((40, 3), np.float32))
        stats = {c.rank: c.service.stats_payload() for c in ctxs}
        health = {c.rank: c.service.health_payload() for c in ctxs}
        rec = aggregator.merge_cluster(stats, health, world=2)
        txt = mvtop.render(rec)
        assert "placement:" in txt and "@classic" in txt
        assert "spmd group" not in txt
        _close(ctxs)


class TestObsLint:
    def test_obs_surface_clean(self):
        from multiverso_tpu_torch.tools import check_obs_surface
        assert check_obs_surface.check() == []

    def test_flags_are_the_jax_packages(self):
        """The plane's two flags: JAX's names, defaults and help text."""
        for name in ("ps_fanout", "ps_spmd_stack"):
            assert config.get_flag(name) is False
            assert (config._registry[name].help
                    == jconfig._registry[name].help)


def test_slot_of_matches_jax(tmp_path):
    """MeshStack.slot_of on a 4-shard stacked AdaGrad world of each
    package: each member's slot (its ``_plane_slot``), None for an object
    outside the group and for a member once evicted; the same in both."""
    rows, dim, n = 72, 5, 4
    for cfg in (config, jconfig):
        cfg.set_flag("ps_fanout", True)
        cfg.set_flag("ps_spmd_stack", True)
    jrdv = jsvc.FileRendezvous(str(tmp_path / "jx"))
    jctx = [jsvc.PSContext(r, n, jsvc.PSService(r, n, jrdv))
            for r in range(n)]
    tctx = _world(tmp_path, n, sub="tx")
    got = {}
    try:
        for pkg, cls, ctxs in (("jax", jtables.AsyncMatrixTable, jctx),
                               ("port", AsyncMatrixTable, tctx)):
            tabs = [cls(rows, dim, name=f"so_{pkg}", updater="adagrad",
                        ctx=c) for c in ctxs]
            plane = tabs[0]._shard._plane
            assert plane is not None and plane.active
            slots = [plane.slot_of(t._shard) for t in tabs]
            assert slots == [t._shard._plane_slot for t in tabs]
            outsider = plane.slot_of(object())
            plane.evict(tabs[2]._shard)
            got[pkg] = (slots, outsider,
                        [plane.slot_of(t._shard) for t in tabs])
    finally:
        _close(tctx)
        _close(jctx)
    assert got["port"] == got["jax"]
    assert got["port"] == ([0, 1, 2, 3], None, [0, 1, None, 3])
