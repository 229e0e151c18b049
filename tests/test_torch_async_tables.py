"""Port parity, ``ps/shard.py`` and ``ps/tables.py``: the five async tables
of multiverso_tpu_torch against multiverso_tpu's (pure-Python plane,
``ps_native=False``), each in its own two-rank world over a
``FileRendezvous`` in ``tmp_path``; the port's shards on the CPU.

One seeded numpy op sequence (row and whole-table adds from both ranks'
clients, row and whole gets, per-worker ``AddOption``s) goes through a
JAX world and a port world. The Gets agree bit for bit for the default
and SGD updaters (the same IEEE f32 adds on the same rows); AdaGrad,
momentum, FTRL and Adam agree to ``STATEFUL_RTOL`` (XLA's CPU ``sqrt``,
``pow`` and division and torch's differ by a few ulp). Also against
JAX: seeded random init, ``set_rows``, ``store``/``load`` across the two
packages, the sparse stale-only protocol, the KV aggregated Get,
hash-shard slot growth, the coalesced applies (``stat_applies``) and
the ``MSG_BATCH`` waves. Then the numpy models of
``tests/test_async_table_fuzz.py`` against the port's tables, the
pipelined sparse pulls, and the hot-row train cache's device.
"""

import io
import threading
import time

import numpy as np
import pytest
import torch

from multiverso_tpu.ps import service as jsvc
from multiverso_tpu.ps import shard as jshard
from multiverso_tpu.ps import tables as jtables
from multiverso_tpu.ps import wire as jwire
from multiverso_tpu.updaters import AdaGradUpdater as JAdaGrad
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.updaters import get_updater as jget_updater
from multiverso_tpu.utils import config as jconfig
import multiverso_tpu_torch as tmv
from multiverso_tpu_torch.ps import service as tsvc
from multiverso_tpu_torch.ps import shard as tshard
from multiverso_tpu_torch.ps import tables as ttables
from multiverso_tpu_torch.ps import wire as twire
from multiverso_tpu_torch.serving import hotcache as thc
from multiverso_tpu_torch import updaters as tupdaters
from multiverso_tpu_torch.updaters import AdaGradUpdater as TAdaGrad
from multiverso_tpu_torch.updaters import AddOption as TAddOption
from multiverso_tpu_torch.updaters import get_updater as tget_updater
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

# the stateful updaters' sqrt/pow/divide differ by a few ulp between
# XLA's CPU backend and torch (tests/test_torch_updaters.py)
STATEFUL_RTOL = 1e-5
STATEFUL_ATOL = 1e-6


class _Pkg:
    """One package's async-PS modules (hashable: a dict key)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


J = _Pkg(t=jtables, svc=jsvc, opt=JAddOption, upd=jget_updater,
         adagrad=JAdaGrad, name="jax")
T = _Pkg(t=ttables, svc=tsvc, opt=TAddOption, upd=tget_updater,
         adagrad=TAdaGrad, name="torch")


@pytest.fixture(autouse=True)
def _short_timeouts():
    for cfg in (tconfig, jconfig):
        cfg.set_flag("ps_timeout", 5.0)
        cfg.set_flag("ps_connect_timeout", 3.0)
    jconfig.set_flag("ps_native", False)
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _world(pkg, directory):
    if pkg is J:
        rdv = jsvc.FileRendezvous(directory)
        return [jsvc.PSContext(r, 2, jsvc.PSService(r, 2, rdv))
                for r in range(2)]
    rdv = tsvc.FileRendezvous(directory)
    return [tsvc.PSContext(r, 2, tsvc.PSService(r, 2, rdv), device="cpu")
            for r in range(2)]


@pytest.fixture
def worlds(tmp_path):
    """A two-rank world of each package: {J: ctxs, T: ctxs}."""
    out = {J: _world(J, str(tmp_path / "jax")),
           T: _world(T, str(tmp_path / "torch"))}
    yield out
    for ctxs in out.values():
        for c in ctxs:
            c.close()


@pytest.fixture
def py_worlds(tmp_path):
    """``worlds`` with the port on the Python wire plane too (ps_native
    off): the coalesced-apply counts are that plane's (the native server
    applies each frame as it lands)."""
    tconfig.set_flag("ps_native", False)
    out = {J: _world(J, str(tmp_path / "jax")),
           T: _world(T, str(tmp_path / "torch"))}
    yield out
    for ctxs in out.values():
        for c in ctxs:
            c.close()


@pytest.fixture
def port_ranks(tmp_path):
    ctxs = _world(T, str(tmp_path / "rdv"))
    yield ctxs
    for c in ctxs:
        c.close()


def _same(t_out, j_out, exact):
    assert len(t_out) == len(j_out)
    for a, b in zip(t_out, j_out):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=STATEFUL_RTOL,
                                       atol=STATEFUL_ATOL)


# ---------------------------------------------------------------------- #
# AsyncMatrixTable
# ---------------------------------------------------------------------- #
_UPDATERS = {
    "default": lambda p: "default",
    "sgd": lambda p: "sgd",
    "momentum_sgd": lambda p: "momentum_sgd",
    "adagrad": lambda p: "adagrad",
    "adagrad_per_worker": lambda p: p.adagrad(num_workers=2,
                                              per_worker=True),
    "ftrl": lambda p: "ftrl",
    "adam": lambda p: "adam",
}


def _matrix_script(p, ctxs, updater, wire="none"):
    rows, cols = 37, 5
    ts = [p.t.AsyncMatrixTable(rows, cols, updater=_UPDATERS[updater](p),
                               name="sc", seed=11, init_scale=0.3,
                               wire=wire, ctx=c) for c in ctxs]
    rng = np.random.default_rng(3)
    out = [ts[0].get(), ts[1].get()]
    for step in range(16):
        c = step % 2
        ids = rng.integers(0, rows, 9)               # duplicates welcome
        vals = (rng.normal(size=(9, cols)) * 0.1).astype(np.float32)
        opt = p.opt(worker_id=c, learning_rate=0.5, rho=0.2, momentum=0.9)
        ts[c].add_rows(ids, vals, opt)
        if step % 4 == 3:
            out.append(ts[1 - c].get_rows(rng.integers(0, rows, 6)))
        if step % 5 == 4:
            ts[c].add((rng.normal(size=(rows, cols)) * 0.01
                       ).astype(np.float32), opt)
    mids = [ts[0].add_rows_async([i, rows - 1 - i],
                                 np.full((2, cols), 0.01 * i, np.float32))
            for i in range(6)]
    for m in mids:
        ts[0].wait(m)
    ts[1].set_rows([0, 36], np.full((2, cols), 0.5, np.float32))
    out += [ts[0].get(), ts[1].get(),
            ts[1].get_rows([36, 0, 36]), ts[0].get_row(18)]
    stats = [(t._shard.stat_adds, t._shard.stat_applies) for t in ts]
    return out, stats


@pytest.mark.parametrize("updater", list(_UPDATERS))
def test_matrix_table_matches_jax(py_worlds, updater):
    j_out, j_stats = _matrix_script(J, py_worlds[J], updater)
    t_out, t_stats = _matrix_script(T, py_worlds[T], updater)
    _same(t_out, j_out, exact=updater in ("default", "sgd"))
    assert t_stats == j_stats


@pytest.mark.parametrize("wire", ["bf16", "1bit", "topk"])
def test_matrix_table_codec_wires_match_jax(worlds, wire):
    """The compressed wires round and encode alike: a default-updater
    script agrees bit for bit, bf16 get replies included."""
    j_out, _ = _matrix_script(J, worlds[J], "default", wire)
    t_out, _ = _matrix_script(T, worlds[T], "default", wire)
    _same(t_out, j_out, exact=True)


def test_random_init_matches_jax_bit_for_bit(worlds):
    """Each shard draws exactly its rows from default_rng([seed, lo]):
    the same table in both packages and from both clients."""
    got = {}
    for p in (J, T):
        ts = [p.t.AsyncMatrixTable(23, 7, name="ri", seed=5, init_scale=0.5,
                                   ctx=c) for c in worlds[p]]
        got[p] = [ts[0].get(), ts[1].get()]
        assert np.array_equal(got[p][0], got[p][1])
    assert np.array_equal(got[J][0], got[T][0])
    assert np.abs(got[T][0]).max() <= 0.5 and got[T][0].std() > 0


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("updater", ["default", "adagrad", "adam"])
def test_store_load_crosses_packages(worlds, direction, updater):
    """A table stored by one package loads into the other, updater state
    (the "MVUS" trailer) included: the next identical add lands alike."""
    src, dst = (J, T) if direction == "jax_to_torch" else (T, J)
    tables = {p: [p.t.AsyncMatrixTable(9, 3, updater=updater, name="sl",
                                       ctx=c) for c in worlds[p]]
              for p in (J, T)}
    rng = np.random.default_rng(8)
    for _ in range(3):
        ids = rng.choice(9, 4, replace=False)
        tables[src][1].add_rows(
            ids, rng.normal(size=(4, 3)).astype(np.float32),
            src.opt(learning_rate=0.5, rho=0.3))
    buf = io.BytesIO()
    tables[src][0].store(buf)
    buf.seek(0)
    tables[dst][0].load(buf)
    assert np.array_equal(tables[dst][1].get(), tables[src][1].get())
    d = rng.normal(size=(9, 3)).astype(np.float32)
    for p in (src, dst):
        tables[p][0].add_rows(np.arange(9), d,
                              p.opt(learning_rate=0.5, rho=0.3))
    _same([tables[T][0].get()], [tables[J][0].get()],
          exact=updater == "default")


def test_corrupt_updater_trailer_fails_loudly(port_ranks):
    t0 = ttables.AsyncMatrixTable(6, 2, name="ctrl", updater="adagrad",
                                  ctx=port_ranks[0])
    ttables.AsyncMatrixTable(6, 2, name="ctrl", updater="adagrad",
                             ctx=port_ranks[1])
    t0.add_rows(np.arange(6), np.ones((6, 2), np.float32))
    buf = io.BytesIO()
    t0.store(buf)
    raw = buf.getvalue()
    second_magic = raw.index(b"\x93NUMPY", raw.index(b"\x93NUMPY") + 1)
    with pytest.raises(ValueError):
        t0.load(io.BytesIO(raw[: second_magic + 4]))
    legacy = io.BytesIO()
    np.save(legacy, t0.get(), allow_pickle=False)
    legacy.seek(0)
    t0.load(legacy)   # a clean data-only stream still loads
    bad = io.BytesIO()
    bad.write(raw[: raw.index(b"\x93NUMPY", 1)])
    np.save(bad, np.array([7, 2], np.int64))
    bad.seek(0)
    with pytest.raises(ValueError, match="trailer"):
        t0.load(bad)


def test_store_keeps_full_precision_despite_wire(port_ranks, tmp_path):
    t0 = ttables.AsyncMatrixTable(6, 2, name="ws", wire="bf16",
                                  ctx=port_ranks[0])
    ttables.AsyncMatrixTable(6, 2, name="ws", wire="bf16",
                             ctx=port_ranks[1])
    exact = np.full((6, 2), 1.0009765625, np.float32)  # not bf16-exact
    t0.set_rows(np.arange(6), exact)
    with open(tmp_path / "ws.npy", "wb") as f:
        t0.store(f)
    assert np.array_equal(np.load(tmp_path / "ws.npy"), exact)
    assert t0._wire == "bf16"


# ---------------------------------------------------------------------- #
# the other tables
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_array_table_matches_jax(worlds, updater):
    out = {}
    for p in (J, T):
        ts = [p.t.AsyncArrayTable(19, updater=updater, name="ar", ctx=c)
              for c in worlds[p]]
        rng = np.random.default_rng(9)
        res = []
        for step in range(8):
            d = rng.normal(size=19).astype(np.float32)
            ts[step % 2].add(d, p.opt(worker_id=step % 2,
                                      learning_rate=0.4, rho=0.1))
            res.append(ts[1 - step % 2].get())
        res.append(ts[0].wait(ts[0].get_async()))
        out[p] = res
    _same(out[T], out[J], exact=updater != "adagrad")


def test_sparse_matrix_stale_protocol_matches_jax(worlds):
    """The same rows and the same rows-over-the-wire counts, for two
    workers on two clients."""
    out = {}
    for p in (J, T):
        ts = [p.t.AsyncSparseMatrixTable(20, 3, name="sp", num_workers=2,
                                         ctx=c) for c in worlds[p]]
        rng = np.random.default_rng(10)
        res, moved = [], []
        for step in range(24):
            c = int(rng.integers(0, 2))
            if step % 3 == 0:
                k = int(rng.integers(1, 8))
                ts[c].add_rows(rng.integers(0, 20, k),
                               rng.normal(size=(k, 3)).astype(np.float32))
            else:
                ids = rng.integers(0, 20, int(rng.integers(1, 9)))
                res.append(ts[c].get_rows_sparse(ids, worker_id=c))
                moved.append(ts[c].last_transfer_rows)
        out[p] = (res, moved, ts[0]._shard.stats()["dirty_rows"])
    _same(out[T][0], out[J][0], exact=True)
    assert out[T][1] == out[J][1]
    assert out[T][2] == out[J][2]


@pytest.mark.parametrize("updater", ["default", "sgd", "ftrl"])
def test_sparse_kv_table_matches_jax(worlds, updater):
    """Hash-sharded keys (owner = key % world), slot growth past the
    1024-slot capacity, plain and stale-only gets, dump and restore."""
    out = {}
    for p in (J, T):
        ts = [p.t.AsyncSparseKVTable(3, updater=updater, name="skv",
                                     num_workers=2, ctx=c)
              for c in worlds[p]]
        rng = np.random.default_rng(12)
        big = np.array([7, 1_000_003, 2 ** 40 + 3, 42, 88])
        res = []
        ts[0].add_rows(big, rng.normal(size=(5, 3)).astype(np.float32))
        ts[1].add_rows(big[:2], rng.normal(size=(2, 3)).astype(np.float32))
        many = np.arange(3000)   # grows each shard past its 1024 slots
        ts[1].add_rows(many, rng.normal(size=(3000, 3)).astype(np.float32))
        res.append(ts[0].get_rows(np.concatenate([big, many[::97], [555]])))
        res.append(ts[1].get_rows_sparse(big, worker_id=1))
        res.append(ts[1].get_rows_sparse(big, worker_id=1))
        ts[0].add_rows([88, 88], np.ones((2, 3), np.float32))
        res.append(ts[1].get_rows_sparse(big, worker_id=1))
        res.append(np.array(ts[1].last_transfer_rows))
        buf = io.BytesIO()
        ts[0].store(buf)
        ts[0].add_rows([7], np.ones((1, 3), np.float32))
        buf.seek(0)
        ts[0].load(buf)
        res.append(ts[1].get_rows(big))
        out[p] = (res, [t._shard.n for t in ts],
                  [t._shard.stats()["keys"] for t in ts])
    _same(out[T][0], out[J][0], exact=updater != "ftrl")
    assert out[T][1] == out[J][1] and min(out[T][1]) >= 1500
    assert out[T][2] == out[J][2]


def test_sparse_kv_store_crosses_packages(worlds):
    tables = {p: [p.t.AsyncSparseKVTable(2, updater="adagrad", name="skc",
                                         ctx=c) for c in worlds[p]]
              for p in (J, T)}
    keys = np.array([3, 10, 1001, 2 ** 33])
    tables[J][0].add_rows(keys, np.ones((4, 2), np.float32))
    buf = io.BytesIO()
    tables[J][0].store(buf)
    buf.seek(0)
    tables[T][1].load(buf)
    assert np.array_equal(tables[T][0].get_rows(keys),
                          tables[J][0].get_rows(keys))
    for p in (J, T):   # the g2 state came along: the next step matches
        tables[p][0].add_rows(keys, np.ones((4, 2), np.float32))
    _same([tables[T][1].get_rows(keys)], [tables[J][1].get_rows(keys)],
          exact=False)


def test_kv_table_aggregated_get_matches_jax(worlds):
    got = {}
    for p in (J, T):
        k0, k1 = [p.t.AsyncKVTable(name="kv", ctx=c) for c in worlds[p]]
        k0.add([0, 1, 2, 2], [1.0, 1.0, 1.0, 0.5])
        k1.add([1, 2, 3], [2.0, 2.0, 2.0])
        got[p] = (k0.get(), k1.get([1, 9, 2, 2, 2]), k0[2])
        buf = io.BytesIO()
        k0.store(buf)
        buf.seek(0)
        k1.load(buf)
        got[p] += (k0.get(),)
    assert got[T] == got[J]
    assert got[T][1] == {1: 3.0, 9: 0, 2: 3.5}   # no double count


def test_create_table_parity():
    tmv.init(device="cpu")
    t = tmv.create_table(ttables.AsyncMatrixTableOption(6, 3), name="opt_m")
    t.add_rows([1], np.ones((1, 3), np.float32))
    np.testing.assert_array_equal(t.get_row(1), 1.0)
    a = tmv.create_table(ttables.AsyncArrayTableOption(8), name="opt_a")
    a.add(np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(a.get(), np.arange(8))
    assert set(TZoo.get().tables()) == {t.table_id, a.table_id}


# ---------------------------------------------------------------------- #
# the shards: coalescing, batch waves, checkpoints, snapshots
# ---------------------------------------------------------------------- #
def _shard(p, updater, n=32, cols=4, num_workers=0):
    upd = p.upd(updater) if isinstance(updater, str) else updater
    mod = jshard if p is J else tshard
    kw = {} if p is J else {"device": "cpu"}
    return mod.RowShard(0, n, cols, np.float32, upd, "coal",
                        num_workers=num_workers, **kw)


def _block_applier_and_queue(p, shard, requests):
    """Deterministic merge setup (the JAX test's): while holding the
    shard lock, start a zero-delta add (it becomes the applier and blocks
    on the lock), then ``requests``, which all queue behind it. On
    release the dummy applies alone and the rest drain as one batch."""
    zero = np.zeros((1, shard.num_col), np.float32)
    threads = []
    with shard._lock:
        dummy = threading.Thread(
            target=shard.handle,
            args=(p.svc.MSG_ADD_ROWS, {"table": shard.name},
                  [np.array([0]), zero]))
        dummy.start()
        threads.append(dummy)
        deadline = time.monotonic() + 5
        while ((not shard._addq_draining or shard._addq)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        for meta, arrays in requests:
            t = threading.Thread(target=shard.handle,
                                 args=(p.svc.MSG_ADD_ROWS, meta, arrays))
            t.start()
            threads.append(t)
            # one at a time, so the queue's order is the requests' order
            while (len(shard._addq) < len(threads) - 1
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        assert len(shard._addq) == len(requests)
    for t in threads:
        t.join(timeout=10)


def _data(p, shard):
    return (np.asarray(shard._data) if p is J
            else shard._data.numpy())[: shard.n]


@pytest.mark.parametrize("case", ["same_rows", "cross_worker",
                                  "per_worker_adagrad", "overlap_f64",
                                  "adam_never_merges", "disabled"])
def test_coalesced_applies_match_jax(case):
    rng = np.random.default_rng(14)
    reqs = []
    updater = "default"
    if case == "same_rows":
        reqs = [({"table": "coal"}, [np.arange(8), np.ones((8, 4),
                                                          np.float32)])
                for _ in range(6)]
    elif case == "cross_worker":
        reqs = [({"table": "coal", "opt": {"worker_id": w}},
                 [np.arange(8), np.ones((8, 4), np.float32)])
                for w in range(6)]
    elif case == "per_worker_adagrad":
        updater = "per_worker"
        reqs = [({"table": "coal", "opt": {"worker_id": w,
                                           "learning_rate": 1.0}},
                 [np.arange(4), np.ones((4, 4), np.float32)])
                for w in (0, 0, 1)]
    elif case == "overlap_f64":
        reqs = [({"table": "coal"},
                 [rng.choice(32, 10, replace=False),
                  rng.normal(size=(10, 4)).astype(np.float32)])
                for _ in range(5)]
    elif case == "adam_never_merges":
        updater = "adam"
        reqs = [({"table": "coal"}, [np.arange(4),
                                     np.ones((4, 4), np.float32)])
                for _ in range(3)]
    out = {}
    for p in (J, T):
        upd = (p.adagrad(num_workers=2, per_worker=True)
               if updater == "per_worker" else updater)
        shard = _shard(p, upd)
        if case == "disabled":
            (jconfig if p is J else tconfig).set_flag("ps_coalesce", False)
            for _ in range(3):
                shard.handle(p.svc.MSG_ADD_ROWS, {"table": "coal"},
                             [np.arange(4), np.ones((4, 4), np.float32)])
        else:
            _block_applier_and_queue(p, shard, reqs)
        out[p] = (_data(p, shard), shard.stat_adds, shard.stat_applies,
                  shard.stats()["wave_ops"])
    _same([out[T][0]], [out[J][0]],
          exact=updater in ("default",))
    assert out[T][1:] == out[J][1:]


@pytest.mark.parametrize("updater", ["default", "adagrad", "adam"])
def test_batch_frame_waves_match_jax(updater):
    """A MSG_BATCH frame (a send window's unit, from any client) applies
    as conflict-free waves: disjoint consecutive adds merge, an overlap
    closes the wave, adam never merges."""
    rng = np.random.default_rng(15)
    subs = []
    for i in range(7):
        ids = (np.arange(3) + 4 * i) % 32 if i != 4 else np.array([0, 1])
        subs.append(({"table": "coal", "opt": {"worker_id": 0}},
                     [ids, rng.normal(size=(ids.size, 4)
                                      ).astype(np.float32)]))
    out = {}
    for p in (J, T):
        shard = _shard(p, updater)
        w = jwire if p is J else twire
        frames = [w.encode(p.svc.MSG_ADD_ROWS, i, m, a)
                  for i, (m, a) in enumerate(subs)]
        rmeta, _ = shard.handle(p.svc.MSG_BATCH, {"table": "coal"},
                                w.pack_batch(frames))
        st = shard.stats()
        out[p] = (_data(p, shard), rmeta, shard.stat_adds,
                  shard.stat_applies, st["wave_ops"], st["wave_max_ops"])
    _same([out[T][0]], [out[J][0]], exact=updater == "default")
    assert out[T][1:] == out[J][1:]


def test_checkpoint_state_crosses_packages():
    """A shard's failover snapshot (data rows, updater-state leaves in
    sorted-key order, version) restores across the packages."""
    rng = np.random.default_rng(16)
    shards = {p: _shard(p, "adagrad", n=10, cols=3) for p in (J, T)}
    ids, vals = np.arange(5), rng.normal(size=(5, 3)).astype(np.float32)
    for p, s in shards.items():
        s.handle(p.svc.MSG_ADD_ROWS, {"table": "coal"}, [ids, vals])
    jmeta, jarrs = shards[J].checkpoint_state()
    tmeta, tarrs = shards[T].checkpoint_state()
    assert {k: tmeta[k] for k in ("kind", "lo", "rows", "cols", "dtype",
                                  "version", "n_leaves")} == \
        {k: jmeta[k] for k in ("kind", "lo", "rows", "cols", "dtype",
                               "version", "n_leaves")}
    _same(tarrs, jarrs, exact=False)
    fresh = _shard(T, "adagrad", n=10, cols=3)
    fresh.restore_checkpoint(jmeta, jarrs)
    assert fresh._version == jmeta["version"]
    assert np.array_equal(fresh._data.numpy()[:10], jarrs[0])
    with pytest.raises(tsvc.PSError, match="partition"):
        _shard(T, "adagrad", n=9, cols=3).restore_checkpoint(jmeta, jarrs)
    with pytest.raises(tsvc.PSError, match="leaves"):
        _shard(T, "default", n=10, cols=3).restore_checkpoint(jmeta, jarrs)


def test_export_snapshot_matches_jax():
    out = {}
    for p in (J, T):
        s = _shard(p, "default", n=6, cols=2)
        s.handle(p.svc.MSG_ADD_ROWS, {"table": "coal"},
                 [np.array([1, 4]), np.ones((2, 2), np.float32)])
        m1, a1 = s.handle(p.svc.MSG_SNAPSHOT, {"table": "coal"}, [])
        m2, a2 = s.handle(p.svc.MSG_SNAPSHOT,
                          {"table": "coal", "since": m1["version"],
                           "since_gen": m1["gen"]}, [])
        out[p] = (m1, np.asarray(a1[0]), m2, len(a2))
    assert out[T][0] == out[J][0] and out[T][2] == out[J][2]
    assert np.array_equal(out[T][1], out[J][1]) and out[T][3] == 0


@pytest.mark.parametrize("updater", ["default", "adagrad_per_worker",
                                     "adam", "ftrl", "sgd", "momentum_sgd",
                                     "adagrad"])
def test_spmd_apply_matches_jax(updater):
    """ops/spmd_apply: one shard's update (gather the rows and the
    row-axis state leaves, apply, scatter; a row-free leaf replaced whole)
    against the JAX package's per-shard body, the slab slice and the
    stacked AddOption leaves; and, for every updater a stacked group takes
    (all but Adam), the stacked apply and gather over a 3-shard stack with
    per-shard options that differ against the JAX package's vmapped
    program (the port splits the round by option, one call a part)."""
    import jax
    import jax.numpy as jnp
    from multiverso_tpu.ops import spmd_apply as jspmd
    from multiverso_tpu_torch.ops import spmd_apply as tspmd
    rng = np.random.default_rng(17)
    shape = (9, 3)
    data = rng.normal(size=shape).astype(np.float32)
    ids = np.array([1, 4, 7, 8, 8])        # the scratch row padded twice
    vals = rng.normal(size=(5, 3)).astype(np.float32)
    vals[3:] = 0.0
    opt = dict(worker_id=1, learning_rate=0.5, rho=0.2)
    upd = {p: (p.adagrad(num_workers=2, per_worker=True)
               if updater == "adagrad_per_worker" else p.upd(updater))
           for p in (J, T)}
    jstate = upd[J].init_state(shape, jnp.float32)
    tstate = upd[T].init_state(shape, torch.float32, torch.device("cpu"))
    jaxes = jax.tree.map(lambda l: (l.ndim - 2 if l.ndim >= 2
                                    and l.shape[-2:] == shape else -1),
                         jstate)
    shard = tshard.RowShard(0, 8, 3, np.float32, upd[T], "sp", device="cpu")
    taxes = {k: shard._state_row_axis(v) for k, v in tstate.items()}
    assert taxes == (jaxes if isinstance(jaxes, dict) else {})
    jfn = jax.jit(jspmd._one_shard_update(upd[J], jaxes))
    tfn = tspmd.build_apply(upd[T], taxes)
    jd, js = jnp.asarray(data), jstate
    td = torch.from_numpy(data.copy())
    for _ in range(3):
        jd, js = jfn(jd, js, jnp.asarray(ids), jnp.asarray(vals),
                     tuple(JAddOption(**opt)))
        td, tstate = tfn(td, tstate, torch.from_numpy(ids),
                         torch.from_numpy(vals), TAddOption(**opt))
    _same([td.numpy()] + [tstate[k].numpy() for k in sorted(tstate)],
          [np.asarray(jd)] + [np.asarray(x) for x in jax.tree.leaves(js)],
          exact=updater == "default")
    rows = tspmd.build_gather()(td, torch.tensor([8, 0]))
    assert np.array_equal(rows.numpy(), td.numpy()[[8, 0]])
    stacked = rng.normal(size=(3, 4, 2)).astype(np.float32)
    assert np.array_equal(
        tspmd.build_slice()(torch.from_numpy(stacked), 2).numpy(),
        np.asarray(jspmd.build_slice()(jnp.asarray(stacked), 2)))
    opts = [JAddOption(worker_id=w, learning_rate=0.1 * w) for w in range(3)]
    for a, b in zip(tspmd.opt_leaves([TAddOption(*o) for o in opts]),
                    jspmd.opt_leaves(opts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if updater == "adam":
        return   # a row-free leaf: Adam never stacks
    # the stacked forms: 3 shards of (9, 3), the last row each shard's
    # scratch row (zero, as in a live shard)
    n_slots, r = 3, shape[0]
    stack = rng.normal(size=(n_slots,) + shape).astype(np.float32)
    stack[:, r - 1] = 0.0
    sids = [np.array([0, 3, 5]), np.array([1, 2, 6, 7]), np.array([4])]
    sopts = [dict(worker_id=0, learning_rate=0.5, rho=0.2),
             dict(worker_id=1, learning_rate=0.25, rho=0.3),
             dict(worker_id=0, learning_rate=0.5, rho=0.2)]
    bucket = 4
    jfn_st = jspmd.build_apply(upd[J], jaxes, None)
    jst = jax.tree.map(lambda l: jnp.stack([l] * n_slots),
                       upd[J].init_state(shape, jnp.float32))
    jstack = jnp.asarray(stack)
    tstack = torch.from_numpy(stack.copy())
    tst = {k: torch.zeros(tspmd.stacked_shape(v.shape, taxes[k], n_slots,
                                              r))
           for k, v in upd[T].init_state(shape, torch.float32,
                                         torch.device("cpu")).items()}
    tfn_st = tspmd.build_stacked_apply(
        upd[T], taxes, tupdaters.STATELESS_LINEAR.get(type(upd[T])))
    for _ in range(2):
        svals = [rng.normal(size=(i.size, 3)).astype(np.float32)
                 for i in sids]
        jids = np.full((n_slots, bucket), r - 1, np.int32)
        jvals = np.zeros((n_slots, bucket, 3), np.float32)
        for k, (i, v) in enumerate(zip(sids, svals)):
            jids[k, : i.size] = i
            jvals[k, : i.size] = v
        jstack, jst = jfn_st(jstack, jst, jids, jvals, jspmd.opt_leaves(
            [JAddOption(**o) for o in sopts]))
        parts = {}
        for k, o in enumerate(sopts):
            parts.setdefault(TAddOption(**o), []).append(k)
        for o, slots in parts.items():
            flat = np.concatenate([k * r + sids[k] for k in slots])
            tfn_st(tstack, tst, torch.from_numpy(flat),
                   torch.from_numpy(np.concatenate(
                       [svals[k] for k in slots])), o)
    exact = updater in ("default", "sgd")
    _same([tstack.numpy()] + [tst[k].movedim(taxes[k], 0).numpy()
                              for k in sorted(tst)],
          [np.asarray(jstack)] + [np.asarray(x)
                                  for x in jax.tree.leaves(jst)],
          exact=exact)
    flat = np.array([2 * r + 4, 0 * r + 5, 1 * r + 7])
    got = tspmd.build_stacked_gather()(tstack, torch.from_numpy(flat))
    assert np.array_equal(got.numpy(), tstack.numpy().reshape(-1, 3)[flat])
    # a slice of a stacked leaf is a copy: a later apply never moves it
    slab = tspmd.build_slice()(tstack, 1)
    before = slab.clone()
    tfn_st(tstack, tst, torch.from_numpy(np.array([1 * r + 2])),
           torch.ones((1, 3)), TAddOption(**sopts[1]))
    assert torch.equal(slab, before)


# ---------------------------------------------------------------------- #
# the numpy models of tests/test_async_table_fuzz.py, on the port
# ---------------------------------------------------------------------- #
def test_async_matrix_matches_numpy_model(port_ranks):
    rng = np.random.default_rng(7)
    rows, cols = 37, 5
    t = ttables.AsyncMatrixTable(rows, cols, name="fz_m", ctx=port_ranks[0])
    ttables.AsyncMatrixTable(rows, cols, name="fz_m", ctx=port_ranks[1])
    model = np.zeros((rows, cols), np.float32)
    for _ in range(120):
        op = rng.choice(["add_rows", "add_rows_async", "get_rows",
                         "add_full", "get_full", "flush"])
        if op in ("add_rows", "add_rows_async"):
            k = int(rng.integers(1, 12))
            ids = rng.integers(0, rows, k)
            vals = rng.normal(size=(k, cols)).astype(np.float32)
            if op == "add_rows":
                t.add_rows(ids, vals)
            else:
                t.add_rows_async(ids, vals)
            np.add.at(model, ids, vals)
        elif op == "add_full":
            d = rng.normal(size=(rows, cols)).astype(np.float32)
            t.add(d)
            model += d
        elif op == "get_rows":
            ids = np.unique(rng.integers(0, rows, int(rng.integers(1, 10))))
            np.testing.assert_allclose(t.get_rows(ids), model[ids],
                                       rtol=2e-5, atol=2e-4)
        elif op == "get_full":
            np.testing.assert_allclose(t.get(), model, rtol=2e-5,
                                       atol=2e-4)
        else:
            t.flush()
    t.flush()
    np.testing.assert_allclose(t.get(), model, rtol=2e-5, atol=2e-4)


def test_async_array_matches_numpy_model(port_ranks):
    rng = np.random.default_rng(11)
    size = 101
    t = ttables.AsyncArrayTable(size, name="fz_a", ctx=port_ranks[0])
    ttables.AsyncArrayTable(size, name="fz_a", ctx=port_ranks[1])
    model = np.zeros(size, np.float32)
    for _ in range(80):
        op = rng.choice(["add", "add_async", "get"])
        if op in ("add", "add_async"):
            d = rng.normal(size=size).astype(np.float32)
            (t.add if op == "add" else t.add_async)(d)
            model += d
        else:
            np.testing.assert_allclose(t.get(), model, rtol=2e-5,
                                       atol=2e-4)
    t.flush()
    np.testing.assert_allclose(t.get(), model, rtol=2e-5, atol=2e-4)


def test_async_sparse_matrix_matches_numpy_model(port_ranks):
    rng = np.random.default_rng(23)
    rows, cols = 29, 3
    t0 = ttables.AsyncSparseMatrixTable(rows, cols, name="fz_s",
                                        ctx=port_ranks[0])
    t1 = ttables.AsyncSparseMatrixTable(rows, cols, name="fz_s",
                                        ctx=port_ranks[1])
    model = np.zeros((rows, cols), np.float32)
    for _ in range(100):
        op = rng.choice(["add0", "add1", "sparse0", "sparse1", "plain"])
        if op in ("add0", "add1"):
            k = int(rng.integers(1, 8))
            ids = rng.integers(0, rows, k)
            vals = rng.normal(size=(k, cols)).astype(np.float32)
            (t0 if op == "add0" else t1).add_rows(ids, vals)
            np.add.at(model, ids, vals)
        elif op in ("sparse0", "sparse1"):
            t = t0 if op == "sparse0" else t1
            ids = np.unique(rng.integers(0, rows, int(rng.integers(1, 10))))
            np.testing.assert_allclose(t.get_rows_sparse(ids), model[ids],
                                       rtol=2e-5, atol=2e-4)
        else:
            ids = np.unique(rng.integers(0, rows, 6))
            np.testing.assert_allclose(t0.get_rows(ids), model[ids],
                                       rtol=2e-5, atol=2e-4)
    all_ids = np.arange(rows)
    np.testing.assert_allclose(t0.get_rows_sparse(all_ids), model,
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(t1.get_rows_sparse(all_ids), model,
                               rtol=2e-5, atol=2e-4)


def test_async_kv_matches_dict_model(port_ranks):
    rng = np.random.default_rng(13)
    t = ttables.AsyncKVTable(name="fz_kv", ctx=port_ranks[0])
    ttables.AsyncKVTable(name="fz_kv", ctx=port_ranks[1])
    model = {}
    for _ in range(60):
        if rng.random() < 0.7:
            keys = rng.integers(0, 40, rng.integers(1, 5)).tolist()
            vals = rng.normal(size=len(keys)).tolist()
            t.add(keys, vals)
            for k, v in zip(keys, vals):
                model[k] = model.get(k, 0.0) + v
        else:
            got = t.get()
            assert set(got) == set(model)
            for k, v in model.items():
                assert abs(got[k] - v) < 1e-3
    got = t.get()
    for k, v in model.items():
        assert abs(got[k] - v) < 1e-3


# ---------------------------------------------------------------------- #
# pipelined sparse pulls
# ---------------------------------------------------------------------- #
def test_two_sparse_pulls_in_flight(port_ranks):
    t0 = ttables.AsyncSparseMatrixTable(12, 2, num_workers=2, name="pp",
                                        ctx=port_ranks[0])
    t1 = ttables.AsyncSparseMatrixTable(12, 2, num_workers=2, name="pp",
                                        ctx=port_ranks[1])
    lo, hi = np.arange(6), np.arange(6, 12)
    a = t0.get_rows_sparse_async(lo, worker_id=0)
    b = t0.get_rows_sparse_async(hi, worker_id=0)
    t0.wait(a)
    assert t0.last_transfer_rows == 6
    t0.wait(b)
    assert t0.last_transfer_rows == 6
    a = t0.get_rows_sparse_async(lo, worker_id=0)
    b = t0.get_rows_sparse_async(hi, worker_id=0)
    t0.wait(a)
    assert t0.last_transfer_rows == 0
    t0.wait(b)
    assert t0.last_transfer_rows == 0
    t1.add_rows([2, 8], np.ones((2, 2), np.float32))
    a = t0.get_rows_sparse_async(lo, worker_id=0)
    b = t0.get_rows_sparse_async(hi, worker_id=0)
    ra = t0.wait(a)
    assert t0.last_transfer_rows == 1
    rb = t0.wait(b)
    assert t0.last_transfer_rows == 1
    np.testing.assert_array_equal(ra[2], 1.0)
    np.testing.assert_array_equal(rb[2], 1.0)


def test_out_of_order_sparse_wait_does_not_revert(port_ranks):
    t0 = ttables.AsyncSparseMatrixTable(8, 2, num_workers=2, name="rv",
                                        ctx=port_ranks[0])
    t1 = ttables.AsyncSparseMatrixTable(8, 2, num_workers=2, name="rv",
                                        ctx=port_ranks[1])
    t0.get_rows_sparse(np.arange(8), worker_id=0)
    t1.add_rows([1], np.ones((1, 2), np.float32))
    a = t0.get_rows_sparse_async([1, 2], worker_id=0)
    with t0._lock:
        futs_a = t0._pending[a][0]
    for f in futs_a:
        f.result(timeout=10)
    t1.add_rows([1], np.ones((1, 2), np.float32))
    b = t0.get_rows_sparse_async([1, 2, 3], worker_id=0)
    rb = t0.wait(b)
    ra = t0.wait(a)
    np.testing.assert_array_equal(rb[0], 2.0)
    np.testing.assert_array_equal(ra[0], 2.0)   # not reverted
    again = t0.get_rows_sparse([1], worker_id=0)
    assert t0.last_transfer_rows == 0
    np.testing.assert_array_equal(again[0], 2.0)
    # waited out of order with overlapping rows: self-heals
    c = t0.get_rows_sparse_async(np.arange(8), worker_id=1)
    d = t0.get_rows_sparse_async(np.arange(4), worker_id=1)
    np.testing.assert_array_equal(t0.wait(d)[1], 2.0)
    np.testing.assert_array_equal(t0.wait(c)[1], 2.0)


# ---------------------------------------------------------------------- #
# the hot-row train cache on an async table
# ---------------------------------------------------------------------- #
def test_train_cache_lives_on_the_tables_device(worlds):
    """The async table's train cache keeps its mirror on the table's
    device (the Zoo's, or the context's), never on a silent CPU default;
    cached gets equal the JAX package's, and a full hit reads no wire."""
    for cfg in (tconfig, jconfig):
        cfg.set_flag("train_cache_rows", 64)
    got = {}
    for p in (J, T):
        ts = [p.t.AsyncMatrixTable(30, 4, name="tc", ctx=c, seed=2,
                                   init_scale=0.2) for c in worlds[p]]
        ids = np.arange(2, 30, 3)
        res = [ts[0].get_rows(ids)]
        ts[0].add_rows(ids, np.ones((ids.size, 4), np.float32))
        res.append(ts[0].get_rows(ids))      # write-through full hit
        ts[1].add_rows([5], np.ones((1, 4), np.float32))   # a remote push
        res.append(ts[0].get_rows(ids))      # still the cached rows
        got[p] = (res, ts[0].train_cache_stats()["hits"])
    _same(got[T][0], got[J][0], exact=True)
    assert got[T][1] == got[J][1] > 0
    tc = ttables.AsyncMatrixTable(8, 2, name="tc2", ctx=worlds[T][0])
    assert tc._train_cache.device == tc.device == torch.device("cpu")
    blk = tc.train_cache_device_block(np.array([0]), 2)
    assert blk is None   # nothing cached yet
    # a HotRowCache with no device resolves as init() does: the Zoo's
    tmv.init(device="cpu")
    assert thc.HotRowCache(4).device == torch.device("cpu")
    assert thc.make_train_cache("x", 4, np.float32, True).device.type == \
        "cpu"
