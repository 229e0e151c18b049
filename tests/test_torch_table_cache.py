"""Port parity, the whole-table read path: multiverso_tpu_torch's
version-stamped get cache and write-triggered prefetch against
multiverso_tpu's, step by step (the prefetch cases of
tests/test_get_path.py:536-620), and the version bump of every path that
writes a table's live tensors in place.

Each sequence of adds and gets runs on both packages; after each step the
tables, their Dashboard counters (``table[X].get.cached``,
``table[X].get.prefetched``) and the prefetch state agree. Gets are
compared bit for bit.
"""

import io

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu.utils.dashboard import Dashboard as JDashboard
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init()
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()
    JDashboard.reset()


def _count(dash, name):
    return dash.snapshot()[name].count if name in dash.snapshot() else 0


class _Both:
    """The same table in both packages, driven step by step."""

    def __init__(self, n, **kw):
        self.j = jmv.ArrayTable(n, name="j", **kw)
        self.t = tmv.ArrayTable(n, name="t", **kw)
        self.n = n

    def add(self, delta):
        self.j.add(delta)
        self.t.add(delta)

    def get(self):
        got, want = self.t.get(), self.j.get()
        np.testing.assert_array_equal(got, want)
        return got

    def counts(self, what):
        return (_count(TDashboard, f"table[t].get.{what}"),
                _count(JDashboard, f"table[j].get.{what}"))

    def prefetch_state(self):
        return ((self.t._get_prefetch is not None, self.t._prefetch_armed,
                 self.t._prefetch_backoff, self.t._prefetch_skip),
                (self.j._get_prefetch is not None, self.j._prefetch_armed,
                 self.j._prefetch_backoff, self.j._prefetch_skip))


def test_get_cache_hits_at_an_unchanged_version():
    """A second Get with no add between is a hit (one more
    ``.get.cached``), equal to the first, and a copy: changing what Get
    returned changes no later Get. An add moves the version and misses."""
    b = _Both(300, updater="sgd")
    rng = np.random.default_rng(0)
    b.add(rng.normal(size=300).astype(np.float32))
    v = b.t.version
    first = b.get()
    assert b.counts("cached") == (0, 0)
    again = b.get()
    assert b.counts("cached") == (1, 1)
    np.testing.assert_array_equal(again, first)
    again[:] = 7.0
    np.testing.assert_array_equal(b.get(), first)
    out = np.empty(300, np.float32)
    assert b.t.get(out=out) is out
    np.testing.assert_array_equal(out, first)
    b.j.get(out=np.empty(300, np.float32))
    assert b.t.version == v
    b.add(np.ones(300, np.float32))
    assert b.t.version > v
    np.testing.assert_array_equal(b.get(), first - 1.0)
    # get_async hits the cache too, and a read of it is a private copy
    mid = b.t.get_async()
    got = b.t.read(mid)
    np.testing.assert_array_equal(got, first - 1.0)
    jmid = b.j.get_async()
    np.testing.assert_array_equal(b.j.read(jmid), got)
    assert b.counts("cached")[0] == b.counts("cached")[1]


def test_get_cache_flag_off():
    tconfig.set_flag("table_get_cache", False)
    jconfig.set_flag("table_get_cache", False)
    b = _Both(64)
    b.add(np.ones(64, np.float32))
    b.get()
    b.get()
    assert b.counts("cached") == (0, 0)
    assert b.t._get_cache is None


def test_prefetch_parity_and_arming():
    """tests/test_get_path.py:536-566 on both packages: the first Get arms,
    the next add prefetches, the Get after it consumes the prefetch (one
    ``.get.prefetched``) with the same bytes a blocking Get reads; two
    adds with no Get between drop the snapshot and disarm."""
    b = _Both(512, updater="sgd")
    delta = np.random.default_rng(4).normal(size=512).astype(np.float32)
    b.add(delta)
    b.get()
    b.add(delta)
    assert b.t._get_prefetch is not None and b.j._get_prefetch is not None
    got = b.get()
    np.testing.assert_array_equal(got, b.t.raw()[:512].numpy())
    assert b.counts("prefetched") == (1, 1)
    b.add(delta)
    b.add(delta)
    st = b.prefetch_state()
    assert st[0] == st[1]
    assert b.t._get_prefetch is None and not b.t._prefetch_armed
    np.testing.assert_array_equal(b.get(), b.t.raw()[:512].numpy())


def test_prefetch_backoff_on_thrash_cadence():
    """tests/test_get_path.py:568-605: an add,add,get cadence wastes at most
    every other snapshot, an add-only burst decays to O(log N) snapshots,
    and one consumed prefetch resets the backoff; the state machine is
    the JAX one step for step."""
    b = _Both(256, updater="sgd")
    delta = np.ones(256, np.float32)
    wasted = 0
    for _ in range(8):
        b.add(delta)
        first = b.t._get_prefetch is not None
        b.add(delta)
        if first and b.t._get_prefetch is None:
            wasted += 1
        b.get()
        st = b.prefetch_state()
        assert st[0] == st[1]
    hits = b.counts("prefetched")
    assert hits[0] == hits[1] >= 2 and wasted <= 4
    dispatched = 0
    for _ in range(16):
        b.add(delta)
        dispatched += b.t._get_prefetch is not None
        st = b.prefetch_state()
        assert st[0] == st[1]
    assert dispatched <= 5
    b.get()
    for _ in range(6):
        b.add(delta)
        b.get()
    assert b.t._prefetch_backoff == b.j._prefetch_backoff == 0


def test_prefetch_flag_off_and_wire_snapshot():
    """tests/test_get_path.py:607-620: with the flag off no snapshot is
    taken. With a wire filter the prefetched snapshot is the bf16 Get."""
    tconfig.set_flag("table_get_prefetch", False)
    jconfig.set_flag("table_get_prefetch", False)
    b = _Both(128, updater="sgd")
    delta = np.ones(128, np.float32)
    b.add(delta)
    b.get()
    b.add(delta)
    assert b.t._get_prefetch is None and b.j._get_prefetch is None
    b.get()
    tconfig.set_flag("table_get_prefetch", True)
    jconfig.set_flag("table_get_prefetch", True)
    w = _Both(300, updater="sgd", wire_filter="bf16")
    d = (np.random.default_rng(1).normal(size=300) / 3).astype(np.float32)
    w.add(d)
    w.get()
    w.add(d)
    assert w.t._get_prefetch is not None
    assert w.t.memory_stats()["prefetch_bytes"] == 300 * 2
    got = w.get()
    assert w.counts("prefetched") == (1, 1)
    assert not np.any(got.view(np.uint32) & 0xFFFF)     # bf16 values


def test_in_place_writes_bump_the_version():
    """Every write of the live tensors that bypasses add: functional_add
    and functional_add_rows on the live state, adopt and load. Each moves
    the version, so the next Get reads the new state, not the cached
    one. functional_add on a copy of the state changes nothing."""
    t = tmv.MatrixTable(6, 3, name="m", updater="adagrad")
    opt = AddOption(learning_rate=0.1, rho=0.1)
    before = t.get()
    st = t.state
    copy = {"data": st["data"].clone(),
            "ustate": {k: v.clone() for k, v in st["ustate"].items()}}
    v = t.version
    t.functional_add(copy, t.pad_delta(torch.ones(6, 3)), opt)
    assert t.version == v
    np.testing.assert_array_equal(t.get(), before)
    t.functional_add(st, t.pad_delta(torch.ones(6, 3)), opt)
    assert t.version > v
    after_add = t.get()
    assert not np.array_equal(after_add, before)
    np.testing.assert_array_equal(after_add, t.raw()[:6].numpy())
    v = t.version
    t.functional_add_rows(t.state, torch.tensor([2, t.scratch_row]),
                          torch.ones(2, 3), opt)
    assert t.version > v
    np.testing.assert_array_equal(t.get(), t.raw()[:6].numpy())
    buf = io.BytesIO()
    t.store(buf)
    snap = t.get()
    t.add(np.ones((6, 3), np.float32), opt)
    buf.seek(0)
    t.load(buf)
    np.testing.assert_array_equal(t.get(), snap)
    # pad_delta matches the JAX table's (logical rows, then zero rows)
    jt = jmv.MatrixTable(6, 3, name="jm")
    d = np.arange(18, dtype=np.float32).reshape(6, 3)
    np.testing.assert_array_equal(
        t.pad_delta(torch.from_numpy(d)).numpy()[:7],
        np.asarray(jt.pad_delta(jax.numpy.asarray(d)))[:7])


def test_device_plane_epoch_is_seen_by_get():
    """The PS block path's device plane writes the live tables in place
    (functional_add_rows) and never calls adopt: a Get cached before the
    epoch must not be served after it. get, train one device-plane
    epoch, get: the two Gets differ, and the second is the trained
    table."""
    tokens = twe.synthetic_corpus(12_000, vocab=200, seed=5)
    cfg = twe.WEConfig(size=8, min_count=5, batch_size=128, negative=3,
                       data_block_size=4000, seed=9, ps_device_plane="1")
    we = twe.WordEmbedding(cfg, twe.Dictionary.build(tokens, 5))
    ids = we.prepare_ids(tokens)
    first_in, first_out = we.table_in.get(), we.table_out.get()
    we.table_in.get()
    assert _count(TDashboard, "table[embed_in].get.cached") == 1
    we.train_ps_blocks(ids, epochs=1)
    second_in, second_out = we.table_in.get(), we.table_out.get()
    assert not np.array_equal(second_in, first_in)
    assert not np.array_equal(second_out, first_out)
    np.testing.assert_array_equal(second_in,
                                  we.table_in.raw()[: len(we.dict)].numpy())
    np.testing.assert_array_equal(second_out,
                                  we.table_out.raw()[: len(we.dict)].numpy())
