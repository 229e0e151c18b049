"""Port parity, the hot-row train cache: multiverso_tpu_torch's
``serving/hotcache`` and ``ops/row_assemble`` against multiverso_tpu's,
op by op (the cases of tests/test_we_pipeline.py), then the cache in the
table layer and on the WordEmbedding PS block path.

Every cache case drives a JAX ``TrainRowCache`` and the port's with the
same operations and holds each return value, each served row and each
device block of the port to the JAX one bit for bit. The block path's
host plane with the cache on must equal the cache-off run bit for bit on
the CPU (write-through serves the rows the table holds), and match the
JAX app with the cache on as tests/test_torch_ps_blocks.py holds the
cache-off runs.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import word_embedding as jwe
from multiverso_tpu.ops import row_assemble as jrow
from multiverso_tpu.serving import hotcache as jhc
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu.utils.dashboard import Dashboard as JDashboard
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.ops import row_assemble as trow
from multiverso_tpu_torch.serving import hotcache as thc
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()
    JDashboard.reset()


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _same(a, b):
    """Return values of the two caches: equal, arrays bit for bit."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, torch.Tensor) or isinstance(a, np.ndarray):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    else:
        assert a == b


class _Both:
    """One TrainRowCache per package; ``call`` runs an op on both."""

    def __init__(self, *args, **kw):
        self.t = thc.TrainRowCache(*args, **kw)
        self.j = jhc.TrainRowCache(*args, **kw)

    def call(self, name, *args):
        got = getattr(self.t, name)(*args)
        want = getattr(self.j, name)(*args)
        _same(got, want)
        return got

    def content(self):
        _same(self.t.ids(), self.j.ids())
        assert len(self.t) == len(self.j)
        if len(self.t):
            self.call("serve_full", self.t.ids())


# ---------------------------------------------------------------------- #
# ops/row_assemble
# ---------------------------------------------------------------------- #
def test_gather_pad_rows_matches_jax():
    """The padded slots gather zero rows (sentinel H, past the last row),
    and a real position of the last row gathers that row."""
    store = _rows(50, 6, 2)
    for pos in ([4, 0, 49, 17], [49], list(range(8))):
        got = trow.gather_pad_rows(torch.from_numpy(store), pos, 8)
        want = jrow.gather_pad_rows(jnp.asarray(store), pos, 8)
        _same(got, want)
        assert not got[len(pos):].any()
    with pytest.raises(ValueError):
        trow.gather_pad_rows(torch.from_numpy(store), [4, 0, 49, 17], 3)


@pytest.mark.parametrize("n", [3, 8, 13])
def test_scatter_add_rows_matches_jax(n):
    """Unique positions, one f32 add per row, the batch padded to a
    power-of-two bucket whose sentinel slots add nothing: bit for bit
    the JAX program and numpy's ``store[pos] += delta``."""
    store = _rows(30, 5, 3)
    pos = np.random.default_rng(n).choice(30, n, replace=False)
    delta = _rows(n, 5, 4)
    got = trow.scatter_add_rows(torch.from_numpy(store.copy()), pos, delta)
    want = jrow.scatter_add_rows(jnp.asarray(store), pos, delta)
    _same(got, want)
    ref = store.copy()
    ref[pos] += delta
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------- #
# TrainRowCache, op by op against the JAX cache
# ---------------------------------------------------------------------- #
def test_fill_lookup_gather_capacity():
    c = _Both("t", 4, capacity=3)
    r = _rows(5, 4)
    assert c.call("fill", np.arange(5), r) == 3      # capacity-clipped
    pos, ok = c.call("lookup", [0, 1, 2, 3, 4])
    assert int(np.count_nonzero(ok)) == 3
    sel = np.flatnonzero(ok)[:2]
    bufs = [np.zeros((2, 4), np.float32) for _ in range(2)]
    assert c.t.gather_into(bufs[0], np.arange(2), pos[sel])
    assert c.j.gather_into(bufs[1], np.arange(2), pos[sel])
    _same(bufs[0], bufs[1])
    np.testing.assert_array_equal(bufs[0], r[sel])
    assert c.call("fill", np.arange(5), _rows(5, 4, seed=9)) == 3
    c.content()
    assert c.call("covers", [0, 1, 2]) and not c.call("covers", [0, 4])


@pytest.mark.parametrize("mode", ["writethrough", "invalidate"])
def test_pushes_write_through_or_invalidate(mode):
    wt = mode == "writethrough"
    c = _Both("t", 4, capacity=16, writethrough=wt)
    r = _rows(6, 4)
    c.call("fill", np.arange(6), r)
    d = _rows(3, 4, seed=1)
    c.call("on_push", np.array([1, 3, 5]), d if wt else None)
    c.content()
    if wt:
        want = r.copy()
        want[[1, 3, 5]] += d                    # the same IEEE f32 adds
        _, out = c.t.serve_full(np.arange(6))
        np.testing.assert_array_equal(out, want)
    else:
        assert len(c.t) == 3 and not c.t.covers([1])
    c.call("on_overwrite", np.array([0]))
    c.content()


def test_fill_since_replays_excludes_and_poisons():
    """A reply fetched at a token, pushes logged after it: write-through
    replays them (the same f32 adds), invalidate excludes the pushed
    ids, a clear poisons the whole fill, and a log overflow skips it."""
    c = _Both("t", 4, capacity=16, writethrough=True)
    token = c.call("fill_token")
    reply = _rows(4, 4)
    c.call("on_push", np.array([1, 2]), _rows(2, 4, seed=2))
    assert c.call("fill_since", np.arange(4), reply, token) == 4
    c.content()
    inv = _Both("i", 4, capacity=16, writethrough=False)
    tok = inv.call("fill_token")
    inv.call("on_push", np.array([1, 2]), None)
    assert inv.call("fill_since", np.arange(4), _rows(4, 4), tok) == 2
    inv.content()
    c2 = _Both("c", 4, capacity=16, writethrough=True)
    t2 = c2.call("fill_token")
    c2.call("clear")
    assert c2.call("fill_since", np.arange(4), _rows(4, 4), t2) == 0
    c3 = _Both("o", 4, capacity=16, writethrough=True)
    t3 = c3.call("fill_token")
    for i in range(thc.TrainRowCache._PUSH_LOG_DEPTH + 2):
        c3.call("on_push", np.array([i % 4]), _rows(1, 4, seed=i))
    assert thc.TrainRowCache._PUSH_LOG_DEPTH == \
        jhc.TrainRowCache._PUSH_LOG_DEPTH
    assert c3.call("fill_since", np.arange(4), _rows(4, 4), t3) == 0


def test_on_push_atomic_vs_concurrent_fill_since():
    """tests/test_we_pipeline.py:211-246 on the port: a fill_since that
    lands while a push is between its apply and its log entry waits for
    the push (one lock hold), so the delta survives."""
    c = thc.TrainRowCache("t", 4, capacity=16, writethrough=True)
    ids = np.array([1, 2])
    rows = _rows(2, 4)
    c.fill(ids, rows)
    token = c.fill_token()
    reply = rows.copy()
    entered, release = threading.Event(), threading.Event()
    real_note = c._note_mutation

    def paused_note(pids, pvals):
        entered.set()
        release.wait(5)
        real_note(pids, pvals)

    c._note_mutation = paused_note
    d = _rows(2, 4, seed=3)
    pusher = threading.Thread(target=c.on_push, args=(ids, d))
    pusher.start()
    assert entered.wait(5)
    filler = threading.Thread(target=c.fill_since, args=(ids, reply, token))
    filler.start()
    time.sleep(0.05)
    release.set()
    pusher.join(5)
    filler.join(5)
    del c.__dict__["_note_mutation"]
    _, out = c.serve_full(ids)
    np.testing.assert_array_equal(out, rows + d)


def test_device_mirror_blocks_refresh_and_counters():
    """The device mirror: built lazily by the first full-coverage block
    and only then; a private copy (a block served before a push keeps the
    pre-push rows); patched in place by pushes. Refresh clock, memory
    gauges, stats and Dashboard counters as in the JAX cache."""
    c = _Both("dm", 8, capacity=64, writethrough=True)
    r = _rows(32, 8)
    c.call("fill", np.arange(32), r)
    assert c.call("device_block", [0, 1, 40], 8) is None
    assert c.call("device_block", np.arange(4), 2) is None
    assert c.t._dev is None
    blk = c.call("device_block", np.arange(16), 16)
    assert c.t._dev is not None
    d = _rows(16, 8, seed=5)
    c.call("on_push", np.arange(16), d)
    np.testing.assert_array_equal(blk[:16].numpy(), r[:16])
    blk2 = c.call("device_block", np.arange(16), 16)
    np.testing.assert_array_equal(blk2[:16].numpy(), r[:16] + d)
    c.call("take_device", [3, 1])
    c.call("device_block_counted", [5, 2], 8)
    c.call("count", 5, 2)
    c.call("stats")
    ms = c.t.memory_stats()
    assert ms == {**c.j.memory_stats(), "device_bytes": 32 * 8 * 4}
    assert ms["push_log_entries"] == 1
    for name in ("train_cache_hit", "train_cache_miss"):
        assert (TDashboard.get(f"table[dm].get.{name}").count
                == JDashboard.get(f"table[dm].get.{name}").count > 0)
    rc = _Both("rc", 4, capacity=16, writethrough=True, refresh_gets=3)
    rc.call("fill", np.arange(4), _rows(4, 4))
    rc.call("on_get"), rc.call("on_get")
    assert len(rc.t) == 4
    rc.call("on_get")
    assert len(rc.t) == 0 and rc.t.refreshes == rc.j.refreshes == 1


def test_install_and_match_positions():
    hc_t, hc_j = thc.HotRowCache(4), jhc.HotRowCache(4)
    ids, rows = np.array([2, 5, 9]), _rows(3, 4)
    dev = torch.from_numpy(rows.copy())
    hc_t.install(ids, rows, dev)
    hc_j.install(ids, rows, jnp.asarray(rows))
    _same(hc_t.take_device([9, 2]), hc_j.take_device([9, 2]))
    assert hc_t.take_device([9, 3]) is None
    hc_t.clear()
    assert len(hc_t) == 0
    for cids, q in ((None, [1, 2]), (np.array([2, 5, 9]), [5, 1, 9, 10])):
        _same(thc.match_positions(cids, np.array(q)),
              jhc.match_positions(cids, np.array(q)))


def test_factory_flag_gating_and_eligibility():
    assert thc.make_train_cache("t", 4, np.float32, True) is None
    tconfig.set_flag("train_cache_rows", 8)
    tconfig.set_flag("train_cache_mode", "writethrough")
    with pytest.raises(ValueError, match="eligible"):
        thc.make_train_cache("t", 4, np.float32, writethrough_ok=False)
    tconfig.set_flag("train_cache_mode", "auto")
    c = thc.make_train_cache("t", 4, np.float32, writethrough_ok=False)
    assert c is not None and not c.writethrough and c.capacity == 8
    tconfig.set_flag("train_cache_mode", "bogus")
    with pytest.raises(ValueError):
        thc.make_train_cache("t", 4, np.float32, True)


# ---------------------------------------------------------------------- #
# the cache in MatrixTable
# ---------------------------------------------------------------------- #
def _set_both(**flags):
    for k, v in flags.items():
        tconfig.set_flag(k, v)
        jconfig.set_flag(k, v)


@pytest.mark.parametrize("mode", ["invalidate", "auto"])
def test_push_never_serves_a_stale_device_copy(mode):
    """tests/test_we_pipeline.py:399-415 in both packages: after a push,
    the next get and device block reflect it."""
    _set_both(train_cache_rows=64, train_cache_mode=mode)
    ts = [pkg.MatrixTable(32, 4, name=f"st_{mode}", updater="default",
                          seed=3, init_scale=0.1) for pkg in (tmv, jmv)]
    ids = np.arange(8)
    before = [t.get_rows(ids) for t in ts]
    _same(before[0], before[1])
    blks = [t.train_cache_device_block(ids, 8) for t in ts]
    _same(*blks)
    delta = _rows(8, 4, seed=7)
    for t in ts:
        t.add_rows(ids, delta)
    after = [t.get_rows(ids) for t in ts]
    _same(after[0], after[1])
    np.testing.assert_array_equal(after[0], before[0] + delta)
    blks = [t.train_cache_device_block(ids, 8) for t in ts]
    _same(*blks)
    if blks[0] is not None:
        np.testing.assert_array_equal(blks[0].numpy(), before[0] + delta)
    assert ts[0].train_cache_stats() == ts[1].train_cache_stats()


def test_cached_row_gets_bit_equal_uncached_and_jax():
    """tests/test_we_pipeline.py:417-442: row gets and adds with the cache
    on equal the cache-off table bit for bit (the later id sets are
    subsets of earlier ones, so full hits happen), the JAX cached table
    too, with the same hit counts."""
    t0 = tmv.MatrixTable(32, 4, name="off", seed=11, init_scale=0.1)
    _set_both(train_cache_rows=64)
    t1 = tmv.MatrixTable(32, 4, name="on", seed=11, init_scale=0.1)
    j1 = jmv.MatrixTable(32, 4, name="jon", seed=11, init_scale=0.1)
    assert t0._train_cache is None and t1._train_cache.writethrough
    rng = np.random.default_rng(0)
    for ids in (np.arange(24), np.arange(16), np.arange(8, 24),
                np.arange(4, 12), np.arange(20), np.arange(24)):
        a, b, c = t0.get_rows(ids), t1.get_rows(ids), j1.get_rows(ids)
        _same(a, b)
        _same(b, c)
        d = rng.normal(size=(ids.size, 4)).astype(np.float32)
        for t in (t0, t1, j1):
            t.add_rows(np.concatenate([ids, ids[:3]]),
                       np.concatenate([d, d[:3]]))   # duplicates summed
    np.testing.assert_array_equal(t0.get(), t1.get())
    stats = t1.train_cache_stats()
    assert stats["hits"] > 0 and stats == j1.train_cache_stats()
    _, rows = t1._train_cache.serve_full(np.arange(24))
    np.testing.assert_array_equal(rows, t1.get()[:24])
    # a whole-table add clears the cache (a coarse mutation)
    t1.add(np.ones((32, 4), np.float32))
    assert len(t1._train_cache) == 0


# ---------------------------------------------------------------------- #
# the cache on the WordEmbedding PS block path (host plane)
# ---------------------------------------------------------------------- #
SMALL = dict(size=16, min_count=5, batch_size=128, negative=3,
             data_block_size=4000, seed=9, ps_device_plane="0")


@pytest.fixture(scope="module")
def small_tokens():
    return twe.synthetic_corpus(50_000, vocab=300, seed=5)


def _run(mod, tokens, cache_rows, **kw):
    for cfg in (tconfig, jconfig):
        cfg.set_flag("train_cache_rows", cache_rows)
    we = mod.WordEmbedding(mod.WEConfig(**SMALL, **kw),
                           mod.Dictionary.build(tokens, 5))
    ids = we.prepare_ids(tokens)
    served = []
    if mod is twe:
        real = we._train_prepared

        def record(prep, nw):
            served.append(("dev_in" in prep, "dev_sec" in prep))
            return real(prep, nw)

        we._train_prepared = record
    losses = [we.train_ps_blocks(ids, epochs=1)["loss"] for _ in range(2)]
    sec = we.table_hs if we.cfg.hs else we.table_out
    return (losses, we.table_in.get(), sec.get(),
            we.table_in.train_cache_stats(), served)


@pytest.mark.parametrize("variant", [{}, {"cbow": 1, "hs": 1}],
                         ids=["sg", "cbow_hs"])
def test_host_plane_cache_on_equals_off_and_jax(small_tokens, variant):
    """Two calls of one epoch (three blocks each) on the host plane: with
    the write-through cache on, the losses and both tables equal the
    cache-off run bit for bit, cache-served device blocks included; and
    they match the JAX app with the cache on as the cache-off runs match
    it in tests/test_torch_ps_blocks.py (losses to rtol 1e-6, tables to
    atol 1e-5)."""
    off = _run(twe, small_tokens, 0, **variant)
    on = _run(twe, small_tokens, 4096, **variant)
    assert on[0] == off[0]
    np.testing.assert_array_equal(on[1], off[1])
    np.testing.assert_array_equal(on[2], off[2])
    stats = on[3]
    assert stats is not None and stats["mode"] == "writethrough"
    assert any(a for a, _ in on[4]) and any(b for _, b in on[4])
    jon = _run(jwe, small_tokens, 4096, **variant)
    np.testing.assert_allclose(on[0], jon[0], rtol=1e-6)
    np.testing.assert_allclose(on[1], jon[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(on[2], jon[2], rtol=0, atol=1e-5)
    assert stats["hits"] == jon[3]["hits"]
    assert stats["misses"] == jon[3]["misses"]


def test_pipelined_host_plane_with_cache_equals_inline(small_tokens):
    """The producer queue with the cache on changes no result either."""
    a = _run(twe, small_tokens, 4096, pipeline="1")
    b = _run(twe, small_tokens, 4096, pipeline="0")
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
