"""Port parity for WordEmbedding's PS block path: multiverso_tpu_torch's
``train_ps_blocks`` and its pieces against multiverso_tpu's, on the CPU,
on the same corpus, config and seeds.

Exact: the splitmix32 negative stream (numpy and jnp against numpy and
torch), the producer queue's contract, the row buckets and padding, the
packed batches. Training: both packages compute in f32 with the same
pairs, negatives and block order, so per-block losses and tables differ
only by the order of f32 sums inside the products; each test states its
bound beside the largest difference measured. ``ps_block_dtype=bf16``
rounds at other points in XLA's fused program than in the port's eager
ops, so it is held more loosely, by the first minibatch and by loss.
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
from multiverso_tpu.models import word2vec as jw2v
from multiverso_tpu.ops import row_assemble as jrow
from multiverso_tpu.tables.matrix_table import _bucket_size as jbucket
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu.utils import config as jconfig
from multiverso_tpu_torch.apps import word_embedding as twe
from multiverso_tpu_torch.io import realtext
from multiverso_tpu_torch.io.sample_reader import BlockPrepareQueue
from multiverso_tpu_torch.models import word2vec as tw2v
from multiverso_tpu_torch.ops import row_assemble as trow
from multiverso_tpu_torch.tables.matrix_table import _bucket_size as tbucket
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

# tests/test_word2vec.py:358-375's config (size 16, batch 128, 3
# negatives, blocks of 4,000 tokens, seed 9), on a corpus of three blocks
# an epoch, so the host plane's one-block staleness and the producer queue
# show
SMALL = dict(size=16, min_count=5, batch_size=128, negative=3,
             data_block_size=4000, seed=9)
VARIANTS = {"sg": {}, "sg_hs": {"hs": 1}, "cbow": {"cbow": 1},
            "cbow_hs": {"cbow": 1, "hs": 1}}
# the bench's PS cell, bench.py:158-159 (size 128, batch 8,192, 5
# negatives, window 5, blocks of 50,000, f32)
BENCH = dict(size=128, min_count=5, batch_size=8192, negative=5, window=5,
             data_block_size=50_000)


@pytest.fixture(autouse=True)
def _both_runtimes():
    # the JAX package on one CPU device: on the 8-device test mesh its
    # tables shard 8 ways and every block's gathers cross devices
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    # one intra-op thread, as in test_torch_word_embedding.py: other test
    # processes share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture(scope="module")
def small_tokens():
    return twe.synthetic_corpus(50_000, vocab=300, seed=5)


def _both(tokens, **kw):
    j = jwe.WordEmbedding(jwe.WEConfig(**kw),
                          jwe.Dictionary.build(tokens, kw["min_count"]))
    t = twe.WordEmbedding(twe.WEConfig(**kw),
                          twe.Dictionary.build(tokens, kw["min_count"]))
    ids = j.prepare_ids(tokens)
    np.testing.assert_array_equal(t.prepare_ids(tokens), ids)
    return j, t, ids


def _block_losses(we, plane: str) -> list:
    """Record the per-block losses of ``we``'s plane (device scalars on the
    device plane, floats on the host plane)."""
    name = "_train_block_device" if plane == "1" else "_train_prepared"
    out, inner = [], getattr(we, name)

    def record(*args):
        loss = inner(*args)
        out.append(loss)
        return loss

    setattr(we, name, record)
    return out


def _sec(we):
    return we.table_hs if we.cfg.hs else we.table_out


# ---------------------------------------------------------------------- #
# splitmix32 and counter_negs
# ---------------------------------------------------------------------- #
def test_splitmix32_matches_jax_bit_for_bit():
    x = np.random.default_rng(0).integers(0, 1 << 32, 4096,
                                          dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 1, 0xFFFFFFFF]
    want = jw2v.splitmix32(x)
    np.testing.assert_array_equal(np.asarray(jw2v.splitmix32(jnp.asarray(x))),
                                  want)
    np.testing.assert_array_equal(tw2v.splitmix32(x), want)
    got = tw2v.splitmix32(torch.from_numpy(x.astype(np.int64)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("base", [0, 123_456_789, 0xFFFFFFFF - 1000],
                         ids=["zero", "mid", "wraps"])
def test_counter_negs_matches_jax_bit_for_bit(base):
    """The counters [base, base + 5000) wrap past 2^32 in the last case,
    as the device plane's ``neg_seed + step * B * K`` does."""
    mask = (1 << 20) - 1
    want = jw2v.counter_negs(np.uint32(base), 5000, mask)
    np.testing.assert_array_equal(
        np.asarray(jw2v.counter_negs(jnp.uint32(base), 5000, mask)), want)
    np.testing.assert_array_equal(
        tw2v.counter_negs(np.uint32(base), 5000, mask), want)
    got = tw2v.counter_negs(torch.tensor(base, dtype=torch.int64), 5000,
                            mask)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------- #
# BlockPrepareQueue (tests/test_we_pipeline.py's cases, on the port)
# ---------------------------------------------------------------------- #
class TestBlockPrepareQueue:
    def test_ordered_delivery_under_contention(self):
        delays = np.random.default_rng(0).uniform(0, 0.003, 40)

        def fn(item, i):
            time.sleep(delays[i])      # scramble completion order
            return item * item

        with BlockPrepareQueue(list(range(40)), fn, depth=6,
                               threads=4) as q:
            assert list(q) == [i * i for i in range(40)]

    def test_depth_bounds_outstanding_production(self):
        lock = threading.Lock()
        live = {"now": 0, "peak": 0}
        consumed = threading.Event()

        def fn(item, i):
            with lock:
                live["now"] += 1
                live["peak"] = max(live["peak"], live["now"])
            # production blocks until the consumer starts, so a depth
            # violation would have every producer pile in here
            consumed.wait(2.0)
            time.sleep(0.001)
            with lock:
                live["now"] -= 1
            return item

        with BlockPrepareQueue(list(range(12)), fn, depth=3,
                               threads=8) as q:
            time.sleep(0.1)            # let the producers run to the bound
            consumed.set()
            out = list(q)
        assert out == list(range(12))
        assert live["peak"] <= 3, live["peak"]

    def test_exception_delivered_in_order(self):
        def fn(item, i):
            if item == 3:
                raise ValueError("boom at 3")
            return item

        q = BlockPrepareQueue(list(range(8)), fn, depth=4, threads=3)
        assert [q.next() for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="boom at 3"):
            q.next()
        # the failure closes the queue and drops what was produced ahead
        for _ in range(2):
            with pytest.raises(RuntimeError, match="closed"):
                q.next()
        for t in q._threads:
            t.join(timeout=5)
            assert not t.is_alive()

    def test_validates_depth_and_exhaustion(self):
        with pytest.raises(ValueError):
            BlockPrepareQueue([1], lambda x, i: x, depth=0)
        with BlockPrepareQueue([], lambda x, i: x) as q:
            with pytest.raises(StopIteration):
                q.next()


# ---------------------------------------------------------------------- #
# row buckets and padding
# ---------------------------------------------------------------------- #
def test_bucket_rows_and_pad_rows_match_jax():
    for n in (0, 1, 7, 8, 9, 100, 4096, 4097):
        assert trow.bucket_rows(n) == jrow.bucket_rows(n)
        assert trow.bucket_rows(n, 1) == jrow.bucket_rows(n, 1)
        assert tbucket(n, 64) == jbucket(n, 64)
    rows = np.random.default_rng(1).normal(size=(13, 8)).astype(np.float32)
    for bucket in (13, 16):
        got = trow.pad_rows(rows, bucket, torch.device("cpu"))
        assert got.dtype == torch.float32 and got.shape == (bucket, 8)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jrow.pad_rows(rows, bucket)))
    with pytest.raises(ValueError):
        trow.pad_rows(rows, 4)


# ---------------------------------------------------------------------- #
# MatrixTable.functional_add_rows
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("updater", ["default", "momentum_sgd", "adagrad"])
def test_functional_add_rows_matches_jax(updater):
    """Two adds of given ids, the second padded with the scratch row and
    zero deltas as the device plane pads a bucket: data and updater state
    against the JAX function's (the same IEEE operations: equal to 1 ulp),
    and the rows outside the second add keep their state."""
    rows, cols = 40, 8
    kw = dict(updater=updater, seed=3, init_scale=0.1)
    j = jmv.MatrixTable(rows, cols, name="jf", **kw)
    t = tmv.MatrixTable(rows, cols, name="tf", **kw)
    assert t.scratch_row == j.scratch_row == t.padded_shape[0] - 1
    opt = dict(momentum=0.9, learning_rate=0.1, rho=0.1)
    rng = np.random.default_rng(2)
    jstate, tstate = j.state, t.state
    first = np.arange(0, 30)
    second = np.concatenate([rng.choice(30, 12, replace=False),
                             np.full(4, t.scratch_row)])
    for ids in (first, second):
        vals = rng.normal(0, 0.05, (ids.size, cols)).astype(np.float32)
        vals[ids == t.scratch_row] = 0
        before = {k: v.clone() for k, v in tstate["ustate"].items()}
        jstate = j.functional_add_rows(jstate, jnp.asarray(ids),
                                       jnp.asarray(vals), JAddOption(**opt))
        tstate = t.functional_add_rows(tstate, torch.from_numpy(ids),
                                       torch.from_numpy(vals),
                                       AddOption(**opt))
        np.testing.assert_allclose(tstate["data"].numpy(),
                                   np.asarray(jstate["data"]), rtol=1e-6,
                                   atol=1e-7)
        assert set(tstate["ustate"]) == set(jstate["ustate"])
        for k, leaf in tstate["ustate"].items():
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jstate["ustate"][k]),
                                       rtol=1e-6, atol=1e-7)
            untouched = np.setdiff1d(np.arange(rows), ids)
            np.testing.assert_array_equal(leaf.numpy()[untouched],
                                          before[k].numpy()[untouched])
    assert tstate["data"] is t.raw()       # in place: the table's tensor


# ---------------------------------------------------------------------- #
# train_ps_blocks against the JAX app
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("plane", ["1", "0"], ids=["device", "host"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_ps_blocks_matches_jax(small_tokens, variant, plane):
    """Two calls of one epoch (three blocks each; every call draws afresh
    from the seed), f32: each block's loss to rtol 1e-6 (measured <=
    1.8e-7), both tables to atol 1e-5 (measured <= 2.5e-6, skip-gram HS's
    embed_hs at max |x| 1.4), the stats' keys and the word count."""
    j, t, ids = _both(small_tokens, ps_device_plane=plane,
                      **SMALL, **VARIANTS[variant])
    jl, tl = _block_losses(j, plane), _block_losses(t, plane)
    for _ in range(2):
        js, ts = j.train_ps_blocks(ids, epochs=1), t.train_ps_blocks(ids,
                                                                      epochs=1)
        assert set(ts) == set(js)
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-6)
    jl, tl = [float(x) for x in jl], [float(x) for x in tl]
    assert len(tl) == len(jl) == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for jt, tt in ((j.table_in, t.table_in), (_sec(j), _sec(t))):
        want = jt.get()
        assert np.abs(want).max() > 1e-2                # trained
        np.testing.assert_allclose(tt.get(), want, rtol=0, atol=1e-5)
    assert t.total_word_count() == j.total_word_count() == 2 * ids.size


@pytest.mark.parametrize("variant", ["sg", "cbow_hs"])
def test_pipelined_host_plane_equals_inline(small_tokens, variant):
    """The producer queue changes no result: the pipelined host plane's
    blocks and tables equal the inline path's bit for bit (two epochs in
    one call, so the lookahead crosses the epoch boundary)."""
    out = {}
    for pipeline in ("1", "0"):
        kw = dict(SMALL, ps_device_plane="0", pipeline=pipeline,
                  **VARIANTS[variant])
        t = twe.WordEmbedding(twe.WEConfig(**kw),
                              twe.Dictionary.build(small_tokens, 5))
        losses = _block_losses(t, "0")
        stats = t.train_ps_blocks(t.prepare_ids(small_tokens), epochs=2)
        out[pipeline] = (stats["loss"], losses, t.table_in.get(),
                         _sec(t).get())
    assert len(out["1"][1]) == 6
    assert out["1"][0] == out["0"][0] and out["1"][1] == out["0"][1]
    for a, b in zip(out["1"][2:], out["0"][2:]):
        np.testing.assert_array_equal(a, b)


def test_host_plane_pulls_before_the_previous_push(small_tokens):
    """The one-block staleness: every pull is dispatched before the push of
    the block before it, so the host plane differs from the device plane
    (which pulls after each push) while matching JAX's host plane."""
    t = twe.WordEmbedding(twe.WEConfig(**SMALL, ps_device_plane="0"),
                          twe.Dictionary.build(small_tokens, 5))
    ops = []
    for table, tag in ((t.table_in, "in"), (t.table_out, "out")):
        for name in ("get_rows_async", "add_rows_async"):
            inner = getattr(table, name)

            def op(*a, _inner=inner, _tag=f"{name[:3]}_{tag}"):
                ops.append(_tag)
                return _inner(*a)

            setattr(table, name, op)
    t.train_ps_blocks(t.prepare_ids(small_tokens), epochs=1)
    assert ops == (["get_in", "get_out"] * 2 + ["add_in", "add_out"]
                   + ["get_in", "get_out", "add_in", "add_out"]
                   + ["add_in", "add_out"])


def test_padded_minibatches_change_nothing(small_tokens):
    """The JAX scan runs the padded minibatches (valid 0); the port skips
    them. Running them too leaves the deltas and the loss unchanged: they
    read and write only the zero dummy row and weigh 0 in the loss."""
    t = twe.WordEmbedding(twe.WEConfig(**SMALL, ps_device_plane="0"),
                          twe.Dictionary.build(small_tokens, 5))
    ids = t.prepare_ids(small_tokens)
    prep = t._produce_block(ids[:4000], np.random.default_rng(1))
    valid = prep["valid"]
    assert 0 < np.count_nonzero(valid) < valid.size     # padded
    rng = np.random.default_rng(2)
    rows = [torch.from_numpy(rng.normal(0, 0.1, (prep["kb"], 16))
                             .astype(np.float32)) for _ in range(2)]
    step = t._step_fn_raw()
    batch = t._upload(prep["batch"])
    d_in, d_sec, loss = t._run_block_scan(step, *rows, valid, batch)

    ri, rs = (torch.cat([r, r.new_zeros((1, 16))]) for r in rows)
    total = 0.0
    for w, *arrs in zip(valid, *batch):
        ri, rs, lt = step(ri, rs, *arrs)
        total = total + lt * float(w)
    assert torch.equal(ri[-1], torch.zeros(16))       # the dummy row
    assert torch.equal(d_in, ri[:-1] - rows[0])
    assert torch.equal(d_sec, rs[:-1] - rows[1])
    assert float(loss) == pytest.approx(float(total) / valid.sum(),
                                        rel=1e-6)


def test_bf16_block_scan_matches_jax(small_tokens):
    """ps_block_dtype=bf16: the first block's packed batches equal JAX's,
    its first minibatch's deltas from the same rows agree to 2 bf16 ulps
    of the rows' magnitude (2^-7 of max |x|; measured 4.9e-4 at max |x|
    0.12) and the loss to one bf16 ulp (rtol 2^-7; measured 2.78125
    against 2.765625, one ulp), a scan that trains nothing gives
    exactly-zero deltas (the deltas are taken against the bf16-rounded
    rows), and a full epoch's block losses agree to rtol 5e-3 (measured
    <= 1.7e-3). Past the first minibatch the
    tables are held by loss: each minibatch rounds the rows to bf16 (an
    ulp is 2^-8 of a value), and XLA and the port round at other points."""
    kw = dict(SMALL, ps_device_plane="0", ps_block_dtype="bf16")
    j, t, ids = _both(small_tokens, **kw)
    jp = j._produce_block(ids[:4000], np.random.default_rng(1))
    tp = t._produce_block(ids[:4000], np.random.default_rng(1))
    for a, b in zip(tp["batch"], jp["batch"]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tp["valid"], jp["valid"])
    rows = [np.random.default_rng(i).normal(0, 0.03, (tp["kb"], 16))
            .astype(np.float32) for i in (3, 4)]
    one = slice(0, 1)
    jd = j._local_train_fn()(*(jnp.asarray(r) for r in rows),
                             jnp.asarray(jp["valid"][one]),
                             tuple(jnp.asarray(a[one]) for a in jp["batch"]))
    td = t._run_block_scan(t._step_fn_raw(),
                           *(torch.from_numpy(r) for r in rows),
                           tp["valid"][one],
                           tuple(a[one].long() for a in tp["batch"]))
    scale = max(np.abs(r).max() for r in rows)
    for got, want in zip(td[:2], jd[:2]):
        assert np.abs(np.asarray(want)).max() > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 ** -7 * scale)
    np.testing.assert_allclose(float(td[2]), float(jd[2]), rtol=2 ** -7)

    def untrained(a, s, *arrs):
        return a, s, torch.zeros((), dtype=a.dtype)

    d_in, d_sec, _ = t._run_block_scan(
        untrained, *(torch.from_numpy(r) for r in rows), tp["valid"],
        t._upload(tp["batch"]))
    assert not d_in.any() and not d_sec.any()

    jl, tl = _block_losses(j, "0"), _block_losses(t, "0")
    j.train_ps_blocks(ids, epochs=1), t.train_ps_blocks(ids, epochs=1)
    np.testing.assert_allclose(tl, [float(x) for x in jl], rtol=5e-3)


def test_device_plane_rules_match_jax(small_tokens):
    for mode, workers, want in (("auto", 1, True), ("auto", 2, False),
                                ("0", 1, False), ("1", 1, True)):
        for mod in (jwe, twe):
            we = mod.WordEmbedding(mod.WEConfig(**SMALL,
                                                ps_device_plane=mode),
                                   mod.Dictionary.build(small_tokens, 5))
            assert we._use_device_plane(workers) == want
    for mod in (jwe, twe):
        we = mod.WordEmbedding(mod.WEConfig(**SMALL, ps_device_plane="1"),
                               mod.Dictionary.build(small_tokens, 5))
        with pytest.raises(ValueError, match="single worker"):
            we._use_device_plane(2)


def test_host_plane_with_two_workers_matches_jax(small_tokens):
    """num_workers 2 (the flag): the host plane pushes (new - old) / 2, as
    the JAX app does with two workers' sync tables in one process."""
    jconfig.set_flag("num_workers", 2)
    tconfig.set_flag("num_workers", 2)
    j, t, ids = _both(small_tokens, **SMALL)
    assert t._ps_topology() == (2, 0) == j._ps_topology()
    js, ts = j.train_ps_blocks(ids), t.train_ps_blocks(ids)
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-6)
    np.testing.assert_allclose(t.embeddings(), j.embeddings(), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------- #
# the bench's width on the real text
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def realtext_tokens():
    return realtext.load_tokens()


def test_device_plane_at_bench_width_matches_jax(realtext_tokens):
    """Skip-gram NS on the device plane at bench.py:158-159's width over
    the first 100,000 real-text training tokens (2 blocks of 50,000, about
    37 minibatches of 8,192 pairs each; the negatives derived from the
    block's seed): both blocks' losses to rtol 1e-6 (measured 2.0e-7),
    both tables to 2e-4 of their largest magnitude (measured 1.3e-5 for
    embed_in and 5.5e-5 for embed_out: each minibatch adds thousands of
    updates into the frequent rows, which amplifies the f32 rounding of
    74 minibatches, ROADMAP.md C.1)."""
    j, t, ids = _both(realtext_tokens, **BENCH, ps_device_plane="1")
    assert t._dev_negs and j._dev_negs
    jl, tl = _block_losses(j, "1"), _block_losses(t, "1")
    js = j.train_ps_blocks(ids[:100_000], epochs=1)
    ts = t.train_ps_blocks(ids[:100_000], epochs=1)
    np.testing.assert_allclose([float(x) for x in tl],
                               [float(x) for x in jl], rtol=1e-6)
    assert len(tl) == 2 and ts["loss"] < 4.16     # below 6 ln 2: trains
    for jt, tt in ((j.table_in, t.table_in), (j.table_out, t.table_out)):
        want = jt.get()
        np.testing.assert_allclose(tt.get(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("batch", [8192, 4096, 2048])
def test_skipgram_hs_blocks_at_bench_width_match_jax_then_diverge(
        realtext_tokens, batch):
    """Skip-gram HS on the device plane at the bench width over the first
    100,000 real-text training tokens (2 blocks), f32, in both packages.
    Every minibatch adds all its pairs' updates into the Huffman root and
    the nodes below it at lr 0.025, and a block's pairs come from 50,000
    neighbouring tokens, so the block path diverges at batches where the
    fused epoch still trains (ROADMAP.md C.2): at 8,192 the first block's
    loss passes 1e6 in both packages (JAX, the whole epoch: 3.0e22, then
    NaN; measured 3.04e22 in both), after its first 8 minibatches agree
    (the deltas to 2e-5 of their max |x|, measured 7.3e-7 at 0.53; the loss
    to rtol 2e-5, measured 3.3e-7); at 4,096 the first block trains (8.6677
    in both, rtol 1e-5, measured 1.1e-7) and the second is NaN in both; at
    2,048 both blocks are finite in both, to rtol 1e-5 (measured 1.2e-7)."""
    j, t, ids = _both(realtext_tokens, **{**BENCH, "batch_size": batch},
                      hs=1, ps_device_plane="1")
    if batch == 8192:
        jp = j._produce_block(ids[:50_000], np.random.default_rng(1))
        tp = t._produce_block(ids[:50_000], np.random.default_rng(1))
        rows = [trow.pad_rows(tab.get_rows(r), b, torch.device("cpu"))
                for tab, r, b in ((t.table_in, tp["vocab"], tp["kb"]),
                                  (t.table_hs, tp["hs_rows"], tp["hkb"]))]
        eight = slice(0, 8)
        jd = j._local_train_fn()(*(jnp.asarray(r.numpy()) for r in rows),
                                 jnp.asarray(jp["valid"][eight]),
                                 tuple(jnp.asarray(a[eight])
                                       for a in jp["batch"]))
        td = t._run_block_scan(t._step_fn_raw(), *rows,
                               tp["valid"][eight],
                               tuple(a[eight] for a in
                                     t._upload(tp["batch"])))
        scale = max(float(np.abs(np.asarray(d)).max()) for d in jd[:2])
        for got, want in zip(td[:2], jd[:2]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=2e-5 * scale)
        np.testing.assert_allclose(float(td[2]), float(jd[2]), rtol=2e-5)
    jl, tl = _block_losses(j, "1"), _block_losses(t, "1")
    j.train_ps_blocks(ids[:100_000], epochs=1)
    t.train_ps_blocks(ids[:100_000], epochs=1)
    jl, tl = np.array([float(x) for x in jl]), np.array([float(x) for x in tl])
    for losses in (jl, tl):
        if batch == 8192:
            assert not losses[0] < 1e6, losses
        elif batch == 4096:
            assert np.isfinite(losses[0]) and not np.isfinite(losses[1])
        else:
            assert np.isfinite(losses).all() and losses.max() < 9, losses
    agree = {8192: 0, 4096: 1, 2048: 2}[batch]
    np.testing.assert_allclose(tl[:agree], jl[:agree], rtol=1e-5)
