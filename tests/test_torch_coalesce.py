"""Port parity, host-add coalescing: multiverso_tpu_torch's ``add_async``
of numpy deltas on a stateless linear updater (default, sgd) against
multiverso_tpu's, bit for bit (the cases of tests/test_api_and_tables.py
:59-109).

Coalescing depends on when the applier drains the queue, so each test
that compares merged adds holds the table's ``_dispatch_lock`` while it
enqueues, as the JAX test does: the applier cannot run, and everything
queued merges into one float64 sum, cast once. The deltas are drawn so
that this sum differs from the same adds applied one by one in f32, which
makes the comparison with the JAX package a test of the merge.
"""

import io

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

N = 257


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


def _deltas(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.0, 1.0, N) * 10.0 ** rng.integers(-3, 3, N))
            .astype(np.float32) for _ in range(k)]


def _count_applies(table):
    calls = []
    real = table.updater.apply

    def counted(*args):
        calls.append(1)
        return real(*args)

    table.updater.apply = counted
    return calls


@pytest.mark.parametrize("updater", ["default", "sgd"])
def test_async_adds_coalesce_into_one_apply(updater):
    """Three adds queued under the dispatch lock merge into ONE apply, and
    the table equals the JAX table bit for bit: one float64 sum, cast,
    then one f32 add. Applied one by one the f32 adds round otherwise."""
    init = np.random.default_rng(1).normal(0.0, 1.0, N).astype(np.float32)
    jt = jmv.ArrayTable(N, updater=updater, init=init, name="j")
    tt = tmv.ArrayTable(N, updater=updater, init=init, name="t")
    calls = _count_applies(tt)
    deltas = _deltas(3)
    for t in (jt, tt):
        with t._dispatch_lock:
            mids = [t.add_async(d) for d in deltas]
            assert t._addq_inflight == 3
        for m in mids:
            t.wait(m)
    assert len(calls) == 1
    got, want = tt.get(), jt.get()
    np.testing.assert_array_equal(got, want)
    seq = init.copy()
    sign = np.float32(-1.0 if updater == "sgd" else 1.0)
    for d in deltas:
        seq = seq + sign * d
    assert not np.array_equal(got, seq)   # the merge, not the sequence


def test_blocking_and_tensor_adds_apply_one_by_one():
    """A blocking add waits for its own apply, so nothing merges; a tensor
    delta never queues. Both equal the JAX table bit for bit."""
    jt = jmv.ArrayTable(N, name="j")
    tt = tmv.ArrayTable(N, name="t")
    calls = _count_applies(tt)
    for d in _deltas(3, seed=2):
        jt.add(d)
        tt.add(d)
    assert len(calls) == 3
    mid = tt.add_async(torch.from_numpy(_deltas(1, seed=3)[0]))
    assert tt._addq_inflight == 0 and len(calls) == 4
    jt.add(_deltas(1, seed=3)[0])
    assert tt.wait(mid) is None
    np.testing.assert_array_equal(tt.get(), jt.get())


def test_momentum_adds_do_not_coalesce():
    """A stateful updater keeps one apply per add (three momentum applies
    are not one summed apply): smooth = .5, .75, .875, data = -2.125 in
    both packages."""
    jt = jmv.ArrayTable(16, updater="momentum_sgd", name="j")
    tt = tmv.ArrayTable(16, updater="momentum_sgd", name="t")
    for _ in range(3):
        jt.wait(jt.add_async(np.ones(16, np.float32),
                             JAddOption(momentum=0.5)))
        tt.wait(tt.add_async(np.ones(16, np.float32),
                             AddOption(momentum=0.5)))
        assert tt._addq_inflight == 0 and not tt._addq
    np.testing.assert_allclose(tt.get(), -2.125, rtol=1e-6)
    np.testing.assert_array_equal(tt.get(), jt.get())


def _read_state(t):
    return np.asarray(t.state["data"]).reshape(-1)[: t.shape[0]].copy()


def _read_raw(t):
    return np.asarray(t.raw()).reshape(-1)[: t.shape[0]].copy()


def _read_get_async(t):
    return t.read(t.get_async())


def _read_store(t):
    buf = io.BytesIO()
    t.store(buf)
    buf.seek(0)
    return np.load(buf)[: t.shape[0]]


READS = {"state": _read_state, "raw": _read_raw,
         "get": lambda t: t.get(), "get_async": _read_get_async,
         "store": _read_store}


@pytest.mark.parametrize("read", list(READS))
def test_reads_flush_queued_adds_even_under_dispatch_lock(read):
    """A read made while holding the dispatch lock (the fused WE path
    reads ``state`` so) drains the queue itself instead of waiting on the
    applier thread: it sees the add, in both packages, and does not hang."""
    out = {}
    for pkg, t in (("j", jmv.ArrayTable(32, updater="sgd", name="j")),
                   ("t", tmv.ArrayTable(32, updater="sgd", name="t"))):
        with t._dispatch_lock:
            t.add_async(np.ones(32, np.float32))
            out[pkg] = READS[read](t)
        assert t._addq_inflight == 0
    np.testing.assert_array_equal(out["t"], -1.0)
    np.testing.assert_array_equal(out["t"], out["j"])


@pytest.mark.parametrize("write", ["load", "adopt"])
def test_writes_flush_queued_adds_first(write):
    """``load`` and ``adopt`` replace the state: an add queued before them
    must apply first, not land on top of the replaced state afterwards."""
    tt = tmv.ArrayTable(32, updater="sgd", name="t")
    buf = io.BytesIO()
    tt.store(buf)
    new = tt.state["data"].clone()
    with tt._dispatch_lock:
        tt.add_async(np.ones(32, np.float32))
        if write == "load":
            buf.seek(0)
            tt.load(buf)
        else:
            tt.adopt({"data": new, "ustate": tt.state["ustate"]})
    assert tt._addq_inflight == 0
    np.testing.assert_array_equal(tt.get(), 0.0)


def test_row_reads_flush_queued_whole_table_adds():
    jt = jmv.MatrixTable(6, 4, name="j")
    tt = tmv.MatrixTable(6, 4, name="t")
    d = np.arange(24, dtype=np.float32).reshape(6, 4)
    for t in (jt, tt):
        with t._dispatch_lock:
            t.add_async(d)
            rows = t.get_rows([5, 0, 5])
        np.testing.assert_array_equal(rows, d[[5, 0, 5]])


def test_pipelined_adds_are_exact_and_ids_match():
    """Many pipelined adds without the lock: the applier merges them into
    batches that depend on timing; the msg ids are those of the JAX
    table, every wait returns None, and the table equals float64 partial
    sums of the same deltas (here: within one f32 rounding per add of the
    sequential sum)."""
    jt = jmv.ArrayTable(N, name="j")
    tt = tmv.ArrayTable(N, name="t")
    deltas = _deltas(20, seed=4)
    jids = [jt.add_async(d) for d in deltas]
    tids = [tt.add_async(d) for d in deltas]
    assert tids == jids
    assert all(tt.wait(m) is None for m in tids)
    want = np.sum(np.stack(deltas).astype(np.float64), 0)
    np.testing.assert_allclose(tt.get(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.get(), jt.get(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wire", ["bf16", "1bit", "topk"])
def test_wire_filtered_adds_coalesce_like_jax(wire):
    """A wire-filtered table coalesces too: the queued deltas merge, then
    ONE encode and one apply, bit for bit as in the JAX package."""
    jt = jmv.ArrayTable(N, name="j", wire_filter=wire)
    tt = tmv.ArrayTable(N, name="t", wire_filter=wire)
    calls = _count_applies(tt)
    for rnd in range(2):
        deltas = _deltas(3, seed=10 + rnd)
        for t in (jt, tt):
            with t._dispatch_lock:
                mids = [t.add_async(d) for d in deltas]
            for m in mids:
                t.wait(m)
        np.testing.assert_array_equal(tt.get(), jt.get())
    assert len(calls) == 2
