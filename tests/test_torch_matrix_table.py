"""Port parity: multiverso_tpu_torch's MatrixTable and KVTable against
multiverso_tpu's, on the same ids, values and options.

Both packages sum duplicate row ids on the host in float64 and cast once,
then apply the updater to the touched rows only. With the default and sgd
updaters that is one IEEE add per element, so the tables agree bit for bit;
momentum, adagrad and adam agree to rtol 1e-6 / atol 1e-7 (f32; sqrt and
pow may differ by an ulp between the libraries), as in
test_torch_tables.py. The JAX table lives on the 8-device CPU mesh, the
port on the CPU.
"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

ROWS, COLS = 37, 6


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


def _pair(updater, init=None, seed=None, init_scale=0.0):
    kw = dict(updater=updater, init=init, seed=seed, init_scale=init_scale)
    return (jmv.MatrixTable(ROWS, COLS, name="j", **kw),
            tmv.MatrixTable(ROWS, COLS, name="t", **kw))


def _assert_tables(got, want, exact):
    assert got.dtype == want.dtype and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad", "adam"])
def test_row_add_get_matches_jax(updater):
    rng = np.random.default_rng(3)
    init = rng.normal(0.0, 1.0, (ROWS, COLS)).astype(np.float32)
    jt, tt = _pair(updater, init=init)
    exact = updater in ("default", "sgd")
    for step in range(4):
        # duplicates in every batch, in no order; f32 values whose float64
        # sum differs from an f32 running sum
        ids = rng.integers(0, ROWS, 25)
        vals = (rng.normal(0.0, 1.0, (25, COLS))
                * 10.0 ** rng.integers(-4, 2, (25, 1))).astype(np.float32)
        opt = (0, 0.9, 0.1 + 0.05 * step, 0.2, 0.0)
        jt.add_rows(ids, vals, jmv.AddOption(*opt))
        tt.add_rows(ids, vals, tmv.AddOption(*opt))
        _assert_tables(tt.get(), jt.get(), exact)
        ask = np.concatenate([ids[:7], ids[:3], [ROWS - 1, 0]])
        _assert_tables(tt.get_rows(ask), jt.get_rows(ask), exact)
    if updater == "default":
        # the order-free sum: the float64 dedupe, then one f32 add
        acc = np.zeros((ROWS, COLS), np.float64)
        rng = np.random.default_rng(3)
        init = rng.normal(0.0, 1.0, (ROWS, COLS)).astype(np.float32)
        want = init.copy()
        for _ in range(4):
            ids = rng.integers(0, ROWS, 25)
            vals = (rng.normal(0.0, 1.0, (25, COLS))
                    * 10.0 ** rng.integers(-4, 2, (25, 1))).astype(np.float32)
            acc[:] = 0
            np.add.at(acc, ids, vals.astype(np.float64))
            touched = np.unique(ids)
            want[touched] = want[touched] + acc[touched].astype(np.float32)
        np.testing.assert_array_equal(tt.get(), want)


@pytest.mark.parametrize("updater", ["momentum_sgd", "adagrad"])
def test_untouched_rows_keep_their_updater_state(updater):
    jt, tt = _pair(updater)
    rng = np.random.default_rng(5)
    opt = (0, 0.5, 0.1, 0.1, 0.0)
    first = np.array([1, 4, 4, 9])
    vals = rng.normal(size=(4, COLS)).astype(np.float32)
    jt.add_rows(first, vals, jmv.AddOption(*opt))
    tt.add_rows(first, vals, tmv.AddOption(*opt))
    key = "smooth" if updater == "momentum_sgd" else "g_sqr"
    before = tt.state["ustate"][key].clone()
    data_before = tt.get()
    second = np.array([2, 9])
    vals2 = rng.normal(size=(2, COLS)).astype(np.float32)
    jt.add_rows(second, vals2, jmv.AddOption(*opt))
    tt.add_rows(second, vals2, tmv.AddOption(*opt))
    after = tt.state["ustate"][key]
    untouched = [r for r in range(ROWS + 1) if r not in (2, 9)]
    assert torch.equal(after[untouched], before[untouched])
    assert not torch.equal(after[[2, 9]], before[[2, 9]])
    rows = [r for r in range(ROWS) if r not in (2, 9)]
    np.testing.assert_array_equal(tt.get()[rows], data_before[rows])
    jstate = np.asarray(jt.state["ustate"][key])[:ROWS]
    np.testing.assert_allclose(after[:ROWS].numpy(), jstate, rtol=1e-6,
                               atol=1e-7)
    _assert_tables(tt.get(), jt.get(), exact=False)


def test_row_id_errors_match_jax():
    jt, tt = _pair("default")
    v = np.ones((2, COLS), np.float32)
    for t in (jt, tt):
        with pytest.raises(TypeError, match="integers"):
            t.add_rows(np.array([1.0, 2.0]), v)
        with pytest.raises(TypeError, match="integers"):
            t.get_rows([0.5])
        with pytest.raises(IndexError, match="out of range"):
            t.add_rows([0, ROWS], v)
        with pytest.raises(IndexError, match="out of range"):
            t.get_rows([-1])
        with pytest.raises(ValueError, match="empty"):
            t.get_rows([])
    # a refused add changes nothing
    np.testing.assert_array_equal(tt.get(), np.zeros((ROWS, COLS),
                                                     np.float32))


def test_single_rows_async_ids_and_seeded_init_match_jax():
    jt, tt = _pair("default", seed=11, init_scale=0.25)
    np.testing.assert_array_equal(tt.get(), jt.get())
    assert tt.padded_shape == (ROWS + 1, COLS)
    assert (tt.num_row, tt.num_col) == (ROWS, COLS)
    row = np.arange(COLS, dtype=np.float32)
    jt.add_row(5, row)
    tt.add_row(5, row)
    np.testing.assert_array_equal(tt.get_row(5), jt.get_row(5))
    out = np.empty(COLS, np.float32)
    assert tt.get_row(5, out=out) is out
    ids, vals = [3, 3, 30], np.full((3, COLS), 0.5, np.float32)
    mid = tt.add_rows_async(ids, vals)
    jt.add_rows(ids, vals)
    assert tt.wait(mid) is None
    gid = tt.get_rows_async([30, 3])
    np.testing.assert_array_equal(tt.wait(gid), jt.get_rows([30, 3]))
    out = np.empty((2, COLS), np.float32)
    assert tt.get_rows([30, 3], out=out) is out


def test_create_table_and_state_adopt():
    jt = jmv.create_table(jmv.MatrixTableOption(ROWS, COLS, seed=2,
                                                init_scale=0.1))
    tt = tmv.create_table(tmv.MatrixTableOption(ROWS, COLS, seed=2,
                                                init_scale=0.1))
    assert isinstance(tt, tmv.MatrixTable)
    np.testing.assert_array_equal(tt.get(), jt.get())
    state = tt.state
    assert state["data"] is tt.raw()
    new = state["data"] + 1.0
    tt.adopt({"data": new, "ustate": state["ustate"]})
    assert tt.raw() is new
    np.testing.assert_array_equal(tt.get(), jt.get() + np.float32(1.0))
    with pytest.raises(ValueError, match="does not match"):
        tt.adopt({"data": new[:-1], "ustate": {}})


def test_kv_table_matches_jax():
    jk = jmv.KVTable(name="jk")
    tk = tmv.KVTable(name="tk")
    rng = np.random.default_rng(0)
    for _ in range(3):
        keys = rng.integers(0, 6, 5).tolist()
        vals = rng.integers(1, 100, 5).tolist()
        jk.add(keys, vals)
        tk.add(keys, vals)
    assert tk.get() == jk.get()
    assert tk.get([0, 5, 99]) == jk.get([0, 5, 99])
    assert tk.get([1, 2], global_=True) == jk.get([1, 2], global_=True)
    assert tk.raw() == jk.raw()
    assert tk[3] == jk[3] and tk[1234] == jk[1234] == 0
    assert tk.allreduce() == jk.allreduce()
    tk2 = tmv.create_table(tmv.KVTableOption(), name="kv2")
    assert isinstance(tk2, tmv.KVTable) and tk2.name == "kv2"
