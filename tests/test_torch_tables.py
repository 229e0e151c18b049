"""Port parity: multiverso_tpu_torch's ArrayTable against multiverso_tpu's.

The JAX table lives on the 8-device CPU mesh of tests/conftest.py, the port
on the CPU (``init(device="cpu")``); the same deltas go through both. The
default/sgd updaters are one IEEE add per element, so Get must agree
exactly; the stateful updaters agree to rtol 1e-6 / atol 1e-6 (f32, sqrt
and pow may differ by a few ulp).
"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
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


def _opt(rng, worker=0):
    return (worker, float(rng.uniform(0.5, 0.95)),
            float(rng.uniform(0.01, 0.5)), float(rng.uniform(0.05, 0.5)), 0.0)


@pytest.mark.parametrize("updater", ["default", "sgd", "momentum_sgd",
                                     "adagrad", "adam", "ftrl"])
def test_add_get_matches_jax(updater):
    rng = np.random.default_rng(11)
    n = 1003
    init = rng.normal(0.0, 1.0, n).astype(np.float32)
    jt = jmv.ArrayTable(n, updater=updater, init=init, name="j")
    tt = tmv.ArrayTable(n, updater=updater, init=init, name="t")
    assert tt.padded_shape == (n + 1,)
    for _ in range(3):
        delta = (rng.normal(0.0, 1.0, n) * 0.1).astype(np.float32)
        opt = _opt(rng)
        jt.add(delta, jmv.AddOption(*opt))
        tt.add(delta, tmv.AddOption(*opt))
        got, want = tt.get(), jt.get()
        assert got.dtype == want.dtype and got.shape == want.shape
        if updater in ("default", "sgd"):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_async_ops_and_msg_ids_match_jax():
    rng = np.random.default_rng(12)
    n = 257
    jt = jmv.ArrayTable(n, name="j")
    tt = tmv.ArrayTable(n, name="t")
    ids = {"j": [], "t": []}
    for _ in range(4):
        delta = rng.normal(0.0, 1.0, n).astype(np.float32)
        ids["j"].append(jt.add_async(delta))
        ids["t"].append(tt.add_async(torch.from_numpy(delta)))
    assert ids["t"] == ids["j"] == [0, 1, 2, 3]
    for mid in ids["t"]:
        assert tt.wait(mid) is None       # adds complete; swept or waited
    for mid in ids["j"]:
        jt.wait(mid)
    gj, gt = jt.get_async(), tt.get_async()
    assert gj == gt
    # a later add must not leak into the pending get's snapshot
    jt.add(np.ones(n, np.float32))
    tt.add(np.ones(n, np.float32))
    want = jt.read(gj)
    got = tt.read(gt)
    # the JAX table merges queued async adds into one float64 sum (host-add
    # coalescing, not ported), the port applies them one by one in f32:
    # one f32 rounding per add apart
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tt.get() - got, np.ones(n, np.float32),
                               rtol=1e-6, atol=1e-6)

    # msg-id errors: same exception types in both packages
    for t in (jt, tt):
        mid = t.get_async()
        out = np.empty(n, np.float32)
        assert t.read(mid, out=out) is out
        with pytest.raises(KeyError):
            t.read(mid)                     # already consumed
        assert t.wait(12345) is None        # unknown id
        add_id = t.add_async(np.zeros(n, np.float32))
        with pytest.raises(TypeError, match="is an add"):
            t.read(add_id)                  # a pending add is not a get


def test_init_seed_and_options_match_jax():
    n = 500
    jt = jmv.ArrayTable(n, seed=3, init_scale=0.1, name="j")
    tt = tmv.ArrayTable(n, seed=3, init_scale=0.1, name="t")
    np.testing.assert_array_equal(tt.get(), jt.get())
    with pytest.raises(ValueError):
        tmv.ArrayTable(n, init=np.zeros(n + 1))
    with pytest.raises(ValueError):
        jmv.ArrayTable(n, init=np.zeros(n + 1))

    jo = jmv.create_table(jmv.ArrayTableOption(7, init=np.arange(7.0)))
    to = tmv.create_table(tmv.ArrayTableOption(7, init=np.arange(7.0)))
    np.testing.assert_array_equal(to.get(), jo.get())
    assert to.size == jo.size == 7
    with pytest.raises(TypeError):
        tmv.create_table(object())
    with pytest.raises(TypeError):
        jmv.create_table(object())


def test_integer_table_and_updater_flag():
    tconfig.set_flag("updater_type", "adagrad")
    jmv.config.set_flag("updater_type", "adagrad")
    tt = tmv.ArrayTable(9, dtype=np.int32, name="ti")
    jt = jmv.ArrayTable(9, dtype=np.int32, name="ji")
    assert type(tt.updater).__name__ == type(jt.updater).__name__ == "Updater"
    for t in (tt, jt):
        t.add(np.arange(9, dtype=np.int32))
        t.add(np.arange(9, dtype=np.int32))
    np.testing.assert_array_equal(tt.get(), jt.get())
    assert tt.get().dtype == np.int32
    ft = tmv.ArrayTable(9, name="tf")
    assert type(ft.updater).__name__ == "AdaGradUpdater"


def test_get_returns_a_copy_and_monitors_are_named():
    tt = tmv.ArrayTable(5, name="copy")
    tt.add(np.ones(5, np.float32))
    got = tt.get()
    got[:] = 7
    np.testing.assert_array_equal(tt.get(), np.ones(5, np.float32))
    snap = TDashboard.snapshot()
    assert snap["table[copy].add"].count == 1
    assert snap["table[copy].get"].count == 2


def test_api_surface():
    assert tmv.rank() == tmv.worker_id() == tmv.server_id() == 0
    assert tmv.size() == tmv.num_workers() == tmv.num_servers() == 1
    assert tmv.is_master_worker()
    assert tmv.device() == torch.device("cpu")
    tmv.barrier()
    tmv.shutdown()
    with pytest.raises(RuntimeError, match="not initialized"):
        tmv.device()
    tmv.init(["-device=cpu", "-updater_type=sgd", "-keep=me"])
    assert tmv.device() == torch.device("cpu")
    t = tmv.ArrayTable(3)
    assert type(t.updater).__name__ == "SGDUpdater"
