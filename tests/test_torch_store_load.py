"""Port parity, checkpoints: ``Table.store``/``load`` and
``KVTable.store``/``load`` of multiverso_tpu_torch, round trips and both
directions across packages, bit for bit (tests/test_api_and_tables.py:128's
round trip, then a file written by either package loaded into the other).

The format is the JAX package's: ``np.save`` of the padded data, the
updater-state leaf count, then the leaves in ``jax.tree.flatten`` order
(sorted dict keys). The JAX table pads rows to a multiple of its mesh's
devices, so the cross-package cases run the JAX Zoo on one CPU device,
where both packages pad to rows + 1.
"""

import io

import jax
import numpy as np
import pytest

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

UPDATERS = ["default", "sgd", "momentum_sgd", "adagrad", "adam", "ftrl"]
OPT = dict(momentum=0.9, learning_rate=0.1, rho=0.1)


@pytest.fixture(autouse=True)
def _both_runtimes():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))
    tmv.init(device="cpu")
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _train(t, opt_cls, n, seed, adds=2):
    rng = np.random.default_rng(seed)
    for _ in range(adds):
        t.add(rng.normal(0.0, 1.0, n).astype(np.float32), opt_cls(**OPT))


def _stored(t) -> io.BytesIO:
    buf = io.BytesIO()
    t.store(buf)
    buf.seek(0)
    return buf


def _saved_arrays(buf):
    """Every array of a checkpoint, in order."""
    out = []
    buf.seek(0)
    while buf.tell() < len(buf.getbuffer()):
        out.append(np.load(buf))
    buf.seek(0)
    return out


@pytest.mark.parametrize("updater", UPDATERS)
def test_round_trip(updater):
    """store, more adds, load: Get and the updater state are the stored
    ones bit for bit, and the next add continues from them as the JAX
    table does."""
    n = 50
    t = tmv.ArrayTable(n, updater=updater, name="t")
    _train(t, AddOption, n, 0)
    buf = _stored(t)
    snap = t.get().copy()
    state = {k: v.clone() for k, v in t.state["ustate"].items()}
    v0 = t.version
    _train(t, AddOption, n, 1)
    assert not np.array_equal(t.get(), snap)
    t.load(buf)
    assert t.version > v0
    np.testing.assert_array_equal(t.get(), snap)   # not the cached Get
    for k, v in t.state["ustate"].items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())


@pytest.mark.parametrize("updater", UPDATERS)
def test_checkpoints_cross_packages(updater):
    """A file the JAX table stored loads into the port's table, and one
    the port stored loads into the JAX table: the same arrays, bit for
    bit, and the tables then agree after one more add: bit for bit for
    default and sgd (one IEEE add), to 1e-6 for the stateful updaters
    (as tests/test_torch_tables.py holds them: the libraries group and
    round their products, sqrt and pow apart)."""
    n = 61
    jt = jmv.ArrayTable(n, updater=updater, name="j")
    tt = tmv.ArrayTable(n, updater=updater, name="t")
    _train(jt, JAddOption, n, 2)
    jbuf, tbuf = _stored(jt), _stored(tt)
    tt.load(jbuf)
    want = _saved_arrays(jbuf)
    got = _saved_arrays(_stored(tt))
    assert len(got) == len(want) == 2 + len(tt.state["ustate"])
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    # and back: the port's (fresh) checkpoint into the JAX table
    jt.load(tbuf)
    np.testing.assert_array_equal(jt.get(), np.zeros(n, np.float32))
    jt.load(_stored(tt))
    np.testing.assert_array_equal(jt.get(), tt.get())
    _train(jt, JAddOption, n, 3, adds=1)
    _train(tt, AddOption, n, 3, adds=1)
    if updater in ("default", "sgd"):
        np.testing.assert_array_equal(tt.get(), jt.get())
    else:
        np.testing.assert_allclose(tt.get(), jt.get(), rtol=1e-6, atol=1e-6)


def test_matrix_table_cross_packages_and_errors():
    """A MatrixTable checkpoint crosses too; a padded shape or an updater
    state that differs raises ValueError in both packages."""
    rows, cols = 9, 5
    jt = jmv.MatrixTable(rows, cols, updater="adagrad", name="j", seed=1,
                         init_scale=0.5)
    jt.add_rows([1, 4, 4], np.ones((3, cols), np.float32),
                JAddOption(**OPT))
    tt = tmv.MatrixTable(rows, cols, updater="adagrad", name="t")
    tt.load(_stored(jt))
    np.testing.assert_array_equal(tt.get(), jt.get())
    np.testing.assert_array_equal(tt.state["ustate"]["g_sqr"].numpy(),
                                  np.asarray(jt.state["ustate"]["g_sqr"]))
    other = _stored(tmv.MatrixTable(rows + 1, cols, updater="adagrad"))
    for t in (jt, tt):
        other.seek(0)
        with pytest.raises(ValueError, match="shape"):
            t.load(other)
    plain = _stored(tmv.MatrixTable(rows, cols, updater="default"))
    for t in (jt, tt):
        plain.seek(0)
        with pytest.raises(ValueError, match="updater state"):
            t.load(plain)


def test_kv_table_cross_packages():
    """The KV map as sorted int64 keys and float64 values: a round trip in
    the port, and both directions across packages."""
    jk, tk = jmv.KVTable(name="jk"), tmv.KVTable(name="tk")
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 50, 20).tolist()
    vals = rng.integers(1, 1000, 20).tolist()
    jk.add(keys, vals)
    tk.add(keys, vals)
    buf = io.BytesIO()
    tk.store(buf)
    jbuf = io.BytesIO()
    jk.store(jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    snap = tk.get()
    tk.add([1, 2], [5, 5])
    buf.seek(0)
    tk.load(buf)
    assert tk.get() == snap
    jk2, tk2 = jmv.KVTable(name="jk2"), tmv.KVTable(name="tk2")
    buf.seek(0)
    jk2.load(buf)
    jbuf.seek(0)
    tk2.load(jbuf)
    assert jk2.get() == tk2.get() == snap
    assert all(type(v) is int for v in tk2.get().values())
