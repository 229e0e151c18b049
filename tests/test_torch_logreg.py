"""Port parity, LogisticRegression: ``models/logreg.py`` and
``apps/logistic_regression.py`` of multiverso_tpu_torch against
multiverso_tpu on the same numpy inputs (the JAX package's own LR tests
are tests/test_logreg.py).

The JAX side runs on a one-device CPU mesh, where both packages pad a
table to rows + 1, so checkpoints cross between them. Torch runs on one
intra-op thread. The two packages' matrix products sum in other orders, so
tables are held by a relative tolerance (of the table's largest
magnitude) stated at each assertion; paths whose result depends on thread
timing (the pipelined pull) are held by convergence.
"""

import io

import jax
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.apps import logistic_regression as japp
from multiverso_tpu.models import logreg as jlr
from multiverso_tpu_torch.apps import logistic_regression as tapp
from multiverso_tpu_torch.models import logreg as tlr
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

# LR from the same start: the products sum in another order, and the
# convex loss does not amplify the difference, so the tables stay within
# a few f32 ulps of their largest magnitude; 1e-5 leaves room for other
# BLAS builds
TABLE_RTOL = 1e-5


def _one_device_jax():
    jmv.init(mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]), ("mv",)))


def _stop_port():
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture
def runtimes():
    _one_device_jax()
    tmv.init(device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _stop_port()


def _pairs(**over):
    base = dict(input_size="20", output_size="4", objective_type="softmax",
                updater_type="sgd", minibatch_size="32",
                learning_rate="0.5", train_epoch="1", sync_frequency="1")
    base.update({k: str(v) for k, v in over.items()})
    return base


def _both(**over):
    pairs = _pairs(**over)
    return (japp.LogReg(japp.LogRegConfig(pairs)),
            tapp.LogReg(tapp.LogRegConfig(pairs)))


def _close(a, b, rtol=TABLE_RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(a).max()), 1e-30)
    err = float(np.abs(a - b).max())
    assert err <= rtol * scale, (err, scale)


def _write_text(path, x, y, fmt):
    with open(path, "w") as f:
        for xi, yi in zip(x, y):
            if fmt == "dense":
                feats = " ".join(f"{v:.5f}" for v in xi)
            else:
                feats = " ".join(f"{j}:{v:.5f}" for j, v in enumerate(xi)
                                 if v != 0)
            f.write(f"{yi} {feats}\n")


def _sparse_set(n, dim, classes, seed, nnz=6):
    """Sparse samples from a planted weight matrix: each sample has ``nnz``
    active features in [0, dim), labels argmax of the planted logits."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(dim, classes)).astype(np.float32)
    x = np.zeros((n, dim), np.float32)
    for i in range(n):
        idx = rng.choice(dim, nnz, replace=False)
        x[i, idx] = rng.uniform(0.5, 1.5, nnz).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


# ---------------------------------------------------------------------- #
# model math
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("objective", ["sigmoid", "softmax"])
@pytest.mark.parametrize("regular", ["none", "l1", "l2"])
def test_loss_and_grad_matches_jax(objective, regular):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 13)).astype(np.float32)
    x = rng.normal(size=(16, 12)).astype(np.float32)
    y = rng.integers(0, 3, 16).astype(np.int32)
    jl, jg = jlr.loss_and_grad(jax.numpy.asarray(w), x, y, objective,
                               regular, 0.01)
    tl, tg = tlr.loss_and_grad(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(y), objective, regular, 0.01)
    # f32, one matrix product summed in another order: rtol 1e-5
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    jp = jlr.predict_proba(jax.numpy.asarray(w), x, objective)
    tp = tlr.predict_proba(torch.from_numpy(w), torch.from_numpy(x),
                           objective)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-7)


def test_synthetic_dataset_is_the_jax_one():
    jx, jy = jlr.synthetic_dataset(100, 784, 10, seed=3)
    tx, ty = tlr.synthetic_dataset(100, 784, 10, seed=3)
    assert np.array_equal(jx, tx) and np.array_equal(jy, ty)
    assert tlr.param_count(784, 10) == jlr.param_count(784, 10) == 7850


# ---------------------------------------------------------------------- #
# the fused path
# ---------------------------------------------------------------------- #
def _digits():
    from multiverso_tpu_torch.io import mnist
    return mnist.load_real(None)


@pytest.mark.parametrize("data", ["digits", "blobs784"])
def test_train_arrays_matches_jax(runtimes, data):
    if data == "digits":
        d = _digits()
        x, y, xt, yt = (d["x_train"], d["y_train"], d["x_test"],
                        d["y_test"])
        pairs = dict(input_size=64, output_size=10, minibatch_size=64,
                     learning_rate=0.05)
    else:
        x, y = tlr.synthetic_dataset(1024, 784, 10, seed=0)
        xt, yt = tlr.synthetic_dataset(512, 784, 10, seed=1)
        pairs = dict(input_size=784, output_size=10, minibatch_size=64,
                     learning_rate=0.05)
    j, t = _both(**pairs)
    js = j.train_arrays(x, y, epochs=1)
    ts = t.train_arrays(x, y, epochs=1)
    _close(t.table.get(), j.table.get())
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-4)
    # accuracy: the same argmax on (nearly) the same weights; one sample in
    # the test set may flip on a near-tie
    assert abs(t.test_arrays(xt, yt) - j.test_arrays(xt, yt)) <= 1 / len(yt)
    assert t.test_arrays(xt, yt) > 0.8


# ---------------------------------------------------------------------- #
# the use_ps host loop
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", ["dense", "libsvm"])
def test_train_file_matches_jax(runtimes, tmp_path, fmt):
    """sync_frequency=1, no pipeline: every add is applied alone before
    the next pull, in both packages, so the run is deterministic."""
    x, y = tlr.synthetic_dataset(512, 10, 3, seed=4)
    path = tmp_path / f"train.{fmt}"
    _write_text(path, x, y, fmt)
    j, t = _both(input_size=10, output_size=3, train_file=path,
                 test_file=path, reader_type=fmt, train_epoch=2)
    js, ts = j.train_file(), t.train_file()
    _close(t.table.get(), j.table.get())
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-4)
    assert t.test_file() == pytest.approx(j.test_file(), abs=1 / 512)


def test_train_file_pipelined_converges(runtimes, tmp_path):
    """sync_frequency=3 with the AsyncBuffer pull: the pulled model depends
    on the fill thread's timing and the applier's merges, in both
    packages, so both are held by convergence."""
    x, y = tlr.synthetic_dataset(1024, 10, 2, seed=6)
    path = tmp_path / "train.svm"
    _write_text(path, x, y, "libsvm")
    j, t = _both(input_size=10, output_size=2, train_file=path,
                 test_file=path, sync_frequency=3, pipeline="true",
                 train_epoch=2)
    js, ts = j.train_file(), t.train_file()
    assert ts["loss"] < 0.3 and js["loss"] < 0.3, (ts, js)
    assert t.test_file() > 0.9 and j.test_file() > 0.9
    assert TDashboard.get("logreg.minibatch").count == 64


def test_ssp_clock_ticks_per_minibatch(runtimes, tmp_path):
    x, y = tlr.synthetic_dataset(256, 10, 2, seed=7)
    path = tmp_path / "train.dense"
    _write_text(path, x, y, "dense")
    t = tapp.LogReg(tapp.LogRegConfig(_pairs(
        input_size=10, output_size=2, train_file=path, reader_type="dense",
        staleness=0, ssp_dir=tmp_path / "ssp",
        heartbeat_dir=tmp_path / "hb")))
    t.train_file()
    from multiverso_tpu.ssp import SSPClock as JSSPClock
    peer = JSSPClock(str(tmp_path / "ssp"), staleness=0, num_workers=1,
                     worker_id=0)
    assert peer.clock == 8   # 256 samples / 32 a minibatch, JAX-readable


# ---------------------------------------------------------------------- #
# the sparse path
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("objective,updater,lr", [
    ("softmax", "sgd", "0.5"), ("sigmoid", "ftrl", "0.1"),
    ("softmax", "ftrl", "0.1")])
def test_sparse_path_matches_jax(runtimes, tmp_path, objective, updater, lr):
    x, y = _sparse_set(512, 40, 2, seed=8)
    path = tmp_path / "train.svm"
    _write_text(path, x, y, "libsvm")
    j, t = _both(input_size=40, output_size=2, sparse="true",
                 objective_type=objective, updater_type=updater,
                 learning_rate=lr, train_file=path, test_file=path,
                 train_epoch=2)
    j.train_file()
    t.train_file()
    jt, tt = j.sparse_table.get(), t.sparse_table.get()
    _close(tt, jt)
    if updater == "ftrl":
        # FTRL's L1 keeps exact zeros: the same pattern in both
        assert np.array_equal(tt == 0, jt == 0)
        assert (tt == 0).any()
    assert t.test_file() == pytest.approx(j.test_file(), abs=1 / 512)
    # above the majority class's share (0.60): FTRL's default alpha 0.1
    # and L1 0.1 train slower than SGD at lr 0.5 over two epochs
    majority = max(np.mean(y), 1 - np.mean(y))
    assert t.test_file() > majority + (0.2 if updater == "sgd" else 0.02)
    assert TDashboard.get("logreg.sparse_minibatch").count == 32


def test_sparse_padding_slots_add_exact_zeros(runtimes):
    """The bias row pads the key set: the padded slots' gradient rows are
    exactly zero, so the float64 sum of the duplicates is the bias row's
    own gradient."""
    x, y = _sparse_set(32, 40, 2, seed=9, nnz=2)
    t = tapp.LogReg(tapp.LogRegConfig(_pairs(
        input_size=40, output_size=2, sparse="true")))
    prep = t._prep_sparse(x, y, None, dispatch=False)
    k = np.count_nonzero(np.any(x != 0, axis=0)) + 1
    assert prep["kb"] >= max(8, k) and prep["kb"] & (prep["kb"] - 1) == 0
    assert np.all(prep["keys_p"][k - 1:] == 40)
    _, grad = t._sparse_grad(torch.zeros(prep["kb"], 2),
                             torch.from_numpy(prep["xa"]),
                             torch.from_numpy(y))
    assert torch.all(grad[k:] == 0)


class _AsyncStub:
    """A SparseMatrixTable whose sparse pull is issued early and collected
    by ``wait``: the overlapped-pull interface the lookahead drives."""

    def __init__(self, table):
        self._t = table
        self._pulls = {}
        self._next = 0

    def __getattr__(self, name):
        return getattr(self._t, name)

    def get_rows_sparse_async(self, keys, worker_id=0):
        self._next += 1
        self._pulls[self._next] = self._t.get_rows_sparse(keys, worker_id)
        return self._next

    def wait(self, msg_id):
        return self._pulls.pop(msg_id)


def test_sparse_lookahead_trains_every_batch_once(runtimes, tmp_path):
    x, y = _sparse_set(512, 40, 2, seed=10)
    path = tmp_path / "train.svm"
    _write_text(path, x, y, "libsvm")
    t = tapp.LogReg(tapp.LogRegConfig(_pairs(
        input_size=40, output_size=2, sparse="true", pipeline="true",
        train_file=path, test_file=path, train_epoch=2)))
    t.sparse_table = _AsyncStub(t.sparse_table)
    stats = t.train_file()
    assert TDashboard.get("logreg.sparse_minibatch").count == 32
    assert not t.sparse_table._pulls
    assert stats["loss"] < 0.5 and t.test_file() > 0.8


# ---------------------------------------------------------------------- #
# checkpoints and the command line
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sparse", [False, True])
def test_save_load_across_packages(runtimes, tmp_path, sparse):
    x, y = (_sparse_set(256, 40, 2, seed=11) if sparse
            else tlr.synthetic_dataset(256, 40, 2, seed=11))
    path = tmp_path / "train.svm"
    _write_text(path, x, y, "libsvm")
    pairs = dict(input_size=40, output_size=2, train_file=path,
                 test_file=path, sparse=str(sparse).lower())
    j, t = _both(**pairs)
    j.train_file()
    t.train_file()
    j.save_model(str(tmp_path / "jax.model"))
    t.save_model(str(tmp_path / "torch.model"))
    j2, t2 = _both(**pairs)
    t2.load_model(str(tmp_path / "jax.model"))
    j2.load_model(str(tmp_path / "torch.model"))
    # bit for bit both ways, and the same accuracy
    assert np.array_equal(t2.param_table.get(), j.param_table.get())
    assert np.array_equal(j2.param_table.get(), t.param_table.get())
    assert t2.test_file() == j.test_file()   # (test_file syncs _local_w)
    assert j2.test_file() == t.test_file()
    assert np.array_equal(t2._local_w, j._local_w)


def test_command_line_matches_jax(tmp_path):
    x, y = tlr.synthetic_dataset(256, 10, 2, seed=12)
    train = tmp_path / "train.dense"
    _write_text(train, x, y, "dense")
    models = {}
    for pkg, app in (("jax", japp), ("torch", tapp)):
        cfg = tmp_path / f"{pkg}.cfg"
        models[pkg] = tmp_path / f"{pkg}.model"
        cfg.write_text(
            "# LR\ninput_size=10\noutput_size=2\nreader_type=dense\n"
            f"train_file={train}\ntest_file={train}\n"
            f"output_file={models[pkg]}\nlearning_rate=0.5\n"
            "minibatch_size=32\ntrain_epoch=2\n")
        if pkg == "jax":
            _one_device_jax()
            assert app.main([str(cfg)]) == 0
        else:
            try:
                assert app.main([str(cfg), "-device=cpu"]) == 0
            finally:
                _stop_port()
    jt = np.load(io.BytesIO(models["jax"].read_bytes()))
    tt = np.load(io.BytesIO(models["torch"].read_bytes()))
    _close(tt, jt)
    assert tapp.main([]) == 2


def test_config_errors_raise():
    with pytest.raises(ValueError, match="ssp_dir"):
        tapp.LogRegConfig({"input_size": "4", "staleness": "0"})
    with pytest.raises(ValueError, match="use_ps"):
        tapp.LogRegConfig({"input_size": "4", "staleness": "0",
                           "ssp_dir": "/tmp/x", "use_ps": "false"})
    with pytest.raises(ValueError, match="input_size"):
        tapp.LogReg(tapp.LogRegConfig({}))
    assert not TZoo.get().started


def test_entry_points_need_the_card(monkeypatch, tmp_path):
    """LogReg and the command line resolve to cuda unless asked for the
    CPU: without a card they raise, with ``-device=cpu`` they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "lr.cfg"
    train = tmp_path / "train.dense"
    x, y = tlr.synthetic_dataset(64, 4, 2, seed=13)
    _write_text(train, x, y, "dense")
    cfg.write_text(f"input_size=4\nreader_type=dense\ntrain_file={train}\n")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapp.LogReg(tapp.LogRegConfig(_pairs()))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapp.main([str(cfg)])
        assert not TZoo.get().started
        assert tapp.main([str(cfg), "-device=cpu"]) == 0
    finally:
        _stop_port()
