"""Port parity, the PyTorch binding: multiverso_tpu_torch.torch_ext's
TorchParamManager against multiverso_tpu.torch_ext's on the same seeded
``nn.Module``s, with the same local updates, ``sync`` and ``pull`` in the
same order, the flat parameters compared after every call.

Both keep a float32 table of the module's parameters padded to the same
width, seeded by worker 0, and run the same float32 arithmetic (a
subtraction for the delta, the default updater's add, the write back in
the parameter's dtype), so every comparison is bit for bit. (The file
is named apart from tests/test_torch_ext.py, the JAX package's own test
of its binding.)"""

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.torch_ext import TorchParamManager as JManager
from multiverso_tpu_torch.torch_ext import TorchParamManager as TManager
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
    jmv.shutdown()


def _mlp(seed: int, dtype=torch.float32) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                               torch.nn.Linear(7, 3)).to(dtype)


class _Scalar(torch.nn.Module):
    """A 0-d parameter and a buffer: the size-1 slot of an empty shape."""

    def __init__(self):
        super().__init__()
        self.s = torch.nn.Parameter(torch.tensor(1.25))
        self.register_buffer("b", torch.ones(2))


def _flat(m: torch.nn.Module) -> np.ndarray:
    ps = [p.detach().float().reshape(-1).numpy() for p in m.parameters()]
    return np.concatenate(ps) if ps else np.zeros(0, np.float32)


def _pair(make, name):
    mj, mt = make(), make()
    return (mj, JManager(mj, name=name)), (mt, TManager(mt, name=name))


def _same(pairs):
    (mj, gj), (mt, gt) = pairs
    np.testing.assert_array_equal(_flat(mj), _flat(mt))
    np.testing.assert_array_equal(np.asarray(gj.table.get()),
                                  gt.table.get())


@pytest.mark.parametrize("make", [lambda: _mlp(0), lambda: _mlp(1),
                                  lambda: _mlp(2, torch.float64), _Scalar,
                                  torch.nn.ReLU],
                         ids=["mlp0", "mlp1", "mlp_f64", "scalar",
                              "paramless"])
def test_sync_and_pull_match_jax(make):
    pairs = _pair(make, "tpm")
    (mj, gj), (mt, gt) = pairs
    assert gj.numel() == gt.numel()
    assert gj.table.size == gt.table.size == max(gt.numel(), 1)
    _same(pairs)
    rng = np.random.default_rng(7)
    for step in range(4):
        deltas = [rng.normal(0, 0.1, tuple(p.shape)) for p in mj.parameters()]
        for m in (mj, mt):
            with torch.no_grad():
                for p, d in zip(m.parameters(), deltas):
                    p.add_(torch.from_numpy(d).to(p.dtype))
        if step == 2:
            # a pull drops the local change, in both
            gj.pull()
            gt.pull()
        else:
            gj.sync()
            gt.sync()
        _same(pairs)


def test_training_through_sync_matches_jax():
    """SGD steps on a seeded regression with a sync after every other
    step: the same losses and parameters in both packages."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(16, 5)).astype(np.float32))
    y = x @ torch.arange(1.0, 6.0).reshape(5, 1)
    def make():
        torch.manual_seed(4)
        return torch.nn.Linear(5, 1)

    pairs = _pair(make, "tpm_train")
    losses = []
    for (m, mgr) in pairs:
        opt = torch.optim.SGD(m.parameters(), lr=0.05)
        out = []
        for step in range(6):
            opt.zero_grad()
            loss = torch.mean((m(x) - y) ** 2)
            loss.backward()
            opt.step()
            out.append(float(loss.detach()))
            if step % 2:
                mgr.sync()
        losses.append(out)
    assert losses[0] == losses[1]
    assert losses[1][-1] < losses[1][0]
    _same(pairs)
