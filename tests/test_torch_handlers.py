"""Port parity, the binding handlers: multiverso_tpu_torch.handlers against
multiverso_tpu.handlers on the same numpy inputs (the cases of
tests/test_bindings.py::TestHandlers, and the rest of the surface: async
and sync adds, row reads and adds, the keyword-only rules), and the XOR
example trained on them against the repo's examples/xor_mlp.py.

The handlers add and read float32 tables with the default updater, so
every table comparison is exact, but where async adds may coalesce (see
test_adds_sync_and_async_agree). The XOR example runs 1,000 gradient
steps of a 2-4-1 MLP in f32 in each package (XLA's fused loop against
torch's eager ops: tanh, sigmoid and log are each library's own), so its
printed losses are held within 1e-4, the print's last digit."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.handlers import ArrayTableHandler as JArray
from multiverso_tpu.handlers import MatrixTableHandler as JMatrix
from multiverso_tpu_torch.handlers import ArrayTableHandler as TArray
from multiverso_tpu_torch.handlers import MatrixTableHandler as TMatrix
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stop_port():
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


@pytest.fixture
def both():
    jmv.init()
    tmv.init(device="cpu")
    yield
    _stop_port()
    jmv.shutdown()


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_array_handler_roundtrip(both):
    init = np.arange(100, dtype=np.float32)
    hs = [cls(100, init_value=init, name="h_arr") for cls in (JArray, TArray)]
    for h in hs:
        np.testing.assert_allclose(h.get(), np.arange(100))
        h.add(np.ones(100))
    _same(hs[0].get(), hs[1].get())
    np.testing.assert_allclose(hs[1].get(), np.arange(100) + 1)


def test_matrix_handler(both):
    hs = [cls(10, 4, name="h_mat") for cls in (JMatrix, TMatrix)]
    for h in hs:
        h.add(np.ones((10, 4)))
        np.testing.assert_allclose(h.get(), 1.0)
        h.add_rows([2, 3], np.full((2, 4), 2.0, np.float32))
        np.testing.assert_allclose(h.get_rows([2]), 3.0)
    _same(hs[0].get(), hs[1].get())


@pytest.mark.parametrize("sync", [False, True])
def test_adds_sync_and_async_agree(both, sync):
    rng = np.random.default_rng(3)
    init = rng.normal(size=(6, 5)).astype(np.float32)
    deltas = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(4)]
    rows = [np.array([0, 4]), np.array([5, 1, 1])]
    vals = [rng.normal(size=(len(r), 5)).astype(np.float32) for r in rows]
    out = []
    for arr_cls, mat_cls in ((JArray, JMatrix), (TArray, TMatrix)):
        a = arr_cls(30, init_value=init.reshape(-1), name=f"h_a{sync}")
        m = mat_cls(6, 5, init_value=init, name=f"h_m{sync}")
        for d in deltas:
            a.add(d.reshape(-1), sync=sync)
            m.add(d, sync=sync)
        for r, v in zip(rows, vals):
            m.add(v, row_ids=r, sync=sync)
        whole = np.empty((6, 5), np.float32)
        m.get(out=whole)
        out.append((a.get(), whole, m.get([1, 4]), m.get_rows([5])))
    for j, t in zip(*out):
        if sync:
            _same(j, t)
        else:
            # async numpy adds coalesce into one float64 sum whenever the
            # table's applier finds them queued, in either package at its
            # own timing: the tables then differ by the f32 rounding of
            # up to 6 adds into values of |x| < 8 (1e-6 covers 2 ulps there)
            np.testing.assert_allclose(j, t, rtol=0, atol=1e-6)


def test_port_takes_tensors_on_its_device(both):
    h = TMatrix(3, 2, init_value=torch.ones(3, 2), name="h_t")
    h.add(torch.full((3, 2), 2.0), sync=True)
    np.testing.assert_array_equal(h.get(), np.full((3, 2), 3.0, np.float32))
    a = TArray(4, init_value=torch.arange(4.0), name="h_ta")
    a.add(torch.ones(4))
    np.testing.assert_array_equal(a.get(), np.arange(4.0) + 1)


@pytest.mark.parametrize("cls", [JMatrix, TMatrix], ids=["jax", "torch"])
def test_row_ids_must_be_integers(both, cls):
    h = cls(4, 2, name="h_ids")
    with pytest.raises(TypeError, match="row_ids must be integers"):
        h.get(np.zeros((4, 2), np.float32))
    with pytest.raises(TypeError, match="row_ids must be integers"):
        h.add(np.zeros((2, 2), np.float32), np.array([0.5, 1.5]))


def _losses(text: str):
    return [(int(r), float(x)) for r, x in
            re.findall(r"round\s+(\d+) loss ([0-9.]+)", text)]


def test_xor_mlp_matches_the_jax_example(capsys):
    # the JAX example in a process of its own, on the CPU (with the port's
    # run after it in one process, that process aborted at its exit half
    # the time: XLA's and torch's threads at teardown)
    code = ("from multiverso_tpu.utils.platform import force_cpu_mesh; "
            "force_cpu_mesh(1); import runpy; "
            "runpy.run_path('examples/xor_mlp.py', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    want = _losses(res.stdout)

    from multiverso_tpu_torch.examples import xor_mlp
    try:
        assert xor_mlp.main(["--device", "cpu"]) == 0
    finally:
        _stop_port()
    printed = capsys.readouterr().out
    assert "XOR SOLVED" in printed
    got = _losses(printed)
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 5, 10, 15]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want],
                               rtol=0, atol=1e-4)
