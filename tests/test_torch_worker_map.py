"""Port parity, ``multiverso_tpu_torch/parallel/worker_map.py``: the BSP
``worker_step`` on four gloo CPU ranks (4 workers, and 2 workers x 2 on
the shard axis) against ``multiverso_tpu``'s on a JAX worker mesh with
the same number of workers: linear least squares on an SGD ArrayTable,
the table and the merged losses step for step, and the SyncServer
guarantee (every rank holds the same table).

Tolerances: the table and the losses within 1e-5 relative (the workers'
gradients are averaged in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import multiverso_tpu as jmv
from multiverso_tpu.parallel.worker_map import (make_worker_mesh,
                                                worker_step)
from torch_mesh_worker import World

WORLD = 4
RTOL = 1e-5
STEPS = 8


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)
    return x, y


def _jax_bsp(workers, x, y):
    jmv.init(mesh=make_worker_mesh(workers, shard_axis="mv"))
    try:
        table = jmv.ArrayTable(8, updater="sgd", name="bsp")

        def grad_fn(params, batch):
            bx, by = batch["x"], batch["y"]
            w = params[:4]
            pred = bx @ w
            loss = jnp.mean((pred - by) ** 2)
            grad = 2 * (bx.T @ (pred - by)) / bx.shape[0]
            return loss, jnp.zeros_like(params).at[:4].set(grad)

        step = jax.jit(worker_step(table, grad_fn, learning_rate=0.1))
        state = table.state
        batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, batch)
            losses.append(float(loss))
        table.adopt(state)
        return np.asarray(table.get())[:8], losses
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("workers", [4, 2])
def test_bsp_matches_jax(world, workers):
    x, y = _data()
    world.submit("bsp_least_squares", workers=workers, x=x, y=y,
                 steps=STEPS)
    want_table, want_losses = _jax_bsp(workers, x, y)
    got = world.collect()
    for g in got:
        np.testing.assert_allclose(g["table"], want_table, rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(g["losses"], want_losses, rtol=RTOL)
    # the loss falls: BSP over the shards equals the large-batch step
    assert got[0]["losses"][-1] < 0.5 * got[0]["losses"][0]


def test_cnn_example_runs_on_cpu_ranks(capsys):
    """examples/cnn_worker_map.py with two workers: every worker ends with
    the same losses (the SyncServer guarantee)."""
    from multiverso_tpu_torch.examples import cnn_worker_map
    assert cnn_worker_map.main(["--device", "cpu", "--world", "2",
                                "--epochs", "1", "--batch", "512"]) == 0
    assert "2 workers" in capsys.readouterr().out


def test_dlrm_example_keeps_the_ranks_tables_equal():
    """examples/dlrm_ctr.py with two ranks: the gradients meet at their
    rows' owners and the MLP's in one all-reduce, so both ranks read the
    same tables, and the loss falls."""
    from multiverso_tpu_torch.examples import dlrm_ctr
    from multiverso_tpu_torch.parallel.mesh import spawn
    out = spawn(dlrm_ctr.rank_main, 2, "cpu", (2, 4096))
    (bce, _, _, d0), (_, _, _, d1) = out
    assert abs(d0 - d1) <= 1e-6 * d0
    assert bce[-1] < bce[0]
