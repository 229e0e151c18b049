"""Port parity, ``multiverso_tpu_torch/parallel/collectives.py``: the
host-plane collectives of four gloo CPU ranks against
``multiverso_tpu.parallel``'s on a JAX mesh of the same shape (1-D and
(dp, tp)), the span every dispatch records, and each differentiable
collective's backward against its transpose.

The ranks are spawned once for the module (tests/torch_mesh_worker.py:
no jax in them). Tolerances: the collectives move and sum small integers
in float32, so every value is held equal; gradients too (the transposes
sum at most four exact terms).
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from multiverso_tpu import parallel as jpar
from multiverso_tpu_torch.telemetry import flightrec as tfr
from torch_mesh_worker import World

WORLD = 4
SHAPES = {"1d": [("mv", 4)], "2d": [("dp", 2), ("tp", 2)]}


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:WORLD]).reshape([n for _, n in shape])
    return Mesh(devs, tuple(a for a, _ in shape))


@pytest.mark.parametrize("which,axis", [("1d", "mv"), ("2d", "tp"),
                                        ("2d", "dp")])
def test_public_collectives_match_jax(world, which, axis):
    shape = SHAPES[which]
    n = dict(shape)[axis]
    x = np.arange(8 * n, dtype=np.float32)
    got = world.run("coll_public", shape=shape, axis=axis, x=x)
    jm = _jmesh(shape)
    want_ar = np.asarray(jpar.all_reduce(x, axis, mesh=jm))
    want_ag = np.asarray(jpar.all_gather(x, axis, mesh=jm))
    want_rs = np.asarray(jpar.reduce_scatter(x * (n * (n + 1) // 2), axis,
                                             mesh=jm))
    want_bc = np.asarray(jpar.broadcast(x, 1, axis, mesh=jm))
    c = want_rs.size // n
    for r, g in enumerate(got):
        i = g["index"]
        np.testing.assert_array_equal(g["all_reduce"], want_ar)
        np.testing.assert_array_equal(g["all_gather"], want_ag)
        np.testing.assert_array_equal(g["reduce_scatter"],
                                      want_rs[i * c:(i + 1) * c])
        np.testing.assert_array_equal(g["broadcast"], want_bc)
        # every rank's host array summed over the world of four
        np.testing.assert_array_equal(g["process_sum"],
                                      np.full(3, 0 + 1 + 2 + 3))


def test_each_dispatch_records_a_span(world):
    got = world.run("coll_public", shape=SHAPES["2d"], axis="tp",
                    x=np.arange(16, dtype=np.float32))
    for g in got:
        colls = g["collectives"]
        for op in ("all_reduce", "all_gather", "reduce_scatter",
                   "broadcast", "process_sum"):
            assert colls[op]["calls"] >= 1 and colls[op]["bytes"] > 0, op
        assert g["snapshot"]["collectives"] == colls
        assert g["snapshot"]["compiles_by_mesh"] == {}
        begins = g["events"].count(tfr.EV_COLL_BEGIN)
        assert begins == g["events"].count(tfr.EV_COLL_END)
        assert begins == sum(d["calls"] for d in colls.values())
        # CPU tensors are never staged
        assert g["staged"] == {}


def _transpose(op, xs, rs, n):
    """The expected f(x) and dx of sum_r <f(x)_r, R_r> per rank (one
    group of n ranks, the ranks in index order; R_r cut to f(x)'s
    shape)."""
    rows, w = xs[0].shape

    def R(r, shape):
        return r[:shape[0], :shape[1]]

    if op == "all_gather_grad":
        y = [np.concatenate(xs)] * n
        dx = [sum(R(r, (n * rows, w))[i * rows:(i + 1) * rows] for r in rs)
              for i in range(n)]
    elif op == "reduce_scatter_grad":
        tot = sum(xs)
        c = rows // n
        y = [tot[i * c:(i + 1) * c] for i in range(n)]
        dx = [np.concatenate([R(r, (c, w)) for r in rs])] * n
    elif op == "all_to_all":
        # split dim 0 into n, concatenate what arrives on dim 1
        c = rows // n
        y = [np.concatenate([xs[j][i * c:(i + 1) * c] for j in range(n)],
                            axis=1) for i in range(n)]
        dx = [np.concatenate([R(rs[j], (c, n * w))[:, i * w:(i + 1) * w]
                              for j in range(n)]) for i in range(n)]
    elif op == "ppermute":
        y = [xs[(i - 1) % n] for i in range(n)]
        dx = [R(rs[(i + 1) % n], (rows, w)) for i in range(n)]
    elif op == "copy_to":
        y = list(xs)
        dx = [sum(R(r, (rows, w)) for r in rs)] * n
    elif op == "reduce_from":
        y = [sum(xs)] * n
        dx = [R(r, (rows, w)) for r in rs]
    elif op == "gather_from":
        y = [np.concatenate(xs)] * n
        dx = [R(rs[i], (n * rows, w))[i * rows:(i + 1) * rows]
              for i in range(n)]
    else:   # scatter_to
        c = rows // n
        y = [xs[i][i * c:(i + 1) * c] for i in range(n)]
        dx = [np.concatenate([R(rs[j], (c, w)) for j in range(n)])] * n
    return y, dx


@pytest.mark.parametrize("op", ["all_gather_grad", "reduce_scatter_grad",
                                "all_to_all", "ppermute", "copy_to",
                                "reduce_from", "gather_from", "scatter_to"])
def test_differentiable_pairs(world, op):
    """Each backward is the pair the module names: checked on the 1-D
    mesh of four against the transpose written out in numpy."""
    rng = np.random.default_rng(3)
    n = WORLD
    xs = [rng.integers(-4, 5, (8, 3)).astype(np.float32) for _ in range(n)]
    if op in ("copy_to", "scatter_to"):
        xs = [xs[0]] * n          # a replicated value
    rs = [rng.integers(-4, 5, (32, 12)).astype(np.float32)
          for _ in range(n)]
    got = world.run("coll_grads", shape=SHAPES["1d"], axis="mv", xs=xs,
                    rs=rs)
    want_y, want_dx = _transpose(op, xs, rs, n)
    for i, g in enumerate(got):
        y, dx = g[op]
        np.testing.assert_array_equal(y, want_y[i])
        np.testing.assert_array_equal(dx, want_dx[i])


def test_lint_four_covers_the_parallel_layers():
    """The port's obs-surface lint 4 reads collectives.py ("all") and the
    files that place collectives; the shipped files are clean, and a
    torch.distributed call or a dispatch with no span is caught."""
    from multiverso_tpu_torch.tools import check_obs_surface as lint
    files = dict(lint._COLLECTIVE_SOURCES)
    assert files["multiverso_tpu_torch/parallel/collectives.py"] == "all"
    for name in ("tp", "ring", "moe", "pipeline", "worker_map"):
        assert f"multiverso_tpu_torch/parallel/{name}.py" in files
    assert lint.collective_coverage_findings() == []
    dark = {
        "multiverso_tpu_torch/parallel/collectives.py": (
            "import torch.distributed as dist\n"
            "def all_max(x, group):\n"
            "    dist.all_reduce(x, group=group)\n"
            "    return x\n"),
        "multiverso_tpu_torch/parallel/tp.py": (
            "from multiverso_tpu_torch.parallel import collectives as coll\n"
            "def _helper(x, m):\n"
            "    return coll.copy_to(x, m, 'tp')\n"
            "def layer(x, m):\n"
            "    return _helper(x, m)\n"),
    }
    found = lint.collective_coverage_findings(source_text=dark)
    assert any("collectives.py:all_max()" in f for f in found)
    assert any("tp.py:layer()" in f for f in found)


def test_spawned_ranks_import_no_jax(world):
    """After the module's cases, no rank has imported jax or a module of
    multiverso_tpu (the rank bodies and the port stand alone)."""
    world.run("coll_public", shape=SHAPES["1d"], axis="mv",
              x=np.arange(32, dtype=np.float32))
    assert world.run("loaded_modules") == [[]] * WORLD
