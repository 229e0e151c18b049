"""Port parity, ``multiverso_tpu_torch/parallel/moe.py``: the
expert-parallel MoE layer on four gloo CPU ranks against
``multiverso_tpu``'s on a JAX mesh of the same shape (ep=4 and (dp, ep)),
top-1 and top-2, with nothing dropped and under a tight capacity. The
routed experts are held equal first; then, at the same mesh size (the
capacity comes from each rank's token count), the output, the aux loss,
the dropped fraction and the gradients of sum(y * r) + 0.01 * aux; and
the layout-free oracle: with nothing dropped the gathered output equals
every expert on every token combined by the gates.

Tolerances: f32 outputs within 2e-5 absolute, aux and dropped within
1e-6, gradients within 1e-4 relative to the array's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import multiverso_tpu as jmv
from multiverso_tpu.parallel import moe as jmoe
from multiverso_tpu_torch.parallel import moe as tmoe
from multiverso_tpu_torch.parallel.mesh import one_rank_mesh
from torch_mesh_worker import World, assemble

WORLD = 4
ATOL_OUT = 2e-5
ATOL_SCALAR = 1e-6
RTOL_GRAD = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:WORLD]).reshape([n for _, n in shape])
    return Mesh(devs, tuple(a for a, _ in shape))


def _close_rel(got, want, name=""):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_GRAD * scale,
                               err_msg=name)


def _dense_oracle(x, params, top_k):
    """Every expert on every token, the top-k combined by their gates
    (tests/test_moe.py's oracle, in numpy-fed torch)."""
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ torch.from_numpy(params["router"]), -1)
    gates, topi = tmoe.top_k_gates(probs, top_k)
    h = torch.nn.functional.gelu(torch.einsum(
        "td,edh->eth", xt, torch.from_numpy(params["w1"])),
        approximate="tanh")
    out_all = torch.einsum("eth,ehd->etd", h, torch.from_numpy(params["w2"]))
    rows = torch.arange(xt.shape[0])
    y = sum(out_all[topi[:, k], rows] * gates[:, k, None]
            for k in range(top_k))
    return y.reshape(x.shape).numpy()


CASES = [
    # (mesh, batch_axis, experts, top_k, capacity_factor)
    ([("ep", 4)], None, 8, 1, 100.0),
    ([("ep", 4)], None, 8, 2, 100.0),
    ([("ep", 4)], None, 8, 2, 0.25),
    ([("dp", 2), ("ep", 2)], "dp", 4, 1, 100.0),
    ([("dp", 2), ("ep", 2)], "dp", 4, 2, 0.25),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{'x'.join(a for a, _ in c[0])}-top{c[3]}-"
                              f"cf{c[4]:g}" for c in CASES])
def test_moe_layer_matches_jax(world, case):
    shape, batch_axis, e, k, cf = CASES[case]
    cfg_kw = dict(num_experts=e, dim=8, hidden=16, capacity_factor=cf,
                  axis="ep", top_k=k)
    rng = np.random.default_rng(case)
    x = rng.normal(size=(4, 16, 8)).astype(np.float32)
    r = rng.normal(size=(4, 16, 8)).astype(np.float32)
    params = tmoe.init_experts(tmoe.MoEConfig(**cfg_kw), seed=1)
    jparams = jmoe.init_experts(jmoe.MoEConfig(**cfg_kw), seed=1)
    for key in params:     # the same draws
        np.testing.assert_array_equal(params[key], np.asarray(jparams[key]))
    world.submit("moe", shape=shape, cfg_kw=cfg_kw, params=params, x=x,
                 r=r, batch_axis=batch_axis)

    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        cfg = jmoe.MoEConfig(**cfg_kw)
        xs = jax.device_put(jnp.asarray(x),
                            NamedSharding(jm, JP(batch_axis, "ep")))
        sp = jmoe.shard_experts(jparams, cfg, jm)
        with jax.default_matmul_precision("float32"):
            probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 8)
                                   @ jparams["router"], -1)
            _, jtopi = jmoe.top_k_gates(probs, k)

            def f(p, xx):
                y, aux, dropped = jmoe.moe_layer(xx, p, cfg, jm,
                                                 batch_axis=batch_axis)
                return jnp.sum(y * r) + 0.01 * aux, (y, aux, dropped)

            (_, (y, aux, dropped)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(sp, xs)
    finally:
        jmv.shutdown()

    # first: every token goes to the same experts
    got = world.collect()
    topi = assemble([g["topi"] for g in got], (4, 16, k))
    np.testing.assert_array_equal(topi, np.asarray(jtopi).reshape(4, 16, k))
    y_full = assemble([g["y"] for g in got], x.shape)
    np.testing.assert_allclose(y_full, np.asarray(y), rtol=0, atol=ATOL_OUT)
    for g in got:
        assert abs(g["aux"] - float(aux)) <= ATOL_SCALAR
        assert abs(g["dropped"] - float(dropped)) <= ATOL_SCALAR
    if cf >= 100:
        assert float(dropped) == 0.0
        np.testing.assert_allclose(y_full, _dense_oracle(x, params, k),
                                   rtol=0, atol=ATOL_OUT)
    else:
        assert float(dropped) > 0.0
    # each rank differentiates its share of the objective (n_dp times its
    # tokens' part, plus the aux): the data ranks' mean is the gradient
    dp = dict(shape).get("dp", 1)
    _close_rel(assemble([g["dx"] for g in got], x.shape) / dp,
               np.asarray(gx), "dx")
    # expert gradients: each rank's experts, averaged over the dp copies
    for name, key in (("dw1", "w1"), ("dw2", "w2")):
        full = np.zeros_like(np.asarray(gp[key]))
        for g in got:
            a, b = g["experts"]
            full[a:b] += g[name]
        _close_rel(full / dp, np.asarray(gp[key]), name)
    # the router: all-reduced over ep on each rank, averaged over dp
    router = sum(g["drouter"] for g in got) / (WORLD // dp) / dp
    _close_rel(router, np.asarray(gp["router"]), "router")


def test_routing_helpers_match_jax():
    """k-major priority routing and the gating convention, on the JAX
    tests' own probabilities."""
    probs = np.asarray([[0.1, 0.9], [0.9, 0.1], [0.9, 0.1], [0.9, 0.1]],
                       np.float32)
    for kk, cap in ((2, 3), (1, 2), (2, 1)):
        got = tmoe._route(torch.from_numpy(probs), kk, cap)
        want = jmoe._route(jnp.asarray(probs), kk=kk, capacity=cap)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-7)


def test_validation():
    m = one_rank_mesh("ep", "cpu")
    x = torch.zeros(1, 4, 8)
    bad_k = tmoe.MoEConfig(num_experts=8, dim=8, hidden=8, top_k=9)
    p = tmoe.shard_experts(tmoe.init_experts(bad_k), bad_k, m)
    with pytest.raises(ValueError, match="top_k"):
        tmoe.moe_layer(x, p, bad_k, m)
