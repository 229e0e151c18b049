"""Port parity, ``multiverso_tpu_torch/parallel/pipeline.py`` and the LM's
pipelined step: four gloo CPU ranks against ``multiverso_tpu`` on a JAX
mesh of the same shape (pp=4, (dp, pp), (pp, tp)). GPipe and the
interleaved schedule on tanh(x @ w + b) stages, with the gradients of
sum(y * r); then ``make_pp_train_step`` on the LM (plain stages, tensor
parallelism inside them, a data-parallel pipeline): the loss and the
updated params, unstacked.

Tolerances: f32 forward within 2e-5 absolute; gradients and updated
params within 1e-4 relative to the leaf's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import multiverso_tpu as jmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu.parallel import pipeline as jpp
from multiverso_tpu_torch.models import transformer as ttfm
from torch_mesh_worker import World, assemble

WORLD = 4
ATOL_OUT = 2e-5
RTOL = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:WORLD]).reshape([n for _, n in shape])
    return Mesh(devs, tuple(a for a, _ in shape))


def _close_rel(got, want, name=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _stages(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.5, (n, d, d)).astype(np.float32),
            "b": rng.normal(0, 0.1, (n, d)).astype(np.float32)}


CASES = [
    # (mesh, batch_axis, n_micro, interleaved, total stages)
    ([("pp", 4)], None, 4, False, 4),
    ([("pp", 4)], None, 2, False, 4),
    ([("dp", 2), ("pp", 2)], "dp", 2, False, 2),
    ([("pp", 4)], None, 4, True, 8),
    ([("dp", 2), ("pp", 2)], "dp", 2, True, 4),
]


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{'x'.join(a for a, _ in c[0])}-m{c[2]}"
                              f"{'-interleaved' if c[3] else ''}"
                              for c in CASES])
def test_pipeline_apply_matches_jax(world, case):
    shape, batch_axis, n_micro, inter, total = CASES[case]
    params = _stages(total, 6, seed=case)
    rng = np.random.default_rng(10 + case)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    r = rng.normal(size=(8, 6)).astype(np.float32)
    world.submit("pp_apply", shape=shape, params=params, x=x, r=r,
                 n_micro=n_micro, batch_axis=batch_axis,
                 interleaved=inter)
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        n = dict(shape)["pp"]
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        if inter:
            sp = jpp.shard_stages_interleaved(jp, n, mesh=jm)
            f = lambda p, xx: jpp.pipeline_apply_interleaved(
                lambda q, a: jnp.tanh(a @ q["w"] + q["b"]), p, xx, mesh=jm,
                batch_axis=batch_axis)
        else:
            sp = jpp.shard_stages(jp, mesh=jm)
            f = lambda p, xx: jpp.pipeline_apply(
                lambda q, a: jnp.tanh(a @ q["w"] + q["b"]), p, xx, n_micro,
                mesh=jm, batch_axis=batch_axis)
        xs = jnp.asarray(x)
        with jax.default_matmul_precision("float32"):
            y = jax.jit(f)(sp, xs)
            gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(f(p, xx) * r),
                                      argnums=(0, 1)))(sp, xs)
    finally:
        jmv.shutdown()
    got = world.collect()
    np.testing.assert_allclose(assemble([g["y"] for g in got], x.shape),
                               np.asarray(y), rtol=0, atol=ATOL_OUT)
    _close_rel(assemble([g["dx"] for g in got], x.shape), gx, "dx")
    # each rank's stage gradient; its dp copies hold their batch parts
    gw, gb = np.asarray(gp["w"]), np.asarray(gp["b"])
    dw, db = np.zeros_like(gw), np.zeros_like(gb)
    for g in got:
        dw[g["stage"]] += g["dw"]
        db[g["stage"]] += g["db"]
    _close_rel(dw, gw, "dw")
    _close_rel(db, gb, "db")


LM = dict(vocab_size=64, dim=32, num_heads=4, max_seq=16, attn="local")


@pytest.mark.parametrize("shape,extra,layers", [
    ([("pp", 4)], {}, 4),
    ([("dp", 2), ("pp", 2)], {"batch_axis": "dp"}, 4),
    ([("pp", 2), ("tp", 2)], {"tp_axis": "tp"}, 4),
], ids=["pp4", "dpxpp", "ppxtp"])
def test_pp_train_step_matches_jax(world, shape, extra, layers):
    cfg_kw = dict(LM, num_layers=layers, **extra)
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jtfm.init_params(jcfg, seed=3))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (4, 17)).astype(np.int32)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    world.submit("lm_pp", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, n_micro=2, lr=0.05, steps=2)
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        n = dict(shape)["pp"]
        with jax.default_matmul_precision("float32"):
            st = jtfm.shard_params_pp(jtfm.stack_pp_params(params, jcfg, n),
                                      mesh=jm, cfg=jcfg)
            step = jax.jit(jtfm.make_pp_train_step(jcfg, 2, 0.05, mesh=jm))
            stok = jtfm.shard_batch(tok, jcfg, jm)
            stgt = jtfm.shard_batch(tgt, jcfg, jm)
            losses = []
            for _ in range(2):
                st, loss = step(st, stok, stgt)
                losses.append(float(loss))
        want = jtfm.unstack_pp_params(jax.tree.map(np.asarray, st), jcfg)
    finally:
        jmv.shutdown()
    got = world.collect()
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, rtol=0,
                                   atol=ATOL_OUT)
    back = got[0]["params"]
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        b = back
        for k in path:
            b = b[k.key]
        _close_rel(b, w, jax.tree_util.keystr(path))


def test_pp_adamw_step_matches_optax(world):
    """make_pp_optim_train_step (torch.optim.AdamW over this rank's
    stage) against the JAX make_pp_optax_train_step (optax.adamw) on
    (dp, pp), every hyperparameter explicit."""
    optax = pytest.importorskip("optax")
    shape = [("dp", 2), ("pp", 2)]
    cfg_kw = dict(LM, num_layers=4, batch_axis="dp")
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jtfm.init_params(jcfg, seed=8))
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 64, (4, 17)).astype(np.int32)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    world.submit("lm_pp", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, n_micro=2, steps=2,
                 optim=dict(lr=1e-2, betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=hp["weight_decay"]))
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        with jax.default_matmul_precision("float32"):
            st = jtfm.shard_params_pp(jtfm.stack_pp_params(params, jcfg, 2),
                                      mesh=jm, cfg=jcfg)
            opt = optax.adamw(learning_rate=1e-2, **hp)
            ost = opt.init(st)
            step = jax.jit(jtfm.make_pp_optax_train_step(jcfg, 2, opt,
                                                         mesh=jm))
            stok = jtfm.shard_batch(tok, jcfg, jm)
            stgt = jtfm.shard_batch(tgt, jcfg, jm)
            losses = []
            for _ in range(2):
                st, ost, loss = step(st, ost, stok, stgt)
                losses.append(float(loss))
        want = jtfm.unstack_pp_params(jax.tree.map(np.asarray, st), jcfg)
    finally:
        jmv.shutdown()
    got = world.collect()
    for g in got:
        np.testing.assert_allclose(g["losses"], losses, rtol=0,
                                   atol=ATOL_OUT)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        b = got[0]["params"]
        for k in path:
            b = b[k.key]
        _close_rel(b, w, jax.tree_util.keystr(path))


def test_stacking_matches_jax():
    """stack_pp_params / unstack_pp_params give the JAX numpy trees
    (GPipe, interleaved, head-grouped qkv) and invert each other."""
    cfg_kw = dict(LM, num_layers=8, tp_axis="tp")
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    tcfg = ttfm.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jtfm.init_params(jcfg, seed=1))
    for chunks in (1, 2):
        want = jtfm.stack_pp_params(params, jcfg, 2, pp_chunks=chunks)
        got = ttfm.stack_pp_params(params, tcfg, 2, pp_chunks=chunks)
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            g = got
            for k in path:
                g = g[k.key]
            np.testing.assert_array_equal(g, np.asarray(w))
        back = ttfm.unstack_pp_params(got, tcfg, pp_chunks=chunks)
        for path, w in jax.tree_util.tree_leaves_with_path(params):
            g = back
            for k in path:
                g = g[k.key]
            np.testing.assert_array_equal(g, w)


def test_validation_matches_jax():
    from multiverso_tpu_torch.parallel.mesh import one_rank_mesh
    m = one_rank_mesh("pp", "cpu")
    jm = Mesh(np.asarray(jax.devices()[:1]), ("pp",))
    for bad, match in (({"attn": "ring"}, "local"),
                       ({"moe_experts": 4}, "dense"),
                       ({"num_layers": 3, "pp_chunks": 2}, "divisible")):
        kw = {**LM, "num_layers": 2, **bad}
        with pytest.raises(ValueError, match=match):
            ttfm.make_pp_train_step(ttfm.TransformerConfig(**kw), 2, mesh=m)
        with pytest.raises(ValueError, match=match):
            jtfm.make_pp_train_step(jtfm.TransformerConfig(**kw), 2,
                                    mesh=jm)


def test_pipelined_example_runs_on_cpu_ranks(capsys):
    """examples/pipelined_lm.py on a (dp=1, pp=2) world: the interleaved
    schedule with remat trains, and rank 0 decodes from the unstacked
    tree."""
    from multiverso_tpu_torch.examples import pipelined_lm
    assert pipelined_lm.main(["--device", "cpu", "--world", "2", "--dp",
                              "1", "--steps", "3"]) == 0
    assert "decoded shape: (2, 12)" in capsys.readouterr().out
