"""Port parity, ``multiverso_tpu_torch/parallel/tp.py`` and the LM's
tensor-parallel and FSDP layouts: four gloo CPU ranks against
``multiverso_tpu`` on a JAX mesh of the same shape (tp=4, (dp, tp) and
fsdp=4). The Megatron block (column -> gelu -> row) with its gradients,
the param rules' shards and their gather, and the LM: the gathered
logits, the loss, the gathered gradients and the params after SGD and
AdamW steps.

The ranks are spawned once for the module (tests/torch_mesh_worker.py:
no jax in them); the JAX side runs under
``jax.default_matmul_precision("float32")``. Tolerances: f32 forward
(outputs, logits, loss) within 2e-5 absolute; gradients and updated
params within 1e-4 relative to the leaf's largest value (the
tensor-parallel partial sums and the data-parallel means add the same
terms in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import multiverso_tpu as jmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu.parallel import tp as jtp
from multiverso_tpu_torch.models import transformer as ttfm
from multiverso_tpu_torch.parallel import tp as ttp
from multiverso_tpu_torch.parallel.mesh import P, one_rank_mesh
from torch_mesh_worker import World, assemble

WORLD = 4
ATOL_OUT = 2e-5
RTOL_GRAD = 1e-4


@pytest.fixture(scope="module")
def world():
    w = World(WORLD)
    yield w
    w.close()


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:WORLD]).reshape([n for _, n in shape])
    return Mesh(devs, tuple(a for a, _ in shape))


def _close_rel(got, want, rtol=RTOL_GRAD, name=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=name)


def _trees_close(got, want, rtol=RTOL_GRAD):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        _close_rel(g, w, rtol, jax.tree_util.keystr(path))


# ---------------------------------------------------------------------- #
# the Megatron block
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,x_axis", [([("tp", 4)], None),
                                          ([("dp", 2), ("tp", 2)], "dp")])
def test_mlp_block_matches_jax(world, shape, x_axis):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    w1 = rng.normal(size=(16, 32)).astype(np.float32) * 0.3
    w2 = rng.normal(size=(32, 16)).astype(np.float32) * 0.3
    r = rng.normal(size=(4, 16)).astype(np.float32)
    world.submit("tp_mlp", shape=shape, x=x, w1=w1, w2=w2, r=r,
                 x_axis=x_axis)
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        xs = JP(x_axis) if x_axis else None
        xa = jax.device_put(jnp.asarray(x), NamedSharding(jm, JP(x_axis)))
        w1a = jax.device_put(jnp.asarray(w1), NamedSharding(jm, JP(None,
                                                                   "tp")))
        w2a = jax.device_put(jnp.asarray(w2), NamedSharding(jm, JP("tp")))
        with jax.default_matmul_precision("float32"):
            f = lambda x, a, b: jtp.mlp_block(x, a, b, "tp", jm, xs)
            y = f(xa, w1a, w2a)
            grads = jax.grad(lambda *a: jnp.sum(f(*a) * r),
                             argnums=(0, 1, 2))(xa, w1a, w2a)
            col = jtp.column_parallel(xa, w1a, "tp", jm, xs)
    finally:
        jmv.shutdown()
    got = world.collect()
    np.testing.assert_allclose(assemble([g[0] for g in got], y.shape),
                               np.asarray(y), rtol=0, atol=ATOL_OUT)
    for j, (name, want) in enumerate(zip(("dx", "dw1", "dw2"), grads), 1):
        # a weight replicated over dp: each rank's gradient is its batch
        # rows' part, the JAX global gradient their sum
        _close_rel(assemble([g[j] for g in got], want.shape,
                            sum_copies=j > 1), np.asarray(want), name=name)
    np.testing.assert_allclose(assemble([g[4] for g in got], col.shape),
                               np.asarray(col), rtol=0, atol=ATOL_OUT)


@pytest.mark.parametrize("kind,shape", [("tp", [("dp", 2), ("tp", 2)]),
                                        ("fsdp", [("dp", 4)])])
def test_shard_params_round_trip(world, kind, shape):
    """Each rank holds its block under the JAX rules (the vocab rows of
    embed over tp; 1/n of every large leaf under FSDP), and the gather
    gives the global tree back."""
    cfg = ttfm.TransformerConfig(vocab_size=64, dim=16, num_heads=4,
                                 num_layers=2, max_seq=8, attn="local")
    tree = ttfm.init_params(cfg, seed=1)
    world.submit("tp_shard_roundtrip", shape=shape, tree=tree,
                 rules_kind=kind)
    n = dict(shape)["tp" if kind == "tp" else "dp"]
    got = world.collect()
    for shapes, back in got:
        if kind == "tp":
            assert shapes["embed"] == (64 // n, 16)
            assert shapes["layers"]["wqkv"] == (2, 16, 48 // n)
            assert shapes["layers"]["w2"] == (2, 64 // n, 16)
            assert shapes["pos"] == (8, 16)
        else:
            assert shapes["embed"] == (64 // n, 16)
            assert shapes["pos"] == (8 // n, 16)
            assert shapes["layers"]["w1"] == (2, 16 // n, 64)
            assert shapes["ln_f"] == (16,)
        for path, leaf in ttp.leaves(tree):
            b = back
            for k in path:
                b = b[k]
            np.testing.assert_array_equal(b, leaf)


def test_rules_equal_jax_rules():
    """The port's spec trees name the same axes on the same dims."""
    for mk in ((lambda m: m.transformer_tp_rules("tp")),
               (lambda m: m.transformer_fsdp_rules("fsdp")),
               (lambda m: m.transformer_fsdp_rules("fsdp", moe=True))):
        t, j = mk(ttp), mk(jtp)
        for path, spec in ttp.leaves(t):
            js = j
            for k in path:
                js = js[k]
            assert tuple(spec) == tuple(js), path


def test_constrain_checks_the_spec():
    m = one_rank_mesh(("dp", "tp"), "cpu")
    x = torch.zeros(2, 3)
    assert ttp.constrain(x, P("dp", "tp"), m) is x
    with pytest.raises(ValueError, match="not an axis"):
        ttp.constrain(x, P("sp"), m)
    with pytest.raises(ValueError, match="twice"):
        ttp.constrain(x, P("dp", "dp"), m)
    with pytest.raises(ValueError, match="longer"):
        ttp.constrain(x, P("dp", None, "tp"), m)


# ---------------------------------------------------------------------- #
# the LM
# ---------------------------------------------------------------------- #
BASE = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=16,
            attn="local")


def _batch(cfg_kw, b, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg_kw["vocab_size"],
                        (b, cfg_kw["max_seq"] + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def jax_lm(shape, cfg_kw, params, tok, tgt, place, steps=0, lr=0.1,
           optim=None):
    """The JAX LM on a mesh of ``shape``: (logits, loss, grads, params
    after ``steps`` steps) as numpy."""
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        cfg = jtfm.TransformerConfig(**cfg_kw)
        with jax.default_matmul_precision("float32"):
            p = place(params, cfg, jm)
            stok = jtfm.shard_batch(tok, cfg, jm)
            stgt = jtfm.shard_batch(tgt, cfg, jm)
            f = jax.jit(lambda q: (jtfm.forward(q, stok, cfg),
                                   jax.value_and_grad(jtfm.loss_fn)(
                                       q, stok, stgt, cfg)))
            logits, (loss, grads) = f(p)
            if optim:
                import optax
                opt = optax.adamw(**optim)
                st = opt.init(p)
                step = jax.jit(jtfm.make_optax_train_step(cfg, opt))
                for _ in range(steps):
                    p, st, _ = step(p, st, stok, stgt)
            else:
                # make_train_step's update from the same program's
                # gradients (one compile)
                g = grads
                for i in range(steps):
                    p = jax.tree.map(lambda a, b: a - lr * b, p, g)
                    if i < steps - 1:
                        g = f(p)[1][1]
        as_np = lambda t: jax.tree.map(np.asarray, t)
        return np.asarray(logits), float(loss), as_np(grads), as_np(p)
    finally:
        jmv.shutdown()


def _replicated(params, cfg, mesh):
    return jax.device_put(params, NamedSharding(mesh, JP()))


def _check_lm(got, want, steps):
    logits, loss, grads, after = want
    r0 = got[0]
    np.testing.assert_allclose(r0["logits"], logits, rtol=0, atol=ATOL_OUT)
    for g in got:
        assert abs(g["loss"] - loss) <= ATOL_OUT
        assert len(g["losses"]) == steps
    _trees_close(r0["grads"], grads)
    if steps:
        _trees_close(r0["params"], after)


@pytest.mark.parametrize("shape,batch_axis", [([("tp", 4)], None),
                                              ([("dp", 2), ("tp", 2)],
                                               "dp")])
def test_lm_tensor_parallel_matches_jax(world, shape, batch_axis):
    cfg_kw = dict(BASE, tp_axis="tp", batch_axis=batch_axis)
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jtfm.TransformerConfig(**BASE), seed=0))
    tok, tgt = _batch(BASE, 4, 1)
    world.submit("lm", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, steps=2, lr=0.1)
    want = jax_lm(shape, cfg_kw, params, tok, tgt,
                  lambda p, c, m: jtfm.shard_params_tp(p, c, m), steps=2)
    got = world.collect()
    _check_lm(got, want, 2)
    # the port's world 1 on the same tree: the global oracle
    with torch.no_grad():
        one = ttfm.params_from_jax(params, ttfm.TransformerConfig(**BASE),
                                   "cpu")
        loss1 = float(ttfm.loss_fn(one, torch.from_numpy(tok),
                                   torch.from_numpy(tgt)))
    assert abs(got[0]["loss"] - loss1) <= ATOL_OUT


def test_lm_fsdp_matches_jax(world):
    shape = [("fsdp", 4)]
    cfg_kw = dict(BASE, batch_axis="fsdp")
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jtfm.TransformerConfig(**BASE), seed=7))
    tok, tgt = _batch(BASE, 8, 8)
    world.submit("lm", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, layout="fsdp",
                 fsdp_axis="fsdp", steps=2, lr=0.1)
    want = jax_lm(shape, cfg_kw, params, tok, tgt,
                  lambda p, c, m: jtfm.shard_params_fsdp(p, c, m), steps=2)
    got = world.collect()
    _check_lm(got, want, 2)


def test_lm_tp_adamw_matches_optax(world):
    pytest.importorskip("optax")
    shape = [("dp", 2), ("tp", 2)]
    cfg_kw = dict(BASE, tp_axis="tp", batch_axis="dp")
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jtfm.TransformerConfig(**BASE), seed=4))
    tok, tgt = _batch(BASE, 4, 5)
    optim = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    world.submit("lm", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, steps=2,
                 optim=dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                        weight_decay=0.1))
    want = jax_lm(shape, cfg_kw, params, tok, tgt,
                  lambda p, c, m: jtfm.shard_params_tp(p, c, m), steps=2,
                  optim=dict(learning_rate=optim["lr"], b1=optim["b1"],
                             b2=optim["b2"], eps=optim["eps"],
                             weight_decay=optim["weight_decay"]))
    got = world.collect()
    _check_lm(got, want, 2)


def test_shard_params_tp_rejects_unset_axis():
    cfg = ttfm.TransformerConfig(vocab_size=32, dim=16, num_heads=2,
                                 num_layers=1, max_seq=8)
    tree = ttfm.init_params(cfg)
    with pytest.raises(ValueError, match="tp_axis"):
        ttfm.shard_params_tp(tree, cfg, device="cpu")
    jmv.init(mesh=Mesh(np.asarray(jax.devices()), ("tp",)))
    try:
        jcfg = jtfm.TransformerConfig(vocab_size=32, dim=16, num_heads=2,
                                      num_layers=1, max_seq=8)
        with pytest.raises(ValueError, match="tp_axis"):
            jtfm.shard_params_tp(jtfm.init_params(jcfg), jcfg)
    finally:
        jmv.shutdown()
