"""Port parity, the LM on a mesh (``multiverso_tpu_torch/models/
transformer.py``): four gloo CPU ranks against ``multiverso_tpu`` on a JAX
mesh of the same shape. Sequence parallelism over (dp, sp) with ring,
zigzag, Ulysses and the gathered local attention, the ring with the heads
tensor-parallel over (tp, sp), the flash path on each rank's batch and
head slice over (dp, tp), a masked loss, remat, and expert-parallel MoE
MLPs over (dp, ep). Each case: the gathered logits (in zigzag order for
zigzag), the global loss, the gathered gradients, and the params after
two SGD steps.

The JAX side runs under ``jax.default_matmul_precision("float32")``;
for ``attn="flash"`` its oracle is ``attn="local"`` on the same mesh: in
f32 the port's flash on the CPU (the kernels' plain version) and
``reference_attention`` differ only in the order of their sums.
Tolerances: logits and loss within 2e-5 absolute; gradients and updated
params within 1e-4 relative to the leaf's largest value.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

import multiverso_tpu as jmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu_torch.models import transformer as ttfm
from torch_mesh_worker import World

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


def _trees_close(got, want):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        _close_rel(g, w, jax.tree_util.keystr(path))


BASE = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=16)

CASES = {
    # name: (mesh, config, placement, mask)
    "dpxsp-ring-masked": ([("dp", 2), ("sp", 2)],
                          dict(attn="ring", batch_axis="dp", seq_axis="sp"),
                          None, True),
    "dpxsp-zigzag-remat": ([("dp", 2), ("sp", 2)],
                           dict(attn="zigzag", batch_axis="dp",
                                seq_axis="sp", remat=True), None, False),
    "dpxsp-ulysses": ([("dp", 2), ("sp", 2)],
                      dict(attn="ulysses", batch_axis="dp", seq_axis="sp"),
                      None, False),
    "dpxsp-local": ([("dp", 2), ("sp", 2)],
                    dict(attn="local", batch_axis="dp", seq_axis="sp"),
                    None, False),
    "tpxsp-ring": ([("tp", 2), ("sp", 2)],
                   dict(attn="ring", seq_axis="sp", tp_axis="tp"),
                   "tp", False),
    "dpxtp-flash": ([("dp", 2), ("tp", 2)],
                    dict(attn="flash", batch_axis="dp", tp_axis="tp"),
                    "tp", False),
    "dp4-flash": ([("dp", 4)], dict(attn="flash", batch_axis="dp"),
                  None, False),
    "dpxep-moe-top2": ([("dp", 2), ("ep", 2)],
                       dict(attn="local", batch_axis="dp", moe_experts=4,
                            moe_top_k=2), "moe", False),
}


def _jax_lm(shape, cfg_kw, params, tok, tgt, mask, place, lr=0.1):
    jm = _jmesh(shape)
    jmv.init(mesh=jm)
    try:
        kw = dict(cfg_kw)
        if kw.get("attn") == "flash":
            kw["attn"] = "local"      # the f32 oracle of the flash path
        cfg = jtfm.TransformerConfig(**kw)
        with jax.default_matmul_precision("float32"):
            if place == "tp":
                p = jtfm.shard_params_tp(params, cfg, jm)
            elif place == "moe":
                p = jtfm.shard_params_moe(params, cfg, jm)
            else:
                p = jax.device_put(params, NamedSharding(jm, JP()))
            stok = jtfm.shard_batch(tok, cfg, jm)
            stgt = jtfm.shard_batch(tgt, cfg, jm)
            # one program: the logits, the loss and its gradients; the
            # SGD steps (make_train_step's update, with the mask) reuse it
            lossf = lambda q: jtfm.loss_fn(q, stok, stgt, cfg, mask)
            f = jax.jit(lambda q: (jtfm.forward(q, stok, cfg),
                                   jax.value_and_grad(lossf)(q)))
            logits, (loss, grads) = f(p)
            g = grads
            for i in range(2):
                p = jax.tree.map(lambda a, b: a - lr * b, p, g)
                if i == 0:
                    g = f(p)[1][1]
        as_np = lambda t: jax.tree.map(np.asarray, t)
        return np.asarray(logits), float(loss), as_np(grads), as_np(p)
    finally:
        jmv.shutdown()


@pytest.mark.parametrize("name", list(CASES))
def test_lm_matches_jax(world, name):
    shape, extra, place, masked = CASES[name]
    cfg_kw = dict(BASE, **extra)
    jcfg = jtfm.TransformerConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jtfm.init_params(jcfg, seed=2))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 64, (4, 17)).astype(np.int32)
    tok, tgt = toks[:, :-1], toks[:, 1:]
    mask = None
    if masked:
        mask = (rng.random((4, 16)) < 0.7).astype(np.float32)
    # the port's mask is placed like the tokens; the JAX loss takes it in
    # the original order (identical here: no zigzag with a mask)
    world.submit("lm", shape=shape, cfg_kw=cfg_kw, params=params,
                 tokens=tok, targets=tgt, mask=mask, steps=2, lr=0.1,
                 layout={"tp": "tp", "moe": "moe"}.get(place))
    want = _jax_lm(shape, cfg_kw, params, tok, tgt,
                   None if mask is None else jax.numpy.asarray(mask), place)
    logits, loss, grads, after = want
    got = world.collect()
    r0 = got[0]
    np.testing.assert_allclose(r0["logits"], logits, rtol=0, atol=ATOL_OUT)
    for g in got:
        assert abs(g["loss"] - loss) <= ATOL_OUT, (g["loss"], loss)
    _trees_close(r0["grads"], grads)
    _trees_close(r0["params"], after)


def test_world_one_runs_mesh_configs():
    """Without a mesh a config with mesh axes runs on a world of one and
    equals the plain local model (the global oracle of every case)."""
    params = ttfm.init_params(ttfm.TransformerConfig(**BASE), seed=2)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 16)).astype(np.int64))
    plain = ttfm.params_from_jax(params, ttfm.TransformerConfig(
        **BASE, attn="local"), "cpu")
    with torch.no_grad():
        want = ttfm.forward(plain, tok).numpy()
        for extra in (dict(attn="ring", seq_axis="sp", batch_axis="dp"),
                      dict(attn="zigzag", seq_axis="sp"),
                      dict(attn="ulysses", seq_axis="sp"),
                      dict(attn="local", tp_axis="tp")):
            cfg = ttfm.TransformerConfig(**BASE, **extra)
            model = ttfm.params_from_jax(params, cfg, "cpu")
            got = ttfm.forward(model, ttfm.shard_batch(tok, cfg,
                                                       model.mesh)).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_OUT,
                                       err_msg=str(extra))


def test_long_context_example_runs_on_cpu_ranks():
    """examples/long_context_lm.py's ranks on a (dp=1, sp=2) world: one
    global loss on every rank, falling over a few steps."""
    from multiverso_tpu_torch.examples import long_context_lm
    from multiverso_tpu_torch.parallel.mesh import spawn
    r0, r1 = spawn(long_context_lm.rank_main, 2, "cpu", (1, 4))
    np.testing.assert_allclose(r0, r1, rtol=0, atol=1e-5)
    assert r0[-1] < r0[0]
