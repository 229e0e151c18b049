"""Port parity: multiverso_tpu_torch.models.transformer against
multiverso_tpu.models.transformer, at the examples/transformer_ps.py size
(vocab 64, dim 32, 4 heads, 2 layers, max_seq 32).

Weights come from the JAX ``init_params`` and are carried across with
``params_from_jax``; the scoring tests run under ``torch.no_grad()``
(training is tests/test_torch_train.py). Tolerance: logits and loss to atol 2e-5 (f32; the
attention and the matmuls sum in another order), for attn="flash" (the
JAX Pallas kernel in interpret mode) and attn="local"; the bf16 model of
both packages to bf16 rounding (tolerances in that test). The slice end
to end: parameters through each package's SharedPytree -> Get -> forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu.sharedvar import SharedPytree as JShared
from multiverso_tpu_torch.models import transformer as ttfm
from multiverso_tpu_torch.sharedvar import SharedPytree as TShared
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

DIMS = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=32)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _tokens(seed=0, b=3, s=32):
    toks = np.random.default_rng(seed).integers(0, DIMS["vocab_size"],
                                                (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _jax_params(seed=0):
    cfg = jtfm.TransformerConfig(attn="local", **DIMS)
    return jax.tree.map(np.asarray, jtfm.init_params(cfg, seed=seed))


def test_init_params_equal_jax():
    jp = _jax_params(seed=3)
    tp = ttfm.init_params(ttfm.TransformerConfig(**DIMS), seed=3)
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("attn", ["flash", "local"])
@torch.no_grad()
def test_logits_and_loss_match_jax(attn):
    params = _jax_params()
    tok, tgt = _tokens()
    jcfg = jtfm.TransformerConfig(attn=attn, **DIMS)
    model = ttfm.params_from_jax(params, ttfm.TransformerConfig(attn=attn,
                                                                **DIMS), "cpu")
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jtfm.forward(jp, jnp.asarray(tok), jcfg))
    got = model(torch.from_numpy(tok).long())
    assert tuple(got.shape) == (3, 32, 64) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    mask = (np.arange(32)[None] < np.array([[32], [20], [5]])).astype(np.float32)
    for m in (None, mask):
        jl = float(jtfm.loss_fn(jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg,
                                None if m is None else jnp.asarray(m)))
        tl = float(ttfm.loss_fn(model, torch.from_numpy(tok),
                                torch.from_numpy(tgt),
                                None if m is None else torch.from_numpy(m)))
        assert abs(tl - jl) <= ATOL


def test_params_round_trip_and_unsupported_configs():
    params = _jax_params()
    model = ttfm.params_from_jax(params, ttfm.TransformerConfig(**DIMS), "cpu")
    back = ttfm.params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ttfm.params_from_jax(params, ttfm.TransformerConfig(
            **{**DIMS, "dim": 64}), "cpu")
    # the mesh configs build on a world of one; what the JAX model refuses
    # stays refused
    for ok in ({"attn": "ring"}, {"moe_experts": 4}, {"tp_axis": "tp"},
               {"attn": "zigzag", "seq_axis": "sp", "batch_axis": "dp"}):
        ttfm.Transformer(ttfm.TransformerConfig(**{**DIMS, **ok}))
    for bad, match in (({"attn": "bogus"}, "attn"),
                       ({"attn": "flash", "seq_axis": "sp"}, "flash"),
                       ({"attn": "ulysses", "tp_axis": "tp"}, "ulysses"),
                       ({"moe_experts": 4, "attn": "ring", "seq_axis": "sp"},
                        "MoE")):
        with pytest.raises(ValueError, match=match):
            ttfm.Transformer(ttfm.TransformerConfig(**{**DIMS, **bad}))


@torch.no_grad()
def test_bf16_model_tracks_f32():
    # bf16 rounding through 2 layers: logits within 5e-2 of the f32 model
    params = _jax_params()
    tok, _ = _tokens()
    t = torch.from_numpy(tok)
    f32 = ttfm.params_from_jax(params, ttfm.TransformerConfig(**DIMS), "cpu")
    b16 = ttfm.params_from_jax(params, ttfm.TransformerConfig(
        dtype=torch.bfloat16, **DIMS), "cpu")
    out = b16(t)
    assert out.dtype == torch.bfloat16
    assert float((out.float() - f32(t)).abs().max()) <= 5e-2


@pytest.mark.parametrize("attn", ["flash", "local"])
@torch.no_grad()
def test_bf16_logits_and_loss_match_jax(attn):
    """The bf16 model of both packages on the same bf16-rounded weights.

    The port rounds each PyTorch op's result to bf16; XLA on the CPU keeps
    some fused elementwise chains (tanh-gelu) in f32. So the logits agree
    to bf16 rounding, not bit for bit: max |diff| <= 6e-3 (3 bf16 ulps at
    |logits| in [0.25, 0.5); 3.9e-3 measured) and mean |diff| <= 8e-4
    (5.4e-4 measured; an rmsnorm that normalizes in f32 and casts once,
    instead of casting rsqrt to bf16 before the multiply, lands above
    it), loss to 2e-4 (f32 sum of bf16 logits).
    """
    params = _jax_params()
    tok, tgt = _tokens()
    jcfg = jtfm.TransformerConfig(attn=attn, dtype=jnp.bfloat16, **DIMS)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jtfm.forward(jp, jnp.asarray(tok), jcfg)
                      .astype(jnp.float32))
    model = ttfm.params_from_jax(params, ttfm.TransformerConfig(
        attn=attn, dtype=torch.bfloat16, **DIMS), "cpu")
    got = model(torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 6e-3 and diff.mean() <= 8e-4
    jl = float(jtfm.loss_fn(jp, jnp.asarray(tok), jnp.asarray(tgt), jcfg))
    tl = float(ttfm.loss_fn(model, torch.from_numpy(tok),
                            torch.from_numpy(tgt)))
    assert abs(tl - jl) <= 2e-4


@torch.no_grad()
def test_slice_end_to_end_matches_jax():
    """init -> SharedPytree -> Get -> forward, then one sync -> forward."""
    params = _jax_params(seed=1)
    tok, tgt = _tokens(seed=1)
    jmv.init()
    tmv.init(device="cpu")
    jcfg = jtfm.TransformerConfig(attn="flash", **DIMS)
    tcfg = ttfm.TransformerConfig(attn="flash", **DIMS)
    js, ts = JShared(params, name="lm_params"), TShared(params,
                                                        name="lm_params")
    np.testing.assert_array_equal(ts.table.get(), js.table.get())

    def both_forward(jtree, ttree):
        want = np.asarray(jtfm.forward(jax.tree.map(jnp.asarray, jtree),
                                       jnp.asarray(tok), jcfg))
        model = ttfm.params_from_jax(ttree, tcfg, tmv.device())
        got = model(torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        return model

    both_forward(js.get(), ts.get())
    # a worker's local progress, pushed and merged through each table
    rng = np.random.default_rng(2)
    local = jax.tree.map(
        lambda x: x + rng.normal(0, 1e-2, x.shape).astype(np.float32),
        params)
    jm, tm = js.sync(local), ts.sync(local)
    for a, b in zip(jax.tree.leaves(jm), jax.tree.leaves(tm)):
        np.testing.assert_array_equal(a, b)
    model = both_forward(jm, tm)
    jl = float(jtfm.loss_fn(jax.tree.map(jnp.asarray, jm), jnp.asarray(tok),
                            jnp.asarray(tgt), jcfg))
    assert abs(float(ttfm.loss_fn(model, torch.from_numpy(tok),
                                  torch.from_numpy(tgt))) - jl) <= ATOL
