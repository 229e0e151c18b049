"""Port parity, ``ops/quantization.py``: multiverso_tpu_torch's int8
weight-only quantization against multiverso_tpu's on the same numpy
inputs, and the int8 decode of ``models/transformer.generate``.

``torch.round`` and ``jnp.round`` both round half to even, and the scale is
one f32 max and one f32 divide, so ``q`` and ``scale`` are held bit for
bit; the LM tree's layout (which leaves are quantized, and their scales'
shapes) is held equal. The int8 greedy tokens are held equal to the JAX
package's int8 decode (both decode under f32 matmul precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu.ops import quantization as jqz
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.ops import quantization as tqz


def _pair(w, keep_axes):
    j = jqz.quantize(jnp.asarray(w), keep_axes=keep_axes)
    t = tqz.quantize(torch.from_numpy(w), keep_axes=keep_axes)
    return j, t


def _assert_same_q(j, t):
    assert t.q.dtype == torch.int8 and t.scale.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.mark.parametrize("shape,keep_axes", [
    ((64, 32), (-1,)), ((64, 32), (0,)), ((3, 16, 8), (0, -1)),
    ((2, 5, 7, 3), (1,)),
])
def test_quantize_bit_for_bit(shape, keep_axes):
    w = np.random.default_rng(len(shape)).normal(0, 3.0, shape).astype(
        np.float32)
    # exact halves land on the round-half-to-even rule
    w.reshape(-1)[:4] = [0.5, 1.5, -2.5, 0.0]
    j, t = _pair(w, keep_axes)
    _assert_same_q(j, t)
    np.testing.assert_array_equal(tqz.dequantize(t).numpy(),
                                  np.asarray(jqz.dequantize(j)))
    # the error bound of the scheme
    err = torch.abs(tqz.dequantize(t) - torch.from_numpy(w))
    assert bool((err <= t.scale / 2 + 1e-6).all())


def test_dequantize_to_bf16_and_maybe_dequantize():
    w = np.random.default_rng(4).normal(size=(8, 16)).astype(np.float32)
    j, t = _pair(w, (-1,))
    got = tqz.dequantize(t, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jqz.dequantize(j, jnp.bfloat16).astype(jnp.float32)))
    plain = torch.ones(3)
    assert tqz.maybe_dequantize(plain) is plain


def _lm(seed=0, **kw):
    base = dict(vocab_size=32, dim=16, num_heads=2, num_layers=2, max_seq=8,
                attn="local")
    base.update(kw)
    jcfg = jtf.TransformerConfig(**base)
    tcfg = ttf.TransformerConfig(**base)
    params = jtf.init_params(jcfg, seed=seed)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, ttf.params_from_jax(tree, tcfg, "cpu"), tree


def test_lm_tree_layout_and_values_equal_jax():
    _, _, jparams, model, tree = _lm()
    jq = jqz.quantize_lm_params(jparams)
    for src in (model, tree):
        tq = tqz.quantize_lm_params(src, device="cpu")
        assert set(tq) == set(jq) and set(tq["layers"]) == set(jq["layers"])
        for name in ("embed", "pos"):
            _assert_same_q(jq[name], tq[name])
        assert tq["embed"].scale.shape == (32, 1)
        for name, leaf in jq["layers"].items():
            got = tq["layers"][name]
            if isinstance(leaf, jqz.QuantizedTensor):
                assert isinstance(got, tqz.QuantizedTensor), name
                _assert_same_q(leaf, got)
            else:
                assert not isinstance(got, tqz.QuantizedTensor), name
                np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
        assert tq["layers"]["wqkv"].scale.shape == (2, 1, 48)
        np.testing.assert_array_equal(tq["ln_f"].numpy(),
                                      np.asarray(jq["ln_f"]))


def test_numpy_tree_defaults_to_the_card(monkeypatch):
    _, _, _, _, tree = _lm()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqz.quantize_lm_params(tree)


def test_int8_greedy_decode_equals_jax():
    jcfg, tcfg, jparams, model, _ = _lm(seed=6, max_seq=24)
    prompt = np.asarray([[4, 9, 1, 7, 2], [8, 8, 3, 0, 5]], np.int32)
    with jax.default_matmul_precision("float32"):
        want = jtf.generate(jqz.quantize_lm_params(jparams),
                            jnp.asarray(prompt), jcfg, 8)
    got = ttf.generate(tqz.quantize_lm_params(model), prompt, tcfg, 8)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_int8_decode_runs_in_range():
    _, tcfg, _, model, _ = _lm(seed=2, num_layers=1)
    bcfg = tcfg._replace(dtype=torch.bfloat16)
    bmodel = ttf.params_from_jax(ttf.params_to_numpy(model), bcfg, "cpu")
    qp = tqz.quantize_lm_params(bmodel)
    assert qp["ln_f"].dtype == torch.bfloat16
    out = ttf.generate(qp, np.zeros((1, 2), np.int32), bcfg, 3).numpy()
    assert out.shape == (1, 5) and out.max() < 32 and out.min() >= 0


def test_wrong_embedding_scale_layout_raises_in_both():
    jcfg, tcfg, jparams, model, _ = _lm(seed=3, num_layers=1)
    jbad = dict(jparams)
    jbad["embed"] = jqz.quantize(jparams["embed"])    # per column: wrong
    tbad = ttf.param_tree(model)
    tbad["embed"] = tqz.quantize(tbad["embed"])
    prompt = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="per-row"):
        jtf.generate(jbad, jnp.asarray(prompt), jcfg, 2)
    with pytest.raises(ValueError, match="per-row"):
        ttf.generate(tbad, prompt, tcfg, 2)
