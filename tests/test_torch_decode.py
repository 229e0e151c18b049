"""Port parity, the LM's decode path: ``generate`` (greedy, sampled, top-p,
the eos latch), ``generate_beam`` and the prefill of
``multiverso_tpu_torch/models/transformer.py`` against multiverso_tpu's on
the JAX tests' own configs (tests/test_transformer.py), from one
``init_params`` tree.

The JAX side decodes under ``jax.default_matmul_precision("float32")``.
Tolerances: tokens are held equal (greedy, eos, beam, bf16 greedy, and
the sampled tokens for the same seed: the port's threefry draws
``jax.random``'s bits, and its gumbel noise and argmax agree, see
tests/test_torch_threefry.py); beam scores and prefill logits within
1e-5 (f32 sums over the vocabulary and the model width in another
order). Every ValueError of the JAX path is raised for the same input.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu.models import transformer as jtf
from multiverso_tpu_torch.models import transformer as ttf
from multiverso_tpu_torch.utils import threefry

ATOL_SCORE = 1e-5
ATOL_LOGITS = 1e-5


def _lm(seed, dtype=None, **kw):
    base = dict(vocab_size=32, dim=16, num_heads=2, num_layers=2, max_seq=24,
                attn="local")
    base.update(kw)
    jcfg = jtf.TransformerConfig(**base, **({"dtype": jnp.bfloat16}
                                            if dtype else {}))
    tcfg = ttf.TransformerConfig(**base, **({"dtype": torch.bfloat16}
                                            if dtype else {}))
    params = jtf.init_params(jcfg, seed=seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return jcfg, tcfg, params, ttf.params_from_jax(tree, tcfg, "cpu")


def _jax(fn, *args, **kw):
    with jax.default_matmul_precision("float32"):
        return fn(*args, **kw)


PROMPT = np.random.default_rng(12).integers(0, 32, (2, 4)).astype(np.int32)


def test_greedy_equals_jax_and_teacher_forced_argmax():
    jcfg, tcfg, jp, model = _lm(0)
    want = np.asarray(_jax(jtf.generate, jp, jnp.asarray(PROMPT), jcfg, 6))
    got = ttf.generate(model, PROMPT, tcfg, max_new_tokens=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    # the oracle: the port's full forward on each growing prefix
    with torch.no_grad():
        logits = ttf.forward(model, got[:, :-1].long(), tcfg)
    np.testing.assert_array_equal(logits[:, 3:].argmax(-1).numpy(),
                                  got[:, 4:].numpy())


def test_eos_latch_equals_jax():
    jcfg, tcfg, jp, model = _lm(0)
    plain = ttf.generate(model, PROMPT, tcfg, 8).numpy()
    eos = int(plain[0, 6])          # a token row 0 emits mid-decode
    want = np.asarray(_jax(jtf.generate, jp, jnp.asarray(PROMPT), jcfg, 8,
                           eos_id=eos))
    got = ttf.generate(model, PROMPT, tcfg, 8, eos_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    first = 4 + int(np.argmax(got[0, 4:] == eos))
    assert (got[0, first:] == eos).all()


def test_beam_of_four_equals_jax():
    jcfg, tcfg, jp, model = _lm(0)
    prompt = np.asarray([[3, 1], [9, 4]], np.int32)
    want, wscore = _jax(jtf.generate_beam, jp, jnp.asarray(prompt), jcfg, 6,
                        num_beams=4, return_score=True)
    got, score = ttf.generate_beam(model, prompt, tcfg, 6, num_beams=4,
                                   return_score=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(score.numpy(), np.asarray(wscore),
                               rtol=0, atol=ATOL_SCORE)


def test_single_beam_equals_greedy():
    _, tcfg, _, model = _lm(0)
    prompt = np.asarray([[3, 1], [9, 4]], np.int32)
    np.testing.assert_array_equal(
        ttf.generate_beam(model, prompt, tcfg, 6, num_beams=1).numpy(),
        ttf.generate(model, prompt, tcfg, 6).numpy())


def test_wide_beam_finds_the_global_optimum():
    # V=4, T=3, W=16 >= V^(T-1): the search is exhaustive
    _, tcfg, _, model = _lm(5, vocab_size=4, max_seq=8)
    prompt = np.asarray([[1, 2]], np.int32)
    beam, score = ttf.generate_beam(model, prompt, tcfg, 3, num_beams=16,
                                    return_score=True)
    best_lp, best = -1e30, None
    with torch.no_grad():
        for cont in itertools.product(range(4), repeat=3):
            seq = torch.tensor([[1, 2, *cont]])
            logp = torch.log_softmax(ttf.forward(model, seq[:, :-1], tcfg),
                                     -1)
            lp = sum(float(logp[0, t, seq[0, t + 1]]) for t in range(1, 4))
            if lp > best_lp:
                best_lp, best = lp, seq.numpy()
    np.testing.assert_array_equal(beam.numpy(), best)
    assert abs(float(score[0]) - best_lp) < 1e-4


def test_bf16_greedy_equals_jax():
    # tests/test_transformer.py::test_bfloat16_generate_matches_forward
    jcfg, tcfg, jp, model = _lm(3, dtype="bf16", max_seq=16)
    prompt = np.asarray([[5, 9, 2]], np.int32)
    want = np.asarray(jtf.generate(jp, jnp.asarray(prompt), jcfg, 4))
    got = ttf.generate(model, prompt, tcfg, 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
def test_sampled_tokens_equal_jax_for_the_same_seed(top_p):
    jcfg, tcfg, jp, model = _lm(2, num_layers=1, max_seq=32)
    prompt = np.zeros((2, 2), np.int32)
    want = np.asarray(_jax(jtf.generate, jp, jnp.asarray(prompt), jcfg, 8,
                           temperature=1.0, key=jax.random.key(3),
                           top_p=top_p))
    got = ttf.generate(model, prompt, tcfg, 8, temperature=1.0,
                       key=threefry.key(3), top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)
    again = ttf.generate(model, prompt, tcfg, 8, temperature=1.0,
                         key=threefry.key(3), top_p=top_p).numpy()
    np.testing.assert_array_equal(again, got)


def test_tiny_top_p_collapses_to_greedy():
    _, tcfg, _, model = _lm(2, num_layers=1, max_seq=32)
    prompt = np.zeros((2, 2), np.int32)
    np.testing.assert_array_equal(
        ttf.generate(model, prompt, tcfg, 8, temperature=1.0,
                     key=threefry.key(3), top_p=1e-6).numpy(),
        ttf.generate(model, prompt, tcfg, 8).numpy())


PREFILL_PROMPT = np.asarray([[4, 9, 1, 7, 2], [8, 8, 3, 0, 5]], np.int32)


def test_batched_prefill_equals_jax():
    jcfg, tcfg, jp, model = _lm(6)
    _, wlogits = _jax(jtf._prefill, jp, jnp.asarray(PREFILL_PROMPT), jcfg,
                      10, batched=True)
    _, logits = ttf._prefill(ttf.param_tree(model),
                             torch.from_numpy(PREFILL_PROMPT), tcfg, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(wlogits), rtol=0,
                               atol=ATOL_LOGITS)


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_batched_prefill_matches_token_by_token(variant):
    from multiverso_tpu_torch.ops.quantization import quantize_lm_params
    _, tcfg, _, model = _lm(6, dtype="bf16" if variant == "bf16" else None)
    tree = (quantize_lm_params(model) if variant == "int8"
            else ttf.param_tree(model))
    prompt = torch.from_numpy(PREFILL_PROMPT)
    cb, lb = ttf._prefill(tree, prompt, tcfg, 10, batched=True)
    cs, ls = ttf._prefill(tree, prompt, tcfg, 10, batched=False)
    # bf16: the two paths round the same values at other points, as in
    # the JAX test of the same name (2e-4 there and here)
    atol = 2e-4 if variant == "bf16" else ATOL_LOGITS
    np.testing.assert_allclose(lb.numpy(), ls.numpy(), rtol=0, atol=atol)
    for k in ("k", "v"):
        np.testing.assert_allclose(cb[k].float().numpy(),
                                   cs[k].float().numpy(), rtol=0, atol=atol)


# (kwargs of generate / generate_beam, prompt shape, max_new_tokens, match)
BAD = [
    ("generate", dict(temperature=1.0, top_p=0.0), (1, 2), 2, "top_p"),
    ("generate", dict(temperature=1.0, top_p=1.5), (1, 2), 2, "top_p"),
    ("generate", dict(eos_id=32), (1, 2), 2, "eos_id"),
    ("generate", dict(eos_id=-1), (1, 2), 2, "eos_id"),
    ("generate", dict(temperature=0.5), (1, 2), 2, "PRNG"),
    ("generate", {}, (1, 0), 2, "at least one token"),
    ("generate", {}, (1, 2), 0, "max_new_tokens"),
    ("generate", {}, (1, 6), 4, "max_seq"),
    ("generate_beam", dict(num_beams=0), (1, 2), 2, "num_beams"),
    ("generate_beam", {}, (1, 6), 4, "max_seq"),
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_value_errors_match_jax(case):
    fn, kw, shape, n, match = BAD[case]
    jcfg, tcfg, jp, model = _lm(0, num_layers=1, max_seq=8)
    prompt = np.zeros(shape, np.int32)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("temperature") and "top_p" in kw:
        jkw["key"], tkw["key"] = jax.random.key(0), threefry.key(0)
    with pytest.raises(ValueError, match=match):
        getattr(jtf, fn)(jp, jnp.asarray(prompt), jcfg, n, **jkw)
    with pytest.raises(ValueError, match=match):
        getattr(ttf, fn)(model, prompt, tcfg, n, **tkw)


def test_moe_configs_stay_refused():
    # MoE decodes now (exact top-k routing); a top_k outside the experts
    # stays refused, in both packages
    jcfg, tcfg, jp, model = _lm(0, num_layers=1, max_seq=8, moe_experts=4)
    prompt = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="top_k"):
        jtf.generate(jp, jnp.asarray(prompt), jcfg._replace(moe_top_k=5), 2)
    with pytest.raises(ValueError, match="top_k"):
        ttf.generate(model, prompt, tcfg._replace(moe_top_k=5), 2)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_decode_equals_jax(top_k):
    """``_moe_exact`` in the decode step and the batched prefill: greedy
    tokens equal, and the prefill's logits within ATOL_LOGITS."""
    jcfg, tcfg, jp, model = _lm(3, moe_experts=4, moe_top_k=top_k)
    want = np.asarray(_jax(jtf.generate, jp, jnp.asarray(PROMPT), jcfg, 6))
    got = ttf.generate(model, PROMPT, tcfg, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)
    _, jl = _jax(jtf._prefill, jp, jnp.asarray(PROMPT), jcfg, 10)
    with torch.inference_mode():
        _, tl = ttf._prefill(ttf.param_tree(model), torch.from_numpy(PROMPT),
                             tcfg, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)
