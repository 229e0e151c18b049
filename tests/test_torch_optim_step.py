"""Port parity, the optimizer step: multiverso_tpu_torch's
``make_optim_train_step`` with ``torch.optim`` against multiverso_tpu's
``make_optax_train_step`` with optax, at the examples/transformer_ps.py
size (vocab 64, dim 32, 4 heads, 2 layers, max_seq 32, batch 8), f32,
attn="local" in both packages (the step, not the attention, is under
test; tests/test_torch_train.py holds the flash path).

Every hyperparameter is passed explicitly: the libraries' defaults
differ (optax.adamw's weight decay is 1e-4, torch.optim.AdamW's 1e-2).
Tolerances are stated at the test, with what was measured.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu_torch.models import transformer as ttfm

DIMS = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=32)
STEPS = 5

# (optax optimizer, torch.optim factory), the same update rule and numbers
OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.3),
            lambda p: torch.optim.SGD(p, lr=0.3)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda p: torch.optim.SGD(p, lr=0.1, momentum=0.9,
                                               dampening=0.0,
                                               nesterov=False)),
    "adam": (lambda: optax.adam(3e-3, b1=0.9, b2=0.999, eps=1e-8),
             lambda p: torch.optim.Adam(p, lr=3e-3, betas=(0.9, 0.999),
                                        eps=1e-8, weight_decay=0.0)),
    "adamw": (lambda: optax.adamw(3e-3, b1=0.9, b2=0.999, eps=1e-8,
                                  weight_decay=0.1),
              lambda p: torch.optim.AdamW(p, lr=3e-3, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=0.1)),
}


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(0, 64, (8, 33))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optim_step_matches_optax(name):
    """5 steps from the same weights and batch: each step's loss within
    2e-5 abs (measured max 1.4e-6, adamw, at a loss of ~4) and every
    parameter leaf within 2e-5 abs after them (measured max 1.3e-6,
    adam and adamw, whose first steps move each weight by ~lr * sign(g);
    sgd 1.2e-7)."""
    make_optax, make_torch = OPTIMIZERS[name]
    cfg = jtfm.TransformerConfig(attn="local", **DIMS)
    params = jax.tree.map(np.asarray, jtfm.init_params(cfg, seed=0))
    tok, tgt = _batch()

    opt = make_optax()
    jstep = jax.jit(jtfm.make_optax_train_step(cfg, opt))
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    jl = []
    with jax.default_matmul_precision("float32"):
        for _ in range(STEPS):
            jp, state, loss = jstep(jp, state, jnp.asarray(tok),
                                    jnp.asarray(tgt))
            jl.append(float(loss))

    tcfg = ttfm.TransformerConfig(attn="local", **DIMS)
    model = ttfm.params_from_jax(params, tcfg, "cpu")
    tstep = ttfm.make_optim_train_step(tcfg,
                                       make_torch(model.parameters()))
    tl = [float(tstep(model, torch.from_numpy(tok), torch.from_numpy(tgt)))
          for _ in range(STEPS)]
    assert all(p.grad is None for p in model.parameters())   # zero_grad

    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    assert tl[-1] < tl[0]
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jp)]
    tleaves = jax.tree.leaves(ttfm.params_to_numpy(model))
    assert len(tleaves) == len(jleaves) == 9
    moved = 0.0
    for a, b, p0 in zip(tleaves, jleaves, jax.tree.leaves(params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
        moved = max(moved, float(np.abs(b - p0).max()))
    assert moved > 1e-3   # the steps moved the weights
