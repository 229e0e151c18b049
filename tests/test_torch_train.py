"""Port parity, training: multiverso_tpu_torch's ``make_train_step`` and the
PS training loop against multiverso_tpu's, at the examples/transformer_ps.py
size (vocab 64, dim 32, 4 heads, 2 layers, max_seq 32, batch 8).

The same numpy weights (the JAX ``init_params``) and tokens go to both
packages. attn="flash" runs the JAX Pallas kernels in interpret mode and
the port's plain forward and backward (CPU tensors); attn="local" runs
each package's ``reference_attention`` under its autograd. Tolerances are
stated at each test, with what was measured.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multiverso_tpu as jmv
import multiverso_tpu_torch as tmv
from multiverso_tpu.models import transformer as jtfm
from multiverso_tpu.sharedvar import SharedPytree as JShared
from multiverso_tpu_torch.examples import transformer_ps as tex
from multiverso_tpu_torch.models import transformer as ttfm
from multiverso_tpu_torch.sharedvar import SharedPytree as TShared
from multiverso_tpu_torch.utils import config as tconfig
from multiverso_tpu_torch.utils.dashboard import Dashboard as TDashboard
from multiverso_tpu_torch.zoo import Zoo as TZoo

DIMS = dict(vocab_size=64, dim=32, num_heads=4, num_layers=2, max_seq=32)
LR = 0.3   # the example's learning rate
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_port():
    yield
    zoo = TZoo.get()
    if zoo.started:
        zoo.stop()
    tconfig.reset_flags()
    TDashboard.reset()


def _batch(seed=0):
    """The example's batch: 8 rows of 33 tokens, inputs and next tokens."""
    toks = np.random.default_rng(seed).integers(0, 64, (8, 33))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _params(seed=0):
    cfg = jtfm.TransformerConfig(attn="local", **DIMS)
    return jax.tree.map(np.asarray, jtfm.init_params(cfg, seed=seed))


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _train_both(attn, dtype, steps=3, seed=0):
    """``steps`` plain-SGD steps in each package from the same weights and
    batch: (JAX losses, JAX leaves, port losses, port leaves)."""
    params = _params(seed)
    tok, tgt = _batch(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jcfg = jtfm.TransformerConfig(attn=attn, dtype=jdt, **DIMS)
    jstep = jax.jit(jtfm.make_train_step(jcfg, LR))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    jl = []
    with jax.default_matmul_precision("float32"):
        for _ in range(steps):
            jp, loss = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
            jl.append(float(loss))

    tcfg = ttfm.TransformerConfig(attn=attn, dtype=getattr(torch, dtype),
                                  **DIMS)
    model = ttfm.params_from_jax(params, tcfg, "cpu")
    tstep = ttfm.make_train_step(tcfg, LR)
    tl = [float(tstep(model, torch.from_numpy(tok), torch.from_numpy(tgt)))
          for _ in range(steps)]
    return jl, _leaves(jp), tl, _leaves(ttfm.params_to_numpy(model))


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_train_step_matches_jax(attn):
    """f32, 3 steps at lr 0.3: each step's loss within 2e-5 and every
    parameter leaf within 1e-6 abs after them (the matmuls and the
    attention sum in another order; measured max |diff| 9.5e-7 for the
    losses and 6e-8 for the leaves)."""
    jl, jleaves, tl, tleaves = _train_both(attn, "float32")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    assert tl[-1] < tl[0]
    assert len(tleaves) == len(jleaves) == 9
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_bf16_train_step_matches_jax(attn):
    """bf16, 3 steps at lr 0.3. bf16 rounds at different places in the two
    frameworks: XLA on the CPU keeps fused elementwise chains (tanh-gelu,
    the SGD update p - lr*g) in f32 where PyTorch rounds each op, and the
    tied embedding's gradient is a scatter-add of duplicate tokens, which
    each framework sums in its own order and rounds to bf16. So a weight
    may land one bf16 ulp apart after a step. Losses within 1e-3
    (measured max |diff| 2.6e-4 at a loss of ~4.1); each leaf's max
    |diff| within 4e-3, two bf16 ulps at |w| in [0.5, 1) (measured
    1.95e-3, one ulp), and its mean |diff| within 4e-4 (measured 1.0e-4).
    """
    jl, jleaves, tl, tleaves = _train_both(attn, "bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    assert tl[-1] < tl[0]
    for a, b in zip(tleaves, jleaves):
        diff = np.abs(a - b)
        assert diff.mean() <= 4e-4 and diff.max() <= 4e-3


@pytest.mark.parametrize("attn", ["flash", "local"])
def test_remat_gives_the_same_gradients(attn):
    """remat=True recomputes each layer in the backward: the same loss and
    gradients as remat=False (the same ops on the same values, so equal
    up to 1e-6)."""
    params = _params(seed=2)
    tok, tgt = (torch.from_numpy(a) for a in _batch(seed=2))
    grads = []
    for remat in (False, True):
        cfg = ttfm.TransformerConfig(attn=attn, remat=remat, **DIMS)
        model = ttfm.params_from_jax(params, cfg, "cpu")
        loss = ttfm.loss_fn(model, tok, tgt)
        grads.append((float(loss.detach()), torch.autograd.grad(
            loss, list(model.parameters()))))
    (l0, g0), (l1, g1) = grads
    assert abs(l0 - l1) <= 1e-6
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_learning_rate_is_cast_to_the_parameter_dtype():
    """In bf16, 1e-2 is 0.010009765625, as jnp.asarray(1e-2, bf16)."""
    cfg = ttfm.TransformerConfig(dtype=torch.bfloat16, **DIMS)
    model = ttfm.params_from_jax(_params(), cfg, "cpu")
    before = [p.detach().clone() for p in model.parameters()]
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    loss = ttfm.loss_fn(model, tok, tgt)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    ttfm.make_train_step(cfg, 1e-2)(model, tok, tgt)
    lr = float(jnp.asarray(1e-2, jnp.bfloat16))
    assert lr == 0.010009765625
    for p, p0, g in zip(model.parameters(), before, grads):
        assert torch.equal(p.detach(), p0 - g * lr)


def test_train_ps_matches_jax_example_loop():
    """train_ps against the JAX example's loop (examples/transformer_ps.py:
    jit step at lr 0.3, SharedPytree.sync every 5 steps) on the same seed,
    batch and steps: each step's loss within 2e-5 and the final table
    within 2e-6 (f32; measured 7.2e-7 and 1.2e-7 after 10 steps and two
    syncs)."""
    steps, sync_every = 10, 5
    params = _params()
    tok, tgt = _batch()
    jmv.init()
    tmv.init(device="cpu")

    jcfg = jtfm.TransformerConfig(attn="flash", **DIMS)
    js = JShared(params, name="lm_params")
    jp = js.get()
    jstep = jax.jit(jtfm.make_train_step(jcfg, LR))
    jl = []
    with jax.default_matmul_precision("float32"):
        for i in range(steps):
            jp, loss = jstep(jp, jnp.asarray(tok), jnp.asarray(tgt))
            jl.append(float(loss))
            if (i + 1) % sync_every == 0:
                jp = js.sync(jp)

    tcfg = ttfm.TransformerConfig(attn="flash", **DIMS)
    ts = TShared(params, name="lm_params")
    model = ttfm.params_from_jax(ts.get(), tcfg, "cpu")
    tl = tex.train_ps(model, ts, torch.from_numpy(tok),
                      torch.from_numpy(tgt), steps, sync_every, LR)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    np.testing.assert_allclose(ts.table.get(), js.table.get(), rtol=0,
                               atol=2e-6)
    # the model holds the table's last Get, bit for bit
    np.testing.assert_array_equal(
        np.concatenate([a.reshape(-1) for a in
                        _leaves(ttfm.params_to_numpy(model))]),
        ts.table.get()[: sum(p.numel() for p in model.parameters())])


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_transformer_ps", REPO / "examples" / "transformer_ps.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_runs_on_cpu_and_needs_the_card_by_default(monkeypatch):
    """main(device="cpu") runs the example and ends where the JAX example
    ends (final loss within 2e-5; measured equal); main() without a
    device needs the card."""
    want = _jax_example().main(steps=10, sync_every=5)
    got = tex.main(steps=10, sync_every=5, device="cpu")
    assert abs(got - want) <= 2e-5
    assert not TZoo.get().started
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.main(steps=1, sync_every=1)
