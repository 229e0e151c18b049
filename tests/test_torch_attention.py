"""Port parity: multiverso_tpu_torch.ops.attention_kernels against the JAX
flash kernels (Pallas, in interpret mode on the CPU as the JAX package's
own tests run them) and against both packages' ``reference_attention``,
forward and backward.

Forward tolerances: f32 max abs error 2e-5 (the online softmax sums over
blocks in another order than a dense softmax; each side is also held to
that bound against a float64 numpy attention, which both meet by 4.3e-7); bf16 2e-2 (``p`` is
rounded to bf16 relative to the running max in the kernel, to the row max
in the plain version). The lse output agrees to 2e-5 with ``_fwd``'s
lse[..., 0].

Backward tolerances: f32 rtol 2e-3 / atol 3e-4, as the JAX package's own
flash-gradient test (tests/test_flash_attention.py); the bf16 ones are
stated at their tests.

The CUDA kernel itself is tested on the card by test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from multiverso_tpu.ops import attention_kernels as jak
from multiverso_tpu.parallel import ring as jring
from multiverso_tpu_torch.ops import _build
from multiverso_tpu_torch.ops import attention_kernels as tak
from multiverso_tpu_torch.parallel import ring as tring

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (shape, causal, block, dtype): multi-block and S < block, both masks
CASES = [
    ((1, 2, 64, 32), True, 32, "float32"),
    ((1, 2, 64, 32), False, 32, "float32"),
    ((2, 1, 16, 8), True, 128, "float32"),      # S < block: clamps to S
    ((2, 1, 16, 8), False, 128, "float32"),
    ((1, 2, 64, 32), True, 32, "bfloat16"),
]


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


def _attention_f64(shape, causal, seed):
    """Softmax attention of ``_inputs``' arrays in float64 numpy: the
    oracle each side is held against, so a failure names the side that
    moved."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32).astype(np.float64)
               for _ in range(3))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(shape[-1])
    if causal:
        s = np.where(np.tri(shape[2], dtype=bool), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_flash_matches_jax_kernel_and_reference(case):
    shape, causal, blk, dtype = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=case)
    # the JAX side at f32 precision, as the file's other JAX comparisons:
    # a dot at the default precision may take a cheaper path
    with jax.default_matmul_precision("float32"):
        want = jak.flash_attention(jq, jk, jv, causal, blk, blk)  # interpret
        jref = jring.reference_attention(jq, jk, jv, causal)
    got = tak.flash_attention(tq, tk, tv, causal, blk, blk)
    assert got.dtype == tq.dtype and tuple(got.shape) == shape
    tref = tring.reference_attention(tq, tk, tv, causal)
    oracle = _attention_f64(shape, causal, case)
    # each side against the f64 oracle, then each pair, all named, so a
    # failure says which side moved
    for name, a, b in (("JAX kernel vs f64", want, oracle),
                       ("port vs f64", got, oracle),
                       ("port vs JAX kernel", got, want),
                       ("port vs JAX reference", got, jref),
                       ("port reference vs JAX reference", tref, jref)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL[dtype], rtol=0,
                                   err_msg=f"{name}, case {CASES[case]}")


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_fwd(causal):
    shape, blk = (1, 2, 64, 32), 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, "float32", seed=7)
    jout, (_, _, _, _, jlse) = jak._fwd(jq, jk, jv, causal, blk, blk, None)
    out, lse = tak.flash_attention_with_lse(tq, tk, tv, causal, blk, blk)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 64)
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=2e-5, rtol=0)


def test_block_contract_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 1, 96, 16), "float32")
    with pytest.raises(ValueError, match="not divisible"):
        jak.flash_attention(jq, jk, jv, True, 64, 64)
    with pytest.raises(ValueError, match="not divisible"):
        tak.flash_attention(tq, tk, tv, True, 64, 64)
    with pytest.raises(ValueError, match="not divisible"):
        tak.flash_attention_with_lse(tq, tk, tv, False, 32, 64)
    # 96 divides by 32 and by the clamped 96
    tak.flash_attention(tq, tk, tv, True, 32, 128)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")
    monkeypatch.setattr(_build, "load", no_build)
    _, (tq, tk, tv) = _inputs((1, 2, 32, 16), "float32")
    before = tak.launch_counts()
    out, lse = tak.flash_attention_with_lse(tq, tk, tv, True)
    assert tak.launch_counts() == before
    ref, ref_lse = tak.flash_forward_plain(tq, tk, tv, True, True)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_kernel_wrapper_refuses_what_it_cannot_run():
    _, (tq, tk, tv) = _inputs((1, 2, 32, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tak._flash_forward_cuda(tq, tk, tv, True, False)
    meta = torch.empty((1, 2, 32, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tak.flash_attention(meta, meta, meta)


GRAD_RTOL, GRAD_ATOL = 2e-3, 3e-4


def _grad_inputs(shape, dtype, seed):
    """q, k, v and the upstream gradient g, for both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(4)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _jax_vjp(fn, jq, jk, jv, jg):
    with jax.default_matmul_precision("float32"):
        out, vjp = jax.vjp(fn, jq, jk, jv)
        return (out,) + tuple(vjp(jg))


def _torch_vjp(fn, tq, tk, tv, tg):
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = fn(q, k, v)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), tg)


def _assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", range(4))
def test_flash_grads_match_jax_kernel_and_reference(case):
    """out, dq, dk, dv of the port's flash_attention (the plain backward on
    the CPU) against jax.vjp of the JAX flash_attention (the Pallas
    backward kernels, interpret mode) and of reference_attention."""
    shape, causal, blk, dtype = CASES[case]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _grad_inputs(shape, dtype, case)
    got = _torch_vjp(lambda q, k, v: tak.flash_attention(
        q, k, v, causal, blk, blk), tq, tk, tv, tg)
    want = _jax_vjp(lambda q, k, v: jak.flash_attention(
        q, k, v, causal, blk, blk), jq, jk, jv, jg)
    jref = _jax_vjp(lambda q, k, v: jring.reference_attention(
        q, k, v, causal), jq, jk, jv, jg)
    tref = _torch_vjp(lambda q, k, v: tring.reference_attention(
        q, k, v, causal), tq, tk, tv, tg)
    assert all(t.dtype == tq.dtype and tuple(t.shape) == shape for t in got)
    _assert_close(got, want)
    _assert_close(got, jref)
    _assert_close(tref, jref)


def test_bf16_flash_grads_match_jax_kernel():
    """bf16: both backwards round ds to bf16 before ds @ k and ds^T @ q and
    p before p^T @ dO, but from forward outputs that differ by bf16
    rounding (p rounded against the running max of 32-key blocks vs the
    row max), so a rounding of ds may flip. Gradients agree to 1.6e-2,
    one bf16 ulp at |grad| in [2, 4) (|grads| reach 2.6-3.1 here;
    measured max |diff| 7.8e-3)."""
    shape, causal, blk, dtype = CASES[4]
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _grad_inputs(shape, dtype, 4)
    got = _torch_vjp(lambda q, k, v: tak.flash_attention(
        q, k, v, causal, blk, blk), tq, tk, tv, tg)
    want = _jax_vjp(lambda q, k, v: jak.flash_attention(
        q, k, v, causal, blk, blk), jq, jk, jv, jg)
    assert all(t.dtype == torch.bfloat16 for t in got)
    _assert_close(got, want, rtol=0, atol=1.6e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_matches_jax_flash_backward(dtype, causal):
    """flash_backward_plain against the JAX _flash_backward (Pallas,
    interpret) on the same q, k, v, out, lse and dO: the JAX lse is
    (B*H, S, 8) lanes, the port's (B*H, S) is its lanes[..., 0]. Same
    roundings, so only the summation order differs: f32 to the JAX
    test's 2e-3 / 3e-4, bf16 to 8e-3, one bf16 ulp at |grad| in [1, 2)
    (measured max |diff| 2.0e-3 with |grads| up to 3.9)."""
    _check_backward_plain((1, 2, 64, 32), 32, dtype, causal, 11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_plain_sums_dkv_over_q_tiles(dtype, causal):
    """S = 192: flash_backward_plain sums dK and dV over three q tiles of
    64 rows, adding each tile's sum in turn, as the JAX kernel with 64-row
    q blocks adds each block's product to its f32 scratch. The limits of
    the one-tile test above."""
    _check_backward_plain((1, 2, 192, 32), 64, dtype, causal, 12)


def _check_backward_plain(shape, blk, dtype, causal, seed):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _grad_inputs(shape, dtype, seed)
    jout, (_, _, _, _, jlse) = jak._fwd(jq, jk, jv, causal, blk, blk, None)
    with jax.default_matmul_precision("float32"):
        want = jak._flash_backward(jq, jk, jv, jout, jlse, jg, causal, blk,
                                   blk, True)
    tout = torch.from_numpy(_np(jout).copy()).to(tq.dtype)
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    got = tak.flash_backward_plain(tq, tk, tv, tout, tlse, tg, causal)
    assert all(t.dtype == tq.dtype for t in got)
    if dtype == "float32":
        _assert_close(got, want)
    else:
        _assert_close(got, want, rtol=0, atol=8e-3)


def test_cpu_backward_never_reaches_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")
    monkeypatch.setattr(_build, "load", no_build)
    _, (tq, tk, tv, tg) = _grad_inputs((1, 2, 32, 16), "float32", 3)
    before = tak.launch_counts()
    got = _torch_vjp(lambda q, k, v: tak.flash_attention(q, k, v, True),
                     tq, tk, tv, tg)
    assert tak.launch_counts() == before
    out, lse = tak.flash_forward_plain(tq, tk, tv, True, True)
    want = (out,) + tak.flash_backward_plain(tq, tk, tv, out, lse, tg, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backward_wrappers_refuse_what_they_cannot_run():
    _, (tq, tk, tv, tg) = _grad_inputs((1, 2, 32, 32), "float32", 5)
    lse = torch.zeros((2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tak._flash_bwd_dq_cuda(tq, tk, tv, tq, lse, tg, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tak._flash_bwd_dkv_cuda(tq, tk, tv, tq, lse, tg, True)
    with pytest.raises(ValueError, match="does not match"):
        tak._flash_bwd_dq_cuda(tq, tk, tv, tq, lse, tg[..., :16], True)
