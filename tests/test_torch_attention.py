"""Port parity: multiverso_tpu_torch.ops.attention_kernels against the JAX
flash kernel (Pallas, in interpret mode on the CPU as the JAX package's own
tests run it) and against both packages' ``reference_attention``.

Tolerances: f32 max abs error 2e-5 (the online softmax sums over blocks in
another order than a dense softmax); bf16 2e-2 (``p`` is rounded to bf16
relative to the running max in the kernel, to the row max in the plain
version). The lse output agrees to 2e-5 with ``_fwd``'s lse[..., 0].

The CUDA kernel itself is tested on the card by test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("case", range(len(CASES)))
def test_flash_matches_jax_kernel_and_reference(case):
    shape, causal, blk, dtype = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=case)
    want = jak.flash_attention(jq, jk, jv, causal, blk, blk)   # interpret
    got = tak.flash_attention(tq, tk, tv, causal, blk, blk)
    assert got.dtype == tq.dtype and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(
        _np(got), _np(jring.reference_attention(jq, jk, jv, causal)),
        atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(
        _np(tring.reference_attention(tq, tk, tv, causal)),
        _np(jring.reference_attention(jq, jk, jv, causal)),
        atol=ATOL[dtype], rtol=0)


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
