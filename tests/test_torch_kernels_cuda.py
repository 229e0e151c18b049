"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
where ``torch.cuda.is_available()`` is False. This file imports neither jax
nor multiverso_tpu, so it also runs where only the port is installed; on
the card run it without the repository's JAX conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py

Tolerances (max abs error against the plain version on the same card):
f32 2e-5 and bf16 2e-2 for the output, 1e-4 for the lse (f32 sums over up
to 256 keys in another order).
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import attention_kernels as ak

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(cuda_device, dtype, causal):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    for shape, blk in (((2, 4, 256, 128), 128), ((1, 4, 40, 64), 128),
                       ((1, 2, 96, 32), 32)):
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .to(cuda_device, tdt) for _ in range(3))
        before = ak.launch_counts()["flash_fwd"]
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        assert ak.launch_counts()["flash_fwd"] == before + 1
        ref, ref_lse = ak.flash_forward_plain(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert out.dtype == tdt and lse.shape == (shape[0] * shape[1], shape[2])
        assert float((out.float() - ref.float()).abs().max()) <= ATOL[dtype]
        assert float((lse - ref_lse).abs().max()) <= 1e-4
