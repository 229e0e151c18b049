"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
where ``torch.cuda.is_available()`` is False. This file imports neither jax
nor multiverso_tpu, so it also runs where only the port is installed; on
the card run it without the repository's JAX conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py

Tolerances (max abs error against the plain version on the same card),
the same limits ``chip_smoke.py`` holds the kernels to:

* forward (B1): f32 2e-5 and bf16 8e-3 for the output (8e-3 is ~2x the
  largest error measured on an H100, one bf16 ulp at |out| in [0.5, 1)),
  1e-4 for the lse (f32 sums over up to 1024 keys in another order);
* backward (B2 dQ, B3 dK/dV): ``BWD_ATOL`` below, with its reason.
"""

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ops import attention_kernels as ak

ATOL = {"float32": 2e-5, "bfloat16": 8e-3}
# dq, dk, dv against the plain backward, the limits chip_smoke.py states
# with their reasons: f32 sums in another order; bf16 one ulp at |x| < 1
# (dk and dv are summed per 64-row q tile in the kernels and the plain
# version alike)
BWD_ATOL = {"float32": 4e-6, "bfloat16": 4e-3}

# (shape, block): S = 40 and S = 200 are not multiples of the kernels'
# tiles (the bf16 B1 and B2 take 128 q rows, and 128 or 64 k rows; the bf16
# B3 128 k rows and 64 q rows), and with several heads a tile read past the
# end of one head's S would take the next head's rows; head dim 32 over
# several tiles; head dim 64 at S = 1024; S = 320 leaves B3 a last k tile
# of 64 rows while 5 q tiles are live
SHAPES = (((2, 4, 256, 128), 128), ((1, 4, 40, 64), 128),
          ((2, 3, 200, 128), 200), ((1, 2, 96, 32), 32),
          ((2, 4, 1024, 64), 128), ((1, 2, 320, 128), 64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev, dtype, n):
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dev, dtype) for _ in range(n)]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(cuda_device, dtype, causal):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    for shape, blk in SHAPES:
        q, k, v = _randn(rng, shape, cuda_device, tdt, 3)
        before = ak.launch_counts()["flash_fwd"]
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        assert ak.launch_counts()["flash_fwd"] == before + 1
        ref, ref_lse = ak.flash_forward_plain(q, k, v, causal, True)
        torch.cuda.synchronize()
        assert out.dtype == tdt and lse.shape == (shape[0] * shape[1], shape[2])
        assert _max_err(out, ref) <= ATOL[dtype]
        assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_plain(cuda_device, dtype, causal):
    """B2 and B3 against flash_backward_plain on the forward kernel's out
    and lse, and the autograd path launches each once."""
    rng = np.random.default_rng(1)
    tdt = getattr(torch, dtype)
    for shape, blk in SHAPES:
        q, k, v, do = _randn(rng, shape, cuda_device, tdt, 4)
        out, lse = ak.flash_attention_with_lse(q, k, v, causal, blk, blk)
        dq = ak._flash_bwd_dq_cuda(q, k, v, out, lse, do, causal)
        dk, dv = ak._flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal)
        ref = ak.flash_backward_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            assert got.dtype == tdt and got.shape == q.shape
            assert torch.isfinite(got).all()
            print(f"{shape} {dtype} causal={causal} {name} max_abs_err "
                  f"{_max_err(got, want):.3e}")
            assert _max_err(got, want) <= BWD_ATOL[dtype]

        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        before = ak.launch_counts()
        o = ak.flash_attention(qg, kg, vg, causal, blk, blk)
        grads = torch.autograd.grad(o, (qg, kg, vg), do)
        after = ak.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
        for got, want in zip(grads, (dq, dk, dv)):
            assert torch.equal(got, want)   # deterministic: one owner a tile


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16])
def test_small_head_dims_are_padded(cuda_device, d):
    """Head dims below 32 are zero-padded to 32 on the way to the kernels
    (the example's LM has head dim 8): out and grads match the plain
    versions on the unpadded tensors."""
    rng = np.random.default_rng(2)
    shape = (2, 4, 32, d)
    q, k, v, do = _randn(rng, shape, cuda_device, torch.float32, 4)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ak.flash_attention(qg, kg, vg, True)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    ref, lse = ak.flash_forward_plain(q, k, v, True, True)
    ref_grads = ak.flash_backward_plain(q, k, v, ref, lse, do, True)
    assert out.shape == shape
    assert _max_err(out.detach(), ref) <= ATOL["float32"]
    for got, want in zip(grads, ref_grads):
        assert got.shape == shape
        assert _max_err(got, want) <= BWD_ATOL["float32"]


@pytest.mark.cuda
def test_example_trains_on_the_card(cuda_device):
    """The PS training example on the card ends where its CPU run ends:
    f32, 10 steps at lr 0.3 with two syncs, final loss within 1e-3 (the
    kernels and cuBLAS sum in another order than the CPU)."""
    from multiverso_tpu_torch.examples import transformer_ps as tex
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = tex.main(steps=10, sync_every=5)
    on_cpu = tex.main(steps=10, sync_every=5, device="cpu")
    print(f"example final loss: card {on_card:.7f}, cpu {on_cpu:.7f}")
    assert np.isfinite(on_card) and abs(on_card - on_cpu) <= 1e-3
