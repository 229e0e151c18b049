"""Flash attention forward (port of ``multiverso_tpu/ops/attention_kernels.py``).

The JAX package runs a Pallas TPU kernel (``_flash_kernel`` via
``_flash_forward``). Here the same function has two implementations:

* ``csrc/flash_fwd.cu``, a CUDA C++ kernel for Hopper (sm_90a), launched
  for CUDA tensors through ``_flash_forward_cuda``. It picks its own tile
  (64 x 64); a failed build or launch raises.
* ``flash_forward_plain``, plain PyTorch with the kernel's arithmetic
  (f32 scores, ``p`` rounded to the input dtype before ``p @ v``, masked
  ``p = 0``, ``l == 0 -> 1``). It is used for CPU tensors, which is the
  caller's explicit choice of device, and as the kernel's reference in
  tests and ``chip_smoke.py``.

The visible contract of the JAX ``_flash_forward`` is kept: blocks clamp
to S, and S not divisible by the clamped block raises ``ValueError``.
``block_q``/``block_k`` are accepted for API parity only.

Only the forward exists in this slice (inference): the backward kernels
and the ``torch.autograd.Function`` that replaces the ``custom_vjp`` come
with training.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from multiverso_tpu_torch.ops import _build

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)

# launches of each CUDA kernel, counted by its wrapper where it launches
_launches: Dict[str, int] = {"flash_fwd": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _check_blocks(s: int, block_q: int, block_k: int) -> None:
    block_q = min(block_q, s)
    block_k = min(block_k, s)
    if s % block_q or s % block_k:
        raise ValueError(f"seq len {s} not divisible by blocks "
                         f"({block_q}, {block_k})")


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, with_lse: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: [B, H, S, D] -> (out, lse
    (B*H, S) f32 or None)."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG_INF))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(sc > _NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, s) if with_lse else None
    return out, lse


def _flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, with_lse: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} {t.device} does not match "
                f"q {tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got {q.dtype}")
    b, h, s, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous q, k, v")
    if not 0 < b * h <= 65535:
        raise ValueError(f"batch*heads {b * h} outside the kernel's grid")
    lib = _build.load("flash_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty((b * h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mv_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b * h, s, d, _KERNEL_DTYPES[q.dtype], int(causal),
            1.0 / (d ** 0.5), stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.mv_cuda_error_string(err).decode())
    _launches["flash_fwd"] += 1
    return out, lse


def _flash_forward(q, k, v, causal: bool, block_q: int, block_k: int,
                   with_lse: bool):
    _check_blocks(q.shape[2], block_q, block_k)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, with_lse)
    if q.device.type == "cuda":
        return _flash_forward_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, with_lse)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Fused attention over [B, H, S, D]; S must divide by the blocks
    (blocks clamp to S when S is smaller)."""
    return _flash_forward(q, k, v, causal, block_q, block_k, False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             block_q: int = 128, block_k: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, S, D], lse (B*H, S) f32): the per-row logsumexp the
    backward kernels will read."""
    return _flash_forward(q, k, v, causal, block_q, block_k, True)
