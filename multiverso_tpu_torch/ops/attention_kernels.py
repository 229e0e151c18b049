"""Flash attention, forward and backward (port of
``multiverso_tpu/ops/attention_kernels.py``).

The JAX package runs three Pallas TPU kernels, the forward
``_flash_kernel`` (via ``_flash_forward``) and the backward
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (via ``_flash_backward``), tied
together by a ``jax.custom_vjp``. Here each has two implementations:

* CUDA C++ kernels for Hopper (sm_90a): ``csrc/flash_fwd.cu`` (forward)
  and ``csrc/flash_bwd.cu`` (dQ; dK and dV), launched for CUDA tensors
  through ``_flash_forward_cuda``, ``_flash_bwd_dq_cuda`` and
  ``_flash_bwd_dkv_cuda``. They pick their own tile (64 x 64) and take
  head dims 32, 64 and 128; a smaller head dim is zero-padded up to the
  next of these on the way in and cut on the way out. A failed build or
  launch raises.
* ``flash_forward_plain`` and ``flash_backward_plain``, plain PyTorch with
  the kernels' arithmetic (f32 scores; forward: ``p`` rounded to the input
  dtype before ``p @ v``, masked ``p = 0``, ``l == 0 -> 1``; backward:
  ``p = exp(s - lse)``, ``delta = rowsum(dO * out)`` in f32, ``ds`` rounded
  to the input dtype before ``ds @ k`` and ``ds^T @ q``, ``p`` rounded to
  dO's dtype before ``p^T @ dO``). They are used for CPU tensors, which is
  the caller's explicit choice of device, and as the kernels' reference in
  tests and ``chip_smoke.py``.

``flash_attention`` is differentiable: ``_FlashAttention``, a
``torch.autograd.Function``, takes the place of the ``custom_vjp``. When a
gradient is needed its forward keeps the lse for the backward, which runs
dQ then dK/dV; otherwise the forward runs without lse, as the JAX primal
does.

The visible contract of the JAX ``_flash_forward`` is kept: blocks clamp
to S, and S not divisible by the clamped block raises ``ValueError``.
``block_q``/``block_k`` are accepted for API parity only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from multiverso_tpu_torch.ops import _build

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)

# launches of each CUDA kernel, counted by its wrapper where it launches
_launches: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0}


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


def _causal_mask(sc: torch.Tensor) -> torch.Tensor:
    s = sc.shape[-1]
    mask = torch.ones((s, s), dtype=torch.bool, device=sc.device).tril()
    return torch.where(mask, sc, torch.full_like(sc, _NEG_INF))


def flash_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, with_lse: bool
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: [B, H, S, D] -> (out, lse
    (B*H, S) f32 or None)."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    sc = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sc = _causal_mask(sc)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    p = torch.where(sc > _NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, s) if with_lse else None
    return out, lse


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: q, k, v, out, dO
    [B, H, S, D] and the forward's lse (B*H, S) f32 -> (dq, dk, dv) in the
    input dtype."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf, kf, dof = q.float(), k.float(), do.float()
    sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        sc = _causal_mask(sc)
    p = torch.exp(sc - lse.reshape(b, h, s, 1))   # masked: exp(-1e30) = 0
    delta = (dof * out.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf).to(q.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                      dof).to(v.dtype)
    return dq, dk, dv


def _kernel_shape(q: torch.Tensor, **others: torch.Tensor
                  ) -> Tuple[int, int, int]:
    """(B*H, S, D) of tensors the kernels take; raises on anything else."""
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, S, D], got {tuple(q.shape)}")
    for name, t in others.items():
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
    if not all(t.is_contiguous() for t in (q, *others.values())):
        raise ValueError(f"flash kernel needs contiguous q, "
                         f"{', '.join(others)}")
    if not 0 < b * h <= 65535:
        raise ValueError(f"batch*heads {b * h} outside the kernel's grid")
    return b * h, s, d


def _check_lse(lse: torch.Tensor, q: torch.Tensor, bh: int, s: int) -> None:
    if (tuple(lse.shape) != (bh, s) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 ({bh}, {s}) on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} "
                         f"{lse.device}")


def _launch(name: str, lib, fn, q: torch.Tensor, *args) -> None:
    """Call ``fn(*args, stream)`` on q's current stream; raise on a failed
    launch, else count it."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.mv_cuda_error_string(err).decode())
    _launches[name] += 1


def _flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, with_lse: bool,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``csrc/flash_fwd.cu`` on the current stream; ``scale``
    defaults to 1/sqrt(D)."""
    bh, s, d = _kernel_shape(q, k=k, v=v)
    lib = _build.load("flash_fwd")
    out = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _launch("flash_fwd", lib, lib.mv_flash_fwd, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            bh, s, d, _KERNEL_DTYPES[q.dtype], int(causal),
            scale or 1.0 / (d ** 0.5))
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, out, lse, do, causal: bool,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dQ kernel (B2) of ``csrc/flash_bwd.cu``."""
    bh, s, d = _kernel_shape(q, k=k, v=v, out=out, do=do)
    _check_lse(lse, q, bh, s)
    lib = _build.load("flash_bwd")
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", lib, lib.mv_flash_bwd_dq, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            bh, s, d, _KERNEL_DTYPES[q.dtype], int(causal),
            scale or 1.0 / (d ** 0.5))
    return dq


def _flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal: bool,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel (B3) of ``csrc/flash_bwd.cu``."""
    bh, s, d = _kernel_shape(q, k=k, v=v, out=out, do=do)
    _check_lse(lse, q, bh, s)
    lib = _build.load("flash_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", lib, lib.mv_flash_bwd_dkv, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s, d, _KERNEL_DTYPES[q.dtype], int(causal),
            scale or 1.0 / (d ** 0.5))
    return dk, dv


def _padded_head(ts, d: int):
    """The tensors contiguous, with the head dim zero-padded up to the next
    one the kernels take (zeros change no score, lse or delta), and the
    padded width."""
    width = next((x for x in _KERNEL_HEAD_DIMS if x >= d), d)
    if width == d:
        return [t.contiguous() for t in ts], d
    return [F.pad(t, (0, width - d)) for t in ts], width


def _flash_forward(q, k, v, causal: bool, with_lse: bool):
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, causal, with_lse)
    if q.device.type == "cuda":
        d = q.shape[-1]
        (q, k, v), width = _padded_head((q, k, v), d)
        out, lse = _flash_forward_cuda(q, k, v, causal, with_lse,
                                       1.0 / (d ** 0.5))
        return (out[..., :d] if width != d else out), lse
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _flash_backward(q, k, v, out, lse, do, causal: bool):
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, do, causal)
    if q.device.type == "cuda":
        d = q.shape[-1]
        (q, k, v, out, do), width = _padded_head((q, k, v, out, do), d)
        lse, scale = lse.contiguous(), 1.0 / (d ** 0.5)
        dq = _flash_bwd_dq_cuda(q, k, v, out, lse, do, causal, scale)
        dk, dv = _flash_bwd_dkv_cuda(q, k, v, out, lse, do, causal, scale)
        if width != d:
            dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
        return dq, dk, dv
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``flash_attention``: the forward keeps
    (q, k, v, out, lse), the backward runs dQ then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        # kept contiguous, so the backward kernels need no second copy
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_forward(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Fused attention over [B, H, S, D]; S must divide by the blocks
    (blocks clamp to S when S is smaller). Differentiable in q, k, v."""
    _check_blocks(q.shape[2], block_q, block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_forward(q, k, v, causal, False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = False,
                             block_q: int = 128, block_k: int = 128
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, S, D], lse (B*H, S) f32): the per-row logsumexp the
    backward kernels read. Not differentiable."""
    _check_blocks(q.shape[2], block_q, block_k)
    return _flash_forward(q, k, v, causal, True)
