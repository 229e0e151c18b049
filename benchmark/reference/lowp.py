"""Matrix products for the references: plain float32, or the controls'
lower precisions emulated on the inputs of every product.

``matmul(a, b, mode)`` with ``mode=None`` is ``torch.matmul`` in float32.
The controls round each operand before a float32 product, in the forward
and in both products of the backward:

* ``"tf32"``: to TF32's 10-bit mantissa, round to nearest even, as the
  tensor cores take float32 inputs when TF32 is on;
* ``"fp8"``: scaled per tensor to float8 e4m3 (e5m2 for the gradient
  flowing back), as a per-tensor-scaled fp8 product takes them.

Emulation gives the same numbers on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    return _round_fp8(x, torch.float8_e4m3fn, _E4M3_MAX)


def round_e5m2(x: torch.Tensor) -> torch.Tensor:
    return _round_fp8(x, torch.float8_e5m2, _E5M2_MAX)


_ROUND = {"tf32": (round_tf32, round_tf32), "fp8": (round_e4m3, round_e5m2)}


class _LowpMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        fwd, _ = _ROUND[mode]
        qa, qb = fwd(a), fwd(b)
        ctx.save_for_backward(qa, qb)
        ctx.mode = mode
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        _, bwd = _ROUND[ctx.mode]
        qg = bwd(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # a [.., m, k] @ b [k, n]: b's gradient sums over a's batch dims
        while db.dim() > qb.dim():
            db = db.sum(0)
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor,
           mode: Optional[str] = None) -> torch.Tensor:
    if mode is None:
        return torch.matmul(a, b)
    return _LowpMatmul.apply(a, b, mode)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for the reference's float32 products, restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)
