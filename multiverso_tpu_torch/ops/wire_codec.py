"""Wire-compression codec on torch tensors (port of
``multiverso_tpu/ops/wire_codec.py``).

Torch versions of the filters in ``utils/filters.py`` (1-bit sign packing
with per-block scales, top-k sparsification, both with error feedback; a
bf16 cast). The numpy filters are the reference, and these functions match
them **bit for bit** in the bits, the scales and the residuals, on the CPU
and on the card, by the same rules:

* per-block sums use the explicit pairwise fold (:func:`fold_sum` here,
  ``filters._fold_sum`` there): the same sequence of f32 additions on both
  sides, where a library ``sum()`` reduces in another order;
* masks select with ``where``, never multiply;
* the scale is one f32/f32 divide;
* bits pack MSB-first into ``uint8``, as ``np.packbits`` packs (torch has
  no packbits: shifts over groups of 8 bits);
* top-k selects with a stable descending sort of ``|x|``, so ties go to
  the lower index as ``np.argsort(kind="stable")`` sends them
  (``torch.topk`` promises no order for ties on CUDA). Only the
  candidates are sorted: ``torch.topk`` finds the k-th largest ``|x|``
  (a value, the same whatever the order of ties), and every entry at or
  above it, in index order, goes through the stable sort. The first k of
  that sort are the first k of the full one.

Where it runs: the encoders run on whatever device their input lies on.
The table encodes host payloads on the CPU, so the f32 payload never
crosses to the card just to be compressed; decode runs on the card, right
before the updater applies the delta. The error-feedback residual is the
caller's state, returned anew by each encode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_TINY = float(np.finfo(np.float32).tiny)


def canon_f32(x: torch.Tensor) -> torch.Tensor:
    """Flush sub-normals to zero (``filters.canon_f32``)."""
    return torch.where(x.abs() < _TINY, torch.zeros((), dtype=x.dtype,
                                                    device=x.device), x)


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Pairwise-fold sum over dim 1, whose width must be a power of two
    (pad with zeros first): ``filters._fold_sum`` addition for addition."""
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def _pow2_pad(width: int) -> int:
    return 1 << max(width - 1, 0).bit_length() if width > 1 else 1


def block_scales(blocks: torch.Tensor, n: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(positive mask, pos_scale, neg_scale) of (nb, block) f32 blocks: the
    mean of the positives and the mean magnitude of the non-positives of
    each block. ``n``, the logical element count: the block padding past
    it is left out of the negative mean, as in ``filters._block_scales``."""
    nb, block = blocks.shape
    pos = blocks > 0
    neg = ~pos
    if n is not None and n < nb * block:
        valid = (torch.arange(nb * block, device=blocks.device)
                 < n).reshape(nb, block)
        neg = neg & valid
    m = _pow2_pad(block)
    zero = torch.zeros((), dtype=torch.float32, device=blocks.device)

    def _mean(vals, mask):
        picked = torch.where(mask, vals, zero)
        if m != block:
            picked = torch.nn.functional.pad(picked, (0, m - block))
        s = fold_sum(picked)
        cnt = torch.clamp(mask.sum(1), min=1).to(torch.float32)
        return torch.where(mask.any(1), s / cnt, zero)

    return pos, _mean(blocks, pos), _mean(-blocks, neg)


_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """Bool vector (length a multiple of 8) -> uint8, MSB first."""
    b = mask.reshape(-1, 8).to(torch.uint8)
    out = b[:, 0] << 7
    for j in range(1, 8):
        out = out | (b[:, j] << _SHIFTS[j])
    return out


def unpackbits(bits: torch.Tensor, count: int) -> torch.Tensor:
    """uint8 -> bool vector of ``count`` bits, MSB first."""
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8, device=bits.device)
    out = (bits.reshape(-1, 1) >> shifts) & 1
    return out.reshape(-1)[:count].to(torch.bool)


def onebit_encode(flat: torch.Tensor, residual: torch.Tensor,
                  block: int = 1024
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1-bit sign packing with error feedback
    (``filters.OneBitsFilter.filter_in``). Returns ``(bits
    u8[ceil(n/block)*block/8], scales f32[nb, 2], new_residual f32[n])``;
    ``block`` must be a multiple of 8."""
    if block % 8:
        raise ValueError(f"block must be a multiple of 8, got {block}")
    flat = canon_f32(flat.reshape(-1).to(torch.float32) + residual)
    n = flat.numel()
    nb = -(-n // block)
    padded = flat.new_zeros(nb * block)
    padded[:n] = flat
    pos, pos_scale, neg_scale = block_scales(padded.reshape(nb, block), n=n)
    decoded = torch.where(pos, pos_scale[:, None],
                          -neg_scale[:, None]).reshape(-1)[:n]
    return (packbits(pos), torch.stack([pos_scale, neg_scale], dim=1),
            flat - decoded)


def onebit_decode(bits: torch.Tensor, scales: torch.Tensor, n: int,
                  block: int = 1024) -> torch.Tensor:
    """Inverse of :func:`onebit_encode` (``filters.onebit_decode_np``)."""
    nb = -(-n // block)
    pos = unpackbits(bits, nb * block).reshape(nb, block)
    flat = torch.where(pos, scales[:, 0:1], -scales[:, 1:2])
    return flat.reshape(-1)[:n]


def topk_encode(flat: torch.Tensor, residual: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-magnitude encode with error feedback (``filters.TopKFilter``):
    the k largest-|x| entries travel exactly, the rest stay in the
    residual. Ties go to the lower index. Returns ``(idx i32[k], vals
    f32[k], new_residual f32[n])``."""
    flat = canon_f32(flat.reshape(-1).to(torch.float32) + residual)
    k = min(int(k), flat.numel())
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=False).values.min()
    cand = torch.nonzero(mag >= kth).reshape(-1)   # index order
    order = torch.sort(mag[cand], descending=True, stable=True).indices
    idx = cand[order[:k]]
    vals = flat[idx]
    rest = flat.clone()
    rest[idx] = 0.0
    return idx.to(torch.int32), vals, rest


def topk_decode(idx: torch.Tensor, vals: torch.Tensor, n: int
                ) -> torch.Tensor:
    """Inverse of :func:`topk_encode` (zeros off the support)."""
    out = vals.new_zeros(n)
    out[idx.long()] = vals
    return out


def bf16_cast(x: torch.Tensor) -> torch.Tensor:
    """bf16 down-cast (round to nearest even) for the Get reply wire and
    the bf16 Add payload; a new tensor, the input stays as it is."""
    return x.to(torch.bfloat16)


def onebit_compressed_nbytes(n: int, block: int = 1024) -> int:
    """Wire bytes of a 1-bit payload (bits + scales) for n f32 elements."""
    nb = -(-n // block)
    return nb * block // 8 + nb * 8


def topk_compressed_nbytes(k: int) -> int:
    """Wire bytes of a top-k payload (i32 idx + f32 vals)."""
    return 8 * k


def default_topk(n: int) -> int:
    """Default top-k support: ~3% of the entries (about 16x fewer wire
    bytes than f32), at least one (``filters.default_topk``)."""
    return max(n // 32, 1)
