"""Row blocks for the PS block path's scan (port of
``multiverso_tpu/ops/row_assemble.py``, ``bucket_rows`` and ``pad_rows``).

Not ported yet (ROADMAP): ``gather_pad_rows`` and ``scatter_add_rows``,
which serve the hot-row train cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def bucket_rows(n: int, floor: int = 8) -> int:
    """Next power of two >= n (>= floor): the repo's one bucketing rule
    for row batches, so a block's row count takes one of few shapes."""
    b = floor
    while b < n:
        b <<= 1
    return b


def pad_rows(rows: np.ndarray, bucket: int,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """Host (n, D) rows -> (bucket, D) block on ``device``, zero-padded:
    ONE transfer of the real rows, the padding made on the device."""
    if rows.shape[0] > bucket:
        raise ValueError(f"pad_rows: {rows.shape[0]} rows > bucket "
                         f"{bucket}")
    src = torch.from_numpy(np.ascontiguousarray(rows))
    out = torch.zeros((bucket,) + tuple(rows.shape[1:]), dtype=src.dtype,
                      device=device)
    out[: rows.shape[0]].copy_(src)
    return out
