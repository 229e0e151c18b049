"""Row blocks for the PS block path's scan and the hot-row train cache's
device mirror (port of ``multiverso_tpu/ops/row_assemble.py``).

* :func:`pad_rows`: host rows -> a zero-padded (bucket, D) block on the
  device, one transfer of the real rows.
* :func:`gather_pad_rows`: the block served from the cache's device
  mirror, gathered and padded on the device; nothing crosses the host.
* :func:`scatter_add_rows`: the write-through upkeep of the mirror, a
  pushed delta added into the cached rows on the device.

A gathered block pads to its bucket with an out-of-range sentinel
position (the mirror's height H), as in the JAX package: a sentinel slot
gathers a zero row, and a scatter drops it. Each row of a scatter takes
exactly one f32 add (unique positions), the add the table's default
updater makes, so the mirror stays equal to the table's rows bit for
bit.
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


def gather_pad_rows(rows_dev: torch.Tensor, positions,
                    bucket: int) -> torch.Tensor:
    """Device (H, D) cache mirror + host positions -> (bucket, D) block on
    the mirror's device: the rows at ``positions``, then zero rows (the
    slots past them hold the sentinel H, past the last row: -1 would name
    the last real row, and gather zeros)."""
    pos = np.asarray(positions, np.int64).reshape(-1)
    if pos.size > bucket:
        raise ValueError(f"gather_pad_rows: {pos.size} positions > bucket "
                         f"{bucket}")
    h = rows_dev.shape[0]
    full = np.full(bucket, h, np.int64)
    full[: pos.size] = pos
    full = torch.from_numpy(full).to(rows_dev.device)
    fill = full >= h
    out = rows_dev.index_select(0, torch.where(fill, 0, full))
    return out.masked_fill_(fill[:, None], 0)


def scatter_add_rows(rows_dev: torch.Tensor, positions,
                     delta) -> torch.Tensor:
    """Add the pushed (n, D) ``delta`` into rows ``positions`` of the
    device mirror, IN PLACE; returns ``rows_dev``. Positions must be
    unique, so each row takes one f32 add; a position at or past the
    mirror's height H (the sentinel of a padded batch) is dropped, as the
    JAX program's ``mode="drop"`` drops it. A gather of the mirror made
    before this call keeps its values (it is a copy, ordered before the
    add on the stream)."""
    pos = np.asarray(positions, np.int64).reshape(-1)
    delta = np.asarray(delta).reshape(pos.size, -1)
    keep = pos < rows_dev.shape[0]
    rows_dev.index_add_(
        0, torch.from_numpy(pos[keep]).to(rows_dev.device),
        torch.from_numpy(np.ascontiguousarray(delta[keep])).to(
            rows_dev.device, rows_dev.dtype))
    return rows_dev
