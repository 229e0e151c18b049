"""Row kernels of the async PS shards (port of
``multiverso_tpu/ops/spmd_apply.py``).

The JAX package vmaps one shard's update over a stack of colocated shards
and places it on a local device mesh with ``shard_map``. One card has no
mesh, so here each function works on ONE shard's ``(R, C)`` rows and its
updater state, on the shard's device:

* :func:`build_apply` — gather the touched rows and the row-axis state
  leaves, run ``updater.apply``, scatter both back; a state leaf with no
  row axis (Adam's step count) is replaced whole. The rule of a row axis
  is the shard's (``RowShard._state_row_axis``): the leaf's trailing dims
  equal the shard's padded shape, and ``-1`` marks a row-free leaf;
* :func:`build_gather` — the rows of a batch of ids;
* :func:`build_slice` — one slab of a stacked leaf;
* :func:`opt_leaves` — per-field arrays of a list of ``AddOption``.

The port's updaters write their arguments in place; the gathered rows and
state leaves are copies (``index_select``), so an update reaches the shard
only through the scatter (``index_copy_``), which writes the rows it is
given and no other.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from multiverso_tpu_torch.updaters import AddOption


def build_apply(updater, row_axes: Dict[str, int]) -> Callable:
    """``(data, ustate, ids, vals, opt) -> (data, ustate)`` for one shard:
    ``ids`` a 1-D int64 tensor of shard-local rows on the shard's device
    (unique, or repeated only where the repeats' deltas leave equal rows:
    the scratch row with zero deltas), ``vals`` one delta row per id.
    ``data`` and the row-axis leaves of ``ustate`` are written in place;
    the returned objects are the same tensors (a row-free leaf may be a
    new one)."""

    def _update(data, ustate, ids, vals, opt: AddOption):
        rows = data.index_select(0, ids)
        gstate = {k: (v.index_select(row_axes[k], ids)
                      if row_axes[k] >= 0 else v)
                  for k, v in ustate.items()}
        new_rows, new_gstate = updater.apply(rows, gstate, vals, opt)
        data.index_copy_(0, ids, new_rows)
        for k, axis in row_axes.items():
            if axis >= 0:
                ustate[k].index_copy_(axis, ids, new_gstate[k])
            else:
                ustate[k] = new_gstate[k]
        return data, ustate

    return _update


def build_gather() -> Callable:
    """``(data, ids) -> rows``: a new tensor of the rows ``ids`` (1-D
    int64 on the shard's device)."""

    def _take(data, ids):
        return data.index_select(0, ids)

    return _take


def build_slice() -> Callable:
    """``(stacked, slot) -> stacked[slot]``: one shard's slab of a stacked
    leaf (a view)."""

    def _slice(stacked, slot: int):
        return stacked.select(0, int(slot))

    return _slice


def opt_leaves(opts, dtype=np.float32):
    """Stack a list of per-shard :class:`AddOption` into per-field
    ``(S,)`` arrays. ``worker_id`` stays int32."""
    cols = list(zip(*[tuple(o) for o in opts]))
    out = []
    for name, vals in zip(AddOption._fields, cols):
        if name == "worker_id":
            out.append(np.asarray(vals, np.int32))
        else:
            out.append(np.asarray(vals, dtype))
    return tuple(out)


def to_device_ids(local: np.ndarray, device: torch.device) -> torch.Tensor:
    """Shard-local row ids as the int64 tensor the kernels index with."""
    return torch.from_numpy(np.ascontiguousarray(local, np.int64)).to(device)
