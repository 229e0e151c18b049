"""Row kernels of the async PS shards (port of
``multiverso_tpu/ops/spmd_apply.py``).

Per-shard forms, on ONE shard's ``(R, C)`` rows and its updater state, on
the shard's device (the classic path of ``ps/shard.py``):

* :func:`build_apply` — gather the touched rows and the row-axis state
  leaves, run ``updater.apply``, scatter both back; a state leaf with no
  row axis (Adam's step count) is replaced whole. The rule of a row axis
  is the shard's (``RowShard._state_row_axis``): the leaf's trailing dims
  equal the shard's padded shape, and ``-1`` marks a row-free leaf;
* :func:`build_gather` — the rows of a batch of ids;
* :func:`opt_leaves` — per-field arrays of a list of ``AddOption``.

Stacked forms, over the ``(S, R_max, C)`` layout of a stacked shard
group (``ps/spmd.py``'s ``MeshStack``): the colocated shards of one table
on one device, their rows padded to the group's largest shard and stacked
along a new slot axis; a state leaf whose per-shard row axis is ``ax``
takes the slot axis at ``ax`` and its rows at ``ax + 1`` (AdaGrad's
per-worker ``(W, R, C)`` leaf stacks as ``(W, S, R_max, C)``), so the slot
and row axes of every leaf flatten into one ``S * R_max`` axis whose index
is ``slot * R_max + local``:

* :func:`build_stacked_apply` — one wave round of several shards as ONE
  call over the flattened stack: the per-shard body of
  :func:`build_apply` on the flat views (or, for the plain adder and SGD,
  the classic path's signed ``index_add_``);
* :func:`build_stacked_gather` — every shard's gather of a round in one
  ``index_select`` over the flat view;
* :func:`build_slice` — one shard's slab of a stacked leaf, as a copy.

The JAX package vmaps the per-shard body over the slot axis and places
the stack on a local device mesh with ``shard_map``; each device runs the
program on its own slots, with every shard's ids padded to a shared
power-of-two bucket with its scratch row. Eager PyTorch compiles no
shapes, so the flat index does the vmap's work on one device and no round
pads: a shard without work in a round is simply not indexed, which leaves
its rows exactly as the JAX scratch lane does. The ops are elementwise per
row, so a stacked round equals the same shards applied one after another
bit for bit. The JAX program takes one ``AddOption`` per shard; the port's
updaters read scalar options, so the caller splits a round by equal
``AddOption`` and makes one call per part (see ``MeshStack.apply_grouped``).

The port's updaters write their arguments in place; the gathered rows and
state leaves are copies (``index_select``), so an update reaches the
shard only through the scatter (``index_copy_``), which writes the rows it
is given and no other. A slice is a copy for the same reason: a slab view
of the stack would change under a reader that pinned it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

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


def stacked_shape(shape, axis: int, slots: int, rows: int) -> tuple:
    """The stacked shape of a per-shard leaf of ``shape`` whose row axis is
    ``axis``: the slot axis at ``axis``, ``rows`` (the group's padded row
    count) at ``axis + 1``."""
    shape = tuple(shape)
    return shape[:axis] + (slots, rows) + shape[axis + 1:]


def flat_view(stacked: torch.Tensor, axis: int) -> torch.Tensor:
    """``stacked`` with its slot axis ``axis`` and row axis ``axis + 1``
    merged into one, as a VIEW (writes reach the stack)."""
    shape = tuple(stacked.shape)
    return stacked.view(shape[:axis] + (shape[axis] * shape[axis + 1],)
                        + shape[axis + 2:])


def build_stacked_apply(updater, row_axes: Dict[str, int],
                        linear: Optional[float] = None) -> Callable:
    """``(stack, ustate, flat_ids, vals, opt) -> (stack, ustate)`` for one
    part of a wave round: ``stack`` the ``(S, R_max, C)`` rows, ``ustate``
    the stacked leaves (each with its slot axis at the per-shard row axis
    of ``row_axes``; a row-free leaf cannot stack), ``flat_ids`` a 1-D
    int64 tensor of ``slot * R_max + local`` indices, unique within the
    part, ``vals`` one delta row each, ``opt`` the part's one
    ``AddOption``. ``linear`` (the sign of a stateless signed accumulate)
    takes the classic path's one ``index_add_``. Written in place."""
    if any(ax < 0 for ax in row_axes.values()):
        raise ValueError("a stacked shard group needs every updater-state "
                         "leaf on the row axis")
    inner = build_apply(updater, row_axes)

    def _update(stack, ustate, flat_ids, vals, opt: AddOption):
        flat = flat_view(stack, 0)
        if linear is not None:
            flat.index_add_(0, flat_ids, vals, alpha=linear)
            return stack, ustate
        flat_state = {k: flat_view(v, row_axes[k]) for k, v in ustate.items()}
        inner(flat, flat_state, flat_ids, vals, opt)
        return stack, ustate

    return _update


def build_stacked_gather() -> Callable:
    """``(stack, flat_ids) -> rows``: a new tensor of the ``slot * R_max +
    local`` rows of the ``(S, R_max, C)`` stack, every shard of a round in
    one ``index_select``."""

    def _take(stack, flat_ids):
        return flat_view(stack, 0).index_select(0, flat_ids)

    return _take


def build_slice() -> Callable:
    """``(stacked, slot, axis=0) -> stacked[slot]``: one shard's slab of a
    stacked leaf whose slot axis is ``axis``, as a new tensor (never a view
    of the stack, which later applies write in place)."""

    def _slice(stacked, slot: int, axis: int = 0):
        return stacked.select(axis, int(slot)).clone()

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
