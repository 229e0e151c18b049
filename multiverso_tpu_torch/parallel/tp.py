"""Tensor (model) parallelism: Megatron-style sharded matmuls over a mesh
axis (port of ``multiverso_tpu/parallel/tp.py``).

The JAX package places the transformer's params with GSPMD rules and lets
XLA insert the collectives. The port is one rank a process, so the rules
say which slice of each global array a rank holds
(:func:`shard_params`, and :func:`gather_params` back), and the layers
place the collectives by hand: the column-parallel -> row-parallel pair
needs one all-reduce on its output (``collectives.reduce_from``), and the
replicated input entering the column-parallel matmul carries its
gradient's all-reduce (``collectives.copy_to``).

:func:`constrain` is the JAX activation hint. A per-rank tensor is already
laid out, so here it checks that the spec names axes of the mesh, each at
most once, over no more dims than the tensor has, and returns the tensor.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.parallel.mesh import P, iter_axes
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.zoo import Zoo


def transformer_tp_rules(axis: str = "tp") -> Dict[str, Any]:
    """Partition specs of the transformer's params (leading layer dim on
    the stacked leaves): qkv/w1 column-parallel (output dim sharded),
    wo/w2 row-parallel (input dim sharded), embeddings vocab-sharded,
    norms replicated."""
    return {
        "embed": P(axis, None),
        "pos": P(None, None),
        "layers": {
            "wqkv": P(None, None, axis),
            "wo": P(None, axis, None),
            "w1": P(None, None, axis),
            "w2": P(None, axis, None),
            "ln1": P(None, None),
            "ln2": P(None, None),
        },
        "ln_f": P(None),
    }


def transformer_fsdp_rules(axis: str = "fsdp",
                           moe: bool = False) -> Dict[str, Any]:
    """FSDP / ZeRO-3 layout: every large leaf split on one dim over the
    data-parallel axis (each rank stores 1/n of the model and gathers a
    leaf when it uses it), tiny norms replicated. ``moe=True`` matches the
    MoE tree (expert stacks split on their model dim)."""
    layers = {
        "wqkv": P(None, axis, None),
        "wo": P(None, axis, None),
        "ln1": P(None, None),
        "ln2": P(None, None),
    }
    if moe:
        layers.update({
            "moe_w1": P(None, None, axis, None),
            "moe_w2": P(None, None, axis, None),
            "moe_router": P(None, axis, None),
        })
    else:
        layers.update({
            "w1": P(None, axis, None),
            "w2": P(None, axis, None),
        })
    return {
        "embed": P(axis, None),
        "pos": P(axis, None),
        "layers": layers,
        "ln_f": P(None),
    }


def _map2(fn, tree, rules):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, rules[k]) for k, v in tree.items()}
    return fn(tree, rules)


def leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def local_slices(shape, spec, mesh):
    """The index tuple of this rank's block of a global array of
    ``shape`` under ``spec`` (contiguous chunks, row-major over the axes
    of a dim sharded on several)."""
    idx = []
    for d, size in enumerate(shape):
        axes = tuple(iter_axes(spec[d])) if d < len(spec) else ()
        if not axes:
            idx.append(slice(None))
            continue
        n, i = mesh.axis_size(axes), mesh.index(axes)
        if size % n:
            raise ValueError(f"dim {d} of {tuple(shape)} not divisible by "
                             f"{n} {axes} shards")
        c = size // n
        idx.append(slice(i * c, (i + 1) * c))
    return tuple(idx)


def local_shape(shape, spec, mesh):
    return tuple(len(range(*s.indices(n))) for s, n in
                 zip(local_slices(shape, spec, mesh), shape))


def shard_params(params: Any, rules: Any, mesh=None,
                 dtype: Optional[torch.dtype] = None) -> Any:
    """This rank's shards of a global numpy param tree, by a matching tree
    of partition specs, as tensors on the mesh's device (in ``dtype``
    when given)."""
    mesh = mesh or Zoo.get().mesh()

    def put(x, spec):
        block = np.ascontiguousarray(np.asarray(x)[local_slices(
            np.shape(x), spec, mesh)])
        if not block.flags.writeable:   # a memory map, or jax's arrays
            block = block.copy()
        t = torch.from_numpy(block)
        if dtype is not None:
            t = t.to(dtype)
        _devstats.note_transfer(t.numel() * t.element_size(), "h2d")
        return t.to(mesh.device)

    return _map2(put, params, rules)


def gather_leaf(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor of a rank's block (every rank gets it): the
    blocks are all-gathered over each sharded dim's axes."""
    out = t.detach()
    with _devstats.collective_span("gather_params",
                                   out.numel() * out.element_size(),
                                   mesh=mesh):
        for d in range(len(spec)):
            axes = tuple(iter_axes(spec[d]))
            if axes and mesh.axis_size(axes) > 1:
                out = coll.raw_all_gather(out, mesh, axes, d)
    return out


def gather_params(shards: Any, rules: Any, mesh=None) -> Any:
    """Inverse of :func:`shard_params`: the global tree as float32 numpy
    (bf16 leaves exactly), on every rank. Collective: every rank calls."""
    mesh = mesh or Zoo.get().mesh()

    def get(t, spec):
        g = gather_leaf(t, spec, mesh)
        _devstats.note_transfer(g.numel() * g.element_size(), "d2h")
        g = g.cpu()
        return (g.float() if g.dtype == torch.bfloat16 else g).numpy()

    return _map2(get, shards, rules)


def constrain(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The JAX ``with_sharding_constraint`` hint: a rank's tensor is
    already laid out, so this checks ``spec`` against the mesh and the
    tensor's rank and returns ``x``."""
    mesh = mesh or Zoo.get().mesh()
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} longer than the tensor's {x.ndim} "
                         "dims")
    seen = []
    for part in spec:
        for a in iter_axes(part):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names {a!r}, not an axis "
                                 f"of {mesh.axis_names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses {a!r} twice")
            seen.append(a)
    return x


def column_parallel(x: torch.Tensor, w: torch.Tensor, axis: str = "tp",
                    mesh=None, x_spec=None) -> torch.Tensor:
    """y = x @ w with w this rank's column block [D, M/n]: the output
    stays sharded on its last dim (no collective on the way out; pair it
    with :func:`row_parallel`). ``x`` is replicated over ``axis`` (its
    leading dims may be sharded on other axes, ``x_spec``); its gradient
    is all-reduced over ``axis``."""
    mesh = mesh or Zoo.get().mesh()
    if x_spec is not None:
        constrain(x, x_spec, mesh)
    with _devstats.collective_span(
            "column_parallel", x.numel() * x.element_size()
            + w.numel() * w.element_size(), mesh=mesh):
        return coll.copy_to(x, mesh, axis) @ w


def row_parallel(x: torch.Tensor, w: torch.Tensor, axis: str = "tp",
                 mesh=None, x_spec=None) -> torch.Tensor:
    """y = x @ w with x sharded on its last dim and w this rank's row
    block [M/n, D]: the partial products are all-reduced over ``axis``,
    the one collective of the column -> row pair."""
    mesh = mesh or Zoo.get().mesh()
    if x_spec is not None:
        constrain(x, x_spec, mesh)
    with _devstats.collective_span(
            "row_parallel", x.numel() * x.element_size()
            + w.numel() * w.element_size(), mesh=mesh):
        return coll.reduce_from(x @ w, mesh, axis)


def mlp_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              axis: str = "tp", mesh=None, x_spec=None) -> torch.Tensor:
    """gelu(x @ w1) @ w2 with the hidden dim sharded: column_parallel ->
    local gelu (tanh form, as ``jax.nn.gelu``) -> row_parallel."""
    mesh = mesh or Zoo.get().mesh()
    h = column_parallel(x, w1, axis, mesh, x_spec)
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return row_parallel(h, w2, axis, mesh, x_spec)
