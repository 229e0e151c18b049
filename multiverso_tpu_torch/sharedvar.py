"""Shared-variable delta sync over parameter trees (port of
``multiverso_tpu/sharedvar.py``).

All leaves of a nested dict of tensors or arrays (or of an ``nn.Module``'s
parameters, nested by their dotted names) are flattened into one
``ArrayTable``; ``sync()`` pushes the local delta since the last sync and
pulls the merged global state (ref theano_ext sharedvar.py ``mv_sync``).

The flat layout equals the JAX package's: ``jax.tree.leaves`` of a dict
visits keys in sorted order at every level, and so does ``_leaves`` here,
so both packages' tables hold the same float32 vector for the same
parameters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from multiverso_tpu_torch import api
from multiverso_tpu_torch.tables import ArrayTable


def _tree_of(params: Any) -> Any:
    """An ``nn.Module`` becomes the nested dict of its parameters."""
    if not isinstance(params, nn.Module):
        return params
    tree: Dict[str, Any] = {}
    for name, p in params.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p
    return tree


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree.leaves`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out.extend(_leaves(tree[key], path + (key,)))
        return out
    return [(path, tree)]


def _as_f32(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy().reshape(-1)
    return np.asarray(leaf, dtype=np.float32).reshape(-1)


def _flatten(tree: Any) -> np.ndarray:
    leaves = [l for _, l in _leaves(_tree_of(tree))]
    return np.concatenate([_as_f32(l) for l in leaves]) if leaves \
        else np.zeros(0, np.float32)


def _np_dtype(leaf: Any) -> np.dtype:
    """numpy dtype of a leaf; bf16 tensors come back as float32."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


class SharedPytree:
    """``mv_shared`` + ``MVNetParamManager`` equivalent for parameter trees."""

    def __init__(self, params: Any, name: str = "shared_params"):
        leaves = _leaves(_tree_of(params))
        self._paths = [p for p, _ in leaves]
        self._shapes = [tuple(np.shape(l)) for _, l in leaves]
        self._dtypes = [_np_dtype(l) for _, l in leaves]
        self._sizes = [int(np.prod(s)) if s else 1 for s in self._shapes]
        flat = _flatten(params)
        self.table = ArrayTable(max(flat.size, 1), dtype=np.float32,
                                name=name)
        # master-init convention (ref param_manager.py:24-31)
        if api.is_master_worker():
            self.table.add(flat)
        else:
            self.table.add(np.zeros_like(flat))
        api.barrier()
        self._last = self.table.get().copy()

    def unflatten(self, flat: np.ndarray) -> Any:
        """Nested dict of numpy leaves in the original shapes."""
        if self._paths == [()]:
            return flat[: self._sizes[0]].reshape(self._shapes[0]).astype(
                self._dtypes[0])
        tree: Dict[str, Any] = {}
        off = 0
        for path, shape, dtype, size in zip(self._paths, self._shapes,
                                            self._dtypes, self._sizes):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flat[off: off + size].reshape(shape).astype(dtype)
            off += size
        return tree

    def sync(self, params: Any) -> Any:
        """Add(current - last), Get, return the merged params."""
        current = _flatten(params)
        self.table.add(current - self._last)
        merged = self.table.get()
        self._last = merged.copy()
        return self.unflatten(merged)

    def get(self) -> Any:
        flat = self.table.get()
        self._last = flat.copy()
        return self.unflatten(flat)
