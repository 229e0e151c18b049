"""Binding-style table handlers (port of ``multiverso_tpu/handlers.py``).

The reference Python binding's surface (ref:
binding/python/multiverso/tables.py — ArrayTableHandler /
MatrixTableHandler over the C ABI; float32 only) over this package's
tables, with its *master-init convention*: worker 0 Adds the init value
while the others Add zeros, so the shared value is initialized exactly
once (tables.py:50-57). Users of the reference binding, or of the JAX
package's handlers, switch imports and keep their code.

Data may be numpy (or anything ``np.asarray`` takes) or a ``torch.Tensor``;
a tensor goes to the table's device as it is, with no host hop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

import multiverso_tpu_torch as mv


def _f32(data, shape) -> "np.ndarray | torch.Tensor":
    """``data`` as float32 of ``shape``: a tensor stays a tensor."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.float32).reshape(shape)
    return np.asarray(data, dtype=np.float32).reshape(shape)


def _master_init(table, init_value) -> None:
    """Worker 0 contributes the value; every worker takes part in the Add
    so the collective and the barrier stay uniform (ref tables.py:50-57)."""
    if mv.is_master_worker():
        table.add(init_value)
    else:
        table.add(np.zeros(init_value.shape, np.float32)
                  if isinstance(init_value, np.ndarray)
                  else torch.zeros_like(init_value))
    mv.barrier()


class ArrayTableHandler:
    def __init__(self, size: int, init_value=None, name: str = "array"):
        self._table = mv.ArrayTable(int(size), dtype=np.float32, name=name)
        self.size = int(size)
        if init_value is not None:
            _master_init(self._table, _f32(init_value, (-1,)))

    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        return self._table.get(out=out)

    def add(self, data, sync: bool = False) -> None:
        """ref tables.py add(data, sync=False): async by default; a later
        get always reflects this add regardless (the table applies in
        dispatch order), sync=True additionally blocks until it
        completes."""
        data = _f32(data, (-1,))
        if sync:
            self._table.add(data)
        else:
            self._table.add_async(data)

    @property
    def table(self) -> mv.ArrayTable:
        return self._table


class MatrixTableHandler:
    def __init__(self, num_row: int, num_col: int, init_value=None,
                 name: str = "matrix"):
        self._table = mv.MatrixTable(int(num_row), int(num_col),
                                     dtype=np.float32, name=name)
        self.num_row, self.num_col = int(num_row), int(num_col)
        if init_value is not None:
            _master_init(self._table,
                         _f32(init_value, (self.num_row, self.num_col)))

    @staticmethod
    def _check_row_ids(row_ids):
        # the table re-validates; checking here too makes the
        # legacy-positional mistake (h.get(buf) / h.add(data, False)) fail
        # before any table work, with empty batches left to the table's
        # clearer "empty row_ids" error
        arr = np.asarray(row_ids)
        if arr.size and not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(
                f"row_ids must be integers, got dtype {arr.dtype} (out= and "
                f"sync= are keyword-only to keep this surface unambiguous)")

    def get(self, row_ids=None, *,
            out: Optional[np.ndarray] = None) -> np.ndarray:
        """Whole table, or just ``row_ids`` when given — the reference
        binding's single-method surface (ref tables.py:108
        ``get(row_ids=None)``). ``out`` is keyword-only so a legacy
        positional buffer cannot be misread as row ids."""
        if row_ids is None:
            return self._table.get(out=out)
        self._check_row_ids(row_ids)
        return self._table.get_rows(row_ids, out=out)

    def add(self, data, row_ids=None, *, sync: bool = False) -> None:
        """Whole-table add, or a row-batch add when ``row_ids`` is given
        (ref tables.py:132 ``add(data, row_ids=None, sync=False)``);
        ``sync`` is keyword-only for the same reason as ``get``'s ``out``,
        and async by default like the reference (later gets still see the
        add)."""
        if row_ids is not None:
            self._check_row_ids(row_ids)
            return self.add_rows(row_ids, data, sync=sync)
        data = _f32(data, (self.num_row, self.num_col))
        if sync:
            self._table.add(data)
        else:
            self._table.add_async(data)

    def get_rows(self, row_ids, out: Optional[np.ndarray] = None) -> np.ndarray:
        return self._table.get_rows(row_ids, out=out)

    def add_rows(self, row_ids, values, sync: bool = False) -> None:
        if sync:
            self._table.add_rows(row_ids, values)
        else:
            self._table.add_rows_async(row_ids, values)

    @property
    def table(self) -> mv.MatrixTable:
        return self._table
