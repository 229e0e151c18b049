"""Python side of the C ABI (port of ``multiverso_tpu/c_api_support.py``;
the C side is ``csrc/mv_capi.cpp``, built by ``native/capi.py``).

The C layer passes raw pointers as integers; this module wraps them with
ctypes into zero-copy numpy views and forwards to the real tables. Handles
are small integers into a registry (the reference's ``TableHandler =
void*``, ref include/multiverso/c_api.h:14).

Where the tables live: ``MV_Init`` calls :func:`init`, which starts the
Zoo on the card, and raises without one, unless the environment's
``MV_CAPI_PLATFORM`` names another device (``MV_CAPI_PLATFORM=cpu``: the
C driver's CPU run). The JAX package pins its platform there the same
way.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict

import numpy as np

import multiverso_tpu_torch as mv

_tables: Dict[int, object] = {}
_next_handle = 1


def _view(addr: int, size: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_float * size).from_address(addr))


def _iview(addr: int, size: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_int32 * size).from_address(addr))


def init() -> None:
    """ref MV_Init: the Zoo on the card, or on ``MV_CAPI_PLATFORM``'s
    device when the environment names one."""
    mv.init(device=os.environ.get("MV_CAPI_PLATFORM") or None)


def shutdown() -> None:
    mv.shutdown()


def barrier() -> None:
    """ref MV_Barrier. The C ABI has no flush entry point, so FFI clients
    use the barrier as the fence after async adds: every async table of
    the registry is flushed first. The barrier runs even when a flush
    raises (a peer left blocked in it would wait forever: the C layer only
    prints and clears a Python error); then the first failure is raised
    with the second chained as its cause, and the rest are logged."""
    errors = []
    for t in list(_tables.values()):
        flush = getattr(t, "flush", None)
        if callable(flush):
            try:
                flush()
            except Exception as exc:  # noqa: BLE001 — surfaced below
                errors.append(exc)
    mv.barrier()
    if errors:
        from multiverso_tpu_torch.utils import log
        for exc in errors[1:]:
            log.error("barrier: additional async-table flush failure "
                      "(first one is raised): %s: %s",
                      type(exc).__name__, exc)
        if len(errors) > 1:
            raise errors[0] from errors[1]
        raise errors[0]


def num_workers() -> int:
    return mv.num_workers()


def worker_id() -> int:
    return mv.worker_id()


def server_id() -> int:
    return mv.server_id()


def _register(table) -> int:
    global _next_handle
    handle = _next_handle
    _next_handle += 1
    _tables[handle] = table
    return handle


def new_array_table(size: int) -> int:
    return _register(mv.ArrayTable(size, dtype=np.float32,
                                   name=f"c_array_{_next_handle}"))


def new_matrix_table(num_row: int, num_col: int) -> int:
    return _register(mv.MatrixTable(num_row, num_col, dtype=np.float32,
                                    name=f"c_matrix_{_next_handle}"))


def new_async_array_table(size: int) -> int:
    """An async-plane array table for FFI clients (beyond the reference C
    API, which reached only the sync tables): every process owns a row
    range served by its PSService. The array accessors work on it
    unchanged."""
    return _register(mv.AsyncArrayTable(size, dtype=np.float32,
                                        name=f"c_async_array_{_next_handle}"))


def new_async_matrix_table(num_row: int, num_col: int) -> int:
    """An async-plane matrix table for FFI clients (see
    :func:`new_async_array_table`); the matrix accessors work on it
    unchanged."""
    return _register(mv.AsyncMatrixTable(
        num_row, num_col, dtype=np.float32,
        name=f"c_async_matrix_{_next_handle}"))


def array_get(handle: int, addr: int, size: int) -> None:
    """The table's values copied straight into the caller's buffer."""
    _tables[handle].get(out=_view(addr, size))


def array_add(handle: int, addr: int, size: int, do_wait: int) -> None:
    t = _tables[handle]
    data = _view(addr, size).copy()
    if do_wait:
        t.add(data)
    else:
        t.add_async(data)


def matrix_get_all(handle: int, addr: int, size: int) -> None:
    t = _tables[handle]
    view = _view(addr, size)
    if size == t.num_row * t.num_col:
        t.get(out=view.reshape(t.num_row, t.num_col))
    else:
        view[:] = t.get().reshape(-1)[:size]


def matrix_add_all(handle: int, addr: int, size: int, do_wait: int) -> None:
    t = _tables[handle]
    data = _view(addr, size).copy().reshape(t.num_row, t.num_col)
    if do_wait:
        t.add(data)
    else:
        t.add_async(data)


def matrix_get_rows(handle: int, addr: int, size: int, ids_addr: int,
                    ids_n: int) -> None:
    t = _tables[handle]
    ids = _iview(ids_addr, ids_n).copy()
    view = _view(addr, size)
    if size == ids_n * t.num_col:
        t.get_rows(ids, out=view.reshape(ids_n, t.num_col))
    else:
        view[:] = t.get_rows(ids).reshape(-1)[:size]


def matrix_add_rows(handle: int, addr: int, size: int, ids_addr: int,
                    ids_n: int, do_wait: int) -> None:
    t = _tables[handle]
    ids = _iview(ids_addr, ids_n).copy()
    vals = _view(addr, size).copy().reshape(ids_n, t.num_col)
    if do_wait:
        t.add_rows(ids, vals)
    else:
        t.add_rows_async(ids, vals)
