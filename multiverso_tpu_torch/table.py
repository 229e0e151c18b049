"""Table core: one device tensor with Add/Get semantics (port of
``multiverso_tpu/table.py``).

* storage     -> one padded tensor on the Zoo's device, plus the updater's
                 state tensors beside it.
* Add         -> the delta is copied to the device (padded) and the updater
                 applies it IN PLACE on the current CUDA stream.
* Get         -> device -> host copy of ``data[:rows]``.
* AddAsync /
  GetAsync    -> every op returns a msg id. An add's id is backed by a CUDA
                 event recorded after the in-place update; a get snapshots
                 the data with a clone and starts a non-blocking copy into
                 pinned host memory. ``wait(id)`` blocks on the event.

Program order on one stream gives every Get the state after all previously
issued Adds, the BSP guarantee of the reference's SyncServer. On the CPU
every op completes before it returns.

The functional plane's ``state``/``adopt`` hand the live tensors to code
that trains them in place (the fused WordEmbedding epoch) and commit the
result. Not ported yet (see ROADMAP): the wire filters, the version-stamped
get cache and write-triggered prefetch, host-add coalescing,
``functional_add`` and ``store``/``load``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.zoo import Zoo

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence]


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _dtypes(dtype) -> Tuple[np.dtype, torch.dtype]:
    """(numpy dtype, torch dtype) of a table; Get hands out numpy arrays,
    so the dtype must exist in both libraries."""
    if isinstance(dtype, torch.dtype):
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    else:
        np_dtype = np.dtype(dtype)
    return np_dtype, torch.from_numpy(np.empty(0, np_dtype)).dtype


class _Pending:
    """One in-flight op: ``finalize`` is None for adds."""

    __slots__ = ("event", "host", "finalize")

    def __init__(self, event: Optional[torch.cuda.Event],
                 host: Optional[torch.Tensor] = None,
                 finalize: Optional[Callable[[torch.Tensor], Any]] = None):
        self.event, self.host, self.finalize = event, host, finalize

    def done(self) -> bool:
        return self.event is None or self.event.query()


class Table:
    """Base table on one device. Subclasses fix dimensionality."""

    def __init__(self, shape: Tuple[int, ...], dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "table",
                 init: Optional[ArrayLike] = None,
                 seed: Optional[int] = None,
                 init_scale: float = 0.0):
        zoo = Zoo.get()
        self._zoo = zoo
        self.name = name
        self.np_dtype, self.dtype = _dtypes(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.device = zoo.device()
        self._num_shards = 1

        # at least one spare row, as in the JAX package, so padded shapes
        # (and a seeded init's draws) match its layout
        self._padded_rows = _ceil_to(self.shape[0] + 1, self._num_shards)
        self._padded_shape = (self._padded_rows,) + self.shape[1:]

        if updater is None:
            updater = config.get_flag("updater_type")
        if isinstance(updater, str):
            updater = updaters_lib.get_updater(
                updater, num_workers=zoo.num_workers(), dtype=self.np_dtype)
        self.updater = updater

        self._data = self._build_init(init, seed, init_scale)
        self._ustate = updater.init_state(self._padded_shape, self.dtype,
                                          self.device)
        self.table_id = zoo.register_table(self)
        self._pending: Dict[int, _Pending] = {}
        self._next_msg_id = 0
        self._lock = threading.Lock()
        # serializes op dispatch: an add must not mutate the data while
        # another thread is snapshotting it
        self._dispatch_lock = threading.RLock()

    def _build_init(self, init, seed, init_scale) -> torch.Tensor:
        data = torch.zeros(self._padded_shape, dtype=self.dtype,
                           device=self.device)
        if init is not None:
            arr = np.asarray(init, dtype=self.np_dtype)
            if arr.shape != self.shape:
                raise ValueError(
                    f"init shape {arr.shape} != table shape {self.shape}")
            data[: self.shape[0]].copy_(torch.from_numpy(arr))
        elif seed is not None and init_scale != 0.0:
            # Uniform(-scale, scale) from numpy, the same numbers as the
            # JAX package for the same seed
            rng = np.random.default_rng(seed)
            out = rng.uniform(-init_scale, init_scale,
                              self._padded_shape).astype(self.np_dtype)
            out[self.shape[0]:] = 0
            data.copy_(torch.from_numpy(out))
        return data

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return self._padded_shape

    def raw(self) -> torch.Tensor:
        """The live padded data tensor."""
        return self._data

    # ------------------------------------------------------------------ #
    # functional plane (ref multiverso_tpu/table.py state/adopt)
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> Dict[str, Any]:
        """The live table state ``{"data", "ustate"}``: the padded data
        tensor and the updater's state tensors, not copies."""
        return {"data": self._data, "ustate": self._ustate}

    def adopt(self, state: Dict[str, Any]) -> None:
        """Commit a table state advanced outside the table (the end of an
        in-place training loop). The data keeps the table's padded shape,
        dtype and device."""
        data = state["data"]
        if (tuple(data.shape) != self._padded_shape
                or data.dtype != self.dtype or data.device != self.device):
            raise ValueError(
                f"adopt: data {tuple(data.shape)} {data.dtype} {data.device}"
                f" does not match the table's {self._padded_shape} "
                f"{self.dtype} {self.device}")
        with self._dispatch_lock:
            self._data = data
            self._ustate = state["ustate"]

    # ------------------------------------------------------------------ #
    # msg-id bookkeeping (ref src/table.cpp:27-97)
    # ------------------------------------------------------------------ #
    def _event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _track(self, op: _Pending) -> int:
        with self._lock:
            # sweep completed fire-and-forget adds; a swept id behaves like
            # an already-waited one (wait returns None)
            done = [mid for mid, p in self._pending.items()
                    if p.finalize is None and p.done()]
            for mid in done:
                del self._pending[mid]
            msg_id = self._next_msg_id
            self._next_msg_id += 1
            self._pending[msg_id] = op
            return msg_id

    def wait(self, msg_id: int) -> Any:
        """Block until the op behind ``msg_id`` is complete. Returns the
        host array for a get, ``None`` for an add or an unknown id."""
        with self._lock:
            op = self._pending.pop(msg_id, None)
        if op is None:
            return None
        if op.event is not None:
            op.event.synchronize()
        return op.finalize(op.host) if op.finalize is not None else None

    # ------------------------------------------------------------------ #
    # whole-table ops
    # ------------------------------------------------------------------ #
    def _device_delta(self, delta: ArrayLike) -> torch.Tensor:
        """Padded delta on the table's device."""
        if isinstance(delta, torch.Tensor):
            if tuple(delta.shape) == self._padded_shape:
                return delta.to(self.device, self.dtype)
            src = delta.reshape(self.shape)
        else:
            src = torch.from_numpy(np.ascontiguousarray(
                np.asarray(delta, dtype=self.np_dtype)).reshape(self.shape))
        padded = torch.zeros(self._padded_shape, dtype=self.dtype,
                             device=self.device)
        padded[: self.shape[0]].copy_(src)
        return padded

    def add_async(self, delta: ArrayLike,
                  opt: Optional[AddOption] = None) -> int:
        """ref WorkerTable::AddAsync: apply the update on the device's
        stream, return a msg id."""
        opt = opt or AddOption()
        with monitor(f"table[{self.name}].add"), self._dispatch_lock:
            self.updater.apply(self._data, self._ustate,
                               self._device_delta(delta), opt)
            return self._track(_Pending(self._event()))

    def add(self, delta: ArrayLike, opt: Optional[AddOption] = None) -> None:
        """ref WorkerTable::Add: blocking add (Wait(AddAsync(...)))."""
        self.wait(self.add_async(delta, opt))

    def get_async(self) -> int:
        """ref WorkerTable::GetAsync: snapshot, start the device -> host
        copy, return a msg id."""
        with monitor(f"table[{self.name}].get"), self._dispatch_lock:
            snap = self._data[: self.shape[0]].clone()
            if self.device.type == "cuda":
                host = torch.empty(self.shape, dtype=self.dtype,
                                   pin_memory=True)
                host.copy_(snap, non_blocking=True)
            else:
                host = snap
            return self._track(_Pending(self._event(), host,
                                        lambda h: h.numpy()))

    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """ref WorkerTable::Get: blocking pull of the whole logical table."""
        with monitor(f"table[{self.name}].get"), self._dispatch_lock:
            host = self._data[: self.shape[0]].to("cpu", copy=True).numpy()
        if out is not None:
            np.copyto(out.reshape(self.shape), host)
            return out
        return host

    def read(self, msg_id: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Materialize the result of a previous :meth:`get_async`."""
        with self._lock:
            op = self._pending.get(msg_id)
        if op is not None and op.finalize is None:
            raise TypeError(
                f"msg_id {msg_id} is an add, not a get; use wait()")
        host = self.wait(msg_id)
        if host is None:
            raise KeyError(f"msg_id {msg_id} unknown or already consumed")
        if out is not None:
            np.copyto(out.reshape(self.shape), host)
            return out
        return host
