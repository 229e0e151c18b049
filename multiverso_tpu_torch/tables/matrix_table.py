"""MatrixTable: 2-D parameter matrix with row-batch Add/Get (port of
``multiverso_tpu/tables/matrix_table.py``).

One device holds the whole matrix (row sharding across cards arrives with
the multi-card slice). The host-side contract of a row op is the JAX
package's, exactly:

* row ids must be integers (``TypeError`` on floats, which would truncate
  onto arbitrary rows) inside ``[0, num_row)`` (``IndexError``), and not
  empty (``ValueError``);
* duplicate ids in one add are summed on the host in float64 with
  ``np.add.at`` and cast to the table's dtype, so the sum does not depend on
  the order of the duplicates (the reference accumulates per row);
* updater locality: an add gathers the touched rows and their updater
  state, applies the updater to them, and scatters both back, so untouched
  rows keep their momentum/adagrad state (a full-table update with a
  zero-padded delta would decay them);
* a get returns the rows in the order asked, duplicates included.

The JAX package pads each id batch to a power-of-two bucket aimed at a
scratch row, so XLA compiles one program per bucket; that changes no
result. PyTorch runs eagerly, so the port's row ops apply just the k
unique rows. ``functional_add_rows`` takes ids on the device, which the PS
block path pads to a bucket with ``scratch_row``.

With the ``train_cache_rows`` flag set, the table keeps a hot-row train
cache (``serving/hotcache.TrainRowCache``): a row get whose ids are all
cached is served from the host copy, and the PS block path takes a fully
cached block as a device block (:meth:`train_cache_device_block`). A
default-updater table writes its pushes through to the cache (the same
deduplicated, float64-summed and cast delta the device adds, so the copy
stays equal to the table's rows bit for bit); any other updater
invalidates the pushed rows.
A subclass sees each row add's deduplicated ids through
:meth:`_rows_applied`, under the dispatch lock (the sparse table's dirty
bits). Not ported yet (ROADMAP): the cross-process union of row adds.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.ops import row_assemble as _rowasm
from multiverso_tpu_torch.serving import hotcache as _hotcache
from multiverso_tpu_torch.table import Table, _Pending
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils.dashboard import monitor


def _bucket_size(k: int, cap: int) -> int:
    """The row bucket of a k-row batch, capped at ``cap`` rows: the one
    bucketing rule (``ops/row_assemble.bucket_rows``)."""
    return min(_rowasm.bucket_rows(k), cap)


class MatrixTable(Table):
    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "matrix",
                 init=None, seed: Optional[int] = None,
                 init_scale: float = 0.0):
        super().__init__((int(num_row), int(num_col)), dtype=dtype,
                         updater=updater, name=name, init=init, seed=seed,
                         init_scale=init_scale)
        # hot-row train cache (flag train_cache_rows): write-through is
        # exact only for the plain-add updater
        self._train_cache = _hotcache.make_train_cache(
            name, int(num_col), self.np_dtype,
            writethrough_ok=(getattr(self.updater, "name", "")
                             == "default"),
            device=self.device)

    @property
    def num_row(self) -> int:
        return self.shape[0]

    @property
    def num_col(self) -> int:
        return self.shape[1]

    @property
    def scratch_row(self) -> int:
        """A padding row past the logical rows (the table keeps at least
        one): padded id slots gather and update it, and no Get sees it."""
        return self._padded_rows - 1

    def _state_row_axis(self, leaf: torch.Tensor) -> Optional[int]:
        """Axis of ``leaf`` that is the table's row axis, or None (a leaf
        shared by all rows, such as Adam's step count)."""
        nd, pd = leaf.dim(), len(self._padded_shape)
        if nd >= pd and tuple(leaf.shape[nd - pd:]) == self._padded_shape:
            return nd - pd
        return None

    def _prep_ids(self, row_ids, values=None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Validate and dedupe a row-id batch: (sorted unique ids, their
        summed values or None, inverse) where ``inverse`` maps each id
        asked for to its unique slot."""
        raw = np.asarray(row_ids)
        if raw.size == 0:
            raise ValueError("empty row_ids")
        if not np.issubdtype(raw.dtype, np.integer):
            raise TypeError(f"row_ids must be integers, got dtype "
                            f"{raw.dtype} (silent float truncation would "
                            f"hit arbitrary rows)")
        ids = raw.astype(np.int64).reshape(-1)
        if np.any((ids < 0) | (ids >= self.num_row)):
            raise IndexError(f"row id out of range [0, {self.num_row})")
        uids, inv = np.unique(ids, return_inverse=True)
        inv = inv.reshape(-1)
        vals = None
        if values is not None:
            vals = np.asarray(values, dtype=self.np_dtype).reshape(
                ids.size, self.num_col)
            acc = np.zeros((uids.size, self.num_col), dtype=np.float64)
            np.add.at(acc, inv, vals.astype(np.float64))
            vals = acc.astype(self.np_dtype)
        return uids, vals, inv

    def add_rows_async(self, row_ids, values,
                       opt: Optional[AddOption] = None) -> int:
        """ref MatrixWorkerTable::AddAsync(row_ids, values): apply the
        updater to the touched rows on the device's stream."""
        self._mark_mutated()
        with monitor(f"table[{self.name}].add_rows"), self._dispatch_lock:
            uids, vals, _ = self._prep_ids(row_ids, values)
            if self._train_cache is not None:
                # the deduplicated, float64-summed and cast delta: exactly
                # what the updater adds on the device
                self._train_cache.on_push(uids, vals)
            dev_ids = torch.from_numpy(uids).to(self.device)
            self._apply_rows(self.state, dev_ids,
                             torch.from_numpy(vals).to(self.device), opt)
            # subclass hook (the sparse table's dirty bits), fed the ids
            # the add applied
            self._rows_applied(uids, dev_ids)
            self._version_applied()
            return self._track(_Pending(self._event()))

    def _rows_applied(self, ids: np.ndarray, dev_ids: torch.Tensor) -> None:
        """Called under the dispatch lock with the deduplicated row ids of
        each row add, on the host and on the table's device. Default:
        nothing."""

    def functional_add_rows(self, state: Dict[str, Any], ids: torch.Tensor,
                            vals: torch.Tensor,
                            opt: Optional[AddOption] = None
                            ) -> Dict[str, Any]:
        """Apply the updater to rows ``ids`` of ``state`` (``{"data",
        "ustate"}``, the table's padded layout) with deltas ``vals`` (one
        row per id), all on the state's device: gather the rows and their
        row-shaped updater state, apply, scatter both back. Rows not in
        ``ids`` keep their updater state. The ids may repeat only where
        their deltas leave equal rows (the scratch row with zero deltas,
        how the PS block path pads a bucket). The JAX function returns new
        arrays; this one updates ``state``'s tensors in place and returns
        ``state``. On the table's live state it is a mutation of the
        table: the version bumps and the train cache clears."""
        live = state["data"] is self._data
        if live:
            self._mark_mutated()
        self._apply_rows(state, ids, vals, opt)
        if live:
            self._wrote_in_place()
        return state

    def _apply_rows(self, state: Dict[str, Any], ids: torch.Tensor,
                    vals: torch.Tensor,
                    opt: Optional[AddOption] = None) -> None:
        """The body of :meth:`functional_add_rows`, with no bookkeeping."""
        opt = opt or AddOption()
        data, ustate = state["data"], state["ustate"]
        axes = {k: self._state_row_axis(v) for k, v in ustate.items()}
        rows = data.index_select(0, ids)
        gstate = {k: (v.index_select(axes[k], ids)
                      if axes[k] is not None else v)
                  for k, v in ustate.items()}
        rows, gstate = self.updater.apply(rows, gstate, vals, opt)
        data.index_copy_(0, ids, rows)
        for k, axis in axes.items():
            if axis is not None:
                ustate[k].index_copy_(axis, ids, gstate[k])

    def add_rows(self, row_ids, values,
                 opt: Optional[AddOption] = None) -> None:
        self.wait(self.add_rows_async(row_ids, values, opt))

    def get_rows_async(self, row_ids) -> int:
        """ref MatrixWorkerTable::GetAsync(row_ids): gather the rows, start
        the device -> host copy, return a msg id. With the train cache, a
        batch whose ids are all cached is served from the host copy, and
        the rows of a miss fill the cache when the reply is read."""
        self._flush_host_adds()   # row reads see prior whole-table adds
        with monitor(f"table[{self.name}].get_rows"), self._dispatch_lock:
            uids, _, inv = self._prep_ids(row_ids)
            tc = self._train_cache
            token = 0
            if tc is not None:
                tc.on_get()
                # token, membership and gather in one cache lock hold;
                # all or nothing (a partial hit refetches every row)
                token, buf = tc.serve_full(uids)
                if buf is not None:
                    tc.count(uids.size, 0)
                    return self._track(_Pending(None, buf,
                                                lambda b: b[inv]))
                tc.count(0, uids.size)
            rows = self._data.index_select(
                0, torch.from_numpy(uids).to(self.device))
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=self.dtype,
                                   pin_memory=True)
                host.copy_(rows, non_blocking=True)
            else:
                host = rows

            def _fin(h):
                h = h.numpy()
                if tc is not None:
                    # warm for the next block, reconciled with the pushes
                    # issued since the token (fill_since replays them)
                    tc.fill_since(uids, h, token)
                return h[inv]

            return self._track(_Pending(self._event(), host, _fin))

    def get_rows(self, row_ids,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
        host = self.wait(self.get_rows_async(row_ids))
        if out is not None:
            np.copyto(out.reshape(host.shape), host)
            return out
        return host

    def get_row(self, row_id: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
        row = self.get_rows([row_id])
        if out is not None:
            np.copyto(out.reshape(self.num_col), row[0])
            return out
        return row[0]

    def add_row(self, row_id: int, values,
                opt: Optional[AddOption] = None) -> None:
        self.add_rows([row_id], np.asarray(values).reshape(1, -1), opt)

    # ------------------------------------------------------------------ #
    # hot-row train cache (serving/hotcache.TrainRowCache)
    # ------------------------------------------------------------------ #
    def train_cache_stats(self) -> Optional[Dict]:
        tc = self._train_cache
        return None if tc is None else tc.stats()

    def train_cache_device_block(self, row_ids,
                                 bucket: int) -> Optional[torch.Tensor]:
        """The cached rows of ``row_ids`` as a zero-padded (bucket,
        num_col) block on the table's device when EVERY id is cached;
        None otherwise (the caller falls back to :meth:`get_rows_async`,
        which counts its own hits and misses)."""
        tc = self._train_cache
        if tc is None:
            return None
        return tc.device_block_counted(row_ids, bucket)


class MatrixTableOption:
    """ref DEFINE_TABLE_TYPE option struct:
    ``create_table(MatrixTableOption(num_row, num_col))``."""

    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater=None, init=None, seed=None, init_scale: float = 0.0):
        self.num_row, self.num_col = num_row, num_col
        self.dtype = dtype
        self.updater = updater
        self.init = init
        self.seed = seed
        self.init_scale = init_scale

    def build(self, name: str = "matrix") -> MatrixTable:
        return MatrixTable(self.num_row, self.num_col, dtype=self.dtype,
                           updater=self.updater, name=name, init=self.init,
                           seed=self.seed, init_scale=self.init_scale)
