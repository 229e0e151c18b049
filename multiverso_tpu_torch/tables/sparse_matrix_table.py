"""SparseMatrixTable: stale-row tracking and minimal host transfer (port of
``multiverso_tpu/tables/sparse_matrix_table.py``).

The reference sparse matrix protocol (ref: include/multiverso/table/matrix.h
+ src/table/matrix.cpp:432-572 and the older
src/table/sparse_matrix_table.cpp) keeps ``up_to_date_[worker][row]`` dirty
bits on the server: a Get returns only the rows that are stale for the
requesting worker (GetOption.worker_id, matrix.cpp:475-483), and an Add
marks the touched rows stale for every worker (:516-540).

Here the wire is the device -> host copy, and a sparse Get is two-phase:

1. the requested rows' dirty bits for this worker are read and cleared on
   the device, and only that bool mask crosses to the host;
2. only the stale rows are gathered and copied, then merged into the
   worker's host :class:`_RowCache`, which serves every requested row.

The dirty bits are a ``(num_workers, padded_rows)`` bool tensor on the
table's device, sharded with the rows: each rank holds the columns of its
block. Row adds mark their rows for every worker
(``MatrixTable._rows_applied``): with more than one process, the union of
every process's rows, so a row that only another worker added is stale
here too (the reference's server sees the union by construction); a
whole-table ``add_async`` marks every row.

On a sharded table ``get_rows_sparse`` and ``stale_fraction`` are
collectives over the table axis (every rank calls them, in one order,
each with its own ids and worker id): the owners of the asked rows read
every asker's bits first and then clear them (two ranks that ask with
one worker id both see the bits as they were), and the stale rows come
from their owners (``MatrixTable._exchange``). A row missing from this
process's cache is fetched whatever its bit says, so a worker id shared
by several processes still serves every row. ``load`` and ``adopt`` mark nothing, as in the JAX package (ROADMAP
C.8): a worker that pulled rows before them is served its cached rows.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.tables.matrix_table import MatrixTable
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils.dashboard import monitor
from multiverso_tpu_torch.zoo import Zoo


class SparseMatrixTable(MatrixTable):
    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "sparse_matrix",
                 init=None, seed: Optional[int] = None,
                 init_scale: float = 0.0,
                 num_workers: Optional[int] = None):
        super().__init__(num_row, num_col, dtype=dtype, updater=updater,
                         name=name, init=init, seed=seed,
                         init_scale=init_scale)
        self._n_workers = num_workers or Zoo.get().num_workers()
        # dirty[worker, row]: True = the row changed since this worker
        # last pulled it. All True at first, so the first Get pulls
        # everything (ref matrix.cpp: up_to_date_ starts false)
        self._dirty = torch.ones((self._n_workers, self._local_shape[0]),
                                 dtype=torch.bool, device=self.device)
        # worker-side row caches, made per worker at its first Get and
        # keyed by row: O(rows pulled), not O(table)
        self._cache: dict = {}

    def _worker_cache(self, worker_id: int) -> "_RowCache":
        if not (0 <= worker_id < self._n_workers):
            raise IndexError(
                f"worker_id {worker_id} out of range [0, {self._n_workers})")
        cache = self._cache.get(worker_id)
        if cache is None:
            cache = self._cache[worker_id] = _RowCache(self.num_col,
                                                       self.np_dtype)
        return cache

    def cache_nbytes(self, worker_id: int) -> int:
        """Host bytes held by ``worker_id``'s row cache (diagnostic)."""
        return self._worker_cache(worker_id).nbytes

    def _rows_applied(self, ids: np.ndarray, dev_ids: torch.Tensor) -> None:
        """Mark the added rows of this block, the cross-process union,
        stale for every worker (ref matrix.cpp:516-540)."""
        self._dirty.index_fill_(1, dev_ids, True)

    def _stale_bits(self, uids: np.ndarray, worker_id: int,
                    clear: bool) -> np.ndarray:
        """The dirty bits of rows ``uids`` for ``worker_id`` (cleared
        after the read when ``clear``), on the host: local, or from the
        rows' owners on a sharded table (a collective)."""
        if self._num_shards == 1:
            dev_ids = torch.from_numpy(uids).to(self.device)
            bits = self._dirty[worker_id]
            mask = bits.index_select(0, dev_ids).cpu().numpy()
            if clear:
                bits.index_fill_(0, dev_ids, False)
            return mask

        def answer(tags, local):
            # every asker's bits first, then the clears
            out = [self._dirty[w].index_select(0, ids).to(torch.uint8)
                   for w, ids in zip(tags, local)]
            if clear:
                for w, ids in zip(tags, local):
                    self._dirty[w].index_fill_(0, ids, False)
            return out

        return self._exchange(uids, worker_id, answer, (), torch.uint8
                              ).cpu().numpy().astype(bool)

    def add_async(self, delta, opt: Optional[AddOption] = None) -> int:
        msg_id = super().add_async(delta, opt)
        # a whole-table add dirties every row for every worker; callers
        # with sparse deltas use add_rows (ref matrix.cpp:147-182 detects
        # the nonzero rows of a full add instead)
        with self._dispatch_lock:
            self._dirty.fill_(True)
        return msg_id

    def get_rows_sparse(self, row_ids, worker_id: int = 0) -> np.ndarray:
        """The requested rows, copying off the device only the ones stale
        for ``worker_id``; fresh ones come from the worker's cache (ref
        matrix.cpp:475-483 and :540-572)."""
        self._flush_host_adds()   # row reads see prior whole-table adds
        with monitor(f"table[{self.name}].get_rows_sparse"), \
                self._dispatch_lock:
            cache = self._worker_cache(worker_id)
            ids = np.asarray(row_ids, dtype=np.int64).reshape(-1)
            uids, _, _ = self._prep_ids(row_ids)
            stale = uids[self._stale_bits(uids, worker_id, clear=True)
                         | ~cache.holds(uids)]
            if self._num_shards > 1:
                # a collective even where this rank has no stale row
                cache.put(stale, self.rows_from_owners(stale).cpu().numpy())
            elif stale.size:
                cache.put(stale, super().get_rows(stale))
            return cache.take(ids)

    def stale_fraction(self, row_ids, worker_id: int = 0) -> float:
        """Diagnostic: the share of the requested distinct rows that would
        be copied."""
        self._worker_cache(worker_id)   # validates worker_id
        if np.asarray(row_ids).size == 0:
            return 0.0
        uids, _, _ = self._prep_ids(row_ids)
        return float(self._stale_bits(uids, worker_id, clear=False).mean())


class _RowCache:
    """Row-keyed worker cache: a sorted-key index (row_id -> slot, resolved
    with ``np.searchsorted`` so lookups stay vectorized) over a growable
    (slots, num_col) buffer. Memory is O(distinct rows pulled) with
    amortized doubling — the sparse analogue of the reference worker's
    local row buffer (ref src/table/matrix.cpp worker side)."""

    def __init__(self, num_col: int, dtype):
        self._num_col = int(num_col)
        self._dtype = dtype
        self._keys = np.empty(0, np.int64)    # sorted distinct row ids
        self._slots = np.empty(0, np.int64)   # buffer slot per sorted key
        self._buf = np.empty((0, self._num_col), dtype)
        self._n = 0                           # slots in use

    @property
    def nbytes(self) -> int:
        return self._buf.nbytes + self._keys.nbytes + self._slots.nbytes

    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        if need <= self._buf.shape[0]:
            return
        cap = max(8, self._buf.shape[0])
        while cap < need:
            cap *= 2
        buf = np.empty((cap, self._num_col), self._dtype)
        buf[: self._buf.shape[0]] = self._buf
        self._buf = buf

    def _locate(self, ids: np.ndarray):
        """(insertion positions, found mask) of ``ids`` in the key index."""
        pos = np.searchsorted(self._keys, ids)
        if self._keys.size == 0:
            return pos, np.zeros(ids.size, bool)
        clip = np.minimum(pos, self._keys.size - 1)
        return clip, self._keys[clip] == ids

    def put(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Insert/overwrite rows; ``ids`` must be distinct (callers pass the
        unique stale subset of an already-deduped batch)."""
        ids = np.asarray(ids, np.int64)
        clip, found = self._locate(ids)
        n_new = int(ids.size - found.sum())
        self._ensure(n_new)
        slots = np.empty(ids.size, np.int64)
        slots[found] = self._slots[clip[found]]
        if n_new:
            new_slots = np.arange(self._n, self._n + n_new)
            slots[~found] = new_slots
            # insert at their searchsorted positions: O(K + n log n), not a
            # full re-sort of the K cached keys per pull
            order = np.argsort(ids[~found], kind="stable")
            nk, ns = ids[~found][order], new_slots[order]
            at = np.searchsorted(self._keys, nk)
            self._keys = np.insert(self._keys, at, nk)
            self._slots = np.insert(self._slots, at, ns)
            self._n += n_new
        self._buf[slots] = rows

    def holds(self, ids: np.ndarray) -> np.ndarray:
        """Which of ``ids`` are cached (a bool mask)."""
        return self._locate(np.asarray(ids, np.int64))[1]

    def take(self, ids: np.ndarray) -> np.ndarray:
        """Rows for ``ids``; every id must be cached (dirty bits start all
        True, so a never-pulled row is stale and lands in the cache
        first)."""
        ids = np.asarray(ids, np.int64)
        clip, found = self._locate(ids)
        if not found.all():
            raise KeyError(
                f"rows {ids[~found][:5].tolist()}... not cached (stale "
                "protocol invariant violated)")
        return self._buf[self._slots[clip]]


class SparseMatrixTableOption:
    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater=None, init=None, seed=None, init_scale: float = 0.0,
                 num_workers: Optional[int] = None):
        self.num_row, self.num_col = num_row, num_col
        self.dtype = dtype
        self.updater = updater
        self.init = init
        self.seed = seed
        self.init_scale = init_scale
        self.num_workers = num_workers

    def build(self, name: str = "sparse_matrix") -> SparseMatrixTable:
        return SparseMatrixTable(
            self.num_row, self.num_col, dtype=self.dtype,
            updater=self.updater, name=name, init=self.init, seed=self.seed,
            init_scale=self.init_scale, num_workers=self.num_workers)
