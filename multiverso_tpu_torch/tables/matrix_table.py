"""MatrixTable: 2-D parameter matrix with row-batch Add/Get (port of
``multiverso_tpu/tables/matrix_table.py``).

The rows are sharded over the Zoo mesh's table axis in contiguous blocks,
as the JAX package's are (``table.py``; the reference routed row ids to
servers by ``row_id / rows_per_server``, src/table/matrix_table.cpp:
266-313); a world of one holds the whole matrix. The host-side contract
of a row op is the JAX package's, exactly:

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
bits).

More than one process: a row add is a collective, and each process may
bring other ids (the WordEmbedding traffic pattern). Every process
deduplicates its own batch as above, then the processes agree on the
largest batch, pad theirs to it with the scratch row, gather every
process's ids and values, and sum the union's values in float64
(``np.unique`` over the ids, ``np.add.at``; the scratch row dropped), as
the JAX package does. Each rank then applies the union's rows that lie
in its block, and the train cache sees the union's ids. The JAX package
pads each batch to a power-of-two bucket for XLA; the port's row ops
apply just the unique rows.

A row read of a sharded table is a collective over the table axis: every
rank calls it, in one order, and may ask for its own ids (a superset of
the JAX contract, where the ids must be the same on every process). The
ranks gather each other's ids, each owner gathers the asked rows of its
block, and one all_to_all brings every rank its rows
(:meth:`MatrixTable._exchange`). With the train cache, a read is served
from the cache only where every rank of the axis hits. On a sharded
table ``functional_add_rows`` takes indices into this rank's block.

A functional step reads its own state's rows the same way
(:meth:`MatrixTable.rows_from_owners` with ``data``), and pushes the
reverse way: every rank brings row ids and values, and each owner sums
every rank's values for its block into a block-shaped delta, through
one all_to_all (:meth:`MatrixTable.sum_at_owners`). One
:meth:`MatrixTable.owner_route` serves both directions on the same ids.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

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


class OwnerRoute(NamedTuple):
    """Where the ranks' row ids live on a sharded table
    (:meth:`MatrixTable.owner_route`): the largest count a rank brought
    (``width``), every rank's tag, and for each rank j the positions in
    its ids that this rank's block holds (``slots[j]``) and those ids as
    indices into the block (``local[j]``); ``owner`` is the owner's index
    of each of this rank's own ids."""

    width: int
    tags: List[int]
    slots: List[torch.Tensor]
    local: List[torch.Tensor]
    owner: torch.Tensor


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

    def _union_across_processes(self, ids: np.ndarray, vals: np.ndarray
                                ) -> Tuple[np.ndarray, np.ndarray]:
        """Every process's deduplicated (ids, vals) merged into the sorted
        union with float64-summed values, the same on every process (a
        collective: every process calls it, in the same order)."""
        from multiverso_tpu_torch.parallel.collectives import \
            process_allgather
        n = int(process_allgather(np.array([ids.size], np.int64)).max())
        if ids.size < n:
            pad = n - ids.size
            ids = np.concatenate(
                [ids, np.full(pad, self.scratch_row, ids.dtype)])
            vals = np.concatenate(
                [vals, np.zeros((pad, self.num_col), self.np_dtype)])
        flat_ids = process_allgather(ids).reshape(-1)
        flat_vals = process_allgather(vals).reshape(-1, self.num_col)
        keep = flat_ids != self.scratch_row
        uids, inv = np.unique(flat_ids[keep], return_inverse=True)
        acc = np.zeros((uids.size, self.num_col), np.float64)
        np.add.at(acc, inv.reshape(-1), flat_vals[keep].astype(np.float64))
        return uids, acc.astype(self.np_dtype)

    def add_rows_async(self, row_ids, values,
                       opt: Optional[AddOption] = None) -> int:
        """ref MatrixWorkerTable::AddAsync(row_ids, values): apply the
        updater to the touched rows on the device's stream; with more
        than one process, to the union of every process's rows (a
        collective). A sharded table applies the rows of its block."""
        self._mark_mutated()
        with monitor(f"table[{self.name}].add_rows"), self._dispatch_lock:
            uids, vals, _ = self._prep_ids(row_ids, values)
            if self._zoo.size() > 1:
                uids, vals = self._union_across_processes(uids, vals)
            if self._train_cache is not None:
                # the deduplicated, float64-summed and cast delta: exactly
                # what the updater adds on the device
                self._train_cache.on_push(uids, vals)
            lo, hi = self._rows
            if self._num_shards > 1:
                mine = (uids >= lo) & (uids < hi)
                uids, vals = uids[mine], vals[mine]
            local = uids - lo
            dev_ids = torch.from_numpy(local).to(self.device)
            if local.size:
                self._apply_rows(self.state, dev_ids,
                                 torch.from_numpy(vals).to(self.device), opt)
            # subclass hook (the sparse table's dirty bits), fed the rows
            # the add applied here: the union's, so rows only other
            # workers brought are marked too
            self._rows_applied(local, dev_ids)
            self._version_applied()
            return self._track(_Pending(self._event()))

    def _rows_applied(self, ids: np.ndarray, dev_ids: torch.Tensor) -> None:
        """Called under the dispatch lock with the deduplicated rows each
        row add applied, as indices into this rank's block (the global
        ids less the block's first row), on the host and on the table's
        device. Default: nothing."""

    def owner_route(self, ids: np.ndarray, tag: int = 0
                    ) -> Optional[OwnerRoute]:
        """Where every rank's row ids live, on a sharded table: a
        collective over the table axis in which every rank brings its
        global row ids (any count, none included) and an int ``tag`` (a
        worker id), and learns which of every rank's ids its block holds.
        Two all-gathers: each rank's count and tag, then the ids padded to
        the largest count. None when no rank brought an id. One route
        serves any number of :meth:`_exchange` and :meth:`sum_at_owners`
        calls on the same ids."""
        from multiverso_tpu_torch.parallel import collectives as coll
        mesh, axis, n = self._mesh, self._axis, self._num_shards
        dev = self.device
        k = int(ids.size)
        meta = coll.raw_all_gather(torch.tensor(
            [k, int(tag)], dtype=torch.int64, device=dev), mesh,
            axis).cpu().numpy().reshape(n, 2)
        width = int(meta[:, 0].max())
        if width == 0:
            return None
        pad = np.full(width, -1, np.int64)
        pad[:k] = ids
        asked = coll.raw_all_gather(torch.from_numpy(pad).to(dev), mesh,
                                    axis).reshape(n, width)
        lo, hi = self._rows
        held = (asked >= lo) & (asked < hi)
        slots = [held[j].nonzero().squeeze(1) for j in range(n)]
        return OwnerRoute(
            width, [int(t) for t in meta[:, 1]], slots,
            [asked[j, slots[j]] - lo for j in range(n)],
            torch.from_numpy(ids // (self._padded_rows // n)).to(dev))

    def _exchange(self, ids: np.ndarray, tag: int, answer,
                  tail: Tuple[int, ...], dtype: torch.dtype,
                  route: Optional[OwnerRoute] = None) -> torch.Tensor:
        """A collective over the table axis that asks the rows' owners:
        every rank brings its row ids (any count, none included) and an
        int ``tag`` (a worker id); each owner answers the ids of its block
        for every rank at once, ``answer(tags, local) -> outs``, where
        ``tags[j]`` is rank j's tag and ``local[j]`` the indices into the
        block of rank j's ids that it holds (a device tensor, maybe
        empty), and ``outs[j]`` one ``tail``-shaped answer per index. One
        all_to_all brings each rank its answers: ``(ids.size, *tail)`` on
        the table's device, in ``ids``' order. ``route``: these ids'
        :meth:`owner_route`, made here when not given. Never
        ``send``/``recv`` (gloo cannot send from CUDA memory, ROADMAP
        C.19)."""
        from multiverso_tpu_torch.parallel import collectives as coll
        n, dev = self._num_shards, self.device
        if route is None:
            route = self.owner_route(ids, tag)
        if route is None:
            return torch.empty((0,) + tail, dtype=dtype, device=dev)
        outs = answer(route.tags, route.local)
        send = torch.zeros((n, route.width) + tail, dtype=dtype, device=dev)
        for j in range(n):
            if route.slots[j].numel():
                send[j, route.slots[j]] = outs[j].to(dtype)
        recv = coll.raw_all_to_all(send, self._mesh, self._axis, 0,
                                   0).reshape((n, route.width) + tail)
        return recv[route.owner, torch.arange(ids.size, device=dev)]

    def rows_from_owners(self, uids: np.ndarray,
                         data: Optional[torch.Tensor] = None,
                         route: Optional[OwnerRoute] = None
                         ) -> torch.Tensor:
        """The rows ``uids`` (global ids, any count) on the table's
        device, read from ``data`` (this rank's block of a state, such as
        a functional step's ``state["data"]``; the table's own by
        default): a local gather, or on a sharded table an
        :meth:`_exchange` with their owners (a collective; ``route`` as
        there)."""
        data = self._data if data is None else data
        if self._num_shards == 1:
            return data.index_select(
                0, torch.from_numpy(uids).to(self.device))
        return self._exchange(
            uids, 0, lambda tags, local: [data.index_select(0, ids)
                                          for ids in local],
            tuple(self.shape[1:]), data.dtype, route)

    def sum_at_owners(self, ids: np.ndarray, values: torch.Tensor,
                      route: Optional[OwnerRoute] = None) -> torch.Tensor:
        """The reverse of :meth:`rows_from_owners`, on a sharded table: a
        collective over the table axis in which every rank brings global
        row ids (any count) and one row of ``values`` per id, and each
        owner receives every rank's values for the ids of its block,
        summed into a tensor of the block's shape (zero where no rank
        brought a row). One all_to_all carries the values; ``route`` as
        in :meth:`_exchange`. Each source rank's values are added in turn,
        in rank order, so where every rank brings each id at most once a
        row's sum is its ranks' values added in rank order: for two ranks
        the all-reduce's sum of two whole-table deltas, bit for bit."""
        from multiverso_tpu_torch.parallel import collectives as coll
        n, dev = self._num_shards, self.device
        tail = tuple(values.shape[1:])
        out = torch.zeros((self._rows[1] - self._rows[0],) + tail,
                          dtype=values.dtype, device=dev)
        if route is None:
            route = self.owner_route(ids)
        if route is None:
            return out
        send = torch.zeros((n, route.width) + tail, dtype=values.dtype,
                           device=dev)
        send[route.owner, torch.arange(ids.size, device=dev)] = values
        recv = coll.raw_all_to_all(send, self._mesh, self._axis, 0,
                                   0).reshape((n, route.width) + tail)
        for j in range(n):
            if route.slots[j].numel():
                out.index_add_(0, route.local[j], recv[j, route.slots[j]])
        return out

    def _agreed(self, ok: bool) -> bool:
        """``ok`` on every rank of the table axis (a collective when the
        table is sharded): the ranks of a collective row read take one
        path."""
        if self._num_shards == 1:
            return ok
        from multiverso_tpu_torch.parallel.collectives import raw_all_reduce
        miss = torch.tensor([0 if ok else 1], dtype=torch.int64,
                            device=self.device)
        return int(raw_all_reduce(miss, self._mesh, self._axis)) == 0

    def functional_add_rows(self, state: Dict[str, Any], ids: torch.Tensor,
                            vals: torch.Tensor,
                            opt: Optional[AddOption] = None
                            ) -> Dict[str, Any]:
        """Apply the updater to rows ``ids`` of ``state`` (``{"data",
        "ustate"}``, this rank's block of the table's padded layout, which
        ``ids`` index) with deltas ``vals`` (one row per id), all on the
        state's device: gather the rows and their
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
                # all or nothing (a partial hit refetches every row); on
                # a sharded table every rank of the axis must hit
                token, buf = tc.serve_full(uids)
                if self._agreed(buf is not None):
                    tc.count(uids.size, 0)
                    return self._track(_Pending(None, buf,
                                                lambda b: b[inv]))
                tc.count(0, uids.size)
            rows = self.rows_from_owners(uids)
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
        # on a sharded table the fallback, get_rows_async, is a
        # collective: every rank of the axis takes it or none does
        return tc.device_block_counted(
            row_ids, bucket,
            agree=self._agreed if self._num_shards > 1 else None)


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
