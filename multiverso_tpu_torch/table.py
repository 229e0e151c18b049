"""Table core: one device tensor with Add/Get semantics (port of
``multiverso_tpu/table.py``).

* storage     -> one padded tensor on the Zoo's device, plus the updater's
                 state tensors beside it.
* Add         -> the delta is copied to the device (padded) and the updater
                 applies it IN PLACE on the table's CUDA stream.
* Get         -> device -> host copy of ``data[:rows]``.
* AddAsync /
  GetAsync    -> every op returns a msg id. An add's id is backed by a CUDA
                 event recorded after the in-place update; a get snapshots
                 the data with a clone and starts a non-blocking copy into
                 pinned host memory. ``wait(id)`` blocks on the event.

Program order on one stream gives every Get the state after all previously
issued Adds, the BSP guarantee of the reference's SyncServer. On the CPU
every op completes before it returns.

More than one process (``Zoo.size() > 1``): the rows are sharded over the
Zoo mesh's table axis (``Zoo.shard_axis()``, the mesh's last axis), as
the JAX package's global array is (``P(axis)``): the rank at index i of
that axis holds rows ``[i*B, (i+1)*B)`` of the padded table, ``B =
padded_rows / num_shards``, and the same block of every updater-state
leaf whose trailing shape is the table's (Adam's step count is held
whole on every rank). The mesh's other axes replicate the blocks. A
world of one, or a table axis of one rank, keeps the whole table
(:attr:`sharding`). A whole-table Add is a collective: every process
calls it, in the same order, with its own worker's delta, and the delta
applied is the world's sum: one reduce-scatter where the table axis spans
the world (``collectives.process_reduce_scatter`` of a numpy delta,
``raw_reduce_scatter`` of a padded tensor), else a sum over the world
whose block each rank keeps. Each rank applies its block only. A tensor
delta of any shape is its rank's contribution: the port has no global
arrays, so none counts as already summed. A wire filter encodes the
world's sum, and each rank decodes it and applies its block. A
whole-table Get is an all-gather of the blocks over the table axis (the
JAX ``process_allgather(tiled=True)``), so every rank receives the whole
table; versions advance in lockstep, so the get cache stays exact. The
functional plane (``state``, ``functional_add``, ``adopt``) holds this
rank's block, the addressable shard of the JAX global array:
``functional_add`` takes the block's shape or the whole padded shape,
whose rows outside the block it ignores, and a caller that needs the
whole table gathers it (:meth:`unshard`). A caller that trains the whole
table in one call (LR's fused epoch) takes :meth:`whole_state`: the
gathered state for the call, of which each rank adopts its block at the
end; a caller that reads and adds rows by id (the WordEmbedding epochs,
the PS block device plane) trains its block through :class:`OwnedRows`,
the rows read from their owners. Every rank runs the call's steps on the
same inputs, which :meth:`require_same_inputs` checks. ``store`` gathers
the table (a collective), ``load`` keeps the block. Coalescing and the
write-triggered prefetch stay off: each add's collective runs on the
caller's thread, in the caller's order.

Around that core, as in the JAX package:

* **version stamp and get cache** (flag ``table_get_cache``): every
  mutation bumps :attr:`Table.version`, and a whole-table Get at an
  unchanged version returns a copy of the cached host array instead of
  copying the table off the device again;
* **write-triggered prefetch** (flag ``table_get_prefetch``): once a
  Get-after-Add pattern shows, each whole-table add also clones the
  updated data on the table's stream and starts its copy into pinned host
  memory, which the next Get at that version takes; two adds with no Get
  between disarm it, with an exponential backoff;
* **host-add coalescing**: ``add_async`` of a numpy delta on a table
  whose updater is a signed accumulate (``STATELESS_LINEAR``) queues the
  delta; a background applier merges everything queued into one float64
  sum, cast once, and applies it as one add. Every read flushes the queue
  first;
* **wire filters** (``wire_filter``: ``"bf16"``, ``"1bit"``, ``"topk"``):
  whole-table adds of host deltas are encoded on the host
  (``ops/wire_codec``), cross to the device compressed, and are decoded
  there before the updater applies them; 1bit and topk keep an
  error-feedback residual on the host. Get then reads bf16. Row ops are
  unaffected;
* **checkpoints**: ``store``/``load`` in the JAX package's format, and
  ``store_snapshot`` (pinned host copies on the table's stream, written
  later) for an asynchronous save.

The functional plane (``state``, ``functional_add``, ``adopt``) hands the
live tensors to code that trains them in place (the fused WordEmbedding
epoch, the PS block path's device plane). Every path that writes the live
tensors bumps the version afterwards and clears the hot-row train cache,
so a cached Get never serves the state from before the write.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.ops import wire_codec
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor
from multiverso_tpu_torch.zoo import Zoo

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence]

config.define_bool(
    "table_get_cache", True,
    "version-stamped host cache for whole-table Get: each applied Add "
    "bumps a table version, and a Get at an unchanged version returns "
    "a copy of the cached host array instead of copying the table off "
    "the device again")
config.define_bool(
    "table_get_prefetch", True,
    "write-triggered snapshot prefetch for whole-table Get: once a "
    "Get-after-Add pattern is observed, each whole-table Add also clones "
    "the updated data on the table's stream and starts its copy into "
    "pinned host memory at once, so the next Get at that version waits "
    "only for the rest of the transfer. Bit-exact (the same bytes a "
    "blocking Get would read at that version; a version mismatch "
    "discards it). Costs one extra table-sized device buffer and one "
    "transfer per prefetching Add, so it self-disarms when two Adds pass "
    "with no Get consuming the snapshot")


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


class TableSharding(NamedTuple):
    """Where a table's rows live (the JAX ``Table.sharding``'s
    counterpart): the Zoo's ``mesh``, its table ``axis``, the number of
    blocks ``num_shards`` (the axis's size) and this rank's padded row
    range ``rows = (lo, hi)``."""

    mesh: Any
    axis: str
    num_shards: int
    rows: Tuple[int, int]


class OwnedRows:
    """This rank's ``block`` of ``table``'s padded rows ``[lo, hi)``, read
    and trained by row id as code reads and trains the whole padded table
    (``index_select(0, ids)``, ``index_add_(0, ids, src)``): the
    counterpart of XLA's partitioned gather and scatter on a ``P(axis)``
    array. No rank holds the whole table.

    * ``index_select``: the rows ``ids`` on every rank of the table axis.
      Each rank reads the ids its block holds and puts -0.0 in the others'
      places (``torch.where``, so a NaN or inf elsewhere cannot leak), then
      one all-reduce sum over the axis (a collective: every rank of the
      axis calls it with the same ids, in one order). An owner's value
      plus -0.0s is that value bit for bit, signed zeros included.
    * ``index_add_``: ``index_add_`` into the block of the ids it holds,
      shifted by ``lo``, in their order, so each row sums the same deltas
      in the same order as the whole table's ``index_add_``; returns the
      view. No collective.

    On a table that is not sharded both are the block's own ops."""

    def __init__(self, table: "Table", block: torch.Tensor):
        self.block = block
        self._mesh, self._axis, self._n, (self._lo, self._hi) = \
            table.sharding

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    @property
    def device(self) -> torch.device:
        return self.block.device

    def _mine(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids >= self._lo) & (ids < self._hi)

    def index_select(self, dim: int, ids: torch.Tensor) -> torch.Tensor:
        if dim != 0:
            raise ValueError("OwnedRows reads rows (dim 0)")
        if self._n == 1:
            return self.block.index_select(0, ids)
        from multiverso_tpu_torch.parallel.collectives import raw_all_reduce
        rows = self.block.index_select(
            0, (ids - self._lo).clamp(0, self._hi - self._lo - 1))
        rows = torch.where(self._mine(ids).unsqueeze(1), rows,
                           rows.new_full((), -0.0))
        return raw_all_reduce(rows, self._mesh, self._axis)

    def index_add_(self, dim: int, ids: torch.Tensor,
                   src: torch.Tensor) -> "OwnedRows":
        if dim != 0:
            raise ValueError("OwnedRows adds rows (dim 0)")
        if self._n == 1:
            self.block.index_add_(0, ids, src)
        else:
            mine = self._mine(ids).nonzero().squeeze(1)
            self.block.index_add_(0, ids[mine] - self._lo, src[mine])
        return self


class _Pending:
    """One in-flight op: ``finalize`` is None for adds."""

    __slots__ = ("event", "host", "finalize")

    def __init__(self, event: Optional[torch.cuda.Event],
                 host: Any = None,
                 finalize: Optional[Callable[[Any], Any]] = None):
        self.event, self.host, self.finalize = event, host, finalize

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def host_ready(self) -> Any:
        """The host side, once the device work behind it has ended."""
        if self.event is not None:
            self.event.synchronize()
        return self.host

    def result(self) -> Any:
        host = self.host_ready()
        return self.finalize(host) if self.finalize is not None else None


class _HostAdd:
    """One queued host add awaiting the coalescing applier."""

    __slots__ = ("arr", "opt", "applied", "error", "event")
    finalize = None   # an add, as far as read() is concerned

    def __init__(self, arr: np.ndarray, opt: AddOption):
        self.arr, self.opt = arr, opt
        self.applied = threading.Event()
        self.error: Optional[Exception] = None
        self.event: Optional[torch.cuda.Event] = None

    def done(self) -> bool:
        """Sweepable: applied, and its CUDA event (if any) has passed."""
        return self.applied.is_set() and (
            self.error is not None or self.event is None
            or self.event.query())

    def result(self) -> None:
        self.applied.wait()
        if self.error is not None:
            raise self.error
        if self.event is not None:
            self.event.synchronize()


class Table:
    """Base table on one device. Subclasses fix dimensionality."""

    def __init__(self, shape: Tuple[int, ...], dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "table",
                 init: Optional[ArrayLike] = None,
                 seed: Optional[int] = None,
                 init_scale: float = 0.0,
                 wire_filter: str = "none"):
        """``wire_filter`` compresses the host -> device wire of whole-table
        Add and the device -> host wire of Get (the reference compressed
        its MPI wire the same way, quantization_util.h SparseFilter):
        "bf16" halves both directions; "1bit" sends sign bits and
        per-block scales with error feedback (1-bit SGD) on Add and bf16
        on Get; "topk" sends the ~3% largest-|x| entries of the delta
        exactly with error feedback on Add and bf16 on Get. Encoding runs
        on the host (``ops/wire_codec``), so the f32 payload never crosses
        to the card just to be compressed; decoding runs on the card,
        right before the updater apply. Row ops are unaffected."""
        zoo = Zoo.get()
        self._zoo = zoo
        self.name = name
        self.np_dtype, self.dtype = _dtypes(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.device = zoo.device()
        mesh = zoo.mesh()
        self._mesh = mesh
        self._axis = zoo.shard_axis()
        self._num_shards = int(mesh.shape[self._axis])

        # at least one spare row, as in the JAX package, so padded shapes
        # (and a seeded init's draws) match its layout; the padded rows
        # split evenly over the table axis, and this rank keeps its block
        self._padded_rows = _ceil_to(self.shape[0] + 1, self._num_shards)
        self._padded_shape = (self._padded_rows,) + self.shape[1:]
        block = self._padded_rows // self._num_shards
        lo = (mesh.index(self._axis) if self._num_shards > 1 else 0) * block
        self._rows = (lo, lo + block)
        self._local_shape = (block,) + self.shape[1:]

        if updater is None:
            updater = config.get_flag("updater_type")
        if isinstance(updater, str):
            updater = updaters_lib.get_updater(
                updater, num_workers=zoo.num_workers(), dtype=self.np_dtype)
        self.updater = updater

        self._data = self._build_init(init, seed, init_scale)
        # the updater state of the block: its row-shaped leaves take the
        # block's shape, the others (Adam's step count) are whole
        self._ustate = updater.init_state(self._local_shape, self.dtype,
                                          self.device)
        # every op of the table runs on this stream, whichever thread
        # issues it (the coalescing applier has a thread of its own)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.table_id = zoo.register_table(self)

        if wire_filter not in ("none", "bf16", "1bit", "topk"):
            raise ValueError(f"unknown wire_filter {wire_filter!r}")
        self._wire = wire_filter
        self._topk_k = wire_codec.default_topk(int(np.prod(self.shape)))
        # the 1bit/topk error-feedback residual: host state of the table,
        # made at the first compressed add
        self._wire_residual: Optional[torch.Tensor] = None
        if wire_filter != "none":
            # a filter trades encode time on the host for wire bytes; on a
            # fast link that trade loses: warn while the user can still
            # change it
            from multiverso_tpu_torch.utils import linkprobe
            ms = linkprobe.device_link_ms(self.device)
            if ms < linkprobe.FAST_LINK_MS:
                log.error(
                    "table[%s]: wire_filter=%r but the host<->device link "
                    "is fast (1 MB upload ~%.1f ms): the filter's encode "
                    "cost will likely exceed its wire savings; use "
                    "wire_filter='none' unless this process feeds a slow "
                    "(remote) device", name, wire_filter, ms)

        self._pending: Dict[int, Any] = {}
        self._next_msg_id = 0
        self._lock = threading.Lock()
        # serializes op dispatch: an add must not mutate the data while
        # another thread is snapshotting it
        self._dispatch_lock = threading.RLock()
        # version-stamped get cache (flag table_get_cache): every applied
        # mutation bumps _version; a whole-table Get at an unchanged
        # version copies the cached host array
        self._version = 0
        self._get_cache: Optional[Tuple[int, np.ndarray]] = None
        # write-triggered prefetch (flag table_get_prefetch): (version,
        # pending copy) dispatched by the LAST whole-table add, consumed
        # by the next Get at that version. _prefetch_armed latches on the
        # first Get and drops when a prefetch goes unconsumed; each wasted
        # snapshot doubles how many arming chances are skipped (capped),
        # and one consumed prefetch resets it. All under the dispatch lock
        self._get_prefetch: Optional[Tuple[int, _Pending]] = None
        self._prefetch_armed = False
        self._prefetch_backoff = 0
        self._prefetch_skip = 0
        # host-add coalescing: async numpy adds queue here, and a
        # background applier merges everything queued into one add
        self._addq: list = []
        self._addq_cv = threading.Condition()
        self._addq_inflight = 0
        self._add_applier: Optional[threading.Thread] = None
        # hot-row training cache (serving/hotcache): MatrixTable makes it
        # behind the train_cache_rows flag; the base ops only clear it
        # after coarse mutations
        self._train_cache = None
        # memory ledger (telemetry/memstats.py): pull-only gauges, a weak
        # reference
        _memstats.register(f"table[{name}]", self)

    def memory_stats(self) -> Dict[str, Any]:
        """Byte gauges: the cached Get's host copy and the prefetch's
        pinned host buffer (the JAX package's two), plus the table's own
        device tensor (``table_bytes``, padded rows included) and its
        updater state (``ustate_bytes``): this rank's block of a sharded
        table, the bytes resident here. Lock-free reads of the
        attribute references: the ledger tolerates a one-sample-stale
        figure."""
        cache = self._get_cache
        pf = self._get_prefetch
        host = pf[1].host if pf is not None else None
        data = self._data
        return {
            "cache_bytes": int(cache[1].nbytes) if cache is not None else 0,
            "prefetch_bytes": (host.numel() * host.element_size()
                               if host is not None else 0),
            "table_bytes": int(data.numel() * data.element_size()),
            "ustate_bytes": int(sum(
                v.numel() * v.element_size()
                for v in list(self._ustate.values())
                if isinstance(v, torch.Tensor))),
        }

    def _build_init(self, init, seed, init_scale) -> torch.Tensor:
        """This rank's block of the initial padded table: ``init``'s rows,
        or a seeded draw of the WHOLE padded table (the same numbers as
        the JAX package for the same seed, whatever the layout), or
        zeros."""
        lo, hi = self._rows
        data = torch.zeros(self._local_shape, dtype=self.dtype,
                           device=self.device)
        if init is not None:
            arr = np.asarray(init, dtype=self.np_dtype)
            if arr.shape != self.shape:
                raise ValueError(
                    f"init shape {arr.shape} != table shape {self.shape}")
            mine = arr[lo:min(hi, self.shape[0])]
            if mine.shape[0]:
                data[: mine.shape[0]].copy_(torch.from_numpy(
                    np.ascontiguousarray(mine)))
        elif seed is not None and init_scale != 0.0:
            # Uniform(-scale, scale) from numpy, the same numbers as the
            # JAX package for the same seed
            rng = np.random.default_rng(seed)
            out = rng.uniform(-init_scale, init_scale,
                              self._padded_shape).astype(self.np_dtype)
            out[self.shape[0]:] = 0
            data.copy_(torch.from_numpy(out[lo:hi]))
        return data

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return self._padded_shape

    @property
    def sharding(self) -> TableSharding:
        """The mesh, the table axis, the number of blocks and this rank's
        padded row range (the JAX ``Table.sharding``: ``NamedSharding(
        mesh, P(axis))``)."""
        return TableSharding(self._mesh, self._axis, self._num_shards,
                             self._rows)

    def raw(self) -> torch.Tensor:
        """The live data tensor, this rank's block of the padded table
        (reads see every prior async add)."""
        self._flush_host_adds()
        return self._data

    def _state_row_axis(self, leaf) -> Optional[int]:
        """Axis of an updater-state leaf that is the table's row axis (its
        trailing shape is the block's), or None (a leaf shared by all
        rows, such as Adam's step count)."""
        shape = tuple(leaf.shape)
        nd, pd = len(shape), len(self._local_shape)
        if nd >= pd and shape[nd - pd:] == self._local_shape:
            return nd - pd
        return None

    def _own(self, delta: torch.Tensor) -> torch.Tensor:
        """A delta of the block's shape as it is; one of the whole padded
        shape cut to this rank's block."""
        if self._num_shards > 1 and delta.shape[0] == self._padded_rows:
            return delta[self._rows[0]:self._rows[1]]
        return delta

    def unshard(self, block: torch.Tensor) -> torch.Tensor:
        """The whole padded tensor of which ``block`` is this rank's block
        (``state["data"]`` or a row-shaped leaf): an all-gather over the
        table axis (the JAX ``in_specs=P()`` of a sharded table), a
        collective; the tensor itself when the table is not sharded."""
        if self._num_shards == 1:
            return block
        from multiverso_tpu_torch.parallel.collectives import raw_all_gather
        return raw_all_gather(block, self._mesh, self._axis)

    @contextlib.contextmanager
    def whole_state(self) -> Iterator[Dict[str, Any]]:
        """The whole padded state ``{"data", "ustate"}`` for a call that
        trains the whole table (LR's fused epoch), as the JAX
        package's ``state`` is the global array. On a table that is not
        sharded it is the live :attr:`state`. On a table axis > 1 it is
        an all-gather of the data and of each row-shaped updater-state
        leaf over the axis (a collective: every rank of the axis enters,
        in one order), at the world's padding: ``padded_shape``, whose
        real rows and scratch row keep their indices. The caller trains
        it in place (:meth:`functional_add` applies a whole delta to it
        whole) or puts new tensors under its keys. On a normal exit the
        table adopts this rank's block of each leaf; a leaf shared by all
        rows (Adam's step count) is adopted whole, the same on every rank
        that ran the same steps. On an exception nothing is adopted."""
        state = self.state
        if self._num_shards == 1:
            yield state
            self.adopt(state)
            return
        from multiverso_tpu_torch.parallel.collectives import raw_all_gather
        axes = {k: self._state_row_axis(v)
                for k, v in state["ustate"].items()}
        whole = {"data": self.unshard(state["data"]),
                 "ustate": {k: v if axes[k] is None else raw_all_gather(
                     v, self._mesh, self._axis, axes[k])
                            for k, v in state["ustate"].items()}}
        yield whole
        lo, hi = self._rows
        # clones: the block must not keep the whole tensor's memory alive
        self.adopt({"data": whole["data"][lo:hi].clone(),
                    "ustate": {k: v if axes[k] is None else
                               v.narrow(axes[k], lo, hi - lo).clone()
                               for k, v in whole["ustate"].items()}})

    def require_same_inputs(self, what: str, *arrays) -> None:
        """On a table axis > 1, raise ``ValueError`` on every rank of the
        axis unless every rank passed the same ``arrays`` (numpy arrays or
        tensors, compared by dtype, shape and bytes): one all-gather of an
        8-byte digest a rank, a collective. The JAX package's inputs are
        global arrays, the same on every device; a rank that brought
        other data would train another run. Nothing on a table that is
        not sharded."""
        if self._num_shards == 1:
            return
        from multiverso_tpu_torch.parallel.collectives import \
            process_all_gather
        h = hashlib.sha1()
        for a in arrays:
            if isinstance(a, torch.Tensor):
                t = a.detach().contiguous().cpu()
                h.update(f"{t.dtype}{tuple(t.shape)}".encode())
                h.update(t.reshape(-1).view(torch.uint8).numpy())
            else:
                arr = np.ascontiguousarray(a)
                h.update(f"{arr.dtype}{arr.shape}".encode())
                h.update(memoryview(arr.reshape(-1)).cast("B"))
        mine = np.frombuffer(h.digest()[:8], np.int64).copy()
        every = process_all_gather(mine, self._mesh, self._axis)
        if np.any(every != mine[0]):
            raise ValueError(
                f"{what}: the ranks of the {self._axis!r} axis passed "
                f"different inputs (digests {every.tolist()}); every rank "
                "of a sharded table trains the same arrays, as the JAX "
                "package's global arrays are")

    # ------------------------------------------------------------------ #
    # mutation bookkeeping (get-cache version)
    # ------------------------------------------------------------------ #
    def _mark_mutated(self) -> None:
        """Entry of every mutation path: mark the table for the Zoo's
        barrier fence, and bump the version early, so a ``version`` poll
        already sees a queued but unapplied add. This bump alone does not
        make the cache correct (it happens outside the dispatch lock, so a
        concurrent Get could stamp old data with the new version);
        :meth:`_version_applied`, at the point the mutation is issued,
        does."""
        self._zoo.mark_dirty(self.table_id)
        self._version += 1

    def _version_applied(self) -> None:
        """Apply-side version bump, at every site that writes ``_data`` or
        ``_ustate``, under the dispatch lock or after the assignment: any
        mutation issued after a Get's snapshot moves the version past that
        Get's stamp."""
        self._version += 1

    def _wrote_in_place(self) -> None:
        """After a write of the live tensors that bypassed add/adopt (the
        functional plane on the live state): bump the version and clear
        the train cache, in that order (a clear logged before the write is
        visible would let a racing get refill old rows under a current
        fill token)."""
        self._version_applied()
        if self._train_cache is not None:
            self._train_cache.clear()

    @property
    def version(self) -> int:
        """Monotonic mutation counter (the get cache's stamp)."""
        return self._version

    def _cached_get(self, into: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
        """A copy of the cached host array when the version is unchanged,
        else None (straight into ``into`` when given). Caller holds the
        dispatch lock. The cache keeps a private copy: callers may change
        what get() hands them."""
        if not config.get_flag("table_get_cache"):
            return None
        cache = self._get_cache
        if cache is None or cache[0] != self._version:
            return None
        Dashboard.get(f"table[{self.name}].get.cached").incr()
        if into is not None:
            np.copyto(into.reshape(self.shape), cache[1])
            return into
        return cache[1].copy()

    def _store_get_cache(self, version: int, host: np.ndarray) -> None:
        """Caller holds the dispatch lock. An older version than the one
        cached (a slow get_async finalize after a newer get) is dropped."""
        if not config.get_flag("table_get_cache"):
            return
        cache = self._get_cache
        if cache is not None and cache[0] > version:
            return
        self._get_cache = (version, host.copy())

    def _snapshot(self) -> _Pending:
        """A clone of the logical rows (bf16 with a wire filter) on the
        table's stream and its copy into pinned host memory, started now;
        the pending's event marks its end. On the CPU the clone is the
        host tensor. The clone's memory may go back to the allocator at
        once: it is reused only on this stream, after the copy."""
        rows = self._data[: self.shape[0]]
        snap = (wire_codec.bf16_cast(rows) if self._wire != "none"
                else rows.clone())
        if self.device.type != "cuda":
            return _Pending(None, snap)
        host = torch.empty(snap.shape, dtype=snap.dtype, pin_memory=True)
        host.copy_(snap, non_blocking=True)
        return _Pending(self._event(), host)

    def _host_array(self, host: torch.Tensor) -> np.ndarray:
        """A snapshot's host tensor as the table's numpy array."""
        if host.dtype != self.dtype:
            host = host.to(self.dtype)
        return host.numpy()

    def _maybe_prefetch(self) -> None:
        """Write-triggered prefetch (caller holds the dispatch lock, right
        after a whole-table update was issued): snapshot the updated data
        and start its copy to the host now. Armed only while a
        Get-after-Add pattern holds: an unconsumed prefetch (two adds, no
        get between) disarms it, so add-only workloads pay nothing."""
        if self._get_prefetch is not None:
            # the previous prefetch was never consumed: drop it, disarm,
            # and back off exponentially (a Get re-arms, but an
            # add,add,get cadence must not buy one wasted table-sized
            # transfer per cycle forever)
            self._prefetch_armed = False
            self._get_prefetch = None
            self._prefetch_backoff = min(self._prefetch_backoff * 2 + 1, 16)
            self._prefetch_skip = self._prefetch_backoff
            return
        if (not self._prefetch_armed
                or not config.get_flag("table_get_prefetch")
                or self._zoo.size() > 1):
            return
        if self._prefetch_skip > 0:
            self._prefetch_skip -= 1
            return
        self._get_prefetch = (self._version, self._snapshot())

    def _take_prefetch(self) -> Optional[_Pending]:
        """The in-flight prefetch for the CURRENT version, or None (caller
        holds the dispatch lock). A stale one (another mutation landed
        after it) is dropped."""
        self._prefetch_armed = True
        pf = self._get_prefetch
        if pf is None:
            return None
        self._get_prefetch = None
        if pf[0] != self._version:
            return None
        self._prefetch_backoff = 0   # consumed: the pattern is real
        Dashboard.get(f"table[{self.name}].get.prefetched").incr()
        return pf[1]

    # ------------------------------------------------------------------ #
    # functional plane (ref multiverso_tpu/table.py state/adopt)
    # ------------------------------------------------------------------ #
    @property
    def state(self) -> Dict[str, Any]:
        """The live table state ``{"data", "ustate"}``: the data tensor
        (this rank's block of the padded table) and the updater's state
        tensors, not copies. A caller that writes them in place commits
        with :meth:`adopt` or through :meth:`functional_add` on this
        state."""
        self._flush_host_adds()
        return {"data": self._data, "ustate": self._ustate}

    def functional_add(self, state: Dict[str, Any], delta: torch.Tensor,
                       opt: Optional[AddOption] = None) -> Dict[str, Any]:
        """Apply the updater to ``state`` with ``delta``. On this rank's
        block (:attr:`state`) the delta has the block's shape, or the
        whole padded shape (:meth:`pad_delta`), whose rows outside the
        block are ignored; on a whole state (:meth:`whole_state`) it has
        the whole padded shape and applies whole. The JAX function
        returns new arrays; this one updates ``state``'s tensors in place
        and returns ``state``. On the table's live state it is a mutation
        of the table: the version bumps and the train cache clears."""
        opt = opt or AddOption()
        live = state["data"] is self._data
        if live:
            self._mark_mutated()
        if delta.shape[0] != state["data"].shape[0]:
            delta = self._own(delta)
        self.updater.apply(state["data"], state["ustate"], delta, opt)
        if live:
            self._wrote_in_place()
        return state

    def pad_delta(self, delta: torch.Tensor) -> torch.Tensor:
        """A logical-shape delta padded with zero rows to the table's
        padded shape."""
        pad = self._padded_rows - self.shape[0]
        if pad == 0:
            return delta
        return torch.cat([delta, delta.new_zeros((pad,) + self.shape[1:])])

    def adopt(self, state: Dict[str, Any]) -> None:
        """Commit a table state advanced outside the table (the end of an
        in-place training loop). The data keeps the block's shape, the
        table's dtype and device."""
        data = state["data"]
        if (tuple(data.shape) != self._local_shape
                or data.dtype != self.dtype or data.device != self.device):
            raise ValueError(
                f"adopt: data {tuple(data.shape)} {data.dtype} {data.device}"
                f" does not match the table's {self._local_shape} "
                f"{self.dtype} {self.device}")
        self._mark_mutated()
        self._flush_host_adds()   # a late-applying add must not overwrite
        with self._dispatch_lock:
            self._data = data
            self._ustate = state["ustate"]
            self._wrote_in_place()

    # ------------------------------------------------------------------ #
    # msg-id bookkeeping (ref src/table.cpp:27-97)
    # ------------------------------------------------------------------ #
    def _event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _track(self, op) -> int:
        with self._lock:
            # sweep completed fire-and-forget adds; a swept id behaves like
            # an already-waited one (wait returns None)
            done = [mid for mid, p in self._pending.items()
                    if p.finalize is None and p.done()]
            for mid in done:
                p = self._pending.pop(mid)
                if isinstance(p, _HostAdd) and p.error is not None:
                    log.error("table[%s]: fire-and-forget add %d failed: "
                              "%s", self.name, mid, p.error)
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
        return op.result()

    # ------------------------------------------------------------------ #
    # whole-table ops
    # ------------------------------------------------------------------ #
    def _host_delta(self, delta: ArrayLike) -> np.ndarray:
        """A numpy delta of the table's logical shape and dtype, summed
        over the processes when there are several (every process calls
        this, in the same order)."""
        arr = np.asarray(delta, dtype=self.np_dtype).reshape(self.shape)
        if self._zoo.size() > 1:
            from multiverso_tpu_torch.parallel.collectives import \
                process_sum
            arr = process_sum(arr)
        return arr

    def _axis_spans_world(self) -> bool:
        return self._num_shards == self._zoo.size()

    def _device_delta(self, delta: ArrayLike) -> torch.Tensor:
        """This rank's block of the delta summed over the processes, on
        the table's device (see the module docstring)."""
        from multiverso_tpu_torch.parallel import collectives as coll
        lo, hi = self._rows
        if isinstance(delta, torch.Tensor):
            if tuple(delta.shape) == self._padded_shape:
                padded = delta.to(self.device, self.dtype)
            else:
                padded = torch.zeros(self._padded_shape, dtype=self.dtype,
                                     device=self.device)
                padded[: self.shape[0]].copy_(delta.reshape(self.shape))
            if self._num_shards > 1 and self._axis_spans_world():
                return coll.raw_reduce_scatter(padded, self._mesh,
                                               self._axis)
            if self._zoo.size() > 1:
                padded = coll.process_sum_tensor(padded)
            return self._own(padded)
        arr = np.asarray(delta, dtype=self.np_dtype).reshape(self.shape)
        if self._num_shards > 1 and self._axis_spans_world():
            padded = np.zeros(self._padded_shape, self.np_dtype)
            padded[: self.shape[0]] = arr
            block = coll.process_reduce_scatter(padded, self._mesh,
                                                self._axis)
            return torch.from_numpy(block).to(self.device)
        arr = self._host_delta(arr)
        out = torch.zeros(self._local_shape, dtype=self.dtype,
                          device=self.device)
        mine = arr[lo:min(hi, self.shape[0])]
        if mine.shape[0]:
            out[: mine.shape[0]].copy_(torch.from_numpy(
                np.ascontiguousarray(mine)))
        return out

    def _apply_full(self, delta: torch.Tensor,
                    opt: AddOption) -> Optional[torch.cuda.Event]:
        """The updater over this rank's block (caller holds the dispatch
        lock; ``delta`` the block's shape or the whole padded shape);
        returns the add's event, recorded before the prefetch so a wait on
        the add does not wait for the prefetch's copy."""
        self.updater.apply(self._data, self._ustate, self._own(delta), opt)
        self._version_applied()
        ev = self._event()
        self._maybe_prefetch()
        return ev

    def _coalescible(self, delta, opt) -> bool:
        """Async host adds coalesce where the merge is exact: a numpy
        delta (a tensor applies in order: it may already be on the card),
        an updater that is a signed accumulate with no state (a sum of
        deltas equals the sequence of adds, and opt is never read), one
        process. Wire-filtered tables coalesce too: the applier encodes in
        order, and under a linear updater the error-feedback codecs do
        not care whether N deltas are encoded one by one or as their sum.
        More than one process: never (each add's collective must run on
        the caller's thread, in its order)."""
        return (self._zoo.size() == 1
                and not isinstance(delta, torch.Tensor)
                and type(self.updater) in updaters_lib.STATELESS_LINEAR)

    _WIRE_BLOCK = 1024      # the 1bit filter's block (OneBitsFilter's)
    _ADDQ_CAP = 16          # backpressure: each entry is a full host copy
    _APPLIER_IDLE_S = 5.0   # an idle applier thread exits

    def _enqueue_host_add(self, delta: ArrayLike, opt: AddOption) -> int:
        entry = _HostAdd(
            np.array(delta, dtype=self.np_dtype).reshape(self.shape), opt)
        with self._addq_cv:
            while len(self._addq) >= self._ADDQ_CAP:
                self._addq_cv.wait()
            self._addq.append(entry)
            self._addq_inflight += 1
            if self._add_applier is None:
                self._add_applier = threading.Thread(
                    target=self._add_applier_loop,
                    name=f"mv-add-{self.name}", daemon=True)
                self._add_applier.start()
            self._addq_cv.notify_all()
        return self._track(entry)

    def _apply_host_batch(self, batch) -> None:
        """Merge, upload and apply one drained batch (caller holds the
        dispatch lock)."""
        try:
            if len(batch) == 1:
                acc = batch[0].arr
            else:   # float64 accumulate, cast once
                acc = np.zeros(self.shape, np.float64)
                for e in batch:
                    acc += e.arr
                acc = acc.astype(self.np_dtype)
            with (torch.cuda.stream(self._stream)
                  if self._stream is not None else contextlib.nullcontext()):
                if self._wire != "none":
                    # one encode and one small transfer for the batch
                    ev = self._dispatch_wire_add(acc, batch[0].opt)
                else:
                    ev = self._apply_full(self._device_delta(acc),
                                          batch[0].opt)
            for e in batch:
                e.event = ev
            if self._train_cache is not None:
                # the delta is visible only now (add_async's clear ran at
                # enqueue time, before the apply): a get that won the
                # dispatch lock ahead of this apply filled pre-add rows
                # under a then-current token; drop them
                self._train_cache.clear()
        except Exception as err:   # pragma: no cover - device failure
            for e in batch:
                e.error = err
        finally:
            with self._addq_cv:
                for e in batch:
                    e.applied.set()
                self._addq_inflight -= len(batch)
                self._addq_cv.notify_all()

    def _add_applier_loop(self) -> None:
        while True:
            with self._addq_cv:
                while not self._addq:
                    if (not self._addq_cv.wait(self._APPLIER_IDLE_S)
                            and not self._addq):
                        # idle exit: a parked thread would pin the table
                        self._add_applier = None
                        return
            # dispatch lock FIRST, pop second: entries are only ever taken
            # by a thread that owns the lock, so a lock-holding flusher
            # always finds them still queued and drains them itself
            with self._dispatch_lock:
                with self._addq_cv:
                    batch, self._addq = self._addq, []
                    if batch:
                        self._addq_cv.notify_all()   # free throttled adds
                if batch:
                    self._apply_host_batch(batch)

    def _flush_host_adds(self) -> None:
        """Reads must see every prior async add: drain the queue here.
        Safe whether or not the caller holds the dispatch lock (it is
        reentrant). Invariant: entries are only popped by a thread holding
        the dispatch lock, and the inflight count drops before that hold
        ends, so for a lock holder inflight > 0 means the entries are
        still queued and it can drain them itself."""
        while self._addq_inflight > 0:
            with self._dispatch_lock:
                with self._addq_cv:
                    batch, self._addq = self._addq, []
                    if batch:
                        self._addq_cv.notify_all()
                if batch:
                    self._apply_host_batch(batch)
                    continue
            # empty queue but inflight > 0: another thread is mid-apply;
            # wait for it OUTSIDE the dispatch lock
            with self._addq_cv:
                while self._addq_inflight > 0 and not self._addq:
                    self._addq_cv.wait()

    def add_async(self, delta: ArrayLike,
                  opt: Optional[AddOption] = None) -> int:
        """ref WorkerTable::AddAsync: apply the update on the table's
        stream, return a msg id. Numpy deltas of a stateless linear
        updater ride the coalescing queue; everything else applies here,
        under the dispatch lock."""
        opt = opt or AddOption()
        self._mark_mutated()
        try:
            with monitor(f"table[{self.name}].add"):
                if self._coalescible(delta, opt):
                    return self._enqueue_host_add(delta, opt)
                with self._dispatch_lock:
                    if (self._wire != "none"
                            and not isinstance(delta, torch.Tensor)):
                        # the world's sum is encoded, as in the JAX package
                        return self._track(_Pending(self._dispatch_wire_add(
                            self._host_delta(delta), opt)))
                    ev = self._apply_full(self._device_delta(delta), opt)
            return self._track(_Pending(ev))
        finally:
            if self._train_cache is not None:
                # whole-table delta: drop everything, AFTER the delta is
                # queued or applied (every return path above)
                self._train_cache.clear()

    def add(self, delta: ArrayLike, opt: Optional[AddOption] = None) -> None:
        """ref WorkerTable::Add: blocking add (Wait(AddAsync(...)))."""
        self.wait(self.add_async(delta, opt))

    # ------------------------------------------------------------------ #
    # wire-compressed adds (ref quantization_util.h filters, applied to
    # the host -> device wire)
    # ------------------------------------------------------------------ #
    def _pad_flat_delta(self, flat: torch.Tensor) -> torch.Tensor:
        """Raveled logical-size delta -> padded table shape, on the
        device."""
        n = int(np.prod(self.shape))
        out = torch.zeros(self._padded_shape, dtype=self.dtype,
                          device=self.device)
        out.view(-1)[:n] = flat.to(self.dtype)
        return out

    def _encode_residual(self) -> torch.Tensor:
        """The host error-feedback residual (zeros at first)."""
        if self._wire_residual is None:
            self._wire_residual = torch.zeros(int(np.prod(self.shape)),
                                              dtype=torch.float32)
        return self._wire_residual

    def _dispatch_wire_add(self, arr: np.ndarray,
                           opt: AddOption) -> Optional[torch.cuda.Event]:
        """Encode ``arr`` on the host, send only the payload to the device,
        decode there and apply (caller holds the dispatch lock: the
        residual is table state). Returns the add's event."""
        src = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        if self._wire == "bf16":
            payload = wire_codec.bf16_cast(src).to(self.device)
            delta = self._pad_flat_delta(payload.reshape(-1))
        elif self._wire == "1bit":
            bits, scales, self._wire_residual = wire_codec.onebit_encode(
                src, self._encode_residual(), block=self._WIRE_BLOCK)
            delta = self._pad_flat_delta(wire_codec.onebit_decode(
                bits.to(self.device), scales.to(self.device),
                n=src.numel(), block=self._WIRE_BLOCK))
        else:  # topk
            idx, vals, self._wire_residual = wire_codec.topk_encode(
                src, self._encode_residual(), k=self._topk_k)
            delta = self._pad_flat_delta(wire_codec.topk_decode(
                idx.to(self.device), vals.to(self.device), n=src.numel()))
        return self._apply_full(delta, opt)

    # ------------------------------------------------------------------ #
    # whole-table reads
    # ------------------------------------------------------------------ #
    def get_async(self) -> int:
        """ref WorkerTable::GetAsync: snapshot, start the device -> host
        copy, return a msg id. A version-cache hit skips both; a prefetch
        at this version is taken instead of a new snapshot."""
        self._flush_host_adds()   # before the lock: the applier needs it
        with monitor(f"table[{self.name}].get"), self._dispatch_lock:
            cached = self._cached_get()
            if cached is not None:
                return self._track(_Pending(None, cached, lambda h: h))
            version = self._version
            if self._num_shards > 1:
                # the blocks' all-gather is a collective: it runs here, on
                # the caller's thread, in the caller's order
                host = self._gathered_rows()
                self._store_get_cache(version, host)
                return self._track(_Pending(None, host, lambda h: h))
            op = self._take_prefetch() or self._snapshot()

            def _finalize(h, _v=version):
                out = self._host_array(h)
                with self._dispatch_lock:
                    self._store_get_cache(_v, out)
                return out

            op.finalize = _finalize
            return self._track(op)

    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """ref WorkerTable::Get: blocking pull of the whole logical table
        (bf16-rounded with a wire filter)."""
        self._flush_host_adds()   # before the lock: the applier needs it
        with monitor(f"table[{self.name}].get"), self._dispatch_lock:
            hit = self._cached_get(into=out)
            if hit is not None:
                return hit
            version = self._version
            op = self._take_prefetch()
            if op is not None:
                # its copy has been streaming since the add issued it
                host = self._host_array(op.host_ready())
            elif self._num_shards > 1:
                host = self._gathered_rows()
            elif self._wire != "none":
                host = self._host_array(wire_codec.bf16_cast(
                    self._data[: self.shape[0]]).cpu())
            elif (out is not None and out.dtype == self.np_dtype
                  and out.size == int(np.prod(self.shape))
                  and out.flags.c_contiguous and out.flags.writeable):
                # one device -> host copy, straight into the caller's
                # buffer (the C ABI's Get hands its own memory here)
                torch.from_numpy(out.reshape(self.shape)).copy_(
                    self._data[: self.shape[0]])
                self._store_get_cache(version, out)
                return out
            else:
                host = self._data[: self.shape[0]].to(
                    "cpu", copy=True).numpy()
            self._store_get_cache(version, host)
        if out is not None:
            np.copyto(out.reshape(self.shape), host)
            return out
        return host

    def _gathered_rows(self) -> np.ndarray:
        """The whole logical table on the host from every rank's block
        (bf16-rounded with a wire filter): one all-gather over the table
        axis, a collective."""
        from multiverso_tpu_torch.parallel.collectives import \
            process_all_gather
        blk = self._data
        if self._wire != "none":
            blk = wire_codec.bf16_cast(blk).to(self.dtype)
        whole = process_all_gather(blk.cpu().numpy(), self._mesh, self._axis)
        return whole[: self.shape[0]]

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

    # ------------------------------------------------------------------ #
    # checkpoint (ref ServerTable Store/Load, table_interface.h:61-75)
    # ------------------------------------------------------------------ #
    def _state_leaves(self):
        """(key, tensor) of the updater state in ``jax.tree.flatten``
        order: sorted keys."""
        return [(k, self._ustate[k]) for k in sorted(self._ustate)]

    @staticmethod
    def _write_stored(stream, data: np.ndarray, leaves) -> None:
        """The stored format: the data, the leaf count, each leaf."""
        np.save(stream, data, allow_pickle=False)
        np.save(stream, np.asarray(len(leaves)), allow_pickle=False)
        for leaf in leaves:
            np.save(stream, leaf, allow_pickle=False)

    def _gather_rows_of(self, arr: np.ndarray, axis: int) -> np.ndarray:
        """The whole padded host array of a block (``arr``'s ``axis`` the
        row axis): an all-gather over the table axis, a collective."""
        from multiverso_tpu_torch.parallel.collectives import \
            process_all_gather
        whole = process_all_gather(np.moveaxis(arr, axis, 0), self._mesh,
                                   self._axis)
        return np.moveaxis(whole, 0, axis)

    def _stored_arrays(self) -> Tuple[np.ndarray, list]:
        """The padded data and the updater-state leaves in sorted-key
        order, whole, on the host. A sharded table gathers its blocks (a
        collective; every rank calls it, in one order) and keeps the
        logical rows and one spare row, the padding of a table of one
        block: the layout a one-process table of either package loads.
        Caller holds the dispatch lock."""
        data = self._data.cpu().numpy()
        leaves = [leaf.cpu().numpy() for _, leaf in self._state_leaves()]
        if self._num_shards == 1:
            return data, leaves
        keep = self.shape[0] + 1

        def whole(arr, axis):
            arr = self._gather_rows_of(arr, axis)
            return arr[(slice(None),) * axis + (slice(0, keep),)]

        return (whole(data, 0),
                [leaf if self._state_row_axis(leaf) is None
                 else whole(leaf, self._state_row_axis(leaf))
                 for leaf in leaves])

    def store(self, stream) -> None:
        """Write the padded data and the updater state with ``np.save``:
        the data, the leaf count, then each leaf in sorted-key order, the
        JAX package's format (ref array_table.cpp:143-151). A sharded
        table writes the whole table, gathered from every rank's block,
        at the padding of one block (``rows + 1``): a collective
        (``checkpoint.save`` has rank 0 write it)."""
        self._flush_host_adds()
        with self._dispatch_lock:
            self._write_stored(stream, *self._stored_arrays())

    def store_snapshot(self) -> Tuple[Callable[[Any], None], int]:
        """The table's state now, for a checkpoint written later:
        ``(write, nbytes)``. ``write(stream)`` writes what :meth:`store`
        would have written at this call, whatever the table did since;
        ``nbytes`` is the host memory the snapshot holds until ``write``
        returns. The data and each updater-state leaf are copied by
        :meth:`_host_copies`. A sharded table gathers its blocks into
        host arrays now (a collective, on the caller's thread)."""
        self._flush_host_adds()
        with self._dispatch_lock:
            if self._num_shards > 1:
                data, leaves = self._stored_arrays()
                hosts, done = [torch.from_numpy(a) for a in
                               [data] + leaves], None
            else:
                hosts, done = self._host_copies(
                    [self._data] + [leaf for _, leaf in
                                    self._state_leaves()])
        nbytes = sum(h.numel() * h.element_size() for h in hosts)

        def write(stream) -> None:
            if done is not None:
                done.synchronize()
            self._write_stored(stream, hosts[0].numpy(),
                               [h.numpy() for h in hosts[1:]])

        return write, nbytes

    def _host_copies(self, srcs) -> Tuple[list, Optional[torch.cuda.Event]]:
        """Host copies of the tensors ``srcs`` as they are now, and the
        event to wait for before reading them (None on the CPU). On the
        card they are pinned buffers filled on the table's stream, where
        every later op of the table runs after the copies; on the CPU
        they are clones. Caller holds the dispatch lock."""
        if self.device.type != "cuda":
            return [t.clone() for t in srcs], None
        with torch.cuda.stream(self._stream):
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in srcs]
            for h, t in zip(hosts, srcs):
                h.copy_(t, non_blocking=True)
            return hosts, self._event()

    # ------------------------------------------------------------------ #
    # the sharded checkpoint (checkpoint.save(backend="orbax")): each rank
    # writes and reads its own block, nothing is gathered
    # ------------------------------------------------------------------ #
    def block_index(self) -> Dict[str, Any]:
        """The JSON index of this table in a sharded checkpoint: the
        logical shape, the padded row count, the dtype, each block's
        padded row range ``[lo, hi)`` in block order, and each leaf's row
        axis, or ``"shared"`` for a leaf shared by all rows (Adam's step
        count). The leaves are ``data`` and ``ustate.<key>``; a row leaf's
        block ``k`` is the file ``<leaf>.<k>.npy``, a shared leaf's the
        file ``<leaf>.npy``."""
        n = self._padded_rows // self._num_shards
        leaves: Dict[str, Any] = {"data": 0}
        for key, leaf in self._state_leaves():
            axis = self._state_row_axis(leaf)
            leaves[f"ustate.{key}"] = "shared" if axis is None else axis
        return {"shape": list(self.shape), "padded_rows": self._padded_rows,
                "dtype": str(self.np_dtype),
                "blocks": [[k * n, (k + 1) * n]
                           for k in range(self._num_shards)],
                "leaves": leaves}

    def _block_writer(self) -> bool:
        """True on the one rank that writes this rank's block: the first
        of the ranks that hold it (index 0 on every mesh axis but the
        table's)."""
        others = tuple(a for a in self._mesh.axis_names if a != self._axis)
        return not others or self._mesh.index(others) == 0

    def block_snapshot(self, shared: bool
                       ) -> Tuple[list, Optional[torch.cuda.Event]]:
        """The files this rank writes to a sharded checkpoint, as the
        state is now: ``([(file name, host tensor)], event)``, copied by
        :meth:`_host_copies` (wait for the event before reading them).
        They are this rank's block of the data and of each row-shaped
        updater-state leaf, when this rank is its block's writer, and,
        with ``shared`` (rank 0), the leaves shared by all rows. No
        collective: every rank copies only what it holds."""
        self._flush_host_adds()
        with self._dispatch_lock:
            k = self._rows[0] // (self._padded_rows // self._num_shards)
            mine = self._block_writer()
            files, srcs = [], []
            if mine:
                files.append(f"data.{k}.npy")
                srcs.append(self._data)
            for key, leaf in self._state_leaves():
                if self._state_row_axis(leaf) is None:
                    if not shared:
                        continue
                    files.append(f"ustate.{key}.npy")
                elif mine:
                    files.append(f"ustate.{key}.{k}.npy")
                else:
                    continue
                srcs.append(leaf)
            hosts, done = self._host_copies(srcs)
        return list(zip(files, hosts)), done

    def load_blocks(self, index: Dict[str, Any],
                    read: Callable[[str], np.ndarray]) -> None:
        """Load this rank's block from a table of a sharded checkpoint:
        ``index`` is its :meth:`block_index`, ``read(name)`` a file's
        array (memory-mapped where the file is local, so that only the
        rows taken are read). Only the saved blocks that overlap this
        rank's rows are read, so a checkpoint of any block count loads.
        At the saved padding every row loads; at another padding the
        logical rows load and this table's own padding rows are zero, as
        :meth:`load` with ``rows``. A leaf shared by all rows loads whole.
        The state lands on the table's device. A logical shape or an
        updater state that differs raises ``ValueError``."""
        if list(index["shape"]) != list(self.shape):
            raise ValueError(f"checkpoint shape {tuple(index['shape'])} != "
                             f"table {self.shape}")
        want = self.block_index()["leaves"]
        if index["leaves"] != want:
            raise ValueError(f"checkpoint updater state mismatch: "
                             f"{index['leaves']} != {want}")
        self._mark_mutated()
        self._flush_host_adds()   # a late-applying add must not overwrite
        n_file = int(index["padded_rows"])
        keep = n_file if n_file == self._padded_rows else self.shape[0]
        lo, hi = self._rows

        def block(name: str, axis: int, like: torch.Tensor) -> torch.Tensor:
            out = torch.zeros(like.shape, dtype=like.dtype)
            for k, (slo, shi) in enumerate(index["blocks"]):
                a, b = max(lo, slo), min(hi, shi, keep)
                if a >= b:
                    continue
                src = read(f"{name}.{k}.npy")
                shape = list(like.shape)
                shape[axis] = shi - slo
                if list(src.shape) != shape:
                    raise ValueError(f"checkpoint {name} block {k}: shape "
                                     f"{src.shape} != {tuple(shape)}")
                part = np.array(   # a copy: the file's rows, read now
                    src[(slice(None),) * axis + (slice(a - slo, b - slo),)])
                out.narrow(axis, a - lo, b - a).copy_(
                    torch.from_numpy(part))
            return out

        def shared(name: str, like: torch.Tensor) -> torch.Tensor:
            arr = np.array(read(f"{name}.npy"))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint {name}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            return torch.as_tensor(arr).to(like.dtype)

        data = block("data", 0, self._data)
        ustate = {}
        for key, leaf in self._state_leaves():
            axis = want[f"ustate.{key}"]
            ustate[key] = (shared(f"ustate.{key}", leaf) if axis == "shared"
                           else block(f"ustate.{key}", axis, leaf))
        with self._dispatch_lock:
            self._data = data.to(self.device)
            self._ustate = {k: v.to(self.device) for k, v in ustate.items()}
            self._wrote_in_place()

    def load(self, stream, rows: Optional[int] = None) -> None:
        """Read what :meth:`store` (of either package) wrote: the whole
        padded table, of which this rank keeps its block. A padded shape
        or an updater state that differs raises ``ValueError``, unless
        ``rows``, the stored table's logical row count (a checkpoint's
        manifest has it), is this table's: then any padding loads (the
        logical rows are kept and this table's own padding rows are
        zero), so a checkpoint crosses between layouts of different
        block counts."""
        self._mark_mutated()
        self._flush_host_adds()   # a late-applying add must not overwrite
        data = np.load(stream)
        n_file = data.shape[0] if data.ndim else 0
        if data.shape != self._padded_shape and not (
                rows == self.shape[0] and n_file > rows
                and data.shape[1:] == self._padded_shape[1:]):
            raise ValueError(
                f"checkpoint shape {data.shape} != table {self._padded_shape}")
        n = int(np.load(stream))
        keys = [k for k, _ in self._state_leaves()]
        if n != len(keys):
            raise ValueError("checkpoint updater state mismatch")
        leaves = [np.load(stream) for _ in range(n)]
        lo, hi = self._rows

        def block(arr, axis):
            """This rank's block of a whole stored array (row axis
            ``axis``, ``n_file`` rows), repadded to this table's."""
            if n_file != self._padded_rows:
                shape = list(arr.shape)
                shape[axis] = self._padded_rows
                out = np.zeros(shape, arr.dtype)
                idx = (slice(None),) * axis + (slice(0, self.shape[0]),)
                out[idx] = arr[idx]
                arr = out
            return np.ascontiguousarray(
                arr[(slice(None),) * axis + (slice(lo, hi),)])

        mine = []
        for k, leaf in zip(keys, leaves):
            want = list(self._ustate[k].shape)
            axis = self._state_row_axis(self._ustate[k])
            if axis is not None:
                want[axis] = n_file
            if leaf.shape != tuple(want):
                raise ValueError(f"checkpoint updater state {k!r}: shape "
                                 f"{leaf.shape} != {tuple(want)}")
            mine.append(leaf if axis is None else block(leaf, axis))
        with self._dispatch_lock:
            self._data = torch.from_numpy(
                block(data, 0).astype(self.np_dtype)).to(self.device)
            self._ustate = {
                k: torch.as_tensor(leaf).to(self.device,
                                            self._ustate[k].dtype)
                for k, leaf in zip(keys, mine)}
            self._wrote_in_place()
