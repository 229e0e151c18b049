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
* **checkpoints**: ``store``/``load`` in the JAX package's format.

The functional plane (``state``, ``functional_add``, ``adopt``) hands the
live tensors to code that trains them in place (the fused WordEmbedding
epoch, the PS block path's device plane). Every path that writes the live
tensors bumps the version afterwards and clears the hot-row train cache,
so a cached Get never serves the state from before the write.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.ops import wire_codec
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

    def memory_stats(self) -> Dict[str, Any]:
        """Byte gauges: the cached Get's host copy and the prefetch's
        pinned host buffer."""
        cache = self._get_cache
        pf = self._get_prefetch
        host = pf[1].host if pf is not None else None
        return {
            "cache_bytes": int(cache[1].nbytes) if cache is not None else 0,
            "prefetch_bytes": (host.numel() * host.element_size()
                               if host is not None else 0),
        }

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
        """The live padded data tensor (reads see every prior async add)."""
        self._flush_host_adds()
        return self._data

    # ------------------------------------------------------------------ #
    # mutation bookkeeping (get-cache version)
    # ------------------------------------------------------------------ #
    def _mark_mutated(self) -> None:
        """Entry of every mutation path: bump the version early, so a
        ``version`` poll already sees a queued but unapplied add. This
        bump alone does not make the cache correct (it happens outside the
        dispatch lock, so a concurrent Get could stamp old data with the
        new version); :meth:`_version_applied`, at the point the mutation
        is issued, does."""
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
        """The live table state ``{"data", "ustate"}``: the padded data
        tensor and the updater's state tensors, not copies. A caller that
        writes them in place commits with :meth:`adopt` or through
        :meth:`functional_add` on this state."""
        self._flush_host_adds()
        return {"data": self._data, "ustate": self._ustate}

    def functional_add(self, state: Dict[str, Any], delta: torch.Tensor,
                       opt: Optional[AddOption] = None) -> Dict[str, Any]:
        """Apply the updater to ``state`` with the padded-shape ``delta``
        (:meth:`pad_delta`). The JAX function returns new arrays; this one
        updates ``state``'s tensors in place and returns ``state``. On the
        table's live state it is a mutation of the table: the version
        bumps and the train cache clears."""
        opt = opt or AddOption()
        live = state["data"] is self._data
        if live:
            self._mark_mutated()
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
        in-place training loop). The data keeps the table's padded shape,
        dtype and device."""
        data = state["data"]
        if (tuple(data.shape) != self._padded_shape
                or data.dtype != self.dtype or data.device != self.device):
            raise ValueError(
                f"adopt: data {tuple(data.shape)} {data.dtype} {data.device}"
                f" does not match the table's {self._padded_shape} "
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

    def _apply_full(self, delta: torch.Tensor,
                    opt: AddOption) -> Optional[torch.cuda.Event]:
        """The updater over the whole table (caller holds the dispatch
        lock); returns the add's event, recorded before the prefetch so a
        wait on the add does not wait for the prefetch's copy."""
        self.updater.apply(self._data, self._ustate, delta, opt)
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
        not care whether N deltas are encoded one by one or as their sum."""
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
                        arr = np.asarray(delta, dtype=self.np_dtype
                                         ).reshape(self.shape)
                        return self._track(_Pending(
                            self._dispatch_wire_add(arr, opt)))
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
            elif self._wire != "none":
                host = self._host_array(wire_codec.bf16_cast(
                    self._data[: self.shape[0]]).cpu())
            else:
                host = self._data[: self.shape[0]].to(
                    "cpu", copy=True).numpy()
            self._store_get_cache(version, host)
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

    # ------------------------------------------------------------------ #
    # checkpoint (ref ServerTable Store/Load, table_interface.h:61-75)
    # ------------------------------------------------------------------ #
    def _state_leaves(self):
        """(key, tensor) of the updater state in ``jax.tree.flatten``
        order: sorted keys."""
        return [(k, self._ustate[k]) for k in sorted(self._ustate)]

    def store(self, stream) -> None:
        """Write the padded data and the updater state with ``np.save``:
        the data, the leaf count, then each leaf in sorted-key order, the
        JAX package's format (ref array_table.cpp:143-151)."""
        self._flush_host_adds()
        with self._dispatch_lock:
            np.save(stream, self._data.cpu().numpy(), allow_pickle=False)
            leaves = self._state_leaves()
            np.save(stream, np.asarray(len(leaves)), allow_pickle=False)
            for _, leaf in leaves:
                np.save(stream, leaf.cpu().numpy(), allow_pickle=False)

    def load(self, stream) -> None:
        """Read what :meth:`store` (of either package) wrote. A padded
        shape or an updater state that differs raises ``ValueError``."""
        self._mark_mutated()
        self._flush_host_adds()   # a late-applying add must not overwrite
        data = np.load(stream)
        if data.shape != self._padded_shape:
            raise ValueError(
                f"checkpoint shape {data.shape} != table {self._padded_shape}")
        n = int(np.load(stream))
        keys = [k for k, _ in self._state_leaves()]
        if n != len(keys):
            raise ValueError("checkpoint updater state mismatch")
        leaves = [np.load(stream) for _ in range(n)]
        for k, leaf in zip(keys, leaves):
            if leaf.shape != tuple(self._ustate[k].shape):
                raise ValueError(f"checkpoint updater state {k!r}: shape "
                                 f"{leaf.shape} != "
                                 f"{tuple(self._ustate[k].shape)}")
        with self._dispatch_lock:
            self._data = torch.from_numpy(
                data.astype(self.np_dtype)).to(self.device)
            self._ustate = {
                k: torch.as_tensor(leaf).to(self.device,
                                            self._ustate[k].dtype)
                for k, leaf in zip(keys, leaves)}
            self._wrote_in_place()
