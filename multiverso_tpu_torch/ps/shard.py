"""RowShard: the owner-side storage of an async table's row range (port of
``multiverso_tpu/ps/shard.py``).

The shard's rows are one torch tensor on the owner's device (the card
unless the caller asked for the CPU), padded with one scratch row, and
its updater state is a dict of tensors beside it. An Add runs the
table's updater there: gather the touched rows and their row-axis state,
apply, scatter back (``ops/spmd_apply.build_apply``); the plain adder and
SGD take one ``index_add_`` instead (the same IEEE adds on unique rows).
Requests arrive on the service's connection threads, so several host
threads drive the device; every reply leaves the card through ``.cpu()``
(which waits for the device) before it is encoded.

Shape discipline: row batches of the stateful updaters are padded to the
next power of two with the scratch row and zero deltas (``_bucket_size``,
as the port's MatrixTable buckets), and so are gathers on the card.

Read path (off-lock snapshot serving), as in the JAX package: a get takes
the lock only to PIN the current data epoch (a counted reference to the
data tensor) and gathers outside it. An apply never writes a pinned
tensor in place: while a reader pins it, the apply copies the rows to a
fresh tensor first (copy-on-write, counted as ``cow_applies``) and the
pinned one retires to its readers. So a get racing adds sees a row
wholly before or wholly after each add, never a mix.

Coalescing (flag ``ps_coalesce``): adds arriving on concurrent connection
threads queue; whichever thread finds the queue idle drains it, merging
queued adds into one update: duplicate rows across requests sum in
float64, merging gated by the updaters' ``ROW_LOCAL_STATE`` /
``OPT_INSENSITIVE`` classes, so ``stat_adds`` / ``stat_applies`` count
the same coalescing as the JAX package.

Hot keys: every get and add the shard serves feeds a Space-Saving sketch
of its global row ids (``telemetry/hotkeys.py``, flag
``hotkeys_capacity``), reported in ``stats()["hotkeys"]``; the read
replica seeds its hot-row cache from it.

Not ported (ROADMAP.md §A): the native plane's shard binding, the spmd
lane, the replay channels and ``mark_durable``, and the telemetry hooks
(flight recorder, tenants, trace spans).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.ops import spmd_apply
from multiverso_tpu_torch.ps import service as svc
from multiverso_tpu_torch.ps import wire
from multiverso_tpu_torch.table import _dtypes
from multiverso_tpu_torch.tables.matrix_table import _bucket_size
from multiverso_tpu_torch.telemetry import hotkeys as _hotkeys
from multiverso_tpu_torch.updaters import (AddOption, Updater,
                                           OPT_INSENSITIVE as _OPT_INSENSITIVE,
                                           ROW_LOCAL_STATE as _ROW_LOCAL_STATE,
                                           STATELESS_LINEAR as _LINEAR_SIGN)
from multiverso_tpu_torch.utils import config as _config
from multiverso_tpu_torch.utils.dashboard import Dashboard

# replay-stamped frames carry the sending client's identity here (the JAX
# package's wire.REPLAY_CLIENT_KEY); this plane refuses them
_REPLAY_CLIENT_KEY = "cl"


def _host(arr, dtype) -> torch.Tensor:
    """A CPU tensor of ``arr`` in ``dtype`` that owns writable memory
    (frame blobs are views into the receive buffer)."""
    a = np.asarray(arr, dtype)
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, dtype, copy=True)
    return torch.from_numpy(a)


class _DataPin:
    """A pinned read epoch of a shard's data tensor: holds the tensor and
    marks it so the apply path does not write it in place while any
    reader computes on it."""

    __slots__ = ("data", "version")

    def __init__(self, data, version: int):
        self.data, self.version = data, version


class _PendingAdd:
    """One queued row-add awaiting the shard's applier (coalescing path)."""

    __slots__ = ("local", "vals", "opt", "event", "error")

    def __init__(self, local: np.ndarray, vals: np.ndarray, opt: AddOption):
        self.local, self.vals, self.opt = local, vals, opt
        self.event = threading.Event()
        self.error: Optional[Exception] = None


class RowShard:
    """Rows ``[lo, hi)`` of a logical ``(num_row, num_col)`` table."""

    def __init__(self, lo: int, hi: int, num_col: int, dtype,
                 updater: Updater, name: str,
                 init: Optional[np.ndarray] = None,
                 seed: Optional[int] = None, init_scale: float = 0.0,
                 num_workers: int = 0, device=None):
        """``num_workers > 0`` enables per-worker dirty bits for the sparse
        stale-row protocol (a sparse Get returns only rows stale for the
        asking worker; an Add marks its rows stale for everyone). The bits
        live on the host: control metadata consulted per request."""
        self.lo, self.hi = int(lo), int(hi)
        self.n = self.hi - self.lo
        self.num_col = int(num_col)
        self.name = name
        self.dtype, self.tdtype = _dtypes(dtype)
        self.device = torch.device(device if device is not None else "cpu")
        self.updater = updater
        self.service = None   # set by PSService.register_handler
        self._padded = (self.n + 1, self.num_col)
        host = np.zeros(self._padded, self.dtype)
        if init is not None:
            host[: self.n] = np.asarray(init, self.dtype)
        elif seed is not None and init_scale != 0.0:
            # random init of exactly this shard's rows, seeded by (seed, lo)
            # so the global init is deterministic for a given partition
            rng = np.random.default_rng([seed, self.lo])
            host[: self.n] = rng.uniform(
                -init_scale, init_scale, (self.n, self.num_col)
            ).astype(self.dtype)
        self._data = self._place_rows(host)
        self._ustate = updater.init_state(self._padded, self.tdtype,
                                          self.device)
        self._linear = _LINEAR_SIGN.get(type(updater))
        self._gather = spmd_apply.build_gather()
        self._update = self._make_update()
        # RLock: HashShard wraps handle() in the same lock to make its
        # key->slot translation atomic with the update it guards
        self._lock = threading.RLock()
        # request-coalescing apply queue (flag ps_coalesce)
        self._addq: List[_PendingAdd] = []
        self._addq_lock = threading.Lock()
        self._addq_draining = False
        # adds received vs updates actually run (the coalescing ratio)
        self._stat_adds = 0
        self._stat_applies = 0
        # applied mutations, and the merged-ops-per-apply distribution in
        # power-of-two buckets (both under self._lock)
        self._version = 0
        self._wave_ops: Dict[int, int] = {}
        self._wave_max = 0
        # off-lock read epochs: _cur_pins counts readers pinning _pin_buf
        # (identity-checked against the live _data, so a tensor swap
        # retires the count)
        self._pin_buf: Optional[torch.Tensor] = None
        self._cur_pins = 0
        self._stat_cow = 0
        self._stat_gets = 0
        self._stat_chunks = 0
        self._stat_snapshots = 0
        self._stat_snapshot_unchanged = 0
        self._stat_get_bytes = 0
        self._stat_add_bytes = 0
        # heavy-hitter sketch over the served GLOBAL row ids (bounded
        # memory, O(1) per recorded op): stats()["hotkeys"]
        cap = _config.get_flag("hotkeys_capacity")
        self._hotkeys = _hotkeys.SpaceSaving(cap) if cap > 0 else None
        self._mon_apply = f"ps[{name}].apply"   # Dashboard monitor
        # dirty[worker, local_row]: starts all-True so a worker's first
        # sparse Get pulls everything
        self._dirty = (np.ones((num_workers, self.n), bool)
                       if num_workers > 0 else None)

    # ------------------------------------------------------------------ #
    def _place_rows(self, host: np.ndarray) -> torch.Tensor:
        return _host(host, self.dtype).to(self.device)

    def _make_update(self):
        row_axes = {k: self._state_row_axis(v)
                    for k, v in self._ustate.items()}
        return spmd_apply.build_apply(self.updater, row_axes)

    def _state_row_axis(self, leaf) -> int:
        """Axis of ``leaf`` matching the table row axis; -1 = row-free
        leaf (replaced whole by an update, never gathered)."""
        nd, pd = leaf.dim(), len(self._padded)
        if nd >= pd and tuple(leaf.shape[nd - pd:]) == self._padded:
            return nd - pd
        return -1

    def _leaves(self) -> List[torch.Tensor]:
        """Updater-state leaves in the JAX package's order (a dict
        flattens by sorted key)."""
        return [self._ustate[k] for k in sorted(self._ustate)]

    @property
    def stat_adds(self) -> int:
        return self._stat_adds

    @property
    def stat_applies(self) -> int:
        return self._stat_applies

    def stats(self) -> Dict[str, Any]:
        """Server-side stats (MSG_STATS): JSON-safe scalars and the wave
        distribution; never touches the data tensor."""
        with self._addq_lock:
            queue_depth = len(self._addq)
            pending_bytes = sum(e.local.nbytes + e.vals.nbytes
                                for e in self._addq)
        with self._lock:
            wave_ops = {str(k): v
                        for k, v in sorted(self._wave_ops.items())}
            wave_max = self._wave_max
            version = self._version
            dirty_rows = (int(self._dirty.any(axis=0).sum())
                          if self._dirty is not None else None)
        snap = Dashboard.get(self._mon_apply).snapshot()
        out = {
            "kind": "row", "lo": self.lo, "rows": self.n,
            "cols": self.num_col,
            "bytes": int(self._padded[0] * self.num_col
                         * self.dtype.itemsize),
            "device": str(self.device),
            "adds": self._stat_adds, "applies": self._stat_applies,
            "version": version, "queue_depth": queue_depth,
            "pending_bytes": pending_bytes, "wave_ops": wave_ops,
            "wave_max_ops": wave_max,
            "apply": {"count": snap.count, "p50_ms": snap.p50_ms,
                      "p99_ms": snap.p99_ms, "max_ms": snap.max_ms},
            "gets": self._stat_gets, "get_chunks": self._stat_chunks,
            "cow_applies": self._stat_cow, "read_pins": self._cur_pins,
            "get_bytes": self._stat_get_bytes,
            "add_bytes": self._stat_add_bytes,
            "snapshots": self._stat_snapshots,
            "snapshots_unchanged": self._stat_snapshot_unchanged,
        }
        if dirty_rows is not None:
            out["dirty_rows"] = dirty_rows
        if self._hotkeys is not None:
            out["hotkeys"] = self._hotkeys.to_dict()
        return out

    def queue_depth(self) -> int:
        """Lock-free apply-queue depth for the health plane."""
        return len(self._addq)

    def memory_stats(self) -> Dict[str, Any]:
        """Byte gauges: the data tensor, the updater state, the pinned
        read epochs and the apply queue's pending payload."""
        with self._lock:
            data_nb = self._data.numel() * self._data.element_size()
            ustate_nb = sum(v.numel() * v.element_size()
                            for v in self._ustate.values())
            pins = self._cur_pins
        with self._addq_lock:
            qd = len(self._addq)
            qb = sum(e.local.nbytes + e.vals.nbytes for e in self._addq)
        return {"table_bytes": int(data_nb), "ustate_bytes": int(ustate_nb),
                "dtype": str(self.dtype), "pins": pins,
                "queue_depth": qd, "queue_pending_bytes": int(qb)}

    @property
    def scratch(self) -> int:
        return self.n

    def _note_rows(self, local: np.ndarray) -> None:
        """Feed the heavy-hitter sketch this op's GLOBAL row ids
        (shard-local + ``lo``), after the ids were validated. HashShard
        overrides: its calls here carry slot ids, and the sketch ranks
        the workload's keys."""
        if self._hotkeys is not None:
            self._hotkeys.observe(local, offset=self.lo)

    # ------------------------------------------------------------------ #
    # off-lock read epochs (snapshot serving)
    # ------------------------------------------------------------------ #
    def _pin_data_locked(self) -> _DataPin:
        """Pin the current data epoch (caller holds ``self._lock``)."""
        if self._pin_buf is not self._data:
            self._pin_buf = self._data
            self._cur_pins = 0
        self._cur_pins += 1
        return _DataPin(self._data, self._version)

    def _pin_data(self) -> _DataPin:
        with self._lock:
            return self._pin_data_locked()

    def _release_data(self, pin: _DataPin) -> None:
        with self._lock:
            if pin.data is self._pin_buf and self._cur_pins > 0:
                self._cur_pins -= 1
                if self._cur_pins == 0:
                    # drop the identity anchor too: after a copy-on-write
                    # swap it would keep the RETIRED tensor alive
                    self._pin_buf = None
        pin.data = None   # last holder of a retired epoch frees it

    def _data_pinned(self) -> bool:
        """True when a reader pins the LIVE tensor (caller holds the lock):
        the apply must then write a fresh tensor."""
        return self._pin_buf is self._data and self._cur_pins > 0

    def _writable_data(self) -> torch.Tensor:
        """The tensor an in-place mutation may write (caller holds
        ``self._lock``): copy-on-write when a reader pins the epoch."""
        if self._data_pinned():
            self._data = self._data.clone()
            self._stat_cow += 1
        return self._data

    def _pad_to_bucket(self, local: np.ndarray) -> np.ndarray:
        """Pad a local-id batch to its power-of-two bucket with the scratch
        row (the one shape rule of every padded row path)."""
        b = _bucket_size(local.size, self.n + 1)
        if b > local.size:
            local = np.concatenate(
                [local, np.full(b - local.size, self.scratch, np.int64)])
        return local.astype(np.int64)

    def _localize_raw(self, ids: np.ndarray) -> np.ndarray:
        """Global ids -> validated local ids (unpadded)."""
        local = np.asarray(ids, np.int64) - self.lo
        if local.size == 0 or np.any((local < 0) | (local >= self.n)):
            raise IndexError(
                f"row ids outside shard [{self.lo}, {self.hi}) of "
                f"{self.name}")
        return local

    def _localize(self, ids: np.ndarray) -> Tuple[np.ndarray, int]:
        """Global ids -> bucket-padded local ids (+ true count)."""
        local = self._localize_raw(ids)
        return self._pad_to_bucket(local), local.size

    def _dev_ids(self, local: np.ndarray) -> torch.Tensor:
        return spmd_apply.to_device_ids(local, self.device)

    def _gather_rows(self, local: np.ndarray,
                     data: Optional[torch.Tensor] = None) -> np.ndarray:
        """Shard rows for a reply from ``data`` (a pinned epoch; defaults
        to the live tensor for callers that hold the lock), as an OWNED
        host array: the rows leave the card through ``.cpu()``. On the
        card the ids pad to their bucket."""
        if data is None:
            data = self._data
        k = int(np.asarray(local).size)
        if self.device.type == "cuda":
            local = self._pad_to_bucket(np.asarray(local, np.int64))
        rows = self._gather(data, self._dev_ids(local)).cpu().numpy()
        return rows[:k] if rows.shape[0] != k else rows

    def _full_rows(self, data: torch.Tensor) -> np.ndarray:
        """The shard's logical rows of ``data`` as an owned host array
        (on the CPU ``.cpu()`` is the tensor itself: copy it)."""
        rows = data[: self.n].cpu().numpy()
        return rows.copy() if self.device.type == "cpu" else rows

    # ------------------------------------------------------------------ #
    # coalescing apply queue (ps_coalesce)
    # ------------------------------------------------------------------ #
    def _apply_add_group(self, entries: List[_PendingAdd],
                         opt: AddOption) -> int:
        """Apply one opt-group of queued adds as ONE update (caller holds
        ``self._lock``). Cross-request duplicate rows sum their deltas in
        float64. Updaters with global state (adam's step counter) never
        merge: K adds count K steps. Returns the number of updates
        dispatched (the ``stat_applies`` unit)."""
        if len(entries) > 1 and type(self.updater) not in _ROW_LOCAL_STATE:
            applies = 0
            for e in entries:
                self._record_wave(1)
                try:
                    self._apply_rows(e.local, e.vals, e.opt)
                    applies += 1
                except Exception as err:  # noqa: BLE001 — per-entry
                    e.error = err
            return applies
        if len(entries) == 1:
            local, vals = entries[0].local, entries[0].vals
        else:
            cat_ids = np.concatenate([e.local for e in entries])
            local, inv = np.unique(cat_ids, return_inverse=True)
            acc = np.zeros((local.size, self.num_col), np.float64)
            np.add.at(acc, inv.reshape(-1),
                      np.concatenate([e.vals for e in entries])
                      .astype(np.float64))
            vals = acc.astype(self.dtype)
        self._record_wave(len(entries))
        self._apply_rows(local, vals, opt)
        return 1

    def _record_wave(self, ops: int) -> None:
        """Merged-ops-per-apply distribution (under ``self._lock``)."""
        b = 1 << max(ops - 1, 0).bit_length()
        self._wave_ops[b] = self._wave_ops.get(b, 0) + 1
        if ops > self._wave_max:
            self._wave_max = ops

    def _apply_rows(self, local: np.ndarray, vals: np.ndarray,
                    opt: AddOption) -> None:
        """One merged, deduped row-delta batch -> the updater (under
        ``self._lock``), on the shard's device. A pinned epoch is never
        written: the apply copies it first."""
        t0 = time.perf_counter()
        data = self._writable_data()   # copy-on-write vs pinned reads
        if self._linear is not None:
            # the plain adder and SGD: one signed index_add_ (merged ids
            # are unique, so each row takes exactly one f32 add)
            data.index_add_(0, self._dev_ids(local),
                            _host(vals, self.dtype).to(self.device),
                            alpha=self._linear)
        else:
            ids = self._pad_to_bucket(np.asarray(local, np.int64))
            v = np.asarray(vals, self.dtype)
            if v.shape[0] < ids.size:   # zero-pad to the bucket
                v = np.concatenate(
                    [v, np.zeros((ids.size - v.shape[0], self.num_col),
                                 self.dtype)])
            self._update(data, self._ustate, self._dev_ids(ids),
                         _host(v, self.dtype).to(self.device), opt)
        if self._dirty is not None:
            self._dirty[:, local] = True   # stale for everyone
        self._version += 1
        Dashboard.get(self._mon_apply).observe_ms(
            (time.perf_counter() - t0) * 1e3)
        if self.service is not None:
            self.service.beat("apply")

    # shared continuation pool for drain hand-off (class-level: shards are
    # many, the pool is one)
    _drain_pool: Optional[Any] = None
    _drain_pool_lock = threading.Lock()

    @classmethod
    def _handoff_pool(cls):
        with cls._drain_pool_lock:
            if cls._drain_pool is None:
                import concurrent.futures as cf
                cls._drain_pool = cf.ThreadPoolExecutor(
                    max_workers=2, thread_name_prefix="ps-drain")
            return cls._drain_pool

    def _drain_adds(self, rounds: int = 8) -> None:
        """Applier loop: drain everything queued, merging per opt-group,
        until the queue is observed empty (checked atomically with the
        drainer-slot release). Bounded at ``rounds`` passes; the rest of
        a backlog hands off to the shared drain pool so the captured
        connection thread can reply to its own rank again."""
        normal_exit = False
        try:
            while True:
                handoff = False
                with self._addq_lock:
                    if not self._addq:
                        self._addq_draining = False
                        normal_exit = True
                        return
                    if rounds <= 0:
                        handoff = True   # drainer slot stays claimed
                    else:
                        rounds -= 1
                        batch, self._addq = self._addq, []
                if handoff:
                    self._handoff_pool().submit(self._drain_adds)
                    normal_exit = True
                    return
                # opt-insensitive updaters merge across senders (one
                # group); the rest group by the full AddOption so e.g.
                # per-worker AdaGrad g2 stays per-worker
                merge_all = type(self.updater) in _OPT_INSENSITIVE
                groups: Dict[Any, List[_PendingAdd]] = {}
                for e in batch:
                    groups.setdefault(
                        None if merge_all else e.opt, []).append(e)
                with self._lock:
                    applies = 0
                    for entries in groups.values():
                        try:
                            applies += self._apply_add_group(
                                entries, entries[0].opt)
                        except Exception as err:
                            for e in entries:
                                e.error = err
                    self._stat_adds += len(batch)
                    self._stat_applies += applies
                for e in batch:
                    e.event.set()
        finally:
            if not normal_exit:   # crashed out: fail queued entries rather
                with self._addq_lock:   # than wedge their waiters forever
                    self._addq_draining = False
                    orphans, self._addq = self._addq, []
                for e in orphans:
                    e.error = svc.PSError(f"{self.name}: add applier died")
                    e.event.set()

    def _enqueue_add(self, local: np.ndarray, vals: np.ndarray,
                     opt: AddOption) -> None:
        """Queue a validated, shard-local add and block until applied (the
        reply must mean applied, or a worker's add->get would not read its
        own write). MUST NOT be called holding ``self._lock``."""
        entry = _PendingAdd(local, vals, opt)
        with self._addq_lock:
            self._addq.append(entry)
            drainer = not self._addq_draining
            if drainer:
                self._addq_draining = True
        if drainer:
            self._drain_adds()
        entry.event.wait()
        if entry.error is not None:
            raise entry.error

    def _prep_add(self, meta: Dict, arrays: Sequence[np.ndarray]
                  ) -> Tuple[np.ndarray, np.ndarray, AddOption]:
        """Validate an ADD_ROWS request into (local ids, vals, opt); the
        value payload decodes once here, from the frame blobs."""
        opt = AddOption(**meta.get("opt", {}))
        local = self._localize_raw(arrays[0])
        self._note_rows(local)   # one sketch record per add (plain, batch)
        wirem = meta.get("wire", "none")
        if wirem in ("none", "bf16"):   # single blob decodes implicitly
            vals = wire.as_values(arrays[1], self.dtype)[: local.size]
        else:
            vals = wire.decode_payload(arrays[1:], wirem,
                                       (local.size, self.num_col),
                                       self.dtype)
        # ENCODED payload bytes, per request
        self._stat_add_bytes += sum(int(getattr(a, "nbytes", 0))
                                    for a in arrays[1:])
        return local, vals, opt

    def _prep_add_entry(self, meta: Dict, arrays: Sequence[np.ndarray]
                        ) -> _PendingAdd:
        """One MSG_BATCH sub-op -> a validated pending entry (HashShard
        overrides: its entries carry keys, translated at apply time)."""
        local, vals, opt = self._prep_add(meta, arrays)
        return _PendingAdd(local, vals, opt)

    def _apply_batch_adds(self, entries: List[_PendingAdd]
                          ) -> Tuple[List[int], List[str]]:
        """Apply one window's adds as conflict-free WAVES: consecutive
        entries whose row sets are disjoint (and whose opts agree, unless
        the updater is opt-insensitive) concatenate into ONE update; a
        conflicting entry closes the wave, so overlapping rows still apply
        in arrival order with per-op arithmetic (bit-identical to the
        same ops as N frames). Global-state updaters never wave-merge.
        Returns ``(failed_indices, error_strings)``: a failing wave marks
        only its entries failed and later waves still apply."""
        failed: List[int] = []
        errors: List[str] = []
        if not entries:
            return failed, errors
        mergeable = type(self.updater) in _ROW_LOCAL_STATE
        merge_all = type(self.updater) in _OPT_INSENSITIVE
        with self._lock:
            wave: List[Tuple[int, _PendingAdd]] = []
            seen: set = set()

            def flush_wave():
                if not wave:
                    return
                self._record_wave(len(wave))
                try:
                    if len(wave) == 1:
                        e = wave[0][1]
                        self._apply_rows(e.local, e.vals, e.opt)
                    else:
                        self._apply_rows(
                            np.concatenate([e.local for _, e in wave]),
                            np.concatenate([e.vals for _, e in wave]),
                            wave[0][1].opt)
                    self._stat_applies += 1
                except Exception as err:   # noqa: BLE001 — reported per op
                    failed.extend(i for i, _ in wave)
                    errors.append(f"{type(err).__name__}: {err}")
                wave.clear()
                seen.clear()

            for i, e in enumerate(entries):
                ids = e.local.tolist()
                if wave and (not mergeable
                             or any(x in seen for x in ids)
                             or (not merge_all
                                 and e.opt != wave[0][1].opt)):
                    flush_wave()
                wave.append((i, e))
                seen.update(ids)
            flush_wave()
            self._stat_adds += len(entries)
        return failed, errors

    def _handle_batch(self, meta: Dict, arrays: Sequence[np.ndarray]
                      ) -> Tuple[Dict, List[np.ndarray]]:
        """One MSG_BATCH frame: row adds applied in order with one ack.
        Validation failures raise BEFORE anything applies; apply failures
        come back per sub-op in the reply meta ("failed" indices)."""
        subs = wire.unpack_batch(arrays)
        entries = []
        for mt, m, arrs in subs:
            if mt != svc.MSG_ADD_ROWS:
                raise svc.PSError(
                    f"{self.name}: batch frames carry MSG_ADD_ROWS only "
                    f"(got type {mt})")
            entries.append(self._prep_add_entry(m, arrs))
        failed, errors = self._apply_batch_adds(entries)
        rmeta: Dict = {"n": len(subs)}
        if failed:
            rmeta["failed"] = failed
            rmeta["error"] = "; ".join(errors[:3])
        return rmeta, []

    def _add_rows(self, local: np.ndarray, vals: np.ndarray,
                  opt: AddOption) -> None:
        if _config.get_flag("ps_coalesce"):
            self._enqueue_add(local, vals, opt)
        else:
            with self._lock:
                self._apply_add_group([_PendingAdd(local, vals, opt)], opt)
                self._stat_adds += 1
                self._stat_applies += 1

    # ------------------------------------------------------------------ #
    # off-lock get serving (pin -> gather -> release -> encode)
    # ------------------------------------------------------------------ #
    def _serve_get_rows(self, meta: Dict, arrays: Sequence[np.ndarray]
                        ) -> Tuple[Dict, Any]:
        local = self._localize_raw(arrays[0])
        self._note_rows(local)
        return self._serve_rows_from_pin(self._pin_data(), local, meta)

    def _serve_rows_from_pin(self, pin: _DataPin, local: np.ndarray,
                             meta: Dict) -> Tuple[Dict, Any]:
        """The shared off-lock serve body once an epoch is pinned and ids
        resolved: gather off-lock, release, count, encode."""
        try:
            rows = self._gather_rows(local, data=pin.data)
        finally:
            self._release_data(pin)
        self._stat_gets += 1
        return self._encode_reply(rows, meta)

    def _serve_get_full(self, meta: Dict) -> Tuple[Dict, Any]:
        pin = self._pin_data()
        try:
            full = self._full_rows(pin.data)
        finally:
            self._release_data(pin)
        self._stat_gets += 1
        return self._encode_reply(full, meta)

    def export_snapshot(self, meta: Dict) -> Tuple[Dict, Any]:
        """Replica subscription snapshot (MSG_SNAPSHOT): the shard's rows
        plus the mutation version they correspond to, taken atomically.
        ``meta["since"]`` = the version the replica holds: an unchanged
        shard answers a meta-only frame."""
        since = int(meta.get("since", -1))
        gen = 0
        since_gen = int(meta.get("since_gen", -1))
        with self._lock:
            version = self._version
            if since >= 0 and version == since and since_gen == gen:
                self._stat_snapshots += 1
                self._stat_snapshot_unchanged += 1
                return {"version": version, "gen": gen, "lo": self.lo,
                        "rows": self.n, "cols": self.num_col,
                        "unchanged": True}, []
            pin = self._pin_data_locked()
        try:
            full = self._full_rows(pin.data)
        finally:
            self._release_data(pin)
        self._stat_snapshots += 1
        rmeta = {"version": int(version), "gen": gen, "lo": self.lo,
                 "rows": self.n, "cols": self.num_col}
        emeta, payload = self._encode_reply(full, meta)
        if isinstance(payload, wire.ChunkedReply):
            payload.meta.update(rmeta)
            return payload.meta, payload
        emeta = dict(emeta)
        emeta.update(rmeta)
        return emeta, payload

    def _encode_reply(self, rows: np.ndarray, meta: Dict
                      ) -> Tuple[Dict, Any]:
        """Wire-encode a gathered get reply — chunk-streamed when the
        client asked for it (meta["chunk"] rows per sub-frame) and the
        reply is big enough, one payload otherwise."""
        w = meta.get("wire", "none")
        chunk = int(meta.get("chunk", 0) or 0)
        if chunk > 0 and rows.shape[0] > chunk:
            return self._chunked_reply(rows, w, chunk)
        payload = wire.encode_payload(rows, w)
        self._stat_get_bytes += sum(int(a.nbytes) for a in payload)
        return {}, payload

    def _chunked_reply(self, rows: np.ndarray, w: str, chunk: int
                       ) -> Tuple[Dict, Any]:
        """Stream a big get as self-describing sub-frames, encoded lazily
        per chunk (chunk k+1 encodes while chunk k drains)."""
        n = rows.shape[0]
        nchunks = -(-n // chunk)
        self._stat_chunks += nchunks
        shard = self

        def gen():
            for i in range(nchunks):
                a, b = i * chunk, min((i + 1) * chunk, n)
                cmeta: Dict = {"seq": i, "row0": a, "rows": b - a}
                if w != "none":
                    cmeta["wire"] = w
                payload = wire.encode_payload(rows[a:b], w)
                shard._stat_get_bytes += sum(int(x.nbytes) for x in payload)
                yield cmeta, payload

        final = {"chunks": nchunks, "rows": n}
        if w != "none":
            final["wire"] = w
        return final, wire.ChunkedReply(final, gen())

    # ------------------------------------------------------------------ #
    # request handler (runs on service connection threads)
    # ------------------------------------------------------------------ #
    def handle(self, msg_type: int, meta: Dict,
               arrays: Sequence[np.ndarray]
               ) -> Tuple[Dict, List[np.ndarray]]:
        if (msg_type in (svc.MSG_ADD_ROWS, svc.MSG_BATCH)
                and _REPLAY_CLIENT_KEY in meta):
            raise svc.PSError(
                f"{self.name}: replay-stamped add frames need the replay "
                "plane, which is not ported to multiverso_tpu_torch yet "
                f"(ROADMAP.md §A {svc.REPLAY_ITEM})")
        return self._handle(msg_type, meta, arrays)

    # ------------------------------------------------------------------ #
    # checkpoint surface: one atomic (meta, arrays) snapshot of the data
    # rows, the updater state and the mutation version
    # ------------------------------------------------------------------ #
    def checkpoint_state(self) -> Tuple[Dict, List[np.ndarray]]:
        """Consistent shard snapshot (under the shard lock); every array
        is an owned host copy."""
        with self._lock:
            version = self._version
            data = self._data[: self.n].cpu().numpy().copy()
            leaves = [l.cpu().numpy().copy() for l in self._leaves()]
        meta = {"kind": "row", "lo": self.lo, "rows": self.n,
                "cols": self.num_col, "dtype": str(self.dtype),
                "version": int(version), "replay": {},
                "n_leaves": len(leaves)}
        return meta, [data] + leaves

    def _set_leaves(self, arrays: Sequence[np.ndarray]) -> None:
        """Adopt updater-state leaves (caller holds the lock), checked
        against the live ones in count and shape."""
        keys = sorted(self._ustate)
        if len(arrays) != len(keys):
            raise svc.PSError(
                f"{self.name}: checkpoint has {len(arrays)} updater-state "
                f"leaves, shard expects {len(keys)} (was the table created "
                "with a different updater?)")
        for got, k in zip(arrays, keys):
            want = self._ustate[k]
            if tuple(np.shape(got)) != tuple(want.shape):
                raise svc.PSError(
                    f"{self.name}: updater-state leaf shape "
                    f"{np.shape(got)} != {tuple(want.shape)} (partition "
                    "changed since the checkpoint?)")
        for got, k in zip(arrays, keys):
            want = self._ustate[k]
            self._ustate[k] = _host(
                np.asarray(got), _dtypes(want.dtype)[0]).to(self.device)

    def restore_checkpoint(self, meta: Dict,
                           arrays: Sequence[np.ndarray]) -> None:
        """Adopt a :meth:`checkpoint_state` snapshot. Dirty bits reset to
        all-True (sparse workers re-pull everything)."""
        if meta.get("kind") != "row":
            raise svc.PSError(f"{self.name}: checkpoint kind "
                              f"{meta.get('kind')!r} is not a row shard")
        if (int(meta["lo"]) != self.lo or int(meta["rows"]) != self.n
                or int(meta["cols"]) != self.num_col):
            raise svc.PSError(
                f"{self.name}: checkpoint shard [{meta['lo']}, "
                f"{int(meta['lo']) + int(meta['rows'])})x{meta['cols']} "
                f"!= live [{self.lo}, {self.hi})x{self.num_col} — "
                "partition changed since the save")
        with self._lock:
            self._set_leaves(list(arrays[1:]))
            host = np.zeros(self._padded, self.dtype)
            host[: self.n] = np.asarray(arrays[0], self.dtype)
            self._data = self._place_rows(host)
            self._version = int(meta.get("version", 0))
            if self._dirty is not None:
                self._dirty[:] = True

    def _handle(self, msg_type: int, meta: Dict,
                arrays: Sequence[np.ndarray]
                ) -> Tuple[Dict, List[np.ndarray]]:
        if msg_type == svc.MSG_ADD_ROWS:
            local, vals, opt = self._prep_add(meta, arrays)
            self._add_rows(local, vals, opt)
            return {}, []
        if msg_type == svc.MSG_BATCH:
            return self._handle_batch(meta, arrays)
        if msg_type == svc.MSG_GET_ROWS and meta.get("sparse"):
            # stale-only reply for meta["worker_id"]
            wid = int(meta.get("worker_id", 0))
            local = self._localize_raw(arrays[0])
            self._note_rows(local)
            with self._lock:
                if self._dirty is None:
                    raise svc.PSError(
                        f"{self.name} was not created with num_workers; "
                        "sparse gets need dirty-bit tracking")
                # mask snapshot + clear ATOMIC with the epoch pin: an add
                # applying after this lock releases re-sets bits on rows
                # served from the pinned (older) epoch, so the next get
                # re-pulls them — nothing lost
                mask = self._dirty[wid, local].copy()
                self._dirty[wid, local] = False
                pin = self._pin_data_locked()
            try:
                stale = local[mask]
                if stale.size:
                    rows = self._gather_rows(stale, data=pin.data)
                else:
                    rows = np.zeros((0, self.num_col), self.dtype)
            finally:
                self._release_data(pin)
            self._stat_gets += 1
            self._stat_get_bytes += mask.nbytes + rows.nbytes
            return {}, [mask, rows]
        if msg_type == svc.MSG_GET_ROWS:
            return self._serve_get_rows(meta, arrays)
        if msg_type == svc.MSG_SET_ROWS:
            ids, k = self._localize(arrays[0])
            vals = np.asarray(arrays[1], self.dtype)[:k]
            with self._lock:
                self._writable_data().index_copy_(
                    0, self._dev_ids(ids[:k]),
                    _host(vals, self.dtype).to(self.device))
                if self._dirty is not None:
                    self._dirty[:, ids[:k]] = True
                self._version += 1
            return {}, []
        if msg_type == svc.MSG_ADD_FULL:
            opt = AddOption(**meta.get("opt", {}))
            delta = wire.decode_payload(arrays, meta.get("wire", "none"),
                                        (self.n, self.num_col), self.dtype)
            padded = np.zeros(self._padded, self.dtype)
            padded[: self.n] = delta
            with self._lock:
                data = self._writable_data()
                self.updater.apply(data, self._ustate,
                                   _host(padded, self.dtype)
                                   .to(self.device), opt)
                if self._dirty is not None:
                    self._dirty[:] = True
                self._version += 1
            return {}, []
        if msg_type == svc.MSG_GET_FULL:
            return self._serve_get_full(meta)
        if msg_type == svc.MSG_SNAPSHOT:
            return self.export_snapshot(meta)
        if msg_type == svc.MSG_GET_STATE:
            # updater-state leaves, full precision (store/load plumbing)
            with self._lock:
                leaves = [l.cpu().numpy().copy() for l in self._leaves()]
            return {"n_leaves": len(leaves)}, leaves
        if msg_type == svc.MSG_SET_STATE:
            with self._lock:
                self._set_leaves(list(arrays))
                self._version += 1
            return {}, []
        raise svc.PSError(f"unknown message type {msg_type}")


class HashShard(RowShard):
    """Sparse-key shard: arbitrary non-negative int64 keys map to row
    slots allocated on first touch. The slot tensor doubles on demand; a
    plain Get of a never-added key returns the initial row (zeros — FTRL's
    w for empty z/n) WITHOUT allocating. Adds, set_rows and sparse
    (dirty-bit) gets allocate."""

    def __init__(self, num_col: int, dtype, updater: Updater, name: str,
                 capacity: int = 1024, num_workers: int = 0, device=None):
        super().__init__(0, capacity, num_col, dtype, updater, name,
                         num_workers=num_workers, device=device)
        self._slot_of: Dict[int, int] = {}
        self._nw = num_workers

    @property
    def keys(self) -> List[int]:
        with self._lock:
            return list(self._slot_of)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["kind"] = "hash"
        with self._lock:
            out["keys"] = len(self._slot_of)
        return out

    def export_snapshot(self, meta: Dict) -> Tuple[Dict, Any]:
        """Hash shards have no stable positional row space to replicate."""
        raise svc.PSError(
            f"{self.name}: read replicas support row-partitioned "
            "shards only (hash-sharded tables have no stable "
            "positional row space)")

    def _grow(self, need: int) -> None:
        old_padded = self._padded
        old_rows = old_padded[0]
        new_n = max(self.n, 1)
        while new_n < need:
            new_n *= 2
        rows = new_n + 1

        def grow(leaf: torch.Tensor) -> torch.Tensor:
            nd, pd = leaf.dim(), len(old_padded)
            if nd >= pd and tuple(leaf.shape[nd - pd:]) == old_padded:
                axis = nd - pd
                shape = list(leaf.shape)
                shape[axis] = rows - old_rows
                return torch.cat([leaf, torch.zeros(shape, dtype=leaf.dtype,
                                                    device=leaf.device)],
                                 dim=axis)
            return leaf

        self._data = grow(self._data)
        self._ustate = {k: grow(v) for k, v in self._ustate.items()}
        if self._dirty is not None:
            self._dirty = np.pad(
                self._dirty, [(0, 0), (0, new_n - self.n)],
                constant_values=True)
        self.n = self.hi = new_n
        self._padded = (rows, self.num_col)
        self._update = self._make_update()

    def _apply_rows(self, keys: np.ndarray, vals: np.ndarray,
                    opt) -> None:
        """Queued add entries carry KEYS; translate to slots here, under
        the same lock hold as the update itself (allocation, grow and
        apply stay atomic)."""
        super()._apply_rows(self._slots_for(keys), vals, opt)

    def _note_rows(self, local: np.ndarray) -> None:
        """No-op: the inherited serve paths reach here with SLOT ids; hash
        traffic records its KEYS through :meth:`_note_keys` where they are
        validated."""

    def _note_keys(self, keys: np.ndarray) -> None:
        if self._hotkeys is not None:
            self._hotkeys.observe(keys)

    def _validate_keys(self, arr) -> np.ndarray:
        keys = np.asarray(arr, np.int64)
        if keys.size == 0:
            raise IndexError(f"{self.name}: empty key batch")
        if np.any(keys < 0):
            raise IndexError(f"{self.name}: negative keys")
        return keys

    def _prep_add_entry(self, meta: Dict, arrays: Sequence[np.ndarray]
                        ) -> _PendingAdd:
        """Batched sub-ops carry KEYS (validated here); key -> slot
        translation stays at apply time."""
        keys = self._validate_keys(arrays[0])
        self._note_keys(keys)
        opt = AddOption(**meta.get("opt", {}))
        vals = wire.as_values(arrays[1], self.dtype)[: keys.size]
        self._stat_add_bytes += sum(int(getattr(a, "nbytes", 0))
                                    for a in arrays[1:])
        return _PendingAdd(keys, vals, opt)

    def _slots_for(self, keys: np.ndarray) -> np.ndarray:
        """key -> slot, allocating unseen keys (under the caller's lock)."""
        out = np.empty(keys.size, np.int64)
        fresh = [i for i, k in enumerate(keys.tolist())
                 if k not in self._slot_of]
        if len(self._slot_of) + len(fresh) > self.n:
            self._grow(len(self._slot_of) + len(fresh))
        for i, k in enumerate(keys.tolist()):
            slot = self._slot_of.get(k)
            if slot is None:
                slot = self._slot_of[k] = len(self._slot_of)
            out[i] = slot
        return out

    def checkpoint_state(self) -> Tuple[Dict, List[np.ndarray]]:
        """Hash-shard snapshot: the (keys, rows, state-leaf) dump plus the
        version."""
        with self._lock:
            version = self._version
            _, arrs = self._dump()
        meta = {"kind": "hash", "cols": self.num_col,
                "dtype": str(self.dtype), "version": int(version),
                "replay": {}, "n_leaves": max(len(arrs) - 2, 0)}
        return meta, [np.ascontiguousarray(a) for a in arrs]

    def restore_checkpoint(self, meta: Dict,
                           arrays: Sequence[np.ndarray]) -> None:
        if meta.get("kind") != "hash":
            raise svc.PSError(f"{self.name}: checkpoint kind "
                              f"{meta.get('kind')!r} is not a hash shard")
        with self._lock:
            self._restore(arrays)
            self._version = int(meta.get("version", 0))

    def _handle(self, msg_type: int, meta: Dict,
                arrays: Sequence[np.ndarray]
                ) -> Tuple[Dict, List[np.ndarray]]:
        if msg_type in (svc.MSG_ADD_FULL, svc.MSG_GET_FULL):
            raise svc.PSError(
                f"{self.name}: hash-sharded table has no dense whole-table "
                "plane; use row/key ops")
        if msg_type == svc.MSG_ADD_ROWS:
            # adds ride the coalescing queue OUTSIDE the lock; entries
            # carry KEYS, translated to slots at apply time
            entry = self._prep_add_entry(meta, arrays)
            self._add_rows(entry.local, entry.vals, entry.opt)
            return {}, []
        if msg_type == svc.MSG_GET_ROWS and not meta.get("sparse"):
            # allocation-free read: unknown keys gather the scratch row,
            # which stays zeros (padded adds apply zero deltas to it)
            keys = self._validate_keys(arrays[0])
            self._note_keys(keys)
            with self._lock:
                slots = np.array(
                    [self._slot_of.get(k, self.n)
                     for k in keys.tolist()], np.int64)
                pin = self._pin_data_locked()
            return self._serve_rows_from_pin(pin, slots, meta)
        keys = None
        if msg_type in (svc.MSG_GET_ROWS, svc.MSG_SET_ROWS):
            keys = self._validate_keys(arrays[0])
            if msg_type == svc.MSG_GET_ROWS:   # a sparse keyed get
                self._note_keys(keys)
        with self._lock:   # reentrant: key->slot stays atomic w/ the update
            if msg_type == svc.MSG_GET_STATE and meta.get("dump"):
                return self._dump()
            if msg_type == svc.MSG_SET_STATE and meta.get("dump"):
                return self._restore(arrays)
            if keys is not None:
                slots = self._slots_for(keys)
                arrays = [slots] + list(arrays[1:])
            return super()._handle(msg_type, meta, arrays)

    # ------------------------------------------------------------------ #
    # checkpoint: (keys, rows, per-key updater state)
    # ------------------------------------------------------------------ #
    def _dump(self) -> Tuple[Dict, List[np.ndarray]]:
        keys = np.array(sorted(self._slot_of), np.int64)
        slots = np.array([self._slot_of[k] for k in keys.tolist()], np.int64)
        if keys.size:
            rows = self._gather_rows(slots)
        else:
            rows = np.zeros((0, self.num_col), self.dtype)
        leaves = []
        for leaf in self._leaves():
            axis = self._state_row_axis(leaf)
            arr = leaf.cpu().numpy()
            if axis >= 0:
                leaves.append(np.take(arr, slots, axis=axis))
            else:
                leaves.append(arr.copy())
        return ({}, [keys, rows] + leaves)

    def _restore(self, arrays: Sequence[np.ndarray]
                 ) -> Tuple[Dict, List[np.ndarray]]:
        keys, rows = np.asarray(arrays[0], np.int64), arrays[1]
        leaves_in = list(arrays[2:])
        self._slot_of = {}
        self.n = self.hi = 0
        self._padded = (1, self.num_col)
        self._data = self._place_rows(np.zeros(self._padded, self.dtype))
        self._ustate = self.updater.init_state(self._padded, self.tdtype,
                                               self.device)
        self._update = self._make_update()
        if self._dirty is not None:
            self._dirty = np.ones((self._nw, 0), bool)
        if keys.size == 0:
            return {}, []
        slots = self._slots_for(keys)
        data = self._data.cpu().numpy().copy()
        data[slots] = wire.as_values(rows, self.dtype)
        self._data = self._place_rows(data)
        names = sorted(self._ustate)
        if len(leaves_in) != len(names):
            raise svc.PSError(
                f"{self.name}: checkpoint has {len(leaves_in)} updater-state "
                f"leaves, expected {len(names)}")
        for got, k in zip(leaves_in, names):
            want = self._ustate[k]
            arr = want.cpu().numpy().copy()
            axis = self._state_row_axis(want)
            if axis >= 0:
                idx = (slice(None),) * axis + (slots,)
                arr[idx] = np.asarray(got, arr.dtype)
            else:
                arr = np.asarray(got, arr.dtype)
            self._ustate[k] = _host(arr, arr.dtype).to(self.device)
        if self._dirty is not None:
            self._dirty = np.ones((self._nw, self.n), bool)
        return {}, []


class KVShard:
    """Hash-sharded key-value shard (``key % world`` routing; the
    owner's map holds the global aggregate for its keys). A host dict:
    scalar KV traffic has no business on the card."""

    def __init__(self, name: str):
        self.name = name
        self._store: Dict[int, float] = {}
        self._lock = threading.Lock()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"kind": "kv", "keys": len(self._store)}

    def handle(self, msg_type: int, meta: Dict,
               arrays: Sequence[np.ndarray]
               ) -> Tuple[Dict, List[np.ndarray]]:
        if msg_type == svc.MSG_KV_ADD:
            keys, vals = arrays
            with self._lock:
                for k, v in zip(keys.tolist(), vals.tolist()):
                    self._store[int(k)] = self._store.get(int(k), 0) + v
            return {}, []
        if msg_type == svc.MSG_KV_GET:
            with self._lock:
                if meta.get("all"):
                    items = sorted(self._store.items())
                    keys = np.array([k for k, _ in items], np.int64)
                    vals = np.array([v for _, v in items], np.float64)
                else:
                    keys = np.asarray(arrays[0], np.int64)
                    vals = np.array(
                        [self._store.get(int(k), 0) for k in keys],
                        np.float64)
            return {}, [keys, vals]
        raise svc.PSError(f"unknown message type {msg_type}")
