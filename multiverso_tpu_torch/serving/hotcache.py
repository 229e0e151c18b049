"""HotRowCache: the hot-row cache of the training read path (port of
``multiverso_tpu/serving/hotcache.py``).

A sorted-id row cache with a host store and a lazily built device mirror,
under two disciplines:

* **replica** (:meth:`HotRowCache.install` / :meth:`take_device`): the
  owner replaces the whole cache at an epoch boundary; rows never change
  in place (``serving/replica.ReadReplica``).
* **training** (:meth:`fill` / :meth:`apply_delta` / :meth:`drop`): rows
  enter when a get reply delivers them; local pushes either *write
  through* (the plain-add updater: the cached copy takes the same f32 add
  the table takes, so it stays equal to the table's rows bit for bit) or
  *invalidate* (drop the pushed ids, always safe). The device mirror is
  kept up incrementally with ``ops/row_assemble``'s gather and
  scatter-add instead of being rebuilt after each mutation.

``MatrixTable`` builds a :class:`TrainRowCache` behind the
``train_cache_rows`` flag (:func:`make_train_cache`). Every public method
takes the cache's lock. The ``memory_stats()`` methods report the
cache's bytes; registering them with a memory ledger waits for the
telemetry slice (ROADMAP A, telemetry and tools).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.ops import row_assemble
from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.utils.dashboard import Dashboard
from multiverso_tpu_torch.zoo import default_device

config.define_int(
    "train_cache_rows", 0,
    "hot-row TRAINING cache capacity per matrix table (rows): cached rows "
    "serve row gets locally (a device block when the block is fully "
    "covered). 0 = off. Hits/misses land on "
    "table[X].get.train_cache_hit/_miss")
config.define_string(
    "train_cache_mode", "auto",
    "training-cache push discipline: 'writethrough' applies local pushes "
    "to the cached copy (bit-identical to the table for a default-updater "
    "table), 'invalidate' drops pushed rows (always safe), 'auto' picks "
    "writethrough when eligible else invalidate")
config.define_int(
    "train_cache_refresh_gets", 0,
    "drop the whole training cache every N get calls so rows re-fetch "
    "from the table: bounds how long OTHER writers' pushes stay invisible "
    "to a writethrough cache. 0 = never (exact single-writer mode)")


def match_positions(cached_ids: np.ndarray, ids: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, hit_mask) of ``ids`` inside the SORTED ``cached_ids``
    — the one membership predicate behind replica hit accounting,
    cache_lookup and the training-path hit/cold split. ``positions`` is
    only meaningful where ``hit_mask`` is True."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if cached_ids is None or cached_ids.size == 0:
        return np.zeros(ids.size, np.int64), np.zeros(ids.size, bool)
    pos = np.searchsorted(cached_ids, ids)
    ok = (pos < cached_ids.size) & (
        cached_ids[np.minimum(pos, cached_ids.size - 1)] == ids)
    return pos, ok


class HotRowCache:
    """Sorted-id row cache with a host store and a lazy device mirror."""

    def __init__(self, num_col: int, dtype=np.float32, capacity: int = 0,
                 name: str = "", device=None):
        self.num_col = int(num_col)
        self.dtype = np.dtype(dtype)
        self.capacity = int(capacity)
        self.name = name
        # where the device mirror lives: the table's device; None
        # resolves as init() does (the Zoo's device when the runtime is
        # up, else the card), never a quiet CPU default
        self.device = default_device(device)
        self._lock = threading.RLock()
        self._ids: Optional[np.ndarray] = None      # sorted int64
        self._rows: Optional[np.ndarray] = None     # (n, num_col) host
        self._dev = None                            # lazy device mirror
        self._dev_epoch = -1
        self._epoch = 0   # bumps on every content change

    # ------------------------------------------------------------------ #
    # replica discipline: atomic whole-cache replace
    # ------------------------------------------------------------------ #
    def install(self, ids: Optional[np.ndarray], rows: Optional[Any],
                device_rows: Any = None) -> None:
        """Replace the whole cache: ``ids`` sorted, ``rows`` the host
        rows aligned with them (``device_rows`` optionally pre-built by
        the caller off-lock, the replica's build-then-commit shape).
        ``ids=None`` clears."""
        with self._lock:
            if ids is None or getattr(ids, "size", 0) == 0:
                self._ids = self._rows = self._dev = None
            else:
                self._ids = np.asarray(ids, np.int64).reshape(-1)
                self._rows = (None if rows is None
                              else np.asarray(rows, self.dtype))
                self._dev = device_rows
            self._epoch += 1
            self._dev_epoch = self._epoch if device_rows is not None else -1

    def clear(self) -> None:
        self.install(None, None)

    # ------------------------------------------------------------------ #
    # membership / reads
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._lock:
            return 0 if self._ids is None else int(self._ids.size)

    def ids(self) -> Optional[np.ndarray]:
        with self._lock:
            return self._ids

    def lookup(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        """(positions, hit_mask) against the current cache content.
        Test/diagnostic primitive: positions are only stable while the
        caller excludes fills/drops — production serves go through
        ``TrainRowCache.serve_into``/``serve_full`` (atomic)."""
        with self._lock:
            return match_positions(self._ids, ids)

    def covers(self, ids) -> bool:
        """True when EVERY id is currently cached."""
        _, ok = self.lookup(ids)
        return bool(ok.all()) if ok.size else False

    def gather_into(self, buf: np.ndarray, sel: np.ndarray,
                    pos: np.ndarray) -> bool:
        """``buf[sel] = rows[pos]`` under the lock (training hit fill).
        Returns False when the content moved since the caller's lookup
        resolved (caller falls back to the wire)."""
        with self._lock:
            if self._rows is None or (pos.size and
                                      int(pos.max()) >= self._rows.shape[0]):
                return False
            buf[sel] = self._rows[pos]
            return True

    def take_device(self, row_ids) -> Optional[Any]:
        """Device rows for ``row_ids`` when EVERY id is cached and a
        device mirror exists — the replica's ``cache_lookup`` serve
        (same epoch as the install that built the mirror)."""
        with self._lock:   # the mirror is patched in place by pushes
            cids, cdev = self._ids, self._dev
            if cids is None or cdev is None:
                return None
            pos, ok = match_positions(cids, row_ids)
            if not ok.size or not bool(ok.all()):
                return None
            return cdev.index_select(0, torch.from_numpy(pos).to(
                cdev.device))

    def device_block(self, row_ids, bucket: int) -> Optional[Any]:
        """Fused gather+pad serve: the cached rows for ``row_ids`` as a
        zero-padded ``(bucket, num_col)`` DEVICE block (the training
        consumer's scan layout), gathered and padded on the device
        (ops/row_assemble), no host assembly. None unless every id is
        cached with a live device mirror."""
        with self._lock:
            cids = self._ids
            if cids is None:
                return None
            # coverage first (one host searchsorted): a miss block must
            # not pay the whole-cache host copy + device upload it can
            # never use — in invalidate mode every block after a push is
            # such a miss (the push dropped the trained rows and the
            # mirror with them)
            pos, ok = match_positions(cids, row_ids)
            if not ok.size or not bool(ok.all()) or int(ok.size) > bucket:
                return None
            cdev = self._dev
            if cdev is None or self._dev_epoch != self._epoch:
                cdev = self._ensure_device_locked()
                if cdev is None:
                    return None
            # inside the lock: a concurrent apply_delta patches the mirror
            # in place, and the gather (a copy) must come before it
            return row_assemble.gather_pad_rows(cdev, pos, bucket)

    # ------------------------------------------------------------------ #
    # training discipline: incremental fills / pushes
    # ------------------------------------------------------------------ #
    def fill(self, ids: np.ndarray, rows: np.ndarray,
             admit: Optional[np.ndarray] = None) -> int:
        """Merge freshly-fetched rows into the cache. ``ids`` sorted
        unique (the get path's _prep contract); ``admit`` optionally
        restricts which of them may ENTER (hot-set gating) — ids already
        cached always refresh in place. Respects ``capacity``: when the
        merge would overflow, only refreshes survive. Returns rows
        admitted or refreshed. Drops the device mirror (rebuilt lazily);
        refreshing in place keeps it patchable but a membership change
        cannot be patched."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(rows, self.dtype).reshape(-1, self.num_col)
        with self._lock:
            if self._ids is None:
                take = ids if admit is None else ids[admit]
                takerows = rows if admit is None else rows[admit]
                if self.capacity and take.size > self.capacity:
                    take, takerows = (take[: self.capacity],
                                      takerows[: self.capacity])
                if take.size == 0:
                    return 0
                order = np.argsort(take, kind="stable")   # invariant:
                self._ids = take[order]                   # _ids sorted
                self._rows = takerows[order]
                self._dev = None
                self._epoch += 1
                return int(take.size)
            pos, ok = match_positions(self._ids, ids)
            n = 0
            if np.any(ok):
                self._rows[pos[ok]] = rows[ok]
                n += int(np.count_nonzero(ok))
            new = ~ok if admit is None else (~ok & admit)
            room = ((self.capacity - self._ids.size)
                    if self.capacity else int(np.count_nonzero(new)))
            if np.any(new) and room > 0:
                nidx = np.flatnonzero(new)[:room]
                merged_ids = np.concatenate([self._ids, ids[nidx]])
                merged_rows = np.concatenate([self._rows, rows[nidx]])
                order = np.argsort(merged_ids, kind="stable")
                self._ids = merged_ids[order]
                self._rows = merged_rows[order]
                n += int(nidx.size)
            if n:
                self._dev = None
                self._epoch += 1
            return n

    def apply_delta(self, ids: np.ndarray, delta: np.ndarray) -> None:
        """Write-through: add a pushed delta to the cached copies (ids
        unique — the add path's _prep contract; missing ids are
        ignored). Host rows update with the same IEEE f32 add the
        table's default updater performs; the device mirror is patched in
        place with the scatter-add (ops/row_assemble) instead of dropped,
        so it stays warm across every push."""
        with self._lock:
            if self._ids is None:
                return
            pos, ok = match_positions(self._ids, ids)
            if not np.any(ok):
                return
            hit_pos = pos[ok]
            d = np.asarray(delta, self.dtype).reshape(
                -1, self.num_col)[ok]
            self._rows[hit_pos] += d
            if self._dev is not None and self._dev_epoch == self._epoch:
                try:
                    self._dev = row_assemble.scatter_add_rows(
                        self._dev, hit_pos, d)
                except Exception:   # noqa: BLE001 — a device failure
                    self._dev = None   # costs the mirror, never the data
            self._epoch += 1
            if self._dev is not None:
                self._dev_epoch = self._epoch

    def drop(self, ids) -> int:
        """Invalidate: remove ``ids`` from the cache (push invalidation,
        the always-safe discipline). Returns rows dropped."""
        with self._lock:
            if self._ids is None:
                return 0
            pos, ok = match_positions(self._ids, ids)
            n = int(np.count_nonzero(ok))
            if n == 0:
                return 0
            if n == self._ids.size:
                self._ids = self._rows = self._dev = None
            else:
                keep = np.ones(self._ids.size, bool)
                keep[pos[ok]] = False
                self._ids = self._ids[keep]
                self._rows = self._rows[keep]
                self._dev = None
            self._epoch += 1
            return n

    # ------------------------------------------------------------------ #
    # device mirror
    # ------------------------------------------------------------------ #
    def _ensure_device_locked(self):
        """Build the device mirror from the host rows (caller holds the
        lock; training fills come once per block, not per request).

        The mirror must be a private copy (``copy=True``): this class
        mutates ``_rows`` in place (apply_delta's ``+=``, fill's refresh),
        and on the CPU ``torch.from_numpy`` of ``_rows`` would alias it,
        so a block served before a push would show the push. (The JAX
        mirror pads its height to a power of two, one compiled program
        per height; eager torch needs no padding.)"""
        if self._rows is None:
            return None
        self._dev = torch.from_numpy(self._rows).to(self.device, copy=True)
        self._dev_epoch = self._epoch
        return self._dev

    # ------------------------------------------------------------------ #
    def memory_stats(self) -> Dict[str, Any]:
        """Byte gauges of the cache (pull-only)."""
        with self._lock:
            rows = 0 if self._ids is None else int(self._ids.size)
            host_nb = (0 if self._rows is None
                       else int(self._rows.nbytes))
            dev_nb = (self._dev.numel() * self._dev.element_size()
                      if self._dev is not None else 0)
        return {"rows": rows, "host_bytes": host_nb,
                "device_bytes": dev_nb, "capacity": self.capacity}


class TrainRowCache(HotRowCache):
    """HotRowCache under the TRAINING discipline, with the table-facing
    policy attached: Dashboard hit/miss counters
    (``table[X].get.train_cache_hit`` / ``_miss``), the push discipline
    (write-through vs invalidate), and the periodic refresh that bounds
    a multi-writer run's read staleness (``train_cache_refresh_gets``).

    Correctness contract (held against the JAX cache op by op in
    tests/test_torch_hotcache.py):

    * **writethrough** is bit-exact for a table whose updater is the
      plain adder, because every local push lands the same IEEE f32 add
      on the cached copy that the table lands on its rows; the table
      layer decides eligibility.
    * **invalidate** is always safe: a pushed row is dropped and the
      next get re-fetches it from the table.
    * remote writers are invisible either way until a refresh; for
      multi-writer runs set ``train_cache_refresh_gets`` (the async
      plane's accepted bounded-staleness, now with a knob on it).
    """

    # in-flight-get push log depth: entries are only needed while a get
    # dispatched before the push is still awaiting its reply (the WE
    # pipeline holds 1-2 per table); past this, fills conservatively skip
    _PUSH_LOG_DEPTH = 8

    def __init__(self, table_name: str, num_col: int, dtype=np.float32,
                 capacity: int = 0, writethrough: bool = False,
                 refresh_gets: int = 0, device=None):
        super().__init__(num_col, dtype=dtype, capacity=capacity,
                         name=table_name, device=device)
        self.writethrough = bool(writethrough)
        self.refresh_gets = int(refresh_gets)
        self._gets = 0
        self.hits = 0
        self.misses = 0
        self.refreshes = 0
        # push log for late fills: a get's reply lands at wait() time,
        # possibly AFTER pushes that were dispatched behind it — filling
        # those rows verbatim would cache pre-push state. Each local push
        # appends (seq, sorted ids, sorted delta|None); fill_since()
        # replays the tail onto the incoming rows (write-through — the
        # same f32 adds the table applies, in the same order, so the
        # filled copy is bit-identical to the table) or excludes the
        # pushed ids (invalidate / log overflow: conservative).
        self._push_seq = 0
        self._push_log: list = []   # [(seq, ids_sorted, vals|None)]

    def on_get(self) -> None:
        """Once per table-level get: advances the refresh clock (the
        periodic whole-cache drop for multi-writer staleness bounding)."""
        with self._lock:
            self._gets += 1
            due = (self.refresh_gets > 0
                   and self._gets % self.refresh_gets == 0)
            if due:
                self.refreshes += 1
        if due:
            self.clear()   # takes the lock itself (wildcard mutation)

    def count(self, hits: int, misses: int) -> None:
        # counters under the lock (concurrent gets must not lose
        # increments); the Dashboard monitors are thread-safe themselves
        # and stay OUTSIDE it
        with self._lock:
            self.hits += hits
            self.misses += misses
        if hits:
            self._mon_hit().incr(hits)
        if misses:
            self._mon_miss().incr(misses)

    def device_block_counted(self, row_ids, bucket: int):
        """The table-facing device serve policy, shared by BOTH planes
        (MatrixTable here; the async plane's table later): a
        fully-covered block serves
        from the device mirror and counts its hits + advances the
        refresh clock; a miss counts NOTHING here — the caller falls
        back to the normal get path, which does its own on_get and
        hit/cold accounting (counting here too would double-count the
        block). Clock after serve, deliberately: a refresh falling due
        on this get must not clear the cache mid-decision and then
        double-advance the clock in the fallback path."""
        blk = self.device_block(row_ids, bucket)
        if blk is not None:
            self.count(int(np.asarray(row_ids).size), 0)
            self.on_get()
            # a device-block serve IS a table-level get: count it in the
            # get_rows monitor so the get totals stay consistent with the
            # hit counters (incr only: no wire latency)
            Dashboard.get(f"table[{self.name}].get_rows").incr()
        return blk

    def _mon_hit(self):
        return Dashboard.get(f"table[{self.name}].get.train_cache_hit")

    def _mon_miss(self):
        return Dashboard.get(f"table[{self.name}].get.train_cache_miss")

    def fill_token(self) -> int:
        """Capture at get DISPATCH; hand back to :meth:`fill_since` when
        the reply lands."""
        with self._lock:
            return self._push_seq

    def serve_full(self, uids: np.ndarray
                   ) -> Tuple[int, Optional[np.ndarray]]:
        """All-or-nothing atomic serve: when EVERY id is cached, gather
        the rows into a fresh buffer and return ``(token, rows)``; else
        ``(token, None)`` with no allocation and no gather — the sync
        plane's serve (its partial path refetches ALL rows from the
        device anyway, so a partial host gather would be wasted work)."""
        with self._lock:
            token = self._push_seq
            pos, ok = match_positions(self._ids, uids)
            if not ok.size or not bool(ok.all()):
                return token, None
            return token, self._rows[pos]   # fancy indexing: a copy

    def serve_into(self, uids: np.ndarray, buf: np.ndarray
                   ) -> Tuple[int, np.ndarray]:
        """Atomic {fill token, membership, gather}: copies every cached
        row of ``uids`` into the matching slot of ``buf`` and returns
        ``(token, hit_mask)`` from ONE lock hold — a concurrent
        fill/drop can neither skew positions between a lookup and the
        gather (which would serve the WRONG row's values, not merely
        stale ones) nor advance the push log between the token capture
        and the membership decision. This (with :meth:`serve_full`) is
        the ONLY serve protocol production callers may use — the split
        :meth:`lookup`/:meth:`gather_into` primitives exist for tests
        and diagnostics and reintroduce the skewed-positions race when
        composed without external exclusion."""
        with self._lock:
            token = self._push_seq
            pos, ok = match_positions(self._ids, uids)
            sel = np.flatnonzero(ok)
            if sel.size:
                buf[sel] = self._rows[pos[sel]]
            return token, ok

    def _note_mutation(self, ids, vals) -> None:
        """Append one push-log entry (``ids=None`` = wildcard: a clear/
        overwrite that poisons every in-flight fill). Caller holds the
        lock or accepts the race (entries are append-only)."""
        with self._lock:
            self._push_seq += 1
            if ids is not None:
                ids = np.asarray(ids, np.int64).reshape(-1)
                order = np.argsort(ids, kind="stable")
                ids = ids[order]
                if vals is not None:
                    vals = np.asarray(vals, self.dtype).reshape(
                        -1, self.num_col)[order].copy()
            self._push_log.append((self._push_seq, ids, vals))
            del self._push_log[: max(
                0, len(self._push_log) - self._PUSH_LOG_DEPTH)]

    def on_push(self, ids, delta=None) -> None:
        """A local push to ``ids``: write through (delta is the exact
        host-side delta the table will apply) or invalidate.

        The mutation and its log entry commit under ONE lock hold (the
        lock is an RLock): a wait()-thread ``fill_since`` landing between
        them would see ``_push_seq`` still at its token, replay nothing,
        and refresh the just-mutated rows with pre-push reply values —
        permanently losing the delta from the cached copy."""
        with self._lock:
            if self.writethrough and delta is not None:
                self.apply_delta(ids, delta)
                self._note_mutation(ids, delta)
            else:
                self.drop(ids)
                self._note_mutation(ids, None)

    def on_overwrite(self, ids) -> None:
        """set_rows-style overwrite: drop + poison in-flight fills for
        these ids (an overwrite is not replayable as an add)."""
        with self._lock:   # atomic with the log entry, like on_push
            self.drop(ids)
            self._note_mutation(ids, None)

    def clear(self) -> None:
        with self._lock:   # atomic with the log entry, like on_push
            super().clear()
            self._note_mutation(None, None)   # wildcard: poison every fill

    def fill_since(self, ids: np.ndarray, rows: np.ndarray,
                   token: int) -> int:
        """Merge a get reply fetched at ``token`` into the cache,
        reconciled against every local mutation logged since: in
        write-through mode the logged deltas REPLAY onto the incoming
        rows (the table's order, same IEEE f32 adds — the filled copy matches
        the table bit-for-bit); rows touched by a non-replayable
        mutation (invalidate drop, overwrite, wildcard, log overflow)
        are excluded and re-fetch fresh next time."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        rows = np.asarray(rows, self.dtype).reshape(-1, self.num_col)
        with self._lock:
            if self._push_seq != token:
                if token < self._push_seq - len(self._push_log):
                    return 0   # log overflowed past the token: skip
                rows = rows.copy()   # never scribble on the caller's buf
                keep = np.ones(ids.size, bool)
                for seq, pids, pvals in self._push_log:
                    if seq <= token:
                        continue
                    if pids is None:
                        return 0   # wildcard mutation: poison the fill
                    pos, ok = match_positions(pids, ids)
                    if pvals is None:
                        keep &= ~ok
                    elif np.any(ok):
                        rows[ok] += pvals[pos[ok]]
                if not np.all(keep):
                    ids, rows = ids[keep], rows[keep]
                if ids.size == 0:
                    return 0
            return self.fill(ids, rows)

    def memory_stats(self) -> Dict[str, Any]:
        # the push log retains up to _PUSH_LOG_DEPTH full per-push delta
        # copies (write-through): retained host bytes that scale with
        # push size, so the gauge counts them
        out = super().memory_stats()
        with self._lock:
            log_nb = 0
            for _seq, pids, pvals in self._push_log:
                if pids is not None:
                    log_nb += int(pids.nbytes)
                if pvals is not None:
                    log_nb += int(pvals.nbytes)
            out["push_log_entries"] = len(self._push_log)
        out["push_log_bytes"] = log_nb
        return out

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"rows": len(self), "capacity": self.capacity,
                "mode": ("writethrough" if self.writethrough
                         else "invalidate"),
                "refresh_gets": self.refresh_gets,
                "refreshes": self.refreshes,
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (round(self.hits / total, 4) if total
                             else None)}


def make_train_cache(table_name: str, num_col: int, dtype,
                     writethrough_ok: bool,
                     device=None) -> Optional[TrainRowCache]:
    """Flag-driven factory for the table layer: None when the
    ``train_cache_rows`` knob is off. ``writethrough_ok`` is the CALLER's
    eligibility verdict (default updater + lossless wire); mode 'auto'
    degrades to invalidate when ineligible, an explicit 'writethrough'
    raises instead of silently diverging from the table."""
    capacity = int(config.get_flag("train_cache_rows"))
    if capacity <= 0:
        return None
    mode = str(config.get_flag("train_cache_mode"))
    if mode not in ("auto", "writethrough", "invalidate"):
        raise ValueError(f"unknown train_cache_mode {mode!r}")
    if mode == "writethrough" and not writethrough_ok:
        raise ValueError(
            f"train_cache_mode=writethrough: table[{table_name}] is not "
            "eligible (needs the default plain-add updater and a "
            "lossless wire) — use 'auto' or 'invalidate'")
    wt = writethrough_ok if mode == "auto" else (mode == "writethrough")
    return TrainRowCache(
        table_name, num_col, dtype, capacity=capacity, writethrough=wt,
        refresh_gets=int(config.get_flag("train_cache_refresh_gets")),
        device=device)
