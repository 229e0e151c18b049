"""ReadReplica: a bounded-staleness read copy of one async PS table (port
of ``multiverso_tpu/serving/replica.py``).

The serving tier's read path. A replica pulls each
owning shard's committed rows through the ``MSG_SNAPSHOT`` subscription
RPC (ps/service.MSG_SNAPSHOT -> ps/shard.RowShard.export_snapshot) on an
epoch cadence and answers ``get_rows`` from its local copy — zero wire
hops on the hot path, so inference QPS scales with replica processes
instead of loading the shards, and a shard briefly down costs serving
nothing while the snapshot is within bound.

The staleness contract (the part that makes a replica *usable*, not
just fast): every served read's data is at most ``staleness_s`` old,
measured from the moment the adopted snapshot's pull STARTED (the
conservative end — the data is at least that fresh). A background
thread refreshes every ``refresh_s``; a read that still finds the
snapshot over bound (refresh thread stalled, owner briefly down longer
than the cadence) does NOT serve stale — it performs/joins one
synchronous refresh first (single-flight; counted as ``deferred``) and
only serves once back under bound. The advertised bound is therefore
enforced, not just reported, and the serving bench asserts
measured-staleness <= bound in-run.

Snapshot pulls reuse the machinery the write plane already paid for:
the shard serves the copy off-lock under an epoch pin (applies keep
flowing during the copy), streams big shards as chunked replies (decode
overlaps the receive), and answers ``since``-version probes
with a tiny ``unchanged`` frame when nothing applied since the last
pull — an idle table costs the wire almost nothing per epoch.

The snapshot lives on the host (numpy), as in the JAX package; a served
read is a host gather. Hot-row cache: with ``cache_rows > 0`` the
replica keeps the table's hottest rows — ranked by the Space-Saving
sketch merged across the owning shards (``telemetry/hotkeys.py``) — as a
tensor on the table's device (the card), rebuilt and installed whole
with each snapshot swap (cache and snapshot are always the same epoch, so a
fully-cached request may be served from the device without mixing
versions). Hits/misses are measured per request: the bench compares the
MEASURED hit rate against the sketch's ``hit_rate_curve`` estimate —
closing the loop the sketch promised.

Reads can be gated by an :class:`~multiverso_tpu_torch.serving.admission.
AdmissionController` (``admission=``): class ``"infer"`` reads over
budget shed with :class:`SheddingError` before touching any state.
Counters land on the Dashboard (``table[X].get.replica`` serve
latency/count, ``.shed``, ``.deferred``, ``.cache_hit`` / ``.cache_miss``)
— they ride MSG_STATS and the Zoo shutdown report like every monitor —
and first-class replica stats (lag epochs/seconds, versions, hit rate)
ride the MSG_STATS ``serving`` block via :func:`stats_snapshot`.

Module-import discipline: ps/service.py imports this module at module
level (flag registration before argv parse), so nothing here may import
the ps package at module scope — ps imports stay inside methods.

Telemetry: each replica registers :meth:`ReadReplica.memory_stats` (the
snapshot buffer, the hot-row cache and the refresh's staging copy) with
the memory ledger; every refresh lands one ``EV_REPLICA_PULL`` on the
flight recorder and, with ``trace_ids`` on, one trace ID rides every
shard's snapshot request, so the ``replica.pull`` span stitches to the
shards' ``snapshot.serve`` spans. Reads feed the process's tenant
ledger (``telemetry/tenants.LEDGER``): each serve with its latency and
age, each shed and each deferred (synchronous-refresh) read, under the
caller's tenant; snapshot pulls are stamped with the process's
``tenant_id``.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.serving.admission import (AdmissionController,
                                                    SheddingError)
from multiverso_tpu_torch.serving.hotcache import (HotRowCache,
                                                   match_positions)
from multiverso_tpu_torch.telemetry import hotkeys as _hotkeys
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.telemetry import tenants as _tenants
from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils import retry as _retry
from multiverso_tpu_torch.utils.dashboard import Dashboard

config.define_float(
    "serving_refresh_s", 0.5,
    "read-replica snapshot refresh cadence seconds (the epoch "
    "cadence); each cycle pulls MSG_SNAPSHOT from every owning shard "
    "with a since-version, so an idle table costs one tiny "
    "'unchanged' frame per shard per epoch")
config.define_float(
    "serving_staleness_s", 2.0,
    "read-replica advertised staleness bound seconds: a served read's "
    "data is at most this old (age measured from the adopted pull's "
    "start). Reads finding the snapshot over bound refresh "
    "synchronously first (counted as 'deferred') — the bound is "
    "enforced, not just reported")
config.define_int(
    "serving_cache_rows", 0,
    "hot-row cache capacity per replica (rows, on the table's device), "
    "seeded from the shards' Space-Saving sketch top-K and rebuilt "
    "atomically with every snapshot swap; 0 = off. Hits/misses are "
    "measured per request (table[X].get.cache_hit/_miss)")
config.define_int(
    "serving_snapshot_chunk_rows", 4096,
    "rows per MSG_REPLY_CHUNK sub-frame of a replica snapshot pull; "
    "shards bigger than this stream chunked (decode overlaps the "
    "receive). 0 = never chunk")
config.define_int(
    "serving_pull_retries", 2,
    "attempts per owning shard within one replica snapshot pull "
    "(utils/retry.py shared backoff, deadline = the pull's own "
    "ps_timeout budget): a transient shard blip — an injected reset, "
    "a reconnect — retries inside the refresh instead of failing the "
    "whole cycle and burning a staleness epoch. 1 = fail fast")


class BoundUnsatisfiableError(RuntimeError):
    """The replica's staleness bound cannot be met: repeated fresh
    pulls each aged past the bound before a read could be served (the
    pull is slower than the advertised staleness, or the owners are
    mid-outage). Typed so a :class:`~multiverso_tpu_torch.serving.pool.
    ReplicaPool` can fail over to a healthy sibling and only surface
    it when the WHOLE pool is over bound."""

# replica registry for the MSG_STATS "serving" block (weak: a replica's
# lifetime belongs to its owner, not to telemetry)
_REPLICAS: "weakref.WeakSet" = weakref.WeakSet()
# pool snapshot providers (serving/pool.py registers one per pool):
# zero-arg callables returning {table: merged-pool entry}. A pool's
# entry REPLACES its member replicas' individual entries — N replicas
# of one table in one process would otherwise last-write-wins each
# other in the block. Registered here (not imported from pool.py) so
# this module never imports pool at module scope.
_POOL_PROVIDERS: List = []


def register_pool_provider(fn) -> None:
    if fn not in _POOL_PROVIDERS:
        _POOL_PROVIDERS.append(fn)

# cache reseed cadence, in refresh epochs: pulling the shards' sketch is
# an extra stats RPC per owner, so it rides every Nth refresh (traffic
# shifts over minutes, snapshots over sub-seconds)
_CACHE_RESEED_EPOCHS = 8


def stats_snapshot() -> Dict[str, Dict]:
    """{table: replica stats} across this process's live replicas —
    the MSG_STATS ``serving`` block (ps/service.stats_payload). Pure
    JSON-safe data; one replica per table expected (the last
    constructed wins a name collision). Tables served by a
    :class:`~multiverso_tpu_torch.serving.pool.ReplicaPool` report the
    pool's MERGED entry instead (summed counters + a ``"pool"``
    detail block — per-member route share, lag, degraded flag — the
    stats consumers read it)."""
    out: Dict[str, Dict] = {}
    for rep in list(_REPLICAS):
        try:
            s = rep.stats()
            out[s["table"]] = s
        except Exception:   # noqa: BLE001 — telemetry never raises
            pass
    for prov in list(_POOL_PROVIDERS):
        try:
            for tname, ent in (prov() or {}).items():
                out[tname] = ent
        except Exception:   # noqa: BLE001 — telemetry never raises
            pass
    return out


class ReadReplica:
    """Bounded-staleness read copy of one row-partitioned async table.

    Construct from the table object (``ReadReplica(table)``) or
    standalone from a context + spec (a serving sidecar that never
    constructs the table)::

        rep = ReadReplica(ctx=ctx, name="emb", num_row=N, num_col=D)

    ``start=True`` (default) runs the background refresh thread; call
    :meth:`close` to stop it. ``start=False`` = manual mode: the owner
    drives :meth:`refresh` (tests, step-driven serving loops) — the
    staleness bound is still enforced via deferred synchronous
    refreshes on reads.
    """

    def __init__(self, table=None, *, ctx=None, name: Optional[str] = None,
                 num_row: Optional[int] = None,
                 num_col: Optional[int] = None, dtype=np.float32,
                 refresh_s: Optional[float] = None,
                 staleness_s: Optional[float] = None,
                 cache_rows: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 start: bool = True):
        if table is not None:
            ctx = table.ctx
            name = table.name
            num_row, num_col = table.num_row, table.num_col
            dtype = table.dtype
            ranges = list(table._ranges)
            device = table.device
        else:
            if ctx is None or name is None or not num_row or not num_col:
                raise ValueError("standalone ReadReplica needs ctx, name, "
                                 "num_row and num_col")
            # identical partition math to AsyncMatrixTable: (rank, lo, hi)
            # of every non-empty shard
            rows_per = -(-int(num_row) // ctx.world)
            ranges = [(r, min(r * rows_per, num_row),
                       min((r + 1) * rows_per, num_row))
                      for r in range(ctx.world)]
            ranges = [(r, a, b) for r, a, b in ranges if b > a]
            device = ctx.device
        self.ctx = ctx
        # where the hot-row cache lives: the table's device (the card
        # unless the context asked for the CPU)
        self.device = torch.device(device)
        self.name = str(name)
        self.num_row, self.num_col = int(num_row), int(num_col)
        self.dtype = np.dtype(dtype)
        self._ranges: List[Tuple[int, int, int]] = ranges
        self.refresh_s = (config.get_flag("serving_refresh_s")
                          if refresh_s is None else float(refresh_s))
        self.staleness_s = (config.get_flag("serving_staleness_s")
                            if staleness_s is None else float(staleness_s))
        self.cache_capacity = (config.get_flag("serving_cache_rows")
                               if cache_rows is None else int(cache_rows))
        self.admission = admission

        # snapshot state: (_data, _versions, _pulled_at, _epoch) swap
        # together under _swap_lock; readers take a reference and
        # compute off it (the buffer is never mutated in place — a
        # refresh builds a fresh one, so held references stay
        # epoch-consistent: the shard's epoch pin, without the pin)
        self._swap_lock = threading.Lock()
        self._data: Optional[np.ndarray] = None
        self._versions: Dict[int, int] = {}
        # per-rank shard incarnation generation (failover plane): the
        # since-version dedupe token is (gen, version) — a respawned
        # shard's counter may coincide with a pre-crash version while
        # the content diverged, and the shard only answers "unchanged"
        # when BOTH match
        self._gens: Dict[int, int] = {}
        self._pulled_at = -float("inf")   # monotonic; -inf = never
        self._epoch = 0
        self._last_refresh_ms = 0.0
        self._unchanged_pulls = 0         # shard replies deduped by since=
        # hot-row cache (same epoch as _data by construction): the shared
        # serving/hotcache.HotRowCache under the replica discipline —
        # whole-cache install at each snapshot swap, never mutated between
        self._hot_ids: Optional[np.ndarray] = None
        self._cache = HotRowCache(self.num_col, self.dtype,
                                  capacity=self.cache_capacity,
                                  name=self.name, device=self.device)
        # single-flight refresh
        self._refresh_lock = threading.Lock()
        # serving counters (ints for stats(); Dashboard monitors beside
        # them for MSG_STATS/shutdown-report visibility)
        self._served = 0
        self._shed = 0
        self._deferred = 0
        self._hits = 0
        self._misses = 0
        # pull-health counters (the pool's demotion signal): total
        # failed refresh cycles + the CONSECUTIVE failure streak
        # (reset by any successful pull)
        self._pull_failures = 0
        self._consec_pull_failures = 0
        base = f"table[{self.name}].get"
        self._mon_replica = Dashboard.get(base + ".replica")
        self._mon_shed = Dashboard.get(base + ".shed")
        self._mon_deferred = Dashboard.get(base + ".deferred")
        self._mon_cache_hit = Dashboard.get(base + ".cache_hit")
        self._mon_cache_miss = Dashboard.get(base + ".cache_miss")

        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # in-flight refresh staging copy (bytes; nonzero only while a
        # pull assembles its fresh buffer) — the memory ledger's view of
        # the transient second table each refresh costs
        self._staging_nb = 0
        _REPLICAS.add(self)
        _memstats.register(f"replica[{self.name}]", self)
        if start:
            self.start()

    def memory_stats(self) -> Dict[str, Any]:
        """Byte-ledger gauges (pull-only): the adopted snapshot buffer,
        the hot-row cache, and the transient refresh staging copy."""
        with self._swap_lock:
            data = self._data
        cstats = self._cache.memory_stats()
        return {
            "snapshot_bytes": int(getattr(data, "nbytes", 0) or 0)
            if data is not None else 0,
            "cache_device_bytes": cstats["device_bytes"],
            "cache_rows": cstats["rows"],
            "staging_bytes": int(self._staging_nb),
        }

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def start(self) -> "ReadReplica":
        if self._thread is None:
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"mv-replica-{self.name}")
            self._thread.start()
        return self

    def close(self) -> None:
        self._closed = True
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_s):
            if self._closed:
                return
            try:
                self.refresh()
            except Exception as e:   # noqa: BLE001 — an owner briefly
                # down must not kill the cadence; reads stay served
                # from the in-bound snapshot and the bound turns a
                # LONG outage into refused (deferred-refresh) reads,
                # never silently-stale ones
                log.debug("replica[%s] refresh failed: %s: %s",
                          self.name, type(e).__name__, e)

    # ------------------------------------------------------------------ #
    # refresh (snapshot pull)
    # ------------------------------------------------------------------ #
    def refresh(self, need_from: Optional[float] = None) -> bool:
        """One synchronous snapshot pull, single-flight: concurrent
        callers serialize, and a caller that waited out someone else's
        pull returns without pulling again IF that pull STARTED at or
        after ``need_from`` (default: this call's entry time) — only
        then does the adopted snapshot cover every write acked before
        the caller asked. (Comparing against the previous pull's stamp
        instead would let a background pull that began BEFORE the
        caller's writes satisfy the dedupe and serve a snapshot
        missing them — the read-your-acked-writes contract refresh()
        gives quiescing callers.) Bound-enforcement callers relax
        ``need_from`` to ``now - staleness_s``: they only need SOME
        in-bound pull, and the strict default would turn K readers
        blocked on one stale snapshot into K serialized full-table
        pulls against an already-degraded owner. Returns True when
        THIS call pulled."""
        if self._closed:
            # a killed/closed replica must not quietly resurrect
            # itself through a health probe's refresh — the pool's
            # demotion of it is permanent until a NEW replica exists
            raise RuntimeError(f"replica[{self.name}] is closed")
        if need_from is None:
            need_from = time.monotonic()
        with self._refresh_lock:
            if self._pulled_at >= need_from:
                return False   # a satisfying concurrent refresh landed
            try:
                self._pull_once()
            except Exception:
                # pull-health bookkeeping for the pool's demotion
                # logic: a replica whose pulls keep failing is routed
                # around, not retried into
                self._pull_failures += 1
                self._consec_pull_failures += 1
                raise
            self._consec_pull_failures = 0
            return True

    def pull_health(self) -> Dict[str, Any]:
        """(pool surface) total + consecutive failed refresh cycles."""
        return {"failures": self._pull_failures,
                "consecutive": self._consec_pull_failures}

    def _make_sink(self, buf: np.ndarray):
        """Chunk sink scattering MSG_REPLY_CHUNK sub-frames of one
        shard's snapshot stream into ``buf`` (runs on the peer's recv
        thread; failures surface on the final frame)."""
        from multiverso_tpu_torch.ps import wire as wire_mod
        cols, dtype = self.num_col, self.dtype

        def sink(cmeta, arrays):
            r0, n = int(cmeta["row0"]), int(cmeta["rows"])
            buf[r0:r0 + n] = wire_mod.decode_payload(
                arrays, cmeta.get("wire", "none"), (n, cols), dtype)

        return sink

    def _pull_once(self) -> None:
        from multiverso_tpu_torch.ps import service as svc
        from multiverso_tpu_torch.ps import wire as wire_mod
        from multiverso_tpu_torch.telemetry import flightrec as _flight
        from multiverso_tpu_torch.telemetry import trace as _trace
        t_start = time.monotonic()
        # one trace ID per refresh cycle rides every shard's snapshot
        # request, so the replica.pull span and each shard's
        # snapshot.serve span stitch on one timeline
        tr = _trace.new_id() if _trace.enabled() else None
        t_wall0 = time.time() if tr is not None else 0.0
        service = self.ctx.service
        chunk = int(config.get_flag("serving_snapshot_chunk_rows"))

        def dispatch(rank, lo, hi):
            # tenant-stamped like add/get frames (the refresh thread has
            # no per-call scope, so this is the process's tenant_id
            # flag): the shard attributes pull bytes to the tenant the
            # replica serves
            meta: Dict[str, Any] = wire_mod.with_tenant(
                wire_mod.with_trace({
                    "table": self.name,
                    "since": int(self._versions.get(rank, -1)),
                    "since_gen": int(self._gens.get(rank, -1))}, tr),
                _tenants.current())
            sink = buf = None
            if chunk > 0 and (hi - lo) > chunk and rank != self.ctx.rank:
                buf = np.empty((hi - lo, self.num_col), self.dtype)
                meta["chunk"] = chunk
                sink = self._make_sink(buf)
            fut = service.request(rank, svc.MSG_SNAPSHOT, meta, (),
                                  chunk_sink=sink)
            return fut, buf

        reqs = []
        for rank, lo, hi in self._ranges:
            fut, buf = dispatch(rank, lo, hi)
            reqs.append((rank, lo, hi, fut, buf))
        timeout = config.get_flag("ps_timeout")
        # shared retry policy (utils/retry.py) with deadline
        # propagation: the whole pull — every shard's attempts AND the
        # backoff sleeps between them — fits one ps_timeout budget, so
        # a transient shard blip (injected reset, mid-failover
        # reconnect) retries inside the refresh instead of burning a
        # staleness epoch, while a real outage still fails in bounded
        # time for _grab_fresh to judge
        attempts = max(int(config.get_flag("serving_pull_retries")), 1)
        deadline = _retry.deadline_in(timeout)
        backoff = _retry.Backoff(base_s=0.05, cap_s=1.0)
        changed: Dict[Tuple[int, int], np.ndarray] = {}
        versions = dict(self._versions)
        gens = dict(self._gens)
        for rank, lo, hi, fut, buf in reqs:
            rmeta = arrays = None
            for k in range(attempts):
                try:
                    rmeta, arrays = svc.await_reply(
                        fut, max(_retry.remaining_s(deadline, timeout),
                                 0.05),
                        f"replica[{self.name}] snapshot from rank "
                        f"{rank}")
                    break
                except svc.PSError:
                    if k + 1 >= attempts or not backoff.sleep(
                            k, deadline):
                        raise
                    log.debug("replica[%s] snapshot pull from rank %d "
                              "failed (attempt %d); retrying",
                              self.name, rank, k + 1)
                    fut, buf = dispatch(rank, lo, hi)   # fresh request
            versions[rank] = int(rmeta.get("version", -1))
            gens[rank] = int(rmeta.get("gen", 0))
            if rmeta.get("unchanged"):
                self._unchanged_pulls += 1
                continue
            if rmeta.get("chunks"):
                rows = buf   # the sinks already scattered the stream
            else:
                rows = np.asarray(arrays[0], self.dtype).reshape(
                    hi - lo, self.num_col)
            changed[(lo, hi)] = rows
        # reseed the hot-id set on a cadence (an extra stats RPC per
        # owner — see _CACHE_RESEED_EPOCHS); BEFORE the swap so the
        # fresh cache is built against the fresh snapshot below
        if (self.cache_capacity > 0
                and self._epoch % _CACHE_RESEED_EPOCHS == 0):
            self._reseed_hot_ids()
        # assemble OFF the reader-facing lock: _refresh_lock already
        # makes pulls single-flight (we are the only mutator of
        # _data), and holding _swap_lock across a production-sized
        # table copy + a device transfer would stall every concurrent
        # get_rows for the duration of each refresh — the same
        # off-lock discipline as the shard read path.
        # Readers only ever need the lock for a reference grab.
        cur = self._data   # sole-writer read; rebind is swap-locked
        if cur is None:
            staging = np.zeros((self.num_row, self.num_col), self.dtype)
        elif changed:
            staging = cur.copy()
            self._staging_nb = int(staging.nbytes)   # ledger gauge
        else:
            staging = cur   # nothing applied anywhere: the epoch
            #                 advances, the buffer stays
        for (lo, hi), rows in changed.items():
            staging[lo:hi] = rows
        cache_ids = cache_dev = None
        if self.cache_capacity > 0:
            cache_ids, cache_dev = self._build_cache(staging)
        with self._swap_lock:
            snapshot_moved = staging is not cur
            self._data = staging
            self._versions = versions
            self._gens = gens
            self._pulled_at = t_start   # pull START: conservative age
            self._epoch += 1
            self._last_refresh_ms = (time.monotonic() - t_start) * 1e3
            if cache_ids is not None:
                # atomic whole-cache replace (hotcache install: the
                # replica discipline) — cache and snapshot swap in under
                # the same lock hold, so they are always the same epoch
                self._cache.install(cache_ids, None,
                                    device_rows=cache_dev)
            elif snapshot_moved:
                # the snapshot content moved but no same-epoch cache was
                # built (no hot ids yet / device placement failed): DROP
                # the old cache at the swap commit. Keeping it would (a)
                # pin a full device-resident row block from a RETIRED
                # epoch until whenever the next successful build lands —
                # the same shape as a shard's retired-epoch
                # hoard — and (b) let cache_lookup serve rows the
                # adopted snapshot no longer contains, breaking the
                # "cache and snapshot are always the same epoch"
                # contract the class docstring promises.
                self._cache.clear()
            self._staging_nb = 0
        # flight recorder + trace span: one refresh = one event/span, so
        # serving refresh traffic shows on the data plane's timeline
        # (nbytes = rows actually re-shipped this cycle)
        _flight.record(
            _flight.EV_REPLICA_PULL,
            nbytes=sum(r.nbytes for r in changed.values()),
            note=f"replica[{self.name}] epoch {self._epoch}")
        if tr is not None:
            _trace.add_span(
                "replica.pull", t_wall0, time.time(), trace=tr,
                cat="serving",
                args={"table": self.name, "epoch": int(self._epoch),
                      "changed": len(changed),
                      "shards": len(self._ranges)})

    # ------------------------------------------------------------------ #
    # hot-row cache (seeded from the Space-Saving sketch)
    # ------------------------------------------------------------------ #
    def _reseed_hot_ids(self) -> None:
        """Pull the owning shards' Space-Saving sketches over MSG_STATS,
        merge (shards partition the id space — exact), and keep the
        top-``cache_capacity`` row ids as the cache seed. Telemetry is
        best-effort: a failed stats pull keeps the previous seed."""
        sketches = []
        for rank, _lo, _hi in self._ranges:
            try:
                payload = self.ctx.service.stats(rank)
                sk = (payload.get("shards", {})
                      .get(self.name, {}).get("hotkeys"))
                if sk:
                    sketches.append(sk)
            except Exception as e:   # noqa: BLE001 — best-effort
                log.debug("replica[%s] sketch pull from rank %d failed: "
                          "%s", self.name, rank, e)
        if not sketches:
            return
        merged = _hotkeys.merge_sketches(sketches)
        ids = [k for k, _c, _e in merged.get("items", [])
               if 0 <= k < self.num_row][: self.cache_capacity]
        if ids:
            self._hot_ids = np.asarray(sorted(ids), np.int64)

    def _build_cache(self, data: np.ndarray):
        """Build the device-resident cache arrays for ``data`` — OFF
        the swap lock (the gather + device put may be expensive); the
        caller installs the result under the same lock hold that swaps
        the snapshot in, so cache rows and snapshot rows are always
        the same epoch. Returns ``(ids, device_rows)`` or ``(None,
        None)`` — the swap then DROPS the previous cache when the
        snapshot content moved (an old-epoch device cache must neither
        stay pinned nor serve retired rows) and keeps it only across
        unchanged epochs."""
        ids = self._hot_ids
        if ids is None or ids.size == 0:
            return None, None
        try:
            return ids, torch.from_numpy(data[ids]).to(self.device)
        except Exception as e:   # noqa: BLE001 — a device placement
            # failure must not fail the snapshot swap; the swap drops
            # the cache for this epoch (served from host until a build
            # succeeds) rather than serving a retired epoch's rows
            log.debug("replica[%s] cache build failed: %s",
                      self.name, e)
            return None, None

    def cache_lookup(self, row_ids) -> Optional[Any]:
        """Device-resident rows for ``row_ids`` when EVERY id is cached
        (same epoch as the last adopted snapshot), else None. For
        inference pipelines that consume rows on-device; hit/miss
        accounting stays with :meth:`get_rows`. (The membership math
        and the fused serve live in serving/hotcache — shared with the
        training-path cache.)"""
        return self._cache.take_device(row_ids)

    # ------------------------------------------------------------------ #
    # the read path
    # ------------------------------------------------------------------ #
    def age_s(self) -> float:
        """Seconds since the adopted snapshot's pull started (inf =
        never refreshed)."""
        with self._swap_lock:
            return time.monotonic() - self._pulled_at

    def _grab_fresh(self, tn: Optional[str] = None):
        """Enforce the staleness bound and take the serving snapshot in
        ONE atomic step: the age check, the buffer grab, and the served
        age are measured under the same lock hold — a read descheduled
        between a passing check and the grab can never serve (or
        report) an over-bound age. A snapshot found over bound
        refreshes synchronously (single-flight; counted as deferred)
        and re-checks. Raises the pull's error when the owners are
        unreachable AND the snapshot is out of bound: refusing to serve
        beats serving silently-stale. Returns (data, age_s, cache_ids)."""
        for _ in range(3):
            with self._swap_lock:
                age = time.monotonic() - self._pulled_at
                if self._data is not None and age <= self.staleness_s:
                    return self._data, age, self._cache.ids()
            self._deferred += 1
            self._mon_deferred.incr()
            # a deferred serve is per-tenant degradation evidence for
            # the noisy-neighbor sweep
            _tenants.LEDGER.note_deferred(self.name, tn)
            # any pull started within the bound satisfies this reader —
            # K concurrent over-bound readers then share ONE pull
            # instead of performing K serialized ones
            self.refresh(need_from=time.monotonic() - self.staleness_s)
            # loop: a refresh that lost the single-flight race may have
            # adopted a pull started just before the bound — re-check
        # three fresh pulls each aged past the bound before serving:
        # the pull itself is slower than the advertised staleness, so
        # the bound is unsatisfiable as configured — refuse loudly
        # rather than quietly violate the contract. Typed: a
        # ReplicaPool catches this, fails over to a healthy sibling,
        # and re-raises only when the WHOLE pool is over bound
        raise BoundUnsatisfiableError(
            f"replica[{self.name}]: staleness bound {self.staleness_s}s "
            f"is below the snapshot pull time "
            f"({self._last_refresh_ms:.1f} ms) — raise "
            "serving_staleness_s or shrink the table")

    def get_rows(self, row_ids, cls: str = "infer",
                 out: Optional[np.ndarray] = None,
                 with_age: bool = False,
                 tenant: Optional[str] = None):
        """Serve rows from the bounded-staleness snapshot.

        ``cls`` is the admission class ("infer" reads may shed with
        :class:`SheddingError`; "train" bypasses unless explicitly
        limited). ``out`` takes the reply in place when it is an exact
        (n, cols) C-contiguous buffer of the table dtype.
        ``with_age=True`` returns ``(rows, age_s)`` with the age of the
        served snapshot measured atomically with the buffer grab — the
        bench's staleness evidence. ``tenant`` overrides the caller's
        :func:`tenants.tenant_scope` / ``tenant_id`` attribution for
        this read (``""`` = explicitly the default tenant)."""
        t0 = time.perf_counter()
        if self._closed:
            # serving off a dead member's last snapshot would mask a
            # replica kill exactly where the pool needs to observe it
            raise RuntimeError(f"replica[{self.name}] is closed")
        ids = np.asarray(row_ids, np.int64).reshape(-1)
        if ids.size == 0:
            raise ValueError("empty row_ids")
        if ids.min() < 0 or ids.max() >= self.num_row:
            raise IndexError(f"row id out of range [0, {self.num_row})")
        tn = _tenants.current() if tenant is None else (tenant or None)
        if self.admission is not None and not self.admission.admit(
                self.name, cls, tenant=tn):
            self._shed += 1
            self._mon_shed.incr()
            _tenants.LEDGER.note_shed(self.name, tn)
            raise SheddingError(
                f"replica[{self.name}]: {cls} read shed by admission "
                "control")
        data, age, cids = self._grab_fresh(tn)
        if (out is not None and isinstance(out, np.ndarray)
                and out.shape == (ids.size, self.num_col)
                and out.dtype == self.dtype and out.flags.c_contiguous):
            np.take(data, ids, axis=0, out=out)
            rows = out
        else:
            rows = data[ids]
        if cids is not None and cids.size:
            _pos, ok = match_positions(cids, ids)
            hits = int(np.count_nonzero(ok))
            if hits:
                self._hits += hits
                self._mon_cache_hit.incr(hits)
            if ids.size - hits:
                self._misses += ids.size - hits
                self._mon_cache_miss.incr(ids.size - hits)
        self._served += 1
        ms = (time.perf_counter() - t0) * 1e3
        self._mon_replica.observe_ms(ms)
        # the serve-side tenant ledger: latency + served age per tenant
        # (one entry per read, at the member that actually served)
        _tenants.LEDGER.note_serve(self.name, tn, ms, age_s=age,
                                   bound_s=self.staleness_s)
        return (rows, age) if with_age else rows

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        """First-class replica stats for the MSG_STATS ``serving``
        block. JSON-safe."""
        with self._swap_lock:
            age = time.monotonic() - self._pulled_at
            epoch = self._epoch
            versions = {str(r): int(v) for r, v in self._versions.items()}
            cache_rows = len(self._cache)
            refresh_ms = self._last_refresh_ms
        total = self._hits + self._misses
        out: Dict[str, Any] = {
            "table": self.name, "epoch": epoch,
            # replica lag: seconds behind the shards (age of the
            # adopted snapshot) + the epoch count
            "age_s": (None if age == float("inf") else round(age, 3)),
            "bound_s": round(self.staleness_s, 3),
            "refresh_s": round(self.refresh_s, 3),
            "refresh_ms": round(refresh_ms, 3),
            "versions": versions,
            "unchanged_pulls": self._unchanged_pulls,
            "served": self._served, "shed": self._shed,
            "deferred": self._deferred,
            "pull_failures": self._pull_failures,
            "pull_failures_consecutive": self._consec_pull_failures,
            "cache_rows": cache_rows,
            "cache_hits": self._hits, "cache_misses": self._misses,
            "cache_hit_rate": (round(self._hits / total, 4)
                               if total else None),
        }
        if self.admission is not None:
            out["admission"] = self.admission.stats()
        return out
