"""Async tables: the uncoordinated cross-process Add/Get client plane (port
of ``multiverso_tpu/ps/tables.py``).

Every rank owns a contiguous row block of each table (its
:class:`~multiverso_tpu_torch.ps.shard.RowShard`, on the rank's device);
a client partitions each op by owner rank and sends uncoordinated
requests — workers at different rates, with different row sets, never
waiting on each other. Every async op returns a msg id; ``wait(id)``
blocks on its request futures and returns the assembled host array for
gets.

The client windows, both off by default as in the JAX package: the send
window (flag ``batch_window_ms`` or the table's ``send_window_ms=``,
:class:`_SendWindow`) queues ``add_rows_async`` per owner and ships each
owner's queue as one frame; the get window (flag ``get_window_ms`` or
the table's ``get_window_ms=``, :class:`_GetWindow`) merges concurrent
gets to an owner into single-flight fetches. Windowed results equal
window-off results bit for bit.

Exactly-once replay (flag ``ps_replay``, on a windowed table): the send
window stamps each frame with (client, per-owner sequence), retains it
past its ack until the owner reports it durable, and re-flushes the
retained tail in sequence order when the owner dies
(:class:`_ReplayBuffer`); the shard's sequence channels dedupe.

The native transport (flag ``ps_native``, ``ps/native.py``): a table
with the plain wire, no sparse stale-row protocol, an f32/f64 dtype and
no window (``_native_ok``) sends its row adds and gets through the C++
client — counted fire-and-forget adds (:class:`_NativeAddFuture`), gets
whose replies the C++ recv threads scatter straight into the result
buffer (:class:`_NativeGetFuture`), the per-owner split done in C
(``native.add_fanout`` / ``get_fanout``) — and its whole-table add and
get one native op per owner. ``set_rows`` fences on the native adds
(:meth:`AsyncMatrixTable._native_flush`) before its frames take the
Python conn.

Telemetry: ``add_rows_async``/``get_rows_async`` mint a trace ID when
``trace_ids`` is on (``client.enqueue``, ``client.add_rows``,
``client.get_rows``, ``window.flush`` and ``window.ack`` spans; the shard
records its side under the same ID), and open ``ps.add``/``ps.get``
step-profiler async spans closed at the reply. The windows mark their
enqueue, flush, ack, fetch and replay edges on the flight recorder, and
the send window registers its ``memory_stats`` with the byte ledger.

Tenants (``telemetry/tenants.py``): a named tenant (``tenant_scope`` or
the ``tenant_id`` flag) stamps ``wire.TENANT_META_KEY`` on every add and
get frame, which punts the native server to Python where the shard's
meter counts it; default traffic keeps the cached meta bytes and the
native fast path. The send window merges only entries of one tenant, a
named tenant's gets bypass the get window, and ``tenant_add_qps``
budgets each (table, tenant)'s windowed adds: an over-budget add still
ships and is counted as deferred in the tenant ledger.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import itertools
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from multiverso_tpu_torch import updaters as updaters_lib
from multiverso_tpu_torch.ps import service as svc
from multiverso_tpu_torch.ps import wire as wire_mod
from multiverso_tpu_torch.ps.shard import HashShard, KVShard, RowShard
from multiverso_tpu_torch.serving import hotcache as _hotcache
from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.telemetry import profiler as _profiler
from multiverso_tpu_torch.telemetry import tenants as _tenants
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils import retry as _retry
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor


# ---------------------------------------------------------------------- #
# native-transport futures: Future-shaped handles over the C++ client
# (ps/native.py). They plug into the same _track/wait/flush bookkeeping as
# the python _Peer futures — done()/exception()/result(timeout) is all the
# plane consumes.
# ---------------------------------------------------------------------- #
def _failed_future(exc: Exception) -> cf.Future:
    f: cf.Future = cf.Future()
    f.set_exception(exc if isinstance(exc, svc.PSPeerError)
                    else svc.PSPeerError(str(exc)))
    return f


class _NativeAddFuture:
    """Counted fire-and-forget add: complete when the conn's ack counter
    reaches this op's sequence number — no Python wakeup per reply. A
    server ERR reply binds to this op alone (by msg id), matching the
    python plane's per-future errors."""

    __slots__ = ("_conn", "_seq", "_mid", "_exc")

    def __init__(self, conn, seq: int, mid: int):
        self._conn, self._seq, self._mid = conn, seq, mid
        self._exc: Optional[Exception] = None

    def done(self) -> bool:
        if self._conn.dead():
            return True
        done = self._conn.adds_done()
        return done < 0 or done >= self._seq

    def result(self, timeout=None):
        from multiverso_tpu_torch.ps.native import NativeConnError
        if self._exc is not None:
            raise self._exc
        try:
            self._conn.wait_adds(self._seq,
                                 3600.0 if timeout is None else timeout)
        except TimeoutError as e:
            raise cf.TimeoutError(str(e)) from None
        except NativeConnError as e:
            self._exc = svc.PSPeerError(str(e))
            raise self._exc from None
        err = self._conn.take_add_error(self._mid)
        if err is not None:
            self._exc = svc.PSError(err)
            raise self._exc
        return ({}, [])

    def exception(self):
        if not self.done():
            return None
        try:
            self.result(timeout=1.0)
        except Exception as e:   # noqa: BLE001 — the sweep logs it
            return e
        return None


class _NativeGetFuture:
    """Buffer-filling get: the C++ recv thread copies the reply payload
    straight into ``out``; result() blocks on the native wait."""

    __slots__ = ("_conn", "_mid", "_out", "_state", "_exc")

    def __init__(self, conn, mid: int, out: np.ndarray):
        self._conn, self._mid, self._out = conn, mid, out
        self._state = "pending"
        self._exc: Optional[Exception] = None

    def done(self) -> bool:
        return self._state != "pending"

    def __del__(self):
        # abandoned while pending (a sibling owner's failure aborted the
        # whole op): cancel so the C++ recv thread can never scatter into
        # the (about to be freed) out buffer
        try:
            if self._state == "pending":
                self._conn.get_cancel(self._mid)
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass

    def result(self, timeout=None):
        from multiverso_tpu_torch.ps.native import NativeConnError
        if self._state == "error":
            raise self._exc
        if self._state == "pending":
            try:
                self._conn.get_wait(self._mid,
                                    3600.0 if timeout is None else timeout)
            except TimeoutError as e:
                # the native side dropped the pending entry: this future
                # can never complete now — pin the failure
                self._exc = svc.PSPeerError(f"native get: {e}")
                self._state = "error"
                raise cf.TimeoutError(str(e)) from None
            except NativeConnError as e:
                self._exc = svc.PSPeerError(str(e))
                self._state = "error"
                raise self._exc from None
            self._state = "done"
        return ({}, [self._out])

    def exception(self):
        return self._exc


def _native_add(service, rank: int, msg_type: int, meta_b: bytes,
                ids: Optional[np.ndarray], vals: np.ndarray):
    """One counted add on the native conn to ``rank``; failures come back
    as failed futures so multi-owner fan-outs keep their live shards
    (service.request's never-raise contract)."""
    conn = None
    try:
        conn = service.native_conn(rank)
        seq, mid = conn.add(msg_type, meta_b, ids, vals)
        return _NativeAddFuture(conn, seq, mid)
    except svc.PSError as e:
        return _failed_future(e)
    except Exception as e:   # NativeConnError mid-send: conn is toast
        if conn is not None:
            service.drop_native_conn(rank, conn)
        return _failed_future(e)


def _native_get(service, rank: int, msg_type: int, meta_b: bytes,
                ids: Optional[np.ndarray], out: np.ndarray):
    conn = None
    try:
        conn = service.native_conn(rank)
        mid = conn.get_send(msg_type, meta_b, ids, out)
        return _NativeGetFuture(conn, mid, out)
    except svc.PSError as e:
        return _failed_future(e)
    except Exception as e:
        if conn is not None:
            service.drop_native_conn(rank, conn)
        return _failed_future(e)


def _fanout_futures(parts, make):
    """Shared shaping of add_fanout/get_fanout results into futures: an
    unreachable owner becomes a failed future (live shards unaffected),
    everything else goes through ``make(conn, seq, mid)``."""
    return [(_failed_future(svc.PSPeerError(f"rank {r} unreachable over "
                                            "native transport"))
             if conn is None else make(conn, seq, mid))
            for r, conn, seq, mid in parts]


def _resolve_updater(updater, num_workers: int, dtype):
    if updater is None:
        updater = config.get_flag("updater_type")
    if isinstance(updater, str):
        updater = updaters_lib.get_updater(updater, num_workers=num_workers,
                                           dtype=dtype)
    return updater


def _dedupe_batch(row_ids, num_col: int, dtype,
                  bound: Optional[int], values=None):
    """Validate + dedupe a row/key batch, accumulating duplicate values in
    float64. Returns (unique_ids, vals | None, inverse) where
    ``inverse=None`` means the ids were already unique and kept in caller
    order (the common case, which skips the sort-ordering, the float64
    accumulate and the caller's re-expansion)."""
    raw = np.asarray(row_ids)
    if raw.size == 0:
        raise ValueError("empty row_ids")
    if not np.issubdtype(raw.dtype, np.integer):
        raise TypeError(f"row_ids must be integers, got {raw.dtype}")
    ids = np.asarray(raw, np.int64).reshape(-1)   # no copy if already i64
    if ids.min() < 0:
        raise IndexError("row ids/keys must be non-negative")
    if bound is not None and ids.max() >= bound:
        raise IndexError(f"row id out of range [0, {bound})")
    if ids.size == 1:
        has_dups = False
    else:
        s = np.sort(ids)
        has_dups = bool(np.any(s[1:] == s[:-1]))
    if not has_dups:
        vals = (None if values is None
                else np.asarray(values, dtype).reshape(ids.size, num_col))
        # own the ids: async gets re-read them after the reply lands, and
        # a caller refilling a reused id buffer must not corrupt them
        return (ids.copy() if ids.base is not None or ids is raw
                else ids), vals, None
    uids, inv = np.unique(ids, return_inverse=True)
    inv = inv.reshape(-1)
    if values is None:
        return uids, None, inv
    vals = np.asarray(values, dtype).reshape(ids.size, num_col)
    acc = np.zeros((uids.size, num_col), np.float64)
    np.add.at(acc, inv, vals.astype(np.float64))
    return uids, acc.astype(dtype), inv


def _window_loop(ref: "weakref.ref") -> None:
    """Flusher thread body. Holds the window only through a WEAKREF,
    re-resolved each cycle: when the table (and its window) are
    garbage-collected the thread exits at its next bounded wakeup, so a
    windowed table is not pinned in memory by its own daemon thread."""
    while True:
        win = ref()
        if win is None:
            return
        step = win._step
        del win
        step()
        # the bound method strongly references the window: drop it before
        # the next cycle's wait
        del step


def _complete_window_futures(batch_fut: cf.Future,
                             group_futs: List[List[cf.Future]],
                             owner: int = -1) -> None:
    """Fan a window frame's one ack out to the placeholder futures the
    callers track (runs on the peer's recv thread). ``group_futs`` is
    aligned with the frame's sub-ops: a partly applied batch names its
    failed sub-ops in the reply meta ("failed"), and only THOSE futures
    carry the error — a delta that was applied is never reported lost,
    or a caller re-issuing lost deltas would apply it twice."""
    exc: Optional[BaseException] = None
    meta: Dict = {}
    try:
        exc = batch_fut.exception()
        if exc is None:
            res = batch_fut.result()
            if isinstance(res, tuple) and isinstance(res[0], dict):
                meta = res[0]
    except (cf.CancelledError, Exception) as e:   # defensive
        exc = e
    # black box: the window ack edge (runs on the peer's recv thread)
    _flight.record(_flight.EV_WIN_ACK, peer=owner,
                   note=None if exc is None else str(exc)[:120])
    failed = set(meta.get("failed", ()))
    ferr = (svc.PSError("batched add failed at the shard: "
                        f"{meta.get('error', '?')}") if failed else None)
    for i, futs in enumerate(group_futs):
        for f in futs:
            if f.done():
                continue
            if exc is not None:
                f.set_exception(exc)
            elif i in failed:
                f.set_exception(ferr)
            else:
                f.set_result(({}, []))


def _attach_reply_span(futs: List, name: str, t0: float, tid: int,
                       table: str) -> None:
    """Record a client send->reply span when the LAST per-owner future
    completes (runs on a peer recv thread). Only cf.Futures support
    callbacks — native-transport handles never reach here (the native
    fast path is untraced by design)."""
    remaining = [len([f for f in futs if isinstance(f, cf.Future)])]
    lock = threading.Lock()
    if not remaining[0]:
        return

    def _done(_f):
        with lock:
            remaining[0] -= 1
            last = remaining[0] == 0
        if last:
            _trace.add_span(name, t0, time.time(), trace=tid,
                            args={"table": table})

    for f in futs:
        if isinstance(f, cf.Future):
            f.add_done_callback(_done)


def _attach_profile_end(futs: List, span) -> bool:
    """Close a step-profiler async span when the LAST per-owner future
    completes (runs on a peer recv thread) — the round-trip end the
    overlap-credit math needs. Returns False when ANY future lacks
    callback support (native-transport handles, including a mixed list):
    the caller then leaves the span open and the wait()/sweep fallback
    closes it."""
    if any(not isinstance(f, cf.Future) for f in futs):
        return False
    remaining = [len(futs)]
    if not remaining[0]:
        return False
    lock = threading.Lock()

    def _done(_f):
        with lock:
            remaining[0] -= 1
            last = remaining[0] == 0
        if last:
            span.end()

    for f in futs:
        f.add_done_callback(_done)
    return True


class _RetainedFrame:
    """One replay-retained window frame: everything needed to put the
    EXACT frame back on the wire (same sequence stamp, meta and blobs)
    plus the waiter futures its eventual ack fans out to."""

    __slots__ = ("owner", "seq", "msg_type", "meta", "arrays", "gfuts",
                 "acked", "needs_send", "created", "attempts",
                 "retry_since", "episode_attempts")

    def __init__(self, owner: int, seq: int, msg_type: int, meta: Dict,
                 arrays, gfuts):
        self.owner, self.seq = owner, seq
        self.msg_type, self.meta, self.arrays = msg_type, meta, arrays
        self.gfuts = gfuts
        self.acked = False
        self.needs_send = False
        self.created = time.monotonic()
        self.attempts = 0
        # when this frame ENTERED its current replay episode (first failed
        # attempt or owner-death re-arm); None = not replaying.
        # ps_replay_timeout bounds time spent RETRYING, measured from here
        self.retry_since: Optional[float] = None
        # failed attempts within the current episode: the exponent of the
        # shared capped-exponential backoff (utils/retry.py)
        self.episode_attempts = 0


def _replay_backoff() -> _retry.Backoff:
    """The replay plane's instance of the shared retry policy: base
    ``ps_replay_backoff``, capped at ``ps_replay_backoff_cap``, jittered
    so a fleet of clients re-arming off one death de-synchronizes."""
    base = config.get_flag("ps_replay_backoff")
    return _retry.Backoff(
        base_s=base,
        cap_s=max(config.get_flag("ps_replay_backoff_cap"), base),
        jitter=0.25)


class _ReplayBuffer:
    """Client half of exactly-once send-window replay (flag
    ``ps_replay``): per-owner monotonic frame sequences, the
    retained-frame log and the replay schedule.

    Every windowed frame is stamped with (client id, per-owner seq) and
    RETAINED past its ack until the owning shard reports it durable (the
    reply's ``dseq`` floor, advanced by the failover checkpointer). On a
    peer death the whole retained tail for that owner re-arms and the
    flusher re-flushes it, oldest first, to whatever incarnation the
    rendezvous resolves next: the restored shard's sequence channels ack
    the already-checkpointed prefix as duplicates and apply the rest."""

    # per-process window nonce: a re-created same-named table must get a
    # FRESH sequence channel on the shard — reusing (rank, pid) alone
    # would restart next_seq at 0 under the old channel's floor and the
    # shard would dedupe every fresh frame as already applied
    _nonce = itertools.count()

    def __init__(self, table):
        self.client_id = (f"r{table.ctx.rank}.{os.getpid()}"
                          f".{next(self._nonce)}")
        self.lock = threading.Lock()
        self.next_seq: Dict[int, int] = {}
        # owner -> seq -> frame, insertion (= seq) order
        self.retained: Dict[int, "collections.OrderedDict[int, _RetainedFrame]"] = {}
        # owner -> count of frames awaiting (re-)send; > 0 blocks direct
        # dispatch of NEW frames so the wire order stays the seq order
        self.pending_send: Dict[int, int] = {}
        # owner -> monotonic deadline of the next replay attempt
        self.next_due: Dict[int, float] = {}
        base = f"table[{table.name}].replay"
        self.mon_replayed = Dashboard.get(base + ".frames")
        self.mon_dups = Dashboard.get(base + ".dups")
        self.mon_dropped = Dashboard.get(base + ".dropped")

    def soonest_due(self) -> Optional[float]:
        with self.lock:
            return min(self.next_due.values()) if self.next_due else None


class _SendWindow:
    """Client-side cross-call add coalescer (the PS *send window*), one
    per windowed table: ``add_rows_async`` enqueues per-owner entries and
    returns at once; a time/byte/op-bounded flusher ships each owner's
    pending adds as ONE frame — a plain MSG_ADD_ROWS when the whole
    window merged into one op, a MSG_BATCH multi-op frame otherwise — so
    a window costs one round trip and one batched shard apply.

    Exactness: queued entries merge into one sub-op ONLY when the merge
    is bit-transparent — same AddOption (unless the updater never reads
    it), pairwise-disjoint row sets, an elementwise wire ("none" or
    "bf16") and a row-local-state updater (``updaters.ROW_LOCAL_STATE``;
    Adam's step counter advances once per apply, so Adam never merges).
    Everything else stays its own sub-op, and the shard applies the
    sub-ops in order as conflict-free waves
    (``shard._apply_batch_adds``). Windowed results therefore equal
    window-off results bit for bit.

    Ordering: each owner's frames leave in enqueue order on the owner's
    conn — senders serialize on a per-owner SEND lock, taken before the
    queue is popped, so a later sender always ships a later batch — and
    the window lock is never held across a socket send, so an enqueue
    never blocks behind a flush. A caller that fences
    (:meth:`flush_pending`) and then issues a get on the same conn reads
    its own writes (the conn's FIFO does the rest); the fence does not
    wait for acks.

    Replay (flag ``ps_replay``): frames are stamped, retained past their
    ack until the owner reports them durable, and re-flushed in sequence
    order when the owner dies. While an owner's retained tail awaits
    replay, fresh frames to it queue behind (seq order IS wire order)
    and their futures stay pending until the restored incarnation acks
    them; the fence then means "queued or retained", and
    read-your-writes on that owner degrades to eventual until the
    replay drains."""

    # idle condvar waits are bounded so the flusher notices its window
    # died (see _window_loop's weakref)
    _IDLE_WAIT_S = 5.0

    def __init__(self, table, window_ms: float, max_bytes: int,
                 max_ops: int):
        # weak: the table owns the window, not the other way round
        self._table_ref = weakref.ref(table)
        self._table_name = table.name
        self.window_s = float(window_ms) / 1e3
        self.max_bytes = int(max_bytes)
        self.max_ops = int(max_ops)
        self._cv = threading.Condition()
        # owner -> [(ids, vals, opt, placeholder future, trace id,
        # tenant id)], enqueue order
        self._pending: Dict[int, List[Tuple]] = {}
        self._nbytes: Dict[int, int] = {}
        # per-tenant add budgets (flag tenant_add_qps): tenant -> bucket
        self._tenant_buckets: Dict[str, Any] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._deadline: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        base = f"table[{table.name}].add_rows"
        self._mon_windowed = Dashboard.get(base + ".windowed")
        self._mon_flushes = Dashboard.get(base + ".flushes")
        self._mon_merged = Dashboard.get(base + ".merged_rows")
        # memory ledger: pending window payloads + the replay retention
        # tail (registration only; gauges are pull-time)
        _memstats.register(f"window[{table.name}]", self)
        # exactly-once replay: stamped, retained, re-flushed frames. The
        # peer-death hook is weakref-bound — the service's hook list
        # outlives any one table and must not pin it
        self._replay: Optional[_ReplayBuffer] = None
        if config.get_flag("ps_replay"):
            self._replay = _ReplayBuffer(table)
            wref = weakref.ref(self)

            def _death(rank: int, _w=wref) -> None:
                w = _w()
                if w is not None:
                    w._on_owner_death(rank)

            table.ctx.service.add_death_hook(_death)

    # ------------------------------------------------------------------ #
    def submit(self, parts: List[Tuple[int, np.ndarray, np.ndarray]],
               opt: AddOption,
               trace: Optional[int] = None,
               tenant: Optional[str] = None) -> List[cf.Future]:
        """Queue ONE logical add's per-owner pieces; returns one
        placeholder future per owner (completed by the window ack).
        ``trace`` is the logical op's trace ID (telemetry/trace.py); it
        rides every per-owner entry into the frame meta, as does the
        resolved ``tenant`` (wire.TENANT_META_KEY; None = default)."""
        self._mon_windowed.incr()
        if tenant is not None:
            self._note_tenant_budget(tenant)
        return [self._enqueue(r, ids, vals, opt, trace, tenant)
                for r, ids, vals in parts]

    def _note_tenant_budget(self, tn: str) -> None:
        """Per-(table, tenant) add budget (flag ``tenant_add_qps``):
        train writes are never dropped — an over-budget windowed add is
        COUNTED as deferred in the tenant ledger (the noisy-neighbor
        sweep's write-plane evidence) and still ships."""
        qps = config.get_flag("tenant_add_qps")
        if qps <= 0:
            return
        b = self._tenant_buckets.get(tn)
        if b is None or b.rate != qps:
            from multiverso_tpu_torch.serving.admission import TokenBucket
            b = self._tenant_buckets[tn] = TokenBucket(qps)
        if not b.try_acquire(1.0):
            _tenants.LEDGER.note_deferred(self._table_name, tn)

    def _enqueue(self, owner: int, ids: np.ndarray, vals: np.ndarray,
                 opt: AddOption, trace: Optional[int] = None,
                 tn: Optional[str] = None) -> cf.Future:
        fut: cf.Future = cf.Future()
        ship = False
        # black box: the enqueue edge (one ring write)
        _flight.record(_flight.EV_WIN_ENQ, peer=owner,
                       nbytes=ids.nbytes + vals.nbytes)
        with self._cv:
            q = self._pending.setdefault(owner, [])
            q.append((ids, vals, opt, fut, trace, tn))
            self._nbytes[owner] = (self._nbytes.get(owner, 0)
                                   + ids.nbytes + vals.nbytes)
            if (len(q) >= self.max_ops
                    or self._nbytes[owner] >= self.max_bytes):
                ship = True   # bound hit: ship now, on this thread
            elif self._deadline is None:
                # arm the window and wake the flusher only then (a notify
                # per enqueue would cost a thread wakeup per small add)
                self._deadline = time.monotonic() + self.window_s
                self._ensure_flusher_locked()
                self._cv.notify()
        if ship:
            self._flush_owner(owner)
        return fut

    def flush_pending(self) -> None:
        """Send every queued add NOW — the fence that gets, flush and
        overwrites run before dispatching their own frames. On return,
        every entry queued before the call is on its conn. The sweep
        covers every owner ever sent to, not only those pending: a
        concurrent flusher may have popped an owner's queue but not yet
        reached the socket, and taking the owner's send lock waits that
        send out."""
        with self._cv:
            owners = set(self._pending) | set(self._send_locks)
            self._deadline = None
        self._flush_owners(owners)

    def memory_stats(self) -> Dict[str, Any]:
        """Byte-ledger gauges (telemetry/memstats.py, pull-only): queued
        window payloads awaiting flush, and the replay plane's retained
        frames — per owner and total, with how many are ARMED for re-send
        (armed > 0 means the owner is dead or being failed over, which
        the retention-leak verdict treats as failover working, not
        hoarding). Bytes are the frames' wire blobs."""
        with self._cv:
            pending_ops = sum(len(q) for q in self._pending.values())
            pending_bytes = sum(self._nbytes.values())
        out: Dict[str, Any] = {
            "pending_ops": int(pending_ops),
            "pending_bytes": int(pending_bytes),
            "retained_frames": 0, "retained_bytes": 0,
            "armed_frames": 0,
        }
        rp = self._replay
        if rp is None:
            return out

        def _nb(a) -> int:
            nb = getattr(a, "nbytes", None)
            return int(nb) if nb is not None else len(a)

        owners: Dict[str, Dict[str, int]] = {}
        with rp.lock:
            for owner, q in rp.retained.items():
                fb = sum(sum(_nb(a) for a in fr.arrays)
                         for fr in q.values())
                # armed PER OWNER: one dead owner's re-armed tail must not
                # mask another live owner's unpruned hoard
                owners[str(owner)] = {
                    "retained_frames": len(q),
                    "retained_bytes": int(fb),
                    "armed_frames": max(
                        int(rp.pending_send.get(owner, 0)), 0)}
                out["retained_frames"] += len(q)
                out["retained_bytes"] += int(fb)
            out["armed_frames"] = sum(max(int(n), 0)
                                      for n in rp.pending_send.values())
        if owners:
            out["owners"] = owners
        return out

    def _ensure_flusher_locked(self) -> None:
        """Start (or restart) the flusher thread; caller holds ``_cv``.
        Shared by the enqueue path and the replay plane: a replay-armed
        window with no fresh enqueues still needs the thread to drive
        retries."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=_window_loop, args=(weakref.ref(self),),
                daemon=True, name=f"ps-window-{self._table_name}")
            self._thread.start()

    def _step(self) -> bool:
        """One flusher cycle: wait out the open window (or idle, bounded),
        then ship everything pending; with replay armed, the wait also
        bounds to the soonest replay deadline and every cycle drives due
        replays."""
        owners: List[int] = []
        rp = self._replay
        with self._cv:
            bound = self._IDLE_WAIT_S
            now = time.monotonic()
            nd = rp.soonest_due() if rp is not None else None
            if nd is not None:
                bound = min(bound, max(nd - now, 0.005))
            if self._deadline is not None:
                delay = self._deadline - now
                if delay <= 0:
                    self._deadline = None
                    owners = list(self._pending)
                else:
                    bound = min(bound, delay)
            if not owners and not (nd is not None and nd <= now):
                self._cv.wait(bound)
        # _replay_step runs OUTSIDE the cv hold: it takes owner send locks
        # (and its sends can block on a dead owner's sockets), while
        # senders holding those locks block on the cv to queue armed
        # frames — calling it under the cv would deadlock
        self._flush_owners(owners)
        return self._replay_step() or bool(owners)

    # ------------------------------------------------------------------ #
    def _send_lock(self, owner: int) -> threading.Lock:
        with self._cv:
            lock = self._send_locks.get(owner)
            if lock is None:
                lock = self._send_locks[owner] = threading.Lock()
            return lock

    # one flush pool shared by every window: per-owner flushes block only
    # on their owner's send lock and socket, so owners never deadlock
    _flush_pool: Optional[cf.ThreadPoolExecutor] = None
    _flush_pool_lock = threading.Lock()

    @classmethod
    def _flush_executor(cls) -> cf.ThreadPoolExecutor:
        with cls._flush_pool_lock:
            if cls._flush_pool is None:
                cls._flush_pool = cf.ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="ps-flush")
            return cls._flush_pool

    def _flush_owners(self, owners) -> None:
        """One multi-owner flush sweep: owners flush concurrently on the
        shared pool; the sweep returns only when every owner's batch is
        on its conn (the fence contract), then raises the first failure."""
        owners = sorted(owners)
        if len(owners) > 1:
            pool = self._flush_executor()
            futs = [pool.submit(self._flush_owner, o) for o in owners]
            cf.wait(futs)
            for f in futs:
                f.result()
        elif owners:
            self._flush_owner(owners[0])

    def _flush_owner(self, owner: int) -> None:
        """Merge and ship one owner's queue as one frame. The send lock is
        taken BEFORE popping, so concurrent senders to one owner serialize
        pop-and-send as a unit; the window lock is only held for the pop."""
        with self._send_lock(owner):
            with self._cv:
                entries = self._pending.pop(owner, None)
                self._nbytes.pop(owner, None)
            if entries:
                self._send(owner, entries)

    def _send(self, owner: int, entries: List[Tuple]) -> None:
        t = self._table_ref()
        if t is None:
            # the table was dropped with adds queued: fail their futures
            # so any stray holder sees a typed error, not a hang
            err = svc.PSError(
                f"table[{self._table_name}] was garbage-collected with "
                "windowed adds still queued")
            for _, _, _, fut, _, _ in entries:
                if not fut.done():
                    fut.set_exception(err)
            return
        traced = _trace.enabled()
        t_flush0 = time.time() if traced else 0.0
        # flush edge: per flush (not per add), so the note's f-string is
        # off the hot path
        _flight.record(_flight.EV_WIN_FLUSH, peer=owner,
                       nbytes=sum(e[0].nbytes + e[1].nbytes
                                  for e in entries),
                       note=f"ops={len(entries)}")
        w = t._wire_for(owner)
        # merging conditions, ALL required for bit-transparency: an
        # elementwise wire (1bit/topk mix values across their block or
        # top-k structure), disjoint row sets, a row-local-state updater,
        # and matching AddOptions (unless the updater never reads them)
        exact = (w in ("none", "bf16")
                 and type(t.updater) in updaters_lib.ROW_LOCAL_STATE)
        merge_all = type(t.updater) in updaters_lib.OPT_INSENSITIVE
        groups: List[List] = []   # [ids[], vals[], opt, futs[], idset,
        merged_rows = 0           #  traces[], tenant]
        for ids, vals, opt, fut, tid, tn in entries:
            g = groups[-1] if groups else None
            # tenants never blur: a merged sub-op is one attribution
            # record at the shard, so only same-tenant entries merge
            if (g is not None and exact
                    and (merge_all or opt == g[2])
                    and tn == g[6]
                    and not g[4].intersection(ids.tolist())):
                g[0].append(ids)
                g[1].append(vals)
                g[3].append(fut)
                g[4].update(ids.tolist())
                if tid is not None:
                    g[5].append(tid)
                merged_rows += int(ids.size)
            else:
                groups.append([[ids], [vals], opt, [fut],
                               set(ids.tolist()),
                               [] if tid is None else [tid], tn])
        try:
            packed = [(np.concatenate(g[0]) if len(g[0]) > 1 else g[0][0],
                       np.concatenate(g[1]) if len(g[1]) > 1 else g[1][0],
                       g[2], g[5], g[6]) for g in groups]
        except Exception as e:   # a merge failure must not orphan waiters
            # close the flush edge too: an unmatched win.flush in a dump
            # is the wedged-window signature, and this one failed fast
            _flight.record(_flight.EV_WIN_FLUSH_END, peer=owner,
                           note=f"merge failed: {e}"[:120])
            for g in groups:
                for f in g[3]:
                    if not f.done():
                        f.set_exception(e)
            return
        def sub_meta(opt, tids, tn):
            """Per-sub-op meta: the cached packed bytes normally; a dict
            carrying the trace ID (wire.TRACE_META_KEY) and/or tenant
            (wire.TENANT_META_KEY) when stamped — a merged group's FIRST
            ID names the sub-op, the full set rides the client flush/ack
            spans."""
            if not tids and tn is None:
                return t._add_meta_b(opt, w)
            meta = {"table": t.name, "opt": opt._asdict()}
            if w != "none":
                meta["wire"] = w
            if tids:
                meta[wire_mod.TRACE_META_KEY] = tids[0]
            if tn is not None:
                meta[wire_mod.TENANT_META_KEY] = tn
            return meta

        all_tids = [tid for g in groups for tid in g[5]]
        # a window can outgrow one frame: ship MAX_BATCH_OPS sub-ops a
        # frame, in order on the same conn
        for i0 in range(0, len(packed), wire_mod.MAX_BATCH_OPS):
            chunk = packed[i0:i0 + wire_mod.MAX_BATCH_OPS]
            gfuts = [g[3] for g in groups[i0:i0 + wire_mod.MAX_BATCH_OPS]]
            try:
                if len(chunk) == 1:
                    ids, vals, opt, tids, tn = chunk[0]
                    meta = {"table": t.name, "opt": opt._asdict()}
                    if w != "none":
                        meta["wire"] = w
                    if tids:
                        meta[wire_mod.TRACE_META_KEY] = tids[0]
                    if tn is not None:
                        meta[wire_mod.TENANT_META_KEY] = tn
                    msg_type = svc.MSG_ADD_ROWS
                    arrays = [ids] + wire_mod.encode_payload(vals, w)
                    meta_b = (None if tids or tn is not None
                              or self._replay is not None
                              else t._add_meta_b(opt, w))
                else:
                    blobs = [wire_mod.encode(
                        svc.MSG_ADD_ROWS, i, sub_meta(opt, tids, tn),
                        [ids] + wire_mod.encode_payload(vals, w))
                        for i, (ids, vals, opt, tids, tn)
                        in enumerate(chunk)]
                    msg_type = svc.MSG_BATCH
                    meta = {"table": t.name, "n": len(chunk)}
                    arrays = wire_mod.pack_batch(blobs)
                    meta_b = None
            except Exception as e:   # an encode failure must not orphan
                for fs in gfuts:     # waiters
                    for f in fs:
                        if not f.done():
                            f.set_exception(e)
                continue
            self._mon_flushes.incr()
            if self._replay is not None:
                # stamped, retained dispatch: the ack callback, retention
                # pruning and peer-death replay live in _frame_done
                self._dispatch_retained(t, owner, msg_type, meta, arrays,
                                        gfuts)
                continue
            req = t.ctx.service.request(owner, msg_type, meta, arrays,
                                        meta_b=meta_b)
            if traced and all_tids:
                # ack span: frame on the wire -> window ack fanned out
                # (runs on the peer's recv thread)
                t_send = time.time()
                chunk_tids = [tid for (_, _, _, tids, _) in chunk
                              for tid in tids]

                def _done(bf, gf=gfuts, ts=t_send, ct=chunk_tids):
                    _complete_window_futures(bf, gf, owner=owner)
                    _trace.add_span(
                        "window.ack", ts, time.time(),
                        trace=ct[0] if ct else None,
                        args={"owner": owner, "traces": ct})

                req.add_done_callback(_done)
            else:
                req.add_done_callback(
                    lambda bf, gf=gfuts:
                        _complete_window_futures(bf, gf, owner=owner))
        _flight.record(
            _flight.EV_WIN_FLUSH_END, peer=owner,
            note=f"frames={-(-len(packed) // wire_mod.MAX_BATCH_OPS)}")
        if merged_rows:
            self._mon_merged.incr(merged_rows)
        if traced and all_tids:
            nframes = -(-len(packed) // wire_mod.MAX_BATCH_OPS)  # frames
            _trace.add_span(
                "window.flush", t_flush0, time.time(),
                trace=all_tids[0],
                args={"owner": owner, "ops": len(entries),
                      "frames": nframes, "traces": all_tids})

    # ------------------------------------------------------------------ #
    # exactly-once replay plane (flag ps_replay)
    # ------------------------------------------------------------------ #
    def _dispatch_retained(self, t, owner: int, msg_type: int,
                           meta: Dict, arrays, gfuts) -> None:
        """Stamp one window frame with (client, per-owner seq), retain
        it, and put it on the wire — unless earlier frames to this owner
        await replay, in which case it queues behind them (seq order IS
        wire order: a new frame overtaking a replayed one could commit a
        later sequence first, and the shard would then treat the late
        arrival as the duplicate)."""
        rp = self._replay
        with rp.lock:
            seq = rp.next_seq.get(owner, 0)
            rp.next_seq[owner] = seq + 1
            meta = dict(meta)
            meta[wire_mod.REPLAY_CLIENT_KEY] = rp.client_id
            meta[wire_mod.REPLAY_SEQ_KEY] = seq
            fr = _RetainedFrame(owner, seq, msg_type, meta, arrays, gfuts)
            q = rp.retained.setdefault(owner, collections.OrderedDict())
            q[seq] = fr
            blocked = rp.pending_send.get(owner, 0) > 0
            if blocked:
                fr.needs_send = True
                rp.pending_send[owner] += 1
        if blocked:
            with self._cv:
                self._ensure_flusher_locked()
                self._cv.notify()
            return
        self._send_frame(t, fr)

    def _send_frame(self, t, fr: _RetainedFrame) -> None:
        fr.attempts += 1
        req = t.ctx.service.request(fr.owner, fr.msg_type, fr.meta,
                                    fr.arrays)
        req.add_done_callback(lambda bf, fr=fr: self._frame_done(bf, fr))

    def _frame_done(self, bf: cf.Future, fr: _RetainedFrame) -> None:
        """Outcome of one retained frame's latest wire attempt (the peer's
        recv thread, or inline for a failed-fast dispatch). A
        peer-unreachable failure inside the replay window does NOT fail
        the waiters — the frame re-arms, and they complete when it lands
        on a (possibly restored) incarnation; anything else — a shard
        error, or the replay window exhausted — completes them with the
        error, as the unreplayed path does."""
        rp = self._replay
        exc: Optional[BaseException] = None
        meta: Dict = {}
        try:
            exc = bf.exception()
            if exc is None:
                res = bf.result()
                if isinstance(res, tuple) and isinstance(res[0], dict):
                    meta = res[0]
        except (cf.CancelledError, Exception) as e:   # defensive
            exc = e
        if isinstance(exc, svc.PSPeerError):
            now = time.monotonic()
            if fr.retry_since is None:
                fr.retry_since = now
                fr.episode_attempts = 0
            if (now - fr.retry_since
                    <= config.get_flag("ps_replay_timeout")):
                with rp.lock:
                    if not fr.needs_send:
                        fr.needs_send = True
                        rp.pending_send[fr.owner] = (
                            rp.pending_send.get(fr.owner, 0) + 1)
                    # the delay never schedules past the episode's
                    # ps_replay_timeout budget
                    due = now + _replay_backoff().delay_s(
                        fr.episode_attempts,
                        deadline=fr.retry_since
                        + config.get_flag("ps_replay_timeout"))
                    fr.episode_attempts += 1
                    cur = rp.next_due.get(fr.owner)
                    if cur is None or due < cur:
                        rp.next_due[fr.owner] = due
                with self._cv:
                    self._ensure_flusher_locked()
                    self._cv.notify()
                return
        if meta.get(wire_mod.REPLAY_DUP_KEY):
            rp.mon_dups.incr()
        with rp.lock:
            q = rp.retained.get(fr.owner)
            if exc is None:
                fr.acked = True
                fr.retry_since = None
                fr.episode_attempts = 0
                if q is not None:
                    self._prune_owner_locked(
                        fr.owner,
                        int(meta.get(wire_mod.REPLAY_DURABLE_KEY, -1)))
            elif q is not None:
                # permanently failed: nothing left to replay. Drop the
                # frame, keeping the armed-frame invariant (pending_send
                # == count of needs_send frames; a stale positive count
                # would block every later frame to this owner forever)
                if fr.needs_send:
                    fr.needs_send = False
                    rp.pending_send[fr.owner] = max(
                        rp.pending_send.get(fr.owner, 0) - 1, 0)
                dropped_acked = all(f.done()
                                    for fs in fr.gfuts for f in fs)
                q.pop(fr.seq, None)
                if dropped_acked:
                    # the waiters already saw success: this IS a lost
                    # acked op, and it must be loud
                    log.error(
                        "table[%s]: replay of frame seq %d to owner %d "
                        "exhausted its window (%s); an ACKED op may be "
                        "lost", self._table_name, fr.seq, fr.owner, exc)
        _complete_window_futures(bf, fr.gfuts, owner=fr.owner)

    def _prune_owner_locked(self, owner: int, durable: int) -> None:
        """Drop retained frames the shard has made durable (caller holds
        ``rp.lock``), then enforce the retention cap: past it the oldest
        ACKED frames drop with a warning — durability degrades to
        ack-time instead of memory growing without bound when no
        checkpointer advances the durable floor."""
        rp = self._replay

        def _remove(seq: int) -> None:
            # keep the armed-frame invariant on EVERY removal path: a
            # frame can be re-armed by an owner death while its
            # (old-incarnation) success ack is in flight
            fr = q.pop(seq, None)
            if fr is not None and fr.needs_send:
                fr.needs_send = False
                rp.pending_send[owner] = max(
                    rp.pending_send.get(owner, 0) - 1, 0)

        q = rp.retained.get(owner)
        if not q:
            return
        # q is in seq order (frames are inserted under rp.lock with
        # increasing seq): only its head can be at or below the floor
        done = []
        for seq, f in q.items():
            if seq > durable:
                break
            if f.acked:
                done.append(seq)
        for seq in done:
            _remove(seq)
        cap = config.get_flag("ps_replay_max_frames")
        if len(q) > cap:
            drop = [s for s, f in q.items() if f.acked][: len(q) - cap]
            if drop:
                rp.mon_dropped.incr(len(drop))
                log.error(
                    "table[%s]: replay retention cap (%d) dropped %d acked "
                    "frames for owner %d — they are durable only to "
                    "ack-time (is the failover checkpointer running?)",
                    self._table_name, cap, len(drop), owner)
                for seq in drop:
                    _remove(seq)

    def _on_owner_death(self, rank: int) -> None:
        """Peer-death hook: the owner may come back restored from a
        checkpoint missing the tail of what it acked — re-arm EVERY
        retained frame (acked ones too) for re-flush in seq order; the
        restored incarnation's sequence channels ack the prefix its
        checkpoint holds as duplicates and apply only the lost tail."""
        rp = self._replay
        if rp is None:
            return
        now = time.monotonic()
        with rp.lock:
            q = rp.retained.get(rank)
            if not q:
                return
            armed = 0
            for fr in q.values():
                fr.acked = False
                if fr.retry_since is None:
                    fr.retry_since = now
                    fr.episode_attempts = 0
                if not fr.needs_send:
                    fr.needs_send = True
                    armed += 1
            if armed:
                rp.pending_send[rank] = (rp.pending_send.get(rank, 0)
                                         + armed)
            # episode start: the FIRST re-flush is quick (attempt 0 of the
            # shared policy); later failures grow the delay per frame
            rp.next_due[rank] = (time.monotonic()
                                 + _replay_backoff().delay_s(0))
            n = len(q)
        _flight.record(_flight.EV_FAILOVER_REPLAY, peer=rank,
                       note=f"owner died: {n} frames re-armed")
        with self._cv:
            self._ensure_flusher_locked()
            self._cv.notify()

    def _replay_step(self) -> bool:
        """Flusher-cycle half of the replay plane: re-flush every owner
        whose retry deadline passed."""
        rp = self._replay
        if rp is None:
            return False
        now = time.monotonic()
        with rp.lock:
            due = [o for o, t0 in rp.next_due.items() if now >= t0]
        did = False
        for owner in due:
            did = self._replay_owner(owner) or did
        return did

    def _replay_owner(self, owner: int) -> bool:
        """Re-flush one owner's armed frames, oldest first, under the
        owner's SEND lock (fresh flushes queue behind, so the conn sees
        strict seq order). Frames that fail again re-arm themselves in
        their _frame_done; frames landing on a restored incarnation
        dedupe at the shard."""
        rp = self._replay
        t = self._table_ref()
        with self._send_lock(owner):
            with rp.lock:
                rp.next_due.pop(owner, None)
                q = rp.retained.get(owner)
                frames = ([f for f in q.values() if f.needs_send]
                          if q else [])
                for f in frames:
                    f.needs_send = False
                if frames:
                    rp.pending_send[owner] = max(
                        rp.pending_send.get(owner, 0) - len(frames), 0)
            if not frames:
                return False
            if t is None:
                err = svc.PSError(
                    f"table[{self._table_name}] was garbage-collected "
                    "with frames awaiting replay")
                with rp.lock:
                    for f in frames:
                        if q is not None:
                            q.pop(f.seq, None)
                for f in frames:
                    for fut in (x for fs in f.gfuts for x in fs):
                        if not fut.done():
                            fut.set_exception(err)
                return True
            rp.mon_replayed.incr(len(frames))
            _flight.record(_flight.EV_FAILOVER_REPLAY, peer=owner,
                           note=f"re-flush {len(frames)} frames")
            for fr in frames:
                self._send_frame(t, fr)
        return True


def _chunk_scatter(buf: np.ndarray, idx: Optional[np.ndarray],
                   ncol: int, dtype):
    """Sink for a chunk-streamed get reply: decode each sub-frame as it
    lands on the peer's recv thread and scatter it into ``buf`` (at
    ``idx[row0:row0+rows]`` for a row subset, contiguously otherwise)."""
    def sink(cmeta, arrays):
        a, k = int(cmeta["row0"]), int(cmeta["rows"])
        rows = wire_mod.decode_payload(arrays, cmeta.get("wire", "none"),
                                       (k, ncol), dtype)
        if idx is None:
            buf[a:a + k] = rows
        else:
            buf[idx[a:a + k]] = rows
    return sink


class _GetWindow:
    """Client-side get coalescer (the read-path mirror of
    :class:`_SendWindow`), one per windowed table: concurrent
    ``get_rows_async`` calls dedupe overlapping row ids per owner into
    single-flight batched fetches.

    A get to an owner with NO fetch outstanding dispatches at once, so
    serial gets pay nothing for the window. Gets arriving while that
    owner's fetch is on the wire queue here; their ids dedupe into ONE
    follow-up frame, dispatched when the outstanding reply lands or when
    the oldest queued entry ages past ``get_window_ms`` (a 1-row get must
    not wait out a long chunked fetch). Each waiter's future resolves to
    ITS OWN rows, sliced from the batch reply, so N concurrent pullers
    cost one frame, one shard serve and one reply.

    Read-your-writes: every caller fences its send window before
    :meth:`fetch`, and a batch's frame reaches the conn only after the
    join, so the conn's FIFO orders the fetch behind the caller's adds.
    Batches are released only from the flusher thread, never from the
    peer's recv thread, where a socket send could block the very reply
    plane that completes fetches (with both TCP buffers full, a
    deadlock)."""

    _IDLE_WAIT_S = 5.0

    def __init__(self, table, window_ms: float):
        self._table_ref = weakref.ref(table)
        self._table_name = table.name
        self.window_s = float(window_ms) / 1e3
        self._cv = threading.Condition()
        # owner -> [(unique ids, waiter future)], join order
        self._queued: Dict[int, List[Tuple[np.ndarray, cf.Future]]] = {}
        self._q_t0: Dict[int, float] = {}
        self._inflight: Dict[int, int] = {}
        # batches a completed fetch released, for the flusher to dispatch
        self._ready: List[Tuple[int, List[Tuple]]] = []
        self._thread: Optional[threading.Thread] = None
        base = f"table[{table.name}].get_rows"
        self._mon_windowed = Dashboard.get(base + ".windowed")
        self._mon_fetches = Dashboard.get(base + ".fetches")
        self._mon_merged = Dashboard.get(base + ".merged_rows")

    def fetch(self, owner: int, ids: np.ndarray) -> cf.Future:
        """One caller's rows from ``owner`` (``ids`` unique, in the
        caller's order); resolves to the (len(ids), num_col) host block
        in that order."""
        fut: cf.Future = cf.Future()
        self._mon_windowed.incr()
        with self._cv:
            if self._inflight.get(owner, 0) > 0:
                q = self._queued.setdefault(owner, [])
                if not q:
                    self._q_t0[owner] = time.monotonic()
                q.append((ids, fut))
                self._ensure_thread_locked()
                self._cv.notify()
                return fut
            self._inflight[owner] = self._inflight.get(owner, 0) + 1
        self._dispatch(owner, [(ids, fut)])
        return fut

    def _ensure_thread_locked(self) -> None:
        """Start the flusher thread (caller holds ``_cv``)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=_window_loop, args=(weakref.ref(self),),
                daemon=True, name=f"ps-getwin-{self._table_name}")
            self._thread.start()

    def _step(self) -> bool:
        """One flusher cycle: dispatch the batches a completed fetch
        released, and queued batches whose oldest entry aged past the
        window."""
        with self._cv:
            batches, self._ready = self._ready, []
            if not batches and not self._q_t0:
                self._cv.wait(self._IDLE_WAIT_S)
                return False
            now = time.monotonic()
            due = [o for o, t0 in self._q_t0.items()
                   if now - t0 >= self.window_s]
            if not due and not batches:
                soonest = min(self._q_t0.values()) + self.window_s - now
                self._cv.wait(min(max(soonest, 0.001), self._IDLE_WAIT_S))
                return False
            for o in due:
                q = self._queued.pop(o, None)
                self._q_t0.pop(o, None)
                if q:
                    self._inflight[o] = self._inflight.get(o, 0) + 1
                    batches.append((o, q))
        for o, q in batches:
            self._dispatch(o, q)
        return True

    def _release(self, owner: int) -> None:
        """A fetch completed: drop its flight and hand whatever queued
        behind it to the FLUSHER as the next batch (this runs on the
        peer's recv thread, which must never send)."""
        with self._cv:
            self._inflight[owner] = max(self._inflight.get(owner, 1) - 1, 0)
            if self._inflight[owner] == 0:
                q = self._queued.pop(owner, None)
                self._q_t0.pop(owner, None)
                if q:
                    self._inflight[owner] = 1
                    self._ready.append((owner, q))
                    self._ensure_thread_locked()
                    self._cv.notify()

    def _dispatch(self, owner: int, entries: List[Tuple]) -> None:
        try:
            self._dispatch_inner(owner, entries)
        except Exception as e:   # noqa: BLE001 — waiters must never hang
            for _, fut in entries:
                if not fut.done():
                    fut.set_exception(e)
            self._release(owner)

    def _dispatch_inner(self, owner: int, entries: List[Tuple]) -> None:
        t = self._table_ref()
        if t is None:
            raise svc.PSError(
                f"table[{self._table_name}] was garbage-collected with "
                "coalesced gets still queued")
        if len(entries) == 1:
            # one waiter: its ids as they are, the reply is its block
            uids = entries[0][0]
        else:
            # a merged batch: the SORTED unique union, so each waiter's
            # ids resolve by searchsorted below
            cat = np.concatenate([ids for ids, _ in entries])
            uids = np.unique(cat)
            self._mon_merged.incr(int(cat.size - uids.size))
        gw = t._get_wire_for(owner)
        chunk = int(config.get_flag("get_chunk_rows"))
        buf = np.empty((uids.size, t.num_col), t.dtype)
        meta: Dict = {"table": t.name}
        if gw != "none":
            meta["wire"] = gw
        sink = None
        if chunk > 0 and uids.size > chunk and owner != t.ctx.rank:
            meta["chunk"] = chunk
            sink = _chunk_scatter(buf, None, t.num_col, t.dtype)
        _flight.record(_flight.EV_GET_WIN, peer=owner,
                       note=f"ops={len(entries)}")
        self._mon_fetches.incr()
        req = t.ctx.service.request(owner, svc.MSG_GET_ROWS, meta, [uids],
                                    chunk_sink=sink)
        chunked = sink is not None
        # the callback holds the window by weakref too: the peer's recv
        # loop may keep the last completed request (and its callbacks)
        # alive, which must not pin the window and its flusher thread
        wself = weakref.ref(self)

        def _done(bf, entries=entries, uids=uids, buf=buf, gw=gw,
                  ncol=t.num_col, dt=t.dtype):
            exc: Optional[BaseException] = None
            try:
                exc = bf.exception()
                if exc is None:
                    rmeta, arrays = bf.result()
                    if not (chunked and rmeta.get("chunks")):
                        buf[:] = wire_mod.decode_payload(
                            arrays, gw, (uids.size, ncol), dt)
            except (cf.CancelledError, Exception) as e:   # defensive
                exc = e
            try:
                for ids, fut in entries:
                    if fut.done():
                        continue
                    if exc is not None:
                        fut.set_exception(exc)
                    elif len(entries) == 1:
                        fut.set_result(buf)
                    else:
                        # each waiter's own rows, in ITS id order (a
                        # fancy-index copy)
                        fut.set_result(buf[np.searchsorted(uids, ids)])
            finally:
                # ALWAYS drop the flight: a slicing fault above fails this
                # batch, it must not wedge every later get
                win = wself()
                if win is not None:
                    win._release(owner)

        req.add_done_callback(_done)


def _part_len(ix) -> int:
    """Row count of an ``_owner_slices`` indexer (slice or positions)."""
    return ix.stop - ix.start if isinstance(ix, slice) else ix.size


def _part_index(ix) -> np.ndarray:
    """An ``_owner_slices`` indexer as explicit positions."""
    return (np.arange(ix.start, ix.stop) if isinstance(ix, slice)
            else ix)


def _owned_part(arr: np.ndarray, ix) -> np.ndarray:
    """``arr[ix]`` as OWNED bytes (the local rank's deferred dispatch
    reads the part later): a slice view gets an explicit copy."""
    part = arr[ix]
    return part.copy() if isinstance(ix, slice) else part


def _maybe_register_in_zoo(table) -> Optional[int]:
    """Async tables join the Zoo registry when the runtime is up;
    standalone PSContext tests run without a Zoo."""
    from multiverso_tpu_torch.zoo import Zoo
    zoo = Zoo.get()
    if zoo.started:
        return zoo.register_table(table)
    return None


class _AsyncBase:
    """msg-id -> futures bookkeeping shared by the async tables."""

    def __init__(self, ctx: Optional[svc.PSContext], name: str):
        self.ctx = ctx if ctx is not None else svc.default_context()
        self.name = name
        self.device = self.ctx.device
        self._pending: Dict[int, Tuple[List[cf.Future], Any]] = {}
        self._next_msg_id = 0
        self._lock = threading.Lock()
        self._meta_cache: Dict[Any, bytes] = {}
        # the client send window (flag batch_window_ms or the table's
        # send_window_ms=); None = every add ships at once (the default)
        self._window: Optional[_SendWindow] = None
        # failures of already-swept fire-and-forget ops, kept so flush()
        # surfaces them deterministically
        self._swept_failures: List[Exception] = []
        # msg id -> open step-profiler span of an op whose futures take
        # no callbacks (native handles): closed at wait() or the sweep
        self._prof_spans: Dict[int, Any] = {}

    def _wire_for(self, rank: int) -> str:
        """Wire codec per destination rank (tables with a compressed wire
        override; hash and KV tables always send raw)."""
        return "none"

    def _add_meta_b(self, opt: AddOption, wire: str = "none") -> bytes:
        """Packed add meta, cached per (AddOption, wire)."""
        key = (opt, wire)
        b = self._meta_cache.get(key)
        if b is None:
            meta = {"table": self.name, "opt": opt._asdict()}
            if wire != "none":
                meta["wire"] = wire
            b = wire_mod.pack_meta(meta)
            if len(self._meta_cache) < 64:
                self._meta_cache[key] = b
        return b

    def _make_window(self, send_window_ms: Optional[float]) -> None:
        """Install the send window when enabled (the table's
        ``send_window_ms`` wins over the batch_window_ms flag; <= 0 stays
        off)."""
        wm = (config.get_flag("batch_window_ms") if send_window_ms is None
              else float(send_window_ms))
        if wm > 0:
            self._window = _SendWindow(
                self, wm, config.get_flag("batch_window_bytes"),
                # the wire refuses frames over MAX_BATCH_OPS sub-ops
                min(config.get_flag("batch_window_ops"),
                    wire_mod.MAX_BATCH_OPS))

    def _flush_window(self) -> None:
        """Ordering fence: ship queued windowed adds before the caller
        dispatches an op that must observe them (no-op when the window
        is off or empty)."""
        if self._window is not None:
            self._window.flush_pending()

    # sweep trigger: under this many pending ops the scan of finished
    # fire-and-forget ops is deferred (flush() still surfaces failures)
    _SWEEP_THRESHOLD = 32

    def _track(self, futures: List[cf.Future], finalize=None,
               op: Optional[str] = None) -> int:
        with self._lock:
            # sweep fire-and-forget adds whose futures are all done; their
            # failures are LOGGED, not raised (a dead peer's stale error
            # must not poison later ops on live shards)
            done = ([mid for mid, (futs, fin) in self._pending.items()
                     if fin is None and all(f.done() for f in futs)]
                    if len(self._pending) >= self._SWEEP_THRESHOLD else ())
            for mid in done:
                futs, _ = self._pending.pop(mid)
                sp = self._prof_spans.pop(mid, None)
                if sp is not None:   # native-handle span: close at the
                    sp.end()         # sweep (its futures are all done)
                for f in futs:
                    exc = f.exception()
                    if exc is not None:
                        log.error("table[%s]: fire-and-forget op %d "
                                  "failed: %s", self.name, mid, exc)
                        if len(self._swept_failures) < 100:
                            self._swept_failures.append(exc)
            msg_id = self._next_msg_id
            self._next_msg_id += 1
            self._pending[msg_id] = (futures, finalize)
        # step-profiler async span (one attribute read when off): the
        # op's dispatch->reply interval, which the overlap-credit math
        # intersects with the compute phases. Reply callbacks close it at
        # the round-trip end; native handles (no callbacks) close it at
        # wait() or the sweep
        if op is not None and _profiler.PROFILER.enabled:
            span = _profiler.async_begin(op, attach="thread")
            if span is not None:
                if not _attach_profile_end(futures, span):
                    with self._lock:
                        # re-check under the lock: a concurrent sweep may
                        # have popped this msg id already
                        if msg_id in self._pending:
                            self._prof_spans[msg_id] = span
                        else:
                            span.end()
        return msg_id

    def wait(self, msg_id: int) -> Any:
        """Block until the op behind ``msg_id`` completes. For gets,
        returns the assembled host array; for adds, None. Raises
        :class:`~multiverso_tpu_torch.ps.service.PSPeerError` if an owning
        rank died — other tables/ops remain usable."""
        # the op may still be queued in the send window: ship it (its
        # placeholder futures complete on the window's ack)
        self._flush_window()
        return self._wait_tracked(msg_id)

    def _wait_tracked(self, msg_id: int) -> Any:
        """:meth:`wait` without the window fence, for callers that already
        fenced (flush waits many ops behind ONE fence)."""
        with self._lock:
            entry = self._pending.pop(msg_id, None)
            span = self._prof_spans.pop(msg_id, None)
        if entry is None:
            if span is not None:
                span.end()
            return None
        futures, finalize = entry
        timeout = config.get_flag("ps_timeout")
        try:
            results = [svc.await_reply(f, timeout,
                                       f"table[{self.name}] op {msg_id}")
                       for f in futures]
        finally:
            if span is not None:   # native-handle span: the reply is in
                span.end()         # by the time await_reply returned
        return finalize(results) if finalize is not None else None

    def flush(self) -> None:
        """Wait for every outstanding op on this table (this worker only —
        NOT a barrier). Raises the first failure of any fire-and-forget op
        issued since the last flush, pending or already swept."""
        self._flush_window()
        with self._lock:
            ids = list(self._pending)
        for mid in ids:
            self._wait_tracked(mid)
        with self._lock:
            failures, self._swept_failures = self._swept_failures, []
        if failures:
            raise failures[0]

    def server_stats(self, rank: Optional[int] = None) -> Dict:
        """Remote dashboard (MSG_STATS) of ``rank`` (None = this rank,
        without the socket); this table's shard is
        ``server_stats(r)["shards"][self.name]``."""
        return self.ctx.service.stats(
            self.ctx.rank if rank is None else int(rank))

    def server_health(self, rank: Optional[int] = None) -> Dict:
        """Liveness probe (MSG_HEALTH) of ``rank``; a dead rank raises
        :class:`~multiverso_tpu_torch.ps.service.PSPeerError`."""
        return self.ctx.service.health(
            self.ctx.rank if rank is None else int(rank))


class AsyncMatrixTable(_AsyncBase):
    """Row-partitioned 2-D async table (ref MatrixTable in async mode)."""

    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "async_matrix",
                 init: Optional[np.ndarray] = None,
                 seed: Optional[int] = None, init_scale: float = 0.0,
                 shard_workers: int = 0, wire: str = "none",
                 send_window_ms: Optional[float] = None,
                 get_window_ms: Optional[float] = None,
                 ctx: Optional[svc.PSContext] = None):
        """``shard_workers > 0`` enables per-worker dirty bits on the owned
        shard (the sparse stale-row protocol). ``wire="bf16"`` sends
        payloads over TCP as bfloat16; ``"1bit"``/``"topk"`` send
        whole-table add deltas with per-owner error feedback, row adds as
        stateless codec payloads, and get replies as bf16. The local rank
        never compresses (no socket to save).

        ``send_window_ms`` overrides the ``batch_window_ms`` flag for this
        table: > 0 buffers ``add_rows_async`` on the client and ships each
        owner's queue as one (multi-op) frame (:class:`_SendWindow`).
        ``get_window_ms`` overrides the ``get_window_ms`` flag: > 0 merges
        concurrent gets into single-flight per-owner fetches
        (:class:`_GetWindow`). Values are unchanged either way."""
        super().__init__(ctx, name)
        if wire not in ("none", "bf16", "1bit", "topk"):
            raise ValueError(f"unknown wire {wire!r}")
        self._wire = wire
        # per-owner error-feedback residuals for 1bit/topk whole-table
        # adds; the lock serializes the encode (filter_in reads AND
        # writes the residual)
        self._add_filters: Dict[int, Any] = {}
        self._add_filter_lock = threading.Lock()
        self.num_row, self.num_col = int(num_row), int(num_col)
        self.shape = (self.num_row, self.num_col)
        self.dtype = np.dtype(dtype)
        world = self.ctx.world
        self._rows_per = -(-self.num_row // world)   # ceil
        self.updater = _resolve_updater(updater, world, self.dtype)
        lo = min(self.ctx.rank * self._rows_per, self.num_row)
        hi = min(lo + self._rows_per, self.num_row)
        self.lo, self.hi = lo, hi
        if hi > lo:
            shard_init = (np.asarray(init, self.dtype)[lo:hi]
                          if init is not None else None)
            self._shard = RowShard(lo, hi, self.num_col, self.dtype,
                                   self.updater, name, init=shard_init,
                                   seed=seed, init_scale=init_scale,
                                   num_workers=shard_workers,
                                   device=self.device)
            self.ctx.service.register_handler(name, self._shard.handle,
                                              shard=self._shard)
        else:
            self._shard = None
        # client-side native transport eligibility: plain wire, no sparse
        # stale-row protocol (its dirty-bit ordering relies on the python
        # conn's FIFO), a dtype the C++ side frames. The server side needs
        # no agreement — a python peer speaks the same wire.
        self._native_ok = (wire == "none" and shard_workers == 0
                           and self.dtype.str in ("<f4", "<f8")
                           and self.ctx.service.native_enabled())
        self._plain_meta_b = wire_mod.pack_meta({"table": self.name})
        # identical on every rank: (rank, lo, hi) of each non-empty shard
        self._ranges = [(r, min(r * self._rows_per, self.num_row),
                         min((r + 1) * self._rows_per, self.num_row))
                        for r in range(world)]
        self._ranges = [(r, a, b) for r, a, b in self._ranges if b > a]
        self._make_window(send_window_ms)
        # the client get coalescer (flag get_window_ms or the table's
        # get_window_ms=); None = every get is its own frame (the default)
        self._get_window: Optional[_GetWindow] = None
        gm = (config.get_flag("get_window_ms") if get_window_ms is None
              else float(get_window_ms))
        if gm > 0:
            self._get_window = _GetWindow(self, gm)
        if self._window is not None or self._get_window is not None:
            # windowed adds and coalesced gets ride the python conns; every
            # other op must share that per-conn FIFO for the fences to
            # mean read-your-writes, so the native fast path (its own
            # socket: no cross-plane ordering) stays off for this table
            self._native_ok = False
        # hot-row TRAINING cache (flag train_cache_rows) on the client's
        # device: write-through is bit-exact only when the local push
        # delta IS what the shard applies (plain-add updater, lossless
        # wire, no sparse dirty-bit protocol, and no window: the send
        # window may merge two queued deltas into one summed add, and the
        # get window may queue a cold fetch behind an in-flight one, so
        # dispatch order is no longer the conn's order)
        self._train_cache = _hotcache.make_train_cache(
            name, self.num_col, self.dtype,
            writethrough_ok=(wire == "none" and shard_workers == 0
                             and self._window is None
                             and self._get_window is None
                             and getattr(self.updater, "name", "")
                             == "default"),
            device=self.device)
        # cache/dispatch ordering lock: the cache's push log must order
        # pushes vs get dispatch exactly as the conn FIFO does
        self._tc_order = (threading.Lock()
                          if self._train_cache is not None else None)
        self.table_id = _maybe_register_in_zoo(self)

    # ------------------------------------------------------------------ #
    # hot-row training cache (serving/hotcache.TrainRowCache)
    # ------------------------------------------------------------------ #
    def train_cache_stats(self) -> Optional[Dict]:
        """Hit/miss/occupancy of the training cache (None when off)."""
        tc = self._train_cache
        return None if tc is None else tc.stats()

    def _tc_ordered(self):
        return (self._tc_order if self._tc_order is not None
                else contextlib.nullcontext())

    def train_cache_device_block(self, row_ids, bucket: int):
        """Serve ``row_ids`` as a zero-padded ``(bucket, num_col)`` block
        on the client's device from the training cache's mirror. None
        unless the cache is on and EVERY id is cached."""
        tc = self._train_cache
        if tc is None:
            return None
        return tc.device_block_counted(row_ids, bucket)

    # ------------------------------------------------------------------ #
    def raw(self):
        """Local shard's data tensor (diagnostics)."""
        return self._shard._data if self._shard is not None else None

    def _prep(self, row_ids, values: Optional[np.ndarray] = None):
        return _dedupe_batch(row_ids, self.num_col, self.dtype,
                             self.num_row, values)

    def _owner_slices(self, uids: np.ndarray) -> List[Tuple[int, Any]]:
        """Partition an id batch into per-owner ``(rank, indexer)`` parts:
        sorted batches get ONE boundary ``searchsorted`` pass and
        contiguous ``slice`` indexers; caller-ordered batches get
        per-owner position arrays."""
        n = uids.size
        if n == 0:
            return []
        rp = self._rows_per
        first = int(uids[0]) // rp
        last = int(uids[-1]) // rp
        if (first <= last
                and (n == 1 or bool(np.all(uids[1:] >= uids[:-1])))):
            if first == last:
                return [(first, slice(0, n))]
            bounds = np.searchsorted(
                uids,
                np.arange(first + 1, last + 1, dtype=np.int64) * rp)
            starts = [0] + [int(b) for b in bounds] + [n]
            return [(r, slice(starts[i], starts[i + 1]))
                    for i, r in enumerate(range(first, last + 1))
                    if starts[i + 1] > starts[i]]
        owners = uids // rp
        r0 = int(owners[0])
        if not np.any(owners != r0):
            return [(r0, slice(0, n))]
        return [(int(r), np.flatnonzero(owners == r))
                for r in np.unique(owners)]

    def _by_owner(self, uids: np.ndarray):
        """Mask-shaped wrapper over :meth:`_owner_slices`."""
        n = uids.size
        for r, ix in self._owner_slices(uids):
            m = np.zeros(n, bool)
            m[ix] = True
            yield r, m

    def _wire_for(self, rank: int) -> str:
        """Wire codec per destination: the local rank short-circuits the
        socket, so its payload stays uncompressed."""
        return "none" if rank == self.ctx.rank else self._wire

    def _owner_conns(self, uids: np.ndarray):
        """Native conns for the C-side fan-out, indexed by rank. ONLY the
        ranks that own rows of THIS batch are resolved (a down rank that
        owns nothing must not cost unrelated ops its connect timeout, and
        a single-owner batch must not open world-many sockets); the rest
        stay None, which the fan-out reads as no rows/unreachable."""
        svc_ = self.ctx.service
        conns = [None] * self.ctx.world
        for r, _sl in self._owner_slices(uids):
            conns[r] = svc_.native_conn_or_none(r)
        return conns

    def _native_flush(self) -> None:
        """Order fence before python-conn ops that must observe earlier
        native adds (set_rows): wait for every add issued on this
        service's native conns. Failures are swallowed here — they
        surface deterministically through the ops' own futures."""
        if not self._native_ok:
            return
        timeout = config.get_flag("ps_timeout")
        for c in self.ctx.service.native_conns():
            if c.dead():
                continue
            seq = c.adds_issued()   # read under the C issue lock: cannot
            if seq:                 # lag a completed add on any thread
                try:
                    c.wait_adds(seq, timeout)
                except Exception:   # noqa: BLE001
                    pass

    def _reply_wire(self) -> str:
        """Reply wire for gets: 1bit/topk apply to DELTAS; parameter
        values ride bf16 instead."""
        return "bf16" if self._wire in ("1bit", "topk") else self._wire

    def _get_wire_for(self, rank: int) -> str:
        return "none" if rank == self.ctx.rank else self._reply_wire()

    # ------------------------------------------------------------------ #
    # row ops
    # ------------------------------------------------------------------ #
    def add_rows_async(self, row_ids, values,
                       opt: Optional[AddOption] = None) -> int:
        opt = opt or AddOption(worker_id=self.ctx.rank)
        with monitor(f"table[{self.name}].add_rows"), self._tc_ordered():
            uids, vals, _ = self._prep(row_ids, values)
            if self._train_cache is not None:
                # AT DISPATCH, before any transport: the cache sees this
                # push at the same point in program order the conn FIFO
                # will (write-through applies the exact deduped delta)
                self._train_cache.on_push(uids, vals)
            # per-request trace ID (telemetry/trace.py): rides the frame
            # meta so client spans and the owning shard's spans stitch by
            # ID; None (the default) costs one attribute read. The native
            # fan-out stays untraced by design
            tid = _trace.new_id() if _trace.enabled() else None
            # effective tenant (telemetry/tenants.py): None for the
            # default tenant, so default traffic keeps the cached meta
            # bytes and the native fast path; a named tenant stamps
            # TENANT_META_KEY on every frame (the C++ server punts it)
            tn = _tenants.current()
            if self._window is not None:
                # send window: enqueue the per-owner pieces and return;
                # the flusher (or the next fencing op) ships each owner's
                # queue as ONE frame
                t_enq0 = time.time() if tid is not None else 0.0
                oparts = self._owner_slices(uids)
                if len(oparts) == 1:
                    # the flusher reads vals LATER: own the bytes (a
                    # caller reusing its gradient buffer must not change
                    # a queued delta)
                    if vals is values or vals.base is not None:
                        vals = vals.copy()
                    parts = [(oparts[0][0], uids, vals)]
                else:
                    parts = [(r, _owned_part(uids, ix),
                              _owned_part(vals, ix)) for r, ix in oparts]
                mid = self._track(
                    self._window.submit(parts, opt, tid, tenant=tn),
                    op="ps.add")
                if tid is not None:
                    _trace.add_span("client.enqueue", t_enq0, time.time(),
                                    trace=tid,
                                    args={"table": self.name,
                                          "rows": int(uids.size)})
                return mid
            if tn is None:
                meta_b = self._add_meta_b(opt)
            else:
                # named tenant: stamped meta per call (the cache is keyed
                # on (opt, wire) only)
                meta_b = wire_mod.pack_meta(wire_mod.with_tenant(
                    {"table": self.name, "opt": opt._asdict()}, tn))
            if self._native_ok and vals.dtype == self.dtype:
                from multiverso_tpu_torch.ps import native as ps_native
                parts = ps_native.add_fanout(
                    self._owner_conns(uids), self.ctx.world, False,
                    self._rows_per, meta_b, uids,
                    np.ascontiguousarray(vals))
                return self._track(_fanout_futures(
                    parts, lambda c, s, m: _NativeAddFuture(c, s, m)),
                    op="ps.add")
            t_send0 = time.time() if tid is not None else 0.0
            futs = []
            for r, ix in self._owner_slices(uids):
                w = self._wire_for(r)
                meta = wire_mod.with_tenant(wire_mod.with_trace(
                    {"table": self.name, "opt": opt._asdict()}, tid), tn)
                if w != "none":
                    meta["wire"] = w
                # the local rank's executor dispatch reads the arrays
                # LATER: own the bytes
                local = r == self.ctx.rank
                ids_part = _owned_part(uids, ix) if local else uids[ix]
                vals_part = _owned_part(vals, ix) if local else vals[ix]
                futs.append(self.ctx.service.request(
                    r, svc.MSG_ADD_ROWS, meta,
                    [ids_part] + wire_mod.encode_payload(vals_part, w),
                    meta_b=(None if tid is not None or tn is not None
                            else self._add_meta_b(opt, w))))
            if tid is not None:
                _attach_reply_span(futs, "client.add_rows", t_send0, tid,
                                   self.name)
        return self._track(futs, op="ps.add")

    def add_rows(self, row_ids, values,
                 opt: Optional[AddOption] = None) -> None:
        self.wait(self.add_rows_async(row_ids, values, opt))

    def _can_take_reply(self, out: Optional[np.ndarray],
                        rows: int) -> bool:
        """True when the caller's buffer can take reply rows directly."""
        return (out is not None and isinstance(out, np.ndarray)
                and out.dtype == self.dtype
                and out.shape == (rows, self.num_col)
                and out.flags.c_contiguous)

    def _reply_buffer(self, out: Optional[np.ndarray], rows: int
                      ) -> np.ndarray:
        if self._can_take_reply(out, rows):
            return out
        return np.empty((rows, self.num_col), self.dtype)

    def get_rows_async(self, row_ids,
                       out: Optional[np.ndarray] = None) -> int:
        tc = self._train_cache
        if tc is not None:
            return self._train_cache_get(row_ids, out)
        futs, fin = self._get_rows_futs(row_ids, out)
        return self._track(futs, fin, op="ps.get")

    def _train_cache_get(self, row_ids,
                         out: Optional[np.ndarray] = None) -> int:
        """Cache-aware get: cached rows fill locally (captured AT
        DISPATCH, the same point in program order the wire snapshot is
        taken); only the residual cold rows ride the wire, and the reply
        warms the cache."""
        tc = self._train_cache
        tc.on_get()
        uids, _, inv = self._prep(row_ids)
        # PRIVATE scatter target: committed into out only at finalize
        buf = np.empty((uids.size, self.num_col), self.dtype)
        with self._tc_ordered():
            token, hit = tc.serve_into(uids, buf)
            nhit = int(np.count_nonzero(hit))
            tc.count(nhit, uids.size - nhit)

            def _expand(res: np.ndarray) -> np.ndarray:
                if inv is None:
                    if res is not out and self._can_take_reply(
                            out, res.shape[0]):
                        np.copyto(out, res)
                        return out
                    return res
                dest = self._reply_buffer(out, inv.size)
                np.take(res, inv, axis=0, out=dest)
                return dest

            if nhit == uids.size:
                # full local serve, zero wire ops; still a table-level get
                Dashboard.get(f"table[{self.name}].get_rows").incr()
                return self._track([], lambda _res: _expand(buf))
            full_miss = nhit == 0
            cold_sel = np.flatnonzero(~hit)
            cold_uids = uids[cold_sel]
            cold_buf = (buf if full_miss else
                        np.empty((cold_uids.size, self.num_col),
                                 self.dtype))
            futs, inner_fin = self._get_rows_futs(
                cold_uids, out=cold_buf, prepped=True)

        def _fin(results):
            rows_cold = inner_fin(results)
            if not full_miss:
                buf[cold_sel] = rows_cold
            elif rows_cold is not buf:
                np.copyto(buf, rows_cold)
            # warm the cache, reconciled against pushes dispatched since
            # the token
            tc.fill_since(cold_uids, rows_cold, token)
            return _expand(buf)

        return self._track(futs, _fin, op="ps.get")

    def _get_rows_futs(self, row_ids,
                       out: Optional[np.ndarray] = None,
                       prepped: bool = False):
        """The wire get: ``(futures, finalize)`` for :meth:`_track`.
        ``prepped=True`` marks ``row_ids`` as already validated
        sorted-unique int64 (the cache's cold residual)."""
        # ordering fence: a get observes every windowed add this caller
        # already issued (read-your-writes over the conn's FIFO)
        self._flush_window()
        with monitor(f"table[{self.name}].get_rows"):
            if prepped:
                uids, inv = np.asarray(row_ids, np.int64), None
            else:
                uids, _, inv = self._prep(row_ids)
            # effective tenant (telemetry/tenants.py): None = default,
            # frames stay unstamped and every cached-meta/coalescing
            # fast path below is untouched
            tn = _tenants.current()
            if self._native_ok:
                from multiverso_tpu_torch.ps import native as ps_native
                # unique ids: the C++ recv threads scatter replies
                # straight into the caller's buffer
                buf = self._reply_buffer(out if inv is None else None,
                                         uids.size)
                # a stamped get punts the native server to Python; the
                # reply frame is unchanged, so the C++ scatter applies
                gmeta_b = (self._plain_meta_b if tn is None
                           else wire_mod.pack_meta(wire_mod.with_tenant(
                               {"table": self.name}, tn)))
                fparts = ps_native.get_fanout(
                    self._owner_conns(uids), self.ctx.world, False,
                    self._rows_per, gmeta_b, uids, buf)
                futs = _fanout_futures(
                    fparts, lambda c, s, m: _NativeGetFuture(c, m, buf))

                def _assemble_native(results):
                    # the C++ recv threads filled ``buf``; results only
                    # carry completion
                    return buf if inv is None else buf[inv]

                return futs, _assemble_native
            parts = self._owner_slices(uids)
            if self._get_window is not None and tn is None:
                # single-flight fetches: each part resolves to its own
                # rows, perhaps from a batch shared with other callers.
                # Named tenants bypass the coalescer: a batch merged
                # across tenants would blur the shard's attribution
                futs = [self._get_window.fetch(r, _owned_part(uids, ix))
                        for r, ix in parts]

                def _assemble_win(results):
                    buf = self._reply_buffer(out if inv is None else None,
                                             uids.size)
                    for (r, ix), rows in zip(parts, results):
                        buf[ix] = rows
                    if inv is None:
                        return buf
                    dest = self._reply_buffer(out, inv.size)
                    np.take(buf, inv, axis=0, out=dest)
                    return dest

                return futs, _assemble_win
            gw = self._reply_wire()
            chunk = int(config.get_flag("get_chunk_rows"))
            tid = _trace.new_id() if _trace.enabled() else None
            t_send0 = time.time() if tid is not None else 0.0
            meta_b = wire_mod.pack_meta(wire_mod.with_tenant(
                wire_mod.with_trace(
                    {"table": self.name, "wire": gw}, tid), tn))
            # the local rank never chunk-streams: no network receive to
            # overlap
            will_chunk = {r for r, ix in parts
                          if (chunk > 0 and _part_len(ix) > chunk
                              and r != self.ctx.rank)}
            # with chunking live the scatter target is PRIVATE even when
            # the caller passed out=: a stream failing mid-way must leave
            # the caller's buffer untouched
            buf = self._reply_buffer(
                out if inv is None and not will_chunk else None,
                uids.size)
            futs = []
            chunked: Dict[int, bool] = {}
            for r, ix in parts:
                if r in will_chunk:
                    futs.append(self.ctx.service.request(
                        r, svc.MSG_GET_ROWS,
                        wire_mod.with_tenant(wire_mod.with_trace(
                            {"table": self.name, "wire": gw,
                             "chunk": chunk}, tid), tn),
                        [uids[ix]],
                        chunk_sink=_chunk_scatter(
                            buf, _part_index(ix), self.num_col,
                            self.dtype)))
                    chunked[r] = True
                else:
                    ids_part = (_owned_part(uids, ix)
                                if r == self.ctx.rank else uids[ix])
                    futs.append(self.ctx.service.request(
                        r, svc.MSG_GET_ROWS,
                        wire_mod.with_tenant(wire_mod.with_trace(
                            {"table": self.name, "wire": "none"}, tid),
                            tn),
                        [ids_part], meta_b=meta_b))
            if tid is not None:
                _attach_reply_span(futs, "client.get_rows", t_send0, tid,
                                   self.name)

            def _assemble(results):
                for (r, ix), (rmeta, arrays) in zip(parts, results):
                    if chunked.get(r) and rmeta.get("chunks"):
                        continue   # the sinks already scattered this part
                    w = "none" if r == self.ctx.rank else gw
                    buf[ix] = wire_mod.decode_payload(
                        arrays, w, (_part_len(ix), self.num_col),
                        self.dtype)
                if inv is None:
                    if (out is not None and buf is not out
                            and self._can_take_reply(out, uids.size)):
                        np.copyto(out, buf)
                        return out
                    return buf
                dest = self._reply_buffer(out, inv.size)
                np.take(buf, inv, axis=0, out=dest)
                return dest

        return futs, _assemble

    def get_rows(self, row_ids, out: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        flat_out = None
        if out is not None:
            # accepted: the exact (n, cols) shape, or an unambiguous flat
            # (n*cols,) C-contiguous buffer
            want = (np.asarray(row_ids).reshape(-1).size, self.num_col)
            shape = getattr(out, "shape", None)
            if (shape == (want[0] * want[1],)
                    and out.flags.c_contiguous):
                flat_out, out = out, None   # fill via the copy fallback
            elif shape != want:
                raise ValueError(
                    f"get_rows(out=): out has shape {shape}, required "
                    f"{want} (or flat ({want[0] * want[1]},))")
        host = self.wait(self.get_rows_async(row_ids, out=out))
        if flat_out is not None:
            np.copyto(flat_out.reshape(host.shape), host)
            return flat_out
        if out is not None and host is not out:
            np.copyto(out, host)
            return out
        return host

    def get_row(self, row_id: int) -> np.ndarray:
        return self.get_rows([row_id])[0]

    def add_row(self, row_id: int, values,
                opt: Optional[AddOption] = None) -> None:
        self.add_rows([row_id], np.asarray(values).reshape(1, -1), opt)

    def set_rows(self, row_ids, values) -> None:
        """Overwrite rows (load/master-init plumbing; no updater). Ids
        must be unique."""
        ids = np.asarray(row_ids, np.int64).reshape(-1)
        vals = np.asarray(values, self.dtype).reshape(-1, self.num_col)
        if vals.shape[0] != ids.size:
            raise ValueError("set_rows: one value row per id required")
        order = np.argsort(ids, kind="stable")
        uids, vals = ids[order], vals[order]
        if uids.size > 1 and np.any(uids[1:] == uids[:-1]):
            raise ValueError("set_rows requires unique row ids")
        if np.any((uids < 0) | (uids >= self.num_row)):
            raise IndexError(f"row id out of range [0, {self.num_row})")
        # order fence: earlier native adds must be acked before this
        # overwrite travels the python conn (different sockets: no FIFO),
        # and queued windowed adds must leave first (same-conn FIFO)
        self._native_flush()
        self._flush_window()
        meta = {"table": self.name}
        futs = [self.ctx.service.request(r, svc.MSG_SET_ROWS, meta,
                                         [uids[m], vals[m]])
                for r, m in self._by_owner(uids)]
        if self._train_cache is not None:
            # not a replayable add: drop + poison, AFTER the frames
            # entered the conn FIFOs
            self._train_cache.on_overwrite(uids)
        self.wait(self._track(futs, lambda rs: None))

    # ------------------------------------------------------------------ #
    # whole-table ops
    # ------------------------------------------------------------------ #
    def add_async(self, delta, opt: Optional[AddOption] = None) -> int:
        opt = opt or AddOption(worker_id=self.ctx.rank)
        # fence: queued windowed row adds land before a whole-table delta
        # (floating-point sums do not commute bit for bit)
        self._flush_window()
        try:
            return self._add_full_dispatch(delta, opt)
        finally:
            if self._train_cache is not None:
                # whole-table delta: a wholesale drop, AFTER the frames
                # entered the conn FIFOs
                self._train_cache.clear()

    def _add_full_dispatch(self, delta, opt: AddOption) -> int:
        with monitor(f"table[{self.name}].add"):
            delta = np.ascontiguousarray(
                np.asarray(delta, self.dtype).reshape(self.shape))
            if self._native_ok:
                meta_b = self._add_meta_b(opt)
                return self._track([
                    _native_add(self.ctx.service, r, svc.MSG_ADD_FULL,
                                meta_b, None, delta[a:b])
                    for r, a, b in self._ranges])
            futs = []
            for r, a, b in self._ranges:
                w = self._wire_for(r)
                if w == "1bit":
                    # per-owner error feedback: this rank's slice shape is
                    # fixed, so the residual's positions are stable
                    from multiverso_tpu_torch.utils.filters import \
                        OneBitsFilter
                    with self._add_filter_lock:
                        filt = self._add_filters.get(r)
                        if filt is None:
                            filt = self._add_filters[r] = OneBitsFilter(
                                block=wire_mod.ONEBIT_BLOCK)
                        _, bits, scales = filt.filter_in(delta[a:b])
                    arrays = [bits, scales]
                elif w == "topk":
                    from multiverso_tpu_torch.utils.filters import (
                        TopKFilter, default_topk)
                    with self._add_filter_lock:
                        filt = self._add_filters.get(r)
                        if filt is None:
                            filt = self._add_filters[r] = TopKFilter(
                                default_topk((b - a) * self.num_col))
                        _, idx, topv = filt.filter_in(delta[a:b])
                    arrays = [idx, topv]
                else:
                    part = delta[a:b]
                    if r == self.ctx.rank:
                        part = part.copy()   # read later on the executor
                    arrays = wire_mod.encode_payload(part, w)
                meta = {"table": self.name, "opt": opt._asdict()}
                if w != "none":
                    meta["wire"] = w
                futs.append(self.ctx.service.request(
                    r, svc.MSG_ADD_FULL, meta, arrays,
                    meta_b=self._add_meta_b(opt, w)))
        return self._track(futs)

    def add(self, delta, opt: Optional[AddOption] = None) -> None:
        self.wait(self.add_async(delta, opt))

    def get_async(self) -> int:
        self._flush_window()   # read-your-writes for windowed adds
        with monitor(f"table[{self.name}].get"):
            ranges = list(self._ranges)
            host = np.empty(self.shape, self.dtype)
            chunked: Dict[int, bool] = {}
            chunk = int(config.get_flag("get_chunk_rows"))
            futs = []
            for r, a, b in ranges:
                w = self._get_wire_for(r)
                if self._native_ok:
                    # the reply lands in this range's rows of ``host``
                    futs.append(_native_get(
                        self.ctx.service, r, svc.MSG_GET_FULL,
                        self._plain_meta_b, None, host[a:b]))
                elif chunk > 0 and (b - a) > chunk and r != self.ctx.rank:
                    # streamed whole-shard pull: sub-frames scatter into
                    # this range's rows as they land
                    futs.append(self.ctx.service.request(
                        r, svc.MSG_GET_FULL,
                        {"table": self.name, "wire": w, "chunk": chunk},
                        chunk_sink=_chunk_scatter(
                            host[a:b], None, self.num_col, self.dtype)))
                    chunked[r] = True
                else:
                    futs.append(self.ctx.service.request(
                        r, svc.MSG_GET_FULL,
                        {"table": self.name, "wire": w}))

            native = self._native_ok

            def _assemble(results):
                if native:
                    return host   # the C++ recv threads filled it
                for (r, a, b), (rmeta, arrays) in zip(ranges, results):
                    if chunked.get(r) and rmeta.get("chunks"):
                        continue   # scattered by the sinks already
                    host[a:b] = wire_mod.decode_payload(
                        arrays, self._get_wire_for(r),
                        (b - a, self.num_col), self.dtype)
                return host

        return self._track(futs, _assemble)

    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        host = self.wait(self.get_async())
        if out is not None:
            np.copyto(out.reshape(self.shape), host)
            return out
        return host

    # ------------------------------------------------------------------ #
    # checkpoint (whole-table via the service), the JAX package's format:
    # the data, then a trailer marker and per-owner updater state
    # ------------------------------------------------------------------ #
    _STATE_MARKER = 0x4D565553   # "MVUS": updater state follows the data

    def store(self, stream) -> None:
        # checkpoints are durable state: always pull full precision
        saved, self._wire = self._wire, "none"
        try:
            np.save(stream, self.get(), allow_pickle=False)
        finally:
            self._wire = saved
        np.save(stream, np.array([self._STATE_MARKER, len(self._ranges)],
                                 np.int64), allow_pickle=False)
        timeout = config.get_flag("ps_timeout")
        for r, _, _ in self._ranges:
            meta, leaves = svc.await_reply(
                self.ctx.service.request(r, svc.MSG_GET_STATE,
                                         {"table": self.name}),
                timeout, f"table[{self.name}] state from {r}")
            np.save(stream, np.array([len(leaves)], np.int64),
                    allow_pickle=False)
            for leaf in leaves:
                np.save(stream, leaf, allow_pickle=False)

    def load(self, stream, _data: Optional[np.ndarray] = None) -> None:
        self._load(stream, only_local=False, _data=_data)

    def load_local(self, stream) -> None:
        """Restore ONLY this rank's owned row range (+ its updater state)
        from a full-table checkpoint stream."""
        self._load(stream, only_local=True)

    def _load(self, stream, only_local: bool,
              _data: Optional[np.ndarray] = None) -> None:
        data = np.load(stream) if _data is None else _data
        if data.shape != self.shape:
            raise ValueError(f"checkpoint shape {data.shape} != {self.shape}")
        me = self.ctx.rank
        for r, a, b in self._ranges:
            if not only_local or r == me:
                self.set_rows(np.arange(a, b), data[a:b])
        try:
            header = np.load(stream)
        except EOFError:
            # ONLY a clean end-of-stream means "checkpoint without updater
            # state"; a truncated or corrupt trailer fails the restore
            log.info("table[%s]: checkpoint predates updater-state "
                     "persistence; optimizer accumulators keep their "
                     "current values", self.name)
            return
        if header.size != 2 or int(header[0]) != self._STATE_MARKER:
            raise ValueError(
                f"table[{self.name}]: unrecognized checkpoint trailer "
                "(not an async-table stream?)")
        if int(header[1]) != len(self._ranges):
            raise ValueError(
                f"table[{self.name}]: checkpoint has per-shard updater "
                f"state for {int(header[1])} owners but the world now has "
                f"{len(self._ranges)} — shard accumulators cannot be "
                "remapped; restore with the original world size")
        timeout = config.get_flag("ps_timeout")
        for r, _, _ in self._ranges:
            n = int(np.load(stream)[0])
            leaves = [np.load(stream) for _ in range(n)]
            if only_local and r != me:
                continue
            svc.await_reply(
                self.ctx.service.request(r, svc.MSG_SET_STATE,
                                         {"table": self.name}, leaves),
                timeout, f"table[{self.name}] state to {r}")


class _SparseGetMixin:
    """Worker-side half of the stale-row protocol, shared by the
    range-sharded and hash-sharded sparse tables: per-worker row cache +
    the stale-only pull. Pipeline-safe: several pulls for one worker may
    be in flight and be waited in any order (a version filter keeps an
    older reply from overwriting a newer one; a lost reply self-heals
    with a plain re-pull)."""

    def _worker_cache(self, worker_id: int):
        from multiverso_tpu_torch.tables.sparse_matrix_table import _RowCache
        if not (0 <= worker_id < self._n_workers):
            raise IndexError(f"worker_id {worker_id} out of range "
                             f"[0, {self._n_workers})")
        with self._caches_lock:
            entry = self._caches.get(worker_id)
            if entry is None:
                entry = self._caches[worker_id] = (
                    _RowCache(self.num_col, self.dtype),
                    threading.Lock(), {})   # cache, lock, row -> pull seq
        return entry

    def _next_seq(self) -> int:
        with self._caches_lock:
            self._pull_seq += 1
            return self._pull_seq

    def get_rows_sparse_async(self, row_ids,
                              worker_id: Optional[int] = None) -> int:
        """Dispatch a stale-only pull; ``wait(msg_id)`` returns the rows.
        Several pulls for the same worker may be in flight."""
        worker_id = self.ctx.rank if worker_id is None else worker_id
        cache, cache_lock, seqs = self._worker_cache(worker_id)
        self._flush_window()   # read-your-writes for windowed adds
        with monitor(f"table[{self.name}].get_rows_sparse"):
            uids, _, inv = self._prep(row_ids)
            parts = list(self._by_owner(uids))
            meta = {"table": self.name, "sparse": True,
                    "worker_id": int(worker_id)}
            meta_b = wire_mod.pack_meta(meta)
            # resolve peers BEFORE taking the cache lock: a down owner's
            # lookup + connect can take ps_connect_timeout
            for r, _ in parts:
                if r != self.ctx.rank:
                    try:
                        self.ctx.service._peer(r)
                    except svc.PSError:
                        pass   # request() below fails fast via backoff
            with cache_lock:
                # seq order == wire send order == server processing order
                # per worker (one conn per owner, FIFO)
                seq = self._next_seq()
                futs = [self.ctx.service.request(r, svc.MSG_GET_ROWS, meta,
                                                 [uids[m]], meta_b=meta_b)
                        for r, m in parts]

        def _finalize(results):
            transferred = 0
            with cache_lock:
                for (r, m), (_, (mask, rows)) in zip(parts, results):
                    stale = uids[m][mask.astype(bool)]
                    if stale.size == 0:
                        continue
                    # version filter: an out-of-order wait() must not let
                    # an OLDER pull's rows overwrite a newer pull's
                    keep = np.array([seqs.get(int(i), -1) < seq
                                     for i in stale.tolist()])
                    fresh_ids = stale[keep]
                    if fresh_ids.size:
                        cache.put(fresh_ids,
                                  wire_mod.as_values(rows, self.dtype)[keep])
                        for i in fresh_ids.tolist():
                            seqs[int(i)] = seq
                        transferred += int(fresh_ids.size)
                try:
                    out = cache.take(uids)
                except KeyError:
                    # self-healing: a reply that cleared dirty bits on the
                    # server was lost or is waited out of order — re-pull
                    # the gap with a plain get
                    _, found = cache._locate(uids)
                    missing = uids[~found]
                    heal_seq = self._next_seq()
                    cache.put(missing, self.get_rows(missing))
                    for i in missing.tolist():
                        seqs[int(i)] = heal_seq
                    transferred += int(missing.size)
                    out = cache.take(uids)
            self.last_transfer_rows = transferred
            return out if inv is None else out[inv]

        return self._track(futs, _finalize)

    def get_rows_sparse(self, row_ids, worker_id: Optional[int] = None
                        ) -> np.ndarray:
        return self.wait(self.get_rows_sparse_async(row_ids, worker_id))


class AsyncSparseMatrixTable(_SparseGetMixin, AsyncMatrixTable):
    """Stale-row protocol on the uncoordinated plane:
    ``get_rows_sparse(ids, worker_id)`` transfers ONLY the rows that
    changed since this worker last pulled them; fresh rows come from the
    worker-side row cache. Dirty bits live on each owning shard, per
    worker."""

    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater=None, name: str = "async_sparse_matrix",
                 init=None, seed=None, init_scale: float = 0.0,
                 num_workers: Optional[int] = None,
                 send_window_ms: Optional[float] = None,
                 get_window_ms: Optional[float] = None,
                 ctx: Optional[svc.PSContext] = None):
        ctx = ctx if ctx is not None else svc.default_context()
        self._n_workers = num_workers or max(ctx.world, 1)
        super().__init__(num_row, num_col, dtype=dtype, updater=updater,
                         name=name, init=init, seed=seed,
                         init_scale=init_scale,
                         shard_workers=self._n_workers,
                         send_window_ms=send_window_ms,
                         get_window_ms=get_window_ms, ctx=ctx)
        self._caches: Dict[int, Any] = {}
        self._caches_lock = threading.Lock()
        self._pull_seq = 0
        self.last_transfer_rows = -1   # diagnostic: rows over the wire


class AsyncSparseKVTable(_SparseGetMixin, _AsyncBase):
    """Hash-sharded sparse-KEY table: arbitrary non-negative int64 keys,
    owner = ``key % world``. With ``updater="ftrl"`` each key's row is the
    weight recomputed from the z/n state — workers push raw gradients.
    Slots materialize on first touch; a Get of a fresh key returns
    zeros."""

    def __init__(self, num_col: int, dtype=np.float32,
                 updater: Union[str, updaters_lib.Updater, None] = None,
                 name: str = "async_sparse_kv",
                 num_row: Optional[int] = None,
                 num_workers: Optional[int] = None,
                 send_window_ms: Optional[float] = None,
                 ctx: Optional[svc.PSContext] = None):
        super().__init__(ctx, name)
        self.num_col = int(num_col)
        self.dtype = np.dtype(dtype)
        self.num_row = num_row   # optional key bound (enables dense get())
        self._n_workers = num_workers or max(self.ctx.world, 1)
        self.updater = _resolve_updater(updater, self._n_workers, self.dtype)
        self._shard = HashShard(self.num_col, self.dtype, self.updater,
                                name, num_workers=self._n_workers,
                                device=self.device)
        self.ctx.service.register_handler(name, self._shard.handle,
                                          shard=self._shard)
        self._caches: Dict[int, Any] = {}
        self._caches_lock = threading.Lock()
        self._pull_seq = 0
        self.last_transfer_rows = -1
        self._make_window(send_window_ms)
        self.table_id = _maybe_register_in_zoo(self)

    def raw(self):
        return self._shard._data

    def _prep(self, keys, values: Optional[np.ndarray] = None):
        return _dedupe_batch(keys, self.num_col, self.dtype,
                             self.num_row, values)

    def _by_owner(self, uids: np.ndarray):
        owners = uids % self.ctx.world
        for r in np.unique(owners):
            yield int(r), owners == r

    def add_rows_async(self, keys, values,
                       opt: Optional[AddOption] = None) -> int:
        opt = opt or AddOption(worker_id=self.ctx.rank)
        with monitor(f"table[{self.name}].add_rows"):
            uids, vals, _ = self._prep(keys, values)
            tid = _trace.new_id() if _trace.enabled() else None
            tn = _tenants.current()
            if self._window is not None:
                # send window: per-owner key batches queue and ship as one
                # (multi-op) frame (see _SendWindow)
                t_enq0 = time.time() if tid is not None else 0.0
                owners = uids % self.ctx.world
                r0 = int(owners[0])
                if uids.size == 1 or not np.any(owners != r0):
                    # the flusher reads vals later: own the bytes
                    if vals is values or vals.base is not None:
                        vals = vals.copy()
                    parts = [(r0, uids, vals)]
                else:
                    parts = [(r, uids[m], vals[m])
                             for r, m in self._by_owner(uids)]
                mid = self._track(
                    self._window.submit(parts, opt, tid, tenant=tn),
                    op="ps.add")
                if tid is not None:
                    _trace.add_span("client.enqueue", t_enq0, time.time(),
                                    trace=tid,
                                    args={"table": self.name,
                                          "rows": int(uids.size)})
                return mid
            meta = wire_mod.with_tenant(wire_mod.with_trace(
                {"table": self.name, "opt": opt._asdict()}, tid), tn)
            meta_b = wire_mod.pack_meta(meta)
            futs = [self.ctx.service.request(r, svc.MSG_ADD_ROWS, meta,
                                             [uids[m], vals[m]],
                                             meta_b=meta_b)
                    for r, m in self._by_owner(uids)]
        return self._track(futs, op="ps.add")

    def add_rows(self, keys, values,
                 opt: Optional[AddOption] = None) -> None:
        self.wait(self.add_rows_async(keys, values, opt))

    def get_rows_async(self, keys) -> int:
        self._flush_window()   # read-your-writes for windowed adds
        with monitor(f"table[{self.name}].get_rows"):
            uids, _, inv = self._prep(keys)
            parts = list(self._by_owner(uids))
            meta = wire_mod.with_tenant({"table": self.name},
                                        _tenants.current())
            meta_b = wire_mod.pack_meta(meta)
            futs = [self.ctx.service.request(
                        r, svc.MSG_GET_ROWS, meta, [uids[m]], meta_b=meta_b)
                    for r, m in parts]

            def _assemble(results):
                out = np.empty((uids.size, self.num_col), self.dtype)
                for (r, m), (_, arrays) in zip(parts, results):
                    out[m] = wire_mod.as_values(arrays[0], self.dtype)
                return out if inv is None else out[inv]

        return self._track(futs, _assemble, op="ps.get")

    def get_rows(self, keys) -> np.ndarray:
        return self.wait(self.get_rows_async(keys))

    def get(self) -> np.ndarray:
        """Dense (num_row, num_col) view; needs the key bound."""
        if self.num_row is None:
            raise ValueError(f"table[{self.name}] is unbounded; get() needs "
                             "num_row (or use get_rows/key enumeration)")
        return self.get_rows(np.arange(self.num_row))

    def store(self, stream) -> None:
        """(keys, rows, per-key updater state) per owner."""
        self._flush_window()   # the dump sees this caller's queued adds
        timeout = config.get_flag("ps_timeout")
        np.save(stream, np.array([self.ctx.world], np.int64),
                allow_pickle=False)
        for r in range(self.ctx.world):
            meta, arrays = svc.await_reply(
                self.ctx.service.request(
                    r, svc.MSG_GET_STATE, {"table": self.name, "dump": True}),
                timeout, f"table[{self.name}] dump from {r}")
            np.save(stream, np.array([len(arrays)], np.int64),
                    allow_pickle=False)
            for a in arrays:
                np.save(stream, a, allow_pickle=False)

    def load(self, stream) -> None:
        self._load(stream, only_local=False)

    def load_local(self, stream) -> None:
        """Restore only this rank's hash shard."""
        self._load(stream, only_local=True)

    def _load(self, stream, only_local: bool) -> None:
        # stale pre-restore deltas must not land on the restored state
        self._flush_window()
        world = int(np.load(stream)[0])
        if world != self.ctx.world:
            raise ValueError(
                f"table[{self.name}]: checkpoint written at world={world}, "
                f"now {self.ctx.world} — hash shards cannot be remapped")
        timeout = config.get_flag("ps_timeout")
        for r in range(self.ctx.world):
            n = int(np.load(stream)[0])
            arrays = [np.load(stream) for _ in range(n)]
            if only_local and r != self.ctx.rank:
                continue
            svc.await_reply(
                self.ctx.service.request(
                    r, svc.MSG_SET_STATE, {"table": self.name, "dump": True},
                    arrays),
                timeout, f"table[{self.name}] restore to {r}")


class AsyncArrayTable(_AsyncBase):
    """1-D async table: contiguous-range sharding of a vector, as a
    single-column matrix (ranges ARE row blocks)."""

    def __init__(self, size: int, dtype=np.float32,
                 updater=None, name: str = "async_array",
                 init: Optional[np.ndarray] = None, wire: str = "none",
                 ctx: Optional[svc.PSContext] = None):
        super().__init__(ctx, name)
        self.size = int(size)
        self.dtype = np.dtype(dtype)
        init2d = (np.asarray(init, self.dtype).reshape(self.size, 1)
                  if init is not None else None)
        self._m = AsyncMatrixTable(self.size, 1, dtype=dtype,
                                   updater=updater, name=name,
                                   init=init2d, wire=wire, ctx=self.ctx)
        self.updater = self._m.updater
        self.table_id = self._m.table_id

    def raw(self):
        return self._m.raw()

    def add_async(self, values, opt: Optional[AddOption] = None) -> int:
        return self._m.add_async(
            np.asarray(values, self.dtype).reshape(self.size, 1), opt)

    def add(self, values, opt: Optional[AddOption] = None) -> None:
        self._m.wait(self.add_async(values, opt))

    def get_async(self) -> int:
        return self._m.get_async()

    def get(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        host = self._m.get().reshape(self.size)
        if out is not None:
            np.copyto(out.reshape(self.size), host)
            return out
        return host

    def wait(self, msg_id: int) -> Any:
        res = self._m.wait(msg_id)
        return res.reshape(self.size) if isinstance(res, np.ndarray) else res

    def flush(self) -> None:
        self._m.flush()

    def store(self, stream) -> None:
        self._m.store(stream)   # (size, 1) data + per-owner updater state

    def load(self, stream) -> None:
        data = np.load(stream)
        if data.ndim == 1:   # a 1-D array-table stream stays loadable
            data = data.reshape(self.size, 1)
        self._m.load(stream, _data=data)

    def load_local(self, stream) -> None:
        self._m.load_local(stream)


class AsyncMatrixTableOption:
    """Option parity for ``mv.create_table`` on the uncoordinated plane."""

    def __init__(self, num_row: int, num_col: int, dtype=np.float32,
                 updater=None, init=None, seed=None,
                 init_scale: float = 0.0):
        self.num_row, self.num_col = num_row, num_col
        self.dtype, self.updater = dtype, updater
        self.init, self.seed, self.init_scale = init, seed, init_scale

    def build(self, name: str = "async_matrix") -> "AsyncMatrixTable":
        return AsyncMatrixTable(self.num_row, self.num_col,
                                dtype=self.dtype, updater=self.updater,
                                name=name, init=self.init, seed=self.seed,
                                init_scale=self.init_scale)


class AsyncArrayTableOption:
    def __init__(self, size: int, dtype=np.float32, updater=None,
                 init=None):
        self.size, self.dtype, self.updater, self.init = (size, dtype,
                                                          updater, init)

    def build(self, name: str = "async_array") -> "AsyncArrayTable":
        return AsyncArrayTable(self.size, dtype=self.dtype,
                               updater=self.updater, name=name,
                               init=self.init)


class AsyncKVTable(_AsyncBase):
    """Hash-sharded async KV table (``key % world``). ``get`` reads the
    server-aggregated value directly (uncoordinated)."""

    def __init__(self, name: str = "async_kv",
                 ctx: Optional[svc.PSContext] = None):
        super().__init__(ctx, name)
        self._shard = KVShard(name)
        self.ctx.service.register_handler(name, self._shard.handle,
                                          shard=self._shard)
        self.table_id = _maybe_register_in_zoo(self)

    def _owner(self, key: int) -> int:
        return int(key) % self.ctx.world

    def add(self, keys: Iterable[int], values: Iterable) -> None:
        keys = np.asarray(list(keys), np.int64)
        vals = np.asarray(list(values), np.float64)
        meta = {"table": self.name}
        futs = []
        for r in range(self.ctx.world):
            m = (keys % self.ctx.world) == r
            if m.any():
                futs.append(self.ctx.service.request(
                    r, svc.MSG_KV_ADD, meta, [keys[m], vals[m]]))
        self.wait(self._track(futs, lambda rs: None))

    def get(self, keys: Optional[Iterable[int]] = None,
            global_: bool = True) -> Dict[int, float]:
        """Aggregated read off the hash shards. ``global_`` is accepted for
        sync-KVTable API compatibility and ignored: an async Get is always
        the server-aggregated value."""
        meta = {"table": self.name}
        out: Dict[int, float] = {}
        if keys is None:
            futs = [self.ctx.service.request(
                        r, svc.MSG_KV_GET, dict(meta, all=True), [])
                    for r in range(self.ctx.world)]
        else:
            karr = np.asarray(list(keys), np.int64)
            uk = np.unique(karr)   # dedupe: a key lives on exactly ONE shard
            futs = []
            for r in range(self.ctx.world):
                m = (uk % self.ctx.world) == r
                if m.any():
                    futs.append(self.ctx.service.request(
                        r, svc.MSG_KV_GET, meta, [uk[m]]))
        timeout = config.get_flag("ps_timeout")
        for f in futs:
            _, arrays = svc.await_reply(f, timeout,
                                        f"table[{self.name}] kv get")
            for k, v in zip(arrays[0].tolist(), arrays[1].tolist()):
                out[int(k)] = v   # assignment: shards are disjoint by hash
        if keys is not None:
            return {int(k): out.get(int(k), 0) for k in karr}
        return out

    def __getitem__(self, key: int):
        return self.get([key])[int(key)]

    def store(self, stream) -> None:
        items = sorted(self.get().items())
        np.save(stream, np.array([k for k, _ in items], np.int64),
                allow_pickle=False)
        np.save(stream, np.array([v for _, v in items], np.float64),
                allow_pickle=False)

    def load(self, stream) -> None:
        keys = np.load(stream)
        vals = np.load(stream)
        with self._shard._lock:
            self._shard._store = {}
        # re-add only this rank's hash shard so the global view is
        # restored exactly once
        m = (keys % self.ctx.world) == self.ctx.rank
        if m.any():
            meta = {"table": self.name}
            self.wait(self._track([self.ctx.service.request(
                self.ctx.rank, svc.MSG_KV_ADD, meta,
                [keys[m], vals[m]])], lambda rs: None))
