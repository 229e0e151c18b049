"""PSService: the per-process async parameter-server runtime (port of
``multiverso_tpu/ps/service.py``).

One PSService per process (or per rank, when a test runs several ranks in
one process):

* a listener thread accepts peer connections; each connection gets a
  handler thread that reads requests, dispatches to the owning table
  shard, and writes the reply (one receive loop per peer);
* a client side (:class:`_Peer`) keeps one persistent connection per
  remote rank with a receiver thread completing per-``msg_id`` futures;
* rendezvous: ranks find each other through a shared directory (flag
  ``ps_rendezvous``, :class:`FileRendezvous`, the JAX package's file
  layout, so a JAX rank and a rank of this package meet in one
  directory), or, with no directory, through the key-value store of the
  ``torch.distributed`` world (:class:`StoreRendezvous`, the counterpart
  of the JAX package's coordinator-store ``JaxRendezvous``).

Local shards short-circuit the socket but still run on the service's
one-thread executor, so ``add_async`` keeps fire-and-forget semantics and
per-owner FIFO order.

Failure semantics: requests to a dead/unreachable rank raise
:class:`PSPeerError` (after ``ps_connect_timeout``/``ps_timeout``); the
service keeps serving live peers — no collective, so nobody hangs.

The stats payload (MSG_STATS) carries the Dashboard monitors, every
shard's stats and, when this process serves read replicas, their
``serving`` block (``serving/replica.stats_snapshot``).

Failover and faults: the service reads its incarnation ``generation``
from flag ``ps_generation`` (echoed by MSG_HEALTH), can hold its
rendezvous publish until a restarted shard has restored
(``defer_publish``), starts and stops the per-shard checkpointer
(``ps/failover.py``, flags ``failover_dir`` and
``failover_ckpt_interval_s``), and hooks the fault-injection plane
(``ps/faults.py``) on the client send path and the serve loop; disarmed,
each hook costs one attribute read.

The native plane (flag ``ps_native``, on by default as in the JAX
package, ``ps/native.py`` over ``csrc/mv_ps.cpp``): accepted connections
are adopted by C++ threads, which serve the hot row ops of a registered
shard with no Python in the loop and punt every other frame to
:meth:`PSService._punt` on the connection thread. A shard registers only
when its rows are a CPU tensor (``device="cpu"``) and its updater is a
stateless signed accumulate; a shard on the card punts every op. The
client half (:meth:`PSService.native_conn`) gives the async tables counted
adds and buffer-filling gets. The fault plane hooks the Python wire only,
so chaos runs set ``ps_native=False``.

Telemetry (the per-process plane): the flight recorder marks the client's
send, ack, error and peer-death edges and the server's receive and reply
edges (probes excluded) and dumps when a peer dies with requests in
flight; the serve paths record ``ps.serve`` spans for traced frames
(``trace_ids``); MSG_HEALTH carries the watchdog's verdict and the oldest
in-flight op; the stats payload is the exporter's record with the
``profile``, ``memory`` and ``devices`` blocks; closing a context flushes
the exporter, spans and step records.

Telemetry (the cluster plane): rank 0 starts the cluster aggregator
(``telemetry/aggregator.py``, flag ``stats_poll_interval_s``), which
polls every rank's MSG_STATS and MSG_HEALTH over one-shot probes and
drives the SLO sentinel and the signal bus; the stats payload adds the
``tenants`` block (``telemetry/tenants.py``) and, while the sentinel is
armed, the ``slo`` block (``telemetry/slo.py``).

The PS half of the mesh data plane (``ps/spmd.py``, both flags off by
default): every service joins the process colocation registry when it
publishes its address. With ``ps_fanout`` armed, a request to a
colocated rank of the same world runs inline in that rank's handler
instead of crossing the localhost socket, and a client's multi-owner row
op rides one in-process ``MSG_MULTI`` super-frame (:meth:`PSService.
multi_local`). With ``ps_spmd_stack`` armed, the shards registered here
join their table's stacked group on their device, and the super-frame
engine applies (or gathers) every sub-op of one stacked plane in one
grouped dispatch.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multiverso_tpu_torch.ps import failover as _failover
from multiverso_tpu_torch.ps import faults as _faults
# the mesh data plane: module-level so the ps_fanout / ps_spmd_stack flags
# register before an argv parse; spmd.py never imports this module at
# module scope, so there is no cycle
from multiverso_tpu_torch.ps import spmd as _spmd
from multiverso_tpu_torch.ps import wire
from multiverso_tpu_torch.serving import replica as _serving_replica
from multiverso_tpu_torch.telemetry import aggregator as _aggregator
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.telemetry import exporter as _exporter
from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.telemetry import profiler as _profiler
from multiverso_tpu_torch.telemetry import slo as _slo
from multiverso_tpu_torch.telemetry import tenants as _tenants
from multiverso_tpu_torch.telemetry import trace as _trace
from multiverso_tpu_torch.telemetry import watchdog as _watchdog
from multiverso_tpu_torch.utils import config, log, retry as _retry
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor
from multiverso_tpu_torch.zoo import default_device

# message types (request side; replies reuse the id space below 0x100)
MSG_REPLY_OK = 1
MSG_REPLY_ERR = 2
# one sub-frame of a chunk-streamed get reply (wire.ChunkedReply)
MSG_REPLY_CHUNK = 3
MSG_PING = 0x10
MSG_ADD_ROWS = 0x11
MSG_GET_ROWS = 0x12
MSG_SET_ROWS = 0x13
MSG_ADD_FULL = 0x14
MSG_GET_FULL = 0x15
MSG_KV_ADD = 0x16
MSG_KV_GET = 0x17
MSG_GET_STATE = 0x18
MSG_SET_STATE = 0x19
# multi-op frame: N row adds (complete inner frames, wire.pack_batch)
# applied as conflict-free waves and acked as ONE request
MSG_BATCH = 0x1A
# remote dashboard: a rank's Dashboard monitors and per-shard stats as
# the reply meta
MSG_STATS = 0x1B
# compact liveness verdict as the reply meta (counter reads only)
MSG_HEALTH = 0x1C
# replica subscription pull (a shard's committed rows + version)
MSG_SNAPSHOT = 0x1D
# multi-owner super-frame: inner frames naming their owning rank under
# wire.OWNER_META_KEY, dispatched across the colocated shards of the
# receiving process and acked as one request
MSG_MULTI = 0x1E

config.define_string("ps_rendezvous", "",
                     "directory for async-PS rank rendezvous; empty = the "
                     "torch.distributed world's key-value store (net_init "
                     "or a launcher) when ps_world > 1")
config.define_int("ps_rank", -1, "async-PS rank (read when ps_world > 0; "
                  "with ps_world <= 0 the rank comes from the "
                  "torch.distributed world)")
config.define_int("ps_world", 0,
                  "async-PS world size (<= 0 = the torch.distributed "
                  "world's rank and size, else rank 0 of 1)")
config.define_int("ps_port", 0, "async-PS listen port (0 = ephemeral)")
config.define_string("ps_host", "127.0.0.1",
                     "async-PS bind host. Single-host runs keep the "
                     "loopback default; multi-host runs set 0.0.0.0 (the "
                     "published address is then the auto-detected routable "
                     "IP) or this machine's explicit routable IP")
config.define_float("ps_local_shard_min_mb", 1.0,
                    "spread an owned row range over the process's local "
                    "devices only when it is at least this big. A process "
                    "of this package keeps its shard on its one device, so "
                    "the flag is accepted and changes nothing")
config.define_float("ps_timeout", 300.0,
                    "async-PS request timeout seconds")
config.define_float("ps_connect_timeout", 30.0,
                    "async-PS peer connect timeout seconds")
config.define_float("ps_reconnect_backoff", 5.0,
                    "seconds to fail fast against a rank that just died "
                    "before trying a fresh rendezvous lookup + reconnect")
config.define_bool("ps_coalesce", True,
                   "server-side request coalescing: Adds queued for the "
                   "same shard while an update is in flight are merged "
                   "(deltas summed in float64) into ONE update. Exact for "
                   "default/sgd updaters, within the ASGD contract for the "
                   "stateful ones")
config.define_bool("ps_native", True,
                   "serve and speak the async-PS wire through the native "
                   "C++ transport (csrc/mv_ps.cpp) when its library "
                   "builds: accepted connections are adopted by C++ "
                   "threads that serve hot row ops on host-backed linear "
                   "shards (rows in a CPU tensor) with no Python in the "
                   "loop, and clients send framed adds/gets straight from "
                   "C. Anything the native side cannot serve (every op on "
                   "a shard on the card) punts to the Python handlers "
                   "unchanged. Off = pure-Python plane")
config.define_float("ps_health_timeout", 5.0,
                    "MSG_HEALTH probe reply timeout seconds (triage scale, "
                    "not ps_timeout)")
config.define_int("ps_probe_attempts", 1,
                  "one-shot probe (MSG_HEALTH/MSG_STATS) attempts per "
                  "pull, all within ONE ps_health_timeout budget")
config.define_float("ps_shutdown_grace", 60.0,
                    "seconds a rank keeps its shards served at shutdown "
                    "while waiting for peers to ALSO reach shutdown "
                    "(the reference's MV_ShutDown barrier)")


class PSError(RuntimeError):
    pass


class PSPeerError(PSError):
    """A specific peer is unreachable/dead; traffic to others is unaffected."""


def _sub_err(e: BaseException) -> Dict:
    """A super-frame sub-op's error as reply meta, with a ``"peer"``
    marker for peer-death errors so the client rethrows the TYPED
    PSPeerError."""
    out = {"error": f"{type(e).__name__}: {e}"}
    if isinstance(e, PSPeerError):
        out["peer"] = True
    return out


def await_reply(fut: cf.Future, timeout: float, what: str):
    """``fut.result`` with waiter timeouts surfaced as PSPeerError."""
    try:
        return fut.result(timeout=timeout)
    except cf.TimeoutError as e:
        raise PSPeerError(f"{what}: no reply within {timeout}s") from e


# ---------------------------------------------------------------------- #
# rendezvous
# ---------------------------------------------------------------------- #
class FileRendezvous:
    """Shared-directory rendezvous, in the JAX package's file layout:
    ``<rank>.addr`` holds a rank's address, ``<tag>.<rank>`` a marker."""

    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)

    @property
    def identity(self) -> str:
        return os.path.realpath(self._dir)

    def publish(self, rank: int, addr: str) -> None:
        tmp = os.path.join(self._dir, f".{rank}.addr.tmp")
        with open(tmp, "w") as f:
            f.write(addr)
        os.replace(tmp, os.path.join(self._dir, f"{rank}.addr"))

    def lookup(self, rank: int, timeout: float) -> str:
        path = os.path.join(self._dir, f"{rank}.addr")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    addr = f.read().strip()
                if addr:
                    return addr
            except FileNotFoundError:
                pass
            time.sleep(0.02)
        raise PSPeerError(f"rank {rank} never published an address "
                          f"({path} missing after {timeout}s)")

    def mark(self, rank: int, tag: str, value: str = "1") -> None:
        """Publish a marker (shutdown quiesce handshake). ``value`` stamps
        it with this incarnation's identity (the published addr), so a
        reused directory's stale markers never satisfy this run."""
        tmp = os.path.join(self._dir, f".{tag}.{rank}.tmp")
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, os.path.join(self._dir, f"{tag}.{rank}"))

    def wait_mark(self, rank: int, tag: str, timeout: float,
                  expect: Optional[str] = None) -> bool:
        path = os.path.join(self._dir, f"{tag}.{rank}")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    got = f.read()
                if expect is None or got == expect:
                    return True
            except OSError:
                pass
            time.sleep(0.02)
        return False


class StoreRendezvous:
    """Rendezvous over a ``torch.distributed`` key-value store (the port's
    counterpart of the JAX package's ``JaxRendezvous`` over the
    ``jax.distributed`` coordinator): ``<namespace>/<rank>`` holds a
    rank's address, ``<namespace>/<tag>/<rank>`` a marker. ``store``
    defaults to the store of this process's world
    (``parallel/mesh.world_store``: ``net_init``'s ``TCPStore``, else the
    default process group's own); any ``torch.distributed.Store`` serves,
    e.g. a ``TCPStore`` client of a world's master."""

    _POLL_S = 0.02

    def __init__(self, store=None, namespace: str = "mv_ps"):
        if store is None:
            from multiverso_tpu_torch.parallel.mesh import world_store
            store = world_store()
            if store is None:
                raise PSError("StoreRendezvous needs a torch.distributed "
                              "world (net_init() or a launcher's) or a "
                              "store")
        self._store = store
        self._ns = namespace
        # one op at a time on the store's client connection
        self._lock = threading.Lock()

    @property
    def identity(self) -> str:
        """Equal for every StoreRendezvous of one world and namespace
        (the colocation registry's key, ``ps/spmd.proc_key``): the
        ``TCPStore``'s address when the store is one (or wraps one), else
        the store object itself."""
        st = self._store
        while not hasattr(st, "port") and hasattr(st, "underlying_store"):
            st = st.underlying_store
        where = (f"{st.host}:{st.port}" if hasattr(st, "port")
                 else f"obj{id(st)}")
        return f"store://{where}/{self._ns}"

    def _key(self, *parts) -> str:
        return "/".join((self._ns,) + tuple(str(p) for p in parts))

    def _read(self, key: str, timeout: float) -> Optional[str]:
        """The key's value once it exists, or None at the deadline
        (polled, so no call blocks the client past its deadline)."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            with self._lock:
                if self._store.check([key]):
                    return self._store.get(key).decode()
            if time.monotonic() >= deadline:
                return None
            time.sleep(self._POLL_S)

    def publish(self, rank: int, addr: str) -> None:
        with self._lock:
            self._store.set(self._key(rank), addr)

    def lookup(self, rank: int, timeout: float) -> str:
        addr = self._read(self._key(rank), timeout)
        if not addr:
            raise PSPeerError(f"rank {rank} never published an address "
                              f"({self._key(rank)} not in the world's "
                              f"store after {timeout}s)")
        return addr

    def mark(self, rank: int, tag: str, value: str = "1") -> None:
        """Publish a marker (the shutdown quiesce handshake); ``value``
        stamps it with this incarnation's identity (its address)."""
        with self._lock:
            self._store.set(self._key(tag, rank), value)

    def wait_mark(self, rank: int, tag: str, timeout: float,
                  expect: Optional[str] = None) -> bool:
        """True once ``rank``'s marker exists (and equals ``expect`` when
        given), False at the deadline."""
        deadline = time.monotonic() + max(timeout, 0.0)
        key = self._key(tag, rank)
        while True:
            got = self._read(key, deadline - time.monotonic())
            if got is not None and (expect is None or got == expect):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(self._POLL_S)


# ---------------------------------------------------------------------- #
# client side: one persistent connection per remote rank
# ---------------------------------------------------------------------- #
_peer_gen = itertools.count()   # per-incarnation msg-id bases (below)


class _Peer:
    def __init__(self, rank: int, addr: str, connect_timeout: float,
                 io_timeout: float,
                 on_death: Optional[Callable[["_Peer", Exception],
                                             None]] = None,
                 src: int = -1):
        self.rank = rank
        self.src = src     # the LOCAL rank (fault-plane src identity;
        #                    -1 = unknown, the plane falls back to its own)
        self.addr = addr   # the resolved incarnation address
        self._on_death = on_death
        host, port = addr.rsplit(":", 1)
        # connect retries ride the shared capped-exponential policy with
        # the connect timeout as the deadline
        deadline = _retry.deadline_in(connect_timeout)
        backoff = _retry.Backoff(base_s=0.05, cap_s=1.0)
        attempt = 0
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, int(port)), timeout=connect_timeout)
                break
            except OSError as e:
                if not backoff.sleep(attempt, deadline):
                    raise PSPeerError(
                        f"cannot connect to rank {rank} at {addr}: {e}"
                    ) from e
                attempt += 1
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(io_timeout)
        self._send_lock = threading.Lock()
        # reorder-injection holdback (ps/faults.py): held encoded frames,
        # released after a LATER frame ships. Touched only under
        # _send_lock, and only when the fault plane is armed
        self._held: List[bytes] = []
        self._pending: Dict[int, cf.Future] = {}
        self._pending_lock = threading.Lock()
        # msg ids start at a per-incarnation base (generation << 32), so a
        # reconnected incarnation never reuses a dying one's ids
        self._next_id = next(_peer_gen) << 32
        self._dead: Optional[Exception] = None
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name=f"ps-peer-{rank}", daemon=True)
        self._recv_thread.start()

    def _recv_loop(self) -> None:
        try:
            while True:
                try:
                    msg_type, msg_id, meta, arrays = wire.recv(self._sock)
                except TimeoutError:
                    # idle socket: the io timeout bounds blocked replies
                    # via each waiter's fut.result(timeout), not the
                    # connection's lifetime
                    continue
                if msg_type == MSG_REPLY_CHUNK:
                    # one sub-frame of a streamed reply: feed the
                    # requester's sink now; the entry stays pending until
                    # the closing MSG_REPLY_OK. A sink failure surfaces on
                    # the final frame.
                    with self._pending_lock:
                        fut = self._pending.get(msg_id)
                    if fut is not None:
                        sink = getattr(fut, "_mv_chunk_sink", None)
                        try:
                            if sink is None:
                                raise PSError(
                                    "chunked reply frame without a "
                                    "registered chunk sink")
                            sink(meta, arrays)
                        except Exception as e:  # noqa: BLE001
                            fut._mv_chunk_err = e
                    continue
                with self._pending_lock:
                    fut = self._pending.pop(msg_id, None)
                if fut is None:
                    continue
                _flight.end_op(self.rank, msg_id,
                               ok=msg_type != MSG_REPLY_ERR)
                if msg_type == MSG_REPLY_ERR:
                    fut.set_exception(PSError(
                        f"rank {self.rank}: {meta.get('error', '?')}"))
                else:
                    cerr = getattr(fut, "_mv_chunk_err", None)
                    if cerr is not None:
                        fut.set_exception(PSError(
                            f"rank {self.rank}: chunk sink failed: "
                            f"{type(cerr).__name__}: {cerr}"))
                    else:
                        fut.set_result((meta, arrays))
        except Exception as e:  # socket death: fail everything in flight
            err = PSPeerError(f"rank {self.rank} connection lost: {e}")
            self._dead = err
            with self._pending_lock:
                pending, self._pending = self._pending, {}
            # black box first, while this incarnation's unacked ops are
            # still in the recorder's in-flight table: the dump names the
            # dead rank's oldest unacked msg for postmortem. Only a death
            # with unacked traffic dumps; the sweep is scoped to our msg
            # ids (a reconnected incarnation may already have live ops)
            _flight.record(_flight.EV_PEER_DEAD, peer=self.rank,
                           note=str(e)[:120])
            if pending:
                _flight.dump_global(
                    f"peer rank {self.rank} connection lost with "
                    "requests in flight")
            _flight.RECORDER.fail_peer(self.rank, msg_ids=list(pending))
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(err)
            if self._on_death is not None:
                self._on_death(self, err)

    def request(self, msg_type: int, meta: Dict,
                arrays: Sequence[np.ndarray],
                chunk_sink: Optional[Callable] = None) -> cf.Future:
        fut: cf.Future = cf.Future()
        if chunk_sink is not None:
            # attached BEFORE the pending insert: the recv loop may see
            # the first chunk the instant the request hits the wire
            fut._mv_chunk_sink = chunk_sink
        if self._dead is not None:
            fut.set_exception(self._dead)
            return fut
        with self._send_lock:
            msg_id = self._next_id
            self._next_id += 1
            with self._pending_lock:
                self._pending[msg_id] = fut
            # probes are tracked in flight (stuck probes should age) but
            # keep their send/ack edges out of the ring — supervisor
            # polling must not wrap the tape
            _flight.begin_op(self.rank, msg_id, msg_type,
                             sum(getattr(a, "nbytes", 0) for a in arrays),
                             record=msg_type not in (MSG_PING, MSG_STATS))
            try:
                if _faults.PLANE.armed:   # fault plane (off: one load)
                    self._send_faulted(msg_type, msg_id, meta, arrays)
                else:
                    wire.send(self._sock, msg_type, msg_id, meta, arrays)
            except OSError as e:
                err = PSPeerError(f"rank {self.rank} send failed: {e}")
                self._dead = err
                _flight.end_op(self.rank, msg_id, ok=False)
                with self._pending_lock:
                    mine = self._pending.pop(msg_id, None)
                # an injected reset shuts the socket down before it
                # raises, so the recv loop may already have failed this
                # future in its death sweep
                if mine is not None:
                    fut.set_exception(err)
                if self._on_death is not None:
                    self._on_death(self, err)
                return fut
            except BaseException:
                # encode failure (bad meta, exotic array): not a peer
                # death — unwind this op (the recorder's entry too, or it
                # ages into a spurious "stuck" verdict) and re-raise
                _flight.end_op(self.rank, msg_id, ok=False)
                with self._pending_lock:
                    self._pending.pop(msg_id, None)
                raise
        # the recv loop may have died BETWEEN the entry _dead check and the
        # _pending insert — re-check so this future fails fast
        if self._dead is not None:
            with self._pending_lock:
                still = self._pending.pop(msg_id, None)
            # close the recorder's entry unconditionally (end_op is
            # idempotent): the recv loop's sweep may have run before
            # begin_op registered this op
            _flight.end_op(self.rank, msg_id, ok=False)
            if still is not None and not fut.done():
                fut.set_exception(self._dead)
        return fut

    # fault plane (ps/faults.py; reached ONLY when a scenario is armed)
    _HELD_CAP = 8   # safety ceiling on the rule's reorder depth

    def _send_faulted(self, msg_type: int, msg_id: int, meta,
                      arrays) -> None:
        """One outbound frame through the armed fault plane. Runs under
        ``_send_lock`` (the caller holds it), so the holdback list and the
        socket have one writer here. Injected partitions and resets raise
        :class:`faults.InjectedFault` (a ConnectionResetError): the
        caller's OSError handling then takes the organic peer-death path,
        which is the point."""
        plan = _faults.PLANE.plan_send(self.rank, msg_type, msg_id,
                                       src=self.src)
        if plan is None:
            wire.send(self._sock, msg_type, msg_id, meta, arrays)
            self._release_held()
            return
        if plan.delay_s:
            # a slow wire backpressures senders to this peer like a real
            # one: the sleep holds the send lock
            time.sleep(plan.delay_s)
        if plan.reset:
            # kill the conn FIRST so the recv loop observes the death
            # (fails in-flight futures, replay re-arms), then fail this
            # send as the kernel would
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise _faults.InjectedFault(
                f"injected {'/'.join(plan.kinds)} to rank {self.rank}")
        if plan.drop:
            return   # silently eaten; the caller's timeout is the signal
        buf = wire.encode(msg_type, msg_id, meta, arrays)
        if plan.reorder and len(self._held) < min(plan.depth,
                                                 self._HELD_CAP):
            self._held.append(buf)   # ships AFTER the next frame...
            timer = threading.Timer(plan.hold_s, self._release_held,
                                    kwargs={"locked": False})
            timer.daemon = True      # ...or after hold_s: a blocking
            timer.start()            # caller awaiting THIS frame's ack
            return                   # is its own only traffic source
        self._sock.sendall(buf)
        # a reorder-claimed frame never duplicates, even when the holdback
        # was full and it shipped at once, so the plane's counts and log
        # match what hit the wire
        if plan.duplicate and not plan.reorder:
            self._sock.sendall(buf)
        self._release_held()

    def _release_held(self, locked: bool = True) -> None:
        """Flush reorder-held frames (oldest first) now that a later frame
        has shipped (``locked=True``: the caller holds the send lock) or
        the hold timer fired. Socket errors are swallowed on both paths: a
        held frame dying with the conn is an injected drop, the recv loop
        owns the death signal, and the current frame's future must not
        fail for a sibling."""
        if not self._held:
            return
        if not locked:
            with self._send_lock:
                self._release_held()
            return
        held, self._held = self._held, []
        try:
            for buf in held:
                self._sock.sendall(buf)
        except OSError:
            pass

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


# ---------------------------------------------------------------------- #
# the service
# ---------------------------------------------------------------------- #
def _routable_ip() -> str:
    """Best-effort routable address of this host: the UDP-connect trick
    picks the egress interface without sending a packet."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    finally:
        s.close()


def oneshot_probe(addr: str, msg_type: int, timeout: float,
                  connect_timeout: Optional[float] = None) -> Dict:
    """One telemetry pull (MSG_HEALTH / MSG_STATS / MSG_PING) over a fresh
    one-shot connection to ``addr``; returns the reply meta. Raises the
    raw socket/wire errors; an ERR reply raises PSError."""
    host, port = addr.rsplit(":", 1)
    ct = timeout if connect_timeout is None else min(timeout,
                                                     connect_timeout)
    with socket.create_connection((host, int(port)), timeout=ct) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(timeout)
        wire.send(s, msg_type, 0, {})
        reply_type, _mid, meta, _ = wire.recv(s)
    if reply_type == MSG_REPLY_ERR:
        raise PSError(f"probe to {addr}: {meta.get('error', '?')}")
    return meta


class PSService:
    """Listener + shard registry + peer pool for one rank."""

    def __init__(self, rank: int, world: int, rendezvous=None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 defer_publish: bool = False):
        """``defer_publish=True`` holds the rendezvous publish until
        :meth:`publish_addr`: a RESTARTED shard must restore from its
        checkpoint before any survivor can discover the new address, or a
        replayed frame landing on the still-empty shard would commit its
        sequence, ack, and then be wiped by the restore (see
        ``failover.rejoin``)."""
        self.rank, self.world = rank, world
        if host is None:
            host = config.get_flag("ps_host") or "127.0.0.1"
        self._rendezvous = rendezvous
        # process-colocation identity (ps/spmd.py): services sharing a
        # process AND a rendezvous may route to each other in-process when
        # ps_fanout is armed. The registry entry appears with the
        # rendezvous publish (a deferred-publish service stays invisible
        # until its restore, the same rule as its address)
        self._proc_key = _spmd.proc_key(rendezvous)
        # ps_fanout is read ONCE, here: routing, inline dispatch and the
        # tables' copy decision (tables.py reads this attribute) must agree
        # for the service's whole life, or one owner's ops would split
        # between the executor and inline dispatch (per-owner FIFO lost)
        # and a view-passing table's request would queue on the executor
        self._fanout = bool(config.get_flag("ps_fanout"))
        self._routed_seen: set = set()
        self._routed_dead: set = set()
        self._handlers: Dict[str, Callable] = {}
        # table -> shard object for MSG_STATS / MSG_HEALTH
        self._shards: Dict[str, Any] = {}
        self._handlers_cv = threading.Condition()
        # telemetry: adopt the trace_ids / step_profile / devstats flags
        # under this service's rank (the exporter starts at the END of
        # __init__, once addr exists); the always-on flight recorder pins
        # the same rank and the watchdog thread starts (flag-gated) to age
        # its in-flight table
        _trace.configure(rank)
        _flight.configure(rank)
        _profiler.configure(rank)
        _devstats.configure(rank)
        # fault plane: adopt the rank; arms from faults_spec /
        # $MV_FAULTS_SPEC when set, else stays the null object
        _faults.configure(rank)
        log.set_rank(rank)
        _watchdog.ensure_started()
        # memory sampler (flag memstats_interval_s; the byte ledger is
        # always on and pull-only)
        _memstats.ensure_started()
        self._peers: Dict[int, _Peer] = {}
        self._peers_lock = threading.Lock()
        self._peer_locks: Dict[int, threading.Lock] = {}
        # rank -> last observed death (monotonic ts); feeds the reconnect
        # backoff and the death hooks (elastic.bind_ps)
        self._dead_ranks: Dict[int, float] = {}
        self._death_hooks: List[Callable[[int], None]] = []
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self._closed = False
        # liveness beats of the data plane (monotonic ts of the last
        # served request / applied add): MSG_HEALTH reports their ages
        self._beats: Dict[str, float] = {}
        # fire-and-forget local dispatch: ops on the local shard still
        # hop through one serial executor (per-owner FIFO)
        self._local_exec = cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ps-local")
        # native transport (flag ps_native + the built library): accepted
        # connections are adopted by C++ serving threads; _native_cb must
        # stay referenced or ctypes frees the callback trampoline under
        # the C++ threads still holding it
        self._native = None        # cleared (under _native_lock) at close
        self._native_raw = None    # NEVER cleared: punt callbacks on C++
        #                            conn threads may run right up to the
        #                            join inside server_free, which close()
        #                            calls only after those threads exit
        self._native_cb = None
        self._native_lock = threading.Lock()
        self._nconns: Dict[int, Any] = {}
        # shard incarnation generation (flag ps_generation): 0 for a first
        # boot; the failover supervisor spawns each replacement at gen + 1
        # and MSG_HEALTH echoes it. Set BEFORE the listener exists: a
        # health probe can land the instant the accept loop starts
        self.generation = int(config.get_flag("ps_generation"))
        if config.get_flag("ps_native"):
            from multiverso_tpu_torch.ps import native as ps_native
            if ps_native.available():
                self._native, self._native_cb = ps_native.server_new(
                    self._punt, rank)
                self._native_raw = self._native
        self._listener = socket.create_server(
            (host, port if port is not None else config.get_flag("ps_port")))
        # published address must be ROUTABLE: a wildcard bind advertises
        # the machine's egress IP, not 0.0.0.0
        publish_host = (_routable_ip() if host in ("", "0.0.0.0", "::")
                        else host)
        self.addr = "%s:%d" % (publish_host,
                               self._listener.getsockname()[1])
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ps-accept", daemon=True)
        self._accept_thread.start()
        self._published = False
        if rendezvous is not None and not defer_publish:
            self.publish_addr()
        # flag-gated metrics exporter with the rich (shard-aware)
        # payload; no-op unless metrics_dir is set
        _exporter.ensure_started(rank, self.stats_payload)
        # controller-side cluster observability (flag
        # stats_poll_interval_s): rank 0 polls every rank's MSG_STATS +
        # MSG_HEALTH over the one-shot probe path and keeps the merged
        # cluster time series
        if rank == 0:
            _aggregator.ensure_started(self)
        # flag-gated per-shard failover checkpointer (failover_dir +
        # failover_ckpt_interval_s): the durable half of exactly-once
        # replay; shards registered later are picked up each cycle
        _failover.ensure_checkpointer(self)
        log.debug("PSService rank %d/%d listening on %s", rank, world,
                  self.addr)

    # ----------------------------- server side ----------------------- #
    def publish_addr(self) -> None:
        """Publish this incarnation's address through the rendezvous (and
        join the process colocation registry, ps/spmd.py) — the moment
        peers may discover it. A deferred-publish (restarted) service
        calls this after its checkpoint restore: a survivor routing a
        replay onto the still-empty shard would commit, ack, and then be
        wiped by the restore. Idempotent."""
        if self._rendezvous is not None:
            self._rendezvous.publish(self.rank, self.addr)
            self._published = True
        _spmd.register_service(self)

    def beat(self, name: str) -> None:
        self._beats[name] = time.monotonic()

    def register_handler(self, table: str, handler: Callable,
                         shard=None) -> None:
        """``handler(msg_type, meta, arrays) -> (meta, arrays)``, called on
        a connection thread; the shard serializes internally. When
        ``shard`` is a host-backed linear RowShard and the native server
        is live, the shard's buffer registers with C++ for zero-Python
        serving of the hot ops — and the Python handler (which then only
        sees punted messages: compressed wires, checkpoint state, stamped
        frames) wraps itself in the native shard mutex so its buffer
        mutations serialize with C++ applies."""
        if self._native is not None and shard is not None:
            wrapped = self._try_register_native(table, handler, shard)
            if wrapped is not None:
                handler = wrapped
        with self._handlers_cv:
            self._handlers[table] = handler
            if shard is not None:
                self._shards[table] = shard
                if hasattr(shard, "service"):
                    shard.service = self
            self._handlers_cv.notify_all()
        if shard is not None:
            # stacked grouping (flag ps_spmd_stack, ps/spmd.py): colocated
            # same-table shards on one device pool into one stacked tensor
            # with grouped apply and gather. No-op unless armed and the
            # shard qualifies
            _spmd.try_join(self, table, shard)

    def _try_register_native(self, table: str, handler: Callable,
                             shard) -> Optional[Callable]:
        from multiverso_tpu_torch.ps import native as ps_native
        from multiverso_tpu_torch.ps.shard import RowShard
        from multiverso_tpu_torch.updaters import STATELESS_LINEAR
        # EXACT RowShard only: HashShard grows/remaps its buffer, which
        # would leave C++ writing through a stale pointer. _np_mode: rows
        # in a CPU tensor and a stateless signed-accumulate updater (a
        # shard on the card punts every op)
        if type(shard) is not RowShard or not shard._np_mode:
            return None
        if self._fanout:
            # process-coalesced routing (ps/spmd.py): a fan-out world's
            # traffic arrives in-process, where a native registration only
            # costs (every routed op would cross the FFI to take the C++
            # shard mutex around its whole Python handler). The C++ fast
            # path exists for socket clients, which such a world does not
            # use
            return None
        sign = STATELESS_LINEAR.get(type(shard.updater))
        if sign is None:
            return None
        nworkers = 0 if shard._dirty is None else shard._dirty.shape[0]
        with self._native_lock:
            if self._native is None:   # raced close(): python plane only
                return None
            pin = ps_native.register_shard(
                self._native, table, shard.lo, shard.n, shard.num_col,
                shard._data, sign, shard._dirty, nworkers)
        if pin is None:
            return None
        # the pin addresses THIS shard object — stable across same-name
        # re-registration and server close (a name lookup at unlock time
        # could unlock a DIFFERENT shard's mutex)
        shard.bind_native(pin)

        def locked_handler(msg_type, meta, arrays,
                           _inner=handler, _pin=pin):
            ps_native.shard_pin_lock(_pin)
            try:
                return _inner(msg_type, meta, arrays)
            finally:
                ps_native.shard_pin_unlock(_pin)

        return locked_handler

    def _punt(self, conn_id: int, frame: bytes) -> None:
        """Frames the native server can't serve, delivered synchronously
        on the C++ connection thread (per-connection FIFO preserved).
        Mirrors _serve_conn's dispatch; the reply goes back through the
        native conn's write lock."""
        from multiverso_tpu_torch.ps import native as ps_native
        try:
            msg_type, msg_id, meta, arrays = wire.parse_frame(frame)
        except wire.WireError as e:
            # Header was sane (C++ validated magic/bounds) but the body
            # failed to parse. The python plane fails fast by killing the
            # connection; silently dropping here would instead park the
            # peer for the full ps_timeout. The header's msg_id is still
            # trustworthy, so send an ERR reply the peer can raise on.
            log.debug("ps native punt: malformed frame (%s)", e)
            try:
                reply = wire.encode(MSG_REPLY_ERR, wire.peek_msg_id(frame),
                                    {"error": f"WireError: {e}"})
                ps_native.send_raw(self._native_raw, conn_id, reply)
            except Exception:   # noqa: BLE001
                log.debug("ps native punt: ERR reply for malformed frame "
                          "failed; dropping")
            return
        # the serve beat and the ring edges mark data-plane liveness:
        # probes refresh neither (a wedged server polled at 2 Hz must
        # report a growing serve age, and probe noise must not wrap the
        # ring past the pre-wedge evidence)
        probe = msg_type in (MSG_PING, MSG_STATS, MSG_HEALTH)
        if not probe:
            self.beat("serve")
            _flight.record(_flight.EV_RECV, msg_type=msg_type,
                           msg_id=msg_id)
        try:
            if msg_type == MSG_PING:       # native serves PING; belt only
                reply = wire.encode(MSG_REPLY_OK, msg_id,
                                    {"rank": self.rank})
            elif msg_type == MSG_STATS:
                reply = wire.encode(MSG_REPLY_OK, msg_id,
                                    self.stats_payload())
            elif msg_type == MSG_HEALTH:
                reply = wire.encode(MSG_REPLY_OK, msg_id,
                                    self.health_payload())
            else:
                tr = (meta.get(wire.TRACE_META_KEY)
                      if _trace.enabled() else None)
                t0 = time.time() if tr is not None else 0.0
                if msg_type == MSG_MULTI:
                    with monitor("ps[multi].serve"):
                        rmeta, rarrays = self._handle_multi(meta, arrays)
                else:
                    handler = self._wait_handler(meta["table"])
                    with monitor(f"ps[{meta['table']}].serve"):
                        rmeta, rarrays = handler(msg_type, meta, arrays)
                if tr is not None:
                    _trace.add_span("ps.serve", t0, time.time(), trace=tr,
                                    args={"table": meta.get("table",
                                                            "multi"),
                                          "type": msg_type})
                if isinstance(rarrays, wire.ChunkedReply):
                    # streamed reply over the native conn: each chunk goes
                    # through send_raw (the conn's C++ write lock orders
                    # them); the closing OK is the `reply` below
                    for cmeta, carrays in rarrays.chunks:
                        ps_native.send_raw(
                            self._native_raw, conn_id,
                            wire.encode(MSG_REPLY_CHUNK, msg_id, cmeta,
                                        carrays))
                        _flight.record(_flight.EV_GET_CHUNK,
                                       msg_type=msg_type, msg_id=msg_id)
                    rmeta, rarrays = rarrays.meta, ()
                reply = wire.encode(MSG_REPLY_OK, msg_id, rmeta, rarrays)
        except Exception as e:   # noqa: BLE001 — reply errors
            log.debug("ps handler error: %s", e)
            if isinstance(e, MemoryError):
                # OOM forensics: dump the ledger while the hoards are
                # still reachable
                _memstats.oom_dump("MemoryError serving a punted request")
            reply = wire.encode(MSG_REPLY_ERR, msg_id,
                                {"error": f"{type(e).__name__}: {e}"})
        # _native_raw, not _native: close() clears the latter while punts
        # may still be in flight; the raw handle stays valid until
        # server_free (which runs after this conn thread is joined)
        if not probe:
            _flight.record(_flight.EV_REPLY, msg_type=msg_type,
                           msg_id=msg_id, nbytes=len(reply))
        ps_native.send_raw(self._native_raw, conn_id, reply)

    # ----------------------------- telemetry -------------------------- #
    def stats_payload(self) -> Dict:
        """This rank's telemetry snapshot (the MSG_STATS reply meta and
        the exporter record share this one shape): Dashboard monitor
        histograms, notes, per-shard server stats and the additive
        blocks (serving, profile, memory, devices, tenants, slo),
        JSON-safe."""
        shards = {}
        with self._handlers_cv:
            items = list(self._shards.items())
        for table, shard in items:
            try:
                stats = shard.stats()
            except Exception as e:  # noqa: BLE001 — one bad shard must
                stats = {"error": f"{type(e).__name__}: {e}"}  # not hide
            shards[table] = stats                              # the rest
        # ONE record shape: the monitors/notes assembly is the exporter's
        # (default_stats_fn), overlaid with this service's identity
        payload = _exporter.default_stats_fn()
        payload.update(rank=self.rank, world=self.world, addr=self.addr,
                       shards=shards)
        # the serving plane: this process's read replicas and pools (lag,
        # versions, cache hit rate, shed counters)
        try:
            serving = _serving_replica.stats_snapshot()
            if serving:
                payload["serving"] = serving
        except Exception:   # noqa: BLE001 — telemetry never raises
            pass
        # step-profiler block (flag step_profile): stall fraction and
        # the steady-state recompile summary, process-global
        try:
            profile = _profiler.stats_snapshot()
            if profile:
                payload["profile"] = profile
        except Exception:   # noqa: BLE001
            pass
        # memory plane: the byte ledger + RSS + recent leak verdicts,
        # always present (the ledger is always on)
        try:
            payload["memory"] = _memstats.stats_snapshot()
        except Exception:   # noqa: BLE001
            pass
        # device plane: transfer counters + the per-device census,
        # omitted when nothing ran on the device plane
        try:
            devices = _devstats.stats_snapshot()
            if devices:
                payload["devices"] = devices
        except Exception:   # noqa: BLE001
            pass
        # tenant attribution plane: per-tenant serve ledger + budgets +
        # the noisy-neighbor verdict sweep (the pull drives one sweep
        # interval); omitted when no tenant traffic was accounted
        try:
            tenants = _tenants.stats_snapshot()
            if tenants:
                payload["tenants"] = tenants
        except Exception:   # noqa: BLE001
            pass
        # SLO sentinel: per-objective burn rates, firing state, episode
        # counts and the named straggler; omitted while disarmed
        try:
            slo_block = _slo.stats_snapshot()
            if slo_block:
                payload["slo"] = slo_block
        except Exception:   # noqa: BLE001
            pass
        return payload

    def stats(self, rank: int, timeout: Optional[float] = None) -> Dict:
        """Pull ``rank``'s telemetry snapshot over MSG_STATS (the local
        rank short-circuits). Raises PSPeerError for a dead rank."""
        if rank == self.rank:
            return self.stats_payload()
        fut = self._peer(rank).request(MSG_STATS, {}, ())
        meta, _ = await_reply(
            fut, timeout or config.get_flag("ps_timeout"),
            f"stats from rank {rank}")
        return meta

    def health_payload(self) -> Dict:
        """This rank's compact liveness verdict (the MSG_HEALTH reply
        meta): serve and apply beat ages, summed shard apply-queue depth
        and the client's requests in flight. Counter reads ONLY — no
        shard lock: a health probe must answer when the data plane is
        wedged."""
        with self._handlers_cv:
            shards = list(self._shards.values())
        queue_depth = 0
        for s in shards:
            depth = getattr(s, "queue_depth", None)
            if callable(depth):
                queue_depth += depth()
        now = time.monotonic()

        def age(name):
            t = self._beats.get(name)
            return None if t is None else round(now - t, 3)

        # ONE in-flight snapshot serves both fields (oldest + count): this
        # path contends the hot-path ring lock and is polled
        snap = _flight.RECORDER.inflight_snapshot()
        oldest = (max(snap, key=lambda e: e[2]) if snap else None)
        wd = _watchdog.last_verdict()
        return {
            "rank": self.rank, "addr": self.addr, "gen": self.generation,
            "ts": round(time.time(), 3),
            # the native server is live: natively served ops refresh no
            # beat, so a consumer discounts quiet beats on such a rank
            "native": self._native_raw is not None,
            "serve_age_s": age("serve"), "apply_age_s": age("apply"),
            "queue_depth": queue_depth,
            "inflight": len(snap),
            "oldest_inflight_s": (round(oldest[2], 3) if oldest else 0.0),
            "oldest_inflight": ({"peer": oldest[0], "msg_id": oldest[1],
                                 "type": oldest[3]} if oldest else None),
            "watchdog": wd,
            # headline verdict: the watchdog's view when it has run, else
            # "ok" (an unwatched plane that answered this RPC is serving)
            "status": wd["status"] if wd.get("checked") else "ok",
        }

    def health(self, rank: int, timeout: Optional[float] = None) -> Dict:
        """Pull ``rank``'s liveness verdict over MSG_HEALTH, on its OWN
        one-shot connection (never behind the shared data conn), with
        ``ps_health_timeout``. Raises PSPeerError for a dead rank."""
        return self._oneshot_pull(rank, MSG_HEALTH, timeout)

    def stats_oneshot(self, rank: int,
                      timeout: Optional[float] = None) -> Dict:
        """MSG_STATS over the probe path (own one-shot connection,
        triage-scale timeout)."""
        return self._oneshot_pull(rank, MSG_STATS, timeout)

    def _probe_addr(self, rank: int, timeout: float) -> str:
        """``rank``'s address for a one-shot probe, without the data
        plane's reconnect backoff: a healthy cached peer donates its
        addr, else the rendezvous re-resolves."""
        with self._peers_lock:
            peer = self._peers.get(rank)
        if peer is not None and peer._dead is None:
            return peer.addr
        if self._rendezvous is not None:
            try:
                return self._rendezvous.lookup(
                    rank, min(config.get_flag("ps_connect_timeout"),
                              timeout))
            except PSError:
                if peer is None:
                    raise
                return peer.addr   # dead peer's last known address
        if peer is not None:
            return peer.addr
        raise PSError("no rendezvous configured for remote ranks")

    def _oneshot_pull(self, rank: int, msg_type: int,
                      timeout: Optional[float] = None) -> Dict:
        if rank == self.rank:
            return (self.health_payload() if msg_type == MSG_HEALTH
                    else self.stats_payload())
        timeout = timeout or config.get_flag("ps_health_timeout")
        addr = self._probe_addr(rank, timeout)
        # retries inside ONE overall timeout (deadline propagation)
        deadline = _retry.deadline_in(timeout)
        try:
            return _retry.call_with_retries(
                lambda: oneshot_probe(
                    addr, msg_type,
                    max(_retry.remaining_s(deadline, timeout), 0.05),
                    config.get_flag("ps_connect_timeout")),
                attempts=config.get_flag("ps_probe_attempts"),
                deadline=deadline,
                retry_on=(OSError, wire.WireError, TimeoutError),
                backoff=_retry.Backoff(base_s=0.05, cap_s=0.5))
        except (OSError, wire.WireError, TimeoutError) as e:
            raise PSPeerError(
                f"probe (type 0x{msg_type:X}) to rank {rank} at {addr} "
                f"failed: {e}") from e

    # ------------------------- multi-owner super-frames --------------- #
    def _owner_service(self, owner: int) -> "PSService":
        """A super-frame sub-op's owning service: this rank, or a
        colocated sibling through the process registry (ps/spmd.py). A
        previously routed owner observed gone raises the typed peer error
        AND fires the death hooks once, as a dying socket would (the
        send-window replay plane re-arms off that hook). An owner that
        was never colocated is a routing error."""
        if owner == self.rank:
            return self
        svc, err = self._colocated(owner)
        if err is not None:
            raise err
        if svc is not None:
            return svc
        raise PSError(
            f"super-frame sub-op for rank {owner}, which is not "
            f"colocated with rank {self.rank}")

    def multi_local(self, subs: Sequence[Tuple[int, Dict, Sequence]]
                    ) -> List[cf.Future]:
        """In-process super-frame dispatch from Python objects (no wire
        encode on either side): every sub-op runs INLINE on the caller's
        thread against its colocated owner (grouped and host fast paths
        included), and one future per sub resolves. Program order is
        per-owner FIFO; an executor hop would cost two thread wakeups per
        op."""
        futs: List[cf.Future] = [cf.Future() for _ in subs]
        try:
            results = self._handle_multi_obj(subs)
        except Exception as e:   # noqa: BLE001 — transport-level
            for f in futs:
                f.set_exception(e)
            return futs
        for f, (ok, rm, ra) in zip(futs, results):
            if ok:
                f.set_result((rm, ra))
            elif rm.get("peer"):
                # rethrow TYPED: callers branch on PSPeerError (a dead
                # owner) vs PSError, and a sub-op riding a super-frame
                # must not lose that
                f.set_exception(PSPeerError(rm.get("error", "?")))
            else:
                f.set_exception(PSError(rm.get("error", "?")))
        return futs

    def _handle_multi(self, meta: Dict, arrays: Sequence[np.ndarray]
                      ) -> Tuple[Dict, List[np.ndarray]]:
        """Wire entry for a MSG_MULTI super-frame: unpack the inner
        frames, run them, and pack the inner replies (OK or ERR per sub,
        in order) the same way."""
        subs = wire.unpack_batch(arrays)
        results = self._handle_multi_obj(subs)
        blobs = [wire.encode(MSG_REPLY_OK if ok else MSG_REPLY_ERR,
                             i, rm, ra)
                 for i, (ok, rm, ra) in enumerate(results)]
        return {"n": len(subs)}, wire.pack_batch(blobs)

    def _handle_multi_obj(self, subs: Sequence[Tuple[int, Dict, Sequence]]
                          ) -> List[Tuple[bool, Dict, Any]]:
        """The super-frame sub-op engine: each ``(msg_type, meta,
        arrays)`` sub-op goes to its owning colocated shard and comes
        back as ``(ok, reply_meta, reply_arrays)``. Plain (unstamped) row
        adds and gets of shards in an ACTIVE stacked plane (ps/spmd.py)
        collapse into one grouped apply and one grouped gather per plane;
        CPU shards with a linear updater that only Python serves apply at
        once (``RowShard._apply_now``: no coalescing-queue round trip, the
        caller's thread is the one server of its routed ops) and serve
        through ``_serve_get_rows``; everything
        else — batch frames, replay-stamped frames, state ops, natively
        registered shards — goes through the shard's ordinary handler in
        frame order. A failing sub-op fails alone (sub K failing does not
        fail sub K+1). Grouping needs every owner to appear once, else
        the whole frame takes the per-sub path."""
        from multiverso_tpu_torch.ps.shard import RowShard as _RowShard
        n = len(subs)
        results: List[Optional[Tuple[bool, Dict, Any]]] = [None] * n
        owners = [int(m.get(wire.OWNER_META_KEY, self.rank))
                  for _mt, m, _a in subs]
        groupable = len(set(owners)) == n
        add_group: List[Tuple[int, Any, Dict, Sequence]] = []
        get_group: List[Tuple[int, Any, Dict, Sequence]] = []
        direct: List[int] = []
        for i, (mt, m, arrs) in enumerate(subs):
            shard = None
            if groupable and mt in (MSG_ADD_ROWS, MSG_GET_ROWS):
                try:
                    shard = self._owner_service(
                        owners[i])._shards.get(m.get("table"))
                except PSError as e:
                    results[i] = (False, _sub_err(e), [])
                    continue
            plane = getattr(shard, "_plane", None)
            stacked = plane is not None and plane.active
            # the host fast path: exactly a RowShard in _np_mode that the
            # C++ server does not hold (a registered shard keeps its
            # handler, whose wrapper takes the native shard mutex)
            np_fast = (type(shard) is _RowShard and shard._np_mode
                       and shard._native_ref is None)
            if (mt == MSG_ADD_ROWS and wire.REPLAY_CLIENT_KEY not in m
                    and (stacked or np_fast)):
                add_group.append((i, shard, m, arrs))
            elif (mt == MSG_GET_ROWS and not m.get("sparse")
                    and not m.get("chunk") and (stacked or np_fast)):
                get_group.append((i, shard, m, arrs))
            else:
                direct.append(i)
        if add_group:
            entries = []
            for i, shard, m, arrs in add_group:
                try:
                    local, vals, opt = shard._prep_add(m, arrs)
                    entries.append((i, shard, local, vals, opt))
                except Exception as e:  # noqa: BLE001 — per sub
                    results[i] = (False, _sub_err(e), [])
            planes: Dict[int, List] = {}
            for ent in entries:
                i, s, l, v, o = ent
                p = s._plane
                if p is not None and p.active:
                    planes.setdefault(id(p), []).append(ent)
                    continue
                # host fast path: apply at once under the shard lock (the
                # coalescing queue merges CONCURRENT senders' adds; a
                # routed caller applies in program order)
                try:
                    s._apply_now(l, v, o)
                    results[i] = (True, {}, [])
                except Exception as e:  # noqa: BLE001 — per sub
                    results[i] = (False, _sub_err(e), [])
            for group in planes.values():
                plane = group[0][1]._plane
                try:
                    strays = plane.apply_grouped(
                        [(s, l, v, o) for _i, s, l, v, o in group])
                except Exception as e:  # noqa: BLE001 — the round's subs
                    err = _sub_err(e)
                    for i, *_rest in group:
                        results[i] = (False, dict(err), [])
                    continue
                stray_ids = {id(st[0]) for st in strays}
                for i, s, l, v, o in group:
                    if id(s) in stray_ids:
                        # evicted since it was grouped: the classic path
                        try:
                            s._add_rows(l, v, o)
                            results[i] = (True, {}, [])
                        except Exception as e:  # noqa: BLE001 — per sub
                            results[i] = (False, _sub_err(e), [])
                        continue
                    with s._lock:
                        s._record_wave(1)
                        s._stat_adds += 1
                        s._stat_applies += 1
                    results[i] = (True, {}, [])
        if get_group:
            pairs = []
            for i, shard, m, arrs in get_group:
                p = shard._plane
                try:
                    if p is None or not p.active:
                        # host fast path: the shard's own off-lock serve
                        results[i] = (True, *shard._serve_get_rows(m, arrs))
                        continue
                    local = shard._localize_raw(arrs[0])
                    shard._note_rows(local)
                    pairs.append((i, shard, m, local))
                except Exception as e:  # noqa: BLE001 — per sub
                    results[i] = (False, _sub_err(e), [])
            gplanes: Dict[int, List] = {}
            for ent in pairs:
                gplanes.setdefault(id(ent[1]._plane), []).append(ent)
            for group in gplanes.values():
                plane = group[0][1]._plane
                try:
                    blocks = plane.gather_grouped(
                        [(s, l) for _i, s, _m, l in group])
                except Exception as e:  # noqa: BLE001 — the round's subs
                    err = _sub_err(e)
                    for i, *_rest in group:
                        results[i] = (False, dict(err), [])
                    continue
                for (i, s, m, l), rows in zip(group, blocks):
                    try:
                        if rows is None:
                            # evicted since it was grouped: classic serve
                            results[i] = (True,
                                          *s._serve_get_rows(m, [l + s.lo]))
                            continue
                        s._stat_gets += 1
                        _flight.record(_flight.EV_GET_SERVE,
                                       nbytes=l.size * s.num_col
                                       * s.dtype.itemsize)
                        results[i] = (True, *s._encode_reply(rows, m))
                    except Exception as e:  # noqa: BLE001 — per sub
                        results[i] = (False, _sub_err(e), [])
        # everything else: in-order per-sub dispatch through the owning
        # shard's ordinary handler (stamp gates, batch waves and native
        # mutex wrappers apply exactly as for a direct frame)
        for i in direct:
            mt, m, arrs = subs[i]
            try:
                svc2 = self._owner_service(owners[i])
                handler = svc2._wait_handler(m["table"])
                with monitor(f"ps[{m['table']}].serve"):
                    rmeta, rarrays = handler(mt, m, arrs)
                if isinstance(rarrays, wire.ChunkedReply):
                    raise PSError("chunk-streamed replies cannot ride a "
                                  "super-frame")
                results[i] = (True, rmeta, rarrays)
            except Exception as e:  # noqa: BLE001 — per sub
                results[i] = (False, _sub_err(e), [])
        return results

    def _wait_handler(self, table: str, timeout: float = 20.0) -> Callable:
        # a worker can race ahead of a peer still constructing its tables:
        # the server waits for the handler
        with self._handlers_cv:
            deadline = time.monotonic() + timeout
            while table not in self._handlers:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._handlers_cv.wait(remaining):
                    raise PSError(f"no such table {table!r} on rank "
                                  f"{self.rank} (after {timeout}s)")
            return self._handlers[table]

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # single read: close()'s leak branch clears self._native while
            # this thread may be between the check and the call
            native = self._native
            if native is not None:
                from multiverso_tpu_torch.ps import native as ps_native
                # hand the fd to a C++ serving thread (detach: the C++
                # side owns it now; close() reaches it via the native
                # server, not self._conns)
                ps_native.serve_fd(native, conn.detach())
                continue
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="ps-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._closed:
                msg_type, msg_id, meta, arrays = wire.recv(conn)
                # serve-loop beat + request edge for the black box; probes
                # neither beat nor hit the ring (see _punt)
                if msg_type not in (MSG_PING, MSG_STATS, MSG_HEALTH):
                    self.beat("serve")
                    _flight.record(_flight.EV_RECV, msg_type=msg_type,
                                   msg_id=msg_id)
                if msg_type == MSG_PING:
                    with send_lock:
                        wire.send(conn, MSG_REPLY_OK, msg_id,
                                  {"rank": self.rank})
                    continue
                if msg_type in (MSG_STATS, MSG_HEALTH):  # telemetry pulls
                    try:
                        payload = (self.stats_payload()
                                   if msg_type == MSG_STATS
                                   else self.health_payload())
                    except Exception as e:  # noqa: BLE001
                        with send_lock:
                            wire.send(conn, MSG_REPLY_ERR, msg_id,
                                      {"error": f"{type(e).__name__}: {e}"})
                        continue
                    with send_lock:
                        wire.send(conn, MSG_REPLY_OK, msg_id, payload)
                    continue
                try:
                    # fault plane: slow-serve sleeps before the handler (a
                    # slow RANK, not a slow wire); drop_reply serves the
                    # request but never answers — an ack lost after the
                    # apply, which the client's replay must dedupe
                    drop_reply = False
                    if _faults.PLANE.armed:
                        _slow_s, drop_reply = _faults.PLANE.plan_serve(
                            msg_type, msg_id, rank=self.rank)
                        if _slow_s:
                            time.sleep(_slow_s)
                    tr = (meta.get(wire.TRACE_META_KEY)
                          if _trace.enabled() else None)
                    t0 = time.time() if tr is not None else 0.0
                    if msg_type == MSG_MULTI:
                        with monitor("ps[multi].serve"):
                            rmeta, rarrays = self._handle_multi(meta,
                                                                arrays)
                    else:
                        handler = self._wait_handler(meta["table"])
                        with monitor(f"ps[{meta['table']}].serve"):
                            rmeta, rarrays = handler(msg_type, meta,
                                                     arrays)
                    if tr is not None:
                        _trace.add_span("ps.serve", t0, time.time(),
                                        trace=tr,
                                        args={"table": meta.get(
                                            "table", "multi"),
                                              "type": msg_type})
                    if isinstance(rarrays, wire.ChunkedReply):
                        # streamed get reply: one MSG_REPLY_CHUNK per
                        # sub-frame as the generator yields, closed by
                        # the ordinary OK
                        for cmeta, carrays in rarrays.chunks:
                            if drop_reply:
                                continue   # drain, send nothing
                            with send_lock:
                                wire.send(conn, MSG_REPLY_CHUNK, msg_id,
                                          cmeta, carrays)
                            _flight.record(_flight.EV_GET_CHUNK,
                                           msg_type=msg_type,
                                           msg_id=msg_id)
                        rmeta, rarrays = rarrays.meta, ()
                    if not drop_reply:
                        with send_lock:
                            wire.send(conn, MSG_REPLY_OK, msg_id, rmeta,
                                      rarrays)
                        _flight.record(_flight.EV_REPLY,
                                       msg_type=msg_type, msg_id=msg_id)
                except Exception as e:  # reply errors, don't kill the conn
                    log.debug("ps handler error: %s", e)
                    if isinstance(e, MemoryError):
                        # OOM forensics (same rule as the punt path)
                        _memstats.oom_dump(
                            "MemoryError serving a request")
                    with send_lock:
                        wire.send(conn, MSG_REPLY_ERR, msg_id,
                                  {"error": f"{type(e).__name__}: {e}"})
                    # the ERR reply is a reply edge too: without it a
                    # handler error reads as "received, never answered"
                    _flight.record(_flight.EV_REPLY, msg_type=msg_type,
                                   msg_id=msg_id, note="err")
        except (wire.WireError, OSError):
            pass  # client went away; its shard traffic simply stops
        finally:
            conn.close()
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass   # already cleared by close()

    # ----------------------------- client side ----------------------- #
    def add_death_hook(self, fn: Callable[[int], None]) -> None:
        """``fn(rank)`` runs when a peer connection is observed dead (the
        PS plane's failure signal, elastic.bind_ps)."""
        self._death_hooks.append(fn)

    def dead_ranks(self) -> List[int]:
        """Ranks whose connection died and has not been re-established."""
        with self._peers_lock:
            return sorted(self._dead_ranks)

    def _note_death(self, rank: int, hooks: bool = True,
                    peer: Optional[_Peer] = None) -> None:
        """``hooks=False`` records the failure for reconnect backoff only
        (a lookup/connect timeout may just mean the rank has not started
        yet). ``peer`` identifies the reporting incarnation: a LATE
        callback from a superseded peer must not re-tombstone a rank whose
        fresh connection is already healthy (the stale-incarnation
        rule)."""
        with self._peers_lock:
            cur = self._peers.get(rank)
            if (peer is not None and cur is not None and cur is not peer
                    and cur._dead is None):
                return   # stale incarnation reporting after replacement
            self._dead_ranks[rank] = time.monotonic()
        if not hooks:
            return
        for fn in self._death_hooks:
            try:
                fn(rank)
            except Exception as e:   # a hook must never break the plane
                log.error("ps death hook failed for rank %d: %s", rank, e)

    def _peer(self, rank: int) -> _Peer:
        # two-phase: the global lock only guards the dict; the (slow)
        # rendezvous lookup + connect runs under a PER-RANK lock, so a dead
        # rank's connect_timeout cannot stall requests to healthy ranks
        with self._peers_lock:
            peer = self._peers.get(rank)
            if peer is not None and peer._dead is None:
                self._dead_ranks.pop(rank, None)
                return peer
            # known-dead rank: fail fast inside the backoff window, else
            # re-resolve (a restarted rank republished its address)
            last = self._dead_ranks.get(rank)
            if (last is not None and time.monotonic() - last
                    < config.get_flag("ps_reconnect_backoff")):
                raise (peer._dead if peer is not None else PSPeerError(
                    f"rank {rank} unreachable (in reconnect backoff)"))
            if peer is not None:
                del self._peers[rank]
                peer.close()   # release the dead socket fd now, not at GC
            lock = self._peer_locks.setdefault(rank, threading.Lock())
        with lock:
            with self._peers_lock:
                peer = self._peers.get(rank)
                if peer is not None and peer._dead is None:
                    return peer
            if self._rendezvous is None:
                raise PSError("no rendezvous configured for remote ranks")
            try:
                addr = self._rendezvous.lookup(
                    rank, config.get_flag("ps_connect_timeout"))
                peer = _Peer(rank, addr,
                             config.get_flag("ps_connect_timeout"),
                             config.get_flag("ps_timeout"),
                             on_death=lambda p, e, r=rank:
                                 self._note_death(r, peer=p),
                             src=self.rank)
            except PSError:
                # lookup/connect failure: backoff yes, death hooks no
                self._note_death(rank, hooks=False)
                raise
            with self._peers_lock:
                stale = self._peers.get(rank)
                self._peers[rank] = peer
                self._dead_ranks.pop(rank, None)   # fresh incarnation
            if stale is not None:
                stale.close()
            return peer

    # ------------------------- native client side --------------------- #
    def native_enabled(self) -> bool:
        """True when this process can open native client connections (the
        remote end may still be pure-Python — the wire is identical)."""
        if not config.get_flag("ps_native"):
            return False
        from multiverso_tpu_torch.ps import native as ps_native
        return ps_native.available()

    def native_conn(self, rank: int):
        """Native client connection to ``rank`` (NativeConn), created
        lazily; the local rank is reached over loopback too. Liveness,
        rendezvous and reconnect-backoff bookkeeping stay with the python
        :meth:`_peer` (which this piggybacks for the address); a native
        conn observed dead is simply dropped, and the next op re-resolves
        through _peer, so a restarted rank's fresh address is honoured.
        Raises PSPeerError like _peer."""
        from multiverso_tpu_torch.ps import native as ps_native
        with self._peers_lock:
            c = self._nconns.get(rank)
        if c is not None and not c.dead():
            return c
        addr = self.addr if rank == self.rank else self._peer(rank).addr
        try:
            c2 = ps_native.NativeConn(addr,
                                      config.get_flag("ps_connect_timeout"),
                                      config.get_flag("ps_timeout"))
        except ps_native.NativeConnError as e:
            raise PSPeerError(f"rank {rank}: {e}") from e
        with self._peers_lock:
            old = self._nconns.get(rank)
            if old is not None and not old.dead():
                # lost the race to another thread: use theirs
                c2.close()
                return old
            self._nconns[rank] = c2
        if old is not None:
            old.close()
        return c2

    def native_conn_or_none(self, rank: int):
        """:meth:`native_conn` with unreachable ranks mapped to None (the
        fan-out paths turn those into failed futures per owner)."""
        try:
            return self.native_conn(rank)
        except PSError:
            return None

    def drop_native_conn(self, rank: int, conn) -> None:
        """Forget a native conn observed dead (death bookkeeping belongs
        to the python peer plane, which sees the same failure on its own
        socket)."""
        with self._peers_lock:
            if self._nconns.get(rank) is conn:
                del self._nconns[rank]
        conn.close()

    def native_conns(self):
        with self._peers_lock:
            return list(self._nconns.values())

    def request(self, rank: int, msg_type: int, meta: Dict,
                arrays: Sequence[np.ndarray] = (),
                meta_b: Optional[bytes] = None,
                chunk_sink: Optional[Callable] = None) -> cf.Future:
        """Uncoordinated request to ``rank``; the local rank short-circuits
        the socket but keeps async dispatch order via the local executor.
        ``meta_b`` (wire.pack_meta) serializes a fan-out op's meta once.
        ``chunk_sink(meta, arrays)`` consumes the sub-frames of a
        chunk-streamed reply. NEVER raises: a dead/unreachable rank
        yields a future carrying PSPeerError."""
        if rank == self.rank:
            return self._dispatch_inproc(self, msg_type, meta, arrays,
                                         chunk_sink)
        # process-coalesced routing (ps/spmd.py; flag ps_fanout): a
        # COLOCATED rank's request skips the localhost socket and runs in
        # the owning service's handler. A routed rank observed gone fails
        # fast like a dead peer AND fires the death hooks, so the
        # send-window replay plane re-arms as it would off a dying socket
        rsvc, rerr = self._route(rank)
        if rerr is not None:
            fut: cf.Future = cf.Future()
            fut.set_exception(rerr)
            return fut
        if rsvc is not None:
            return self._dispatch_inproc(rsvc, msg_type, meta, arrays,
                                         chunk_sink)
        try:
            return self._peer(rank).request(
                msg_type, meta if meta_b is None else meta_b, arrays,
                chunk_sink=chunk_sink)
        except PSError as e:
            fut = cf.Future()
            fut.set_exception(e if isinstance(e, PSPeerError)
                              else PSPeerError(str(e)))
            return fut

    def _route(self, rank: int):
        """Resolve ``rank`` to a live colocated service while ps_fanout is
        armed (see :meth:`_colocated`); ``(None, None)`` = not routed: use
        the socket path."""
        if self._proc_key is None or not self._fanout:
            return None, None
        return self._colocated(rank)

    def _colocated(self, rank: int):
        """``(service, None)`` for a live colocated ``rank``; ``(None,
        PSPeerError)`` once a rank seen colocated is observed gone (its
        death hooks fire once, as for a dying socket); ``(None, None)``
        for a rank never colocated."""
        svc = _spmd.colocated_service(self._proc_key, rank)
        if svc is not None:
            self._routed_seen.add(rank)
            if rank in self._routed_dead:
                # a fresh incarnation registered (respawn): clear the
                # tombstone so routing resumes without backoff, and a
                # second death fires the hooks again
                self._routed_dead.discard(rank)
                with self._peers_lock:
                    self._dead_ranks.pop(rank, None)
            return svc, None
        if rank in self._routed_seen:
            err = PSPeerError(f"rank {rank} (in-process route) is down")
            if rank not in self._routed_dead:
                self._routed_dead.add(rank)
                self._note_death(rank)
            return None, err
        return None, None

    def _dispatch_inproc(self, svc: "PSService", msg_type: int,
                         meta: Dict, arrays,
                         chunk_sink: Optional[Callable]) -> cf.Future:
        """The local short-circuit, for this service or a colocated one.
        With ``ps_fanout`` armed the dispatch runs INLINE on the caller's
        thread (program order is per-owner FIFO, and two thread wakeups
        per op are saved); with it off, on this service's serial executor
        (fire-and-forget timing, per-owner FIFO)."""
        fut: cf.Future = cf.Future()

        def _run():
            try:
                if msg_type == MSG_MULTI:
                    rmeta, rarrays = svc._handle_multi(meta, arrays)
                else:
                    handler = svc._wait_handler(meta["table"])
                    rmeta, rarrays = handler(msg_type, meta, arrays)
                if isinstance(rarrays, wire.ChunkedReply):
                    if chunk_sink is None:
                        raise PSError(
                            "chunked reply without a chunk sink on "
                            "the local path")
                    for cmeta, carrays in rarrays.chunks:
                        chunk_sink(cmeta, carrays)
                    rmeta, rarrays = rarrays.meta, []
                fut.set_result((rmeta, rarrays))
            except Exception as e:
                fut.set_exception(e)

        if self._fanout:
            _run()
        else:
            self._local_exec.submit(_run)
        return fut

    def ping(self, rank: int, timeout: Optional[float] = None) -> bool:
        if rank == self.rank:
            return True
        try:
            self._peer(rank).request(MSG_PING, {}, ()).result(
                timeout or config.get_flag("ps_timeout"))
            return True
        except (PSError, cf.TimeoutError):
            return False

    def close(self) -> None:
        # the cluster aggregator polls THROUGH this service: stop it
        # (final short-timeout poll included) while the probe path is
        # still alive. The shard checkpointer stops with a FINAL save
        # while the shards are intact: a cleanly closing rank's tail of
        # applies stays durable for whoever inherits its rows
        _aggregator.stop_if_bound(self)
        _failover.stop_if_bound(self)
        self._closed = True
        # the mesh data plane (ps/spmd.py): leave the routing registry (so
        # colocated clients observe this rank's death like a dead socket)
        # and evict this service's shards from their stacked groups; they
        # keep working standalone for the checkpointer's final save
        _spmd.release_service(self)
        # shutdown, not just close: close() does not wake a thread blocked
        # in accept() on Linux
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # the accept thread must be DONE before the native server is
        # freed: it could otherwise adopt a last-instant connection into
        # freed memory
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=10.0)
        if self._accept_thread.is_alive():
            # a wedged accept thread could still call serve_fd into the
            # native server: leak the server instead of freeing it (its
            # C++ threads keep the callback trampoline, so _native_cb
            # stays referenced too)
            log.error("ps service close: accept thread did not exit in "
                      "10s; leaking native server instead of freeing it")
            with self._native_lock:
                self._native = None
        # drop accepted connections too, so an in-process "killed" service
        # actually goes silent (a killed OS process gets this for free)
        with self._conns_lock:
            for conn in self._conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
            self._conns.clear()
        with self._native_lock:
            native, self._native = self._native, None
        if native is not None:
            from multiverso_tpu_torch.ps import native as ps_native
            # server_close shuts the adopted connections down; server_free
            # then joins the C++ serving threads (an in-flight punt
            # finishes first: ctypes released the GIL for this call)
            ps_native.server_close(native)
            ps_native.server_free(native)
            self._native_cb = None
        with self._peers_lock:
            nconns, self._nconns = list(self._nconns.values()), {}
            for peer in self._peers.values():
                peer.close()
            self._peers.clear()
        for c in nconns:
            c.close()
        self._local_exec.shutdown(wait=True)


# ---------------------------------------------------------------------- #
# default per-process context
# ---------------------------------------------------------------------- #
class PSContext:
    """Bundle of (rank, world, service, device) used by the async tables.
    ``device`` is where this rank's shards live: the card unless the
    caller names another device (``device="cpu"``); ``None`` takes the
    Zoo's device when the runtime is up, else resolves as ``init()``
    does. Tests construct standalone contexts to simulate N ranks in one
    process."""

    def __init__(self, rank: int, world: int, service: PSService,
                 device=None):
        self.rank, self.world, self.service = rank, world, service
        self.device = default_device(device)

    def quiesce(self) -> None:
        """Shutdown handshake (the reference's MV_ShutDown barrier): mark
        this rank done through the rendezvous and keep serving until every
        live peer is done too. Observed-dead ranks are skipped; timing out
        proceeds with an error log."""
        rdv = self.service._rendezvous
        if self.world <= 1 or rdv is None or not hasattr(rdv, "mark"):
            return
        # the marker VALUE is this incarnation's published address, so a
        # reused rendezvous directory's stale markers never satisfy it
        rdv.mark(self.rank, "ps_quiesce", self.service.addr)
        deadline = time.monotonic() + config.get_flag("ps_shutdown_grace")
        for r in range(self.world):
            if r == self.rank or r in self.service.dead_ranks():
                continue
            remaining = deadline - time.monotonic()
            try:
                expect = rdv.lookup(r, min(max(remaining, 0.001), 5.0))
            except PSError:
                continue   # never published: the rank never came up
            if remaining <= 0 or not rdv.wait_mark(
                    r, "ps_quiesce", remaining, expect=expect):
                log.error("ps shutdown: rank %d did not reach shutdown "
                          "within ps_shutdown_grace; not waiting for it", r)

    def close(self, quiesce: bool = False) -> None:
        if quiesce:
            try:
                self.quiesce()
            except Exception as e:
                # best-effort: a vanished rendezvous dir must not abort
                # shutdown and leak the service's sockets/threads
                log.error("ps shutdown quiesce failed (%s: %s); closing "
                          "anyway", type(e).__name__, e)
        # final telemetry flush before the service dies: the last metrics
        # record and any buffered spans and step records must survive a
        # short run. export_global, not stop_global: a process may hold
        # several contexts, and one closing must not stop the exporter for
        # the rest (it stops at Zoo.stop or with the process)
        try:
            _exporter.export_global()
            d = config.get_flag("metrics_dir")
            if d:
                _trace.dump_to(d)
                _profiler.dump_to(d)
        except Exception as e:  # noqa: BLE001 — telemetry never blocks
            log.error("telemetry flush at close failed: %s", e)  # shutdown
        self.service.close()


_default_ctx: Optional[PSContext] = None
_default_lock = threading.Lock()


def default_context() -> PSContext:
    """The process's context, from the flags: ``ps_world <= 0`` takes the
    rank and world of the ``torch.distributed`` world (``net_init`` or a
    launcher), else rank 0 of 1; a larger ``ps_world`` needs ``ps_rank``.
    A world larger than 1 meets in the ``ps_rendezvous`` directory when
    that flag is set, else in the world's key-value store
    (:class:`StoreRendezvous`)."""
    global _default_ctx
    with _default_lock:
        if _default_ctx is None:
            world = config.get_flag("ps_world")
            rank = config.get_flag("ps_rank")
            if world <= 0:
                import torch.distributed as dist
                if dist.is_available() and dist.is_initialized():
                    rank, world = dist.get_rank(), dist.get_world_size()
                else:
                    rank, world = 0, 1
            elif rank < 0:
                raise PSError("ps_world set but ps_rank is not")
            rdv = None
            if world > 1:
                rdv_dir = config.get_flag("ps_rendezvous")
                if rdv_dir:
                    rdv = FileRendezvous(rdv_dir)
                else:
                    from multiverso_tpu_torch.parallel.mesh import \
                        world_store
                    if world_store() is None:
                        raise PSError(
                            f"a PS world of {world} ranks needs a "
                            "rendezvous: set ps_rendezvous=<dir> (a shared "
                            "directory), or join a torch.distributed world "
                            "first (net_init() or a launcher's "
                            "environment) for its key-value store")
                    rdv = StoreRendezvous()
            service = PSService(rank, world, rdv)
            try:
                _default_ctx = PSContext(rank, world, service)
            except BaseException:
                service.close()   # no device: release the listener
                raise
        return _default_ctx


def reset_default_context() -> None:
    """Close the default context; the app flow quiesces first (every rank
    got here through ``mv.shutdown``)."""
    global _default_ctx
    with _default_lock:
        if _default_ctx is not None:
            _default_ctx.close(quiesce=True)
            _default_ctx = None
