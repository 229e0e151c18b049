"""PSService: the per-process async parameter-server runtime (port of
``multiverso_tpu/ps/service.py``, the pure-Python wire plane).

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
  directory).

Local shards short-circuit the socket but still run on the service's
one-thread executor, so ``add_async`` keeps fire-and-forget semantics and
per-owner FIFO order.

Failure semantics: requests to a dead/unreachable rank raise
:class:`PSPeerError` (after ``ps_connect_timeout``/``ps_timeout``); the
service keeps serving live peers — no collective, so nobody hangs.

The stats payload (MSG_STATS) carries the Dashboard monitors, every
shard's stats and, when this process serves read replicas, their
``serving`` block (``serving/replica.stats_snapshot``).

Not ported (ROADMAP.md §A, each under its title): the native C++ plane
(``ps_native``, which raises here), failover and fault injection, the
spmd stack, and the telemetry planes (flight recorder, trace, exporter,
aggregator, watchdog). The Dashboard monitors stay.
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

from multiverso_tpu_torch.ps import wire
from multiverso_tpu_torch.serving import replica as _serving_replica
from multiverso_tpu_torch.utils import config, log, retry as _retry
from multiverso_tpu_torch.utils.dashboard import Dashboard, monitor
from multiverso_tpu_torch.zoo import default_device

# ROADMAP.md §A titles of the parts of ps/ this plane refuses
NATIVE_ITEM = "the native plane (ps/native.py, native/mv_ps.cpp)"
TELEMETRY_ITEM = "Telemetry and tools"
REPLAY_ITEM = "failover, faults and replay"
NO_FILE_RDV_ITEM = "a rendezvous without a file"

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
                     "directory for async-PS rank rendezvous (required "
                     "when ps_world > 1)")
config.define_int("ps_rank", -1, "async-PS rank (-1 = rank 0 of a world "
                  "of 1 when ps_world <= 0)")
config.define_int("ps_world", 0,
                  "async-PS world size (<= 0 = one process, world 1)")
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
config.define_bool("ps_native", False,
                   "serve and speak the async-PS wire through the native "
                   "C++ transport. Not ported: True raises "
                   f"NotImplementedError (ROADMAP.md §A {NATIVE_ITEM})")
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


def check_native() -> None:
    """Refuse ``ps_native=True``: the native plane is not ported, and this
    plane never quietly stands in for it."""
    if config.get_flag("ps_native"):
        raise NotImplementedError(
            "ps_native=True: the native C++ wire plane is not ported to "
            f"multiverso_tpu_torch yet (ROADMAP.md §A {NATIVE_ITEM}); "
            "set ps_native=False for the pure-Python plane")


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


# ---------------------------------------------------------------------- #
# process-colocation registry: services sharing a process AND a
# rendezvous may serve each other's super-frame sub-ops in-process
# ---------------------------------------------------------------------- #
_colocated: Dict[Any, Dict[int, "PSService"]] = {}
_colocated_lock = threading.Lock()


def colocated_service(key, rank: int) -> Optional["PSService"]:
    if key is None:
        return None
    with _colocated_lock:
        return _colocated.get(key, {}).get(rank)


# ---------------------------------------------------------------------- #
# client side: one persistent connection per remote rank
# ---------------------------------------------------------------------- #
_peer_gen = itertools.count()   # per-incarnation msg-id bases (below)


class _Peer:
    def __init__(self, rank: int, addr: str, connect_timeout: float,
                 io_timeout: float,
                 on_death: Optional[Callable[["_Peer", Exception],
                                             None]] = None):
        self.rank = rank
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
            try:
                wire.send(self._sock, msg_type, msg_id, meta, arrays)
            except OSError as e:
                err = PSPeerError(f"rank {self.rank} send failed: {e}")
                self._dead = err
                with self._pending_lock:
                    self._pending.pop(msg_id, None)
                fut.set_exception(err)
                if self._on_death is not None:
                    self._on_death(self, err)
                return fut
            except BaseException:
                # encode failure (bad meta, exotic array): not a peer
                # death — unwind this op and re-raise
                with self._pending_lock:
                    self._pending.pop(msg_id, None)
                raise
        # the recv loop may have died BETWEEN the entry _dead check and the
        # _pending insert — re-check so this future fails fast
        if self._dead is not None:
            with self._pending_lock:
                still = self._pending.pop(msg_id, None)
            if still is not None and not fut.done():
                fut.set_exception(self._dead)
        return fut

    def inflight(self) -> int:
        with self._pending_lock:
            return len(self._pending)

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
                 host: Optional[str] = None, port: Optional[int] = None):
        check_native()
        self.rank, self.world = rank, world
        if host is None:
            host = config.get_flag("ps_host") or "127.0.0.1"
        self._rendezvous = rendezvous
        self._proc_key = getattr(rendezvous, "identity", None)
        self._handlers: Dict[str, Callable] = {}
        # table -> shard object for MSG_STATS / MSG_HEALTH
        self._shards: Dict[str, Any] = {}
        self._handlers_cv = threading.Condition()
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
        self.generation = 0
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
        if rendezvous is not None:
            self.publish_addr()
        log.debug("PSService rank %d/%d listening on %s", rank, world,
                  self.addr)

    # ----------------------------- server side ----------------------- #
    def publish_addr(self) -> None:
        """Publish this incarnation's address through the rendezvous (and
        join the in-process colocation registry); idempotent."""
        if self._rendezvous is not None:
            self._rendezvous.publish(self.rank, self.addr)
            self._published = True
        if self._proc_key is not None:
            with _colocated_lock:
                _colocated.setdefault(self._proc_key, {})[self.rank] = self

    def _release_colocated(self) -> None:
        if self._proc_key is None:
            return
        with _colocated_lock:
            ranks = _colocated.get(self._proc_key, {})
            if ranks.get(self.rank) is self:
                del ranks[self.rank]
            if not ranks:
                _colocated.pop(self._proc_key, None)

    def beat(self, name: str) -> None:
        self._beats[name] = time.monotonic()

    def register_handler(self, table: str, handler: Callable,
                         shard=None) -> None:
        """``handler(msg_type, meta, arrays) -> (meta, arrays)``, called on
        a connection thread; the shard serializes internally."""
        with self._handlers_cv:
            self._handlers[table] = handler
            if shard is not None:
                self._shards[table] = shard
                if hasattr(shard, "service"):
                    shard.service = self
            self._handlers_cv.notify_all()

    # ----------------------------- telemetry -------------------------- #
    def stats_payload(self) -> Dict:
        """This rank's telemetry snapshot (the MSG_STATS reply meta):
        Dashboard monitors and per-shard server stats, JSON-safe."""
        shards = {}
        with self._handlers_cv:
            items = list(self._shards.items())
        for table, shard in items:
            try:
                stats = shard.stats()
            except Exception as e:  # noqa: BLE001 — one bad shard must
                stats = {"error": f"{type(e).__name__}: {e}"}  # not hide
            shards[table] = stats                              # the rest
        monitors = {}
        for name, snap in Dashboard.snapshot().items():
            monitors[name] = {"count": snap.count,
                              "total_ms": snap.total_ms,
                              "p50_ms": snap.p50_ms, "p90_ms": snap.p90_ms,
                              "p99_ms": snap.p99_ms, "max_ms": snap.max_ms}
        payload = {"monitors": monitors, "shards": shards,
                   "pid": os.getpid(), "rank": self.rank,
                   "world": self.world, "addr": self.addr}
        # the serving plane: this process's read replicas and pools (lag,
        # versions, cache hit rate, shed counters)
        try:
            serving = _serving_replica.stats_snapshot()
            if serving:
                payload["serving"] = serving
        except Exception:   # noqa: BLE001 — telemetry never raises
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
        with self._peers_lock:
            peers = list(self._peers.values())
        now = time.monotonic()

        def age(name):
            t = self._beats.get(name)
            return None if t is None else round(now - t, 3)

        return {
            "rank": self.rank, "addr": self.addr, "gen": self.generation,
            "ts": round(time.time(), 3), "native": False,
            "serve_age_s": age("serve"), "apply_age_s": age("apply"),
            "queue_depth": queue_depth,
            "inflight": sum(p.inflight() for p in peers),
            "status": "ok",
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
        colocated one (same process, same rendezvous)."""
        if owner == self.rank:
            return self
        svc = colocated_service(self._proc_key, owner)
        if svc is not None and not svc._closed:
            return svc
        raise PSError(
            f"super-frame sub-op for rank {owner}, which is not "
            f"colocated with rank {self.rank}")

    def multi_local(self, subs: Sequence[Tuple[int, Dict, Sequence]]
                    ) -> List[cf.Future]:
        """In-process super-frame dispatch from Python objects (no wire
        encode on either side): every sub-op runs on the caller's thread
        against its colocated owner, and one future per sub resolves."""
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
        arrays)`` sub-op goes, in frame order, to its owning shard's
        ordinary handler, and comes back as ``(ok, reply_meta,
        reply_arrays)``. A failing sub-op fails alone (sub K failing does
        not fail sub K+1). The JAX package also groups row adds and gets
        of mesh-stacked shards into one SPMD dispatch; a card has no
        stack, so every sub-op takes the per-sub path, with the same
        results."""
        results: List[Tuple[bool, Dict, Any]] = []
        for mt, m, arrs in subs:
            try:
                owner = int(m.get(wire.OWNER_META_KEY, self.rank))
                svc2 = self._owner_service(owner)
                handler = svc2._wait_handler(m["table"])
                with monitor(f"ps[{m['table']}].serve"):
                    rmeta, rarrays = handler(mt, m, arrs)
                if isinstance(rarrays, wire.ChunkedReply):
                    raise PSError("chunk-streamed replies cannot ride a "
                                  "super-frame")
                results.append((True, rmeta, rarrays))
            except Exception as e:  # noqa: BLE001 — per sub
                results.append((False, _sub_err(e), []))
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
            with self._conns_lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="ps-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        try:
            while not self._closed:
                msg_type, msg_id, meta, arrays = wire.recv(conn)
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
                # probes leave the beat alone: it marks data-plane liveness
                self.beat("serve")
                try:
                    if msg_type == MSG_MULTI:
                        with monitor("ps[multi].serve"):
                            rmeta, rarrays = self._handle_multi(meta,
                                                                arrays)
                    else:
                        handler = self._wait_handler(meta["table"])
                        with monitor(f"ps[{meta['table']}].serve"):
                            rmeta, rarrays = handler(msg_type, meta,
                                                     arrays)
                    if isinstance(rarrays, wire.ChunkedReply):
                        # streamed get reply: one MSG_REPLY_CHUNK per
                        # sub-frame as the generator yields, closed by
                        # the ordinary OK
                        for cmeta, carrays in rarrays.chunks:
                            with send_lock:
                                wire.send(conn, MSG_REPLY_CHUNK, msg_id,
                                          cmeta, carrays)
                        rmeta, rarrays = rarrays.meta, ()
                    with send_lock:
                        wire.send(conn, MSG_REPLY_OK, msg_id, rmeta,
                                  rarrays)
                except Exception as e:  # reply errors, don't kill the conn
                    log.debug("ps handler error: %s", e)
                    with send_lock:
                        wire.send(conn, MSG_REPLY_ERR, msg_id,
                                  {"error": f"{type(e).__name__}: {e}"})
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
                                 self._note_death(r, peer=p))
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
        try:
            return self._peer(rank).request(
                msg_type, meta if meta_b is None else meta_b, arrays,
                chunk_sink=chunk_sink)
        except PSError as e:
            fut: cf.Future = cf.Future()
            fut.set_exception(e if isinstance(e, PSPeerError)
                              else PSPeerError(str(e)))
            return fut

    def _dispatch_inproc(self, svc: "PSService", msg_type: int,
                         meta: Dict, arrays,
                         chunk_sink: Optional[Callable]) -> cf.Future:
        """The local short-circuit: the handler runs on this service's
        serial executor (fire-and-forget timing, per-owner FIFO)."""
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
        self._closed = True
        # colocated clients observe this rank's death like a dead socket
        self._release_colocated()
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
        if self._accept_thread.is_alive():
            self._accept_thread.join(timeout=10.0)
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
        with self._peers_lock:
            for peer in self._peers.values():
                peer.close()
            self._peers.clear()
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
        self.service.close()


_default_ctx: Optional[PSContext] = None
_default_lock = threading.Lock()


def default_context() -> PSContext:
    """The process's context, from the flags: ``ps_world <= 0`` means a
    world of 1 (rank 0); a larger world needs ``ps_rank`` and a
    ``ps_rendezvous`` directory."""
    global _default_ctx
    with _default_lock:
        if _default_ctx is None:
            world = config.get_flag("ps_world")
            rank = config.get_flag("ps_rank")
            if world <= 0:
                rank, world = 0, 1
            elif rank < 0:
                raise PSError("ps_world set but ps_rank is not")
            rdv = None
            if world > 1:
                rdv_dir = config.get_flag("ps_rendezvous")
                if not rdv_dir:
                    raise NotImplementedError(
                        f"ps_world={world} needs ps_rendezvous=<dir>: a "
                        "rendezvous without a shared directory (the JAX "
                        "package's coordinator key-value store) is not "
                        "ported to multiverso_tpu_torch yet (ROADMAP.md "
                        f"§A {NO_FILE_RDV_ITEM})")
                rdv = FileRendezvous(rdv_dir)
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
