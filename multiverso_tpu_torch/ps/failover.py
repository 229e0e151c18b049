"""Elastic shard failover: checkpointed handoff and supervised recovery
(port of ``multiverso_tpu/ps/failover.py``).

* :class:`ShardCheckpointer` — a per-rank background thread writing
  per-shard incremental checkpoints (``checkpoint.save_shard_state``:
  data rows, updater state, replay sequence channels and apply version,
  copied from the card; commit marker last, so a torn save is invisible)
  every ``failover_ckpt_interval_s``. After each COMMITTED save it
  advances the shards' durable replay floors, which lets clients prune
  their retained send-window frames (``ps/tables._ReplayBuffer``).
* :class:`FailoverSupervisor` — polls ``elastic.health()`` (beacon
  staleness and tombstones), confirms each ``dead|stuck`` suspect with a
  MSG_HEALTH one-shot probe at its published address (a half-written
  beacon must not kill a healthy rank), then recovers: kill the old
  incarnation (``kill``), tombstone it, respawn the rank (``spawn``: an
  OS process in a deployment, an in-process service in tests) at the
  next generation, and watch for the rejoin (a fresh beacon from the new
  incarnation clearing the tombstone).
* :func:`rejoin` — the restarted incarnation's first act: restore its own
  shards onto its device from the newest committed per-shard checkpoint,
  then publish its address. Clients re-route through the per-rank
  reconnect path and their send windows re-flush the retained tail; the
  restored shard's sequence channels dedupe the prefix the checkpoint
  already holds — no acked op lost, no frame applied twice.

The supervisor is transport-free: it reads beacons and ``<rank>.addr``
files from shared directories and probes over one-shot sockets, so it can
run in a worker, a sidecar, or a parent process that serves nothing.

Telemetry: the flight recorder marks each recovery's detect, respawn and
rejoin (``EV_FAILOVER_*``, which the postmortem tool renders as the
recovery timeline), and each checkpointer registers its on-disk footprint
with the memory ledger.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from multiverso_tpu_torch import checkpoint, elastic
from multiverso_tpu_torch.telemetry import flightrec as _flight
from multiverso_tpu_torch.telemetry import memstats as _memstats
from multiverso_tpu_torch.utils import config, log


def read_addr(rendezvous_dir: str, rank: int) -> Optional[str]:
    """``rank``'s published address straight off a file-rendezvous
    directory (no PSService needed — the supervisor may live in a
    process that serves nothing)."""
    try:
        with open(os.path.join(rendezvous_dir, f"{rank}.addr")) as f:
            addr = f.read().strip()
        return addr or None
    except OSError:
        return None


def rejoin(directory: str, rank: int, tables,
           heartbeat: Optional["elastic.Heartbeat"] = None,
           service=None) -> int:
    """Restarted-incarnation boot: restore this rank's shards from its
    newest committed per-shard checkpoint (0 restored = cold start —
    a rank that died before its first save simply rejoins empty), THEN
    announce the new incarnation: publish the deferred rendezvous
    address (``service`` built with ``defer_publish=True`` — a
    survivor must not discover the address while the shard is still
    empty, or a replayed frame could apply, ack, and be wiped by this
    very restore) and beat the heartbeat so the supervisor and the
    tombstone plane see the fresh incarnation immediately. Returns
    shards restored."""
    n = checkpoint.restore_shard_state(directory, rank, tables)
    _flight.record(_flight.EV_FAILOVER_REJOIN,
                   note=f"rank {rank}: {n} shards restored")
    if service is not None:
        service.publish_addr()
    if heartbeat is not None:
        heartbeat.beat()
    return n


class ShardCheckpointer:
    """Periodic per-shard checkpointer for one rank (the durable half
    of failover). ``tables`` may be a list of async tables, a
    ``{name: shard}`` dict, or a zero-arg callable returning either —
    the service wiring passes a callable so shards registered after
    start are picked up."""

    def __init__(self, directory: str, rank: int, tables,
                 interval_s: float = 1.0, keep: int = 2):
        self.directory = directory
        self.rank = int(rank)
        self._tables = tables if callable(tables) else (lambda: tables)
        self.interval_s = float(interval_s)
        self.keep = int(keep)
        self.saves = 0
        self.errors = 0
        self.last_path: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # memory ledger: on-disk footprint of this rank's kept tags. The
        # walk runs here and after each committed save/prune (the only
        # moments the size changes), never on a ledger pull: pulls ride
        # the watchdog's sweep, which a slow directory walk would stall
        self._disk_bytes = checkpoint._dir_bytes(
            checkpoint._shard_base(directory, self.rank))
        _memstats.register(f"failover_ckpt[r{self.rank}]", self)

    def memory_stats(self) -> Dict[str, int]:
        return {"disk_bytes": int(self._disk_bytes),
                "saves": self.saves}

    def checkpoint_now(self) -> Optional[str]:
        """One committed save + prune; returns the tag path (None when
        the rank currently owns nothing checkpointable)."""
        tables = self._tables()
        if not tables:
            return None
        path = checkpoint.save_shard_state(self.directory, self.rank,
                                           tables)
        checkpoint.prune_shard_tags(self.directory, self.rank, self.keep)
        self.saves += 1
        self.last_path = path
        self._disk_bytes = checkpoint._dir_bytes(
            checkpoint._shard_base(self.directory, self.rank))
        return path

    def start(self) -> "ShardCheckpointer":
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mv-shardckpt-{self.rank}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.checkpoint_now()
            except Exception as e:   # noqa: BLE001 — one failed save
                self.errors += 1     # must not kill the cadence
                log.error("shard checkpoint failed (rank %d): %s: %s",
                          self.rank, type(e).__name__, e)

    def stop(self, final: bool = True) -> None:
        """Stop the cadence; ``final=True`` writes one last committed
        save so a clean shutdown's tail of applies is never lost."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 10)
            self._thread = None
        if final:
            try:
                self.checkpoint_now()
            except Exception as e:   # noqa: BLE001
                log.error("final shard checkpoint failed (rank %d): %s",
                          self.rank, e)


class FailoverSupervisor:
    """Detect → confirm → kill → respawn → watch-rejoin, per rank.

    ``spawn(rank, generation)`` relaunches the rank (REQUIRED for
    recovery; without it the supervisor only detects and tombstones).
    ``kill(rank)`` terminates the old incarnation first — a SIGSTOPPED
    process still holds its listen socket and would fight its
    replacement for the published address. Both callbacks run on the
    supervisor thread; exceptions are logged, never raised into the
    loop. ``events`` is the recovery log the chaos bench and tests
    read: ``(wall_ts, phase, rank)`` with phase in
    detect|respawn|rejoin."""

    def __init__(self, heartbeat_dir: str, world: int,
                 rendezvous_dir: Optional[str] = None,
                 spawn: Optional[Callable[[int, int], None]] = None,
                 kill: Optional[Callable[[int], None]] = None,
                 timeout: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 confirm: bool = True,
                 respawn_grace: Optional[float] = None,
                 ranks: Optional[List[int]] = None):
        self.heartbeat_dir = heartbeat_dir
        self.rendezvous_dir = rendezvous_dir
        self.world = int(world)
        self.ranks = list(ranks) if ranks is not None \
            else list(range(self.world))
        self.spawn = spawn
        self.kill = kill
        self.timeout = (config.get_flag("failover_timeout")
                        if timeout is None else float(timeout))
        self.poll_s = (config.get_flag("failover_poll_s")
                       if poll_s is None else float(poll_s))
        self.confirm = confirm
        # a replacement needs real time to boot (a worker imports torch
        # and reaches the card for seconds before its first beacon):
        # re-declaring it dead on the detection timeout would kill our
        # own respawn in a storm
        self.respawn_grace = (max(3.0 * self.timeout, 15.0)
                              if respawn_grace is None
                              else float(respawn_grace))
        self.events: List[Tuple[float, str, int]] = []
        self._gen: Dict[int, int] = {}
        self._recovering: Dict[int, float] = {}   # rank -> respawn t0
        self._seen: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    def start(self) -> "FailoverSupervisor":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mv-failover")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 10)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception as e:   # noqa: BLE001 — the loop survives
                log.error("failover supervisor poll failed: %s: %s",
                          type(e).__name__, e)

    # ------------------------------------------------------------------ #
    def check_once(self) -> Dict[int, str]:
        """One poll: health verdicts in, recovery actions out. Returns
        the verdict map (tests assert on it)."""
        verdicts = elastic.health(self.heartbeat_dir,
                                  timeout=self.timeout)
        for r, v in verdicts.items():
            if v == "ok":
                self._seen.add(r)
        for r in self.ranks:
            v = verdicts.get(r)
            if v == "ok":
                self._note_rejoin(r)
                continue
            if v is None and r not in self._seen:
                continue   # never came up: not this supervisor's call
            with self._lock:
                if r in self._recovering:
                    # respawn in flight: give it the full grace to boot
                    # and publish a fresh beacon before declaring it
                    # dead AGAIN (a respawn storm would thrash
                    # checkpoints and kill its own replacements)
                    if (time.monotonic() - self._recovering[r]
                            < self.respawn_grace):
                        continue
                    del self._recovering[r]
            if self.confirm and not self._confirm_down(r):
                continue
            self._recover(r, v or "dead")
        return verdicts

    def _confirm_down(self, rank: int) -> bool:
        """MSG_HEALTH one-shot probe at the published address: only a
        probe that fails (or answers ``stuck``) confirms the verdict —
        heartbeat staleness alone can be a wedged NFS client, and a
        healthy rank must never be killed over it. No address on file
        counts as confirmation (nothing to probe)."""
        if self.rendezvous_dir is None:
            return True
        addr = read_addr(self.rendezvous_dir, rank)
        if addr is None:
            return True
        from multiverso_tpu_torch.ps import service as svc
        try:
            # triage-scale budget, floored: a tiny/zero detection
            # timeout must not starve the probe into a false "down"
            h = svc.oneshot_probe(
                addr, svc.MSG_HEALTH,
                max(min(config.get_flag("ps_health_timeout"),
                        self.timeout), 0.5))
            return h.get("status") == "stuck"
        except Exception:   # noqa: BLE001 — unreachable IS the answer
            return True

    def _recover(self, rank: int, verdict: str) -> None:
        now = time.time()
        self.events.append((now, "detect", rank))
        _flight.record(_flight.EV_FAILOVER_DETECT, peer=rank,
                       note=f"verdict={verdict}")
        log.error("failover: rank %d is %s — recovering", rank, verdict)
        addr = (read_addr(self.rendezvous_dir, rank)
                if self.rendezvous_dir else None)
        try:
            elastic.mark_failed(self.heartbeat_dir, rank, addr=addr)
        except OSError as e:
            log.error("failover: tombstone for rank %d failed: %s",
                      rank, e)
        if self.kill is not None:
            try:
                self.kill(rank)
            except Exception as e:   # noqa: BLE001
                log.error("failover: kill(%d) failed: %s", rank, e)
        if self.spawn is None:
            return   # detection-only mode: operator drives the respawn
        gen = self._gen.get(rank, 0) + 1
        self._gen[rank] = gen
        self.events.append((time.time(), "respawn", rank))
        _flight.record(_flight.EV_FAILOVER_RESPAWN, peer=rank,
                       note=f"gen={gen}")
        with self._lock:
            self._recovering[rank] = time.monotonic()
        try:
            self.spawn(rank, gen)
        except Exception as e:   # noqa: BLE001
            log.error("failover: spawn(%d, gen %d) failed: %s",
                      rank, gen, e)

    def _note_rejoin(self, rank: int) -> None:
        with self._lock:
            if rank not in self._recovering:
                return
            del self._recovering[rank]
        self.events.append((time.time(), "rejoin", rank))
        _flight.record(_flight.EV_FAILOVER_REJOIN, peer=rank)
        log.info("failover: rank %d rejoined", rank)

    def recovery_spans(self) -> List[Dict]:
        """detect→rejoin durations per recovery episode (bench extra)."""
        out: List[Dict] = []
        open_at: Dict[int, float] = {}
        for ts, phase, rank in self.events:
            if phase == "detect":
                open_at[rank] = ts
            elif phase == "rejoin" and rank in open_at:
                out.append({"rank": rank, "detect_ts": open_at[rank],
                            "rejoin_ts": ts,
                            "detect_to_rejoin_s": round(
                                ts - open_at.pop(rank), 3)})
        return out


# ---------------------------------------------------------------------- #
# flag-gated per-service checkpointer: PSService starts one when failover_ckpt_interval_s > 0 and
# failover_dir is set; service.close / Zoo.stop stop it (final save
# included — a clean shutdown's tail of applies stays durable)
# ---------------------------------------------------------------------- #
_ckptrs: Dict[int, ShardCheckpointer] = {}
_ckptrs_lock = threading.Lock()


def ensure_checkpointer(service) -> Optional[ShardCheckpointer]:
    interval = config.get_flag("failover_ckpt_interval_s")
    directory = config.get_flag("failover_dir")
    if interval <= 0 or not directory:
        return None
    with _ckptrs_lock:
        cur = _ckptrs.get(id(service))
        if cur is not None:
            return cur

        def shards(_svc=service):
            with _svc._handlers_cv:
                return dict(_svc._shards)

        ck = ShardCheckpointer(
            directory, service.rank, shards, interval_s=interval,
            keep=config.get_flag("failover_ckpt_keep")).start()
        _ckptrs[id(service)] = ck
        return ck


def stop_if_bound(service, final: bool = True) -> None:
    with _ckptrs_lock:
        ck = _ckptrs.pop(id(service), None)
    if ck is not None:
        ck.stop(final=final)


def stop_global(final: bool = False) -> None:
    """Stop every registered checkpointer (test teardown / Zoo.stop).
    ``final=False`` by default: a leaked checkpointer's service may
    already be gone, and teardown must not fail on a last save."""
    with _ckptrs_lock:
        cks = list(_ckptrs.values())
        _ckptrs.clear()
    for ck in cks:
        try:
            ck.stop(final=final)
        except Exception as e:   # noqa: BLE001
            log.error("shard checkpointer stop failed: %s", e)
