"""Failure detection and elastic resume (port of
``multiverso_tpu/elastic.py``).

* **Heartbeat** — each process writes a small JSON beacon
  (``heartbeat.<rank>.json``: rank, step, timestamp, and the
  incarnation's address) to shared storage on a background thread; any
  process can list ``peers()``, detect ``failed()`` ranks by staleness,
  read ``health()`` and find ``stragglers()`` by step lag.
* A PS plane that sees a peer's socket die writes a tombstone
  (``failed.<rank>.json``, :func:`mark_failed`; ``bind_ps`` wires it), so
  a death is visible at once instead of after a heartbeat timeout.
* **ElasticLoop** — periodic full-state checkpoints (``checkpoint.py``
  walks every registered table, data and updater state) and
  resume-from-latest on restart.

The files are the JAX package's, so a beacon or tombstone written by
either package is read alike by the other.

Not ported (ROADMAP.md §A "Telemetry and tools"): the beacon's
``last_health`` block, which comes from the watchdog. This package's
beacons leave it out; :func:`health` still reads ``stuck`` from a beacon
that has one (a JAX rank's).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from multiverso_tpu_torch import checkpoint
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.zoo import Zoo


class Heartbeat:
    """Periodic liveness beacon on shared storage (one file per rank)."""

    def __init__(self, directory: str, interval: float = 5.0,
                 rank: Optional[int] = None, addr: Optional[str] = None):
        """``addr`` stamps every beacon with this incarnation's identity
        (the rank's published PS address): a respawned rank's fresh
        beacon then clears its predecessor's tombstone by identity, not
        just by timestamp — see :func:`failed`."""
        self.directory = directory
        self.interval = interval
        self.rank = Zoo.get().rank() if rank is None else rank
        self.addr = addr
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def set_addr(self, addr: Optional[str]) -> None:
        """Late-bind the incarnation address (a service constructed after
        the heartbeat started)."""
        self.addr = addr

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"heartbeat.{self.rank}.json")

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def beat(self) -> None:
        """Write one beacon now (atomic rename, so readers never see a
        torn write)."""
        entry = {"rank": self.rank, "step": self._step, "ts": time.time()}
        if self.addr:
            entry["addr"] = self.addr
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, self.path)

    def start(self) -> "Heartbeat":
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"mv-heartbeat-{self.rank}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
            self._thread = None


def peers(directory: str) -> Dict[int, Dict]:
    """All beacons currently present: {rank: {rank, step, ts}}."""
    out: Dict[int, Dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not (name.startswith("heartbeat.") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                raw = json.load(f)
            entry = {"rank": int(raw["rank"]), "step": int(raw["step"]),
                     "ts": float(raw["ts"])}
            if isinstance(raw.get("last_health"), dict):
                entry["last_health"] = raw["last_health"]
            if isinstance(raw.get("addr"), str):
                entry["addr"] = raw["addr"]
            out[entry["rank"]] = entry
        except (ValueError, KeyError, TypeError, json.JSONDecodeError,
                OSError):
            continue  # torn/foreign/old-schema file: not a liveness verdict
    return out


def _tombstones(directory: str) -> Dict[int, Dict]:
    """rank -> {"ts": last-seen beacon ts (subject clock), "addr":
    tombstoned incarnation address or None} at tombstone time."""
    out: Dict[int, Dict] = {}
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not (name.startswith("failed.") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                entry = json.load(f)
            out[int(entry["rank"])] = {
                "ts": float(entry.get("beacon_ts", entry["ts"])),
                "addr": entry.get("addr")}
        except (ValueError, KeyError, TypeError, json.JSONDecodeError,
                OSError):
            continue
    return out


def failed(directory: str, timeout: float = 30.0,
           beacons: Optional[Dict[int, Dict]] = None) -> List[int]:
    """Ranks considered dead: beacon older than ``timeout`` seconds, OR
    tombstoned with no exonerating beacon. A beacon exonerates its rank
    when it is newer than the one the tombstone recorded (both timestamps
    the subject's own clock, so cross-host skew cannot pin a rejoined
    rank) or when it carries a DIFFERENT incarnation address than the
    tombstone: a respawned rank's fresh identity clears its predecessor's
    tombstone even if the predecessor's last beacons out-stamp it.
    ``beacons`` lets a caller that already listed the directory skip a
    second scan of shared storage."""
    now = time.time()
    if beacons is None:
        beacons = peers(directory)
    out = {r for r, e in beacons.items() if now - float(e["ts"]) > timeout}
    for rank, tomb in _tombstones(directory).items():
        beacon = beacons.get(rank)
        if beacon is None:
            out.add(rank)
            continue
        fresh_incarnation = (tomb.get("addr") is not None
                             and beacon.get("addr") is not None
                             and beacon["addr"] != tomb["addr"])
        if not fresh_incarnation and float(beacon["ts"]) <= tomb["ts"]:
            out.add(rank)
    return sorted(out)


def health(directory: str, timeout: float = 30.0) -> Dict[int, str]:
    """Per-rank liveness verdict: ``"dead"`` (stale beacon or PS-death
    tombstone — exactly :func:`failed`'s set), ``"stuck"`` (beacon still
    fresh but its ``last_health`` block says the PS plane is wedged),
    else ``"ok"``."""
    beacons = peers(directory)
    dead = set(failed(directory, timeout, beacons=beacons))
    out: Dict[int, str] = {r: "dead" for r in dead}
    for r, e in beacons.items():
        if r in dead:
            continue
        lh = e.get("last_health") or {}
        out[r] = "stuck" if lh.get("status") == "stuck" else "ok"
    return out


def mark_failed(directory: str, rank: int,
                addr: Optional[str] = None) -> None:
    """Tombstone ``rank`` as failed NOW — the PS plane's socket-death
    signal feeding the heartbeat view (see :func:`bind_ps`). The tombstone
    records the rank's last-seen beacon timestamp (the subject's own
    clock) and the dead incarnation's address (``addr``, defaulting to
    the last beacon's); a newer beacon, or one with another address,
    clears it (:func:`failed`)."""
    os.makedirs(directory, exist_ok=True)
    beacon = peers(directory).get(int(rank))
    seen_ts = float(beacon["ts"]) if beacon else float("-inf")
    if addr is None and beacon is not None:
        addr = beacon.get("addr")
    path = os.path.join(directory, f"failed.{int(rank)}.json")
    tmp = path + ".tmp"
    entry: Dict = {"rank": int(rank), "ts": time.time(),
                   "beacon_ts": seen_ts}
    if addr:
        entry["addr"] = addr
    with open(tmp, "w") as f:
        json.dump(entry, f)
    os.replace(tmp, path)


def bind_ps(directory: str, ctx=None) -> None:
    """Feed PS-plane peer deaths into this heartbeat directory: every
    socket death the service observes writes a tombstone that
    :func:`failed` reports immediately."""
    if ctx is None:
        from multiverso_tpu_torch.ps.service import default_context
        ctx = default_context()
    ctx.service.add_death_hook(lambda rank: mark_failed(directory, rank))


def stragglers(directory: str, lag: int = 10) -> List[int]:
    """Ranks more than ``lag`` steps behind the front-runner (the working
    version of the reference's dead backup_worker_ratio knob)."""
    entries = peers(directory)
    if not entries:
        return []
    front = max(int(e["step"]) for e in entries.values())
    return sorted(r for r, e in entries.items()
                  if front - int(e["step"]) > lag)


class ElasticLoop:
    """Checkpoint-every-N + resume-from-latest around any training loop.

    ::

        loop = ElasticLoop("/ckpt/run7", every=100)
        start = loop.resume()            # 0 on a fresh run
        for step in range(start, total):
            ...train...
            loop.completed(step)         # checkpoints at step % every == 0
        loop.stop()
    """

    TAG = "step_{step:09d}"

    def __init__(self, directory: str, every: int = 100,
                 keep: int = 2, heartbeat_interval: float = 5.0,
                 backend: str = "stream", block: bool = True):
        checkpoint._check_backend(backend, block)
        self.directory = directory
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        self.backend = backend
        self.block = block
        self.heartbeat = Heartbeat(
            os.path.join(directory, "heartbeats"),
            interval=heartbeat_interval).start()

    def resume(self) -> int:
        """Restore the newest committed checkpoint; return the step to
        resume FROM (one past the checkpointed step; 0 if none)."""
        tag = checkpoint.latest(self.directory)
        if tag is None or not tag.startswith("step_"):
            return 0
        checkpoint.restore(self.directory, tag)
        step = int(tag.split("_", 1)[1])
        self.heartbeat.set_step(step)
        log.info("elastic resume from %s (next step %d)", tag, step + 1)
        return step + 1

    def completed(self, step: int) -> bool:
        """Record progress; checkpoint when due. Returns True if a
        checkpoint was written."""
        self.heartbeat.set_step(step)
        if (step + 1) % self.every:
            return False
        checkpoint.save(self.directory, self.TAG.format(step=step),
                        backend=self.backend, block=self.block)
        self._prune()
        return True

    def _prune(self) -> None:
        tags = sorted(t for t in os.listdir(self.directory)
                      if t.startswith("step_") and
                      os.path.exists(os.path.join(self.directory, t,
                                                  "manifest.json")))
        for tag in tags[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, tag))

    def stop(self) -> None:
        self.heartbeat.stop()
