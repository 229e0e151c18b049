"""Failure detection (port of ``multiverso_tpu/elastic.py``: ``peers``,
``_tombstones``, ``failed``, ``mark_failed`` and ``bind_ps``).

Each process of a job writes a JSON liveness beacon
(``heartbeat.<rank>.json``: rank, step, timestamp) to shared storage, and a
PS plane that sees a peer's socket die writes a tombstone
(``failed.<rank>.json``). These functions read both, in the JAX package's
format, so the LR app's SSP clock can stop waiting on dead workers
(``heartbeat_dir``), whichever package wrote the files. ``bind_ps`` makes
the async PS plane's socket deaths write those tombstones.

Not ported yet (ROADMAP §A): ``Heartbeat``, ``stragglers``, ``health``
and ``ElasticLoop``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


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
