"""Stale-synchronous parallelism: bounded-staleness clocks between workers
(port of ``multiverso_tpu/ssp.py``).

The reference offers only the two extremes — pure async (its default
server, ref src/server.cpp:36-58) or strict BSP (SyncServer vector clocks,
ref src/server.cpp:68-222); its `backup_worker_ratio` flag for anything in
between is declared but dead (ref src/server.cpp:21). This module completes
the spectrum: an :class:`SSPClock` lets each worker run ahead of the slowest
peer by at most ``staleness`` steps.

* ``staleness=0`` — lockstep, the SyncServer BSP guarantee.
* ``staleness=s`` — classic SSP: a fast worker blocks only when it would be
  more than ``s`` clocks ahead; stragglers never block anyone.
* large ``staleness`` — effectively the async default server.

Mechanism: one clock beacon file per worker on shared storage
(``sspclock.<worker>.json``, atomic rename, readable by any process; the
JAX package's format, so workers of both packages can share a directory),
polled on advance. SSP governs uncoordinated per-process training loops,
where the reference's SyncServer would sit. Compose with
:func:`multiverso_tpu_torch.elastic.failed` to stop waiting on dead
workers.

A blocked wait marks the flight recorder: ``ssp.wait`` when it blocks,
``ssp.resolved`` when it clears, and ``ssp.timeout`` (with the clock
snapshot) before the timeout raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.zoo import Zoo


class SSPTimeout(TimeoutError):
    """A worker waited longer than ``timeout`` for stragglers to catch up."""


class SSPClock:
    """Bounded-staleness clock over a shared directory.

    Call :meth:`tick` once per training step. It publishes this worker's
    new clock, then blocks until ``min(peer clocks) >= clock - staleness``.
    """

    def __init__(self, directory: str, staleness: int = 1,
                 num_workers: Optional[int] = None,
                 worker_id: Optional[int] = None,
                 poll: float = 0.02, timeout: Optional[float] = 600.0,
                 ignore: Optional[Callable[[], List[int]]] = None):
        """``timeout`` (seconds, None = forever) bounds every wait — the
        default keeps a dead/never-launched peer (e.g. ``num_workers``
        larger than the processes actually started) from hanging the fleet
        silently. ``ignore`` returns worker ids to exclude from the bound
        (pass ``lambda: elastic.failed(hb_dir)`` for heartbeat-driven
        exclusion). A restarted worker resumes from its existing beacon
        rather than re-publishing clock 0 (which would stall every peer at
        the staleness bound until it caught back up)."""
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        zoo = Zoo.get()
        self.directory = directory
        self.staleness = int(staleness)
        self.num_workers = (zoo.num_workers() if num_workers is None
                            else int(num_workers))
        self.worker_id = (zoo.worker_id() if worker_id is None
                          else int(worker_id))
        self.poll = poll
        self.timeout = timeout
        self._ignore = ignore
        os.makedirs(directory, exist_ok=True)
        try:  # resume: pick up this worker's beacon from a previous run
            with open(self._path(self.worker_id)) as f:
                self._clock = int(json.load(f).get("clock", 0))
        except (OSError, ValueError):
            self._clock = 0
        self._publish()

    def _path(self, worker_id: int) -> str:
        return os.path.join(self.directory, f"sspclock.{worker_id}.json")

    def _publish(self) -> None:
        tmp = self._path(self.worker_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"worker": self.worker_id, "clock": self._clock}, f)
        os.replace(tmp, self._path(self.worker_id))

    @property
    def clock(self) -> int:
        return self._clock

    def peer_clocks(self) -> Dict[int, int]:
        """Latest published clock per worker (absent file = clock 0,
        a worker that has not started yet)."""
        clocks = {}
        for w in range(self.num_workers):
            try:
                with open(self._path(w)) as f:
                    clocks[w] = int(json.load(f).get("clock", 0))
            except (OSError, ValueError):
                clocks[w] = 0
        return clocks

    def _min_live_clock(self) -> int:
        clocks = self.peer_clocks()
        dead = set(self._ignore()) if self._ignore is not None else ()
        live = [c for w, c in clocks.items() if w not in dead]
        return min(live) if live else self._clock

    def tick(self) -> int:
        """Advance this worker's clock by one and enforce the bound.
        Returns the new clock value."""
        self._clock += 1
        self._publish()
        self.wait()
        return self._clock

    def wait(self) -> None:
        """Block until the slowest live worker is within ``staleness`` of
        this worker's clock. Raises :class:`SSPTimeout` after ``timeout``
        seconds (None = wait forever) — the exception message carries the
        full per-worker clock snapshot (and which workers were excluded
        as dead) so a fleet-wide stall is attributable from the error
        alone, and the flight recorder gets the same snapshot before the
        raise."""
        from multiverso_tpu_torch.telemetry import flightrec
        deadline = (None if self.timeout is None
                    else time.monotonic() + self.timeout)
        warned = False
        while self._min_live_clock() < self._clock - self.staleness:
            if deadline is not None and time.monotonic() > deadline:
                clocks = self.peer_clocks()
                dead = sorted(self._ignore()) if self._ignore else []
                snapshot = (f"clock {self._clock}, staleness "
                            f"{self.staleness}, peer clocks {clocks}, "
                            f"ignored-dead {dead}")
                flightrec.record(flightrec.EV_SSP_TIMEOUT,
                                 note=snapshot[:200])
                raise SSPTimeout(
                    f"worker {self.worker_id} waited >{self.timeout}s "
                    f"for stragglers ({snapshot})")
            if not warned:
                log.debug(f"[ssp] worker {self.worker_id} clock "
                          f"{self._clock} waiting on stragglers")
                flightrec.record(flightrec.EV_SSP_WAIT,
                                 msg_id=self._clock)
                warned = True
            time.sleep(self.poll)
        if warned:   # the blocked wait resolved: close the edge
            flightrec.record(flightrec.EV_SSP_RESOLVED,
                             msg_id=self._clock)
