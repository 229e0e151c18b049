"""Device-plane observability: host<->device transfers and the per-device
census (port of the transfer and census parts of
``multiverso_tpu/telemetry/devstats.py``).

* **Transfer chokepoint** — :func:`note_transfer` counts host<->device
  bytes per direction (``h2d``/``d2h``). The word-embedding and DLRM
  pipelines report here, and the ``h2d`` side feeds the step profiler's
  per-step ``transfer_bytes`` delta.
* **Per-device census** — :func:`device_rollup` reads, for every CUDA
  device, ``torch.cuda.memory_allocated`` (``bytes``) and the caching
  allocator's live block count (``arrays``), where the JAX package
  groups ``jax.live_arrays()`` by device. It rides MSG_STATS as the
  ``"devices"`` block's ``per_device`` and the exporter emits it as
  ``mv_dev_live_*`` gauges.

The block keeps the JAX package's keys, so its readers take either
package's payload: ``collectives`` and ``compiles_by_mesh`` are always
empty here. Their producers (mesh-keyed compile events, collective spans
and the SPMD compile-hygiene capture) serve device meshes, which this
package does not have yet (ROADMAP.md §A item 1).

Cost: the ``devstats`` flag (default on) gates every recording site
behind one attribute read; a counter is one int add under a lock at a
per-batch site; the census runs only on a stats pull.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from multiverso_tpu_torch.utils import config

config.define_bool(
    "devstats", True,
    "device-plane observability (telemetry/devstats.py): host<->device "
    "transfer byte counters and the per-device census in the MSG_STATS "
    "'devices' block. On by default: one attribute read gates every "
    "site; the census runs only on a stats pull")

# directions the transfer chokepoint accepts — anything else raises at
# the instrumented site (a typo'd direction must not open a third,
# never-rendered counter)
_DIRECTIONS = ("h2d", "d2h")


def device_rollup() -> Optional[Dict[str, Dict[str, int]]]:
    """Live device bytes per CUDA device: ``{"cuda:i": {"bytes",
    "arrays"}}`` from the caching allocator (``memory_allocated`` and
    ``allocation.all.current``). None when CUDA is absent or not
    initialised (a CPU run has no device census)."""
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        out: Dict[str, Dict[str, int]] = {}
        for i in range(torch.cuda.device_count()):
            dev = torch.device("cuda", i)
            out[str(dev)] = {
                "bytes": int(torch.cuda.memory_allocated(dev)),
                "arrays": int(torch.cuda.memory_stats(dev).get(
                    "allocation.all.current", 0))}
        return out
    except Exception:   # noqa: BLE001 — census is best-effort
        return None


class DevStats:
    """One per process (like the FlightRecorder/StepProfiler);
    in-process multi-rank worlds share it."""

    def __init__(self) -> None:
        self.enabled = True       # plain attribute: THE site gate
        self.rank = 0
        self._rank_pinned = False
        self._lock = threading.Lock()
        # direction -> [ops, bytes]
        self._transfers: Dict[str, List[int]] = {
            d: [0, 0] for d in _DIRECTIONS}

    def configure(self, rank: Optional[int] = None) -> None:
        """Adopt the ``devstats`` flag (PSService init / Zoo.start);
        idempotent, first caller's rank sticks."""
        if rank is not None and not self._rank_pinned:
            self.rank = int(rank)
            self._rank_pinned = True
        self.enabled = bool(config.get_flag("devstats"))

    def note_transfer(self, nbytes: int, direction: str = "h2d") -> None:
        """THE host<->device transfer chokepoint. ``h2d`` additionally
        feeds the step profiler's per-step transfer delta."""
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction {direction!r}: expected one of "
                             f"{_DIRECTIONS}")
        if self.enabled:
            with self._lock:
                g = self._transfers[direction]
                g[0] += 1
                g[1] += int(nbytes)
        if direction == "h2d":
            from multiverso_tpu_torch.telemetry import profiler as _profiler
            _profiler.note_transfer(int(nbytes))

    def stats_snapshot(self) -> Optional[Dict]:
        """The MSG_STATS ``"devices"`` block: per-direction transfer
        counters and the per-device census. None when the flag is off
        and when there is nothing to report."""
        if not self.enabled:
            return None
        with self._lock:
            transfers = {d: {"ops": g[0], "bytes": g[1]}
                         for d, g in self._transfers.items() if g[0]}
        per_device = device_rollup()
        if not (transfers or per_device):
            return None
        out: Dict = {"transfers": transfers, "collectives": {},
                     "compiles_by_mesh": {}}
        if per_device:
            out["per_device"] = per_device
        return out

    def reset(self) -> None:
        """Test isolation: drop counters and unpin."""
        with self._lock:
            self._transfers = {d: [0, 0] for d in _DIRECTIONS}
            self._rank_pinned = False
            self.rank = 0
        self.enabled = True


DEVSTATS = DevStats()


# module-level wrappers (the call-site idiom, like telemetry.profiler)
def enabled() -> bool:
    return DEVSTATS.enabled


def configure(rank: Optional[int] = None) -> None:
    DEVSTATS.configure(rank)


def note_transfer(nbytes: int, direction: str = "h2d") -> None:
    DEVSTATS.note_transfer(nbytes, direction)


def stats_snapshot() -> Optional[Dict]:
    return DEVSTATS.stats_snapshot()


def reset() -> None:
    DEVSTATS.reset()
