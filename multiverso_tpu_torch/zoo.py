"""Zoo: lifecycle, device and table registry (port of
``multiverso_tpu/zoo.py``).

The JAX package builds a device mesh and shards every table over it. This
slice runs one process on one device, so the Zoo resolves a single
``torch.device`` in place of the mesh: ``num_workers() == num_servers() ==
1`` and the process is rank 0. The device is the card (``cuda``) unless the
caller names another one; a missing card is an error, never a quiet switch
to the CPU.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

import torch

from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.utils.dashboard import Dashboard

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` (and an empty ``device`` flag) means the card. Raises
    ``RuntimeError`` when a CUDA device is asked for and none is present."""
    if device is None or device == "":
        device = config.get_flag("device") or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multiverso_tpu_torch runs on the card by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(or -device=cpu) to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Zoo:
    """Singleton orchestrator. Use the api helpers or ``Zoo.get()``."""

    _instance: Optional["Zoo"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._started = False
        self._device: Optional[torch.device] = None
        self._tables: Dict[int, Any] = {}
        self._next_table_id = 0

    @classmethod
    def get(cls) -> "Zoo":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Zoo()
            return cls._instance

    def start(self, argv: Optional[List[str]] = None,
              device: DeviceLike = None) -> None:
        """Parse flags, configure logging, resolve the device. Idempotent."""
        if self._started:
            return
        config.parse_cmd_flags(argv)
        log.configure_from_flags()
        self._device = resolve_device(device)
        self._started = True
        log.info("multiverso_tpu_torch started: process %d/%d on %s%s",
                 self.rank(), self.size(), self._device,
                 f" ({torch.cuda.get_device_name(self._device)})"
                 if self._device.type == "cuda" else "")
        self.barrier()

    def stop(self, finalize: bool = True) -> None:
        """Drain, display the dashboard, forget the tables."""
        if not self._started:
            return
        self.barrier()
        if config.get_flag("dashboard"):
            Dashboard.display(log.info)
            Dashboard.reset()
        # the failover checkpointer writes one final committed save while
        # the shards are still intact; then the async PS plane's default
        # context quiesces (each rank keeps serving until its live peers
        # are done) and closes
        from multiverso_tpu_torch.ps import failover as _failover
        from multiverso_tpu_torch.ps import service as _ps_service
        _failover.stop_global(final=True)
        _ps_service.reset_default_context()
        self._tables.clear()
        self._next_table_id = 0
        self._device = None
        self._started = False

    @property
    def started(self) -> bool:
        return self._started

    # topology: one process, one device
    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def device(self) -> torch.device:
        if self._device is None:
            raise RuntimeError(
                "multiverso_tpu_torch not initialized; call init()")
        return self._device

    def num_workers(self) -> int:
        n = config.get_flag("num_workers")
        return n if n > 0 else self.size()

    def num_servers(self) -> int:
        # every table is one shard on the one device
        return 1

    def worker_id(self) -> int:
        return self.rank()

    def server_id(self) -> int:
        return self.rank()

    def barrier(self) -> None:
        """One process: every prior Add is visible once the device's queue
        has drained."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # table registry
    def register_table(self, table: Any) -> int:
        with self._lock:
            table_id = self._next_table_id
            self._next_table_id += 1
            self._tables[table_id] = table
            return table_id

    def table(self, table_id: int) -> Any:
        return self._tables[table_id]

    def tables(self) -> Dict[int, Any]:
        return dict(self._tables)


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` resolved, or, for ``None``, where the runtime runs: the
    Zoo's device when it is up, else what ``init()`` would resolve (the
    card, or an error without one)."""
    zoo = Zoo.get()
    if device is None and zoo.started:
        return zoo.device()
    return resolve_device(device)
