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
        self._barrier_count = 0

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
        # telemetry plane: adopt the trace_ids / step_profile / devstats
        # flags and start the flag-gated metrics exporter (no-ops unless
        # configured; a PSService starting later upgrades the exporter's
        # payload with its shard registry)
        from multiverso_tpu_torch.telemetry import devstats as _devstats
        from multiverso_tpu_torch.telemetry import exporter as _exporter
        from multiverso_tpu_torch.telemetry import flightrec as _flightrec
        from multiverso_tpu_torch.telemetry import profiler as _profiler
        from multiverso_tpu_torch.telemetry import trace as _trace
        _trace.configure(self.rank())
        _profiler.configure(self.rank())
        _devstats.configure(self.rank())
        _exporter.ensure_started(self.rank())
        # flight-recorder plane: pin the rank, give the structured log
        # sink the same rank, and dump the black box if a fault signal
        # lands (a later handler replaces this one and dumps on its own)
        _flightrec.configure(self.rank())
        log.set_rank(self.rank())
        _flightrec.install_signal_handlers()
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
            # natively-served async ops never cross the Python monitor,
            # so surface the C++ counters in the shutdown report (before
            # the final exporter snapshot, so its last record has them)
            for table in list(self._tables.values()):
                shard = getattr(table, "_shard", None)
                if shard is None or getattr(shard, "_native_ref",
                                            None) is None:
                    continue
                adds, applies = shard._native_stats()
                if adds:
                    Dashboard.note(
                        f"ps[{table.name}].native_served",
                        f"adds = {adds}, applies = {applies}")
        # final telemetry flush while the monitors still hold this run's
        # numbers (the exporter's stop() writes a last snapshot; buffered
        # trace spans and step records drain to metrics_dir). The cluster
        # aggregator goes first (its final poll needs the PS service);
        # the failover checkpointer then writes one final committed save
        # while the shards are still intact
        from multiverso_tpu_torch.ps import failover as _failover
        from multiverso_tpu_torch.ps import service as _ps_service
        from multiverso_tpu_torch.telemetry import aggregator as _aggregator
        from multiverso_tpu_torch.telemetry import exporter as _exporter
        from multiverso_tpu_torch.telemetry import flightrec as _flightrec
        from multiverso_tpu_torch.telemetry import profiler as _profiler
        from multiverso_tpu_torch.telemetry import trace as _trace
        _aggregator.stop_global()
        _failover.stop_global(final=True)
        _exporter.stop_global()
        # final black-box dump (no-op unless a dump directory resolves);
        # routine=True keeps an earlier fault dump of this process
        _flightrec.dump_global("Zoo.stop", routine=True)
        d = config.get_flag("metrics_dir")
        if d:
            try:
                _trace.dump_to(d)
            except OSError as e:
                log.error("trace dump at shutdown failed: %s", e)
            try:
                _profiler.dump_to(d)
            except OSError as e:
                log.error("profile dump at shutdown failed: %s", e)
        if config.get_flag("dashboard"):
            Dashboard.display(log.info)
            Dashboard.reset()
        # the async PS plane's default context quiesces (each rank keeps
        # serving until its live peers are done) and closes
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
        has drained. The flight recorder marks both edges: a rank that
        dies inside the barrier leaves "enter without exit" last on its
        tape."""
        from multiverso_tpu_torch.telemetry import flightrec as _flightrec
        self._barrier_count += 1
        _flightrec.record(_flightrec.EV_BARRIER_ENTER,
                          msg_id=self._barrier_count, note="zoo.barrier")
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        _flightrec.record(_flightrec.EV_BARRIER_EXIT,
                          msg_id=self._barrier_count, note="zoo.barrier")

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
