"""Zoo: lifecycle, topology, device and table registry (port of
``multiverso_tpu/zoo.py``).

The JAX package's topology is its multi-controller runtime: ranks are
``jax.process_index()``/``process_count()``, every process is a worker,
every device holds a server shard, and tables are global arrays sharded
over one mesh of every process's devices. Here a world is a
``torch.distributed`` default process group, one rank a process:
``net_init()`` (``api.py``) joins one over a ``TCPStore``, and so does
``start`` itself when a launcher's environment names a world of more than
one rank (``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``) and
no group exists yet. ``rank()``/``size()`` are the group's, or 0 and 1
without one. Every process is a worker (``num_workers()`` = processes),
and every rank of the mesh holds a server shard (``num_servers()`` = the
mesh's size, as in the JAX package).

The Zoo resolves this process's ``torch.device``: the card (``cuda``)
unless the caller names another one; a missing card is an error, never a
quiet switch to the CPU. It holds a mesh (``parallel/mesh.Mesh``) for the
parallel layers and the tables: the one given to ``start``/``init()``,
else one axis named by the ``mesh_axis`` flag over every rank of the
world (a one-rank mesh for a world of one), as the JAX package's default
mesh spans every device of every process.

The synchronous tables shard their rows over the mesh's last axis
(:meth:`Zoo.shard_axis`, the table axis): the rank at index i of that
axis holds the i-th block of the padded rows and of the row-shaped
updater state, and the other axes replicate it (``table.py``). A
whole-table Add is a reduce-scatter of the world's deltas, a whole-table
Get an all-gather of the blocks. The barrier drains this rank's card and
then meets the world (``dist.barrier``); with one process it fences the
tables written since the last barrier (``mark_dirty``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist

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
        self._mesh: Any = None
        self._tables: Dict[int, Any] = {}
        self._next_table_id = 0
        self._barrier_count = 0
        self._dirty: set = set()   # table ids written since the barrier

    @classmethod
    def get(cls) -> "Zoo":
        with cls._lock:
            if cls._instance is None:
                cls._instance = Zoo()
            return cls._instance

    def start(self, argv: Optional[List[str]] = None,
              device: DeviceLike = None, mesh: Any = None) -> None:
        """Parse flags, configure logging, resolve the device and adopt
        ``mesh`` (else the one-rank default mesh). Idempotent."""
        if self._started:
            return
        config.parse_cmd_flags(argv)
        log.configure_from_flags()
        if mesh is not None and device is None:
            device = mesh.device
        self._device = resolve_device(device)
        if not _world_up() and launcher_world() > 1:
            # a launcher started this process as one rank of a world: join
            # it, on the card LOCAL_RANK names unless a device was named
            from multiverso_tpu_torch.parallel.mesh import net_join
            self._device = net_join(
                *launcher_args(),
                device=device or config.get_flag("device") or "cuda",
                **launcher_local(),
                timeout_s=config.get_flag("net_timeout_s"))
        self._mesh = mesh if mesh is not None else self._default_mesh()
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
        # spans with no narrower scope run under this mesh's label
        _devstats.set_default_mesh(self._mesh)
        _exporter.ensure_started(self.rank())
        # flight-recorder plane: pin the rank, give the structured log
        # sink the same rank, and dump the black box if a fault signal
        # lands (a later handler replaces this one and dumps on its own)
        _flightrec.configure(self.rank())
        log.set_rank(self.rank())
        _flightrec.install_signal_handlers()
        self._started = True
        log.info("multiverso_tpu_torch started: process %d/%d on %s%s, "
                 "mesh %s", self.rank(), self.size(), self._device,
                 f" ({torch.cuda.get_device_name(self._device)})"
                 if self._device.type == "cuda" else "", self._mesh.shape)
        self.barrier()

    def _default_mesh(self):
        """One axis (the ``mesh_axis`` flag) over every rank of the world
        (the JAX package's ``zoo.py:103-106``): the tables shard over it."""
        from multiverso_tpu_torch.parallel.mesh import world_mesh
        return world_mesh(config.get_flag("mesh_axis"), self._device)

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
        if self.size() > 1:
            # no rank leaves while a peer may still read its quiesce
            # markers from the world's store
            self.barrier()
        self._tables.clear()
        self._next_table_id = 0
        self._device = None
        self._mesh = None
        self._started = False

    @property
    def started(self) -> bool:
        return self._started

    # topology (the JAX package's jax.process_index()/process_count())
    def rank(self) -> int:
        return dist.get_rank() if _world_up() else 0

    def size(self) -> int:
        return dist.get_world_size() if _world_up() else 1

    def device(self) -> torch.device:
        if self._device is None:
            raise RuntimeError(
                "multiverso_tpu_torch not initialized; call init()")
        return self._device

    def mesh(self):
        """The mesh of the parallel layers (a one-rank mesh on
        :meth:`device` when ``init()`` was given none)."""
        if self._mesh is None:
            raise RuntimeError(
                "multiverso_tpu_torch not initialized; call init()")
        return self._mesh

    def shard_axis(self) -> str:
        """The mesh's last axis (the JAX package's table axis)."""
        return self.mesh().axis_names[-1]

    def num_workers(self) -> int:
        n = config.get_flag("num_workers")
        return n if n > 0 else self.size()

    def num_servers(self) -> int:
        """The flag, else the mesh's size: every rank of the mesh holds a
        server shard (the JAX package counts every device of its mesh)."""
        n = config.get_flag("num_servers")
        if n > 0:
            return n
        return self._mesh.size if self._mesh is not None else self.size()

    def worker_id(self) -> int:
        return self.rank()

    def server_id(self) -> int:
        return self.rank()

    def worker_id_to_rank(self, worker_id: int) -> int:
        return worker_id

    def server_id_to_rank(self, server_id: int) -> int:
        return server_id

    def mark_dirty(self, table_id: int) -> None:
        """Table writes call this; the next one-process barrier fences
        only the tables written since the last one."""
        self._dirty.add(table_id)

    def barrier(self) -> None:
        """Every prior Add is visible after it. More than one process:
        drain this rank's card, then meet every rank (``dist.barrier``).
        One process: apply the queued adds of the tables written since
        the last barrier, then drain the card. The flight recorder marks
        both edges: a rank that dies inside the barrier leaves "enter
        without exit" last on its tape."""
        from multiverso_tpu_torch.telemetry import flightrec as _flightrec
        self._barrier_count += 1
        _flightrec.record(_flightrec.EV_BARRIER_ENTER,
                          msg_id=self._barrier_count, note="zoo.barrier")
        dirty, self._dirty = self._dirty, set()
        if self.size() == 1:
            for table_id in dirty:
                raw = getattr(self._tables.get(table_id), "raw", None)
                if callable(raw):
                    raw()   # flushes the table's queued host adds
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        if self.size() > 1:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()
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


def _world_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def launcher_world() -> int:
    """The world size a launcher's environment names (``WORLD_SIZE``;
    1 when it names none)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def launcher_args() -> tuple:
    """``(coordinator address, world, rank)`` from a launcher's
    environment: ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
    (``KeyError`` naming the missing variable)."""
    env = os.environ
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            int(env["WORLD_SIZE"]), int(env["RANK"]))


def launcher_local() -> Dict[str, Optional[int]]:
    """``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` (None where unset): which of
    its host's cards a rank takes."""
    env = os.environ
    return {"local_rank": int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env
            else None,
            "local_world": int(env["LOCAL_WORLD_SIZE"])
            if "LOCAL_WORLD_SIZE" in env else None}


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` resolved, or, for ``None``, where the runtime runs: the
    Zoo's device when it is up, else what ``init()`` would resolve (the
    card, or an error without one)."""
    zoo = Zoo.get()
    if device is None and zoo.started:
        return zoo.device()
    return resolve_device(device)
