"""Public API facade (port of ``multiverso_tpu/api.py``): the reference's
MV_* surface in snake_case, with ``device()`` beside ``mesh()``, and the
``MV_*`` aliases of the reference binding.

The reference's MV_NetBind/MV_NetConnect map onto :func:`net_init`, which
joins this process to a ``torch.distributed`` world through a
``TCPStore`` (the JAX package wraps ``jax.distributed.initialize``)."""

from __future__ import annotations

from typing import Any, List, Optional, Union

import numpy as np
import torch

from multiverso_tpu_torch.utils import config, log
from multiverso_tpu_torch.zoo import (DeviceLike, Zoo, launcher_args,
                                      launcher_local)


def init(argv: Optional[List[str]] = None,
         device: DeviceLike = None,
         mesh: Any = None,
         updater: Optional[str] = None) -> None:
    """ref MV_Init. ``device=None`` means the card (or ``mesh``'s device
    when a mesh is given): without CUDA this raises ``RuntimeError``
    unless ``device="cpu"`` (or ``-device=cpu`` in ``argv``) asks for the
    CPU. ``mesh`` is this rank's ``parallel.mesh.Mesh`` over its
    ``torch.distributed`` world; without one the Zoo makes a one-rank mesh.
    Under a launcher's environment naming a world of more than one rank
    (and no process group yet) it joins that world first, as
    :func:`net_init` does. There is no ``sync`` option: the tables'
    collective adds keep every process in step."""
    if updater is not None:
        config.set_flag("updater_type", updater)
    Zoo.get().start(argv, device=device, mesh=mesh)


def shutdown(finalize: bool = True) -> None:
    """ref MV_ShutDown."""
    Zoo.get().stop(finalize)


def barrier() -> None:
    """ref MV_Barrier."""
    Zoo.get().barrier()


def rank() -> int:
    return Zoo.get().rank()


def size() -> int:
    return Zoo.get().size()


def num_workers() -> int:
    return Zoo.get().num_workers()


def num_servers() -> int:
    return Zoo.get().num_servers()


def worker_id() -> int:
    return Zoo.get().worker_id()


def server_id() -> int:
    return Zoo.get().server_id()


def worker_id_to_rank(wid: int) -> int:
    return Zoo.get().worker_id_to_rank(wid)


def server_id_to_rank(sid: int) -> int:
    return Zoo.get().server_id_to_rank(sid)


def device() -> torch.device:
    return Zoo.get().device()


def mesh():
    """The Zoo's mesh (``parallel.mesh.Mesh``)."""
    return Zoo.get().mesh()


def is_master_worker() -> bool:
    """Worker 0 initializes shared values (reference binding convention)."""
    return worker_id() == 0


def create_table(option: Any, name: Optional[str] = None):
    """ref MV_CreateTable: build from an Option struct and barrier."""
    if not hasattr(option, "build"):
        raise TypeError(
            f"create_table expects a table Option (ArrayTableOption, ...), "
            f"got {type(option).__name__}: {option!r}")
    table = option.build(name) if name is not None else option.build()
    barrier()
    return table


def aggregate(data: Union[np.ndarray, torch.Tensor, Any],
              size: Optional[int] = None) -> np.ndarray:
    """ref MV_Aggregate: the sum of every process's ``data`` (the first
    ``size`` elements when given), written back into ``data`` when it is
    a numpy array, also a non-contiguous one, and returned. One process:
    the data itself. More: one all_reduce over the world
    (``collectives.process_sum``); every process calls it with the same
    shape."""
    arr = np.asarray(data)
    if size is not None:
        arr = arr.reshape(-1)[:size]
    if Zoo.get().size() == 1:
        out = arr
    else:
        from multiverso_tpu_torch.parallel.collectives import process_sum
        out = process_sum(arr)
    if isinstance(data, np.ndarray):
        # ndarray.flat writes through a view, so a non-contiguous input
        # (which reshape(-1) would copy) still gets the in-place write
        data.flat[: out.size] = out.reshape(-1)
        return data
    return out


def net_init(coordinator_address: Optional[str] = None,
             num_processes: Optional[int] = None,
             process_id: Optional[int] = None,
             device: DeviceLike = None) -> int:
    """ref MV_NetBind/MV_NetConnect: join this process to a world of
    ``num_processes`` ranks as rank ``process_id``, meeting through a
    ``TCPStore`` at ``coordinator_address`` (``host:port``) that rank 0
    hosts. Arguments left ``None`` come from a launcher's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; and
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` for the rank's card), as
    ``jax.distributed.initialize`` reads its cluster's. The backend is
    nccl when each rank of the host has its own card, gloo otherwise (the
    CPU, or ranks sharing a card). ``device`` is where the ranks compute:
    the card unless it names another. The store's connect and every
    collective of the world give up after the ``net_timeout_s`` flag's
    seconds. Call it before :func:`init`. Returns 0, or -1 with the
    error logged."""
    try:
        from multiverso_tpu_torch.parallel.mesh import net_join
        if None in (coordinator_address, num_processes, process_id):
            addr, world, rank = launcher_args()
            coordinator_address = coordinator_address or addr
            num_processes = world if num_processes is None \
                else num_processes
            process_id = rank if process_id is None else process_id
        net_join(coordinator_address, int(num_processes), int(process_id),
                 device=device or config.get_flag("device") or "cuda",
                 **launcher_local(),
                 timeout_s=config.get_flag("net_timeout_s"))
        return 0
    except Exception as e:  # noqa: BLE001 — the reference's int status
        log.error("net_init failed: %s: %s", type(e).__name__, e)
        return -1


# reference Python-binding names (ref binding api.py:54 workers_num)
workers_num = num_workers
servers_num = num_servers

# MV_* aliases (ref include/multiverso/multiverso.h)
MV_Init = init
MV_ShutDown = shutdown
MV_Barrier = barrier
MV_Rank = rank
MV_Size = size
MV_NumWorkers = num_workers
MV_NumServers = num_servers
MV_WorkerId = worker_id
MV_ServerId = server_id
MV_WorkerIdToRank = worker_id_to_rank
MV_ServerIdToRank = server_id_to_rank
MV_CreateTable = create_table
MV_Aggregate = aggregate
