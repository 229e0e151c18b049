"""Public API facade (port of ``multiverso_tpu/api.py``): the reference's
MV_* surface in snake_case. ``device()`` takes the place of ``mesh()``."""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from multiverso_tpu_torch.utils import config
from multiverso_tpu_torch.zoo import DeviceLike, Zoo


def init(argv: Optional[List[str]] = None,
         device: DeviceLike = None,
         updater: Optional[str] = None) -> None:
    """ref MV_Init. ``device=None`` means the card: without CUDA this
    raises ``RuntimeError`` unless ``device="cpu"`` (or ``-device=cpu`` in
    ``argv``) asks for the CPU. There is no ``sync`` option: one process
    on one device is always synchronous."""
    if updater is not None:
        config.set_flag("updater_type", updater)
    Zoo.get().start(argv, device=device)


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


def device() -> torch.device:
    return Zoo.get().device()


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
