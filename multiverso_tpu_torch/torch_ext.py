"""Delta-sync data parallelism for ``torch.nn.Module``s (port of
``multiverso_tpu/torch_ext.py``).

The reference shipped framework bindings as its user surface: Theano
``mv_shared``/``mv_sync`` (ref binding/python/multiverso/theano_ext/
sharedvar.py:38-50) and Lasagne's ``MVNetParamManager``, which flattens
every network parameter into one ArrayTable (ref theano_ext/lasagne_ext/
param_manager.py:9-64). ``TorchParamManager`` does that for a PyTorch
module: its parameters flattened into one float32 ArrayTable, and
``sync()`` runs the Add(current - last) -> Get delta-sync ASGD recipe,
writing the merged state back into the module in place. The JAX package
crosses to numpy on the host for every sync; here the flat vector stays
on the module's device, and the table's own device is the only other
place it goes (none, when the module lives where the Zoo's tables do).

Usage::

    manager = TorchParamManager(model)          # master-init convention
    for batch in loader:
        loss.backward(); opt.step()
        if step % sync_frequency == 0:
            manager.sync()                      # ASGD merge across workers
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv


class TorchParamManager:
    """``MVNetParamManager`` for PyTorch modules (ref param_manager.py:9-64).

    Flattens ``module.parameters()`` into one float32 ArrayTable. Worker 0
    seeds the table with its initial values, other workers add zeros, so
    after the constructor's barrier every worker holds worker 0's init
    (ref param_manager.py:24-31 master-init)."""

    def __init__(self, module: torch.nn.Module, name: str = "torch_params"):
        self._module = module
        self._shapes: List[Tuple[int, ...]] = [
            tuple(p.shape) for p in module.parameters()]
        self._sizes = [int(np.prod(s)) if s else 1 for s in self._shapes]
        # paramless modules still get a 1-slot table so the Add/Get/barrier
        # protocol below stays collective-uniform across workers
        self._width = max(sum(self._sizes), 1)
        first = next(iter(module.parameters()), None)
        self._device = first.device if first is not None else mv.device()
        self.table = mv.ArrayTable(self._width, dtype=np.float32, name=name)
        flat = self._flatten()
        self.table.add(flat if mv.is_master_worker()
                       else torch.zeros_like(flat))
        mv.barrier()
        self._last = self._pull()
        self._write_back(self._last)

    def _flatten(self) -> torch.Tensor:
        """Module params as one float32 vector on the module's device,
        padded to the table width."""
        out = torch.zeros(self._width, dtype=torch.float32,
                          device=self._device)
        off = 0
        for p, size in zip(self._module.parameters(), self._sizes):
            out[off: off + size] = p.detach().reshape(-1).to(torch.float32)
            off += size
        return out

    def _pull(self) -> torch.Tensor:
        """The table's whole value, a copy on the module's device (the
        table applies in dispatch order, so its live tensor reflects every
        add made before; a sharded table's blocks are gathered, a
        collective as every caller is)."""
        return self.table.unshard(self.table.raw())[: self._width].to(
            self._device, torch.float32, copy=True)

    def _write_back(self, flat: torch.Tensor) -> None:
        with torch.no_grad():
            off = 0
            for p, shape, size in zip(self._module.parameters(),
                                      self._shapes, self._sizes):
                p.copy_(flat[off: off + size].reshape(shape))
                off += size

    def sync(self) -> None:
        """Add(current - last) then Get, in place into the module
        (ref sharedvar.py mv_sync :38-50 semantics)."""
        self.table.add(self._flatten() - self._last)
        self._last = self._pull()
        self._write_back(self._last)

    def pull(self) -> None:
        """Get without pushing (refresh from the global state)."""
        self._last = self._pull()
        self._write_back(self._last)

    def numel(self) -> int:
        return int(sum(self._sizes))
