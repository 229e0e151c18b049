"""Multi-worker BSP training over a worker mesh axis (port of
``multiverso_tpu/parallel/worker_map.py``).

The reference's synchronous data parallelism: N workers push deltas and
the SyncServer's vector clocks make every i-th Get see the same state on
all of them (ref: src/server.cpp:68-222, flag -sync=true). Here each
worker is one rank of the world: it computes its gradient on its batch
shard, the gradients and losses meet in one all-reduce mean over the
worker axis (the BSP merge), and the merged step goes through the
table's updater with ``functional_add``. The table's rows are sharded
over the mesh's table axis (``table.py``): the step gathers the
parameters over that axis before ``grad_fn`` (the JAX ``in_specs=P()``),
the ranks of one worker group compute the same merged gradient, and each
applies its own block of it. Every worker sees the same table state (the
SyncServer guarantee) because every rank applies the same merged delta.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.parallel.mesh import Mesh
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.zoo import Zoo


def make_worker_mesh(num_workers: int, axis: str = "worker",
                     shard_axis: str = "mv", device=None) -> Mesh:
    """A (worker, shard) mesh over the world's ranks: batch parallel over
    ``worker``, the rest over ``shard``. ``num_workers`` must divide the
    world size. Collective: every rank builds it."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % num_workers:
        raise ValueError(
            f"{num_workers} workers do not divide {world} ranks")
    return Mesh({axis: num_workers, shard_axis: world // num_workers},
                device=device)


def worker_step(table, grad_fn: Callable, learning_rate: float = 0.1,
                axis: str = "worker",
                opt: Optional[AddOption] = None) -> Callable:
    """Build ``step(state, batch) -> (state, loss)``, ``batch`` this
    worker's shard: ``grad_fn(params_flat, batch) -> (loss, grad_flat)``
    runs on it with the whole padded parameters (gathered over the
    table axis), the gradient and the loss are averaged over ``axis``,
    the learning rate multiplies the merged gradient and the table's
    updater applies this rank's block of it (``functional_add``:
    ``state``'s tensors update in place)."""
    mesh = Zoo.get().mesh()
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    opt = opt or AddOption(learning_rate=learning_rate)
    n = mesh.axis_size(axis)

    def step(state, batch):
        loss, grad = grad_fn(table.unshard(state["data"]), batch)
        # BSP merge: one all-reduce for the gradient and the loss together
        flat = torch.cat([grad.reshape(-1).float(),
                          torch.as_tensor(loss, dtype=torch.float32,
                                          device=grad.device).reshape(1)])
        with _devstats.collective_span("worker_step",
                                       flat.numel() * flat.element_size(),
                                       mesh=mesh):
            flat = coll.raw_all_reduce(flat, mesh, axis) / n
        grad = flat[:-1].reshape(grad.shape).to(grad.dtype)
        delta = learning_rate * grad
        new_state = table.functional_add(state, delta, opt)
        return new_state, flat[-1]

    return step
