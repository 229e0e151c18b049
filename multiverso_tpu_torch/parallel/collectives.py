"""Collectives over a mesh axis (port of
``multiverso_tpu/parallel/collectives.py``), and the differentiable
collectives the parallel layers place by hand.

The JAX functions take a global axis-sharded array and run one XLA
collective inside ``shard_map``. The port is one rank a process: each
function takes THIS rank's chunk and returns what the JAX output holds
on this rank.

* :func:`all_reduce` — the sum of the ranks' chunks (replicated).
* :func:`all_gather` — the ranks' chunks concatenated on dim 0.
* :func:`reduce_scatter` — the sum of the ranks' arrays, this rank's
  slice of it (the reference's ReduceScatter; the JAX function, given the
  replicated sum, returns the same slice).
* :func:`broadcast` — the ``root`` rank's chunk.
* :func:`process_sum` — a host array summed over the whole world.
* :func:`process_sum_tensor` — a tensor summed over the whole world.
* :func:`process_allgather` — every process's host array, stacked.
* :func:`process_reduce_scatter` — host arrays summed over a mesh axis,
  this rank's slice of dim 0 (a sharded table's whole-table Add).
* :func:`process_all_gather` — host arrays over a mesh axis,
  concatenated on dim 0 (a sharded table's whole-table Get).

The differentiable collectives are ``torch.autograd.Function``s, each
backward the pair of its forward:

======================  =================================================
forward                 backward
======================  =================================================
``all_gather_grad``     reduce_scatter (sequence-parallel and FSDP
                        gathers: each rank computes on the gathered value
                        with its own data or weights)
``reduce_scatter_grad`` all_gather
``all_to_all``          the inverse all_to_all
``ppermute``            the inverse ppermute
``copy_to``             all_reduce (Megatron's f: a replicated value
                        entering rank-specific compute)
``reduce_from``         identity (Megatron's g: partial sums become one
                        replicated value)
``sum_over``            all_reduce (a sum over the ranks' shards of one
                        batch that each rank's own loss reads, such as
                        BatchNorm's moments: every rank's inputs feed
                        every rank's loss)
``gather_from``         this rank's slice (a sharded value gathered into
                        replicated compute)
``scatter_to``          all_gather (a replicated value split into
                        rank-specific compute)
======================  =================================================

A replicated tensor carries one logical value and one logical gradient,
the same on every rank of its group; a sharded or partial one carries
its rank's own. On the data axes (batch and sequence shards) the objective
is the mean of the ranks' local losses, and the train steps average the
gradients of the parameters replicated there.

Every dispatch, forward or backward, runs inside
``telemetry/devstats.collective_span`` (Dashboard ``coll[op]``, flight
recorder ``coll.begin``/``coll.end``, a profiler async span, the
``"devices"`` block's ``collectives``); ``tools/check_obs_surface.py``
checks that no call into ``torch.distributed`` here runs outside one.

**Transport.** NCCL when every rank has its own card, gloo otherwise
(two ranks on one card: NCCL refuses them). Gloo (torch 2.11+cu128, an
H100) runs ``all_reduce``, ``broadcast``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` on CUDA tensors, but not the point-to-point sends
of ``ppermute`` (``batch_isend_irecv``, ``send``/``recv``: its TCP pair
writes from the device pointer and fails with "Bad address"). So on gloo
``ppermute`` runs on host copies of its CUDA tensors, here and only here
(:func:`_run`): each copy counts through ``devstats.note_transfer``, and
:func:`staged_counts` tallies the staged calls and bytes by op. The
compute stays on the card; a CPU tensor is never staged.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.zoo import Zoo

# the collectives gloo runs on CUDA tensors; the rest stage through host
# buffers (see the module docstring)
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather",
                           "reduce_scatter", "all_to_all"})

_staged_lock = threading.Lock()
_staged: Dict[str, List[int]] = {}   # op -> [calls, bytes copied]


def staged_counts() -> Dict[str, Dict[str, int]]:
    """``{op: {"calls", "bytes"}}`` of the collectives that ran on host
    copies of CUDA tensors (bytes: both directions)."""
    with _staged_lock:
        return {op: {"calls": c, "bytes": b}
                for op, (c, b) in _staged.items()}


def reset_staged_counts() -> None:
    with _staged_lock:
        _staged.clear()


def _mesh_axes(axis, mesh=None):
    """(mesh, axes): ``axis`` defaults to the mesh's last axis (the
    table axis), ``mesh`` to the Zoo's."""
    if mesh is None:
        zoo = Zoo.get()
        mesh = zoo.mesh()
        return mesh, (axis or zoo.shard_axis())
    return mesh, (axis or mesh.axis_names[-1])


def _stages(op: str, tensors: Sequence[torch.Tensor], group) -> bool:
    if not any(t.is_cuda for t in tensors):
        return False
    return dist.get_backend(group) == "gloo" and op not in GLOO_CUDA_OPS


def _run(op: str, fn, inputs: Sequence[torch.Tensor],
         outputs: Sequence[torch.Tensor], group,
         inplace: bool = False) -> None:
    """Run ``fn(inputs, outputs)`` (a torch.distributed call) where the
    backend can: on the tensors themselves, or on host copies of them
    when gloo cannot take their CUDA memory for ``op``. ``inplace``: the
    outputs' values are inputs too (all_reduce, broadcast)."""
    if not _stages(op, list(inputs) + list(outputs), group):
        fn(inputs, outputs)
        return
    nbytes = 0
    h_in = []
    for t in inputs:
        _devstats.note_transfer(_nbytes(t), "d2h")
        nbytes += _nbytes(t)
        h_in.append(t.cpu())
    if inplace:
        h_out = []
        for t in outputs:
            _devstats.note_transfer(_nbytes(t), "d2h")
            nbytes += _nbytes(t)
            h_out.append(t.cpu())
    else:
        h_out = [torch.zeros(t.shape, dtype=t.dtype) for t in outputs]
    fn(h_in, h_out)
    for t, h in zip(outputs, h_out):
        _devstats.note_transfer(h.numel() * h.element_size(), "h2d")
        nbytes += h.numel() * h.element_size()
        t.copy_(h)
    with _staged_lock:
        c = _staged.setdefault(op, [0, 0])
        c[0] += 1
        c[1] += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------- #
# the raw collectives: every torch.distributed call of the port's
# parallel layers goes through one of these, inside a span
# ---------------------------------------------------------------------- #
def raw_all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
                   ) -> torch.Tensor:
    """Sum (or max) of ``x`` over the group of ``axes``; a new tensor."""
    group = mesh.group(axes)
    with _devstats.collective_span("all_reduce", _nbytes(x), mesh=mesh):
        out = x.detach().clone().contiguous()
        if group is None:
            return out
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        _run("all_reduce",
             lambda i, o: dist.all_reduce(o[0], op=red, group=group),
             [], [out], group, inplace=True)
        return out


def raw_broadcast(x: torch.Tensor, mesh, axes, root: int) -> torch.Tensor:
    """The value of the rank at index ``root`` along ``axes``."""
    group = mesh.group(axes)
    with _devstats.collective_span("broadcast", _nbytes(x), mesh=mesh):
        out = x.detach().clone().contiguous()
        if group is None:
            return out
        src = mesh.group_ranks(axes)[root]
        _run("broadcast",
             lambda i, o: dist.broadcast(o[0], src=src, group=group),
             [], [out], group, inplace=True)
        return out


def raw_all_gather(x: torch.Tensor, mesh, axes, dim: int = 0
                   ) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` in index order."""
    group = mesh.group(axes)
    n = mesh.axis_size(axes)
    with _devstats.collective_span("all_gather", _nbytes(x) * n,
                                   mesh=mesh):
        if group is None:
            return x.detach().clone()
        x0 = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((n, x0.numel()), dtype=x.dtype, device=x.device)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        _run("all_gather", lambda i, o: gather(o[0], i[0], group=group),
             [x0.reshape(-1)], [out.reshape(-1)], group)
        out = out.reshape((n * x0.shape[0],) + tuple(x0.shape[1:]))
        return out.movedim(0, dim).contiguous()


def raw_reduce_scatter(x: torch.Tensor, mesh, axes, dim: int = 0
                       ) -> torch.Tensor:
    """The sum of the ranks' ``x``, this rank's slice of it on ``dim``."""
    group = mesh.group(axes)
    n = mesh.axis_size(axes)
    with _devstats.collective_span("reduce_scatter", _nbytes(x),
                                   mesh=mesh):
        if group is None:
            return x.detach().clone()
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} not divisible "
                             f"by {n} shards")
        x0 = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((x0.shape[0] // n,) + tuple(x0.shape[1:]),
                          dtype=x.dtype, device=x.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        _run("reduce_scatter",
             lambda i, o: scatter(o[0], i[0], group=group),
             [x0.reshape(-1)], [out.reshape(-1)], group)
        return out.movedim(0, dim).contiguous()


def raw_all_to_all(x: torch.Tensor, mesh, axes, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``split_dim`` into
    n chunks, send chunk j to index j, concatenate what arrives on
    ``concat_dim`` in source order."""
    group = mesh.group(axes)
    n = mesh.axis_size(axes)
    with _devstats.collective_span("all_to_all", _nbytes(x), mesh=mesh):
        if group is None:
            return x.detach().clone()
        if x.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} not "
                             f"divisible by {n} shards")
        xs = x.detach().movedim(split_dim, 0)
        xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
        xs = xs.contiguous()
        out = torch.empty_like(xs)
        _run("all_to_all",
             lambda i, o: dist.all_to_all_single(o[0], i[0], group=group),
             [xs], [out], group)
        # out[j] is source j's chunk: [n, c, ...rest] with split_dim moved
        # first; put it back and concatenate the sources on concat_dim
        out = out.movedim(1, split_dim + 1)       # [n, ...x dims]
        out = out.movedim(0, concat_dim)          # n next to concat_dim
        shape = list(out.shape)
        shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                            * shape[concat_dim + 1]]
        return out.reshape(shape).contiguous()


def raw_ppermute(x: torch.Tensor, mesh, axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: send ``x`` along the (src, dst) index pairs
    of ``perm``; an index that receives nothing gets zeros."""
    group = mesh.group(axes)
    me = mesh.index(axes)
    ranks = mesh.group_ranks(axes)
    with _devstats.collective_span("ppermute", _nbytes(x), mesh=mesh):
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        xc = x.detach().contiguous()
        if group is None:
            return xc.clone() if src else torch.zeros_like(xc)
        out = torch.zeros_like(xc)
        if src and dst and src[0] == me and dst[0] == me:
            out.copy_(xc)
            return out

        def ops(i, o):
            return ([dist.P2POp(dist.isend, i[0], ranks[d], group)
                     for d in dst]
                    + [dist.P2POp(dist.irecv, o[0], ranks[s], group)
                       for s in src])

        _run("ppermute", lambda i, o: [
            w.wait() for w in dist.batch_isend_irecv(ops(i, o))],
            [xc], [out], group)
        return out


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """Index i sends to i + 1, the last to 0."""
    return [(i, (i + 1) % n) for i in range(n)]


# ---------------------------------------------------------------------- #
# differentiable collectives
# ---------------------------------------------------------------------- #
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return raw_all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return raw_reduce_scatter(g, mesh, axes, dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return raw_reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return raw_all_gather(g, mesh, axes, dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return raw_all_to_all(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (raw_all_to_all(g, mesh, axes, concat_dim, split_dim),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, perm):
        ctx.args = (mesh, axes, perm)
        return raw_ppermute(x, mesh, axes, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, perm = ctx.args
        inv = [(d, s) for s, d in perm]
        return raw_ppermute(g, mesh, axes, inv), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return raw_all_reduce(g, mesh, axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return raw_all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return raw_all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return raw_all_reduce(g, mesh, axes), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim, x.shape[dim])
        return raw_all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, size = ctx.args
        i = mesh.index(axes)
        return (g.narrow(dim, i * size, size).contiguous(), None, None,
                None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        n, i = mesh.axis_size(axes), mesh.index(axes)
        size = x.shape[dim] // n
        return x.narrow(dim, i * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return raw_all_gather(g, mesh, axes, dim), None, None, None


def _live(mesh, axes) -> bool:
    return mesh.axis_size(axes) > 1


def all_gather_grad(x, mesh, axes, dim: int = 0):
    """all_gather on ``dim``; backward reduce_scatter."""
    return _AllGather.apply(x, mesh, axes, dim) if _live(mesh, axes) \
        else x


def reduce_scatter_grad(x, mesh, axes, dim: int = 0):
    """reduce_scatter on ``dim``; backward all_gather."""
    return _ReduceScatter.apply(x, mesh, axes, dim) \
        if _live(mesh, axes) else x


def all_to_all(x, mesh, axes, split_dim: int, concat_dim: int):
    """Tiled all_to_all; backward the inverse all_to_all."""
    return _AllToAll.apply(x, mesh, axes, split_dim, concat_dim) \
        if _live(mesh, axes) else x


def ppermute(x, mesh, axes, perm):
    """ppermute along ``perm``; backward along the inverse pairs."""
    return _PPermute.apply(x, mesh, axes, list(perm))


def copy_to(x, mesh, axes):
    """Identity; backward all_reduce."""
    return _CopyTo.apply(x, mesh, axes) if _live(mesh, axes) else x


def reduce_from(x, mesh, axes):
    """all_reduce (sum); backward identity."""
    return _ReduceFrom.apply(x, mesh, axes) if _live(mesh, axes) else x


def sum_over(x, mesh, axes):
    """all_reduce (sum); backward all_reduce. For a sum of partial sums
    over the shards of one batch (each rank its rows) that feeds every
    rank's own loss: the gradient of the objective, the sum of the ranks'
    losses, at this rank's partial sum is the sum of the ranks' gradients
    at the total (``reduce_from``'s identity backward would keep only this
    rank's)."""
    return _SumOver.apply(x, mesh, axes) if _live(mesh, axes) else x


def gather_from(x, mesh, axes, dim: int):
    """all_gather on ``dim``; backward this rank's slice."""
    return _GatherFrom.apply(x, mesh, axes, dim) if _live(mesh, axes) \
        else x


def scatter_to(x, mesh, axes, dim: int):
    """This rank's slice on ``dim``; backward all_gather."""
    return _ScatterTo.apply(x, mesh, axes, dim) if _live(mesh, axes) \
        else x


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of a scalar over ``axes`` whose gradient passes to this
    rank's ``x`` unchanged: on the data axes the train steps average the
    ranks' gradients afterwards, so this rank's share is already 1/n."""
    if not _live(mesh, axes):
        return x
    m = raw_all_reduce(x.detach(), mesh, axes) / mesh.axis_size(axes)
    return x + (m - x.detach())


# ---------------------------------------------------------------------- #
# the host-plane entry points (the JAX package's surface)
# ---------------------------------------------------------------------- #
def _tensor(x, mesh) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def all_reduce(x, axis: Optional[str] = None, mesh=None) -> torch.Tensor:
    """Sum this rank's chunk over ``axis`` (the reference Allreduce,
    ref AllreduceEngine::Allreduce): every rank gets the sum."""
    mesh, ax = _mesh_axes(axis, mesh)
    return raw_all_reduce(_tensor(x, mesh), mesh, ax)


def all_gather(x, axis: Optional[str] = None, mesh=None) -> torch.Tensor:
    """The ranks' chunks concatenated on dim 0, on every rank
    (ref AllreduceEngine::Allgather)."""
    mesh, ax = _mesh_axes(axis, mesh)
    return raw_all_gather(_tensor(x, mesh), mesh, ax, 0)


def reduce_scatter(x, axis: Optional[str] = None, mesh=None
                   ) -> torch.Tensor:
    """Sum the ranks' arrays and leave each with its slice on dim 0
    (ref AllreduceEngine::ReduceScatter)."""
    mesh, ax = _mesh_axes(axis, mesh)
    return raw_reduce_scatter(_tensor(x, mesh), mesh, ax, 0)


def broadcast(x, root: int = 0, axis: Optional[str] = None, mesh=None
              ) -> torch.Tensor:
    """Every rank adopts index ``root``'s chunk (the controller
    broadcast, ref src/controller.cpp)."""
    mesh, ax = _mesh_axes(axis, mesh)
    return raw_broadcast(_tensor(x, mesh), mesh, ax, root)


def _group_tensor(arr: np.ndarray, group=None) -> torch.Tensor:
    """A private copy of ``arr`` where ``group``'s backend (the world's
    for None) reduces: the host for gloo, this rank's card for nccl."""
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if dist.get_backend(group) == "nccl":
        _devstats.note_transfer(arr.nbytes, "h2d")
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _host(t: torch.Tensor, nbytes: int) -> np.ndarray:
    if t.is_cuda:
        _devstats.note_transfer(nbytes, "d2h")
    return t.cpu().numpy()


def process_sum(arr: np.ndarray) -> np.ndarray:
    """Sum identical-shaped per-process host arrays over the whole world
    with one all_reduce (the reference reduce-scattered for this, ref
    src/net/allreduce_engine.cpp:39-53), in ``arr``'s dtype; ``arr`` is
    not changed. A world of one: identity. Called collectively, every
    process with the same shape and dtype."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr
    world = dist.get_world_size()
    t = _group_tensor(arr)
    with _devstats.collective_span("process_sum", arr.nbytes,
                                   mesh={"proc": world}):
        dist.all_reduce(t)
    return _host(t, arr.nbytes).astype(arr.dtype, copy=False)


def process_sum_tensor(t: torch.Tensor) -> torch.Tensor:
    """The sum of every process's ``t`` (same shape and dtype on each),
    as a new tensor on ``t``'s device: one all_reduce, on the card where
    the backend takes CUDA tensors (nccl, and gloo's all_reduce: C.19),
    else through a host copy. ``t`` is not changed."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    world = dist.get_world_size()
    out = t.detach().clone().contiguous()
    with _devstats.collective_span("process_sum", _nbytes(out),
                                   mesh={"proc": world}):
        if out.is_cuda or dist.get_backend() != "nccl":
            dist.all_reduce(out)
        else:
            dev = out.to(torch.device("cuda", torch.cuda.current_device()))
            _devstats.note_transfer(_nbytes(out), "h2d")
            dist.all_reduce(dev)
            _devstats.note_transfer(_nbytes(out), "d2h")
            out.copy_(dev)
    return out


def process_reduce_scatter(arr: np.ndarray, mesh, axis: str) -> np.ndarray:
    """The sum of the host arrays of the ranks of ``axis``'s group (same
    shape and dtype on each), this rank's slice of dim 0 by its index
    along ``axis``: one reduce_scatter (the reference's ReduceScatter,
    src/net/allreduce_engine.cpp:39-53), on the host for gloo, through
    the card for nccl. A group of one: a copy. Called collectively."""
    arr = np.asarray(arr)
    group = mesh.group(axis)
    n = mesh.axis_size(axis)
    if group is None:
        return arr.copy()
    if arr.shape[0] % n:
        raise ValueError(f"dim 0 of {arr.shape} not divisible by {n} ranks")
    t = _group_tensor(arr, group).reshape(-1)
    out = torch.empty((t.numel() // n,), dtype=t.dtype, device=t.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    with _devstats.collective_span("process_reduce_scatter", arr.nbytes,
                                   mesh=mesh):
        scatter(out, t, group=group)
    return _host(out, arr.nbytes // n).reshape(
        (arr.shape[0] // n,) + arr.shape[1:])


def process_all_gather(arr: np.ndarray, mesh, axis: str) -> np.ndarray:
    """The host arrays of the ranks of ``axis``'s group (same shape and
    dtype on each) concatenated on dim 0 in their index order along
    ``axis``: one all_gather, on the host for gloo, through the card for
    nccl. A group of one: a copy. Called collectively."""
    arr = np.asarray(arr)
    group = mesh.group(axis)
    n = mesh.axis_size(axis)
    if group is None:
        return arr.copy()
    t = _group_tensor(arr, group).reshape(-1)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with _devstats.collective_span("process_all_gather", arr.nbytes * n,
                                   mesh=mesh):
        gather(out, t, group=group)
    return _host(out, arr.nbytes * n).reshape(
        (n * arr.shape[0],) + arr.shape[1:])


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` stacked in rank order, ``(world,
    *arr.shape)``, on every process (``multihost_utils.process_allgather(
    arr, tiled=False)``). A world of one: ``arr[None]``. Called
    collectively, every process with the same shape and dtype."""
    arr = np.asarray(arr)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr[None].copy()
    world = dist.get_world_size()
    t = _group_tensor(arr).reshape(-1)
    out = torch.empty((world * t.numel(),), dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    with _devstats.collective_span("process_allgather",
                                   arr.nbytes * world, mesh={"proc": world}):
        gather(out, t)
    return _host(out, arr.nbytes * world).reshape((world,) + arr.shape)
