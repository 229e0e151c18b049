"""Named device meshes over a ``torch.distributed`` world, one rank a
process.

The JAX package runs one controller over a ``jax.sharding.Mesh``: global
arrays, GSPMD, ``shard_map``. The port is SPMD per process, as PyTorch
is: every rank is one process of a ``torch.distributed`` world, holds its
own shard of the parameters and activations, and the collectives are
placed in the code by hand where GSPMD would have inserted them.

:class:`Mesh` is a thin type over a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions. Each
axis names the process group that a JAX mesh axis names
(:meth:`Mesh.group`); a set of axes names the group of their product
(the data-parallel group of a ``(dp, sp, tp)`` mesh is ``("dp", "sp")``).
The groups of every set of axes are made when the mesh is built, on every
rank in the same order, since ``new_group`` is collective over the world.
The DeviceMesh is built with device type ``cpu``: it only names the
groups, and the port's collectives address the tensors' devices
themselves (two ranks may share one card, which a ``cuda`` DeviceMesh
would refuse to set up).

A world of one needs no process group: ``Mesh({"mv": 1})`` is the
one-rank mesh the Zoo makes when ``init()`` is given none, and every
collective over it is the identity.

:func:`init_world` joins a process to its world (``nccl`` when every rank
has its own card, ``gloo`` otherwise: NCCL refuses two ranks on one card),
and :func:`spawn` starts a world's ranks with ``torch.multiprocessing``'s
spawn method (never fork: a parent that has touched CUDA cannot fork
ranks that use it). They meet through a ``FileStore`` in a temporary
directory, the store of the collectives' own process group.
:func:`net_join` (behind ``api.net_init`` and a launcher's world joined
by ``init()``) meets through a ``TCPStore`` that rank 0 hosts instead,
needs no shared directory, and keeps the store for the async PS's
rendezvous (:func:`world_store`).
"""

from __future__ import annotations

import datetime
import itertools
import os
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional, \
    Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

ShapeLike = Union[Dict[str, int], Sequence[Tuple[str, int]]]


class P(tuple):
    """A partition spec: one entry per leading dimension of an array, each
    a mesh axis name, a tuple of axis names, or ``None`` (replicated). The
    port's counterpart of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """Named axes over the ranks of the world (row-major: the last axis
    varies fastest over consecutive ranks, as in a JAX mesh built by
    reshaping ``jax.devices()``)."""

    def __init__(self, shape: ShapeLike, device: Any = None):
        items = list(shape.items()) if isinstance(shape, dict) else \
            [tuple(s) for s in shape]
        if not items:
            raise ValueError("a mesh needs at least one axis")
        self.axis_names: Tuple[str, ...] = tuple(n for n, _ in items)
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis names {self.axis_names}")
        sizes = tuple(int(s) for _, s in items)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {self.shape} holds {int(np.prod(sizes))} "
                             f"ranks but the world has {world}")
        self.size = world
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # the ranks laid out on the axes (mesh_label reads its shape)
        self.devices = np.arange(world).reshape(sizes)
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self._coord = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   self.rank, sizes))))
        self.device_mesh = None
        # frozenset of axes -> (group or None, ranks of my group in order)
        self._groups: Dict[frozenset, Tuple[Any, List[int]]] = {}
        if world > 1:
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(
                "cpu", torch.as_tensor(self.devices),
                mesh_dim_names=self.axis_names)
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                self._make_groups(axes)

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        key = frozenset(axes)
        mine = self._ranks_of(axes, self._coord)
        if self.size == 1 or len(mine) == 1:
            self._groups[key] = (None, mine)
            return
        if len(axes) == len(self.axis_names):
            self._groups[key] = (dist.group.WORLD, mine)
            return
        if len(axes) == 1:
            self._groups[key] = (self.device_mesh.get_group(axes[0]), mine)
            return
        # every rank builds every group of this set of axes, in one order
        others = [a for a in self.axis_names if a not in axes]
        group = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            ranks = self._ranks_of(axes, dict(zip(others, fixed)))
            g = dist.new_group(ranks)
            if ranks == mine:
                group = g
        self._groups[key] = (group, mine)

    def _ranks_of(self, axes: Sequence[str], fixed: Dict[str, int]
                  ) -> List[int]:
        """The ranks whose coordinates on the axes outside ``axes`` are
        ``fixed``'s, in row-major order over ``axes``."""
        idx = tuple(slice(None) if a in axes else fixed[a]
                    for a in self.axis_names)
        return [int(r) for r in self.devices[idx].reshape(-1)]

    # ------------------------------------------------------------------ #
    def _key(self, axes) -> frozenset:
        if axes is None:
            return frozenset(self.axis_names)
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no {a!r} axis: "
                                 f"{self.axis_names}")
        return frozenset(axes)

    def group(self, axes=None):
        """The process group of ``axes`` (a name or a tuple of names;
        ``None`` = every axis) holding this rank; ``None`` when that group
        is this rank alone."""
        return self._groups[self._key(axes)][0]

    def group_ranks(self, axes=None) -> List[int]:
        """The world ranks of this rank's group over ``axes``, in the
        order of their index along it."""
        return list(self._groups[self._key(axes)][1])

    def axis_size(self, axes=None) -> int:
        return len(self._groups[self._key(axes)][1])

    def index(self, axes=None) -> int:
        """This rank's index along ``axes`` (row-major over several)."""
        return self.group_ranks(axes).index(self.rank)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def one_rank_mesh(axes, device: Any) -> Mesh:
    """The mesh of a world of one over ``axes`` (a name or names, each of
    size 1): the Zoo's default without a mesh, and a model's mesh when it
    is built with none. It needs no process group."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    m = Mesh.__new__(Mesh)
    m.axis_names = axes
    m.shape = {a: 1 for a in axes}
    m.size, m.rank = 1, 0
    m.devices = np.zeros((1,) * len(axes), np.int64)
    m.device = torch.device(device) if device is not None else \
        torch.device("cpu")
    m._coord = {a: 0 for a in axes}
    m.device_mesh = None
    m._groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            m._groups[frozenset(sub)] = (None, [0])
    return m


def world_mesh(axis: str, device: Any) -> Mesh:
    """One axis named ``axis`` over every rank of the world, in rank
    order (the JAX package's default mesh over every device of every
    process); the one-rank mesh for a world of one. Collective: every
    rank builds it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1:
        return one_rank_mesh(axis, device)
    return Mesh({axis: world}, device=device)


# ---------------------------------------------------------------------- #
# worlds
# ---------------------------------------------------------------------- #
def rank_device(device: Any, rank: int, world: int) -> torch.device:
    """Where a rank computes: ``cuda`` means ``cuda:rank`` when the world
    has a card per rank, else ``cuda:0`` for every rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        dev = torch.device("cuda", rank if world <= n else 0)
    return dev


def backend_for(device: Any, world: int) -> str:
    """``nccl`` when every rank of the world has its own card, ``gloo``
    otherwise (the CPU, or several ranks on one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_nccl_available() \
            and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join(store, rank: int, world: int, device: Any, local_rank: int,
          local_world: int, timeout_s: Optional[float]) -> torch.device:
    """``init_process_group`` over ``store`` with the backend
    :func:`backend_for` picks for the ranks of this host; returns the
    rank's device (made current when it is a card)."""
    dev = rank_device(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend_for(device, local_world), store=store,
                            rank=rank, world_size=world, **kw)
    return dev


def world_device(device: Any = None) -> Any:
    """``device`` for the ranks of a world: ``None`` means the card, as
    ``init()`` resolves it (``RuntimeError`` without CUDA, unless the
    ``device`` flag names the CPU); each rank's own card is then picked
    by :func:`rank_device`."""
    if device is not None:
        return device
    from multiverso_tpu_torch.zoo import resolve_device
    dev = resolve_device(None)
    return "cuda" if dev.type == "cuda" else dev


def init_world(rank: int, world: int, store_path: str,
               device: Any = None) -> torch.device:
    """Join this process to a world of ``world`` ranks on one host that
    meet in the ``FileStore`` at ``store_path``; returns the rank's
    device (``device=None``: the card, see :func:`world_device`)."""
    device = world_device(device)
    store = dist.FileStore(store_path, world)
    return _join(store, rank, world, device, rank, world, None)


_net_store: Optional[Any] = None   # the TCPStore of net_join's world


def net_join(address: str, world: int, rank: int, device: Any,
             local_rank: Optional[int] = None,
             local_world: Optional[int] = None,
             timeout_s: float = 600.0) -> torch.device:
    """Join a world of ``world`` ranks that meet through a ``TCPStore``
    at ``address`` (``host:port``; rank 0 hosts it there, the others
    connect) and keep the store for :func:`world_store`. ``local_rank``
    and ``local_world`` place the rank on its host's cards (a launcher's
    ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``; default: one host). Every
    collective of the world, the store's connect and the group's, gives
    up after ``timeout_s``; returns the rank's device."""
    global _net_store
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         "host:port")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=(rank == 0),
                          timeout=timeout)
    dev = _join(store, rank, world, device,
                rank if local_rank is None else local_rank,
                world if local_world is None else local_world, timeout_s)
    _net_store = store
    return dev


def world_store():
    """The key-value store of this process's world: the ``TCPStore`` of
    :func:`net_join`, else the default process group's own store (a
    world joined another way, e.g. ``init_method="env://"``), else
    ``None`` (no world)."""
    if _net_store is not None and dist.is_initialized():
        return _net_store
    if not dist.is_initialized():
        return None
    from torch.distributed import distributed_c10d as c10d
    get = getattr(c10d, "_get_default_store", None)
    return get() if get is not None else None


def leave_world() -> None:
    global _net_store
    if dist.is_initialized():
        dist.destroy_process_group()
    _net_store = None


def _rank_main(rank: int, world: int, store_path: str, device: Any,
               fn: Callable, args: tuple, results) -> None:
    try:
        if torch.device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = init_world(rank, world, store_path, device)
        out = fn(rank, world, dev, *args)
        results.put((rank, "ok", out))
    except BaseException as e:   # noqa: BLE001 — reported to the parent
        import traceback
        results.put((rank, "error", f"{type(e).__name__}: {e}\n"
                     + traceback.format_exc()))
        raise
    finally:
        leave_world()


def spawn(fn: Callable, world: int, device: Any = None, args: tuple = (),
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` on ``world`` spawned ranks
    and return their results in rank order (``device=None``: the card,
    and ``RuntimeError`` here, before any rank starts, without one; pass
    ``device="cpu"`` for the CPU). ``fn`` must be importable by name (a
    module-level function). A rank that raises fails the call with its
    traceback; every rank is joined or killed before it returns."""
    import queue as _queue

    device = world_device(device)

    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mv_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store, device, fn, args,
                                   results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        errors = []
        try:
            while len(out) + len(errors) < world:
                try:
                    rank, status, val = results.get(timeout=timeout)
                except _queue.Empty:
                    raise TimeoutError(
                        f"{world - len(out)} ranks gave no result in "
                        f"{timeout} s") from None
                if status == "ok":
                    out[rank] = val
                else:
                    errors.append(f"rank {rank}: {val}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30 if not errors else 2)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        bad = [p.exitcode for p in procs if p.exitcode not in (0, None)]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(world)]


def iter_axes(axes) -> Iterable[str]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)
