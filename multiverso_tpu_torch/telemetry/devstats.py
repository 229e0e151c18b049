"""Device-plane observability: host<->device transfers, collective spans
and the per-device census (port of ``multiverso_tpu/telemetry/
devstats.py``).

* **Transfer chokepoint** — :func:`note_transfer` counts host<->device
  bytes per direction (``h2d``/``d2h``). The word-embedding and DLRM
  pipelines report here, ``parallel/tp.shard_params`` uploads and every
  collective staged through host buffers (``parallel/collectives.py``)
  count their copies, and the ``h2d`` side feeds the step profiler's
  per-step ``transfer_bytes`` delta.
* **Collective spans** — :func:`collective_span` wraps every collective
  dispatch of ``parallel/``: op/bytes/duration land as Dashboard monitors
  (``coll[op]`` timed + ``.calls``/``.bytes`` counters in the zoo
  shutdown report), flight-recorder ``coll.begin``/``coll.end`` events, a
  step-profiler async span (``attach="any"``), and this module's per-op
  tally in the ``"devices"`` block's ``collectives``, in the JAX
  package's formats. A span's duration is the host's wall time of the
  call: the port's collectives return when their data has arrived (gloo
  is synchronous; an NCCL call returns when it is queued on the stream).
* **Mesh labels** — :func:`mesh_label` names a mesh by its axes
  (``"{'tp': 2}"``); :func:`mesh_scope` and :func:`set_default_mesh`
  (the Zoo's mesh, at start) keep the label a span runs under.
* **Per-device census** — :func:`device_rollup` reads, for every CUDA
  device, ``torch.cuda.memory_allocated`` (``bytes``) and the caching
  allocator's live block count (``arrays``), where the JAX package
  groups ``jax.live_arrays()`` by device. It rides MSG_STATS as the
  ``"devices"`` block's ``per_device`` and the exporter emits it as
  ``mv_dev_live_*`` gauges.

The block keeps the JAX package's keys, so its readers take either
package's payload. ``compiles_by_mesh`` is always empty here: it counts
XLA compiles keyed by the mesh that triggered them, and the port runs
eagerly, with no compile to count (its native libraries, built at first
use, count as the step records' compiles in ``telemetry/profiler.py``).
For the same reason the JAX package's SPMD compile-hygiene capture has
no counterpart.

Cost: the ``devstats`` flag (default on) gates every recording site
behind one attribute read; a counter is one int add under a lock at a
per-batch site; the census runs only on a stats pull.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

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

# spans with no mesh scope active key under this label
_NO_MESH = "unmeshed"


def mesh_label(mesh: Any) -> str:
    """Canonical label for a mesh configuration: ``"{'mv': 4}"`` for a
    ``parallel.mesh.Mesh`` (its ``axis_names`` and the shape of its
    ``devices``); dicts and strings pass through."""
    if mesh is None:
        return _NO_MESH
    if isinstance(mesh, str):
        return mesh
    if isinstance(mesh, dict):
        return str(dict(mesh))
    names = getattr(mesh, "axis_names", None)
    devs = getattr(mesh, "devices", None)
    if names is not None and devs is not None:
        return str(dict(zip(names, devs.shape)))
    return str(mesh)


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


class _NullCtx:
    """Shared no-op context: the flag-off path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _MeshScope:
    __slots__ = ("_ds", "_label")

    def __init__(self, ds: "DevStats", label: str):
        self._ds = ds
        self._label = label

    def __enter__(self):
        stack = getattr(self._ds._tls, "mesh_stack", None)
        if stack is None:
            stack = self._ds._tls.mesh_stack = []
        stack.append(self._label)
        return self._label

    def __exit__(self, *exc):
        try:
            self._ds._tls.mesh_stack.pop()
        except (AttributeError, IndexError):
            pass
        return False


class _CollSpan:
    """One collective op's span: Dashboard + flightrec + profiler + the
    per-op tally, under its mesh's scope."""

    __slots__ = ("_ds", "_op", "_nbytes", "_scope", "_t0")

    def __init__(self, ds: "DevStats", op: str, nbytes: int,
                 label: Optional[str]):
        self._ds = ds
        self._op = op
        self._nbytes = int(nbytes)
        self._scope = (_MeshScope(ds, label) if label is not None
                       else None)

    def __enter__(self):
        from multiverso_tpu_torch.telemetry import flightrec as _flight
        if self._scope is not None:
            self._scope.__enter__()
        self._t0 = time.time()
        _flight.record(_flight.EV_COLL_BEGIN, nbytes=self._nbytes,
                       note=f"coll.{self._op}")
        return self

    def __exit__(self, *exc):
        from multiverso_tpu_torch.telemetry import flightrec as _flight
        from multiverso_tpu_torch.telemetry import profiler as _profiler
        from multiverso_tpu_torch.utils.dashboard import Dashboard
        t1 = time.time()
        if self._scope is not None:
            self._scope.__exit__()
        ms = (t1 - self._t0) * 1e3
        with self._ds._lock:
            d = self._ds._coll.setdefault(
                self._op, {"calls": 0, "bytes": 0, "ms": 0.0})
            d["calls"] += 1
            d["bytes"] += self._nbytes
            d["ms"] = round(d["ms"] + ms, 4)
        Dashboard.get(f"coll[{self._op}]").observe_ms(ms)
        Dashboard.get(f"coll[{self._op}].calls").incr()
        Dashboard.get(f"coll[{self._op}].bytes").incr(self._nbytes)
        _flight.record(_flight.EV_COLL_END, nbytes=self._nbytes,
                       note=f"coll.{self._op}")
        # attach to whatever step is open, on any thread
        _profiler.note_async(f"coll.{self._op}", self._t0, t1,
                             attach="any")
        return False


class DevStats:
    """One per process (like the FlightRecorder/StepProfiler);
    in-process multi-rank worlds share it."""

    def __init__(self) -> None:
        self.enabled = True       # plain attribute: THE site gate
        self.rank = 0
        self._rank_pinned = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._default_mesh: Optional[str] = None
        # direction -> [ops, bytes]
        self._transfers: Dict[str, List[int]] = {
            d: [0, 0] for d in _DIRECTIONS}
        # op -> {"calls", "bytes", "ms"}
        self._coll: Dict[str, Dict[str, Any]] = {}

    def configure(self, rank: Optional[int] = None) -> None:
        """Adopt the ``devstats`` flag (PSService init / Zoo.start);
        idempotent, first caller's rank sticks."""
        if rank is not None and not self._rank_pinned:
            self.rank = int(rank)
            self._rank_pinned = True
        self.enabled = bool(config.get_flag("devstats"))

    def _mesh_label(self) -> str:
        stack = getattr(self._tls, "mesh_stack", None)
        if stack:
            return stack[-1]
        return self._default_mesh or _NO_MESH

    def mesh_scope(self, mesh: Any):
        """Run the spans opened inside this scope (on this thread) under
        ``mesh``'s label. Collective spans push one themselves."""
        if not self.enabled:
            return _NULL
        return _MeshScope(self, mesh_label(mesh))

    def set_default_mesh(self, mesh: Any) -> None:
        """Process-default mesh label (Zoo.start's mesh)."""
        self._default_mesh = mesh_label(mesh) if mesh is not None else None

    def collective_span(self, op: str, nbytes: int, mesh: Any = None):
        """Span context for one collective call (see the module
        docstring). No-op (shared context, no allocation) when the
        ``devstats`` flag is off."""
        if not self.enabled:
            return _NULL
        return _CollSpan(self, op, nbytes,
                         mesh_label(mesh) if mesh is not None else None)

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
        counters, per-op collective tallies and the per-device census
        (``compiles_by_mesh`` empty: see the module docstring). None when
        the flag is off and when there is nothing to report."""
        if not self.enabled:
            return None
        with self._lock:
            transfers = {d: {"ops": g[0], "bytes": g[1]}
                         for d, g in self._transfers.items() if g[0]}
            colls = {op: dict(d) for op, d in self._coll.items()}
        per_device = device_rollup()
        if not (transfers or colls or per_device):
            return None
        out: Dict = {"transfers": transfers, "collectives": colls,
                     "compiles_by_mesh": {}}
        if per_device:
            out["per_device"] = per_device
        return out

    def reset(self) -> None:
        """Test isolation: drop counters and unpin."""
        with self._lock:
            self._transfers = {d: [0, 0] for d in _DIRECTIONS}
            self._coll.clear()
            self._rank_pinned = False
            self.rank = 0
            self._default_mesh = None
        self._tls = threading.local()
        self.enabled = True


DEVSTATS = DevStats()


# module-level wrappers (the call-site idiom, like telemetry.profiler)
def enabled() -> bool:
    return DEVSTATS.enabled


def configure(rank: Optional[int] = None) -> None:
    DEVSTATS.configure(rank)


def note_transfer(nbytes: int, direction: str = "h2d") -> None:
    DEVSTATS.note_transfer(nbytes, direction)


def collective_span(op: str, nbytes: int, mesh: Any = None):
    return DEVSTATS.collective_span(op, nbytes, mesh=mesh)


def mesh_scope(mesh: Any):
    return DEVSTATS.mesh_scope(mesh)


def set_default_mesh(mesh: Any) -> None:
    DEVSTATS.set_default_mesh(mesh)


def collectives() -> Dict[str, Dict[str, Any]]:
    """The per-op tally ``{op: {"calls", "bytes", "ms"}}`` (a copy)."""
    with DEVSTATS._lock:
        return {op: dict(d) for op, d in DEVSTATS._coll.items()}


def stats_snapshot() -> Optional[Dict]:
    return DEVSTATS.stats_snapshot()


def reset() -> None:
    DEVSTATS.reset()
