"""Pipeline parallelism: a GPipe-style microbatch ring over a mesh axis
(port of ``multiverso_tpu/parallel/pipeline.py``).

Stage s of a stack of identical blocks lives on rank s of the ``pp``
axis; microbatches enter at stage 0 and activations hop stage to stage
(``collectives.ppermute``, whose backward sends the gradients back the
other way). The schedule is the JAX one, tick for tick: over
``n_micro + n_stages - 1`` ticks every stage ingests (stage 0 a new
microbatch), applies ``stage_fn``, emits (the last stage, once the fill
ends) and rotates; the last stage's outputs are then summed over the axis
so every stage holds them (``collectives.reduce_from``). Every rank runs
every tick, the bubble's ticks on zeros whose results are masked away, so
each rank's autograd graph has the same collectives in the same order
and the backward drains the pipeline in the transposed schedule with no
hand-written reverse pass.

The input is a value replicated over the axis that only stage 0 reads
(``collectives.copy_to``: its gradient is summed over the stages), and
``batch_axis`` shards the batch as in JAX (the input and output are this
rank's batch shard). ``param_specs`` names extra axes the stage weights
are sharded on (tensor parallelism inside a stage): ``stage_fn`` then gets
this rank's blocks and places its own collectives.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.parallel.mesh import P
from multiverso_tpu_torch.parallel.tp import leaves, shard_params
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.zoo import Zoo


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_stages(stacked_params: Any, axis: str = "pp", mesh=None,
                 dtype: Optional[torch.dtype] = None) -> Any:
    """This rank's stage of a [n_stages, ...]-stacked numpy tree: leaves
    [1, ...] on the mesh's device."""
    mesh = mesh or Zoo.get().mesh()
    rules = _tree_map(lambda _: P(axis), stacked_params)
    return shard_params(stacked_params, rules, mesh, dtype)


def _check_param_specs(param_specs: Any, axis: str) -> None:
    """Every stage-weight spec must lead with the pipeline axis."""
    if param_specs is None:
        return
    for path, spec in leaves(param_specs):
        if not spec or spec[0] != axis:
            raise ValueError(
                f"param_specs leaf {'.'.join(path)} must lead with the "
                f"pipeline axis {axis!r}, got {spec}")


def _mask(x: torch.Tensor, keep: bool) -> torch.Tensor:
    # multiply, not branch: every rank's graph keeps the same shape
    return x * (1.0 if keep else 0.0)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, n_micro: int,
                   axis: str = "pp", mesh=None,
                   batch_axis: Optional[str] = None,
                   param_specs: Any = None) -> torch.Tensor:
    """Run ``x`` [B, ...] (this rank's batch shard when ``batch_axis`` is
    set) through ``n_stages`` pipelined applications of ``stage_fn``,
    split into ``n_micro`` microbatches. ``stage_params`` leaves are this
    rank's [1, ...] stage (:func:`shard_stages`); ``stage_fn(params, act)
    -> act`` keeps the activation's shape. Returns the output on every
    stage."""
    mesh = mesh or Zoo.get().mesh()
    n_stages = mesh.axis_size(axis)
    for path, leaf in leaves(stage_params):
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stage_params leaf {'.'.join(path)} has leading dim "
                f"{leaf.shape[0]}, expected this rank's one stage of "
                f"n_stages={n_stages} (mesh axis {axis!r}); fold extra "
                "layers into stage_fn")
    _check_param_specs(param_specs, axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    mb = b // n_micro
    params = _tree_map(lambda p: p[0], stage_params)
    idx = mesh.index(axis)
    last = n_stages - 1
    fwd = coll.ring_perm(n_stages)
    with _devstats.collective_span("pipeline_apply",
                                   x.numel() * x.element_size(), mesh=mesh):
        xs = coll.copy_to(x, mesh, axis).reshape((n_micro, mb)
                                                 + x.shape[1:])
        act = torch.zeros_like(xs[0])
        outs = [None] * n_micro
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t while it exists; the others
            # keep the activation that just arrived on the ring
            inp = xs[min(t, n_micro - 1)]
            act = _mask(inp, idx == 0) + _mask(act, idx != 0)
            act = stage_fn(params, act)
            # the last stage emits microbatch t - (n-1) once the fill ends
            slot = min(max(t - last, 0), n_micro - 1)
            emit = _mask(act, idx == last and t >= last)
            outs[slot] = emit if outs[slot] is None else outs[slot] + emit
            act = coll.ppermute(act, mesh, axis, fwd)
        out = coll.reduce_from(torch.stack(outs), mesh, axis)
    return out.reshape((b,) + x.shape[1:])


def shard_stages_interleaved(stacked_params: Any, n_stages: int,
                             axis: str = "pp", mesh=None,
                             dtype: Optional[torch.dtype] = None) -> Any:
    """Regroup a [n_total, ...] numpy stage stack for the interleaved
    schedule (global stage g runs as chunk g // n_stages on rank
    g % n_stages: [n_stages, n_chunks, ...]) and return this rank's
    [1, n_chunks, ...] block."""
    def regroup(p):
        if p.shape[0] % n_stages:
            raise ValueError(f"stage count {p.shape[0]} not divisible by "
                             f"n_stages={n_stages}")
        v = p.shape[0] // n_stages
        return p.reshape((v, n_stages) + p.shape[1:]).swapaxes(0, 1)

    return shard_stages(_tree_map(regroup, stacked_params), axis, mesh,
                        dtype)


def pipeline_apply_interleaved(stage_fn: Callable[[Any, torch.Tensor],
                                                  torch.Tensor],
                               stage_params: Any, x: torch.Tensor,
                               axis: str = "pp", mesh=None,
                               batch_axis: Optional[str] = None,
                               param_specs: Any = None) -> torch.Tensor:
    """Interleaved (virtual-chunk) pipeline: each rank holds ``n_chunks``
    non-contiguous stages and an activation circles the ring ``n_chunks``
    times; the bubble shrinks from (S-1)/(S-1+M) to (S-1)/(S-1+M*V) for a
    fixed microbatch count of ``n_stages``. ``stage_params`` leaves are
    this rank's [1, n_chunks, ...] block
    (:func:`shard_stages_interleaved`); ``stage_fn(chunk_params, act)``
    applies one chunk."""
    mesh = mesh or Zoo.get().mesh()
    n_stages = mesh.axis_size(axis)
    lv = list(leaves(stage_params))
    n_chunks = lv[0][1].shape[1] if lv else 1
    for path, leaf in lv:
        if leaf.shape[0] != 1 or leaf.shape[1] != n_chunks:
            raise ValueError(
                f"stage_params leaf {'.'.join(path)} has leading dims "
                f"{tuple(leaf.shape[:2])}, expected (1, {n_chunks})")
    _check_param_specs(param_specs, axis)
    b = x.shape[0]
    if b % n_stages:
        raise ValueError(f"batch {b} not divisible by the interleaved "
                         f"schedule's fixed n_micro={n_stages}")
    S, V = n_stages, n_chunks
    mb = b // S
    params = _tree_map(lambda p: p[0], stage_params)
    idx = mesh.index(axis)
    fwd = coll.ring_perm(S)
    with _devstats.collective_span("pipeline_apply_interleaved",
                                   x.numel() * x.element_size(), mesh=mesh):
        xs = coll.copy_to(x, mesh, axis).reshape((S, mb) + x.shape[1:])
        act = torch.zeros_like(xs[0])
        outs = [None] * S
        for t in range(S * V + S - 1):
            u = t - idx                      # ticks since this rank's first
            v = min(max(u // S, 0), V - 1)   # chunk this rank runs now
            # rank 0 ingests microbatch t during the first S ticks; later
            # it continues chunks arriving back around the ring
            inp = xs[min(max(t, 0), S - 1)]
            ingest = idx == 0 and t < S
            act = _mask(inp, ingest) + _mask(act, not ingest)
            act = stage_fn(_tree_map(lambda q: q[v], params), act)
            # the last rank emits microbatch u - (V-1)S on its last chunk
            slot = min(max(u - (V - 1) * S, 0), S - 1)
            emit = _mask(act, idx == S - 1 and (V - 1) * S <= u < V * S)
            outs[slot] = emit if outs[slot] is None else outs[slot] + emit
            act = coll.ppermute(act, mesh, axis, fwd)
        out = coll.reduce_from(torch.stack(outs), mesh, axis)
    return out.reshape((b,) + x.shape[1:])
