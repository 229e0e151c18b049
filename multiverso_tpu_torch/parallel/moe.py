"""Expert parallelism: a mixture-of-experts layer over a mesh axis (port of
``multiverso_tpu/parallel/moe.py``).

Experts are sharded over the ``ep`` axis (each rank owns ``num_experts /
ep`` expert MLPs, the router is replicated); tokens travel to their
experts and back with one ``all_to_all`` each way
(``parallel/collectives.all_to_all``, whose backward is the inverse
all_to_all).

* **Static capacity** from this rank's tokens: each rank sends exactly
  ``capacity`` tokens to each expert (truncate and pad); a dropped token
  falls back to the residual path with zero output.
* **Top-1 (switch) or top-k (GShard) routing**, k-major priority (every
  token's 1st choice wins the capacity race against any 2nd choice), plus
  the load-balance auxiliary loss.
* Expert compute is one batched einsum over the local experts.

Gradients: the router is a replicated weight used on this rank's tokens,
so its gradient is all-reduced over ``ep`` (``collectives.copy_to``); the
aux loss is the mean over the ``ep`` group of the ranks' losses (one
logical value, ``collectives.reduce_from``), and over ``batch_axis`` its
gradient passes to this rank unchanged (``collectives.mean_over``: the
train steps average the data-parallel gradients). Returned values equal
the JAX function's, which ``pmean``s both scalars over the two axes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.parallel.mesh import P
from multiverso_tpu_torch.parallel.tp import shard_params
from multiverso_tpu_torch.telemetry import devstats as _devstats
from multiverso_tpu_torch.zoo import Zoo


class MoEConfig(NamedTuple):
    num_experts: int
    dim: int
    hidden: int
    capacity_factor: float = 1.25
    axis: str = "ep"
    top_k: int = 1


def init_experts(cfg: MoEConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """[E, ...]-stacked expert MLPs and the router as a float32 numpy
    tree: the JAX ``init_experts`` draws (the same numpy generator calls
    in the same order). Shard with :func:`shard_experts`."""
    rng = np.random.default_rng(seed)
    e, d, h = cfg.num_experts, cfg.dim, cfg.hidden

    def mk(*s, scale):
        return np.asarray(rng.normal(0, scale, s), np.float32)

    return {
        "w1": mk(e, d, h, scale=1 / np.sqrt(d)),
        "w2": mk(e, h, d, scale=1 / np.sqrt(h)),
        "router": mk(d, e, scale=1 / np.sqrt(d)),
    }


def expert_rules(cfg: MoEConfig) -> Dict[str, P]:
    return {"w1": P(cfg.axis), "w2": P(cfg.axis), "router": P()}


def shard_experts(params: Dict, cfg: MoEConfig, mesh=None,
                  dtype: Optional[torch.dtype] = None) -> Dict:
    """This rank's experts (w1/w2 split on E over ``cfg.axis``) and the
    replicated router, as tensors on the mesh's device."""
    return shard_params(params, expert_rules(cfg), mesh, dtype)


def top_k_gates(probs: torch.Tensor, kk: int):
    """Top-k expert choice with the gating convention shared by training
    and decode: the raw top probability for k=1 (switch), the top-k
    renormalized for k>1 (GShard). Ties go to the lower index, as
    ``jax.lax.top_k``. Returns (gates [T, K], topi [T, K])."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :kk], idx[..., :kk]
    gates = topv if kk == 1 else topv / topv.sum(-1, keepdim=True)
    return gates, topi


def _route(probs: torch.Tensor, kk: int, capacity: int):
    """Priority routing over the [T, E] probabilities, assignments
    flattened k-major. Returns (expert, gate, pos, keep, onehot), each
    over the K*T assignments."""
    t, e = probs.shape
    gates, topi = top_k_gates(probs, kk)                   # [T, K]
    expert = topi.t().reshape(-1)                          # [K*T]
    gate = gates.t().reshape(-1)
    onehot = F.one_hot(expert, e).to(torch.int32)          # [K*T, E]
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1   # slot per expert
    keep = pos < capacity
    return expert, gate, pos, keep, onehot


def _local_moe(x, w1, w2, router, cfg: MoEConfig, capacity: int, mesh,
               batch_axis: Optional[str] = None):
    """Per-rank body. x: [T_local, D]; w1/w2: local experts [E_local, ...];
    router: the replicated [D, E]."""
    ax = cfg.axis
    n = mesh.axis_size(ax)
    e = cfg.num_experts
    e_local = e // n
    t, d = x.shape
    kk = cfg.top_k

    logits = x @ coll.copy_to(router, mesh, ax)            # [T, E]
    probs = torch.softmax(logits.float(), -1)
    expert, gate, pos, keep, onehot = _route(probs, kk, capacity)

    # dispatch buffer [E, capacity (+1 overflow row), D]
    x_rep = x.repeat(kk, 1)                                # [K*T, D]
    slot = torch.where(keep, pos, torch.full_like(pos, capacity)).long()
    dispatch = torch.zeros((e, capacity + 1, d), dtype=x.dtype,
                           device=x.device)
    dispatch = dispatch.index_put((expert, slot), x_rep, accumulate=True)
    dispatch = dispatch[:, :capacity].reshape(n, e_local, capacity, d)
    # [n (destination), E_local, C, D] -> [n (source), E_local, C, D]
    recv = coll.all_to_all(dispatch, mesh, ax, split_dim=0, concat_dim=0)

    # expert compute, batched over the local experts: [E_local, n*C, D]
    xin = recv.transpose(0, 1).reshape(e_local, n * capacity, d)
    h = F.gelu(torch.einsum("ecd,edh->ech", xin, w1), approximate="tanh")
    out = torch.einsum("ech,ehd->ecd", h, w2)              # [E_local, n*C, D]

    back = out.reshape(e_local, n, capacity, d).transpose(0, 1)
    combined = coll.all_to_all(back.contiguous(), mesh, ax, split_dim=0,
                               concat_dim=0)
    combined = combined.reshape(e, capacity, d)            # [E, C, D]

    # each surviving assignment's expert output (dropped -> 0), a token's
    # k contributions summed (k-major flatten)
    y = combined[expert, torch.clamp(pos, max=capacity - 1).long()]
    y = torch.where(keep[:, None], y, torch.zeros_like(y)) \
        * gate[:, None].to(x.dtype)
    y = y.reshape(kk, t, d).sum(0)                         # [T, D]

    # load-balance aux loss (switch for k=1, GShard-normalized for k>1)
    me = probs.mean(0)                                     # [E]
    ce = onehot.float().reshape(kk, t, e).sum(0).mean(0) / kk
    aux = e * torch.sum(me * ce)
    aux = coll.reduce_from(aux, mesh, ax) / n
    if batch_axis is not None:
        aux = coll.mean_over(aux, mesh, batch_axis)
    # dropped = tokens whose EVERY assignment overflowed
    token_dropped = 1.0 - keep.reshape(kk, t).any(0).float()
    axes = (ax,) if batch_axis is None else (ax, batch_axis)
    frac = coll.raw_all_reduce(token_dropped.mean(), mesh, axes) \
        / mesh.axis_size(axes)
    return y, aux, frac


def capacity_of(cfg: MoEConfig, local_tokens: int) -> int:
    """Static capacity per expert from this rank's token count."""
    return max(1, int(cfg.capacity_factor * local_tokens * cfg.top_k
                      / cfg.num_experts))


def moe_layer(x: torch.Tensor, params: Dict, cfg: MoEConfig, mesh=None,
              batch_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply the expert-parallel MoE to this rank's tokens [B_l, T_l, D]
    (T sharded over ``cfg.axis``, B over ``batch_axis``) with this rank's
    experts (:func:`shard_experts`). Returns (output [B_l, T_l, D], aux
    loss, dropped fraction: the share of tokens whose every routed choice
    overflowed capacity), the scalars replicated."""
    mesh = mesh or Zoo.get().mesh()
    n = mesh.axis_size(cfg.axis)
    if cfg.num_experts % n:
        raise ValueError(
            f"{cfg.num_experts} experts not divisible by {n} shards")
    if params["w1"].shape[0] * n != cfg.num_experts:
        raise ValueError(f"w1 holds {params['w1'].shape[0]} experts, not "
                         f"this rank's {cfg.num_experts // n}")
    if not 1 <= cfg.top_k <= cfg.num_experts:
        raise ValueError(f"top_k={cfg.top_k} out of range for "
                         f"{cfg.num_experts} experts")
    b, t, d = x.shape
    capacity = capacity_of(cfg, b * t)
    with _devstats.collective_span("moe_layer",
                                   x.numel() * x.element_size(), mesh=mesh):
        y, aux, dropped = _local_moe(x.reshape(-1, d), params["w1"],
                                     params["w2"], params["router"], cfg,
                                     capacity, mesh, batch_axis)
    return y.reshape(x.shape), aux, dropped
