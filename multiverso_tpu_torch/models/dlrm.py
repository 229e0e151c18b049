"""DLRM-style recommender: sharded embedding tables + dot-interaction MLP
(port of ``multiverso_tpu/models/dlrm.py``).

Categorical fields hit rows of one embedding table (every field's rows
concatenated, ``field_offsets``), the dense side is a small MLP, and the
second-order feature interactions are pairwise dots (the DLRM
architecture). Plain functions on tensors: the MLP parameters are a dict
of lists (``bottom_w``, ``bottom_b``, ``top_w``, ``top_b``), flattened
into one vector in the JAX tree's leaf order (``flatten_mlp``), so the
MLP side lives in one ``ArrayTable`` and the JAX package's parameters
carry across (``mlp_from_jax``).

Training shape (``make_train_step``): read the batch's rows, forward
and backward through autograd, sum the row gradients into a delta with
``index_add_`` (duplicate ids accumulate), then apply each table's
server-side updater through ``functional_add`` — gradient aggregation
followed by one updater application per step, as the JAX step does in
one jitted program. On an embedding table sharded over the world's ranks
the rows are read from their owners and the gradients pushed to them, so
no rank holds the whole table (the JAX step's partitioned gather and
scatter); the delta has the rank's block's shape.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.updaters import AddOption

# the leaf order of the JAX package's parameter tree: jax.tree.flatten
# visits a dict's keys sorted, then each list in order
_KEYS = ("bottom_b", "bottom_w", "top_b", "top_w")


class DLRMConfig(NamedTuple):
    vocab_sizes: Tuple[int, ...] = (100, 100, 100)  # rows per categorical field
    embed_dim: int = 16
    dense_dim: int = 8                  # continuous-feature width
    bottom_mlp: Tuple[int, ...] = (32, 16)  # last entry must equal embed_dim
    top_mlp: Tuple[int, ...] = (32, 1)      # last entry must be 1 (logit)
    dtype: Any = torch.float32


def field_offsets(cfg: DLRMConfig) -> np.ndarray:
    """Row offset of each field inside the single concatenated table (the
    multi-table-in-one-table layout, so ONE sharded table serves every
    field)."""
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(
        np.int32)


def total_rows(cfg: DLRMConfig) -> int:
    return int(sum(cfg.vocab_sizes))


def _mlp_shapes(cfg: DLRMConfig):
    f = len(cfg.vocab_sizes)
    n_inter = (f + 1) * f // 2          # upper-triangle pairwise dots
    bottom, top = [], []
    d_in = cfg.dense_dim
    for d_out in cfg.bottom_mlp:
        bottom.append((d_in, d_out))
        d_in = d_out
    if cfg.bottom_mlp[-1] != cfg.embed_dim:
        raise ValueError(f"bottom_mlp must end at embed_dim="
                         f"{cfg.embed_dim}, got {cfg.bottom_mlp}")
    d_in = cfg.embed_dim + n_inter
    for d_out in cfg.top_mlp:
        top.append((d_in, d_out))
        d_in = d_out
    if cfg.top_mlp[-1] != 1:
        raise ValueError(f"top_mlp must end at 1 (logit), got {cfg.top_mlp}")
    return bottom, top


def init_mlp_params(cfg: DLRMConfig, seed: int = 0,
                    device=None) -> Dict[str, List[torch.Tensor]]:
    """Glorot-normal weights and zero biases, from the JAX package's
    numpy draws (the same values for the same seed)."""
    rng = np.random.default_rng(seed)
    bottom, top = _mlp_shapes(cfg)
    device = torch.device(device if device is not None else "cpu")

    def glorot(shape):
        s = np.sqrt(2.0 / (shape[0] + shape[1]))
        return torch.as_tensor(rng.normal(0, s, shape), dtype=cfg.dtype,
                               device=device)

    return {
        "bottom_w": [glorot(s) for s in bottom],
        "bottom_b": [torch.zeros((s[1],), dtype=cfg.dtype, device=device)
                     for s in bottom],
        "top_w": [glorot(s) for s in top],
        "top_b": [torch.zeros((s[1],), dtype=cfg.dtype, device=device)
                  for s in top],
    }


def mlp_from_jax(params: Dict[str, Any], dtype=torch.float32,
                 device=None) -> Dict[str, List[torch.Tensor]]:
    """The JAX package's MLP parameters (its ``init_mlp_params`` tree, or
    any tree of arrays of that layout) as the port's tensors: the weights
    carried across."""
    device = torch.device(device if device is not None else "cpu")
    return {k: [torch.tensor(np.asarray(a), dtype=dtype, device=device)
                for a in params[k]] for k in _KEYS}


def flatten_mlp(params: Dict[str, List[torch.Tensor]]
                ) -> Tuple[np.ndarray, Any]:
    """[flat f32 vector, meta] in the JAX tree's leaf order — the MLP side
    lives in ONE ArrayTable (the reference bindings' convention)."""
    leaves = [l for k in _KEYS for l in params[k]]
    flat = np.concatenate([np.asarray(l.detach().cpu()).reshape(-1)
                           for l in leaves])
    meta = ([(k, len(params[k])) for k in _KEYS],
            [tuple(l.shape) for l in leaves],
            [int(np.prod(l.shape)) for l in leaves])
    return flat.astype(np.float32), meta


def unflatten_mlp(flat: torch.Tensor, meta) -> Dict[str, List[torch.Tensor]]:
    """The parameter dict as views into ``flat`` (a backward through them
    fills ``flat.grad`` in the flat layout)."""
    keys, shapes, sizes = meta
    leaves, off = [], 0
    for shape, size in zip(shapes, sizes):
        leaves.append(flat[off: off + size].reshape(shape))
        off += size
    out, i = {}, 0
    for k, n in keys:
        out[k] = leaves[i: i + n]
        i += n
    return out


def _mlp(x, ws, bs, final_linear=True):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if not (final_linear and i == len(ws) - 1):
            x = torch.relu(x)
    return x


def forward(mlp: Dict[str, Any], emb_rows: torch.Tensor,
            dense: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """emb_rows [B, F, D], dense [B, dense_dim] -> logits [B].

    DLRM dot interaction: the bottom-MLP output joins the F embeddings,
    and all (F+1 choose 2) pairwise dots, concatenated with the bottom
    output, feed the top MLP. The pairs are in ``np.triu_indices(F + 1,
    k=1)``'s order, as in the JAX package.
    """
    f = len(cfg.vocab_sizes)
    x = _mlp(dense, mlp["bottom_w"], mlp["bottom_b"], final_linear=False)
    z = torch.cat([x[:, None, :], emb_rows], dim=1)          # [B, F+1, D]
    dots = torch.bmm(z, z.transpose(1, 2))                   # [B, F+1, F+1]
    iu, ju = np.triu_indices(f + 1, k=1)
    inter = dots[:, torch.as_tensor(iu, device=z.device),
                 torch.as_tensor(ju, device=z.device)]       # [B, (F+1)F/2]
    top_in = torch.cat([x, inter], dim=-1)
    return _mlp(top_in, mlp["top_w"], mlp["top_b"])[:, 0]


def loss_fn(mlp: Dict[str, Any], emb_rows: torch.Tensor,
            dense: torch.Tensor, labels: torch.Tensor,
            cfg: DLRMConfig) -> torch.Tensor:
    """Mean binary cross-entropy on the click logit (f32), in the JAX
    package's stable form, with JAX's gradients at a logit of exactly 0
    (every hidden unit of the top MLP off and zero biases, common early in
    training): ``maximum`` splits the tie evenly as ``jnp.maximum`` does,
    and |x| takes slope 1 at 0 as ``jnp.abs`` does (``torch.abs`` gives
    0)."""
    logits = forward(mlp, emb_rows, dense, cfg).float()
    y = labels.float()
    abs_l = torch.where(logits >= 0, logits, -logits)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-abs_l)))


def loss_and_grads(mlp: Dict[str, Any], rows: torch.Tensor,
                   dense: torch.Tensor, labels: torch.Tensor,
                   cfg: DLRMConfig):
    """(loss, mlp gradients in the params' layout, row gradients) by
    autograd: the JAX ``value_and_grad(loss_fn, argnums=(0, 1))``."""
    leaves = [p.detach().requires_grad_() for k in _KEYS for p in mlp[k]]
    params, i = {}, 0
    for k in _KEYS:
        params[k] = leaves[i: i + len(mlp[k])]
        i += len(mlp[k])
    rows = rows.detach().requires_grad_()
    loss = loss_fn(params, rows, dense, labels, cfg)
    grads = torch.autograd.grad(loss, leaves + [rows])
    g_mlp, i = {}, 0
    for k in _KEYS:
        g_mlp[k] = list(grads[i: i + len(mlp[k])])
        i += len(mlp[k])
    return loss.detach(), g_mlp, grads[-1]


def make_train_step(cfg: DLRMConfig, emb_table, mlp_table, mlp_meta,
                    emb_opt: Optional[AddOption] = None,
                    mlp_opt: Optional[AddOption] = None,
                    mesh=None, axis=None):
    """One PS step over the tables' states.

    ``step(emb_state, mlp_state, cat_ids [B, F], dense, labels) ->
    (emb_state, mlp_state, loss)``: read the batch's rows, autograd, sum
    the row gradients into the embedding delta (duplicate ids
    accumulate), apply each table's server-side updater with
    ``functional_add``. The states' tensors update in place (the JAX step
    returns new ones); on a table's live ``state`` that commits the step.

    With ``mesh`` and a data axis ``axis`` (a name or a tuple of names)
    each rank passes its batch shard, and the gradients and the loss are
    averaged over the axis before the updaters: the global batch's step.
    Without one every rank passes the same global batch.

    On an embedding table sharded over the Zoo mesh's table axis
    (``table.py``; a ``{"dp": N}`` mesh shards over ``dp``) no rank holds
    the whole table, as on the JAX package's mesh, where the step's
    gather and scatter are partitioned. The step deduplicates its ids,
    reads the rows from their owners (:meth:`MatrixTable.owner_route`,
    :meth:`MatrixTable.rows_from_owners` on ``emb_state``) and makes a
    delta of its block's shape: where the table axis is a data axis each
    rank sends its row gradients to their owners
    (:meth:`MatrixTable.sum_at_owners`); otherwise the ranks of the table
    axis hold the same batch and each sums the gradients of its own
    rows, all-reduced over the data axis when there is one. The updater
    then applies to the whole block, as the JAX step's applies to every
    row of its sharded delta (a momentum moves rows the batch did not
    touch). The small MLP table is gathered (``Table.unshard``), as the
    JAX step pins it replicated, and its gradient and the loss share one
    all-reduce over the data axis. A table that is not sharded is read
    and updated whole, its delta all-reduced with the MLP's.
    """
    offsets = field_offsets(cfg).astype(np.int64)
    n_mlp = int(sum(mlp_meta[2]))
    emb_opt = emb_opt or AddOption(learning_rate=0.05, rho=0.1)
    mlp_opt = mlp_opt or AddOption(learning_rate=0.05, rho=0.1)
    from multiverso_tpu_torch.parallel.mesh import iter_axes
    # the data axes (every axis of ``mesh`` when ``axis`` is None)
    data_axes = () if mesh is None else (
        tuple(mesh.axis_names) if axis is None else tuple(iter_axes(axis)))
    n = mesh.axis_size(data_axes) if data_axes else 1
    _, table_axis, num_shards, (lo, hi) = emb_table.sharding
    sharded = num_shards > 1
    # where the table axis is a data axis, the ranks along it bring other
    # batches: their gradients meet at the owners, and any other data
    # axis all-reduces the owners' block
    by_owner = sharded and n > 1 and table_axis in data_axes
    rest = tuple(a for a in data_axes if a != table_axis)
    rest = rest if by_owner and rest and mesh.axis_size(rest) > 1 else ()

    def step(emb_state, mlp_state, cat_ids, dense, labels):
        from multiverso_tpu_torch.parallel import collectives
        block = emb_state["data"]
        dev = block.device
        cat = (cat_ids.cpu().numpy() if isinstance(cat_ids, torch.Tensor)
               else np.asarray(cat_ids))
        b, f = cat.shape
        ids = (cat.astype(np.int64) + offsets[None, :]).reshape(-1)
        if sharded:
            # the batch's unique rows from their owners, indexed back
            uids, inv = np.unique(ids, return_inverse=True)
            route = emb_table.owner_route(uids)
            slot = torch.from_numpy(inv.reshape(-1)).to(dev)
            rows = emb_table.rows_from_owners(uids, block, route)[slot]
        else:
            slot = torch.from_numpy(ids).to(dev)
            rows = block.index_select(0, slot)
        rows = rows.reshape(b, f, cfg.embed_dim)
        flat = mlp_table.unshard(mlp_state["data"])[:n_mlp]
        flat = flat.detach().requires_grad_()
        mlp = unflatten_mlp(flat, mlp_meta)
        rows = rows.detach().requires_grad_()
        loss = loss_fn(mlp, rows, torch.as_tensor(dense, device=dev),
                       torch.as_tensor(labels, device=dev), cfg)
        loss.backward()
        with torch.no_grad():
            # PS push: the row grads summed per row (duplicate ids
            # accumulate), then ONE updater application
            g = rows.grad.reshape(b * f, cfg.embed_dim)
            if sharded:
                g = torch.zeros((uids.size, cfg.embed_dim), dtype=g.dtype,
                                device=dev).index_add_(0, slot, g)
                if by_owner:
                    emb_delta = emb_table.sum_at_owners(uids, g, route)
                else:
                    mine = np.flatnonzero((uids >= lo) & (uids < hi))
                    emb_delta = torch.zeros_like(block).index_add_(
                        0, torch.from_numpy(uids[mine] - lo).to(dev),
                        g[torch.from_numpy(mine).to(dev)])
            else:
                emb_delta = torch.zeros_like(block).index_add_(0, slot, g)
            mlp_grad = flat.grad
            loss = loss.detach()
            if by_owner:
                if rest:
                    emb_delta = collectives.raw_all_reduce(emb_delta, mesh,
                                                           rest)
                emb_delta.div_(n)
            if n > 1:
                # one all-reduce: the MLP's gradient and the loss, and
                # the embedding delta unless it met at its owners
                parts = [mlp_grad.reshape(-1), loss.reshape(1)]
                if not by_owner:
                    parts.insert(0, emb_delta.reshape(-1))
                merged = collectives.raw_all_reduce(
                    torch.cat(parts), mesh, data_axes) / n
                if not by_owner:
                    emb_delta = merged[:emb_delta.numel()].view_as(
                        emb_delta)
                mlp_grad = merged[-1 - mlp_grad.numel():-1].view_as(
                    mlp_grad)
                loss = merged[-1]
            emb_state = emb_table.functional_add(emb_state, emb_delta,
                                                 emb_opt)
            mlp_state = mlp_table.functional_add(
                mlp_state, mlp_table.pad_delta(mlp_grad), mlp_opt)
        return emb_state, mlp_state, loss

    return step


def synthetic_ctr(cfg: DLRMConfig, n: int, seed: int = 0):
    """Click data with planted structure: certain (field-0, field-1) row
    pairs interact positively — learnable only through the embedding
    tables + dot interaction. The JAX package's numpy draws."""
    rng = np.random.default_rng(seed)
    cat = np.stack([rng.integers(0, v, n) for v in cfg.vocab_sizes],
                   axis=1).astype(np.int32)
    dense = rng.normal(size=(n, cfg.dense_dim)).astype(np.float32)
    w = rng.normal(size=cfg.dense_dim)
    affinity = rng.normal(0, 1.5, (cfg.vocab_sizes[0], cfg.vocab_sizes[1]))
    logits = dense @ w + affinity[cat[:, 0], cat[:, 1] % cfg.vocab_sizes[1]]
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(
        np.float32)
    return cat, dense, labels
