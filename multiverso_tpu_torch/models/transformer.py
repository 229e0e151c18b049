"""Decoder-only transformer LM (port of
``multiverso_tpu/models/transformer.py``): forward, training steps, the
mesh layouts, the pipelined stack, and the KV-cache decode.

The parameters keep the JAX package's layout: per-layer weights are
stacked on a leading layer dimension (``layers.wqkv`` is [L, D, 3D], ...),
so ``params_from_jax`` / ``params_to_numpy`` carry one package's
``init_params`` tree to the other, and ``SharedPytree`` flattens both into
the same vector. ``attn="flash"`` runs the port's flash attention (the
CUDA kernels on the card, forward and backward), ``attn="local"`` the
plain ``reference_attention``, and ``"ring"``, ``"zigzag"`` and
``"ulysses"`` the sequence-parallel schemes of ``parallel/ring.py``.

**Meshes.** The JAX model is written at the global level and GSPMD
shards it. Here every rank is one process holding its own shard
(``parallel/mesh.py``): a ``Transformer`` built for a mesh holds this
rank's blocks of the global tree, and the forward takes this rank's
tokens (``shard_batch``) and returns this rank's logits, with the
collectives placed by hand:

* ``batch_axis`` shards B, ``seq_axis`` shards S (ring, zigzag, Ulysses;
  ``local`` gathers K and V); the train steps average the gradients over
  both, and ``loss_fn`` returns the global loss.
* ``tp_axis``: Megatron tensor parallelism. Each rank holds the q, k and
  v columns of its heads, w1's columns and wo/w2's rows, and its vocab
  rows of the embedding; the copy-to / reduce-from pair
  (``parallel/collectives``) frames each sublayer, the lookup is masked
  and all-reduced, and the loss is a vocab-parallel cross-entropy with
  the JAX f32 logsumexp.
* ``shard_params_fsdp``: each rank stores 1/n of every large leaf and
  all-gathers it for the forward (its gradient reduce-scattered back).
* ``moe_experts``: expert-parallel MoE MLPs (``parallel/moe.py``) over
  ``moe_axis``; the aux loss joins the loss.
* Pipelines: ``stack_pp_params`` / ``shard_params_pp`` /
  ``make_pp_train_step`` over a ``pp`` axis (``parallel/pipeline.py``),
  with tensor parallelism inside a stage.

``attn="flash"`` with ``batch_axis``/``tp_axis`` runs the flash kernels
on each rank's local [B/dp, H/tp, S, hd] (and their backward in
training). Without a mesh a model runs on a world of one.

``forward``, ``loss_fn`` and the steps are differentiable with autograd;
a caller that only scores wraps them in ``torch.no_grad()`` or
``torch.inference_mode()``. ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``). ``make_optim_train_step`` is the
counterpart of the JAX ``make_optax_train_step``: one step of any
``torch.optim`` optimizer. ``generate`` and ``generate_beam`` decode with a
static KV cache ([L, B, H, max_seq, hd] in ``cfg.dtype``; dense attention
over it, as the JAX decode does, not the flash kernel; MoE layers route
each token to its top-k experts exactly), from a ``Transformer`` or the
int8 tree of ``ops.quantization.quantize_lm_params``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverso_tpu_torch.ops.attention_kernels import flash_attention
from multiverso_tpu_torch.parallel import collectives as coll
from multiverso_tpu_torch.parallel import ring
from multiverso_tpu_torch.parallel import tp as tp_lib
from multiverso_tpu_torch.parallel.mesh import P, iter_axes, one_rank_mesh


class TransformerConfig(NamedTuple):
    vocab_size: int = 256
    dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    max_seq: int = 512
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    attn: str = "flash"   # "flash" | "local" | "ring" | "zigzag" | "ulysses"
    seq_axis: Optional[str] = None    # mesh axis for sequence parallelism
    batch_axis: Optional[str] = None  # mesh axis for data parallelism
    tp_axis: Optional[str] = None     # mesh axis for tensor parallelism
    remat: bool = False
    # interleaved pipeline schedule: virtual chunks per pp rank
    # (parallel/pipeline.pipeline_apply_interleaved); 1 = plain GPipe
    pp_chunks: int = 1
    # expert-parallel MoE MLPs (parallel/moe.py): 0 = dense MLP
    moe_experts: int = 0
    moe_axis: str = "ep"              # mesh axis the experts shard over
    moe_top_k: int = 1
    moe_capacity_factor: float = 2.0
    moe_aux_coef: float = 0.01


_ATTNS = ("flash", "local", "ring", "zigzag", "ulysses")


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``ValueError`` for what the JAX model refuses too: an unknown
    ``attn``, the flash kernel over a sequence axis, Ulysses with tensor
    parallelism, and MoE MLPs with a sequence or tensor axis."""
    if cfg.attn not in _ATTNS:
        raise ValueError(f"attn={cfg.attn!r}: expected one of {_ATTNS}")
    if cfg.attn == "flash" and cfg.seq_axis is not None:
        raise ValueError("attn='flash' is the single-chip fused kernel; "
                         "use attn='ring' for sequence parallelism")
    if cfg.attn == "ulysses" and cfg.tp_axis is not None:
        raise ValueError("ulysses attention reshards heads itself; combine "
                         "tp_axis with attn='ring' or 'local' instead")
    if cfg.moe_experts and (cfg.seq_axis is not None
                            or cfg.tp_axis is not None):
        raise ValueError(
            "MoE MLPs shard tokens over moe_axis; combine with "
            "batch_axis only (seq_axis/tp_axis are not supported "
            "together with moe_experts)")


def cfg_axes(cfg: TransformerConfig) -> tuple:
    """The mesh axes ``cfg`` names, in a fixed order."""
    axes = [a for a in (cfg.batch_axis, cfg.seq_axis, cfg.tp_axis) if a]
    if cfg.moe_experts:
        axes.append(cfg.moe_axis)
    return tuple(dict.fromkeys(axes))


def init_params(cfg: TransformerConfig, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's ``init_params`` draws, as a float32 numpy tree:
    the same numpy generator calls in the same order, so for a float32
    config the arrays are equal to the JAX ones bit for bit."""
    rng = np.random.default_rng(seed)
    d, L = cfg.dim, cfg.num_layers
    m = cfg.mlp_ratio * d

    def norm(*shape, scale):
        return np.asarray(rng.normal(0, scale, shape), np.float32)

    s = 1.0 / np.sqrt(d)
    layers = {
        "wqkv": norm(L, d, 3 * d, scale=s),
        "wo": norm(L, d, d, scale=s / np.sqrt(2 * L)),
        "ln1": np.ones((L, d), np.float32),
        "ln2": np.ones((L, d), np.float32),
    }
    if cfg.moe_experts:
        e = cfg.moe_experts
        layers["moe_w1"] = norm(L, e, d, m, scale=s)
        layers["moe_w2"] = norm(L, e, m, d,
                                scale=np.sqrt(1.0 / m) / np.sqrt(2 * L))
        layers["moe_router"] = norm(L, d, e, scale=s)
    else:
        layers["w1"] = norm(L, d, m, scale=s)
        layers["w2"] = norm(L, m, d, scale=np.sqrt(1.0 / m) / np.sqrt(2 * L))
    return {
        "embed": norm(cfg.vocab_size, d, scale=0.02),
        "pos": norm(cfg.max_seq, d, scale=0.02),
        "layers": layers,
        "ln_f": np.ones((d,), np.float32),
    }


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The global shape of every leaf of the param tree."""
    d, L, v = cfg.dim, cfg.num_layers, cfg.vocab_size
    m = cfg.mlp_ratio * d
    layers = {"wqkv": (L, d, 3 * d), "wo": (L, d, d), "ln1": (L, d),
              "ln2": (L, d)}
    if cfg.moe_experts:
        e = cfg.moe_experts
        layers.update(moe_w1=(L, e, d, m), moe_w2=(L, e, m, d),
                      moe_router=(L, d, e))
    else:
        layers.update(w1=(L, d, m), w2=(L, m, d))
    return {"embed": (v, d), "pos": (cfg.max_seq, d), "ln_f": (d,),
            "layers": layers}


def _replicated_rules(cfg: TransformerConfig) -> Dict[str, Any]:
    sh = param_shapes(cfg)
    return {k: ({kk: P() for kk in v} if isinstance(v, dict) else P())
            for k, v in sh.items()}


def _moe_rules(cfg: TransformerConfig) -> Dict[str, Any]:
    rules = _replicated_rules(cfg)
    ax = cfg.moe_axis
    rules["layers"]["moe_w1"] = P(None, ax, None, None)
    rules["layers"]["moe_w2"] = P(None, ax, None, None)
    return rules


def _qkv_tp_perm(d: int, n: int) -> np.ndarray:
    """Column permutation of wqkv ([q_all | k_all | v_all]) after which a
    contiguous split over ``n`` tensor-parallel ranks hands rank r the q,
    k and v columns of its heads: [q_r | k_r | v_r] for r = 0..n-1."""
    dl = d // n
    return np.asarray([c * d + r * dl + i for r in range(n)
                       for c in range(3) for i in range(dl)], np.int64)


class _Layers(nn.Module):
    """The layer stack's weights, stacked on a leading layer dimension."""

    def __init__(self, shapes: Dict[str, tuple], cfg: TransformerConfig,
                 device):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, _param(shape, cfg, device))


def _param(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))


class Transformer(nn.Module):
    """The LM; parameter names follow the JAX tree. Built for a ``mesh``
    it holds this rank's blocks under ``layout`` ("replicated", "tp",
    "fsdp" or "moe"; default: "tp" with ``cfg.tp_axis``, "moe" with
    ``cfg.moe_experts``, else "replicated"); without one, a world of one
    over the axes ``cfg`` names (the Zoo's mesh when it has them)."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None,
                 layout: Optional[str] = None,
                 fsdp_axis: Optional[str] = None):
        super().__init__()
        check_supported(cfg)
        if cfg.dim % cfg.num_heads:
            raise ValueError(f"dim {cfg.dim} not divisible by "
                             f"num_heads {cfg.num_heads}")
        self.cfg = cfg
        self.mesh = _model_mesh(cfg, mesh, device)
        if device is None:
            device = self.mesh.device
        if layout is None:
            layout = ("tp" if cfg.tp_axis else
                      "moe" if cfg.moe_experts else "replicated")
        if layout == "tp":
            if cfg.tp_axis is None:
                raise ValueError("the tp layout needs cfg.tp_axis set; with "
                                 "no tensor-parallel axis it would silently "
                                 "replicate every parameter")
            self.rules = tp_lib.transformer_tp_rules(cfg.tp_axis)
            n = self.mesh.axis_size(cfg.tp_axis)
            if cfg.num_heads % n or cfg.vocab_size % n:
                raise ValueError(f"num_heads={cfg.num_heads} and "
                                 f"vocab_size={cfg.vocab_size} must be "
                                 f"divisible by tp={n}")
            self.qkv_perm = _qkv_tp_perm(cfg.dim, n) if n > 1 else None
        elif layout == "fsdp":
            if cfg.tp_axis is not None:
                raise ValueError("the fsdp layout shards over the data "
                                 "axis; combine it with tp_axis=None")
            self.rules = tp_lib.transformer_fsdp_rules(
                fsdp_axis or cfg.batch_axis or "fsdp",
                moe=bool(cfg.moe_experts))
            self.qkv_perm = None
        elif layout == "moe":
            if not cfg.moe_experts:
                raise ValueError("the moe layout needs cfg.moe_experts > 0")
            self.rules = _moe_rules(cfg)
            self.qkv_perm = None
        elif layout == "replicated":
            self.rules = _replicated_rules(cfg)
            self.qkv_perm = None
        else:
            raise ValueError(f"layout={layout!r}")
        self.layout = layout
        for _, spec in tp_lib.leaves(self.rules):
            tp_lib.constrain(torch.empty((0,) * len(spec)), spec, self.mesh)
        shapes = param_shapes(cfg)
        local = {k: (tp_lib.local_shape(v, self.rules[k], self.mesh)
                     if not isinstance(v, dict) else
                     {kk: tp_lib.local_shape(vv, self.rules[k][kk],
                                             self.mesh)
                      for kk, vv in v.items()})
                 for k, v in shapes.items()}
        self.embed = _param(local["embed"], cfg, device)
        self.pos = _param(local["pos"], cfg, device)
        self.ln_f = _param(local["ln_f"], cfg, device)
        self.layers = _Layers(local["layers"], cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)

    def spec(self, path) -> P:
        node = self.rules
        for key in path:
            node = node[key]
        return node

    def vocab_sharded(self) -> bool:
        ax = self.spec(("embed",))[0] if self.spec(("embed",)) else None
        return self.layout == "tp" and ax is not None \
            and self.mesh.axis_size(ax) > 1


def _model_mesh(cfg: TransformerConfig, mesh, device):
    if mesh is not None:
        for a in cfg_axes(cfg):
            if a not in mesh.shape:
                raise ValueError(f"mesh {mesh.axis_names} has no {a!r} "
                                 "axis, which the config names")
        return mesh
    from multiverso_tpu_torch.zoo import Zoo
    zoo = Zoo.get()
    axes = cfg_axes(cfg)
    if zoo.started and all(a in zoo.mesh().shape for a in axes):
        return zoo.mesh()
    return one_rank_mesh(axes or ("mv",), device)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    # rsqrt cast to x's dtype before the multiply, as the JAX model does
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * g


def _local_attention_sharded(q, k, v, mesh, seq_axis) -> torch.Tensor:
    """``attn="local"`` over a sequence axis: this rank's queries against
    the all-gathered keys and values (the gather's backward
    reduce-scatters their gradients), causal at global positions; the
    scores and softmax in f32 as ``reference_attention``."""
    sq = q.shape[2]
    k = coll.all_gather_grad(k, mesh, seq_axis, dim=2)
    v = coll.all_gather_grad(v, mesh, seq_axis, dim=2)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = mesh.index(seq_axis) * sq + torch.arange(sq, device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    s = torch.where(qpos[:, None] >= kpos[None, :], s,
                    torch.full_like(s, ring._NEG_INF))
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _attention(cfg: TransformerConfig, mesh, q, k, v) -> torch.Tensor:
    """Attention over this rank's [B/dp, H/tp, S/sp, hd] q/k/v."""
    if cfg.attn == "local":
        if cfg.seq_axis is not None and mesh.axis_size(cfg.seq_axis) > 1:
            return _local_attention_sharded(q, k, v, mesh, cfg.seq_axis)
        return ring.reference_attention(q, k, v, causal=True)
    if cfg.attn == "flash":
        # each rank runs the kernel on its own batch and head slice; the
        # kernel picks its own tile (no TPU block-size rule here)
        return flash_attention(q, k, v, causal=True)
    if cfg.attn == "ring":
        return ring.ring_attention(q, k, v, axis_name=cfg.seq_axis,
                                   mesh=mesh, causal=True,
                                   batch_axis=cfg.batch_axis,
                                   head_axis=cfg.tp_axis)
    if cfg.attn == "zigzag":
        # balanced causal ring; activations are in zigzag sequence order
        # end to end (shard_batch permutes tokens, forward permutes pos)
        return ring.zigzag_ring_attention(
            q, k, v, axis_name=cfg.seq_axis, mesh=mesh,
            batch_axis=cfg.batch_axis, head_axis=cfg.tp_axis)
    return ring.ulysses_attention(q, k, v, axis_name=cfg.seq_axis,
                                  mesh=mesh, causal=True,
                                  batch_axis=cfg.batch_axis)


def _mlp(y: torch.Tensor, w1, w2) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.matmul(F.gelu(torch.matmul(y, w1), approximate="tanh"), w2)


def _moe_config(cfg: TransformerConfig):
    from multiverso_tpu_torch.parallel import moe as moe_lib
    return moe_lib.MoEConfig(
        num_experts=cfg.moe_experts, dim=cfg.dim,
        hidden=cfg.mlp_ratio * cfg.dim,
        capacity_factor=cfg.moe_capacity_factor, axis=cfg.moe_axis,
        top_k=cfg.moe_top_k)


def _layer(cfg: TransformerConfig, mesh, x: torch.Tensor,
           aux: torch.Tensor, p: Dict[str, torch.Tensor],
           stats: Optional[Dict[str, list]] = None):
    """One transformer block on this rank's activation [B_l, S_l, D];
    returns (x, aux). With ``cfg.tp_axis`` the weights are this rank's
    Megatron blocks and each sublayer is framed by copy_to/reduce_from;
    with MoE the MLP is ``parallel/moe.moe_layer`` on this rank's token
    chunk over ``moe_axis``."""
    b, s, _ = x.shape
    hd = cfg.dim // cfg.num_heads
    tp = cfg.tp_axis
    y = _rmsnorm(x, p["ln1"])
    if tp:
        y = coll.copy_to(y, mesh, tp)
    q, k, v = torch.matmul(y, p["wqkv"]).chunk(3, dim=-1)
    h_loc = q.shape[-1] // hd
    # [B, S, D_l] -> [B, H_l, S, hd]
    split = lambda t: t.reshape(b, s, h_loc, hd).transpose(1, 2)
    o = _attention(cfg, mesh, split(q), split(k), split(v))
    o = o.transpose(1, 2).reshape(b, s, h_loc * hd)
    a = torch.matmul(o, p["wo"])
    if tp:
        a = coll.reduce_from(a, mesh, tp)
    x = x + a
    y = _rmsnorm(x, p["ln2"])
    if cfg.moe_experts:
        from multiverso_tpu_torch.parallel import moe as moe_lib
        ax = cfg.moe_axis
        yc = coll.scatter_to(y, mesh, ax, dim=1)
        out, aux_l, dropped = moe_lib.moe_layer(
            yc, {"w1": p["moe_w1"], "w2": p["moe_w2"],
                 "router": p["moe_router"]},
            _moe_config(cfg), mesh, batch_axis=cfg.batch_axis)
        if stats is not None:
            stats.setdefault("aux", []).append(float(aux_l))
            stats.setdefault("dropped", []).append(float(dropped))
        return x + coll.gather_from(out, mesh, ax, dim=1), aux + aux_l
    if tp:
        y = coll.copy_to(y, mesh, tp)
    m = _mlp(y, p["w1"], p["w2"])
    if tp:
        m = coll.reduce_from(m, mesh, tp)
    return x + m, aux


def _weights(params: "Transformer") -> Dict[str, Any]:
    """The leaves the forward computes with: the model's own, or under
    FSDP each sharded leaf all-gathered (backward: reduce-scatter)."""
    tree: Dict[str, Any] = {}
    for path, p in _paths(params):
        if params.layout == "fsdp":
            spec = params.spec(path)
            for d in range(len(spec)):
                axes = tuple(iter_axes(spec[d]))
                if axes:
                    p = coll.all_gather_grad(p, params.mesh, axes, dim=d)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p
    return tree


def _embed_lookup(params: "Transformer", embed: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    tokens = tokens.long()
    if not params.vocab_sharded():
        return embed[tokens]
    # vocab-sharded rows: a masked lookup of this rank's rows, summed over
    # the tensor axis (each token's row lives on exactly one rank)
    mesh, ax = params.mesh, params.cfg.tp_axis
    vl = embed.shape[0]
    local = tokens - mesh.index(ax) * vl
    inside = (local >= 0) & (local < vl)
    rows = embed[local.clamp(0, vl - 1)] * inside[..., None].to(embed.dtype)
    return coll.reduce_from(rows, mesh, ax)


def _positions(params: "Transformer", cfg: TransformerConfig, s: int,
               device) -> torch.Tensor:
    """Global positions of this rank's ``s`` tokens."""
    mesh = params.mesh
    ax = cfg.seq_axis or mesh.axis_names[-1]
    n, i = mesh.axis_size(ax), mesh.index(ax)
    if cfg.attn == "zigzag":
        # tokens arrive zigzag-permuted (shard_batch); the position
        # embeddings follow the same permutation
        perm = ring.zigzag_shard_ids(s * n, n)[i * s:(i + 1) * s]
        return torch.as_tensor(perm, device=device)
    off = i * s if cfg.seq_axis is not None else 0
    return torch.arange(off, off + s, device=device)


def forward_with_aux(params: Transformer, tokens: torch.Tensor,
                     cfg: Optional[TransformerConfig] = None,
                     stats: Optional[Dict[str, list]] = None):
    """This rank's tokens [B_l, S_l] -> (its logits [B_l, S_l, V_l], the
    MoE aux loss, a scalar). ``V_l`` is the vocab block of a
    vocab-sharded (tensor-parallel) model, else V. ``cfg`` defaults to the
    model's (it may differ in ``attn``, ``remat`` and the MoE capacity,
    not in shapes). ``stats``, a dict, collects each MoE layer's ``aux``
    and ``dropped`` fraction (floats: a host sync a layer)."""
    cfg = cfg or params.cfg
    check_supported(cfg)
    mesh = params.mesh
    w = _weights(params)
    s = tokens.shape[1]
    pos = w["pos"][_positions(params, cfg, s, tokens.device)]
    x = _embed_lookup(params, w["embed"], tokens) + pos[None]
    ls = w["layers"]
    names = list(ls)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # one unbind per stacked leaf, as the JAX scan slices it: its backward
    # stacks the layers' gradients once, where indexing [i] would add L
    # full-size zero-padded gradients into each leaf
    for weights in zip(*(ls[n].unbind(0) for n in names)):
        p = dict(zip(names, weights))
        if cfg.remat:
            # recompute the layer in the backward (jax.checkpoint in JAX)
            x, aux = checkpoint(_layer, cfg, mesh, x, aux, p,
                                use_reentrant=False)
        else:
            x, aux = _layer(cfg, mesh, x, aux, p, stats)
    return _lm_head_sharded(params, cfg, x, w["ln_f"], w["embed"]), aux


def _lm_head_sharded(params: Transformer, cfg: TransformerConfig, x,
                     ln_f, embed) -> torch.Tensor:
    y = _rmsnorm(x, ln_f)
    if params.vocab_sharded():
        y = coll.copy_to(y, params.mesh, cfg.tp_axis)
    return torch.matmul(y, embed.t())


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V] (this rank's blocks on a mesh);
    the MoE aux loss is dropped (training uses :func:`loss_fn`, which
    keeps it)."""
    return forward_with_aux(params, tokens, cfg)[0]


def _lm_head(x: torch.Tensor, ln_f: torch.Tensor,
             embed: torch.Tensor) -> torch.Tensor:
    """Final norm + tied-embedding projection: [B, S, D] -> [B, S, V]."""
    return torch.matmul(_rmsnorm(x, ln_f), embed.t())


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in f32 (logsumexp - target logit);
    ``mask`` weights positions. The max shift is a constant offset of both
    terms and carries no gradient (``stop_gradient`` in JAX)."""
    lg32 = logits.float()
    m = torch.amax(lg32, -1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lg32 - m), -1)) + m[..., 0]
    tl = torch.gather(lg32, -1, targets[..., None].long())[..., 0]
    nll = lse - tl
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def data_axes(cfg: TransformerConfig, mesh) -> tuple:
    """The axes the tokens are sharded on (batch, sequence) that the mesh
    has: the loss is their ranks' mean, and the steps average the
    gradients over them."""
    return tuple(a for a in dict.fromkeys((cfg.batch_axis, cfg.seq_axis))
                 if a and a in mesh.shape)


def _token_nll(params: Transformer, cfg: TransformerConfig, logits,
               targets) -> torch.Tensor:
    """Per-token cross-entropy [B_l, S_l] in f32 from this rank's logits;
    over a vocab-sharded head the max, the exp-sum and the target logit
    are reduced over the tensor axis (the JAX f32 logsumexp, its sum in
    another order)."""
    if not params.vocab_sharded():
        lg32 = logits.float()
        m = torch.amax(lg32, -1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(lg32 - m), -1)) + m[..., 0]
        tl = torch.gather(lg32, -1, targets[..., None].long())[..., 0]
        return lse - tl
    mesh, ax = params.mesh, cfg.tp_axis
    lg32 = logits.float()
    m = coll.raw_all_reduce(lg32.detach().amax(-1, keepdim=True), mesh, ax,
                            op="max")
    se = coll.reduce_from(torch.sum(torch.exp(lg32 - m), -1), mesh, ax)
    lse = torch.log(se) + m[..., 0]
    vl = logits.shape[-1]
    local = targets.long() - mesh.index(ax) * vl
    inside = (local >= 0) & (local < vl)
    tl = torch.gather(lg32, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
    tl = coll.reduce_from(tl * inside.float(), mesh, ax)
    return lse - tl


def loss_fn(params: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) plus ``moe_aux_coef`` times the
    MoE load-balance loss. ``targets`` is tokens shifted by one, ``mask``
    zeroes padding positions; on a mesh all three are this rank's blocks
    (``shard_batch``, which zigzag-permutes the mask with the tokens).

    Returns the global loss; its gradient on each rank is that of this
    rank's share (the data-parallel steps average the ranks' gradients),
    so the averaged gradient is the global loss's."""
    cfg = cfg or params.cfg
    mesh = params.mesh
    logits, aux = forward_with_aux(params, tokens, cfg)
    nll = _token_nll(params, cfg, logits, targets)
    axes = data_axes(cfg, mesh)
    n = mesh.axis_size(axes) if axes else 1
    if mask is not None:
        mask = mask.to(nll.dtype)
        total = mask.sum()
        if n > 1:
            total = coll.raw_all_reduce(total, mesh, axes)
        local = n * (nll * mask).sum() / torch.clamp(total, min=1)
    else:
        local = nll.mean()
    if cfg.moe_experts:
        local = local + cfg.moe_aux_coef * aux
    return coll.mean_over(local, mesh, axes) if n > 1 else local


def reduce_grads(params: Transformer, grads: List[torch.Tensor],
                 cfg: Optional[TransformerConfig] = None
                 ) -> List[torch.Tensor]:
    """Average the gradients over the data axes (aligned with
    ``params.parameters()``): a leaf replicated there is all-reduced (one
    bucket per set of axes and dtype), and every leaf is divided by the
    data ranks' count (a leaf sharded on a data axis arrives summed from
    its all-gather's reduce-scatter)."""
    cfg = cfg or params.cfg
    mesh = params.mesh
    axes = data_axes(cfg, mesh)
    n = mesh.axis_size(axes) if axes else 1
    if n == 1:
        return list(grads)
    out = [g / n for g in grads]
    buckets: Dict[Any, List[int]] = {}
    for i, (path, _) in enumerate(_paths(params)):
        spec = params.spec(path)
        held = {a for part in spec for a in iter_axes(part)}
        rep = tuple(a for a in axes if a not in held)
        if rep and mesh.axis_size(rep) > 1:
            buckets.setdefault((rep, out[i].dtype), []).append(i)
    for (rep, _), idx in buckets.items():
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        flat = coll.raw_all_reduce(flat, mesh, rep)
        off = 0
        for i in idx:
            k = out[i].numel()
            out[i] = flat[off:off + k].view_as(out[i])
            off += k
    return out


def loss_and_grads(model: Transformer, tokens, targets, mask=None,
                   cfg: Optional[TransformerConfig] = None):
    """(global loss, the averaged gradients aligned with
    ``model.parameters()``)."""
    params = list(model.parameters())
    loss = loss_fn(model, tokens, targets, mask, cfg=cfg)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), reduce_grads(model, list(grads), cfg)


def make_train_step(cfg: TransformerConfig, learning_rate: float = 1e-2):
    """Plain-SGD step ``(model, tokens, targets, mask=None) -> loss`` (port
    of the JAX ``make_train_step``).

    Autograd computes the gradients of ``loss_fn`` (averaged over the data
    axes on a mesh); then, under ``no_grad``, each parameter is updated in
    place as ``p -= lr * g`` with ``lr`` first cast to the parameter's
    dtype, as ``jnp.asarray(learning_rate, p.dtype)`` does (in bf16, 1e-2
    becomes 0.010009765625). The in-place update stands in for the JAX
    step's donation of ``params`` (``donate_argnums=(0,)``): the weights
    are written where they lie, and the caller's model is the updated one.
    """
    def step(model: Transformer, tokens: torch.Tensor,
             targets: torch.Tensor, mask=None) -> torch.Tensor:
        loss, grads = loss_and_grads(model, tokens, targets, mask, cfg)
        sgd_update_(list(model.parameters()), grads, learning_rate)
        return loss

    return step


@torch.no_grad()
def sgd_update_(params: List[torch.Tensor], grads: List[torch.Tensor],
                learning_rate: float) -> None:
    """The SGD steps' update, in place: ``p -= lr * g`` with ``lr`` cast
    to each parameter's dtype first (the JAX ``jnp.asarray(lr,
    p.dtype)``)."""
    for p, g in zip(params, grads):
        lr = torch.tensor(learning_rate, dtype=p.dtype).item()
        p.sub_(g * lr)


def make_optim_train_step(cfg: TransformerConfig,
                          optimizer: torch.optim.Optimizer):
    """One step of any ``torch.optim`` optimizer over a ``Transformer``:
    ``(model, tokens, targets, mask=None) -> loss`` (port of the JAX
    ``make_optax_train_step``).

    The JAX step is ``(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` for an optax ``GradientTransformation`` initialized
    with ``optimizer.init(params)``. Here the parameters are the model's
    own, and the optimizer, built over ``model.parameters()`` by the
    caller, holds its state (``optimizer.state``) and updates the
    parameters in place. So the step takes the model and the batch, and
    returns only the loss (detached): the loss of ``loss_fn``, its
    backward (through the flash autograd function with
    ``attn="flash"``), the gradients averaged over the data axes on a
    mesh, ``optimizer.step()``, then ``zero_grad``. Under FSDP or tensor
    parallelism each rank's optimizer state covers its own blocks.

    The hyperparameters' defaults differ between the libraries
    (``optax.adamw``'s weight decay is 1e-4, ``torch.optim.AdamW``'s is
    1e-2): pass each one explicitly. The update rules agree: optax's
    ``sgd(lr, momentum)`` is ``torch.optim.SGD(lr, momentum)`` (no
    dampening, no Nesterov), ``adam`` and ``adamw`` are ``Adam`` and
    ``AdamW`` (bias correction, eps outside the square root, decoupled
    decay), with the state in the parameters' dtype in both."""
    def step(model: Transformer, tokens: torch.Tensor,
             targets: torch.Tensor, mask=None) -> torch.Tensor:
        loss = loss_fn(model, tokens, targets, mask, cfg=cfg)
        loss.backward()
        params = list(model.parameters())
        if data_axes(cfg, model.mesh):
            for p, g in zip(params, reduce_grads(
                    model, [p.grad for p in params], cfg)):
                p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step


def _paths(model: Transformer):
    for name, p in model.named_parameters():
        yield tuple(name.split(".")), p


def _local_block(model: Transformer, path, arr: np.ndarray) -> np.ndarray:
    """This rank's block of the global leaf ``arr`` at ``path``."""
    if path[-1] == "wqkv" and model.qkv_perm is not None:
        arr = arr[..., model.qkv_perm]
    return arr[tp_lib.local_slices(arr.shape, model.spec(path), model.mesh)]


@torch.no_grad()
def load_params_(model: Transformer, tree: Dict[str, Any]) -> Transformer:
    """Write the global JAX-layout numpy tree ``tree`` (stacked [L, ...]
    layer leaves) into ``model``'s parameters in place, cast to their
    dtype: this rank's blocks of it on a mesh."""
    for path, p in _paths(model):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.asarray(leaf, dtype=np.float32)
        want = param_shapes(model.cfg)
        for key in path:
            want = want[key]
        if arr.shape != tuple(want):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape} != "
                             f"{tuple(want)}")
        arr = np.ascontiguousarray(_local_block(model, path, arr))
        if not arr.flags.writeable:   # arrays handed out by jax
            arr = arr.copy()
        p.copy_(torch.from_numpy(arr))
    return model


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device=None, mesh=None,
                    layout: Optional[str] = None,
                    fsdp_axis: Optional[str] = None) -> Transformer:
    """Build the port's model from the JAX ``init_params`` tree given as
    numpy arrays (stacked [L, ...] layer leaves), cast to ``cfg.dtype``:
    on a ``mesh``, this rank's blocks of it under ``layout`` (see
    :class:`Transformer`)."""
    return load_params_(Transformer(cfg, device, mesh, layout, fsdp_axis),
                        tree)


def shard_params_tp(params: Dict[str, Any], cfg: TransformerConfig,
                    mesh=None, device=None) -> Transformer:
    """This rank's Megatron blocks over ``cfg.tp_axis`` (see
    parallel/tp.transformer_tp_rules; wqkv keeps the q, k and v columns
    of the rank's heads)."""
    if cfg.tp_axis is None:
        raise ValueError("shard_params_tp needs cfg.tp_axis set; with no "
                         "tensor-parallel axis it would silently replicate "
                         "every parameter")
    return params_from_jax(params, cfg, device, mesh, layout="tp")


def shard_params_fsdp(params: Dict[str, Any], cfg: TransformerConfig,
                      mesh=None, axis: str = "fsdp",
                      device=None) -> Transformer:
    """This rank's FSDP blocks over ``axis`` (parallel/tp.
    transformer_fsdp_rules): 1/n of every large leaf, gathered for the
    forward; combine with ``batch_axis=axis`` so the same ranks compute
    data-parallel."""
    return params_from_jax(params, cfg, device, mesh, layout="fsdp",
                           fsdp_axis=axis)


def shard_params_moe(params: Dict[str, Any], cfg: TransformerConfig,
                     mesh=None, device=None) -> Transformer:
    """This rank's experts (the [L, E, ...] stacks split on E over
    ``cfg.moe_axis``), everything else replicated."""
    if not cfg.moe_experts:
        raise ValueError("shard_params_moe needs cfg.moe_experts > 0")
    return params_from_jax(params, cfg, device, mesh, layout="moe")


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX-layout tree of its own tensors
    (detached, on its device, in its dtype; this rank's blocks on a
    mesh): what ``generate`` reads, and what
    ``ops.quantization.quantize_lm_params`` quantizes."""
    tree: Dict[str, Any] = {}
    for path, p in _paths(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach()
    return tree


@torch.no_grad()
def tree_to_numpy(model: Transformer,
                  tensors: Optional[List[torch.Tensor]] = None
                  ) -> Dict[str, Any]:
    """The global JAX-layout numpy tree of per-parameter tensors aligned
    with ``model.parameters()`` (default: the parameters; gradients from
    :func:`loss_and_grads` too): on a mesh every rank's blocks are
    gathered (collective: every rank calls). bf16 comes back as float32,
    exactly."""
    if tensors is None:
        tensors = [p for _, p in _paths(model)]
    tree: Dict[str, Any] = {}
    for (path, _), t in zip(_paths(model), tensors):
        g = tp_lib.gather_leaf(t.detach(), model.spec(path), model.mesh)
        g = g.cpu()
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        if path[-1] == "wqkv" and model.qkv_perm is not None:
            inv = np.empty_like(model.qkv_perm)
            inv[model.qkv_perm] = np.arange(model.qkv_perm.size)
            g = g[..., inv]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = g
    return tree


def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the global JAX-layout numpy tree (bf16
    leaves come back as float32, exactly); gathered on a mesh."""
    return tree_to_numpy(model)


def shard_batch(tokens, cfg: TransformerConfig, mesh=None,
                device=None) -> torch.Tensor:
    """This rank's block of a global [B, S] batch (numpy or a tensor),
    sharded over (batch_axis, seq_axis), as a tensor on the mesh's device.
    With ``attn="zigzag"`` the sequence is permuted into zigzag order first
    (apply it to tokens, targets and masks alike: logits and losses come
    back in that order, which leaves any position-mean loss unchanged)."""
    if mesh is None:
        mesh = _model_mesh(cfg, None, device)
    arr = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) \
        else np.asarray(tokens)
    if cfg.attn == "zigzag":
        ax = cfg.seq_axis or mesh.axis_names[-1]
        arr = arr[:, ring.zigzag_shard_ids(arr.shape[1],
                                           mesh.axis_size(ax))]
    spec = P(cfg.batch_axis, cfg.seq_axis)
    block = np.ascontiguousarray(arr[tp_lib.local_slices(arr.shape, spec,
                                                         mesh)])
    return torch.from_numpy(block).to(device or mesh.device)


def gather_activations(x: torch.Tensor, cfg: TransformerConfig, mesh,
                       vocab_sharded: bool = False) -> np.ndarray:
    """The global array of this rank's [B_l, S_l, ...] block (logits,
    per-token values): gathered over the batch and sequence axes, and the
    vocab dim over the tensor axis when ``vocab_sharded``. Collective."""
    spec = [cfg.batch_axis, cfg.seq_axis]
    if vocab_sharded:
        spec.append(cfg.tp_axis)
    spec = P(*(a if a and a in mesh.shape else None for a in spec))
    g = tp_lib.gather_leaf(x.detach(), spec, mesh).cpu()
    return (g.float() if g.dtype == torch.bfloat16 else g).numpy()


# ---------------------------------------------------------------------- #
# pipeline parallelism: the layer stack split over a pp axis
# ---------------------------------------------------------------------- #
def _qkv_head_perm(d: int, h: int) -> np.ndarray:
    """Column permutation taking wqkv's [q_all | k_all | v_all] layout to
    head-grouped [(q,k,v) of head 0 | (q,k,v) of head 1 | ...], so that a
    contiguous tensor-parallel split inside a pipeline stage hands each
    rank whole heads (the Megatron interleaved-qkv layout)."""
    hd = d // h
    return np.asarray([c * d + g * hd + i
                       for g in range(h) for c in range(3)
                       for i in range(hd)], dtype=np.int64)


def _np_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _np_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_pp_params(params: Dict[str, Any], cfg: TransformerConfig,
                    n_stages: int, tp: Optional[bool] = None,
                    pp_chunks: Optional[int] = None) -> Dict[str, Any]:
    """Regroup the global numpy tree's [L, ...] layer stack as
    [n_stages, L/n_stages, ...] under ``"stages"`` (the JAX function's
    numpy tree): with tensor parallelism (``tp``, default from
    ``cfg.tp_axis``) wqkv's columns are head-grouped
    (:func:`_qkv_head_perm`), and ``pp_chunks > 1`` gives the interleaved
    schedule's [n_stages, pp_chunks, per, ...] layout."""
    if tp is None:
        tp = cfg.tp_axis is not None
    if pp_chunks is None:
        pp_chunks = cfg.pp_chunks
    L = cfg.num_layers
    groups = n_stages * pp_chunks
    if L % groups:
        raise ValueError(f"num_layers={L} not divisible by "
                         f"n_stages*pp_chunks={groups}")
    per = L // groups
    layers = {k: np.asarray(v) for k, v in params["layers"].items()}
    if tp:
        layers["wqkv"] = layers["wqkv"][
            ..., _qkv_head_perm(cfg.dim, cfg.num_heads)]
    out = {k: v for k, v in params.items() if k != "layers"}
    if pp_chunks > 1:
        # interleaved layout: global group g -> (rank g % S, chunk g // S)
        out["stages"] = _np_map(
            lambda p: p.reshape((pp_chunks, n_stages, per) + p.shape[1:])
            .swapaxes(0, 1), layers)
    else:
        out["stages"] = _np_map(
            lambda p: p.reshape((n_stages, per) + p.shape[1:]), layers)
    return out


def unstack_pp_params(stacked: Dict[str, Any],
                      cfg: Optional[TransformerConfig] = None,
                      tp: Optional[bool] = None,
                      pp_chunks: Optional[int] = None) -> Dict[str, Any]:
    """Inverse of :func:`stack_pp_params` on numpy trees: back to the
    plain [L, ...] layout (pass the ``cfg`` and ``pp_chunks`` used to
    stack)."""
    if tp is None:
        tp = cfg is not None and cfg.tp_axis is not None
    if pp_chunks is None:
        pp_chunks = cfg.pp_chunks if cfg is not None else 1
    out = {k: v for k, v in stacked.items() if k != "stages"}
    if pp_chunks > 1:
        layers = _np_map(
            lambda p: np.asarray(p).swapaxes(0, 1).reshape(
                (p.shape[0] * p.shape[1] * p.shape[2],) + p.shape[3:]),
            stacked["stages"])
    else:
        layers = _np_map(
            lambda p: np.asarray(p).reshape(
                (p.shape[0] * p.shape[1],) + p.shape[2:]),
            stacked["stages"])
    if tp:
        if cfg is None:
            raise ValueError("unstack_pp_params(tp=True) needs cfg to "
                             "invert the head-grouped qkv layout")
        perm = _qkv_head_perm(cfg.dim, cfg.num_heads)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        layers["wqkv"] = layers["wqkv"][..., inv]
    out["layers"] = layers
    return out


def _pp_stage_specs(cfg: TransformerConfig, axis: str,
                    chunked: bool = False) -> Dict[str, P]:
    """Partition specs of the stages subtree under pp x tp: the weights
    split over ``cfg.tp_axis`` on the Megatron dims, norms pp-only.
    ``chunked``: leaves carry the interleaved schedule's [n_chunks] dim
    after the stage dim."""
    t = cfg.tp_axis
    c = (None,) if chunked else ()
    return {
        "wqkv": P(axis, *c, None, None, t),
        "wo": P(axis, *c, None, t, None),
        "ln1": P(axis), "ln2": P(axis),
        "w1": P(axis, *c, None, None, t),
        "w2": P(axis, *c, None, t, None),
    }


def shard_params_pp(stacked: Dict[str, Any], mesh=None, axis: str = "pp",
                    cfg: Optional[TransformerConfig] = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """This rank's block of a :func:`stack_pp_params` tree: its stage's
    layers (leaves [1, ...] over ``axis``), the embeddings and final norm
    replicated, as tensors that require grad (in ``dtype``, default
    ``cfg.dtype``). With ``cfg.tp_axis`` each stage's weights are also
    tensor-parallel (:func:`_pp_stage_specs`)."""
    from multiverso_tpu_torch.zoo import Zoo
    mesh = mesh or Zoo.get().mesh()
    if dtype is None:
        dtype = cfg.dtype if cfg is not None else torch.float32
    rules = {k: P() for k in stacked if k != "stages"}
    chunked = np.ndim(stacked["stages"]["wqkv"]) == 5
    if cfg is not None and cfg.tp_axis is not None:
        rules["stages"] = _pp_stage_specs(cfg, axis, chunked=chunked)
    else:
        rules["stages"] = {k: P(axis) for k in stacked["stages"]}
    out = tp_lib.shard_params(stacked, rules, mesh, dtype)
    return _np_map(lambda t: t.requires_grad_(), out)


def pp_leaves(stacked: Dict[str, Any]) -> List[torch.Tensor]:
    """The leaves of a :func:`shard_params_pp` tree, in a fixed order
    (what a ``torch.optim`` optimizer is built over)."""
    return [t for _, t in tp_lib.leaves(stacked)]


def _make_tp_layer_fn(cfg: TransformerConfig, tp_axis: str, n_tp: int,
                      mesh):
    """A transformer block with Megatron tensor parallelism inside a
    pipeline stage: the weights are this rank's blocks (head-grouped qkv,
    w1 column-, wo/w2 row-sharded) and each sublayer ends in one
    all-reduce over ``tp_axis`` (``reduce_from``), its input entering
    through ``copy_to``."""
    h, d = cfg.num_heads, cfg.dim
    hd = d // h
    h_loc = h // n_tp

    def layer(x, p):
        b, s = x.shape[0], x.shape[1]
        y = coll.copy_to(_rmsnorm(x, p["ln1"]), mesh, tp_axis)
        qkv = torch.matmul(y, p["wqkv"])               # [b, s, 3d/t] by head
        qkv = qkv.reshape(b, s, h_loc, 3, hd).permute(3, 0, 2, 1, 4)
        o = _attention(cfg, mesh, qkv[0], qkv[1], qkv[2])   # local heads
        o = o.transpose(1, 2).reshape(b, s, h_loc * hd)
        x = x + coll.reduce_from(torch.matmul(o, p["wo"]), mesh, tp_axis)
        y = coll.copy_to(_rmsnorm(x, p["ln2"]), mesh, tp_axis)
        return x + coll.reduce_from(_mlp(y, p["w1"], p["w2"]), mesh,
                                    tp_axis)

    return layer


def make_pp_loss_fn(cfg: TransformerConfig, n_micro: int, axis: str = "pp",
                    mesh=None, pp_chunks: Optional[int] = None):
    """The pipelined LM loss ``loss(stacked, tokens, targets, mask=None)``
    over the ``axis`` mesh dimension (GPipe microbatch ring,
    ``parallel/pipeline.py``); ``stacked`` is this rank's
    :func:`shard_params_pp` tree, the tokens this rank's batch shard.
    Autograd through the ring's ppermutes drains the pipeline in the
    transposed schedule. Combine with ``cfg.batch_axis`` on a ``(dp, pp)``
    mesh, and ``cfg.tp_axis`` for tensor parallelism inside each stage;
    ``cfg.remat=True`` recomputes each layer in the backward."""
    from multiverso_tpu_torch.parallel import pipeline as pp_lib
    from multiverso_tpu_torch.zoo import Zoo
    mesh = mesh or Zoo.get().mesh()
    if pp_chunks is None:
        pp_chunks = cfg.pp_chunks
    if cfg.moe_experts or cfg.seq_axis is not None:
        raise ValueError("the pp step pipelines the dense stack; sp/moe "
                         "combinations are separate strategies (see "
                         "seq_axis / moe_experts)")
    if cfg.attn not in ("local", "flash"):
        raise ValueError("pipeline stages attend within a microbatch that "
                         "is fully local to the stage; use attn='local' "
                         "(or 'flash' for the fused per-chip kernel)")
    n_stages = mesh.axis_size(axis)
    if cfg.num_layers % (n_stages * pp_chunks):
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pp={n_stages} x pp_chunks={pp_chunks}")
    if pp_chunks > 1 and n_micro != n_stages:
        raise ValueError(f"the interleaved schedule runs a fixed "
                         f"n_micro == pp ({n_stages}); got "
                         f"n_micro={n_micro}")
    # inside the pipeline activations are stage-local: the layer runs
    # without mesh axes (flash runs on the stage's microbatch)
    pcfg = cfg._replace(batch_axis=None, tp_axis=None, seq_axis=None)
    param_specs = None
    if cfg.tp_axis is not None:
        n_tp = mesh.axis_size(cfg.tp_axis)
        if cfg.num_heads % n_tp or (cfg.mlp_ratio * cfg.dim) % n_tp:
            raise ValueError(
                f"num_heads={cfg.num_heads} and mlp hidden "
                f"{cfg.mlp_ratio * cfg.dim} must both be divisible by "
                f"tp={n_tp}")
        layer = _make_tp_layer_fn(pcfg, cfg.tp_axis, n_tp, mesh)
        param_specs = _pp_stage_specs(cfg, axis, chunked=pp_chunks > 1)
    else:
        zero = torch.zeros(())

        def layer(x, p):
            return _layer(pcfg, mesh, x, zero, p)[0]

    def stage_fn(p, x):
        names = list(p)
        for weights in zip(*(p[n].unbind(0) for n in names)):
            pl = dict(zip(names, weights))
            if cfg.remat:
                x = checkpoint(layer, x, pl, use_reentrant=False)
            else:
                x = layer(x, pl)
        return x

    axes = data_axes(cfg, mesh)

    def loss(stacked, tokens, targets, mask=None):
        s = tokens.shape[1]
        x = stacked["embed"][tokens.long()] + stacked["pos"][:s][None]
        if pp_chunks > 1:
            x = pp_lib.pipeline_apply_interleaved(
                stage_fn, stacked["stages"], x, axis=axis, mesh=mesh,
                batch_axis=cfg.batch_axis, param_specs=param_specs)
        else:
            x = pp_lib.pipeline_apply(stage_fn, stacked["stages"], x,
                                      n_micro, axis=axis, mesh=mesh,
                                      batch_axis=cfg.batch_axis,
                                      param_specs=param_specs)
        logits = _lm_head(x, stacked["ln_f"], stacked["embed"])
        n = mesh.axis_size(axes) if axes else 1
        if mask is not None and n > 1:
            total = coll.raw_all_reduce(mask.float().sum(), mesh, axes)
            lg32 = logits.float()
            m = torch.amax(lg32, -1, keepdim=True).detach()
            lse = torch.log(torch.sum(torch.exp(lg32 - m), -1)) + m[..., 0]
            tl = torch.gather(lg32, -1, targets[..., None].long())[..., 0]
            local = n * ((lse - tl) * mask.float()).sum() \
                / torch.clamp(total, min=1)
        else:
            local = _nll(logits, targets, mask)
        return coll.mean_over(local, mesh, axes) if n > 1 else local

    return loss


def reduce_pp_grads(grads: List[torch.Tensor], cfg: TransformerConfig,
                    mesh) -> List[torch.Tensor]:
    """Average a pipeline tree's gradients over ``cfg.batch_axis`` (every
    leaf is replicated there; one all-reduce per dtype)."""
    axes = data_axes(cfg, mesh)
    n = mesh.axis_size(axes) if axes else 1
    if n == 1:
        return list(grads)
    out = list(grads)
    for dt in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dt]
        flat = coll.raw_all_reduce(
            torch.cat([grads[i].reshape(-1) for i in idx]), mesh, axes) / n
        off = 0
        for i in idx:
            k = grads[i].numel()
            out[i] = flat[off:off + k].view_as(grads[i])
            off += k
    return out


def make_pp_loss_and_grads(cfg: TransformerConfig, n_micro: int,
                           axis: str = "pp", mesh=None,
                           pp_chunks: Optional[int] = None):
    """``f(stacked, tokens, targets, mask=None) -> (loss, grads)``: the
    pipelined loss and its gradients (aligned with :func:`pp_leaves`,
    averaged over ``cfg.batch_axis``), what the pp steps apply."""
    from multiverso_tpu_torch.zoo import Zoo
    mesh = mesh or Zoo.get().mesh()
    loss = make_pp_loss_fn(cfg, n_micro, axis, mesh, pp_chunks)

    def f(stacked, tokens, targets, mask=None):
        loss_v = loss(stacked, tokens, targets, mask)
        grads = torch.autograd.grad(loss_v, pp_leaves(stacked))
        return loss_v.detach(), reduce_pp_grads(grads, cfg, mesh)

    return f


def make_pp_train_step(cfg: TransformerConfig, n_micro: int,
                       learning_rate: float = 1e-2, axis: str = "pp",
                       mesh=None, pp_chunks: Optional[int] = None):
    """Plain-SGD pipeline-parallel step ``step(stacked, tokens, targets,
    mask=None) -> (stacked, loss)`` (see :func:`make_pp_loss_fn`): the
    leaves of this rank's tree update in place."""
    f = make_pp_loss_and_grads(cfg, n_micro, axis, mesh, pp_chunks)

    def step(stacked, tokens, targets, mask=None):
        loss_v, grads = f(stacked, tokens, targets, mask)
        sgd_update_(pp_leaves(stacked), grads, learning_rate)
        return stacked, loss_v

    return step


def make_pp_optim_train_step(cfg: TransformerConfig, n_micro: int,
                             optimizer: torch.optim.Optimizer,
                             axis: str = "pp", mesh=None,
                             pp_chunks: Optional[int] = None):
    """The pipelined step for any ``torch.optim`` optimizer built over
    :func:`pp_leaves` (the JAX ``make_pp_optax_train_step``):
    ``step(stacked, tokens, targets, mask=None) -> (stacked, loss)``. The
    optimizer's state for a stage lives on that stage's rank only."""
    f = make_pp_loss_and_grads(cfg, n_micro, axis, mesh, pp_chunks)

    def step(stacked, tokens, targets, mask=None):
        loss_v, grads = f(stacked, tokens, targets, mask)
        for p, g in zip(pp_leaves(stacked), grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return stacked, loss_v

    return step


def pp_tree_to_numpy(stacked: Dict[str, Any], cfg: TransformerConfig,
                     mesh=None, axis: str = "pp",
                     tensors: Optional[List[torch.Tensor]] = None
                     ) -> Dict[str, Any]:
    """The global numpy :func:`stack_pp_params` tree of this rank's
    pipeline tree (or of per-leaf ``tensors`` aligned with
    :func:`pp_leaves`, e.g. gradients), gathered over the stages and the
    tensor axis. Collective: every rank calls."""
    from multiverso_tpu_torch.zoo import Zoo
    mesh = mesh or Zoo.get().mesh()
    chunked = stacked["stages"]["wqkv"].ndim == 5
    rules = {k: P() for k in stacked if k != "stages"}
    rules["stages"] = (_pp_stage_specs(cfg, axis, chunked)
                       if cfg.tp_axis is not None
                       else {k: P(axis) for k in stacked["stages"]})
    if tensors is not None:
        it = iter(tensors)
        stacked = _np_map(lambda _: next(it), stacked)
    return tp_lib.gather_params(stacked, rules, mesh)


# ---------------------------------------------------------------------- #
# decoding: KV-cache generate and beam search
# ---------------------------------------------------------------------- #
_DECODE_NEG_INF = -1e30   # the JAX decode's mask value


def _decode_tree(params) -> Dict[str, Any]:
    return param_tree(params) if isinstance(params, nn.Module) else params


def _is_q(x) -> bool:
    from multiverso_tpu_torch.ops.quantization import QuantizedTensor
    return isinstance(x, QuantizedTensor)


def _emb_rows(e, idx: torch.Tensor) -> torch.Tensor:
    """Embedding-row lookup without materializing the full table."""
    if _is_q(e):
        want = (e.q.shape[0],) + (1,) * (e.q.ndim - 1)
        if tuple(e.scale.shape) != want:
            # a wrong scale layout would index the wrong scales (or fail
            # far from the cause), so it is refused here, as in JAX
            raise ValueError(
                f"embedding QuantizedTensor needs per-row scales "
                f"{want}, got {tuple(e.scale.shape)}; quantize embeddings "
                "with keep_axes=(0,) (quantize_lm_params does)")
        return e.q[idx].float() * e.scale[idx]
    return e[idx]


def _tied_logits(x: torch.Tensor, e) -> torch.Tensor:
    """[B, D] @ tied embedding -> [B, V] f32 logits, the products of the
    ``x.dtype`` values taken in f32 (``preferred_element_type=f32``: a
    bf16 matmul would round the logits to bf16 and flip greedy tokens on
    near-ties). For int8 embeddings the int8 operand is cast to
    ``x.dtype`` and the per-row scale falls on the [B, V] output."""
    if _is_q(e):
        w = e.q.to(x.dtype).float()
        return torch.matmul(x.float(), w.t()) * e.scale[:, 0][None]
    return torch.matmul(x.float(), e.float().t())


def _layer_weights(layers: Dict[str, Any], i: int, dtype) -> Dict[str, Any]:
    """Layer ``i``'s weights, int8 ones dequantized to ``dtype`` (one layer
    at a time: the whole tree is never dequantized)."""
    from multiverso_tpu_torch.ops.quantization import maybe_dequantize
    return {k: maybe_dequantize(v.layer(i) if _is_q(v) else v[i], dtype)
            for k, v in layers.items()}


def _moe_exact(y2d: torch.Tensor, pl: Dict[str, Any],
               cfg: TransformerConfig, chunk: int = 64) -> torch.Tensor:
    """Exact top-k MoE for [T, D] tokens (no capacity, nothing dropped):
    each token gathers only its chosen experts' weights, ``chunk``
    positions at a time so the gathered weights stay O(chunk * K * D *
    M)."""
    from multiverso_tpu_torch.parallel.moe import top_k_gates
    t, d = y2d.shape
    c = min(t, chunk)
    pad = (-t) % c
    if pad:
        y2d = torch.cat([y2d, y2d.new_zeros((pad, d))])
    outs = []
    for yc in y2d.reshape(-1, c, d):
        probs = torch.softmax(torch.matmul(yc, pl["moe_router"]).float(), -1)
        gates, topi = top_k_gates(probs, cfg.moe_top_k)
        w1_sel = pl["moe_w1"][topi]                  # [C, K, D, M]
        w2_sel = pl["moe_w2"][topi]
        hmid = F.gelu(torch.einsum("td,tkdm->tkm", yc, w1_sel),
                      approximate="tanh")
        out = torch.einsum("tkm,tkmd->tkd", hmid, w2_sel)
        outs.append((out * gates[..., None].to(out.dtype)).sum(1))
    return torch.cat(outs)[:t]


def _ffn(y: torch.Tensor, pl: Dict[str, Any],
         cfg: TransformerConfig) -> torch.Tensor:
    """The decode path's MLP: dense, or exact top-k MoE routing."""
    if cfg.moe_experts:
        return _moe_exact(y.reshape(-1, y.shape[-1]), pl, cfg
                          ).reshape(y.shape)
    return _mlp(y, pl["w1"], pl["w2"])


def _decode_step(tree, caches: Dict[str, torch.Tensor], tok: torch.Tensor,
                 t: int, cfg: TransformerConfig) -> torch.Tensor:
    """One token through all layers: writes position ``t`` of the KV caches
    ([L, B, H, max_seq, hd], in place) and returns the next logits [B, V]
    f32. Attention runs over every cache slot, the slots after ``t``
    masked to -1e30, as the JAX step does."""
    b = tok.shape[0]
    h, d = cfg.num_heads, cfg.dim
    hd = d // h
    pos = torch.full_like(tok, t)
    x = (_emb_rows(tree["embed"], tok)
         + _emb_rows(tree["pos"], pos)).to(cfg.dtype)        # [B, D]
    live = torch.arange(cfg.max_seq, device=tok.device) <= t
    for i in range(cfg.num_layers):
        pl = _layer_weights(tree["layers"], i, cfg.dtype)
        ck, cv = caches["k"][i], caches["v"][i]
        y = _rmsnorm(x, pl["ln1"])
        q, kk, vv = torch.matmul(y, pl["wqkv"]).split(d, dim=-1)
        ck[:, :, t] = kk.reshape(b, h, hd)
        cv[:, :, t] = vv.reshape(b, h, hd)
        # f32 scores from the cache dtype's values, as JAX's
        # preferred_element_type=f32
        s = torch.einsum("bhd,bhkd->bhk", q.reshape(b, h, hd).float(),
                         ck.float()) / (hd ** 0.5)
        s = torch.where(live, s, torch.full_like(s, _DECODE_NEG_INF))
        pattn = torch.softmax(s, -1).to(cv.dtype)
        o = torch.einsum("bhk,bhkd->bhd", pattn, cv).reshape(b, d)
        x = x + torch.matmul(o, pl["wo"])
        x = x + _ffn(_rmsnorm(x, pl["ln2"]), pl, cfg)
    x = _rmsnorm(x, tree["ln_f"])
    return _tied_logits(x, tree["embed"])


def _new_caches(cfg: TransformerConfig, b: int, device
                ) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, b, cfg.num_heads, cfg.max_seq,
             cfg.dim // cfg.num_heads)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _prefill(tree, prompt: torch.Tensor, cfg: TransformerConfig, total: int,
             batched: bool = True):
    """Validate a decode request, build the KV caches from the prompt and
    return (caches, next-token logits [B, V] f32).

    ``batched=True`` runs one causal pass over all prompt positions
    (:func:`_prefill_pass`); ``batched=False`` feeds the prompt through the
    decode step token by token (the two agree: tested)."""
    b, p = prompt.shape
    if p < 1:
        raise ValueError("prompt must contain at least one token (an "
                         "empty prompt would decode from placeholder "
                         "logits)")
    if total <= p:
        raise ValueError("max_new_tokens must be >= 1")
    if total > cfg.max_seq:
        raise ValueError(f"prompt + new tokens = {total} exceeds "
                         f"max_seq={cfg.max_seq}")
    if cfg.moe_experts and not 1 <= cfg.moe_top_k <= cfg.moe_experts:
        raise ValueError(f"top_k={cfg.moe_top_k} out of range for "
                         f"{cfg.moe_experts} experts")
    caches = _new_caches(cfg, b, prompt.device)
    if batched:
        ks, vs, logits = _prefill_pass(tree, prompt, cfg)
        caches["k"][:, :, :, :p] = ks
        caches["v"][:, :, :, :p] = vs
        return caches, logits
    for i in range(p):
        logits = _decode_step(tree, caches, prompt[:, i], i, cfg)
    return caches, logits


def _prefill_pass(tree, prompt: torch.Tensor, cfg: TransformerConfig):
    """One causal pass over the prompt, capturing each layer's K/V: returns
    (ks [L, B, H, P, hd], vs, last-position logits [B, V] f32). The decode
    step's math batched over positions (dense scores, not the flash
    kernel: the kernel rounds ``p`` at another point, and the tokens must
    be the step's)."""
    b, p = prompt.shape
    h, d = cfg.num_heads, cfg.dim
    hd = d // h
    positions = torch.arange(p, device=prompt.device)
    x = (_emb_rows(tree["embed"], prompt)
         + _emb_rows(tree["pos"], positions)[None]).to(cfg.dtype)  # [B,P,D]
    causal = torch.ones((p, p), dtype=torch.bool,
                        device=prompt.device).tril()
    ks, vs = [], []
    for i in range(cfg.num_layers):
        pl = _layer_weights(tree["layers"], i, cfg.dtype)
        y = _rmsnorm(x, pl["ln1"])
        q, kk, vv = torch.matmul(y, pl["wqkv"]).split(d, dim=-1)
        split = lambda t: t.reshape(b, p, h, hd).transpose(1, 2)
        q, kk, vv = split(q), split(kk), split(vv)           # [B,H,P,hd]
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         kk.float()) / (hd ** 0.5)
        s = torch.where(causal, s, torch.full_like(s, _DECODE_NEG_INF))
        pattn = torch.softmax(s, -1).to(vv.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", pattn, vv)
        o = o.transpose(1, 2).reshape(b, p, d)
        x = x + torch.matmul(o, pl["wo"])
        x = x + _ffn(_rmsnorm(x, pl["ln2"]), pl, cfg)
        ks.append(kk)
        vs.append(vv)
    xl = _rmsnorm(x[:, -1], tree["ln_f"])                    # [B, D]
    return torch.stack(ks), torch.stack(vs), _tied_logits(xl, tree["embed"])


def _as_prompt(prompt, tree) -> torch.Tensor:
    """The prompt as an integer tensor on the parameters' device."""
    dev = tree["ln_f"].device
    if isinstance(prompt, torch.Tensor):
        return prompt.to(dev)
    return torch.as_tensor(np.asarray(prompt), device=dev)


@torch.inference_mode()
def generate(params, prompt, cfg: TransformerConfig, max_new_tokens: int,
             temperature: float = 0.0, key=None, top_p: float = 1.0,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Autoregressive decode with a static KV cache (port of the JAX
    ``generate``): a batched prefill, then one single-token pass per new
    token. Greedy at ``temperature=0.0``, else samples with ``key`` (a
    ``utils.threefry`` key: the same seed draws the same tokens as
    ``jax.random``); ``top_p < 1.0`` keeps the nucleus (the smallest set
    of tokens whose probability mass reaches ``top_p``); with ``eos_id``
    set, a sequence that emits it keeps emitting it.

    ``params`` is a ``Transformer`` or the int8 tree of
    ``ops.quantization.quantize_lm_params`` (weights stay int8 on the
    device and are dequantized one layer at a time). Decoding runs where
    the parameters lie. prompt [B, P] -> [B, P + max_new_tokens] in the
    prompt's integer dtype."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if eos_id is not None and not 0 <= eos_id < cfg.vocab_size:
        raise ValueError(f"eos_id={eos_id} outside vocab of "
                         f"{cfg.vocab_size} (the latch could never fire)")
    if temperature > 0.0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    from multiverso_tpu_torch.utils import threefry

    tree = _decode_tree(params)
    prompt = _as_prompt(prompt, tree)
    b, p = prompt.shape
    caches, logits = _prefill(tree, prompt, cfg, p + max_new_tokens)

    def pick(logits, k):
        if temperature <= 0.0:
            return torch.argmax(logits, -1).to(prompt.dtype)
        logits = logits / temperature
        if top_p < 1.0:
            # nucleus filter: drop the tokens outside the smallest set
            # whose mass reaches top_p (the top token always stays)
            sorted_logits = torch.sort(logits, -1, descending=True).values
            csum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
            cutoff_idx = torch.sum(csum < top_p, -1)
            cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
            logits = torch.where(logits >= cutoff, logits,
                                 torch.full_like(logits, _DECODE_NEG_INF))
        return threefry.categorical(k, logits).to(prompt.dtype)

    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)

    def finish(tok, done):
        """Latch eos: once a row emits it, it keeps emitting it."""
        if eos_id is None:
            return tok, done
        tok = torch.where(done, torch.full_like(tok, eos_id), tok)
        return tok, done | (tok == eos_id)

    k = key if key is not None else threefry.key(0)
    new = []
    for i in range(max_new_tokens):
        k, sub = threefry.split(k)
        tok, done = finish(pick(logits, sub), done)
        new.append(tok)
        # the last token needs only the last logits, not another pass
        if i < max_new_tokens - 1:
            logits = _decode_step(tree, caches, tok, p + i, cfg)
    return torch.cat([prompt, torch.stack(new, 1)], dim=1)


def _top_k_first_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties in index
    order (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def generate_beam(params, prompt, cfg: TransformerConfig,
                  max_new_tokens: int, num_beams: int = 4,
                  return_score: bool = False):
    """Beam-search decode (port of the JAX ``generate_beam``): keep the
    ``num_beams`` highest-logprob continuations per sequence and return
    the best [B, P + max_new_tokens] (with its total continuation log-prob
    [B] when ``return_score``).

    The batch runs expanded to B*W rows on the same KV caches as
    :func:`generate`; each step takes the top W over (beam, token) pairs,
    ties to the lower index as ``lax.top_k``, and reorders the caches
    along the batch dim with one gather. ``num_beams=1`` is greedy."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    tree = _decode_tree(params)
    prompt = _as_prompt(prompt, tree)
    b, p = prompt.shape
    w, v = num_beams, cfg.vocab_size
    dev = prompt.device

    # prefill once per sequence, then fan the caches out to the W beams;
    # the scores start [0, -1e30, ...] so the first expansion picks W
    # distinct tokens from beam 0
    caches, logits = _prefill(tree, prompt, cfg, p + max_new_tokens)
    caches = {n: c.repeat_interleave(w, dim=1) for n, c in caches.items()}
    logits = logits.repeat_interleave(w, dim=0)              # [B*W, V]
    scores = torch.tensor([0.0] + [_DECODE_NEG_INF] * (w - 1),
                          dtype=torch.float32, device=dev).repeat(b, 1)
    toks = torch.zeros((b, w, max_new_tokens), dtype=prompt.dtype,
                       device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    for i in range(max_new_tokens):
        logp = torch.log_softmax(logits, -1).reshape(b, w, v)
        cand = scores[..., None] + logp                      # [B, W, V]
        scores, flat = _top_k_first_index(cand.reshape(b, w * v), w)
        origin = flat // v                                   # [B, W]
        tok = (flat % v).to(prompt.dtype)
        toks = toks[rows, origin]                            # [B, W, T]
        toks[:, :, i] = tok
        # the last token needs only the last logits, not another pass
        if i < max_new_tokens - 1:
            gather = (rows * w + origin).reshape(-1)
            caches = {n: c.index_select(1, gather)
                      for n, c in caches.items()}
            logits = _decode_step(tree, caches, tok.reshape(-1), p + i, cfg)
    best = torch.argmax(scores, -1)                          # [B]
    out = torch.cat([prompt, toks[rows[:, 0], best]], dim=1)
    if return_score:
        return out, scores[rows[:, 0], best]
    return out
