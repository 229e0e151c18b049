"""Decoder-only transformer LM, forward and training step (port of the
dense, single-device part of ``multiverso_tpu/models/transformer.py``).

The parameters keep the JAX package's layout: per-layer weights are
stacked on a leading layer dimension (``layers.wqkv`` is [L, D, 3D], ...),
so ``params_from_jax`` / ``params_to_numpy`` carry one package's
``init_params`` tree to the other unchanged, and ``SharedPytree`` flattens
both into the same vector. ``attn="flash"`` runs the port's flash
attention (the CUDA kernels on the card, forward and backward),
``attn="local"`` the plain ``reference_attention``.

``forward``, ``loss_fn`` and ``make_train_step`` are differentiable with
autograd; a caller that only scores wraps them in ``torch.no_grad()`` or
``torch.inference_mode()``. ``remat=True`` recomputes each layer in the
backward (``torch.utils.checkpoint``). Decoding, the optax-style step, the
parallel axes and MoE arrive with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multiverso_tpu_torch.ops.attention_kernels import flash_attention
from multiverso_tpu_torch.parallel import ring


class TransformerConfig(NamedTuple):
    vocab_size: int = 256
    dim: int = 128
    num_heads: int = 4
    num_layers: int = 2
    max_seq: int = 512
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    attn: str = "flash"   # "flash" | "local" in this slice
    seq_axis: Optional[str] = None
    batch_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    remat: bool = False
    moe_experts: int = 0


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice that brings what the
    config asks for."""
    if cfg.attn not in ("flash", "local"):
        raise NotImplementedError(
            f"attn={cfg.attn!r} (sequence parallelism) arrives with the "
            f"parallel-layers slice; this slice has 'flash' and 'local'")
    if cfg.seq_axis or cfg.batch_axis or cfg.tp_axis:
        raise NotImplementedError(
            "mesh axes arrive with the parallel-layers slice")
    if cfg.moe_experts:
        raise NotImplementedError("MoE MLPs arrive with the parallel-layers "
                                  "slice")


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
        "w1": norm(L, d, m, scale=s),
        "w2": norm(L, m, d, scale=np.sqrt(1.0 / m) / np.sqrt(2 * L)),
    }
    return {
        "embed": norm(cfg.vocab_size, d, scale=0.02),
        "pos": norm(cfg.max_seq, d, scale=0.02),
        "layers": layers,
        "ln_f": np.ones((d,), np.float32),
    }


def _param(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))


class _Layers(nn.Module):
    """The layer stack's weights, stacked on a leading layer dimension."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        L, d = cfg.num_layers, cfg.dim
        m = cfg.mlp_ratio * d
        self.wqkv = _param((L, d, 3 * d), cfg, device)
        self.wo = _param((L, d, d), cfg, device)
        self.ln1 = _param((L, d), cfg, device)
        self.ln2 = _param((L, d), cfg, device)
        self.w1 = _param((L, d, m), cfg, device)
        self.w2 = _param((L, m, d), cfg, device)


class Transformer(nn.Module):
    """Dense LM; parameter names and shapes follow the JAX tree."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        check_supported(cfg)
        if cfg.dim % cfg.num_heads:
            raise ValueError(f"dim {cfg.dim} not divisible by "
                             f"num_heads {cfg.num_heads}")
        self.cfg = cfg
        d = cfg.dim
        self.embed = _param((cfg.vocab_size, d), cfg, device)
        self.pos = _param((cfg.max_seq, d), cfg, device)
        self.ln_f = _param((d,), cfg, device)
        self.layers = _Layers(cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), -1, keepdim=True)
    # rsqrt cast to x's dtype before the multiply, as the JAX model does
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * g


def _attention(cfg: TransformerConfig, q, k, v) -> torch.Tensor:
    if cfg.attn == "local":
        return ring.reference_attention(q, k, v, causal=True)
    # the kernel picks its own tile; no TPU block-size rule here
    return flash_attention(q, k, v, causal=True)


def _layer(cfg: TransformerConfig, x: torch.Tensor, wqkv, wo, ln1, ln2, w1,
           w2) -> torch.Tensor:
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    y = _rmsnorm(x, ln1)
    q, k, v = torch.matmul(y, wqkv).split(d, dim=-1)
    # [B, S, D] -> [B, H, S, hd]
    split = lambda t: t.reshape(b, s, h, hd).transpose(1, 2)
    o = _attention(cfg, split(q), split(k), split(v))
    o = o.transpose(1, 2).reshape(b, s, d)
    x = x + torch.matmul(o, wo)
    y = _rmsnorm(x, ln2)
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(torch.matmul(y, w1), approximate="tanh")
    return x + torch.matmul(y, w2)


def forward(params: Transformer, tokens: torch.Tensor,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V]; ``cfg`` defaults to the model's
    (it may differ in ``attn`` and ``remat``, not in shapes)."""
    cfg = cfg or params.cfg
    s = tokens.shape[1]
    x = params.embed[tokens] + params.pos[:s][None]
    ls = params.layers
    # one unbind per stacked leaf, as the JAX scan slices it: its backward
    # stacks the layers' gradients once, where indexing [i] would add L
    # full-size zero-padded gradients into each leaf
    per_layer = zip(*(t.unbind(0) for t in (ls.wqkv, ls.wo, ls.ln1, ls.ln2,
                                            ls.w1, ls.w2)))
    for weights in per_layer:
        if cfg.remat:
            # recompute the layer in the backward (jax.checkpoint in JAX)
            x = checkpoint(_layer, cfg, x, *weights, use_reentrant=False)
        else:
            x = _layer(cfg, x, *weights)
    return _lm_head(x, params.ln_f, params.embed)


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


def loss_fn(params: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (f32); ``targets`` is tokens shifted
    by one, ``mask`` zeroes padding positions."""
    return _nll(forward(params, tokens, cfg), targets, mask)


def make_train_step(cfg: TransformerConfig, learning_rate: float = 1e-2):
    """Plain-SGD step ``(model, tokens, targets) -> loss`` (port of the JAX
    ``make_train_step``).

    Autograd computes the gradients of ``loss_fn``; then, under
    ``no_grad``, each parameter is updated in place as ``p -= lr * g`` with
    ``lr`` first cast to the parameter's dtype, as
    ``jnp.asarray(learning_rate, p.dtype)`` does (in bf16, 1e-2 becomes
    0.010009765625). The in-place update stands in for the JAX step's
    donation of ``params`` (``donate_argnums=(0,)``): the weights are
    written where they lie, and the caller's model is the updated one.
    """
    def step(model: Transformer, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        params = list(model.parameters())
        loss = loss_fn(model, tokens, targets, cfg=cfg)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                lr = torch.tensor(learning_rate, dtype=p.dtype).item()
                p.sub_(g * lr)
        return loss.detach()

    return step


def _paths(model: Transformer):
    for name, p in model.named_parameters():
        yield name.split("."), p


@torch.no_grad()
def load_params_(model: Transformer, tree: Dict[str, Any]) -> Transformer:
    """Write the JAX-layout numpy tree ``tree`` (stacked [L, ...] layer
    leaves) into ``model``'s parameters in place, cast to their dtype."""
    for path, p in _paths(model):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        arr = np.asarray(leaf, dtype=np.float32)
        if not arr.flags.writeable:   # arrays handed out by jax
            arr = arr.copy()
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{'.'.join(path)}: shape {arr.shape} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(arr))
    return model


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device=None) -> Transformer:
    """Build the port's model from the JAX ``init_params`` tree given as
    numpy arrays (stacked [L, ...] layer leaves), cast to ``cfg.dtype``."""
    return load_params_(Transformer(cfg, device), tree)


@torch.no_grad()
def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX-layout numpy tree (bf16 leaves
    come back as float32, exactly)."""
    tree: Dict[str, Any] = {}
    for path, p in _paths(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        t = p.detach().cpu()
        node[path[-1]] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
