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
backward (``torch.utils.checkpoint``). ``make_optim_train_step`` is the
counterpart of the JAX ``make_optax_train_step``: one step of any
``torch.optim`` optimizer. ``generate`` and ``generate_beam`` decode with a
static KV cache ([L, B, H, max_seq, hd] in ``cfg.dtype``; dense attention
over it, as the JAX decode does, not the flash kernel), from a
``Transformer`` or the int8 tree of ``ops.quantization.quantize_lm_params``.
The parallel axes and MoE arrive with later slices.
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
    return x + _mlp(_rmsnorm(x, ln2), w1, w2)


def _mlp(y: torch.Tensor, w1, w2) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return torch.matmul(F.gelu(torch.matmul(y, w1), approximate="tanh"), w2)


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


def make_optim_train_step(cfg: TransformerConfig,
                          optimizer: torch.optim.Optimizer):
    """One step of any ``torch.optim`` optimizer over a ``Transformer``:
    ``(model, tokens, targets) -> loss`` (port of the JAX
    ``make_optax_train_step``).

    The JAX step is ``(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` for an optax ``GradientTransformation`` initialized
    with ``optimizer.init(params)``. Here the parameters are the model's
    own, and the optimizer, built over ``model.parameters()`` by the
    caller, holds its state (``optimizer.state``) and updates the
    parameters in place. So the step takes the model and the batch, and
    returns only the loss (detached): the loss of ``loss_fn``, its
    backward (through the flash autograd function with
    ``attn="flash"``), ``optimizer.step()``, then ``zero_grad``.

    The hyperparameters' defaults differ between the libraries
    (``optax.adamw``'s weight decay is 1e-4, ``torch.optim.AdamW``'s is
    1e-2): pass each one explicitly. The update rules agree: optax's
    ``sgd(lr, momentum)`` is ``torch.optim.SGD(lr, momentum)`` (no
    dampening, no Nesterov), ``adam`` and ``adamw`` are ``Adam`` and
    ``AdamW`` (bias correction, eps outside the square root, decoupled
    decay), with the state in the parameters' dtype in both."""
    def step(model: Transformer, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        loss = loss_fn(model, tokens, targets, cfg=cfg)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
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


def param_tree(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX-layout tree of its own tensors
    (detached, on its device, in its dtype): what ``generate`` reads, and
    what ``ops.quantization.quantize_lm_params`` quantizes."""
    tree: Dict[str, Any] = {}
    for path, p in _paths(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach()
    return tree


@torch.no_grad()
def params_to_numpy(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX-layout numpy tree (bf16 leaves
    come back as float32, exactly)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        t = node.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return host(param_tree(model))


# ---------------------------------------------------------------------- #
# decoding: KV-cache generate and beam search (dense configs)
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
        x = x + _mlp(_rmsnorm(x, pl["ln2"]), pl["w1"], pl["w2"])
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
    check_supported(cfg)
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
        x = x + _mlp(_rmsnorm(x, pl["ln2"]), pl["w1"], pl["w2"])
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
