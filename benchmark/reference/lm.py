"""The plain LM step: a GPT-2-shaped decoder in float32, SGD, and the
parameter server's delta-sync merge.

Written from the architecture, not from the program: pre-norm blocks
(RMSNorm), causal softmax attention over 128-wide heads written out as
products, a tanh-GELU MLP of width ``n_inner``, learned positions, the
output projection tied to the embedding, and the mean next-token
cross-entropy. Every product is float32 with TF32 off, or the control's
lower precision (``lowp``). Gradients come from autograd, one sequence at
a time, summed into one float32 gradient per leaf.

The configuration stores its weights in ``torch_dtype`` (bfloat16): each
SGD update and each merged sync is rounded to it, as a stored weight is.
The sync merge is the table's: the table holds the float32 weights of the
last sync, adds the worker's delta (current - last), and the worker reads
the sum back.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from benchmark import traffic
from benchmark.reference import lowp


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def nll_sum(w: Dict[str, torch.Tensor], seq: torch.Tensor, cfg: Dict,
            mode: Optional[str] = None) -> torch.Tensor:
    """Summed next-token negative log-likelihood of ``seq`` [b, s + 1]
    under float32 weights ``w`` (the layout of ``traffic.lm_leaf_shapes``).
    """
    mm = lambda a, b: lowp.matmul(a, b, mode)
    eps = cfg["layer_norm_epsilon"]
    h = cfg["n_head"]
    tok, tgt = seq[:, :-1], seq[:, 1:]
    b, s = tok.shape
    d = cfg["n_embd"]
    hd = d // h
    x = w["embed"][tok] + w["pos"][:s][None]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=x.device).tril_()
    for i in range(cfg["n_layer"]):
        y = _rms(x, w["layers.ln1"][i], eps)
        q, k, v = mm(y, w["layers.wqkv"][i]).split(d, dim=-1)
        q, k, v = (t.reshape(b, s, h, hd).transpose(1, 2) for t in (q, k, v))
        sc = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~causal, float("-inf")), -1)
        o = mm(p, v).transpose(1, 2).reshape(b, s, d)
        x = x + mm(o, w["layers.wo"][i])
        y = _rms(x, w["layers.ln2"][i], eps)
        u = torch.nn.functional.gelu(mm(y, w["layers.w1"][i]),
                                     approximate="tanh")
        x = x + mm(u, w["layers.w2"][i])
    logits = mm(_rms(x, w["ln_f"], eps), w["embed"].t())
    lse = torch.logsumexp(logits, -1)
    return (lse - logits.gather(-1, tgt[..., None])[..., 0]).sum()


def loss_and_grads(w: Dict[str, torch.Tensor], batch: torch.Tensor,
                   cfg: Dict, mode: Optional[str] = None, rows: int = 1):
    """(mean loss, {leaf: float32 gradient}) of one batch [B, S + 1],
    ``rows`` sequences at a time."""
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    n_tok = batch.shape[0] * (batch.shape[1] - 1)
    loss = 0.0
    for r in range(0, batch.shape[0], rows):
        part = nll_sum(leaves, batch[r:r + rows], cfg, mode) / n_tok
        gs = torch.autograd.grad(part, list(leaves.values()))
        for k, g in zip(leaves, gs):
            grads[k] += g
        loss += float(part.detach())
    return loss, grads


def stored(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """``x`` rounded to the configuration's weight dtype, as float32."""
    return x.to(getattr(torch, cfg["torch_dtype"])).float()


def run(cfg: Dict, cell: Dict, seed: int, device, mode: Optional[str] = None,
        half_batch: bool = False) -> Dict:
    """The first three steps of the cell's worker from ``seed``'s weights
    on the pool's first three batches; then, in a cell that syncs, the
    sync that its set-up makes after the third step. Returns the readings
    that ``check`` holds the program's against: each step's loss, each
    leaf's norm of the first gradient as SGD's state shows it,
    (w0 - w1) / lr, and of the change of the weights after the three
    steps. ``half_batch`` plants the fault
    of a step that leaves half of its batch out."""
    tr = cell["traffic"]
    dtype = getattr(torch, cfg["torch_dtype"])
    lr = torch.tensor(tr["lr"], dtype=dtype).item()
    with torch.no_grad(), lowp.strict_float32():
        w0 = {k: v.float() for k, v in traffic.lm_weights(
            cfg, seed, device, dtype).items()}
        pool = traffic.lm_batches(cfg, tr, seed, device)
    w = {k: v.clone() for k, v in w0.items()}
    losses: List[float] = []
    grad_norm: Dict[str, float] = {}
    with lowp.strict_float32():
        for i in range(3):
            batch = pool[i]
            if half_batch:
                batch = batch[: batch.shape[0] // 2]
            loss, g = loss_and_grads(w, batch, cfg, mode)
            losses.append(loss)
            with torch.no_grad():
                w = {k: stored(w[k] - lr * g[k], cfg) for k in w}
                if i == 0:
                    grad_norm = {k: float((w0[k] - w[k]).norm() / lr)
                                 for k in w}
            del g
        with torch.no_grad():
            if tr["sync_every"]:
                # a syncing cell's set-up syncs after its third step; the
                # table holds w0 (the master's add onto zeros)
                w = {k: stored(w0[k] + (w[k] - w0[k]), cfg) for k in w}
            change = {k: float((w[k] - w0[k]).norm()) for k in w}
    return {"loss": losses, "grad": grad_norm, "change": change}
