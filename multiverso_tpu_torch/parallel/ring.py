"""Attention oracle (port of ``reference_attention`` from
``multiverso_tpu/parallel/ring.py``). The ring, zigzag and Ulysses
schemes of that module arrive with the multi-card slice."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Unsharded softmax attention over [B, H, S, D]: scores and softmax in
    f32 whatever the input dtype, ``p`` cast to ``v``'s dtype before
    ``p @ v``, output in ``v``'s dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
