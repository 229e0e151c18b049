"""Transformer LM trained through the parameter server (port of
``examples/transformer_ps.py``).

The LM's whole parameter tree lives in one ArrayTable (``SharedPytree``).
The worker trains locally with plain-SGD steps (on the card, attention
forward and backward are the port's CUDA kernels) and every
``sync_every`` steps delta-syncs: Add(current - last), then Get, and the
merged parameters are written back into the model in place.

Run: python -m multiverso_tpu_torch.examples.transformer_ps [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.models import transformer as tfm
from multiverso_tpu_torch.sharedvar import SharedPytree


def train_ps(model: tfm.Transformer, shared: SharedPytree,
             tokens: torch.Tensor, targets: torch.Tensor, steps: int,
             sync_every: int, lr: float,
             step_fn: Optional[Callable] = None) -> List[float]:
    """``steps`` SGD steps on one batch, delta-syncing the model through
    ``shared`` after every ``sync_every``-th step; returns each step's
    loss. ``step_fn`` defaults to ``make_train_step(model.cfg, lr)``."""
    step = step_fn or tfm.make_train_step(model.cfg, lr)
    losses = []
    for i in range(steps):
        losses.append(float(step(model, tokens, targets)))
        if (i + 1) % sync_every == 0:
            # push local progress, pull the merged global state
            tfm.load_params_(model, shared.sync(model))
            mv.log.info("step %d, loss %.4f (synced)", i + 1, losses[-1])
    return losses


def main(steps: int = 40, sync_every: int = 5, device=None) -> float:
    """The JAX example's run: its tiny LM, seed, batch and learning rate.
    Runs on the card unless ``device="cpu"``; returns the final loss."""
    mv.init(device=device)
    try:
        cfg = tfm.TransformerConfig(vocab_size=64, dim=32, num_heads=4,
                                    num_layers=2, max_seq=32, attn="flash")
        shared = SharedPytree(tfm.init_params(cfg, seed=0), name="lm_params")
        model = tfm.params_from_jax(shared.get(), cfg, mv.device())
        toks = np.random.default_rng(0).integers(0, 64, (8, 33))
        toks = torch.from_numpy(toks.astype(np.int32)).to(mv.device())
        losses = train_ps(model, shared, toks[:, :-1], toks[:, 1:], steps,
                          sync_every, 0.3)
    finally:
        mv.shutdown()
    print(f"transformer-PS ok: final loss {losses[-1]:.4f} "
          f"(delta-sync every {sync_every} steps)")
    return losses[-1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--sync-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args()
    main(args.steps, args.sync_every, args.device)
