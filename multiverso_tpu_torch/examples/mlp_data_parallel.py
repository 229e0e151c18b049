"""Data-parallel MLP with delta-sync shared parameters (port of
``examples/mlp_data_parallel.py``).

The reference's Theano examples (binding/python/examples/theano/
logistic_regression.py and cnn.py) wrap a local training loop with
``mv_shared``/``mv_sync`` so N workers train ASGD with their deltas merged
through an ArrayTable. Here the local loop is plain SGD in PyTorch and the
wrap is ``sharedvar.mv_shared``: one process a worker, each drawing its
own data (``seed=worker_id()``), and every ``sync()`` merges the workers'
deltas through the shared table. One process alone trains local SGD.

The processes meet as a launcher starts them: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` in the environment, read by
``init()`` (or call ``net_init`` first). The weights are the JAX
example's: ``jax.random.normal`` drawn through ``utils/threefry``.

Run: python -m multiverso_tpu_torch.examples.mlp_data_parallel
         [--device cpu] [--epochs 6]
"""

from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.models.logreg import synthetic_dataset
from multiverso_tpu_torch.sharedvar import mv_shared
from multiverso_tpu_torch.utils import threefry

SIZES = (32, 64, 5)
LR = 0.1
SYNC_EVERY, BATCH = 8, 256


def init_mlp(seed: int = 0, sizes=SIZES) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX example's ``init_mlp(jax.random.key(seed), sizes)``: layer
    i's weights ``normal * sqrt(2 / fan_in)`` from the i-th split of the
    key chain, zero biases. Keyed ``l0``, ``l1``, ... so the shared
    table's flat layout is the JAX list's (biases before weights)."""
    params = {}
    key = threefry.key(seed)
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        k1, key = threefry.split(key)
        w = threefry.normal(k1, (a, b)) * np.float32(np.sqrt(2.0 / a))
        params[f"l{i}"] = {"w": w.numpy(),
                           "b": np.zeros((b,), np.float32)}
    return params


def apply_mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x
    layers = [params[k] for k in sorted(params)]
    for layer in layers[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ layers[-1]["w"] + layers[-1]["b"]


def _tensors(tree: Dict, dev) -> Dict:
    return {k: {n: torch.as_tensor(v, device=dev) for n, v in d.items()}
            for k, d in tree.items()}


def main(epochs: int = 6, device=None) -> List[float]:
    """The JAX example's run; returns each epoch's last batch loss."""
    mv.init(device=device)
    dev = mv.device()
    try:
        x, y = synthetic_dataset(4096, 32, 5, seed=mv.worker_id())
        xt, yt = synthetic_dataset(1024, 32, 5, seed=100)
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(
            y.astype(np.int64)).to(dev)
        xt = torch.from_numpy(xt).to(dev)
        shared = mv_shared(init_mlp(0), name="mlp_params")
        params = _tensors(shared.get(), dev)

        def step(params, xb, yb):
            p = {k: {n: v.detach().requires_grad_() for n, v in d.items()}
                 for k, d in params.items()}
            loss = F.cross_entropy(apply_mlp(p, xb), yb)
            leaves = [v for d in p.values() for v in d.values()]
            grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            return ({k: {n: (v - LR * next(it)).detach()
                         for n, v in d.items()} for k, d in p.items()},
                    loss.detach())

        losses = []
        for epoch in range(epochs):
            for i in range(0, len(y), BATCH):
                params, loss = step(params, x[i:i + BATCH], y[i:i + BATCH])
                if (i // BATCH) % SYNC_EVERY == SYNC_EVERY - 1:
                    params = _tensors(shared.sync(params), dev)  # ASGD
            params = _tensors(shared.sync(params), dev)
            with torch.no_grad():
                pred = apply_mlp(params, xt).argmax(-1).cpu().numpy()
            acc = float(np.mean(pred == yt))
            losses.append(float(loss))
            print(f"epoch {epoch}: loss {losses[-1]:.4f}  test acc "
                  f"{acc:.4f}", flush=True)
    finally:
        mv.shutdown()
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted")
    args = ap.parse_args()
    main(args.epochs, args.device)
