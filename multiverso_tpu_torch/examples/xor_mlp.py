"""XOR MLP, data-parallel through a shared table: the reference's Lua demo
(port of the repo's ``examples/xor_mlp.py``).

A tiny 2-4-1 MLP learns XOR while every worker pushes parameter deltas to
(and pulls parameters from) one shared ArrayTable through the handler
surface the reference's Lua/Torch FFI binding exposes (ref
binding/lua/ArrayTableHandler.lua; demo loop in
demos/xor/xor_multiverso.lua). The handler layer is
``multiverso_tpu_torch.handlers`` and the math is torch's autograd on the
Zoo's device. Run one process per worker for data parallelism (a
launcher's environment), or one process for the smoke test below.

Run: python -m multiverso_tpu_torch.examples.xor_mlp [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.handlers import ArrayTableHandler

X = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], np.float32)
Y = np.array([[0], [1], [1], [0]], np.float32)

SIZES = [(2, 4), (4,), (4, 1), (1,)]  # w1, b1, w2, b2
TOTAL = sum(int(np.prod(s)) for s in SIZES)
LR, SYNC_FREQUENCY, ROUNDS = 0.5, 50, 20


def unflatten(flat: torch.Tensor) -> List[torch.Tensor]:
    out, i = [], 0
    for s in SIZES:
        n = int(np.prod(s))
        out.append(flat[i: i + n].reshape(s))
        i += n
    return out


def forward(flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    w1, b1, w2, b2 = unflatten(flat)
    h = torch.tanh(x @ w1 + b1)
    return torch.sigmoid(h @ w2 + b2)


def loss_fn(flat: torch.Tensor, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    p = forward(flat, x)
    return -torch.mean(y * torch.log(p + 1e-7)
                       + (1 - y) * torch.log(1 - p + 1e-7))


def local_rounds(flat: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """SYNC_FREQUENCY local gradient steps between table syncs (the LR
    app's bounded-staleness pattern)."""
    f = flat.detach().clone()
    for _ in range(SYNC_FREQUENCY):
        f.requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(f, x, y), f)
        f = (f - LR * g).detach()
    return f


def train(device=None) -> Tuple[List[Tuple[int, float]], List[int]]:
    """One worker's run: returns the printed (round, loss) pairs and the
    final predictions."""
    mv.init(device=device)
    dev = mv.device()
    rng = np.random.default_rng(mv.worker_id())
    init = rng.normal(0, 0.5, TOTAL).astype(np.float32)
    # master-init convention (ref tables.py:50-57): worker 0 pushes the
    # initial weights, the rest push zeros
    params = ArrayTableHandler(TOTAL, init_value=init, name="xor_params")
    x, y = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
    losses = []
    for r in range(ROUNDS):
        flat = torch.from_numpy(params.get()).to(dev)
        new = local_rounds(flat, x, y)
        # push the *delta*; the server-side default updater adds it
        params.add(new - flat)
        if r % 5 == 0:
            loss = float(loss_fn(new, x, y))
            losses.append((r, loss))
            print(f"round {r:3d} loss {loss:.4f}")
    flat = torch.from_numpy(params.get()).to(dev)
    pred = forward(flat, x).round().to(torch.int64).reshape(-1).cpu()
    mv.shutdown()
    return losses, pred.tolist()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    _, pred = train(args.device)
    print("prediction:", pred, "target:", Y.ravel().astype(int).tolist())
    ok = pred == Y.ravel().astype(int).tolist()
    print("XOR", "SOLVED" if ok else "NOT SOLVED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
