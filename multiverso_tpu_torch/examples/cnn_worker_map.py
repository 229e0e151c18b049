"""Small CNN trained BSP data-parallel via ``worker_step`` (port of
``examples/cnn_worker_map.py``).

The reference's Theano CNN example (binding/python/examples/theano/
cnn.py, MNIST with params synced through Multiverso): each worker is one
rank of a ``torch.distributed`` world that this script spawns, takes its
batch shard, and the workers' gradients meet in one all-reduce mean
before the table's SGD updater applies the merged step.

Run: python -m multiverso_tpu_torch.examples.cnn_worker_map
         [--device cpu] [--world 4] [--mnist DIR]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# the JAX example's widths: conv 3x3 1->16 (stride 2), 3x3 16->32
# (stride 2), mean pool, dense 32 -> classes
SHAPES = {"conv1": (16, 1, 3, 3), "conv2": (32, 16, 3, 3),
          "dense": (32, 10), "bias": (10,)}
SCALES = {"conv1": 0.2, "conv2": 0.1, "dense": 0.1, "bias": 0.0}


def init_cnn(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([
        (rng.normal(size=s) * SCALES[k]).astype(np.float32).reshape(-1)
        for k, s in SHAPES.items()])


def unflatten(v):
    out, off = {}, 0
    for k, s in SHAPES.items():
        n = int(np.prod(s))
        out[k] = v[off:off + n].reshape(s)
        off += n
    return out


def apply_cnn(p, x):
    """x [N, 1, H, W] -> logits [N, classes]."""
    import torch.nn.functional as F
    h = F.relu(F.conv2d(x, p["conv1"], stride=2, padding=1))
    h = F.relu(F.conv2d(h, p["conv2"], stride=2, padding=1))
    return h.mean(dim=(2, 3)) @ p["dense"] + p["bias"]


def data(mnist_dir: str = "", n: int = 4096):
    """(x [N, 1, S, S], y [N]) float32/int64: MNIST when the directory
    holds it, else a seeded synthetic set (grayscale synthetic CIFAR)."""
    if mnist_dir:
        from multiverso_tpu_torch.io import mnist
        if mnist.available(mnist_dir):
            x, y = mnist.load(mnist_dir, flatten=False)
            return (x[:n].reshape(-1, 1, 28, 28).astype(np.float32),
                    y[:n].astype(np.int64))
    from multiverso_tpu_torch.models.resnet import synthetic_cifar
    x, y = synthetic_cifar(n, size=16, classes=10, seed=0)
    x = x.mean(axis=-1)[:, None]              # grayscale, NCHW
    return x.astype(np.float32), y.astype(np.int64)


def rank_main(rank: int, world: int, device, epochs: int, mnist_dir: str,
              batch: int):
    import torch
    import torch.nn.functional as F
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.parallel import worker_map
    mesh = worker_map.make_worker_mesh(world, device=device)
    mv.init(device=device, mesh=mesh)
    try:
        x, y = data(mnist_dir)
        flat = init_cnn(0)
        table = mv.ArrayTable(flat.size, updater="sgd", init=flat,
                              name="cnn")
        n, i = mesh.axis_size("worker"), mesh.index("worker")

        def grad_fn(params, b):
            bx, by = b
            p = {k: v.detach().requires_grad_()
                 for k, v in unflatten(params[:flat.size]).items()}
            loss = F.cross_entropy(apply_cnn(p, bx), by)
            grads = torch.autograd.grad(loss, list(p.values()))
            g = torch.zeros_like(params)
            g[:flat.size] = torch.cat([t.reshape(-1) for t in grads])
            return loss.detach(), g

        step = worker_map.worker_step(table, grad_fn, learning_rate=0.2)
        state = table.state
        dev = state["data"].device
        per = batch // n
        losses = []
        for epoch in range(epochs):
            tot, nb = 0.0, 0
            for s in range(0, len(y) - batch + 1, batch):
                lo = s + i * per
                b = (torch.from_numpy(x[lo:lo + per]).to(dev),
                     torch.from_numpy(y[lo:lo + per]).to(dev))
                state, loss = step(state, b)
                tot, nb = tot + float(loss), nb + 1
            losses.append(tot / nb)
            if rank == 0:
                print(f"epoch {epoch}: loss {losses[-1]:.4f}", flush=True)
        table.adopt(state)
        p = unflatten(torch.as_tensor(table.get(), device=dev))
        with torch.no_grad():
            pred = apply_cnn(p, torch.from_numpy(x[:1024]).to(dev))
        acc = float((pred.argmax(-1).cpu().numpy() == y[:1024]).mean())
    finally:
        mv.shutdown()
    return losses, acc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--mnist", default="")
    args = ap.parse_args(argv)
    from multiverso_tpu_torch.parallel.mesh import spawn
    out = spawn(rank_main, args.world, args.device,
                (args.epochs, args.mnist, args.batch))
    losses, acc = out[0]
    assert all(o[0] == losses for o in out), "workers disagree"
    print(f"{args.world} workers; train accuracy: {acc:.4f}; losses "
          f"{[round(v, 4) for v in losses]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
