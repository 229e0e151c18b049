"""ResNet-CIFAR trainer with every parameter in one Adam ArrayTable (port of
``multiverso_tpu/apps/resnet_cifar.py``).

The reference's workload: Torch fb.resnet ResNet-18 / Lasagne ResNet-32 on
CIFAR-10 with all parameters in one Multiverso ArrayTable (ref
binding/lua/docs/BENCHMARK.md, binding/python/docs/BENCHMARK.md). Here:

* the flattened parameter vector lives in one ``ArrayTable`` with the
  server-side **Adam** updater, in the JAX package's flat order
  (``models.resnet.flatten_params``);
* an epoch is a loop of steps on the table's state on the device: the
  tree is a set of views into the flat vector, autograd's backward fills
  the whole flat gradient, and ``functional_add`` applies Adam in place;
  ``adopt`` commits at the end, and the losses stay on the device until
  one readback per :meth:`ResNetTrainer.train` call;
* BatchNorm running stats stay with the worker, as in the reference;
* on a table sharded over the world's ranks the trainer is data-parallel,
  as the JAX app splits each batch over its mesh axis (``P(None,
  axis)``): every rank passes the same images, trains its rows of each
  batch with BatchNorm's moments summed over the ranks
  (``collectives.sum_over``), reduce-scatters the flat gradient to the
  blocks, applies Adam to its block and gathers the flat vector for the
  next step; the BN running stats come out equal on every rank.

Usage: ``python -m multiverso_tpu_torch.apps.resnet_cifar -depth 20
-epochs 2 [-device=cpu]`` (synthetic CIFAR).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import multiverso_tpu_torch as mv
from multiverso_tpu_torch.models import resnet as resnet_lib
from multiverso_tpu_torch.parallel.collectives import (raw_all_reduce,
                                                       raw_reduce_scatter)
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import config as config_lib
from multiverso_tpu_torch.utils import log


class ResNetTrainer:
    """``init`` is an optional (flat vector, BN state) pair, e.g. from
    ``models.resnet.resnet_from_jax``; without it the port's own
    ``init_resnet(seed)`` draws the start."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 image_size: int = 32, batch_size: int = 128,
                 learning_rate: float = 1e-3, seed: int = 0,
                 init: Optional[Tuple[np.ndarray, Dict]] = None):
        if not mv.Zoo.get().started:
            mv.init()
        self.device = mv.device()
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        params, bn = resnet_lib.init_resnet(seed, depth=depth,
                                            num_classes=num_classes)
        flat, self._meta = resnet_lib.flatten_params(params)
        if init is not None:
            flat, bn = init
            if flat.size != sum(int(np.prod(s)) for _, s in self._meta):
                raise ValueError(f"init vector of {flat.size} values does "
                                 f"not fit depth {depth}")
        self.n_params = flat.size
        self.table = mv.ArrayTable(flat.size, updater="adam", init=flat,
                                   name=f"resnet{depth}_params")
        self.bn = resnet_lib.bn_to_device(bn, self.device)
        mesh, axis, n, _ = self.table.sharding
        # the (mesh, axis) whose ranks split each batch, or None
        self._shards = (mesh, axis) if n > 1 else None

    def _batches(self, x, y):
        """The epoch's batches on the device: [nb, B, H, W, C] and [nb, B];
        the remainder of ``len(y) % batch_size`` is dropped. ``x`` and
        ``y`` may be numpy arrays or tensors already on the device (a
        caller that trains many times uploads once, as bench_resnet
        does); those are not copied."""
        b = self.batch_size
        n = (len(y) // b) * b
        xb = torch.as_tensor(x[:n], device=self.device)
        yb = torch.as_tensor(y[:n], device=self.device).long()
        return (xb.reshape(-1, b, *x.shape[1:]), yb.reshape(-1, b))

    def step(self, state: Dict, x: torch.Tensor, y: torch.Tensor,
             opt: AddOption) -> torch.Tensor:
        """One step on the table state: loss and flat gradient at the
        state's weights, then the Adam apply in place. Returns the loss
        (on the device). On a sharded table ``x`` and ``y`` are this
        rank's rows of the batch and ``state`` its block: the flat vector
        is gathered, the loss is the rows' mean, and the gradient of the
        ranks' mean loss reaches the block through the Add's
        reduce-scatter."""
        whole = self.table.unshard(state["data"])
        flat = whole[: self.n_params].detach().requires_grad_()
        params = resnet_lib.unflatten_params(flat, self._meta)
        loss, self.bn = resnet_lib.loss_fn(params, self.bn, x, y, train=True,
                                           shards=self._shards)
        if self._shards is None:
            loss.backward()
        else:
            (loss / self.table.sharding.num_shards).backward()
        with torch.no_grad():
            delta = self.table.pad_delta(flat.grad)
            if self._shards is not None:
                delta = raw_reduce_scatter(delta, *self._shards)
            self.table.functional_add(state, delta, opt)
        return loss.detach()

    def train(self, x, y, epochs: int = 1) -> Dict[str, float]:
        """``epochs`` passes over (x, y) (numpy, or tensors on the
        device). On a sharded table every rank passes the same (x, y)
        (``ValueError`` otherwise, on every rank) and trains rows ``[r B
        / N, (r + 1) B / N)`` of each batch of B, r its index on the
        table axis of N ranks (B % N != 0: ``ValueError``); the loss is
        the whole batches' mean."""
        n_shards = self.table.sharding.num_shards
        if self.batch_size % n_shards:
            raise ValueError(f"batch {self.batch_size} does not split over "
                             f"the table axis's {n_shards} ranks")
        self.table.require_same_inputs("ResNetTrainer.train", x, y)
        xb, yb = self._batches(x, y)
        images = yb.numel() * epochs
        if self._shards is not None:
            part = self.batch_size // n_shards
            lo = self._shards[0].index(self._shards[1]) * part
            xb, yb = xb[:, lo:lo + part], yb[:, lo:lo + part]
        opt = AddOption(learning_rate=self.learning_rate)
        state = self.table.state
        t0 = time.perf_counter()
        losses = []
        for _ in range(epochs):
            for i in range(xb.shape[0]):
                losses.append(self.step(state, xb[i], yb[i], opt))
        # the losses of the last epoch, read back once (the device drains)
        last = torch.stack(losses[-xb.shape[0]:])
        if self._shards is not None:
            last = raw_all_reduce(last, *self._shards) / n_shards
        loss = float(torch.mean(last))
        dt = time.perf_counter() - t0
        self.table.adopt(state)
        return {"loss": loss, "images_per_sec": images / dt, "seconds": dt,
                "sec_per_epoch": dt / epochs}

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray) -> float:
        """Accuracy on (x, y) with the running stats. On a sharded table
        every rank passes the same (x, y) and reads the gathered flat
        vector: the same accuracy on every rank."""
        self.table.require_same_inputs("ResNetTrainer.evaluate", x, y)
        params = resnet_lib.unflatten_params(
            self.table.unshard(self.table.state["data"])[: self.n_params],
            self._meta)
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        logits, _ = resnet_lib.apply_resnet(params, self.bn, xt, train=False)
        yt = torch.from_numpy(np.asarray(y, np.int64)).to(self.device)
        return float(torch.mean((torch.argmax(logits, -1) == yt).float()))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # "-key=value" entries are runtime flags (-device=cpu among them); the
    # app's own keys are "-key value" pairs
    argv = config_lib.consume_runtime_flags(argv)
    kw = {}
    i = 0
    while i < len(argv) - 1:
        if argv[i].startswith("-"):
            kw[argv[i].lstrip("-")] = argv[i + 1]
            i += 2
        else:
            i += 1
    depth = int(kw.get("depth", 20))
    epochs = int(kw.get("epochs", 1))
    batch = int(kw.get("batch_size", 128))
    n = int(kw.get("num_samples", 2048))
    mv.init()
    trainer = ResNetTrainer(depth=depth, batch_size=batch)
    x, y = resnet_lib.synthetic_cifar(n, seed=1)
    stats = trainer.train(x, y, epochs=epochs)
    log.info("resnet%d train: %s", depth, stats)
    xt, yt = resnet_lib.synthetic_cifar(512, seed=2)
    log.info("eval accuracy: %.4f", trainer.evaluate(xt, yt))
    mv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
