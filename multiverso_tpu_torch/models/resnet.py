"""CIFAR ResNet (6n+2 layout) as plain functions on tensors (port of
``multiverso_tpu/models/resnet.py``).

The parameter tree keeps the JAX package's layout: convolution weights
HWIO, the head [C, classes], BatchNorm state per block. Its flat order is
``jax.tree.flatten``'s (dict keys sorted: ``blocks`` with each block's
``conv1``, ``conv2``, ``proj``; ``head_b``; ``head_w``; ``stem``), so the
flat vectors of the two packages compare directly and a table's
``store``/``load`` interoperate. Activations come in NHWC, as in JAX; they
are viewed as NCHW with channels-last strides (no copy; on the CPU they
are made contiguous NCHW) and the weights as OIHW only at ``F.conv2d``.

Two points where PyTorch's defaults are not XLA's:

* SAME padding at stride 2 on an even input pads (0, 1), not (1, 1): the
  shape is the same, the values are not. :func:`_conv` pads with XLA's
  rule (the larger half after) and then runs an unpadded convolution.
* BatchNorm in training normalizes with the biased variance and updates
  the running variance with it too (``F.batch_norm`` would update it with
  the unbiased one), so mean, variance and the running update are
  computed here, in the JAX order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, Any]


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of NCHW ``x`` with the HWIO weight ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    w = w.permute(3, 2, 0, 1)                             # HWIO -> OIHW
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def _bn_apply(x, scale, bias, mean, var, eps=1e-5):
    inv = torch.rsqrt(var + eps)
    return ((x - _per_channel(mean)) * _per_channel(inv) * _per_channel(scale)
            + _per_channel(bias))


def _bn_train(x, scale, bias, mean, var, momentum=0.9):
    axes = (0, 2, 3)
    m = torch.mean(x, axes)
    v = torch.mean(torch.square(x - _per_channel(m)), axes)  # biased
    out = _bn_apply(x, scale, bias, m, v)
    new_mean = momentum * mean + (1 - momentum) * m
    new_var = momentum * var + (1 - momentum) * v
    return out, new_mean, new_var


def _bn_init(c: int) -> Tree:
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def init_resnet(seed: int = 0, depth: int = 20, num_classes: int = 10,
                width: int = 16, in_channels: int = 3) -> Tuple[Tree, Tree]:
    """CIFAR ResNet (6n+2 layout: depth 20/32/44...; the reference's
    benchmarks use 32). Returns (params, bn_state) as CPU tensors, the
    draws' own device (the trainer moves them to its device). The draws
    come from a ``torch.Generator`` seeded with ``seed``: the shapes and
    the He fan-in scaling are the JAX package's, the values are not
    (``jax.random.normal`` cannot be redrawn here; :func:`resnet_from_jax`
    carries a JAX tree over)."""
    if (depth - 2) % 6:
        raise ValueError("CIFAR resnet depth must be 6n+2 (20, 32, 44, ...)")
    n = (depth - 2) // 6
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen) * scale

    def conv_init(kh, kw, cin, cout):
        return normal(kh, kw, cin, cout, scale=np.sqrt(2.0 / (kh * kw * cin)))

    params: Tree = {"stem": conv_init(3, 3, in_channels, width)}
    bn: Tree = {"stem": _bn_init(width)}
    chans = [width, 2 * width, 4 * width]
    blocks: List[Tree] = []
    bn_blocks: List[Tree] = []
    cin = width
    for stage, cout in enumerate(chans):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk = {"conv1": conv_init(3, 3, cin, cout),
                   "conv2": conv_init(3, 3, cout, cout)}
            if stride != 1 or cin != cout:
                blk["proj"] = conv_init(1, 1, cin, cout)
            blocks.append(blk)
            bn_blocks.append({"bn1": _bn_init(cout), "bn2": _bn_init(cout)})
            cin = cout
    params["blocks"] = blocks
    bn["blocks"] = bn_blocks
    params["head_w"] = normal(chans[-1], num_classes,
                              scale=np.sqrt(1.0 / chans[-1]))
    params["head_b"] = torch.zeros(num_classes)
    return params, bn


def apply_resnet(params: Tree, bn: Tree, x: torch.Tensor, train: bool = True
                 ) -> Tuple[torch.Tensor, Tree]:
    """Forward pass of NHWC images ``x``; returns (logits, new_bn_state)."""
    new_bn: Tree = {"stem": {}, "blocks": []}

    def run_bn(h, st, store: Tree):
        if train:
            out, m, v = _bn_train(h, st["scale"], st["bias"], st["mean"],
                                  st["var"])
            store.update({"scale": st["scale"], "bias": st["bias"],
                          "mean": m.detach(), "var": v.detach()})
            return out
        store.update(st)
        return _bn_apply(h, st["scale"], st["bias"], st["mean"], st["var"])

    h = x.permute(0, 3, 1, 2)           # NHWC memory, NCHW view
    if h.device.type == "cpu":
        # the CPU convolution's backward fails on channels-last inputs
        # (the process aborts in oneDNN, torch 2.13); cuDNN takes them
        h = h.contiguous()
    h = F.relu(run_bn(_conv(h, params["stem"]), bn["stem"], new_bn["stem"]))
    n = len(params["blocks"]) // 3      # blocks per stage (6n+2 layout)
    for i, (blk, bst) in enumerate(zip(params["blocks"], bn["blocks"])):
        # stage boundaries downsample (except the first stage)
        stride = 2 if (i in (n, 2 * n)) else 1
        store: Tree = {"bn1": {}, "bn2": {}}
        out = _conv(h, blk["conv1"], stride)
        out = F.relu(run_bn(out, bst["bn1"], store["bn1"]))
        out = run_bn(_conv(out, blk["conv2"]), bst["bn2"], store["bn2"])
        shortcut = _conv(h, blk["proj"], stride) if "proj" in blk else h
        h = F.relu(out + shortcut)
        new_bn["blocks"].append(store)
    h = torch.mean(h, dim=(2, 3))
    logits = torch.matmul(h, params["head_w"]) + params["head_b"]
    return logits, new_bn


def loss_fn(params: Tree, bn: Tree, x: torch.Tensor, y: torch.Tensor,
            train: bool = True) -> Tuple[torch.Tensor, Tree]:
    """Mean softmax cross-entropy; returns (loss, new_bn_state)."""
    logits, new_bn = apply_resnet(params, bn, x, train)
    logp = torch.log_softmax(logits, -1)
    loss = -torch.mean(torch.gather(logp, -1, y.long()[:, None])[:, 0])
    return loss, new_bn


def _leaves(tree: Any, path=()):
    """(path, leaf) pairs in ``jax.tree.flatten``'s order: dict keys
    sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def flatten_params(params: Tree) -> Tuple[np.ndarray, Any]:
    """The leaves concatenated in ``jax.tree.flatten``'s order, as float32
    numpy, and the meta :func:`unflatten_params` needs. Takes the port's
    tensors or the JAX package's (numpy) tree alike."""
    flat, meta = [], []
    for path, leaf in _leaves(params):
        arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        flat.append(arr.reshape(-1))
        meta.append((path, arr.shape))
    return np.concatenate(flat).astype(np.float32), meta


def unflatten_params(flat: torch.Tensor, meta) -> Tree:
    """The tree as views into the flat tensor ``flat`` (so a gradient of
    the tree's leaves lands in ``flat.grad``, whole)."""
    tree: Tree = {}
    off = 0
    for path, shape in meta:
        size = int(np.prod(shape)) if shape else 1
        leaf = flat[off:off + size].reshape(shape)
        off += size
        node: Any = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, dict):
                node = node.setdefault(key, [] if isinstance(nxt, int)
                                       else {})
            else:
                while len(node) <= key:
                    node.append({})
                node = node[key]
        if isinstance(node, dict):
            node[path[-1]] = leaf
        else:
            node.append(leaf)
    return tree


def bn_to_device(bn: Any, device) -> Tree:
    """A BN state tree (numpy or tensors) as f32 tensors on ``device``."""
    if isinstance(bn, dict):
        return {k: bn_to_device(v, device) for k, v in bn.items()}
    if isinstance(bn, (list, tuple)):
        return [bn_to_device(v, device) for v in bn]
    if isinstance(bn, torch.Tensor):
        return bn.to(device=device, dtype=torch.float32)
    # a copy: arrays handed out by jax are read-only views of its buffers
    return torch.from_numpy(np.array(bn, np.float32)).to(device)


def resnet_from_jax(params: Tree, bn: Tree) -> Tuple[np.ndarray, Tree]:
    """The JAX package's ``init_resnet`` trees (as numpy) -> (the flat
    table vector and the BN state, both float32 numpy): what
    ``apps.resnet_cifar.ResNetTrainer(init=...)`` starts from, so that
    both packages train from one tree."""
    flat, _ = flatten_params(params)
    return flat, _to_numpy(bn)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().astype(np.float32)
    return np.array(tree, np.float32)


def synthetic_cifar(n: int, size: int = 32, classes: int = 10, seed: int = 0):
    """CIFAR-shaped synthetic data with class-dependent structure (each
    class a distinct low-frequency pattern plus noise); the JAX package's
    arrays, bit for bit. Returns (x [n, size, size, 3] f32, y [n] int32)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    patterns = np.stack([
        np.sin(2 * np.pi * ((c % 5 + 1) * xx + (c // 5 + 1) * yy))
        for c in range(classes)]).astype(np.float32)
    x = (patterns[y][..., None].repeat(3, axis=-1) * 0.5
         + rng.normal(size=(n, size, size, 3)).astype(np.float32) * 0.3)
    return x.astype(np.float32), y
