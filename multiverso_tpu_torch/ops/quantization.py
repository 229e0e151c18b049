"""Weight-only int8 quantization for decoding (port of
``multiverso_tpu/ops/quantization.py``).

Params are held as int8 plus per-channel f32 scales, 4x smaller in device
memory than f32 (2x smaller than bf16), and dequantized on use: the
matrix products still run in the model dtype.

Symmetric scheme: ``scale = max|w| / 127`` per kept channel and ``w ~=
q.float() * scale``; the error is at most ``scale / 2`` per element.
``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` and
``scale`` equal the JAX package's bit for bit on the same f32 input.
:class:`QuantizedTensor` is a pair of tensors; a stacked ``[L, ...]`` one
slices per layer with :meth:`QuantizedTensor.layer`, which is how
``models/transformer.generate`` dequantizes one layer at a time.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch

from multiverso_tpu_torch.zoo import default_device


class QuantizedTensor(NamedTuple):
    q: torch.Tensor       # int8, same shape as the original
    scale: torch.Tensor   # f32, original shape with reduced dims = 1

    def layer(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a tensor stacked on a leading layer dimension."""
        return QuantizedTensor(self.q[i], self.scale[i])


def quantize(w: torch.Tensor, keep_axes: Sequence[int] = (-1,)
             ) -> QuantizedTensor:
    """Symmetric int8 quantization with one scale per index of the
    ``keep_axes`` dims (all other dims share a scale)."""
    keep = {a % w.ndim for a in keep_axes}
    reduce_dims = tuple(d for d in range(w.ndim) if d not in keep)
    w32 = w.float()
    amax = torch.amax(torch.abs(w32), dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QuantizedTensor(q.to(torch.int8), scale)


def dequantize(t: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.float() * t.scale).to(dtype)


def maybe_dequantize(leaf: Any, dtype=torch.float32) -> Any:
    return dequantize(leaf, dtype) if isinstance(leaf, QuantizedTensor) \
        else leaf


_LAYER_MATRICES = ("wqkv", "wo", "w1", "w2")


@torch.no_grad()
def quantize_lm_params(params: Any, device=None) -> Dict[str, Any]:
    """Quantize an LM for decoding: embeddings per row, the stacked layer
    matrices per (layer, out-channel); the norm vectors stay exact.

    ``params`` is the port's ``models.transformer.Transformer`` (the tree
    lands on its device) or a JAX-layout numpy tree (it lands on
    ``device``, by default the card). The norms keep the model's dtype (a
    numpy tree's float32). The result drops into
    ``transformer.generate`` directly."""
    if isinstance(params, torch.nn.Module):
        from multiverso_tpu_torch.models.transformer import param_tree
        tree = param_tree(params)
    else:
        dev = default_device(device)
        tree = _to_tensors(params, dev)
    out = dict(tree)
    out["embed"] = quantize(tree["embed"], keep_axes=(0,))
    out["pos"] = quantize(tree["pos"], keep_axes=(0,))
    layers = dict(tree["layers"])
    for k in _LAYER_MATRICES:
        if k in layers:
            layers[k] = quantize(layers[k], keep_axes=(0, -1))
    out["layers"] = layers
    return out


def _to_tensors(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device)
