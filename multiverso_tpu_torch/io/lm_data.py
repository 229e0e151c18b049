"""LM data pipeline: token packing and prefetched device batches (port of
``multiverso_tpu/io/lm_data.py``).

A flat token stream is packed into fixed [seq+1] windows, and an iterator
yields (tokens, targets[, mask]) batches already on the device, the next
batch's host-to-device copy overlapped behind the current step through
``utils.async_buffer.AsyncBuffer`` (the reference's double-buffered
prefetch, util/async_buffer.h). On the card each batch is copied from
pinned host memory without blocking. A config with mesh axes (or zigzag
attention) places this rank's block of each batch with
``models.transformer.shard_batch``, as the JAX package does; the mask is
placed like the tokens (the port's ``loss_fn`` takes it in the tokens'
order, where the JAX one permutes an original-order mask itself). What
``models.transformer.check_supported`` refuses is refused here.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.utils.async_buffer import AsyncBuffer
from multiverso_tpu_torch.zoo import default_device


def _window(ids: np.ndarray, n: int, seq_len: int) -> np.ndarray:
    """[N, seq+1] overlapping windows from one vectorized view."""
    view = np.lib.stride_tricks.sliding_window_view(
        ids[: n * seq_len + 1], seq_len + 1)
    return np.ascontiguousarray(view[::seq_len]).astype(np.int32)


def pack_tokens(ids: np.ndarray, seq_len: int,
                drop_remainder: bool = True) -> np.ndarray:
    """Pack a flat token stream into [N, seq_len + 1] windows (each row
    holds inputs ``[:-1]`` and next-token targets ``[1:]``). Windows
    overlap by one token so no target is lost at a boundary. To keep the
    ragged tail use :func:`pack_tokens_padded`, which returns the target
    mask that keeps pad positions out of the loss."""
    ids = np.asarray(ids).reshape(-1)
    n = (ids.size - 1) // seq_len
    if not drop_remainder:
        raise ValueError("padding needs a target mask; use "
                         "pack_tokens_padded")
    if n < 1:
        raise ValueError(f"stream of {ids.size} tokens is shorter than one "
                         f"window of {seq_len + 1}")
    return _window(ids, n, seq_len)


def pack_tokens_padded(ids: np.ndarray, seq_len: int, pad_id: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Like :func:`pack_tokens` but keeps the ragged tail, padding the last
    window with ``pad_id``. Returns (windows [N, seq+1], target_mask [N,
    seq] f32): pass the mask to ``loss_fn`` / ``TokenBatches(masks=...)``
    so pad targets never count."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size < 2:
        raise ValueError("need at least 2 tokens (one target)")
    n = -(-(ids.size - 1) // seq_len)  # ceil
    pad = n * seq_len + 1 - ids.size
    real_targets = ids.size - 1
    if pad:
        ids = np.concatenate([ids, np.full(pad, pad_id, ids.dtype)])
    windows = _window(ids, n, seq_len)
    mask = (np.arange(n * seq_len) < real_targets).reshape(n, seq_len)
    return windows, mask.astype(np.float32)


class TokenBatches:
    """Iterate (tokens, targets) device batches over an epoch.

    Shuffles the windows each epoch with ``np.random.default_rng(seed)``
    (the JAX package's order for the same seed), groups them into [batch,
    seq] pairs and places each on ``device`` (default: the Zoo's device
    when it is up, else the card); the next batch's placement runs on a
    background thread while the caller's step executes
    (``prefetch=False`` turns that off)."""

    def __init__(self, windows: np.ndarray, batch_size: int, cfg,
                 device=None, seed: int = 0, prefetch: bool = True,
                 masks: Optional[np.ndarray] = None, mesh=None):
        from multiverso_tpu_torch.models.transformer import check_supported
        check_supported(cfg)
        if windows.ndim != 2:
            raise ValueError("windows must be [N, seq+1] (use pack_tokens)")
        if windows.shape[0] < batch_size:
            raise ValueError(f"{windows.shape[0]} windows < batch_size "
                             f"{batch_size}")
        if masks is not None and masks.shape != (windows.shape[0],
                                                 windows.shape[1] - 1):
            raise ValueError(f"masks shape {masks.shape} != "
                             f"{(windows.shape[0], windows.shape[1] - 1)}")
        self._windows = windows
        self._masks = masks
        self._batch = batch_size
        self._device = default_device(device)
        self._cfg = cfg
        self._mesh = mesh
        from multiverso_tpu_torch.models.transformer import cfg_axes
        self._sharded = bool(cfg_axes(cfg)) or cfg.attn == "zigzag"
        self._rng = np.random.default_rng(seed)
        self._prefetch = prefetch

    def __len__(self) -> int:
        return self._windows.shape[0] // self._batch

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    def _place(self, idx: np.ndarray):
        rows = self._windows[idx]
        if self._sharded:
            from multiverso_tpu_torch.models.transformer import shard_batch
            out = (shard_batch(rows[:, :-1], self._cfg, self._mesh,
                               self._device),
                   shard_batch(rows[:, 1:], self._cfg, self._mesh,
                               self._device))
            if self._masks is not None:
                out += (shard_batch(self._masks[idx], self._cfg,
                                    self._mesh, self._device),)
            return out
        out = (self._to_device(rows[:, :-1]), self._to_device(rows[:, 1:]))
        if self._masks is not None:
            out += (self._to_device(self._masks[idx]),)
        return out

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        """Yields (tokens, targets) pairs, or (tokens, targets, mask)
        triples when the batches carry padding masks."""
        order = self._rng.permutation(self._windows.shape[0])
        nb = len(self)
        batches = (order[i * self._batch: (i + 1) * self._batch]
                   for i in range(nb))
        if not self._prefetch:
            for idx in batches:
                yield self._place(idx)
            return
        it = iter(batches)

        def pull():
            idx = next(it, None)
            return None if idx is None else self._place(idx)

        buf = AsyncBuffer(pull)
        try:
            while True:
                batch = buf.get()  # starts the next pull in the background
                if batch is None:
                    return
                yield batch
        finally:
            buf.stop()


def evaluate_perplexity(params, batches, cfg,
                        loss_fn=None) -> Tuple[float, float]:
    """Mean next-token loss and perplexity over an iterable of
    (tokens, targets[, mask]) batches (e.g. a :class:`TokenBatches`;
    masked batches keep padding out of the score). ``loss_fn`` defaults to
    ``models.transformer.loss_fn`` under ``cfg``."""
    if loss_fn is None:
        from multiverso_tpu_torch.models import transformer as tfm

        def loss_fn(p, tok, tgt, mask=None):
            return tfm.loss_fn(p, tok, tgt, mask=mask, cfg=cfg)
    total, count = 0.0, 0
    with torch.inference_mode():
        for batch in batches:
            total += float(loss_fn(params, *batch))
            count += 1
    if count == 0:
        raise ValueError("no batches to evaluate")
    mean = total / count
    return mean, float(np.exp(mean))
