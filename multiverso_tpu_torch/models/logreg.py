"""Logistic-regression / softmax model math on torch tensors (port of
``multiverso_tpu/models/logreg.py``).

The reference LR model and objectives (ref:
Applications/LogisticRegression/src/model/model.cpp:64-111 minibatch
gradient accumulation; src/objective/objective.cpp sigmoid/softmax
Predict / Diff / Gradient; src/regular/{l1,l2}_regular.h) loop over
samples; here the logits are one matrix product and the minibatch-average
gradient a second, in the tensors' dtype (f32; the card's TF32 products
are the caller's switch).

Parameters are a single (num_classes, input_dim + 1) matrix with the bias
folded in, stored flattened in an ArrayTable (the reference's dense PS
layout, ps_model.cpp:24-41).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from multiverso_tpu_torch.updaters import AddOption

_SIGMOID_EPS = 1e-7


def param_count(input_dim: int, num_classes: int) -> int:
    return num_classes * (input_dim + 1)


def unflatten(params: torch.Tensor, input_dim: int,
              num_classes: int) -> torch.Tensor:
    return params[: param_count(input_dim, num_classes)].reshape(
        num_classes, input_dim + 1)


def _augment(x: torch.Tensor) -> torch.Tensor:
    """Append the bias column."""
    return torch.cat([x, x.new_ones((*x.shape[:-1], 1))], dim=-1)


def predict_logits(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, D) x (C, D+1) -> (B, C)."""
    return _augment(x) @ w.T


def predict_proba(w: torch.Tensor, x: torch.Tensor,
                  objective: str) -> torch.Tensor:
    logits = predict_logits(w, x)
    if objective == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def objective_loss_diff(logits: torch.Tensor, y: torch.Tensor,
                        objective: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minibatch loss and ``diff = p - onehot`` (ref objective.cpp Diff)
    of (B, C) logits: per-class sigmoid with its 1e-7 eps, or softmax
    cross-entropy through ``log_softmax``."""
    # jax.nn.one_hot's rule: a label outside [0, C) is an all-zero row
    onehot = (y.long()[:, None] == torch.arange(
        logits.shape[-1], device=logits.device)).to(logits.dtype)
    if objective == "sigmoid":
        p = torch.sigmoid(logits)
        loss = -torch.mean(torch.sum(
            onehot * torch.log(p + _SIGMOID_EPS)
            + (1 - onehot) * torch.log(1 - p + _SIGMOID_EPS), dim=-1))
        return loss, p - onehot
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.sum(onehot * logp, dim=-1))
    return loss, torch.softmax(logits, dim=-1) - onehot


def loss_and_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  objective: str, regular: str = "none",
                  reg_coef: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minibatch loss and average gradient (ref objective.cpp Diff then
    Gradient accumulation; the regularizer added per element as
    regular.cpp Calculate does)."""
    xb = _augment(x)
    loss, diff = objective_loss_diff(xb @ w.T, y, objective)
    grad = diff.T @ xb / x.shape[0]
    if regular == "l2":
        grad = grad + reg_coef * w
        loss = loss + 0.5 * reg_coef * torch.sum(torch.square(w))
    elif regular == "l1":
        grad = grad + reg_coef * torch.sign(w)
        loss = loss + reg_coef * torch.sum(torch.abs(w))
    return loss, grad


def accuracy(w: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(predict_logits(w, x), dim=-1)
                       == y.long()).to(torch.float32))


def make_train_step(table, input_dim: int, num_classes: int, objective: str,
                    regular: str = "none", reg_coef: float = 0.0,
                    learning_rate: float = 0.1) -> Callable:
    """The in-graph PS train step: grad -> lr-premultiplied delta ->
    ``table.functional_add`` (the reference worker premultiplies the LR and
    the server's SGD updater subtracts, ref app updater.cpp:52-71). The
    JAX step runs under ``lax.scan``; this one is called once per
    minibatch and updates ``state``'s tensors in place."""
    opt = AddOption(learning_rate=learning_rate)

    def step(state: Dict, batch) -> Tuple[Dict, torch.Tensor]:
        x, y = batch
        w = unflatten(state["data"], input_dim, num_classes)
        loss, grad = loss_and_grad(w, x, y, objective, regular, reg_coef)
        delta = learning_rate * grad
        flat = torch.zeros(table.padded_shape, dtype=table.dtype,
                           device=state["data"].device)
        flat[: delta.numel()] = delta.reshape(-1)
        state = table.functional_add(state, flat, opt)
        return state, loss

    return step


def synthetic_dataset(num_samples: int, input_dim: int, num_classes: int,
                      seed: int = 0, noise: float = 0.6,
                      centers_seed: int = 1234
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-blob classification set (test/bench fixture; a copy of the
    JAX package's, numpy only, so both packages see the same bytes from a
    seed). ``centers_seed`` fixes the class centers independently of the
    sample seed so train/test splits share one task."""
    rng = np.random.default_rng(seed)
    centers = (np.random.default_rng(centers_seed)
               .normal(size=(num_classes, input_dim)).astype(np.float32))
    y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    x = centers[y] + noise * rng.normal(size=(num_samples, input_dim)
                                        ).astype(np.float32)
    return x.astype(np.float32), y
