"""Server-side updaters on torch tensors (port of
``multiverso_tpu/updaters/__init__.py``).

An updater is a pair of functions:

* ``init_state(shape, dtype, device)`` -> dict of state tensors
* ``apply(data, state, delta, opt)``   -> (data, state)

Unlike the JAX package, whose arrays are immutable, ``apply`` updates
``data`` and the state tensors IN PLACE on their device (no second
table-sized buffer) and returns the same objects. The arithmetic follows
the JAX functions operation by operation, with every hyperparameter made
a 0-d tensor of the data's dtype first (as ``jnp.asarray(x, data.dtype)``
does), so results agree with the JAX package to the ulp wherever the
same IEEE operations are involved; ``sqrt`` and ``pow`` may differ by a
few ulp between the two libraries.

Semantics (signs follow the reference Multiverso):
* default:      data += delta
* sgd:          data -= delta          (lr pre-multiplied by the worker)
* momentum_sgd: smooth = m*smooth + (1-m)*delta; data -= smooth
* adagrad:      G += delta**2 / lr**2 ; data -= delta * rho / (sqrt(G)+eps),
                one shared G, or one per worker with ``per_worker=True``
* adam:         bias-corrected Adam; the step counter advances once per
                ``apply`` call
* ftrl:         FTRL-proximal; ``delta`` is the raw gradient and ``data``
                becomes the weights recomputed from the (z, n) state
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

State = Dict[str, torch.Tensor]


class AddOption(NamedTuple):
    """Wire-parity hyperparameter bundle (ref updater.h AddOption)."""
    worker_id: int = 0
    momentum: float = 0.0
    learning_rate: float = 0.1
    rho: float = 0.1
    lam: float = 0.0  # "lambda" in the reference


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """0-d tensor of ``like``'s dtype and device (``jnp.asarray(x, dtype)``)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


class Updater:
    """Base updater: plain accumulation."""

    name = "default"

    def __init__(self, num_workers: int = 1):
        self.num_workers = num_workers

    def init_state(self, shape, dtype: torch.dtype,
                   device: torch.device) -> State:
        return {}

    def apply(self, data: torch.Tensor, state: State, delta: torch.Tensor,
              opt: AddOption) -> Tuple[torch.Tensor, State]:
        data.add_(delta)
        return data, state


class SGDUpdater(Updater):
    name = "sgd"

    def apply(self, data, state, delta, opt):
        data.sub_(delta)
        return data, state


class MomentumUpdater(Updater):
    name = "momentum_sgd"

    def init_state(self, shape, dtype, device):
        return {"smooth": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, data, state, delta, opt):
        m = _scalar(opt.momentum, data)
        smooth = state["smooth"]
        smooth.mul_(m).add_((1.0 - m) * delta)
        data.sub_(smooth)
        return data, state


class AdaGradUpdater(Updater):
    name = "adagrad"

    def __init__(self, num_workers: int = 1, per_worker: bool = False,
                 eps: float = 1e-10):
        super().__init__(num_workers)
        self.per_worker = per_worker
        self.eps = eps

    def init_state(self, shape, dtype, device):
        if self.per_worker:
            shape = (self.num_workers,) + tuple(shape)
        return {"g_sqr": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, data, state, delta, opt):
        lr = _scalar(opt.learning_rate, data)
        rho = _scalar(opt.rho, data)
        g2 = torch.square(delta) / torch.square(lr)
        if self.per_worker:
            hist = state["g_sqr"][int(opt.worker_id)]
        else:
            hist = state["g_sqr"]
        hist.add_(g2)
        step = delta * rho / (torch.sqrt(hist) + self.eps)
        data.sub_(step)
        return data, state


class AdamUpdater(Updater):
    name = "adam"

    def __init__(self, num_workers: int = 1, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        super().__init__(num_workers)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps

    def init_state(self, shape, dtype, device):
        return {
            "m": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def apply(self, data, state, delta, opt):
        lr = _scalar(opt.learning_rate, data)
        b1 = _scalar(self.beta1, data)
        b2 = _scalar(self.beta2, data)
        t = state["t"]
        t.add_(1)
        m, v = state["m"], state["v"]
        m.mul_(b1).add_((1.0 - b1) * delta)
        v.mul_(b2).add_((1.0 - b2) * torch.square(delta))
        tf = t.to(data.dtype)
        m_hat = m / (1.0 - torch.pow(b1, tf))
        v_hat = v / (1.0 - torch.pow(b2, tf))
        step = lr * m_hat / (torch.sqrt(v_hat) + self.eps)
        data.sub_(step)
        return data, state


class FTRLUpdater(Updater):
    """FTRL-proximal. ``delta`` is the raw gradient; the stored data is the
    weight vector recomputed from the (z, n) state after each update."""

    name = "ftrl"

    def __init__(self, num_workers: int = 1, alpha: float = 0.1,
                 beta: float = 1.0, lambda1: float = 0.1,
                 lambda2: float = 1.0):
        super().__init__(num_workers)
        self.alpha, self.beta = alpha, beta
        self.lambda1, self.lambda2 = lambda1, lambda2

    def init_state(self, shape, dtype, device):
        return {"z": torch.zeros(shape, dtype=dtype, device=device),
                "n": torch.zeros(shape, dtype=dtype, device=device)}

    def apply(self, data, state, delta, opt):
        g = delta
        z, n = state["z"], state["n"]
        alpha = _scalar(self.alpha, data)
        g2 = torch.square(g)
        sigma = (torch.sqrt(n + g2) - torch.sqrt(n)) / alpha
        z.add_(g).sub_(sigma * data)
        n.add_(g2)
        w = torch.where(
            torch.abs(z) <= self.lambda1,
            torch.zeros_like(z),
            -(z - torch.sign(z) * self.lambda1)
            / ((self.beta + torch.sqrt(n)) / alpha + self.lambda2))
        data.copy_(w)
        return data, state


# Classification used by the merging planes of later slices (exact type
# match: a subclass overriding apply() inherits neither property):
# * STATELESS_LINEAR: Add is a signed accumulate with no state.
# * OPT_INSENSITIVE: apply() never reads AddOption.
# * ROW_LOCAL_STATE: apply() is per-row elementwise and every state leaf is
#   row-aligned, so K disjoint-row adds merge into one. Adam is excluded:
#   its step counter advances once per apply() call.
STATELESS_LINEAR: Dict[type, float] = {Updater: 1.0, SGDUpdater: -1.0}
OPT_INSENSITIVE = {Updater, SGDUpdater, FTRLUpdater}
ROW_LOCAL_STATE = {Updater, SGDUpdater, MomentumUpdater, AdaGradUpdater,
                   FTRLUpdater}

_REGISTRY: Dict[str, Callable[..., Updater]] = {
    "default": Updater,
    "sgd": SGDUpdater,
    "momentum_sgd": MomentumUpdater,
    "adagrad": AdaGradUpdater,
    "adam": AdamUpdater,
    "ftrl": FTRLUpdater,
}


def register_updater(name: str, factory: Callable[..., Updater]) -> None:
    """User extension point."""
    _REGISTRY[name] = factory


def _is_integer(dtype: Any) -> bool:
    if isinstance(dtype, torch.dtype):
        return not dtype.is_floating_point and not dtype.is_complex \
            and dtype is not torch.bool
    return np.issubdtype(np.dtype(dtype), np.integer)


def get_updater(name: str, num_workers: int = 1, dtype=None,
                **kwargs) -> Updater:
    """Factory keyed on the ``updater_type`` flag value. Integer tables
    always get the default updater (ref updater.cpp:33-36)."""
    if dtype is not None and _is_integer(dtype):
        return Updater(num_workers)
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown updater_type {name!r}; known: {sorted(_REGISTRY)}"
        ) from None
    return factory(num_workers=num_workers, **kwargs)
