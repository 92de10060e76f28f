"""Optimizers as ``(init, update)`` pairs on pytrees.

Counterpart of ``repro.optim.optimizers``, with its update formulas.
The paper's algorithms take plain (tracked) gradient steps; these are
the substrate for non-bilevel training and for inner-problem solvers.
``update(grads, state, params) -> (updates, state)``; the caller adds
the updates to the parameters.  Adam's step counter is a 0-dim int32
tensor on the parameters' device, so an update reads nothing on the
host.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["AdamState", "Optimizer", "adam", "adamw", "clip_by_global_norm",
           "cosine_schedule", "momentum", "sgd", "warmup_linear"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def _tmap(f, *trees):
    return pytree.tree_map(f, *trees)


def sgd(lr: float) -> Optimizer:
    def init(_params):
        return ()

    def update(grads, state, _params=None):
        return _tmap(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return _tmap(torch.zeros_like, params)

    def update(grads, vel, _params=None):
        vel = _tmap(lambda v, g: beta * v + g, vel, grads)
        if nesterov:
            upd = _tmap(lambda v, g: -lr * (beta * v + g), vel, grads)
        else:
            upd = _tmap(lambda v: -lr * v, vel)
        return upd, vel

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        device = pytree.tree_leaves(params)[0].device
        return AdamState(_tmap(torch.zeros_like, params),
                         _tmap(torch.zeros_like, params),
                         torch.zeros((), dtype=torch.int32, device=device))

    def update(grads, state, _params=None):
        count = state.count + 1
        mu = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = _tmap(lambda n, g: b2 * n + (1 - b2) * g * g, state.nu, grads)
        steps = count.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=steps.device), steps)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=steps.device), steps)
        upd = _tmap(lambda m, n: -lr * (m / c1) / (torch.sqrt(n / c2) + eps),
                    mu, nu)
        return upd, AdamState(mu, nu, count)

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(grads, state, params):
        upd, state = base.update(grads, state, params)
        upd = _tmap(lambda u, p: u - lr * weight_decay * p, upd, params)
        return upd, state

    return Optimizer(base.init, update)


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped, norm)``: every leaf scaled by ``min(1, max_norm /
    ||grads||)`` (in float32, cast back), and the global norm."""
    gsq = sum(torch.sum(torch.square(g.to(torch.float32)))
              for g in pytree.tree_leaves(grads))
    norm = torch.sqrt(gsq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return _tmap(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                 grads), norm


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    """lr(step): cosine decay from ``base_lr`` to ``final_frac * base_lr``
    over ``total_steps``, constant after; a 0-dim float32 tensor."""
    def lr(step):
        t = torch.clamp(torch.as_tensor(step, dtype=torch.float32)
                        / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def warmup_linear(base_lr: float, warmup_steps: int):
    """lr(step): ``base_lr * min(1, (step + 1) / warmup_steps)``."""
    def lr(step):
        frac = (torch.as_tensor(step, dtype=torch.float32) + 1) / warmup_steps
        return base_lr * torch.clamp(frac, max=1.0)
    return lr
