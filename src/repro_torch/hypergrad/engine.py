"""The `HypergradEngine` API: one pluggable backend behind eq. (5).

Counterpart of ``repro.hypergrad.engine``.  Every algorithm's outer
gradient is the approximate hypergradient

    grad_bar f(x, y) = grad_x f(x, y)
        - H_xy(g)(x, y) [H_yy(g)(x, y)]^{-1} grad_y f(x, y).

A ``HypergradEngine`` owns the inverse application (``solve``); the
shared ``hypergradient`` surface owns the joint grad of f, the single
H_xy cross term and the subtraction.  Gradients and HVPs are
``torch.func`` transforms, so the whole estimator runs under
``torch.func.vmap`` over agents, and nothing in it reads a tensor on the
host, so it can be captured in a CUDA graph.

Backends: ``cg`` (fixed-trip CG), ``neumann`` (eq. 22, truncated or
with a drawn k), ``cholesky`` (H_yy materialised and factored), and the
linearize-once ``cg-linearized`` and ``neumann-linearized``
(``linearize_grad_y``).

The reference draws the stochastic Neumann k from a ``jax.random`` key;
the port takes the drawn k itself (``draw``, an int tensor), which the
caller samples (``repro_torch.core.svr_interact.Sampler``) or hands over
from the reference.
"""
from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch.func import grad, jvp
from torch.utils import _pytree as pytree

from repro_torch.hypergrad.config import HypergradConfig
from repro_torch.hypergrad.operator import HypergradStats, flat_dot, tree_sub

__all__ = [
    "HypergradEngine",
    "available_backends",
    "get_backend",
    "hvp_xy",
    "hvp_yy",
    "hypergradient",
    "hypergradient_with_stats",
    "linearize",
    "linearize_grad_y",
    "measure_counts",
    "measure_problem_counts",
    "register_backend",
]


def hvp_yy(g: Callable, x, y, v, *args):
    """H_yy(g)(x, y) @ v via forward-over-reverse."""
    grad_y = lambda yy: grad(g, argnums=1)(x, yy, *args)
    return jvp(grad_y, (y,), (v,))[1]


def hvp_xy(g: Callable, x, y, v, *args):
    """H_xy(g)(x, y) @ v  =  grad_x <grad_y g(x, y), v>."""
    def inner(xx):
        return flat_dot(grad(g, argnums=1)(xx, y, *args), v)

    return grad(inner)(x)


def linearize(fn: Callable, primal):
    """``torch.func.linearize(fn, primal)``: ``(fn(primal), tangent_map)``,
    the forward-over-reverse trace taken once at ``primal`` with
    everything the tangent does not touch folded into constants."""
    with warnings.catch_warnings():
        # the constant folder notes each folded attribute it inserts
        warnings.simplefilter("ignore", UserWarning)
        return torch.func.linearize(fn, primal)


def linearize_grad_y(g: Callable, x, y, g_args: tuple = ()):
    """``v -> H_yy(g)(x, y) @ v`` with ``grad_y g(x, .)`` linearized once.

    ``torch.func.linearize`` traces the forward-over-reverse product once
    at y and folds everything the tangent does not touch into constants,
    so each application runs only the tangent half (the reference's
    ``jax.linearize``).  Its dual tensors have no batching rule, so under
    a functorch transform (``vmap`` over agents or a sweep group's
    experiments) the map is ``hvp_yy``: a fresh ``torch.func.jvp`` of the
    y-gradient each application, the same value.
    """
    if torch._C._functorch.maybe_current_level() is not None:
        return lambda v: hvp_yy(g, x, y, v, *g_args)
    return linearize(lambda yy: grad(g, argnums=1)(x, yy, *g_args), y)[1]


class HypergradEngine:
    """Base class: apply the inner-Hessian inverse, counting evaluations.

    ``solve`` returns ``(z, stats)`` with ``z ~= [H_yy g]^{-1} b``; the
    stats count only the solve's own evaluations.  ``draw`` is the drawn
    Neumann k (stochastic configs only); ``inner_hess_yy`` an optional
    closed form of the flat H_yy, which only ``cholesky`` reads.
    """

    name = "base"

    def solve(self, g: Callable, x, y, b, cfg: HypergradConfig,
              g_args: tuple, draw=None,
              inner_hess_yy: Callable | None = None):
        raise NotImplementedError


_REGISTRY: dict[str, HypergradEngine] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: register a (stateless) engine under ``name``."""

    def deco(cls: type) -> type:
        existing = _REGISTRY.get(name)
        if existing is not None and type(existing) is not cls:
            raise ValueError(f"hypergradient backend {name!r} already "
                             f"registered ({type(existing).__name__})")
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def _populate() -> None:
    # Engines live in sibling modules; importing them registers them.
    from repro_torch.hypergrad import cg as _cg  # noqa: F401
    from repro_torch.hypergrad import cholesky as _chol  # noqa: F401
    from repro_torch.hypergrad import neumann as _neu  # noqa: F401


def available_backends() -> tuple[str, ...]:
    """Registered backend names, sorted."""
    _populate()
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> HypergradEngine:
    """Look a backend up by registry name."""
    _populate()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown hypergradient backend {name!r}; "
            f"choose from {tuple(sorted(_REGISTRY))}") from None


def hypergradient_with_stats(f: Callable, g: Callable, x, y,
                             cfg: HypergradConfig, f_args: tuple = (),
                             g_args: tuple = (), draw=None,
                             inner_hess_yy: Callable | None = None):
    """grad_bar f(x, y) of eq. (5)/(22) plus its evaluation counts.

    ``f(x, y, *f_args)`` is the outer loss, ``g(x, y, *g_args)`` the
    inner.  Returns ``(p, HypergradStats)`` with ``p`` shaped like x.
    """
    engine = get_backend(cfg.resolve_backend())
    gx, gy = grad(f, argnums=(0, 1))(x, y, *f_args)
    z, stats = engine.solve(g, x, y, gy, cfg, g_args, draw, inner_hess_yy)
    p = tree_sub(gx, hvp_xy(g, x, y, z, *g_args))
    return p, stats._replace(hvp_count=stats.hvp_count + 1,    # H_xy term
                             grad_count=stats.grad_count + 1)  # grad f


def hypergradient(f: Callable, g: Callable, x, y, cfg: HypergradConfig,
                  f_args: tuple = (), g_args: tuple = (), draw=None,
                  inner_hess_yy: Callable | None = None):
    """The approximate hypergradient grad_bar f(x, y) of eq. (5)/(22)."""
    p, _ = hypergradient_with_stats(f, g, x, y, cfg, f_args=f_args,
                                    g_args=g_args, draw=draw,
                                    inner_hess_yy=inner_hess_yy)
    return p


def measure_counts(f: Callable, g: Callable, x, y, cfg: HypergradConfig,
                   f_args: tuple = (), g_args: tuple = (), draw=None,
                   inner_hess_yy: Callable | None = None) -> HypergradStats:
    """Run one hypergradient call and return its counts as Python ints.

    For a stochastic-k config without a ``draw``, the counts are the
    rounded mean over 16 draws of k from a generator seeded with 0, as
    the reference averages over 16 keys (other draws, same estimate of
    the expected (K-1)/2 HVPs).
    """
    def one(d):
        _, stats = hypergradient_with_stats(f, g, x, y, cfg, f_args=f_args,
                                            g_args=g_args, draw=d,
                                            inner_hess_yy=inner_hess_yy)
        return HypergradStats(*(int(c) for c in stats))

    if cfg.stochastic_k and draw is None:
        draws = torch.randint(0, max(cfg.neumann_k, 1), (16,),
                              generator=torch.Generator().manual_seed(0))
        draws = draws.to(pytree.tree_leaves(x)[0].device)
        samples = [one(d) for d in draws]
        return HypergradStats(*(round(sum(c) / len(samples))
                                for c in zip(*samples)))
    return one(draw)


def measure_problem_counts(problem, cfg: HypergradConfig, x0, y0, data,
                           agent: int = 0, draw=None) -> HypergradStats:
    """``measure_counts`` on one agent's slice of stacked ``AgentData``."""
    return measure_counts(
        problem.outer, problem.inner, x0, y0, cfg,
        f_args=((data.outer_x[agent], data.outer_y[agent]),),
        g_args=((data.inner_x[agent], data.inner_y[agent]),), draw=draw,
        inner_hess_yy=getattr(problem, "inner_hess_yy", None))
