"""Bilevel problem abstraction and the paper's meta-learning instance.

Counterpart of ``repro.core.bilevel``.  A ``BilevelProblem`` packages the
per-agent outer loss f_i(x, y; batch) and inner loss g_i(x, y; batch) of
problem (1):

    min_x (1/m) sum_i f_i(x_i, y_i*(x_i)),
    y_i*(x_i) = argmin_y g_i(x_i, y_i),   g_i mu_g-strongly convex in y.

The Section-6 instance is a shared two-hidden-layer tanh backbone x and
per-agent linear heads y_i, with g_i = CE(train split) + (mu/2)||y||^2
and f_i = CE(validation split).

Parameters keep the JAX layout: a weight is ``(in, out)``, the backbone
is ``[(W0, b0), (W1, b1)]`` and the head ``(W_head, b_head)``, so the leaf
order is that of ``jax.flatten_util.ravel_pytree``.  Labels are int64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "AgentData",
    "BilevelProblem",
    "MLPMetaProblem",
    "init_head",
    "init_mlp_backbone",
    "make_synthetic_agents",
    "pad_agent_data",
]


class AgentData(NamedTuple):
    """Per-agent datasets split into inner (train) / outer (val) samples.

    Every field carries a leading agent dimension m.
    """

    inner_x: torch.Tensor  # (m, n_in, d) float32
    inner_y: torch.Tensor  # (m, n_in) int64 labels
    outer_x: torch.Tensor  # (m, n_out, d)
    outer_y: torch.Tensor  # (m, n_out)


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    """f(x, y, batch) outer loss, g(x, y, batch) inner loss.

    ``inner_hess_yy(x, y, batch) -> (d_y, d_y)`` is an optional closed
    form of the flat inner Hessian in ``ravel_pytree(y)`` order, ridge
    included.
    """

    outer: Callable
    inner: Callable
    mu_g: float
    lipschitz_g: float
    inner_hess_yy: Callable | None = None


def _mlp_features(params, inputs):
    h = inputs
    for w, b in params:
        h = torch.tanh(h @ w + b)
    return h


def _cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[:, None]).mean()


def MLPMetaProblem(mu_g: float = 0.1, lipschitz_g: float = 4.0) -> BilevelProblem:
    """Backbone x = [(W, b), ...], head y = (W_head, b_head).

    g(x, y) = CE(head(features(x, inner_x)), inner_y) + mu/2 ||y||^2
    f(x, y) = CE(head(features(x, outer_x)), outer_y)

    The head's inner Hessian has the closed form

        H[(i,c),(j,d)] = (1/n) sum_s phi_si phi_sj A_s[c,d] + mu I,
        A_s = diag(p_s) - p_s p_s^T,   phi_s = [features_s, 1].
    """

    def outer(x, y, batch):
        inputs, labels = batch
        w, b = y
        return _cross_entropy(_mlp_features(x, inputs) @ w + b, labels)

    def inner(x, y, batch):
        inputs, labels = batch
        w, b = y
        ce = _cross_entropy(_mlp_features(x, inputs) @ w + b, labels)
        return ce + 0.5 * mu_g * (torch.sum(w * w) + torch.sum(b * b))

    def inner_hess_yy(x, y, batch):
        inputs, _labels = batch
        feats = _mlp_features(x, inputs)
        w, b = y
        p = torch.softmax(feats @ w + b, dim=-1)            # (n, C)
        n, C = p.shape
        # phi rows [features, 1]: index i*C+c matches ravel((w, b)) =
        # [w.ravel(), b] with the bias as the trailing phi column.
        phi = torch.cat([feats, feats.new_ones(n, 1)], dim=1)
        hd1 = phi.shape[1]
        d = hd1 * C
        R = (phi[:, :, None] * p[:, None, :]).reshape(n, d)
        G = torch.einsum("sc,si,sj->cij", p, phi, phi)      # (C, hd+1, hd+1)
        H = -(R.T @ R).reshape(hd1, C, hd1, C)
        eye_c = torch.eye(C, dtype=p.dtype, device=p.device)
        H = H + G.permute(1, 0, 2)[:, :, :, None] * eye_c[None, :, None, :]
        return (H.reshape(d, d) / n
                + mu_g * torch.eye(d, dtype=p.dtype, device=p.device))

    return BilevelProblem(outer=outer, inner=inner, mu_g=mu_g,
                          lipschitz_g=lipschitz_g,
                          inner_hess_yy=inner_hess_yy)


def init_mlp_backbone(generator: torch.Generator, d_in: int, hidden: int = 20,
                      depth: int = 2, scale: float = 0.5,
                      device: torch.device | str | None = None):
    """``[(W, b)] * depth`` with W ~ scale * N(0, 1/fan_in), b = 0.

    Draws from ``generator`` on the CPU, then moves to ``device`` (the
    CUDA card when ``None``), so a seed gives the same weights on every
    device.  The distribution is the JAX package's; the numbers are not
    (a different generator).
    """
    device = resolve_device(device)
    params = []
    dims = [d_in] + [hidden] * depth
    for i in range(depth):
        w = scale * torch.randn(dims[i], dims[i + 1],
                                generator=generator) / np.sqrt(dims[i])
        params.append((w.to(device), torch.zeros(dims[i + 1], device=device)))
    return params


def init_head(generator: torch.Generator, hidden: int, num_classes: int,
              scale: float = 0.1, device: torch.device | str | None = None):
    """``(W_head, b_head)`` with W ~ scale * N(0, 1/hidden), b = 0, on
    ``device`` (the CUDA card when ``None``)."""
    device = resolve_device(device)
    w = scale * torch.randn(hidden, num_classes,
                            generator=generator) / np.sqrt(hidden)
    return (w.to(device), torch.zeros(num_classes, device=device))


def pad_agent_data(data: AgentData, pad_to: int) -> AgentData:
    """Ghost-pad the agent axis to ``pad_to`` by tiling the real agents'
    data: ghost agent i >= m sees a copy of agent ``i % m``'s dataset.

    Real, finite samples keep the ghosts' (discarded) computations finite,
    so no ``0 * NaN`` reaches an active row through a padded combine.
    Active agents' rows are untouched.
    """
    m = data.inner_x.shape[0]
    if pad_to < m:
        raise ValueError(f"cannot pad {m} agents down to {pad_to}")
    if pad_to == m:
        return data
    idx = torch.arange(pad_to, device=data.inner_x.device) % m
    return AgentData(*(leaf[idx] for leaf in data))


def make_synthetic_agents(
    seed: int,
    num_agents: int,
    n_per_agent: int = 1000,
    d_in: int = 32,
    num_classes: int = 10,
    heterogeneity: float = 0.5,
    outer_frac: float = 0.3,
    device: torch.device | str | None = None,
) -> AgentData:
    """Synthetic heterogeneous classification tasks (MNIST stand-in).

    Class means are shared globally; each agent sees a skewed label
    distribution (Dirichlet with concentration 1/heterogeneity) plus an
    agent-specific mean shift.  Draws with ``numpy.random.default_rng
    (seed)``: the same distributions as the JAX package's ``jax.random``
    draws, but not the same numbers.  The tensors go to ``device`` (the
    CUDA card when ``None``).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    means = 2.0 * rng.standard_normal((num_classes, d_in))
    shifts = heterogeneity * rng.standard_normal((num_agents, 1, d_in))
    conc = np.full(num_classes, 1.0 / max(heterogeneity, 1e-3))
    probs = rng.dirichlet(conc, size=num_agents)
    labels = np.stack([rng.choice(num_classes, size=n_per_agent, p=pr)
                       for pr in probs])
    noise = rng.standard_normal((num_agents, n_per_agent, d_in))
    xs = (means[labels] + shifts + 0.75 * noise).astype(np.float32)

    n_out = int(outer_frac * n_per_agent)
    xs = torch.from_numpy(xs).to(device)
    ys = torch.from_numpy(labels.astype(np.int64)).to(device)
    return AgentData(inner_x=xs[:, n_out:].contiguous(),
                     inner_y=ys[:, n_out:].contiguous(),
                     outer_x=xs[:, :n_out].contiguous(),
                     outer_y=ys[:, :n_out].contiguous())
