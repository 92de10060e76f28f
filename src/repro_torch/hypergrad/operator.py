"""`LinearOperator`: the counted matvec every backend's solve flows through.

Counterpart of ``repro.hypergrad.operator``.  The paper states its
complexity in gradient and Hessian-vector evaluations, so the engines
count them.  A fixed trip count is counted as a Python integer; the
stochastic Neumann chain counts its drawn k, a tensor (per agent under
``torch.func.vmap``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "HypergradStats",
    "LinearOperator",
    "as_operator",
    "flat_dot",
    "ravel",
    "tree_axpy",
    "tree_scale",
    "tree_sub",
]


class HypergradStats(NamedTuple):
    """Evaluation counts of one hypergradient call.

    hvp_count:  Hessian-vector products against g (the H_yy solve
                matvecs and the single H_xy cross term).
    grad_count: first-order gradient evaluations (grad_{x,y} f counts once).
    hess_count: full H_yy materialisations (the ``cholesky`` backend's
                closed form; 0 elsewhere).

    Each is a Python int, or an int tensor where the count was drawn or
    counted on the device (``cg-linearized``'s trips before its freeze).
    """

    hvp_count: int | torch.Tensor
    grad_count: int | torch.Tensor
    hess_count: int | torch.Tensor

    @classmethod
    def zero(cls) -> "HypergradStats":
        return cls(hvp_count=0, grad_count=0, hess_count=0)


class LinearOperator:
    """A linear map with evaluation accounting:
    ``op.apply_counted(v, count)`` returns ``(A v, count + cost)``;
    ``op.apply_basis(V, count)`` maps every row of ``V`` (under
    ``torch.func.vmap``) and charges one evaluation a row."""

    def __init__(self, matvec: Callable, cost: int = 1):
        self.matvec = matvec
        self.cost = cost

    def apply_counted(self, v, count: int):
        return self.matvec(v), count + self.cost

    def apply_basis(self, basis: torch.Tensor, count: int):
        rows = torch.func.vmap(self.matvec)(basis)
        return rows, count + self.cost * basis.shape[0]


def as_operator(matvec) -> LinearOperator:
    """A bare matvec callable as a unit-cost ``LinearOperator``."""
    if isinstance(matvec, LinearOperator):
        return matvec
    return LinearOperator(matvec)


def flat_dot(a, b) -> torch.Tensor:
    """<a, b> summed over every leaf of two like-shaped pytrees."""
    leaves_a = pytree.tree_leaves(a)
    leaves_b = pytree.tree_leaves(b)
    return sum(torch.sum(la * lb) for la, lb in zip(leaves_a, leaves_b))


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise."""
    return pytree.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_scale(alpha, x):
    return pytree.tree_map(lambda xi: alpha * xi, x)


def tree_sub(x, y):
    return pytree.tree_map(lambda xi, yi: xi - yi, x, y)


def ravel(tree):
    """``(flat, unravel)``: every leaf of ``tree`` laid end to end in leaf
    order (``jax.flatten_util.ravel_pytree``'s order); ``unravel(flat)``
    restores the tree."""
    leaves, spec = pytree.tree_flatten(tree)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(vec: torch.Tensor):
        parts = torch.split(vec, sizes)
        return pytree.tree_unflatten(
            [part.reshape(shape) for part, shape in zip(parts, shapes)],
            spec)

    return flat, unravel
