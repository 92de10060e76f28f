"""`LinearOperator`: the counted matvec every backend's solve flows through.

Counterpart of ``repro.hypergrad.operator``.  The paper states its
complexity in gradient and Hessian-vector evaluations, so the engines
count them.  The ``cg`` backend runs a fixed trip count, so its counts are
plain Python integers, which stay outside ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "HypergradStats",
    "LinearOperator",
    "flat_dot",
    "tree_axpy",
    "tree_sub",
]


class HypergradStats(NamedTuple):
    """Evaluation counts of one hypergradient call.

    hvp_count:  Hessian-vector products against g (the H_yy solve
                matvecs and the single H_xy cross term).
    grad_count: first-order gradient evaluations (grad_{x,y} f counts once).
    hess_count: full H_yy materialisations (0 for ``cg``).
    """

    hvp_count: int
    grad_count: int
    hess_count: int

    @classmethod
    def zero(cls) -> "HypergradStats":
        return cls(hvp_count=0, grad_count=0, hess_count=0)


class LinearOperator:
    """A linear map with evaluation accounting:
    ``op.apply_counted(v, count)`` returns ``(A v, count + cost)``."""

    def __init__(self, matvec: Callable, cost: int = 1):
        self.matvec = matvec
        self.cost = cost

    def apply_counted(self, v, count: int):
        return self.matvec(v), count + self.cost


def flat_dot(a, b) -> torch.Tensor:
    """<a, b> summed over every leaf of two like-shaped pytrees."""
    leaves_a = pytree.tree_leaves(a)
    leaves_b = pytree.tree_leaves(b)
    return sum(torch.sum(la * lb) for la, lb in zip(leaves_a, leaves_b))


def tree_axpy(alpha, x, y):
    """alpha * x + y, leaf-wise."""
    return pytree.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_sub(x, y):
    return pytree.tree_map(lambda xi, yi: xi - yi, x, y)
