"""Robust combine rules: replacements for the ``M @ X`` contraction.

Counterpart of ``repro.byzantine.combine``.  A :class:`CombineRule`
aggregates, for each agent i, the payload rows of its in-neighborhood:
the support ``{j : |M[i, j]| > 1e-12} ∪ {i}`` of its mixing row,
computed on the device from the round's matrix (so a topology stream's
round buffer and the adaptive matrix pass through unchanged).  The
robust rules are nonlinear in the payload: no exact average
preservation, and the engine's self-clean correction does not apply.

The reference computes them in ``jnp``, outside any Pallas kernel; the
port computes them in plain PyTorch, every agent at once (an (m, m, D)
masked buffer; m is the network, D one agent's payload).  Three places
where PyTorch's defaults differ from JAX's are handled explicitly:

* the median averages the two middle values of an even support, as
  ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower one);
* trimmed-mean sorts stably, keyed on +inf outside the support;
* krum's distances are sums of squared differences, not ``|a|^2 +
  |b|^2 - 2ab``, so near ties pick the row the reference picks; ties go
  to the first index in both frameworks.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "CombineRule",
    "combine_rule_names",
    "make_combine_rule",
    "register_combine_rule",
    "robust_combine",
    "support_of",
]

_RULES: dict[str, type] = {}

_SUPPORT_TOL = 1e-12


def register_combine_rule(name: str):
    """Class decorator: register a :class:`CombineRule` under ``name``."""

    def wrap(cls):
        if name in _RULES:
            raise ValueError(f"combine rule {name!r} already registered "
                             f"({_RULES[name].__name__})")
        cls.name = name
        _RULES[name] = cls
        return cls

    return wrap


def combine_rule_names() -> tuple[str, ...]:
    return tuple(sorted(_RULES))


def make_combine_rule(name: str) -> "CombineRule":
    try:
        return _RULES[name]()
    except KeyError:
        raise ValueError(
            f"unknown combine rule {name!r}; registered: "
            f"{combine_rule_names()}") from None


class CombineRule:
    """Aggregate an (m, D) payload buffer row-neighborhood-wise."""

    name = "?"

    def aggregate(self, vals: torch.Tensor, support: torch.Tensor,
                  matrix: torch.Tensor, trim: int) -> torch.Tensor:
        """(m, D) float32 aggregate from (m, D) vals, (m, m) support."""
        raise NotImplementedError


@register_combine_rule("weighted")
class WeightedRule(CombineRule):
    """The paper's contraction ``M @ X``: the bitwise no-op baseline (the
    engine routes it to its ``mix``, a kernel on the ``cuda`` backend)."""

    def aggregate(self, vals, support, matrix, trim):
        del support, trim
        return matrix @ vals


@register_combine_rule("coordinate-median")
class CoordinateMedianRule(CombineRule):
    """Per-coordinate median over the in-neighborhood (incl. self); every
    support entry counts once.  An even count averages the two middle
    values, with ``jnp.nanmedian``'s linear weights."""

    def aggregate(self, vals, support, matrix, trim):
        del matrix, trim
        masked = torch.where(support[:, :, None], vals[None],
                             float("nan"))
        ordered = torch.sort(masked, dim=1).values      # NaN sorts last
        cnt = (~torch.isnan(ordered)).sum(dim=1, keepdim=True).to(
            torch.float32)
        pos = 0.5 * (cnt - 1.0)
        low, high = torch.floor(pos), torch.ceil(pos)
        w_high = pos - low
        top = cnt - 1.0
        low = torch.maximum(torch.minimum(low, top), torch.zeros_like(low))
        high = torch.maximum(torch.minimum(high, top),
                             torch.zeros_like(high))
        lo = torch.gather(ordered, 1, low.to(torch.int64))
        hi = torch.gather(ordered, 1, high.to(torch.int64))
        return (lo * (1.0 - w_high) + hi * w_high)[:, 0]


@register_combine_rule("trimmed-mean")
class TrimmedMeanRule(CombineRule):
    """Drop the f smallest and f largest per coordinate, mean the rest.

    ``trim`` is f.  A neighborhood too small to trim (``|support| <=
    2f``) falls back to the plain support mean.
    """

    def aggregate(self, vals, support, matrix, trim):
        del matrix
        m, d = vals.shape
        sup = support[:, :, None].expand(m, m, d)
        keyed = torch.where(sup, vals[None], float("inf"))
        order = torch.sort(keyed, dim=1, stable=True).indices
        svals = torch.gather(vals[None].expand(m, m, d), 1, order)
        ssup = torch.gather(sup, 1, order)
        cnt = support.sum(dim=1)[:, None, None]
        idx = torch.arange(m, device=vals.device)[None, :, None]
        keep = ssup & (idx >= trim) & (idx < cnt - trim)
        keep = torch.where(cnt > 2 * trim, keep, ssup)
        total = torch.where(keep, svals, 0.0).sum(dim=1)
        return total / torch.clamp(keep.sum(dim=1), min=1)


@register_combine_rule("krum-like")
class KrumLikeRule(CombineRule):
    """Nearest-neighbor screening: adopt the most central support row
    (smallest summed squared distance to the other support rows)."""

    def aggregate(self, vals, support, matrix, trim):
        del matrix, trim
        diff = vals[:, None, :] - vals[None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        pair = support[:, :, None] & support[:, None, :]
        scores = torch.where(pair, d2[None], 0.0).sum(dim=2)
        scores = torch.where(support, scores, float("inf"))
        return vals[torch.argmin(scores, dim=1)]


def support_of(matrix: torch.Tensor) -> torch.Tensor:
    """(m, m) bool: each agent's in-neighborhood plus itself."""
    m = matrix.shape[0]
    return (torch.abs(matrix) > _SUPPORT_TOL) | torch.eye(
        m, dtype=torch.bool, device=matrix.device)


def robust_combine(matrix: torch.Tensor, tree, rule: str, trim: int = 1):
    """Aggregate a payload pytree under ``rule`` over the support of
    ``matrix`` (plus the diagonal), keeping leaf shapes and dtypes.

    Leaves are concatenated into one (m, D) float32 buffer (krum scores
    need the full rows) and split back after aggregation.
    """
    leaves, spec = pytree.tree_flatten(tree)
    m = leaves[0].shape[0]
    flat = [leaf.to(torch.float32).reshape(m, -1) for leaf in leaves]
    vals = flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)
    mat = matrix.to(torch.float32)
    out = make_combine_rule(rule).aggregate(vals, support_of(mat), mat, trim)
    pieces = torch.split(out, [f.shape[1] for f in flat], dim=1)
    return pytree.tree_unflatten(
        [p.reshape(leaf.shape).to(leaf.dtype)
         for p, leaf in zip(pieces, leaves)], spec)
