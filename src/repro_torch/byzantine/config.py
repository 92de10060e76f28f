"""Frozen, hashable configs: what attacks run and what guards watch.

Counterpart of ``repro.byzantine.config``, with the same fields,
defaults, validation and messages.  Both ride on ``SolverConfig``;
``structural_key`` is what a padded sweep group must share (the attack
values become its operands there).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.byzantine.attacks import attack_names
from repro_torch.byzantine.combine import (combine_rule_names,
                                           make_combine_rule)

__all__ = ["ByzantineConfig", "GuardConfig"]


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Attack injection and robust aggregation for one experiment.

    Attributes:
      kind: attack name from the registry, or ``"none"``.
      num_byzantine: how many slots attack (a fixed seeded subset).
      scale: attack magnitude (attack-specific semantics).
      seed: attack-schedule seed; ``None`` inherits ``SolverConfig.seed``
        (see :meth:`resolve_seed`).
      combine: aggregation rule name (``"weighted"`` is the paper's
        ``M @ X`` and the bitwise no-op default).
      trim: the f of ``trimmed-mean``; ``None`` resolves to
        ``max(num_byzantine, 1)``.
    """

    kind: str = "none"
    num_byzantine: int = 0
    scale: float = 1.0
    seed: int | None = None
    combine: str = "weighted"
    trim: int | None = None

    def __post_init__(self):
        if self.kind != "none" and self.kind not in attack_names():
            raise ValueError(f"unknown attack kind {self.kind!r}; "
                             f"registered: {attack_names()}")
        if self.combine not in combine_rule_names():
            raise ValueError(f"unknown combine rule {self.combine!r}; "
                             f"registered: {combine_rule_names()}")
        if self.num_byzantine < 0:
            raise ValueError("num_byzantine must be >= 0, got "
                             f"{self.num_byzantine}")
        if not math.isfinite(self.scale):
            raise ValueError(f"scale must be finite, got {self.scale}")
        if self.trim is not None and self.trim < 1:
            raise ValueError(f"trim must be >= 1, got {self.trim}")

    @property
    def attack_active(self) -> bool:
        return self.kind != "none"

    @property
    def active(self) -> bool:
        """Anything here puts the engine on the wire path."""
        return self.attack_active or self.combine != "weighted"

    def resolve_trim(self) -> int:
        return self.trim if self.trim is not None else max(
            int(self.num_byzantine), 1)

    def resolve_seed(self, fallback: int) -> int:
        return int(fallback if self.seed is None else self.seed)

    def structural_key(self):
        """What a padded sweep group must share; values become operands."""
        trim = self.resolve_trim() if self.combine == "trimmed-mean" else 0
        return ("byzantine", self.kind, self.combine, trim)

    def validate_for(self, m: int) -> None:
        """Loud breakdown errors against a known network size."""
        if self.combine == "trimmed-mean" and 2 * self.resolve_trim() >= m:
            raise ValueError(
                f"trimmed-mean breakdown: f={self.resolve_trim()} needs "
                f"2f < m but m={m}; a majority-trimmed neighborhood has "
                f"no honest signal left")
        if self.attack_active and int(self.num_byzantine) >= m:
            raise ValueError(
                f"num_byzantine={self.num_byzantine} >= m={m}: at least "
                f"one honest agent is required")
        if self.combine != "weighted":
            make_combine_rule(self.combine)  # raises on unknown


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Divergence trip-wires on every step (all off by default).

    Attributes:
      nan: roll back any step whose x/y iterates contain NaN/Inf.
      max_norm: roll back any step where ||x||_F (over all agents)
        exceeds this; 0 disables the norm trip-wire.

    A tripped step is replaced by the last good state with
    ``torch.where`` on the device and counted;
    ``SolveResult.tripped_steps`` / ``last_good_step`` report the
    counters.
    """

    nan: bool = False
    max_norm: float = 0.0

    def __post_init__(self):
        if self.max_norm < 0 or not math.isfinite(self.max_norm):
            raise ValueError(f"max_norm must be finite and >= 0, got "
                             f"{self.max_norm}")

    @property
    def active(self) -> bool:
        return self.nan or self.max_norm > 0
