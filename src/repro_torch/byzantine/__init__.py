"""Byzantine-resilient consensus: attacks, robust combines, guards.

Counterpart of ``repro.byzantine``.  Three layers, carried by
``SolverConfig`` and threaded through the consensus engine, eager and
captured:

* **Attacks** (:mod:`repro_torch.byzantine.attacks`): a fixed seeded
  subset of agent slots ships corrupted payloads every communication
  round (``sign-flip``, ``gaussian``, ``same-value``,
  ``inner-outer-split``), before compression, so the error-feedback
  copies track what was actually sent.  Masks and noise are drawn on
  the host from numpy.
* **Combine rules** (:mod:`repro_torch.byzantine.combine`):
  ``weighted`` (the engine's ``mix``), ``coordinate-median``,
  ``trimmed-mean`` and ``krum-like`` over each agent's in-neighborhood.
* **Guards** (:mod:`repro_torch.byzantine.guards`): NaN/Inf and
  iterate-norm trip-wires with ``torch.where`` rollback to the last good
  state, reported through ``SolveResult``.
"""
from repro_torch.byzantine.attacks import (
    Attack,
    AttackSchedule,
    GroupAttackSchedule,
    apply_attack,
    attack_names,
    byzantine_mask,
    make_attack,
    register_attack,
    round_noise,
)
from repro_torch.byzantine.combine import (
    CombineRule,
    combine_rule_names,
    make_combine_rule,
    register_combine_rule,
    robust_combine,
)
from repro_torch.byzantine.config import ByzantineConfig, GuardConfig
from repro_torch.byzantine.guards import guard_param_step, init_guard

__all__ = [
    "Attack",
    "AttackSchedule",
    "ByzantineConfig",
    "CombineRule",
    "GroupAttackSchedule",
    "GuardConfig",
    "apply_attack",
    "attack_names",
    "byzantine_mask",
    "combine_rule_names",
    "guard_param_step",
    "init_guard",
    "make_attack",
    "make_combine_rule",
    "register_attack",
    "register_combine_rule",
    "robust_combine",
    "round_noise",
]
