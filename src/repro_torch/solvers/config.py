"""`SolverConfig`: the configuration object behind every solver.

Counterpart of ``repro.solvers.config`` with the fields the port
honours.  The sweep's ``static_key`` / ``BATCH_FIELDS`` grouping comes
with the batched sweeps, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.byzantine.config import ByzantineConfig, GuardConfig
from repro_torch.consensus.compress import CompressionConfig
from repro_torch.core.consensus import (MixingSpec, erdos_renyi_adjacency,
                                        laplacian_mixing, ring_mixing,
                                        torus_mixing)
from repro_torch.hypergrad import HypergradConfig
from repro_torch.topology.process import TopologyProcessConfig

__all__ = ["SolverConfig", "TopologyConfig"]


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Declarative communication graph, realised per agent count m.

    kind:       "ring" | "erdos-renyi" | "torus".
    p_connect:  ER edge probability.
    seed:       ER graph sample seed.
    self_weight: ring mixing w0.
    """

    kind: str = "erdos-renyi"
    p_connect: float = 0.5
    seed: int = 0
    self_weight: float = 1.0 / 3.0

    def mixing_spec(self, m: int) -> MixingSpec:
        """The configured topology's mixing matrix for ``m`` agents."""
        if self.kind == "ring":
            return ring_mixing(m, self_weight=self.self_weight)
        if self.kind == "erdos-renyi":
            return laplacian_mixing(
                erdos_renyi_adjacency(m, self.p_connect, self.seed))
        if self.kind == "torus":
            rows = int(m ** 0.5)
            while rows > 1 and m % rows:
                rows -= 1
            return torus_mixing(rows, m // rows)
        raise ValueError(f"unknown topology {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Configuration of a registry solver.

    Attributes:
      algo: registry name ("interact", "svr-interact", "gt-dsgd", "d-sgd";
        see ``available_solvers()``).
      alpha / beta: outer / inner step sizes (Theorem-1 bounds apply).
      batch_size: minibatch size |S| of the stochastic solvers; ``None``
        takes q (the paper's |S| = q).
      q: SVR-INTERACT's refresh period; ``None`` takes ceil(sqrt(n)).
      num_agents: network size m; when set it wins over the m of the data.
      mixing: explicit ``MixingSpec``; overrides ``topology`` when set.
      topology: declarative graph, realised once m is known.
      backend: consensus backend, "dense" or "cuda".
      backend_opts: extra keyword arguments for ``make_engine``.
      hypergrad: how the inner-Hessian inverse is applied (eq. 5).
      compression: wire compression of the consensus payloads
        (``CompressionConfig``: none / int8 / sign1bit / topk, error
        feedback, warm-up, damping).
      communication_interval: steps between consensus rounds (1 mixes
        every step, the paper's algorithms); the steps between mix
        nothing.
      topology_process: how the mixing matrix evolves over steps
        (``TopologyProcessConfig``: static / link-failure / straggler /
        random-gossip / adaptive), on top of ``topology`` / ``mixing``;
        the default static process changes nothing.
      byzantine: attack injection and robust aggregation
        (``ByzantineConfig``: attack kind, attacker count, scale, combine
        rule); the default, no attack and ``weighted``, changes nothing.
      guard: divergence trip-wires (``GuardConfig``: NaN/Inf and an
        iterate-norm bound, rollback to the last good state); the
        counters come back as ``SolveResult.tripped_steps`` /
        ``last_good_step``.  Off by default.
      seed: seed of the default Section-6 instance ``solve`` builds, of
        the stochastic solvers' sampling generator, and the fallback seed
        of the topology process and of the attack schedule.
    """

    algo: str = "interact"
    alpha: float = 0.3
    beta: float = 0.3
    batch_size: int | None = None
    q: int | None = None
    num_agents: int | None = None
    mixing: MixingSpec | None = None
    topology: TopologyConfig = TopologyConfig()
    backend: str = "dense"
    backend_opts: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    hypergrad: HypergradConfig = HypergradConfig()
    compression: CompressionConfig = CompressionConfig()
    communication_interval: int = 1
    topology_process: TopologyProcessConfig = TopologyProcessConfig()
    byzantine: ByzantineConfig = ByzantineConfig()
    guard: GuardConfig = GuardConfig()
    seed: int = 0

    def mixing_spec(self, m: int | None = None) -> MixingSpec:
        """The mixing matrix: explicit ``mixing`` if set, else topology(m)."""
        if self.mixing is not None:
            return self.mixing
        m = self.num_agents if self.num_agents is not None else m
        if m is None:
            raise ValueError(
                "SolverConfig has no explicit mixing; the agent count m is "
                "required to realise the declarative topology (set "
                "num_agents or pass m)")
        return self.topology.mixing_spec(m)

    def resolve_num_agents(self, m: int | None = None) -> int | None:
        """``num_agents``, else the explicit mixing's size, else ``m``."""
        if self.num_agents is not None:
            return self.num_agents
        if self.mixing is not None:
            return self.mixing.num_agents
        return m

    def resolve_q(self, n: int | None = None) -> int:
        """Refresh period: explicit ``q`` or the paper's ceil(sqrt(n))."""
        if self.q is not None:
            return self.q
        if n is None:
            raise ValueError("q unset and per-agent sample count n unknown")
        return int(math.ceil(math.sqrt(n)))

    def resolve_batch(self, n: int | None = None) -> int:
        """Minibatch size: explicit ``batch_size`` or |S| = q (paper)."""
        if self.batch_size is not None:
            return self.batch_size
        return self.resolve_q(n)
