"""`SolverConfig`: the configuration object behind every solver.

Counterpart of ``repro.solvers.config`` with the fields the port
honours, and the sweep's grouping contract: ``static_key`` and
``BATCH_FIELDS`` (see ``repro_torch.solvers.sweep``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np

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

    # -- static / batch split (the sweep's grouping contract) -------------
    #
    # Two configs share one sweep group, a batch of one vmapped step,
    # exactly when everything the step's structure depends on matches:
    # algorithm, network, backend and its options, hypergradient, batch
    # and q, the wire, the topology process's structure, the Byzantine
    # configuration and the guard.  ``seed``, ``alpha`` and ``beta``
    # enter only as values (the draws' generator and two per-experiment
    # scalars), so they are the batch axes.

    BATCH_FIELDS = ("seed", "alpha", "beta")

    def static_key(self, pad_to: int | None = None) -> tuple:
        """Hashable fingerprint of every field but the ``BATCH_FIELDS``.

        Configs with equal keys run in one group.  An explicit
        ``MixingSpec`` is keyed by value (its matrix bytes), so two equal
        networks built apart still share a group.  The topology process
        contributes only its structure (kind, period, tau): its ``p`` and
        seed change the stream's values, which a group takes per
        experiment.

        ``pad_to`` is the padded grouping (``sweep(..., pad_agents=
        True)``): the network fields (``topology``, ``mixing``,
        ``num_agents``) leave the key for the common padded size, and the
        Byzantine config contributes only its structure (kind, combine
        rule, trim); attacker count, scale and attack seed become
        per-experiment values.  Unpadded groups key on the whole
        Byzantine config and the resolved attack seed, so a seed grid
        never shares one attack schedule.
        """
        opts = tuple(sorted(self.backend_opts.items()))
        wire = (self.compression, self.communication_interval)
        proc = self.topology_process.structural_key()
        if pad_to is not None:
            byz = self.byzantine.structural_key()
            return (self.algo, self.batch_size, self.q, ("padded", pad_to),
                    self.backend, opts, self.hypergrad, wire, proc, byz,
                    self.guard)
        mix = None
        if self.mixing is not None:
            mat = np.asarray(self.mixing.matrix)
            mix = (mat.shape, mat.tobytes(), float(self.mixing.lam),
                   tuple(self.mixing.neighbors), tuple(self.mixing.weights))
        byz = (self.byzantine,
               self.byzantine.resolve_seed(self.seed)
               if self.byzantine.attack_active else None)
        return (self.algo, self.batch_size, self.q, self.num_agents, mix,
                self.topology, self.backend, opts, self.hypergrad, wire,
                proc, byz, self.guard)

    def batch_values(self) -> tuple[int, float, float]:
        """The per-experiment values: ``(seed, alpha, beta)``."""
        return (self.seed, self.alpha, self.beta)
