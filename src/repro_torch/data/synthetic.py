"""Deterministic synthetic data pipelines.

Counterpart of ``repro.data.synthetic``.  Two generators:

* ``TokenTaskStream``: per-agent language-model token streams with
  agent-specific Markov structure (heterogeneous f_i / g_i, as the
  paper's decentralized setting requires), for the LM training driver.
* ``classification_agents``: the port's synthetic classifier data
  (``repro_torch.core.make_synthetic_agents``).

Batch t of agent i is a pure function of (seed, i, t), so runs are
exactly reproducible and every process makes only its own agents'
batches.  The draws come from numpy on the host, not from
``jax.random``: ``default_rng([seed, TOKEN_TAG, i, t])`` for a batch,
``default_rng([seed, BAND_TAG, i])`` for the agent's vocabulary band.
A tag leads the stream's words because ``SeedSequence`` drops trailing
zeros (``[seed, i, 0]`` would name the stream ``[seed, i]``).  The
distributions are the JAX package's; the numbers are not.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bilevel import make_synthetic_agents as classification_agents
from repro_torch.device import resolve_device

__all__ = ["BAND_TAG", "TOKEN_TAG", "TokenTaskStream",
           "classification_agents"]

# entropy tags of the stream's generators (ASCII "toks" and "band")
TOKEN_TAG = 0x746F6B73
BAND_TAG = 0x62616E64


@dataclasses.dataclass(frozen=True)
class TokenTaskStream:
    """Heterogeneous per-agent token streams.

    Agent i draws tokens from a sticky first-order chain over an
    agent-specific contiguous band of ``subset_frac * vocab_size`` token
    ids: each position keeps the previous token with probability
    ``stickiness`` and otherwise jumps to a uniform token of the band.
    """

    vocab_size: int
    num_agents: int
    seed: int = 0
    stickiness: float = 0.8
    subset_frac: float = 0.25

    @property
    def band_size(self) -> int:
        return max(2, int(self.subset_frac * self.vocab_size))

    def band_start(self, agent: int) -> int:
        """The first token id of agent ``agent``'s band."""
        rng = np.random.default_rng([self.seed, BAND_TAG, agent])
        return int(rng.integers(0, max(1, self.vocab_size - self.band_size)))

    def agent_tokens(self, agent: int, step: int, batch: int,
                     seq_len: int) -> np.ndarray:
        """(batch, seq_len) int64 tokens of one agent at one step, numpy."""
        sub = self.band_size
        rng = np.random.default_rng([self.seed, TOKEN_TAG, agent, step])
        first = rng.integers(0, sub, batch)
        jumps = rng.integers(0, sub, (batch, seq_len))
        stick = rng.random((batch, seq_len)) < self.stickiness
        toks = np.empty((batch, seq_len), np.int64)
        prev = first
        for t in range(seq_len):
            prev = np.where(stick[:, t], prev, jumps[:, t])
            toks[:, t] = prev
        return (toks + self.band_start(agent)) % self.vocab_size

    def agent_batch(self, agent: int, step: int, batch: int, seq_len: int,
                    device: str | torch.device | None = None
                    ) -> torch.Tensor:
        """(batch, seq_len) int64 tokens of one agent on ``device``."""
        return torch.as_tensor(self.agent_tokens(agent, step, batch, seq_len),
                               device=resolve_device(device))

    def global_batch(self, step: int, per_agent: int, seq_len: int,
                     device: str | torch.device | None = None
                     ) -> torch.Tensor:
        """(num_agents, per_agent, seq_len) int64, stacked over agents."""
        rows = [self.agent_tokens(i, step, per_agent, seq_len)
                for i in range(self.num_agents)]
        return torch.as_tensor(np.stack(rows), device=resolve_device(device))
