"""Plain PyTorch versions of the consensus kernels.

The CPU path of the wrappers in ``ops.py``, and the oracle that
``chip_smoke.py`` holds the CUDA kernels against on the card.  Float32
sums, outputs cast back to the input dtype.
"""
from __future__ import annotations

import torch

__all__ = ["consensus_mix_batched_ref", "consensus_mix_ref",
           "consensus_step_batched_ref", "consensus_step_ref"]


def consensus_step_ref(M: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
                       p: torch.Tensor, p_prev: torch.Tensor, *, alpha: float
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(M @ x - alpha * u, M @ u + (p - p_prev))`` on (m, D) rows."""
    M32 = M.float()
    u32 = u.float()
    x_out = M32 @ x.float() - alpha * u32
    u_out = M32 @ u32 + (p.float() - p_prev.float())
    return x_out.to(x.dtype), u_out.to(u.dtype)


def consensus_mix_ref(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``M @ x`` on (m, D) rows."""
    return (M.float() @ x.float()).to(x.dtype)


def consensus_step_batched_ref(M: torch.Tensor, x: torch.Tensor,
                               u: torch.Tensor, p: torch.Tensor,
                               p_prev: torch.Tensor, alpha: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``consensus_step_ref`` for B experiments at once: streams (B, m, D),
    M (B, m, m) or (1, m, m) shared, alpha (B,)."""
    M32 = M.float()
    u32 = u.float()
    a = alpha.float().reshape(-1, 1, 1)
    x_out = torch.matmul(M32, x.float()) - a * u32
    u_out = torch.matmul(M32, u32) + (p.float() - p_prev.float())
    return x_out.to(x.dtype), u_out.to(u.dtype)


def consensus_mix_batched_ref(M: torch.Tensor, x: torch.Tensor
                              ) -> torch.Tensor:
    """``consensus_mix_ref`` for B experiments at once: x (B, m, D), M
    (B, m, m) or (1, m, m) shared."""
    return torch.matmul(M.float(), x.float()).to(x.dtype)
