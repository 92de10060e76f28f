"""Plain PyTorch versions of the consensus kernels.

The CPU path of the wrappers in ``ops.py``, and the oracle that
``chip_smoke.py`` holds the CUDA kernels against on the card.  Float32
sums, outputs cast back to the input dtype.
"""
from __future__ import annotations

import torch

__all__ = ["block_product", "consensus_mix_batched_ref", "consensus_mix_ref",
           "consensus_mix_rows_ref", "consensus_step_batched_ref",
           "consensus_step_ref", "consensus_step_rows_ref"]


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


def block_product(M: torch.Tensor, row0: int, rows: int, x: torch.Tensor
                  ) -> torch.Tensor:
    """``M[row0:row0 + rows] @ x`` in float32.

    A one-row product is taken as the first row of a two-row one: BLAS
    sends a single row to its matrix-vector routine, whose sums differ in
    the last bit from the matrix product's, and every row block is to be
    the square product's rows bit for bit (``row0 = 0, rows = m`` is
    ``M @ x`` itself)."""
    W = M.float()[row0:row0 + rows]
    if rows == 1:
        return (W.expand(2, -1) @ x.float())[:1]
    return W @ x.float()


def consensus_step_rows_ref(M: torch.Tensor, x: torch.Tensor,
                            u: torch.Tensor, p: torch.Tensor,
                            p_prev: torch.Tensor, *, row0: int, alpha: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The row block of ``consensus_step_ref``: x and u are the gathered
    (m, D) tables, p and p_prev the block's (rows, D) rows, which start at
    row ``row0`` of M; returns the block's (rows, D) rows of both
    outputs."""
    rows = p.shape[0]
    own_u = u[row0:row0 + rows].float()
    x_out = block_product(M, row0, rows, x) - alpha * own_u
    u_out = block_product(M, row0, rows, u) + (p.float() - p_prev.float())
    return x_out.to(x.dtype), u_out.to(u.dtype)


def consensus_mix_rows_ref(M: torch.Tensor, x: torch.Tensor, *, row0: int,
                           rows: int) -> torch.Tensor:
    """The row block of ``consensus_mix_ref``: rows ``row0 .. row0 + rows
    - 1`` of ``M @ x`` for the gathered (m, D) table ``x``."""
    return block_product(M, row0, rows, x).to(x.dtype)


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
