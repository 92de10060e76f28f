"""Plain PyTorch version of the flash attention kernel.

The CPU path of ``ops.flash_attention``, and the oracle that
``chip_smoke.py`` holds the CUDA kernel against on the card.  A copy of
``repro.kernels.flash_attention.ref.attention_ref``: exact softmax in
float32, output cast back to the input dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  logit_softcap: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (b, sq, nh, hd), k and v (b, skv, nkv, hd) -> (b, sq, nh, hd).

    Query row i sits at position ``i + q_offset``, key column j at j.  A
    row with no visible key gives zeros.
    """
    b, sq, nh, hd = q.shape
    _, skv, nkv, _ = k.shape
    group = nh // nkv
    qg = q.reshape(b, sq, nkv, group, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / math.sqrt(hd)
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    row = torch.arange(sq, device=q.device)[:, None] + q_offset
    col = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= row >= col
    if window is not None:
        mask &= row - col < window
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, torch.zeros((), device=q.device))
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, nh, hd).to(q.dtype)
