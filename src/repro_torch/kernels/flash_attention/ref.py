"""Plain PyTorch versions of the flash attention kernels.

``attention_ref`` is the CPU path of ``ops.flash_attention``, and the
oracle that ``chip_smoke.py`` holds the CUDA kernels against on the card.
A copy of ``repro.kernels.flash_attention.ref.attention_ref``: exact
softmax in float32, output cast back to the input dtype.

``split_f32_ref`` is the float32 path's split pass: what the card's
``flash_split_f32_kernel`` writes, bit for bit.
"""
from __future__ import annotations

import math

import torch

__all__ = ["SPLIT_SHIFT", "attention_ref", "split_f32_ref"]

# A split tile is scaled by 2^-e into [2^SPLIT_SHIFT, 2^(SPLIT_SHIFT + 1)).
SPLIT_SHIFT = 14


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


def split_f32_ref(x: torch.Tensor, rows: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (b, s, h, hd) float32 -> (hi, lo, e): hi and lo (b, h, s, hd)
    float16, e (b, h, ceil(s / rows)) int32.

    Each tile of ``rows`` rows of a (batch row, head) is scaled by the
    exact power of two 2^-e that puts its largest magnitude M in
    [2^14, 2^15) (e = floor(log2 M) - 14; e = 0 for an all-zero or
    non-finite tile), then split as hi = f16(x 2^-e), lo = f16(x 2^-e -
    hi): hi + lo is x 2^-e to about 2^-22 of M, in float16's range for
    every float32 x.  A NaN is carried through the split but does not
    enter M (as fmaxf drops it on the card).
    """
    b, s, h, hd = x.shape
    xt = x.float().permute(0, 2, 1, 3)
    tiles = -(-s // rows)
    pad = torch.zeros(b, h, tiles * rows, hd, device=x.device)
    pad[:, :, :s] = xt
    mag = pad.abs()
    mag = torch.where(torch.isnan(mag), 0.0, mag)
    m = mag.reshape(b, h, tiles, rows * hd).amax(dim=-1)
    ok = (m > 0) & torch.isfinite(m)
    e = torch.where(ok, torch.frexp(m).exponent - 1 - SPLIT_SHIFT, 0)
    e = e.to(torch.int32)
    # in float64 the power of two is exact at every exponent
    scale = torch.exp2(-e.double()).repeat_interleave(rows, dim=2)[:, :, :s]
    xs = (xt.double() * scale[..., None]).float()
    hi = xs.to(torch.float16)
    lo = (xs - hi.float()).to(torch.float16)
    return hi, lo, e
