"""Plain PyTorch version of the WKV6 kernel.

The CPU path of ``ops.wkv6``, and the oracle that ``chip_smoke.py``
holds the CUDA kernel against on the card.  A copy of
``repro.kernels.rwkv6.ref.wkv6_ref``: the token-by-token recurrence in
float32, output cast back to r's dtype.
"""
from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             state: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (b, s, h, N); u (h, N); state (b, h, N, N) float32,
    k-major (state[b, h, i, j] ~ k_i v_j), zeros when None.

        o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T

    Returns (out (b, s, h, N) in r's dtype, final state float32).
    """
    b, s, h, n = r.shape
    st = (torch.zeros(b, h, n, n, dtype=torch.float32, device=r.device)
          if state is None else state.float())
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()[None, :, :, None]
    outs = []
    for t in range(s):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]     # (b, h, n, n)
        att = st + u32 * kv
        outs.append(torch.einsum("bhn,bhnm->bhm", r32[:, t], att))
        st = w32[:, t, :, :, None] * st + kv
    out = (torch.stack(outs, dim=1) if outs
           else torch.zeros(b, 0, h, n, device=r.device))
    return out.to(r.dtype), st
