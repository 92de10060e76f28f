"""RWKV-6 "Finch" block: attention-free time mixing with data-dependent decay.

Counterpart of ``repro.models.rwkv``.  Per head (size N), with
receptance r_t, key k_t, value v_t, decay w_t (all input-dependent) and a
learned bonus u:

    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``rwkv_time_mix`` runs the recurrence with ``impl="cuda"`` (the
hand-written WKV6 kernel of ``repro_torch.kernels.rwkv6`` on CUDA
tensors, its plain version on CPU tensors) and with every other impl of
``IMPLS`` (``"reference"``, ``"blockwise"``) the plain ``wkv6_ref``, a
loop over time, as the JAX package sends every impl but its kernel's to
its reference.  Decode carries the (heads, N, N) state, O(1) per token.
Channel mixing is the RWKV variant of a gated MLP with token shift.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models.layers import IMPLS, init_normal

__all__ = [
    "init_rwkv_block", "init_rwkv_state", "rwkv_channel_mix",
    "rwkv_time_mix", "rwkv_time_mix_decode", "wkv6_ref",
]


def init_rwkv_block(gen: torch.Generator, d_model: int, head_size: int,
                    dtype, device, d_ff: int | None = None) -> dict:
    if d_model % head_size:
        raise ValueError(f"d_model {d_model} is not a multiple of the head "
                         f"size {head_size}")
    d_ff = d_ff or 4 * d_model
    s = 1.0 / math.sqrt(d_model)
    num_heads = d_model // head_size

    def normal(shape, scale):
        return init_normal(gen, shape, scale, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        # time mixing
        "w_r": normal((d_model, d_model), s),
        "w_k": normal((d_model, d_model), s),
        "w_v": normal((d_model, d_model), s),
        "w_g": normal((d_model, d_model), s),
        "w_decay": normal((d_model, d_model), 0.1 * s),
        "decay_bias": full((d_model,), -5.0),
        "bonus_u": normal((num_heads, head_size), 0.5),
        "mix_coeff": full((5, d_model), 0.5),
        "w_out_t": normal((d_model, d_model), s),
        "ln_x_scale": full((d_model,), 1.0),
        # channel mixing
        "cm_wk": normal((d_model, d_ff), s),
        "cm_wv": normal((d_ff, d_model), 0.5 * s),
        "cm_wr": normal((d_model, d_model), s),
        "cm_mix": full((2, d_model), 0.5),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Shift the sequence right by one; ``last`` supplies the carry for
    decode (zeros when None)."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None, :].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(params: dict, x: torch.Tensor, head_size: int,
                  state: torch.Tensor | None = None,
                  x_last: torch.Tensor | None = None,
                  impl: str = "reference"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, final_wkv_state, last_token) for chaining decode."""
    if impl not in IMPLS:
        raise ValueError(f"unknown rwkv impl {impl!r}; known: {IMPLS}")
    b, s, d = x.shape
    h = d // head_size
    shifted = _token_shift(x, x_last)
    mix = params["mix_coeff"]
    xr = x * mix[0] + shifted * (1 - mix[0])
    xk = x * mix[1] + shifted * (1 - mix[1])
    xv = x * mix[2] + shifted * (1 - mix[2])
    xg = x * mix[3] + shifted * (1 - mix[3])
    xw = x * mix[4] + shifted * (1 - mix[4])

    r = (xr @ params["w_r"]).reshape(b, s, h, head_size)
    k = (xk @ params["w_k"]).reshape(b, s, h, head_size)
    v = (xv @ params["w_v"]).reshape(b, s, h, head_size)
    g = F.silu(xg @ params["w_g"])
    # data-dependent decay in (0, 1):  w = exp(-exp(decay))
    decay = params["decay_bias"] + xw @ params["w_decay"]
    w = torch.exp(-torch.exp(decay.float())).reshape(b, s, h, head_size)

    if impl == "cuda":
        from repro_torch.kernels.rwkv6 import ops as wkv_ops
        out, final = wkv_ops.wkv6(r, k, v, w.to(r.dtype), params["bonus_u"],
                                  state)
    else:
        out, final = wkv6_ref(r, k, v, w.to(r.dtype), params["bonus_u"],
                              state)
    # group-norm over heads (ln_x in the reference implementation)
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, unbiased=False)
    out = ((out - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, d)
    out = out * params["ln_x_scale"] * g
    return out @ params["w_out_t"], final, x[:, -1, :]


def rwkv_channel_mix(params: dict, x: torch.Tensor,
                     x_last: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    shifted = _token_shift(x, x_last)
    mix = params["cm_mix"]
    xk = x * mix[0] + shifted * (1 - mix[0])
    xr = x * mix[1] + shifted * (1 - mix[1])
    k = torch.square(F.relu(xk @ params["cm_wk"]))
    kv = k @ params["cm_wv"]
    return torch.sigmoid(xr @ params["cm_wr"]) * kv, x[:, -1, :]


def init_rwkv_state(batch: int, d_model: int, head_size: int,
                    device) -> dict:
    h = d_model // head_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wkv": torch.zeros(batch, h, head_size, head_size, **f32),
        "tm_last": torch.zeros(batch, d_model, **f32),
        "cm_last": torch.zeros(batch, d_model, **f32),
    }


def rwkv_time_mix_decode(params: dict, x: torch.Tensor, head_size: int,
                         state: dict) -> tuple[torch.Tensor, dict]:
    """Time mixing of x (batch, s, d) from a carried state (plain path, as
    in the JAX package); returns the output and the advanced state."""
    out, wkv, last = rwkv_time_mix(params, x, head_size, state=state["wkv"],
                                   x_last=state["tm_last"].to(x.dtype))
    return out, {**state, "wkv": wkv, "tm_last": last.float()}
