"""Mamba (S6) block: the SSM mixer of jamba's 7-of-8 layers.

Counterpart of ``repro.models.mamba``.  Selective state-space model:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t      (diagonal A < 0)
    y_t = C_t . h_t + D x_t

The prefill path (``mamba_block``, ``mamba_prefill``) runs the
recurrence as a parallel prefix over the pairs (decay, drive), combined
as (d1, x1) then (d2, x2) -> (d1 d2, x1 d2 + x2).  The JAX package uses
``jax.lax.associative_scan``; the port a doubling (Hillis-Steele) scan
in plain PyTorch (``_scan``): log2(s) passes of elementwise products,
the same algebra, which stays bounded because every decay is at most 1.
(Factoring out exp(cumsum(log decay)) and dividing it back in would
overflow: the log-decay reaches -600 over 2048 steps at dt ~ 0.018 and
A down to -16.)  Decode is the O(1) single-step recurrence on a carried
state.

Dtypes as in the JAX package: ``bcdt`` and ``dt`` in the model dtype,
``A = -exp(a_log)``, the state and y in float32, the output cast back
to the model dtype before ``w_out``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import init_normal

__all__ = ["init_mamba", "init_mamba_state", "mamba_block",
           "mamba_decode_step", "mamba_prefill"]


def init_mamba(gen: torch.Generator, d_model: int, d_state: int,
               d_conv: int, expand: int, dtype, device) -> dict:
    d_inner = expand * d_model
    si, sinner = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_inner)

    def normal(shape, scale):
        return init_normal(gen, shape, scale, dtype, device)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    # S4D-real initialisation for A: a_log[i, n] = log(n + 1)
    a_init = torch.arange(1, d_state + 1, dtype=torch.float32,
                          device=device).repeat(d_inner, 1)
    return {
        "w_in": normal((d_model, 2 * d_inner), si),
        "conv_w": normal((d_conv, d_inner), 0.2),
        "conv_b": full((d_inner,), 0.0),
        "w_bcdt": normal((d_inner, 2 * d_state + 1), sinner),
        "dt_bias": full((d_inner,), -4.0),   # softplus^-1(~0.018)
        "w_dt": normal((1, d_inner), 0.1),
        "a_log": torch.log(a_init).to(dtype),
        "d_skip": full((d_inner,), 1.0),
        "w_out": normal((d_inner, d_model), sinner),
    }


def _ssm_params(params: dict, u: torch.Tensor):
    """Input-dependent (dt, B, C) from the post-conv activations u, and
    A = -exp(a_log) in float32."""
    bcdt = u @ params["w_bcdt"]                       # (..., 2*ds + 1)
    d_state = (bcdt.shape[-1] - 1) // 2
    B, C, dt_raw = torch.split(bcdt, [d_state, d_state, 1], dim=-1)
    dt = F.softplus(dt_raw @ params["w_dt"] + params["dt_bias"])
    A = -torch.exp(params["a_log"].float())           # (d_inner, d_state)
    return dt, B, C, A


def _causal_conv(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (batch, seq, d_inner)."""
    d_conv = params["conv_w"].shape[0]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * params["conv_w"][i]
              for i in range(d_conv))
    return out + params["conv_b"]


def _scan(dt32: torch.Tensor, u32: torch.Tensor, B32: torch.Tensor,
          A: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = decay_t h_{t-1} + drive_t (h_{-1} = 0) over the
    sequence, decay = exp(dt A) and drive = dt u B, by doubling: after
    the pass at offset o, position t holds the composition of positions
    t - 2o + 1 .. t.  Out of place, so autograd can differentiate it;
    the pairs are made here, so each pass frees the last one's where
    autograd does not keep them."""
    decay = torch.exp(dt32[..., None] * A)            # (b, s, d_inner, N)
    drive = (dt32 * u32)[..., None] * B32[..., None, :]
    s = decay.shape[1]
    off = 1
    while off < s:
        drive = torch.cat([drive[:, :off], torch.addcmul(
            drive[:, off:], drive[:, :-off], decay[:, off:])], dim=1)
        if 2 * off < s:
            decay = torch.cat([decay[:, :off],
                               decay[:, off:] * decay[:, :-off]], dim=1)
        off *= 2
    return drive


def _ssm_apply(params: dict, u, dt, B, C, A, h0=None):
    """Selective scan over the full given span; returns (y, h_last).

    h_t = decay_t h_{t-1} + drive_t, with optional incoming state h0
    folded in closed form: h_t += (prod_{j<=t} decay_j) h0.
    """
    dt32, u32 = dt.float(), u.float()
    B32, C32 = B.float(), C.float()
    h = _scan(dt32, u32, B32, A)                      # (b, s, d_inner, N)
    if h0 is not None:
        carried = torch.exp(torch.cumsum(dt32[..., None] * A, dim=1))
        h = h + carried * h0[:, None]
    y = torch.einsum("bsdn,bsn->bsd", h, C32)
    y = y + params["d_skip"].float() * u32
    # a copy: a view of the last step would keep all of h alive in the
    # decode cache (2.15 GB a layer at jamba's (1, 2048) prefill)
    return y, h[:, -1].clone()


def _in_proj(params: dict, x: torch.Tensor):
    """(u before the conv, u after conv and silu, z)."""
    u_pre, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    return u_pre, F.silu(_causal_conv(params, u_pre)), z


def _out_proj(params: dict, y: torch.Tensor, z: torch.Tensor,
              dtype) -> torch.Tensor:
    y = (y * F.silu(z.float())).to(dtype)
    return y @ params["w_out"]


def mamba_block(params: dict, x: torch.Tensor,
                seq_chunk: int | None = None) -> torch.Tensor:
    """x: (batch, seq, d_model) -> same; the training and prefill path.

    ``seq_chunk``: run the scan in sequence chunks with a carried (d_inner,
    N) state, which bounds the (b, s, d_inner, N) decay and drive
    temporaries to O(b * chunk * d_inner * N) (used when it divides the
    sequence and is shorter); each chunk is recomputed in the backward
    pass, as the JAX package checkpoints its scan body.
    """
    b, s, _ = x.shape
    _, u, z = _in_proj(params, x)
    dt, B, C, A = _ssm_params(params, u)

    if seq_chunk is None or s % seq_chunk != 0 or s <= seq_chunk:
        y, _ = _ssm_apply(params, u, dt, B, C, A)
    else:
        h = torch.zeros(b, u.shape[-1], A.shape[-1], dtype=torch.float32,
                        device=x.device)

        def body(h, uc, dtc, Bc, Cc):
            return _ssm_apply(params, uc, dtc, Bc, Cc, A, h0=h)

        ys = []
        for lo in range(0, s, seq_chunk):
            chunk = [t[:, lo:lo + seq_chunk] for t in (u, dt, B, C)]
            if torch.is_grad_enabled():
                yc, h = checkpoint(body, h, *chunk, use_reentrant=False)
            else:
                yc, h = body(h, *chunk)
            ys.append(yc)
        y = torch.cat(ys, dim=1)
    return _out_proj(params, y, z, x.dtype)


def mamba_prefill(params: dict, x: torch.Tensor,
                  seq_chunk: int | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also emits the decode state of a fresh
    cache: the recurrent h after the last token and the conv tail (the
    last ``d_conv - 1`` rows of u before the conv, left-padded with zeros
    when the sequence is shorter).  ``seq_chunk`` is ignored, as in the
    JAX package."""
    s = x.shape[1]
    u_pre, u, z = _in_proj(params, x)
    dt, B, C, A = _ssm_params(params, u)
    y, h_last = _ssm_apply(params, u, dt, B, C, A)
    out = _out_proj(params, y, z, x.dtype)

    tail = params["conv_w"].shape[0] - 1
    if s >= tail:
        conv_tail = u_pre[:, s - tail:, :]
    else:
        conv_tail = F.pad(u_pre, (0, 0, tail - s, 0))
    # a copy, as h_last is: the slice is a view of the whole projection
    return out, {"h": h_last, "conv": conv_tail.to(x.dtype, copy=True)}


def init_mamba_state(batch: int, d_model: int, d_state: int, d_conv: int,
                     expand: int, dtype, device) -> dict:
    d_inner = expand * d_model
    return {
        "h": torch.zeros(batch, d_inner, d_state, dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(batch, d_conv - 1, d_inner, dtype=dtype,
                            device=device),
    }


def mamba_decode_step(params: dict, x: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
    """Single-token step.  x: (batch, 1, d_model).  Returns the output and
    a new state (the given one is not written)."""
    u, z = torch.chunk(x @ params["w_in"], 2, dim=-1)  # (b, 1, d_inner)
    conv_buf = torch.cat([state["conv"], u.to(state["conv"].dtype)], dim=1)
    u_conv = (torch.einsum("bkd,kd->bd", conv_buf, params["conv_w"])
              + params["conv_b"])
    u_act = F.silu(u_conv)[:, None, :]                # (b, 1, d_inner)

    dt, B, C, A = _ssm_params(params, u_act)
    dt32 = dt[:, 0].float()
    u32 = u_act[:, 0].float()
    decay = torch.exp(dt32[..., None] * A)            # (b, d_inner, d_state)
    drive = (dt32 * u32)[..., None] * B[:, 0].float()[:, None, :]
    h = state["h"] * decay + drive
    y = torch.einsum("bdn,bn->bd", h, C[:, 0].float())
    y = y + params["d_skip"].float() * u32
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = (y @ params["w_out"])[:, None, :]
    return out, {"h": h, "conv": conv_buf[:, 1:, :]}
