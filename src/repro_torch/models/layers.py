"""Shared transformer layers: RMSNorm, RoPE, GQA attention, gated MLP.

Counterpart of ``repro.models.layers``, with its layouts at every public
function: q (b, s, h, hd), ``wq`` (d, h, hd), ``wo`` (h, hd, d).
Parameters are plain dicts of tensors.  ``attention`` takes
``impl="reference"`` (the plain ``attention_ref``), ``impl="blockwise"``
(``attention_blockwise``: the streaming softmax over kv blocks, plain
PyTorch as the JAX package's is XLA code) or ``impl="cuda"`` (the
hand-written flash kernel of ``repro_torch.kernels.flash_attention`` on
CUDA tensors, its plain version on CPU tensors) on its no-cache branch;
its cached prefill and ring-buffer decode branches are plain, as in the
JAX package.

Supported attention variants: grouped-query (num_kv_heads < num_heads)
and MQA, causal masking, sliding window, attention-logit softcapping,
per-head q/k RMSNorm, single-token decode against a ring-buffer KV cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "IMPLS", "apply_rope", "attention", "attention_blockwise",
    "attention_ref", "gated_mlp",
    "init_attention", "init_mlp", "init_normal", "init_rms_norm",
    "rms_norm", "rope_frequencies", "softcap",
]

# How attention and WKV6 run on their kernel paths: the plain PyTorch
# version, attention's streaming softmax over kv blocks (WKV6 runs its
# plain version there, as in the JAX package), or the hand-written kernel
# (its plain version on CPU tensors).
IMPLS = ("reference", "blockwise", "cuda")

# the position ``attention_blockwise`` gives padded keys: the JAX
# package's int32 max, past every query, so the causal mask hides them
PAD_POSITION = 2 ** 31 - 1

Params = dict


def init_normal(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """Standard normal draws times ``scale``, made in float32 and cast."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_rms_norm(d: int, dtype, device) -> Params:
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + params["scale"].float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qk_norm: bool, dtype,
                   device) -> Params:
    scale_in = 1.0 / math.sqrt(d_model)
    scale_out = 1.0 / math.sqrt(num_heads * head_dim)
    p = {
        "wq": init_normal(gen, (d_model, num_heads, head_dim), scale_in,
                          dtype, device),
        "wk": init_normal(gen, (d_model, num_kv_heads, head_dim), scale_in,
                          dtype, device),
        "wv": init_normal(gen, (d_model, num_kv_heads, head_dim), scale_in,
                          dtype, device),
        "wo": init_normal(gen, (num_heads, head_dim, d_model), scale_out,
                          dtype, device),
    }
    if qk_norm:
        p["q_norm"] = init_rms_norm(head_dim, dtype, device)
        p["k_norm"] = init_rms_norm(head_dim, dtype, device)
    return p


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: int | None) -> torch.Tensor:
    """(q, k) boolean mask: causal, optionally sliding-window."""
    causal = q_pos[:, None] >= k_pos[None, :]
    if window is None:
        return causal
    return causal & (q_pos[:, None] - k_pos[None, :] < window)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  window: int | None = None,
                  logit_softcap: float | None = None,
                  kv_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Exact softmax GQA attention over explicit positions.

    q (b, q_len, heads, hd), k and v (b, kv_len, kv_heads, hd),
    q_positions (q_len,), kv_positions (kv_len,), kv_valid (kv_len,) bool.
    """
    b, qlen, nh, hd = q.shape
    nkv = k.shape[2]
    group = nh // nkv
    qg = q.reshape(b, qlen, nkv, group, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = softcap(logits, logit_softcap)
    mask = _attn_mask(q_positions, kv_positions, window)
    if kv_valid is not None:
        mask = mask & kv_valid[None, :]
    logits = torch.where(mask, logits, torch.tensor(-1e30,
                                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, qlen, nh, hd).to(q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor,
                        kv_positions: torch.Tensor,
                        window: int | None = None,
                        logit_softcap: float | None = None,
                        block_k: int = 1024) -> torch.Tensor:
    """Streaming-softmax GQA attention over kv blocks of ``block_k``.

    Counterpart of the JAX ``attention_blockwise``: the same online
    softmax recurrence in float32 (running max, rescaled sum and
    accumulator), never holding the (q_len, kv_len) scores, so peak
    attention memory is O(q_len * block_k).  k, v and their positions are
    padded to a block multiple, the padded keys at ``PAD_POSITION``, which
    the causal mask hides; masked scores are -1e30.  Under autograd each
    block is recomputed in the backward pass (``torch.utils.checkpoint``,
    non-reentrant), as ``jax.checkpoint`` does there.
    """
    b, sq, nh, hd = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    scale = 1.0 / float(hd) ** 0.5
    pad = (-skv) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=PAD_POSITION)
    qg = q.reshape(b, sq, nkv, group, hd).float()

    def block(acc, mx, lse, kc, vc, pc):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.float()) * scale
        s = softcap(s, logit_softcap)
        mask = q_positions[:, None] >= pc[None, :]
        if window is not None:
            mask = mask & (q_positions[:, None] - pc[None, :] < window)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(mx, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(mx - m_new)
        lse = lse * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vc.float())
        return acc, m_new, lse

    acc = torch.zeros((b, nkv, group, sq, hd), dtype=torch.float32,
                      device=q.device)
    mx = torch.full((b, nkv, group, sq), -1e30, dtype=torch.float32,
                    device=q.device)
    lse = torch.zeros((b, nkv, group, sq), dtype=torch.float32,
                      device=q.device)
    remat = torch.is_grad_enabled()
    for lo in range(0, k.shape[1], block_k):
        xs = (k[:, lo:lo + block_k], v[:, lo:lo + block_k],
              kv_positions[lo:lo + block_k])
        if remat:
            acc, mx, lse = checkpoint(block, acc, mx, lse, *xs,
                                      use_reentrant=False)
        else:
            acc, mx, lse = block(acc, mx, lse, *xs)
    out = acc / torch.clamp(lse, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(b, sq, nh, hd).to(q.dtype)


def attention(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
              num_heads: int, num_kv_heads: int, head_dim: int,
              rope_theta: float, window: int | None,
              logit_softcap: float | None, qk_norm: bool, norm_eps: float,
              cache: dict | None = None, impl: str = "reference"
              ) -> tuple[torch.Tensor, dict | None]:
    """Full attention layer: qkv projection, rope, SDPA, out projection.

    ``cache`` (decode): {"k": (b, size, kv, hd), "v": ..., "len": int} —
    a ring buffer; token p lives in slot p mod size.  The port writes the
    new keys and values into the cache tensors in place (the JAX package
    returns updated copies) and returns the same dict with ``len``
    advanced.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; known: {IMPLS}")
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if qk_norm:
        q = rms_norm(params["q_norm"], q, norm_eps)
        k = rms_norm(params["k_norm"], k, norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is not None and s > 1:
        # Prefill into a fresh cache: attend among the new tokens exactly,
        # then lay the (last ``size``) roped keys into their ring slots
        # (token p -> slot p mod size).
        ck, cv = cache["k"], cache["v"]
        size = ck.shape[1]
        out = attention_ref(q, k, v, positions, positions, window,
                            logit_softcap)
        if s >= size:
            ck.copy_(torch.roll(k[:, -size:], s % size, dims=1))
            cv.copy_(torch.roll(v[:, -size:], s % size, dims=1))
        else:
            ck[:, :s] = k
            cv[:, :s] = v
        new_cache = {"k": ck, "v": cv, "len": cache["len"] + s}
    elif cache is not None:
        # Decode: slot j holds absolute position idx - ((idx - j) mod size)
        # (negative: not yet written).  Keys are stored after RoPE, so
        # positions are needed only for the mask.
        idx = cache["len"]
        ck, cv = cache["k"], cache["v"]
        size = ck.shape[1]
        slot = idx % size
        ck[:, slot:slot + s] = k
        cv[:, slot:slot + s] = v
        j = torch.arange(size, device=x.device)
        kv_pos = idx - torch.remainder(idx - j, size)
        out = attention_ref(q, ck, cv, positions, kv_pos, window,
                            logit_softcap, kv_valid=kv_pos >= 0)
        new_cache = {"k": ck, "v": cv, "len": idx + s}
    else:
        if impl == "cuda":
            from repro_torch.kernels.flash_attention import ops as fa_ops
            out = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                         logit_softcap=logit_softcap)
        elif impl == "blockwise":
            out = attention_blockwise(q, k, v, positions, positions, window,
                                      logit_softcap)
        else:
            out = attention_ref(q, k, v, positions, positions, window,
                                logit_softcap)
        new_cache = None

    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU family)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> Params:
    si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "w_gate": init_normal(gen, (d_model, d_ff), si, dtype, device),
        "w_up": init_normal(gen, (d_model, d_ff), si, dtype, device),
        "w_down": init_normal(gen, (d_ff, d_model), so, dtype, device),
    }


def gated_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    return (gate * (x @ params["w_up"])) @ params["w_down"]
