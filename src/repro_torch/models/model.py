"""The LM: ArchConfig -> init / features / logits / decode.

Counterpart of ``repro.models.model``: attention, mamba and rwkv
mixers; dense and moe ffns.  The JAX package stacks
layer parameters per period and scans over them; the port keeps one
parameter dict per layer in ``params["layers"]`` and loops over it in
Python, layer ``period * len(pattern) + i`` holding pattern entry ``i``.

Bilevel split, as in the JAX package: ``features`` returns the final
hidden states of the backbone (the outer variable x); the LM head is a
separate (d_model, vocab) parameter (the inner variable y).
``init_params(..., with_head=True)`` includes one, and ``forward`` goes
end to end; ``lm_loss`` is the next-token cross entropy of its logits.
``features(..., remat=True)`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), where the JAX package
checkpoints each period: only the residual stream between layers stays
saved.

The moe ffn has two routes, as in the JAX package: ``features`` and
``forward`` take ``moe_impl="capacity"`` (``moe_ffn``, which drops the
tokens past each expert's capacity) by default, and the cached path
(``prefill``, ``decode_step``) runs ``moe_impl="exact"``
(``moe_ffn_exact``, no drops).  Where a token is dropped the two compute
different functions.

The vision and audio frontends are stubs, as in the JAX package:
``features`` and ``forward`` take ``prefix_embed``, precomputed patch or
frame embeddings (batch, num_prefix_tokens, frontend_dim), which go
through the ``frontend_proj`` parameter and are put before the scaled
token embeddings; positions run over prefix and tokens.  The cached
path (``prefill``, ``decode_step``) takes no prefix, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as Mb
from repro_torch.models import moe as Moe
from repro_torch.models import rwkv as Rk
from repro_torch.models.base import ArchConfig, LayerSpec

__all__ = [
    "decode_step", "features", "forward", "head_logits", "init_cache",
    "init_head", "init_params", "lm_head", "lm_loss", "param_count",
    "prefill",
]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _window(cfg: ArchConfig, spec: LayerSpec) -> int | None:
    if cfg.long_context_mode == "window" and spec.sliding_window is None:
        return cfg.local_window
    return spec.sliding_window


def _layer_specs(cfg: ArchConfig) -> list[LayerSpec]:
    pattern = cfg.layer_pattern()
    return [pattern[i % len(pattern)]
            for i in range(cfg.num_periods() * len(pattern))]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(cfg: ArchConfig, spec: LayerSpec, gen: torch.Generator,
                device: torch.device) -> dict:
    dt = _dtype(cfg)
    p: dict[str, Any] = {"pre_norm": L.init_rms_norm(cfg.d_model, dt, device),
                         "post_norm": L.init_rms_norm(cfg.d_model, dt,
                                                      device)}
    if spec.mixer == "attn":
        p["attn"] = L.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dt, device)
    elif spec.mixer == "mamba":
        p["mamba"] = Mb.init_mamba(gen, cfg.d_model, cfg.mamba_d_state,
                                   cfg.mamba_d_conv, cfg.mamba_expand, dt,
                                   device)
    else:
        p["rwkv"] = Rk.init_rwkv_block(gen, cfg.d_model, cfg.rwkv_head_size,
                                       dt, device, cfg.d_ff)
    if spec.ffn == "dense" and spec.mixer != "rwkv":
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dt, device)
    elif spec.ffn == "moe":
        p["moe"] = Moe.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                dt, device)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, with_head: bool = False,
                device: str | torch.device | None = None) -> dict:
    """Backbone parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the JAX package's distributions, other
    numbers): {"embed", "final_norm", "layers": [one dict per layer]},
    "frontend_proj" (frontend_dim, d_model) for a config with a
    frontend's prefix tokens and, with ``with_head``, "head"."""
    device = resolve_device(device)
    cfg.validate()
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg)
    params: dict[str, Any] = {
        "embed": L.init_normal(gen, (cfg.vocab_size, cfg.d_model),
                               1.0 / math.sqrt(cfg.d_model), dt, device),
        "final_norm": L.init_rms_norm(cfg.d_model, dt, device),
        "layers": [_init_layer(cfg, spec, gen, device)
                   for spec in _layer_specs(cfg)],
    }
    if cfg.frontend != "none" and cfg.num_prefix_tokens:
        fd = cfg.frontend_dim or cfg.d_model
        params["frontend_proj"] = L.init_normal(
            gen, (fd, cfg.d_model), 1.0 / math.sqrt(fd), dt, device)
    if with_head:
        params["head"] = init_head(cfg, gen, device)
    return params


def init_head(cfg: ArchConfig, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """The inner-variable readout head y (d_model, vocab)."""
    return L.init_normal(gen, (cfg.d_model, cfg.vocab_size),
                         1.0 / math.sqrt(cfg.d_model), _dtype(cfg), device)


def param_count(params) -> int:
    def count(tree):
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        if isinstance(tree, dict):
            return sum(count(t) for t in tree.values())
        return sum(count(t) for t in tree)
    return count(params)


# ---------------------------------------------------------------------------
# Forward (training / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, impl: str = "reference",
                 cache: dict | None = None, moe_impl: str = "capacity",
                 pod=None
                 ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Pre-norm residual layer.  Returns (x, new_cache, aux): the moe
    ffn's aux loss, else a float32 zero.  ``impl`` picks the no-cache
    attention and WKV6 route; the cached branches are plain, as in the
    JAX package.  A mamba layer with a cache prefills a fresh one from a
    sequence and steps it from one token.  ``pod``: x is this rank's
    share of its pod's batch (the moe capacity route is the pod's)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.rms_norm(p["pre_norm"], x, cfg.norm_eps)
    new_cache = cache
    if spec.mixer == "attn":
        out, new_attn = L.attention(
            p["attn"], h, positions,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=_window(cfg, spec), logit_softcap=cfg.attn_logit_softcap,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
            cache=None if cache is None else cache["attn"], impl=impl)
        if cache is not None:
            new_cache = {**cache, "attn": new_attn}
    elif spec.mixer == "mamba":
        if cache is None:
            out = Mb.mamba_block(p["mamba"], h,
                                 seq_chunk=cfg.mamba_seq_chunk or None)
        elif h.shape[1] > 1:   # prefill into a fresh cache
            out, st = Mb.mamba_prefill(p["mamba"], h)
            new_cache = {**cache, "mamba": st}
        else:
            out, st = Mb.mamba_decode_step(p["mamba"], h, cache["mamba"])
            new_cache = {**cache, "mamba": st}
    else:
        if cache is None:
            out, _, _ = Rk.rwkv_time_mix(p["rwkv"], h, cfg.rwkv_head_size,
                                         impl=impl)
        else:
            out, st = Rk.rwkv_time_mix_decode(p["rwkv"], h,
                                              cfg.rwkv_head_size,
                                              cache["rwkv"])
            new_cache = {**cache, "rwkv": st}
    x = x + out

    h = L.rms_norm(p["post_norm"], x, cfg.norm_eps)
    if spec.mixer == "rwkv":
        # RWKV uses its own token-shifted channel mix as the FFN.
        if cache is None:
            out, _ = Rk.rwkv_channel_mix(p["rwkv"], h)
        else:
            out, cm_last = Rk.rwkv_channel_mix(
                p["rwkv"], h,
                x_last=new_cache["rwkv"]["cm_last"].to(h.dtype))
            new_cache = {**new_cache,
                         "rwkv": {**new_cache["rwkv"],
                                  "cm_last": cm_last.float()}}
        return x + out, new_cache, aux
    if spec.ffn == "dense":
        return x + L.gated_mlp(p["mlp"], h), new_cache, aux
    if spec.ffn == "moe":
        if moe_impl == "exact":
            out, aux = Moe.moe_ffn_exact(p["moe"], h,
                                         num_experts=cfg.num_experts,
                                         top_k=cfg.experts_per_token)
        elif moe_impl == "capacity":
            out, aux = Moe.moe_ffn(p["moe"], h, num_experts=cfg.num_experts,
                                   top_k=cfg.experts_per_token,
                                   capacity_factor=cfg.capacity_factor,
                                   token_chunk=cfg.moe_token_chunk or None,
                                   expert_parallel=cfg.expert_parallel,
                                   pod=pod)
        else:
            raise ValueError(f"unknown moe_impl {moe_impl!r}; known: "
                             "'capacity', 'exact'")
        return x + out, new_cache, aux
    return x, new_cache, aux   # ffn "none": the JAX package adds zeros


def _embed(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
           prefix_embed: torch.Tensor | None = None) -> torch.Tensor:
    """The scaled token embeddings, after the prefix (cast to their
    dtype and projected by ``frontend_proj`` where there is one; not
    scaled) when one is given."""
    embed = params["embed"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=embed.dtype,
                         device=embed.device)
    x = embed[tokens] * scale
    if prefix_embed is None:
        return x
    pre = prefix_embed.to(x.dtype)
    if "frontend_proj" in params:
        pre = pre @ params["frontend_proj"]
    return torch.cat([pre, x], dim=1)


def features(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
             prefix_embed: torch.Tensor | None = None,
             impl: str = "reference", remat: bool = False,
             moe_impl: str = "capacity", pod=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backbone features (batch, [prefix +] seq, d_model), and the moe
    ffns' aux loss summed over the layers in float32 (zero without a moe
    ffn).  ``prefix_embed`` (batch, prefix, frontend_dim) goes before the
    tokens.  ``impl`` routes attention and WKV6: ``"reference"``,
    ``"blockwise"`` or ``"cuda"``; ``moe_impl`` the moe ffn:
    ``"capacity"`` or ``"exact"``.  ``remat`` recomputes each layer in
    the backward pass (a no-op where autograd is not recording).
    ``pod`` (an ``AgentMesh`` of a pod's ranks): the batch is this rank's
    share of the pod's, and each capacity route is the pod's batch's
    (``moe_ffn``); every other layer is per token."""
    x = _embed(cfg, params, tokens, prefix_embed)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in zip(_layer_specs(cfg), params["layers"]):
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(lambda h, spec=spec, p=p: _apply_layer(
                cfg, spec, p, h, positions, impl, moe_impl=moe_impl,
                pod=pod)[::2], x, use_reentrant=False)
        else:
            x, _, a = _apply_layer(cfg, spec, p, x, positions, impl,
                                   moe_impl=moe_impl, pod=pod)
        aux = aux + a
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, aux


def head_logits(cfg: ArchConfig, head: torch.Tensor,
                feats: torch.Tensor) -> torch.Tensor:
    return L.softcap(feats @ head, cfg.final_logit_softcap)


def lm_head(params: dict) -> torch.Tensor:
    """The (d_model, vocab) readout: the head, else the tied embedding."""
    return params["head"] if "head" in params else params["embed"].T


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            prefix_embed: torch.Tensor | None = None,
            impl: str = "reference", remat: bool = False,
            moe_impl: str = "capacity"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    feats, aux = features(cfg, params, tokens, prefix_embed, impl, remat,
                          moe_impl)
    return head_logits(cfg, lm_head(params), feats), aux


def lm_loss(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor,
            aux: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token CE; labels aligned with the *token* part of the sequence
    (a prefix's logits, if any, are dropped)."""
    n_pre = logits.shape[1] - labels.shape[1]
    logp = F.log_softmax(logits[:, n_pre:].float(), dim=-1)
    nll = -torch.gather(logp[:, :-1], -1, labels[:, 1:, None])
    loss = nll.mean()
    if aux is not None:
        loss = loss + cfg.router_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      max_len: int, device: torch.device) -> dict:
    if spec.mixer == "rwkv":
        return {"rwkv": Rk.init_rwkv_state(batch, cfg.d_model,
                                           cfg.rwkv_head_size, device)}
    if spec.mixer == "mamba":
        return {"mamba": Mb.init_mamba_state(
            batch, cfg.d_model, cfg.mamba_d_state, cfg.mamba_d_conv,
            cfg.mamba_expand, _dtype(cfg), device)}
    window = _window(cfg, spec)
    # SWA layers only ever need `window` slots; full layers the sequence.
    size = max_len if window is None else min(max_len, window)
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"attn": {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=device),
        "len": 0,
    }}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: str | torch.device | None = None) -> list[dict]:
    """One decode cache per layer: KV ring buffers for attention layers,
    (h, conv tail) states for mamba layers, (wkv, token-shift) states for
    rwkv layers."""
    device = resolve_device(device)
    return [_init_layer_cache(cfg, spec, batch, max_len, device)
            for spec in _layer_specs(cfg)]


def _decode_features(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
                     cache: list[dict], positions: torch.Tensor
                     ) -> tuple[torch.Tensor, list[dict]]:
    x = _embed(cfg, params, tokens)
    new_cache = []
    for spec, p, c in zip(_layer_specs(cfg), params["layers"], cache):
        x, nc, _ = _apply_layer(cfg, spec, p, x, positions, cache=c,
                                moe_impl="exact")
        new_cache.append(nc)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps), new_cache


def prefill(cfg: ArchConfig, params: dict, head: torch.Tensor | None,
            tokens: torch.Tensor, cache: list[dict]
            ) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence forward that populates a fresh decode cache.

    Returns (last-token logits (batch, vocab), cache).  The head is
    applied to the last position only; the JAX package computes every
    position's logits and keeps the last, which gives the same result.
    """
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, new_cache = _decode_features(cfg, params, tokens, cache, positions)
    head = lm_head(params) if head is None else head
    return head_logits(cfg, head, x[:, -1, :]), new_cache


def decode_step(cfg: ArchConfig, params: dict, head: torch.Tensor | None,
                token: torch.Tensor, cache: list[dict],
                position: int | torch.Tensor
                ) -> tuple[torch.Tensor, list[dict]]:
    """One-token decode.  token (batch, 1) int64; position an int (or an
    (s,) position vector).  Returns (logits (batch, s, vocab), cache).
    Attention caches are written in place."""
    positions = torch.as_tensor(position, device=token.device).reshape(-1)
    x, new_cache = _decode_features(cfg, params, token, cache, positions)
    head = lm_head(params) if head is None else head
    return head_logits(cfg, head, x), new_cache
