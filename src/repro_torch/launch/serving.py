"""Serving steps: prefill (full-sequence forward) and decode (one token).

Counterpart of ``repro.launch.serving`` on one card: there is nothing to
shard, so the JAX ``seq_shard`` option waits for a multi-card slice.
Both steps take parameters made by ``repro_torch.models.model.
init_params`` on the step's device.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig

__all__ = ["make_prefill_step", "make_serve_step"]


def _check_impl(attn_impl: str) -> None:
    if attn_impl not in L.IMPLS:
        raise ValueError(f"unknown attention impl {attn_impl!r}; "
                         f"known: {L.IMPLS}")


def make_prefill_step(cfg: ArchConfig, *, attn_impl: str = "reference",
                      device: str | torch.device | None = None):
    """prefill(params, tokens, prefix=None) -> last-token logits (batch,
    vocab).

    The full-sequence forward with no cache; ``attn_impl="cuda"`` routes
    attention and WKV6 through the hand-written kernels,
    ``"blockwise"`` attention through ``attention_blockwise``.  ``prefix``
    (batch, num_prefix_tokens, frontend_dim), a frontend's embeddings, is
    moved to the step's device and put before the tokens.  A moe ffn takes
    the capacity route (``moe_ffn``), as in the JAX package, so where a
    token is dropped this differs from the cached ``prefill``, which
    routes exactly.  Only the last position's features go through the
    head.  Runs on ``device`` (the CUDA card when None; raises where
    there is none).
    """
    _check_impl(attn_impl)
    device = resolve_device(device)

    def prefill(params: dict, tokens: torch.Tensor,
                prefix: torch.Tensor | None = None) -> torch.Tensor:
        if prefix is not None:
            prefix = prefix.to(device)
        feats, _aux = M.features(cfg, params, tokens.to(device),
                                 prefix_embed=prefix, impl=attn_impl)
        return M.head_logits(cfg, M.lm_head(params), feats[:, -1, :])

    return prefill


def make_serve_step(cfg: ArchConfig, *, attn_impl: str = "reference",
                    device: str | torch.device | None = None):
    """serve(params, token, cache, position) -> (logits, new_cache).

    ONE new token per request against the decode cache of
    ``init_cache``, which it updates in place.  Runs on ``device`` (the
    CUDA card when None; raises where there is none).  ``attn_impl`` is
    checked and otherwise changes nothing: it mirrors the JAX signature,
    and the cached branches are plain attention in both packages.  A moe
    ffn routes exactly (``moe_ffn_exact``), a mamba layer steps its
    carried state.  Like the cached path, it takes no prefix.
    """
    _check_impl(attn_impl)
    device = resolve_device(device)

    def serve(params: dict, token: torch.Tensor, cache: list[dict],
              position: int) -> tuple[torch.Tensor, list[dict]]:
        head = params["head"] if "head" in params else None
        logits, new_cache = M.decode_step(cfg, params, head,
                                          token.to(device), cache, position)
        return logits[:, 0, :], new_cache

    return serve
