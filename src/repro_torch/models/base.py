"""Architecture configuration schema (a copy of ``repro.models.base``).

Every assigned architecture is expressed as an ``ArchConfig``; the model
(``repro_torch/models/model.py``) consumes only this schema, so
adding an architecture is a config file, not code.

Layers are organised into repeating *periods* (jamba's 1:7
attention:mamba interleave, gemma2's local/global alternation).  The JAX
package scans over stacked period parameters; the port keeps one
parameter dict per layer and loops over them in Python, layer
``period * len(pattern) + i`` holding pattern entry ``i``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

__all__ = ["LayerSpec", "ArchConfig"]

Mixer = Literal["attn", "mamba", "rwkv"]
Ffn = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period."""

    mixer: Mixer = "attn"
    ffn: Ffn = "dense"
    sliding_window: int | None = None  # None = full/global attention


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # --- identity -----------------------------------------------------
    name: str = "unnamed"
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"] = "dense"
    source: str = ""  # citation (arXiv id / model card), from the pool

    # --- trunk dimensions ----------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 1024

    # --- attention ------------------------------------------------------
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None  # default: d_model // num_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False                 # qwen3
    attn_logit_softcap: float | None = None  # gemma2: 50.0
    final_logit_softcap: float | None = None  # gemma2: 30.0
    sliding_window: int | None = None     # mixtral: 4096
    local_global: bool = False            # gemma2: alternate SWA/global
    local_window: int = 4096

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1        # apply MoE every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_token_chunk: int = 0   # >0: dispatch in token chunks (perf, P3)
    expert_parallel: bool = False  # pin expert buffers to 'model' (perf, P5)

    # --- hybrid / SSM ------------------------------------------------------
    attn_every: int = 0       # jamba: 8 => 1 attention layer per 8
    mamba_seq_chunk: int = 0  # >0: chunked selective scan (perf, P7)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_size: int = 64

    # --- modality frontend (stubs per spec) -------------------------------
    frontend: Literal["none", "vision", "audio"] = "none"
    num_prefix_tokens: int = 0   # vision: image patches; audio: frames
    frontend_dim: int = 0        # encoder output dim (0 = d_model, no proj)

    # --- numerics / misc ---------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # --- serving ------------------------------------------------------------
    long_context_mode: Literal["native", "window"] = "native"
    # "window": force all attention layers to the local window for the
    # sub-quadratic long_500k gate (documented deviation, DESIGN.md §4).

    # -------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0

    def layer_pattern(self) -> tuple[LayerSpec, ...]:
        """The repeating period of layers; num_layers % len(period) == 0."""
        if self.family == "ssm":
            return (LayerSpec(mixer="rwkv", ffn="dense"),)

        if self.family == "hybrid":
            # jamba: period of attn_every layers, one attention layer per
            # period (at position 0); MoE on every ``moe_every``-th layer.
            period = []
            for i in range(self.attn_every):
                mixer = "attn" if i == 0 else "mamba"
                ffn = "moe" if (self.num_experts and i % self.moe_every == 1 % self.moe_every) else "dense"
                period.append(LayerSpec(mixer=mixer, ffn=ffn,
                                        sliding_window=self.sliding_window))
            return tuple(period)

        ffn: Ffn = "moe" if self.num_experts else "dense"
        if self.local_global:
            # gemma2: local (SWA) / global alternating.
            g_window = self.local_window if self.long_context_mode == "window" else None
            return (
                LayerSpec(mixer="attn", ffn=ffn, sliding_window=self.local_window),
                LayerSpec(mixer="attn", ffn=ffn, sliding_window=g_window),
            )
        return (LayerSpec(mixer="attn", ffn=ffn,
                          sliding_window=self.sliding_window),)

    def num_periods(self) -> int:
        pat = self.layer_pattern()
        if self.num_layers % len(pat) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"period length {len(pat)}")
        return self.num_layers // len(pat)

    def validate(self) -> None:
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, self.name
        if self.num_experts:
            assert 0 < self.experts_per_token <= self.num_experts, self.name
        self.num_periods()

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized variant of the same family (<=2 periods,
        d_model <= 512, <= 4 experts) per the assignment spec."""
        pat_len = len(self.layer_pattern())
        small = dict(
            num_layers=max(pat_len, 2 if pat_len == 1 else pat_len),
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.num_experts else 0,
            local_window=64,
            sliding_window=64 if self.sliding_window else None,
            mamba_d_state=8,
            rwkv_head_size=16,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            dtype="float32",
        )
        if self.num_heads and self.num_kv_heads:
            ratio = self.num_heads // self.num_kv_heads
            small["num_heads"] = min(4, max(2, ratio))
            small["num_kv_heads"] = max(1, small["num_heads"] // min(ratio, small["num_heads"]))
        if self.family == "hybrid":
            small["attn_every"] = 2  # keep the attn/mamba mix, 1 period = 2 layers
            small["num_layers"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)
