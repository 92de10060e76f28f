"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  [arXiv:2403.19887]
MoE applied every other layer (moe_every=2), attention 1 layer in 8.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65_536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10_000.0,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,
    attn_every=8,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
)
