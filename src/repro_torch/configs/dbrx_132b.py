"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352.
[hf:databricks/dbrx-base]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    d_ff=10752,
    vocab_size=100_352,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
    num_experts=16,
    experts_per_token=4,
)
