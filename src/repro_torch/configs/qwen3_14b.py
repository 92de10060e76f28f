"""qwen3-14b [dense] — qk_norm, GQA.  40L d_model=5120 40H (kv=8)
d_ff=17408 vocab=151936.  [hf:Qwen/Qwen3-8B family card]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    d_ff=17408,
    vocab_size=151_936,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1_000_000.0,
    qk_norm=True,
)
