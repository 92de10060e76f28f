"""llama3.2-3b [dense] — small llama3.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B family card]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    num_layers=28,
    d_model=3072,
    d_ff=8192,
    vocab_size=128_256,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500_000.0,
)
