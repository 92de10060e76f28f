"""smollm-360m [dense] — llama-architecture small model.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M family card]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49_152,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    rope_theta=10_000.0,
)
