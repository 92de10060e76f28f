"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048.  [arXiv:2306.05284]
The EnCodec tokenizer / conditioning encoder is a STUB per the assignment:
``input_specs()`` provides precomputed conditioning frame embeddings
(num_prefix_tokens) of frontend_dim; the decoder itself is fully built.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=1536,
    d_ff=6144,
    vocab_size=2048,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    rope_theta=10_000.0,
    frontend="audio",
    num_prefix_tokens=64,
    frontend_dim=768,
)
