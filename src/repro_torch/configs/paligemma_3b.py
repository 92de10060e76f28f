"""paligemma-3b [vlm] — SigLIP vision encoder + gemma decoder, MQA.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.  [arXiv:2407.07726]
SigLIP is a STUB per the assignment: ``input_specs()`` provides 256
precomputed patch embeddings (1152-d, SigLIP-So400m width), projected by a
learned linear into the decoder; the language model is fully built.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    source="arXiv:2407.07726",
    num_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=257_216,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    rope_theta=10_000.0,
    frontend="vision",
    num_prefix_tokens=256,
    frontend_dim=1152,
)
