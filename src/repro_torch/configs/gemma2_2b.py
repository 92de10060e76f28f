"""gemma2-2b [dense] — local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
[arXiv:2408.00118]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256_000,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    rope_theta=10_000.0,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    local_global=True,
    local_window=4096,
)
