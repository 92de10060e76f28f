"""rwkv6-3b "Finch" [ssm] — attention-free, data-dependent decay.

32L d_model=2560 d_ff=8960 vocab=65536.  [arXiv:2404.05892]
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65_536,
    num_heads=40,       # d_model / head_size
    num_kv_heads=40,
    rwkv_head_size=64,
)
