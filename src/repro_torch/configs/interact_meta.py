"""The paper's own experimental model: two-hidden-layer MLP (20 units)
meta-learning task (Section 6).  Not a transformer; used by the
paper-faithful reproduction in repro_torch/core.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="interact-meta-mlp",
    family="dense",
    source="paper section 6",
    num_layers=2,
    d_model=20,
    d_ff=20,
    vocab_size=10,
    num_heads=1,
    num_kv_heads=1,
    head_dim=20,
    dtype="float32",
)
