"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    d_ff=0,              # no separate MLP: the SSD mixer is the whole block
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    source="arXiv:2405.21060; unverified",
)
