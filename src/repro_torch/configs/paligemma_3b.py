"""paligemma-3b [vlm] — SigLIP + gemma [arXiv:2407.07726; hf].

Backbone only: the SigLIP vision frontend is a STUB — input_specs() provides
precomputed patch embeddings of length ``prefix_len`` (task convention)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,        # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    frontend="vlm_stub",
    prefix_len=256,      # 224/14 = 16x16 patches
    source="arXiv:2407.07726; hf",
)
