"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a STUB — input_specs() provides
precomputed frame embeddings (conditioning prefix)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,       # MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio_stub",
    prefix_len=128,
    source="arXiv:2306.05284; hf",
)
