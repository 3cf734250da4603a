"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    microbatches=8,     # grad accumulation: fits one pod (§Perf It.4)
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
