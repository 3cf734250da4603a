"""llama4-scout-17b-a16e [moe] — MoE 16e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    n_experts=16,
    experts_per_token=1,
    moe_every=1,
    microbatches=8,     # grad accumulation: fits one pod (§Perf It.4)
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
