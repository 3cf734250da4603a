"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base;
unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    n_experts=16,
    experts_per_token=4,
    moe_every=1,
    microbatches=8,     # grad accumulation: fits one pod (§Perf It.4)
    source="hf:databricks/dbrx-base; unverified",
)
