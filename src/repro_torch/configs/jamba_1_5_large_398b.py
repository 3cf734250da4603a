"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,        # GQA kv=8 (padded to 16 for TP=16)
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,         # MoE every other layer (Jamba convention)
    attn_every=8,        # 1 attention layer per 8 (1:7 Mamba:attn)
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=32,   # small chunk: intra-chunk residuals scale with Q
    opt_state_dtype="bfloat16",  # 398B: f32 moments would not fit one pod
    microbatches=16,     # grad accumulation: activation live-set / 16 (§Perf It.4)
    source="arXiv:2403.19887; hf",
)
