"""Config system: architecture + shape + run configs.

Every assigned architecture is a ``ModelConfig`` in its own module under
``repro_torch.configs``; ``repro_torch.configs.get_config(name)`` resolves them.
``reduced()`` derives the CPU-smoke-test variant of any config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1             # layer i is MoE iff i % moe_every == moe_every-1
    capacity_factor: float = 1.25
    moe_groups: int = 1            # GShard dispatch groups (= batch shards at scale)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0            # hybrid: layer i is attention iff i % attn_every == attn_every//2; 0 = all-attn (or no attn for pure ssm)
    # --- modality stub frontends ---
    frontend: str = "none"         # none | vlm_stub | audio_stub
    prefix_len: int = 0            # precomputed patch/frame embedding prefix
    # --- numerics / memory policy ---
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    q_chunk: int = 512             # attention query-block size
    microbatches: int = 1          # gradient-accumulation splits of the global batch
    # --- source provenance ---
    source: str = ""

    # ---- derived -----------------------------------------------------------

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_every > 0:
            return "attn" if i % self.attn_every == self.attn_every // 2 else "ssm"
        return "attn"

    def mlp_kind(self, i: int) -> str:
        """'moe' or 'dense' for layer i."""
        if self.n_experts > 0 and i % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense"

    @property
    def period(self) -> int:
        """Smallest repeating layer pattern (for scan-over-layers stacking)."""
        p = 1
        if self.family == "hybrid" and self.attn_every:
            p = self.attn_every
        if self.n_experts:
            p = _lcm(p, self.moe_every)
        if self.family == "ssm":
            p = max(p, 1)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return p

    def padded_heads(self, tp: int) -> Tuple[int, int]:
        """(n_heads, n_kv) padded up to multiples of the tensor-parallel
        degree (zero-filled slots; DESIGN.md sharding notes)."""
        if self.n_heads == 0:
            return 0, 0
        h = _round_up(self.n_heads, tp)
        kv = _round_up(self.n_kv_heads, tp)
        kv = min(kv, h)
        # grouped attention requires kv | h
        while h % kv != 0:
            kv += tp
        return h, kv

    def padded_vocab(self, tp: int) -> int:
        return _round_up(self.vocab_size, tp * 8)

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------

    def param_count(self, logical: bool = True, tp: int = 1) -> int:
        """Total parameters; logical=True uses the paper head counts."""
        h, kv = (self.n_heads, self.n_kv_heads) if logical else self.padded_heads(tp)
        v = self.vocab_size if logical else self.padded_vocab(tp)
        d, hd = self.d_model, self.head_dim
        total = v * d + d * v  # embed + untied head
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
                if self.qkv_bias:
                    total += (h + 2 * kv) * hd
            else:  # ssm
                di, n, sh = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * n + sh)   # in_proj
                total += 4 * (di + 2 * n)            # conv
                total += di * d                      # out_proj
            if self.mlp_kind(i) == "moe":
                total += d * self.n_experts + 3 * self.n_experts * d * self.d_ff
            elif self.d_ff > 0:
                total += 3 * d * self.d_ff
            total += 2 * d  # norms
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed experts)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_moe = sum(1 for i in range(self.n_layers) if self.mlp_kind(i) == "moe")
        inactive = n_moe * 3 * d * self.d_ff * (self.n_experts - self.experts_per_token)
        return total - inactive

    # ---- reduced (smoke-test) variant ---------------------------------------

    def reduced(self) -> "ModelConfig":
        period = self.period
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 * period,
            d_model=64,
            n_heads=min(self.n_heads, 4) or 0,
            n_kv_heads=min(self.n_kv_heads, 2) or 0,
            head_dim=16,
            d_ff=min(self.d_ff, 128),
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # drop-free capacity so prefill/decode exactly match the full
            # forward regardless of sequence length (tests rely on it)
            capacity_factor=8.0,
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            ssm_chunk=8,
            prefix_len=min(self.prefix_len, 8),
            param_dtype="float32",
            q_chunk=16,
            microbatches=1,  # smoke tests use tiny batches
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs able to run long_500k (sub-quadratic long-context decode)
LONG_CONTEXT_ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True
