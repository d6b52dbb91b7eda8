"""Architecture + shape config system (a copy of ``repro.configs.base``).

Every assigned architecture is a :class:`ModelConfig` in its own module
(``configs/<id>.py``) with the exact public-literature numbers from the
brief.  ``reduced()`` derives the small same-family config used by the CPU
tests; ``chip_smoke.py`` serves qwen3-1.7b and mamba2-130m at their full
configs on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm_np (non-parametric, olmo)
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0

    # --- sliding-window attention (gemma3): repeating pattern of layer kinds,
    # e.g. 5 local : 1 global.  window == 0 means all layers are global.
    local_window: int = 0
    locals_per_global: int = 0  # e.g. 5 -> pattern LLLLLG repeating

    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    d_expert: int = 0  # expert FF width (d_ff used for dense blocks)
    n_shared_experts: int = 0
    first_dense_layers: int = 0  # leading dense-MLP layers (kimi: 1)
    moe_every: int = 1  # a layer is MoE iff layer_idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (jamba): one attention layer per `attn_period` layers at
    # `attn_offset`; remaining layers are mamba blocks.
    attn_period: int = 0
    attn_offset: int = 0

    # --- encoder-decoder (whisper) / modality frontends (stubs)
    encoder_layers: int = 0
    n_frames: int = 0  # whisper: precomputed conv-frontend frame embeddings
    n_patches: int = 0  # vlm: precomputed ViT patch embeddings (prefix tokens)
    patch_dim: int = 0  # raw patch embedding width before projection

    # --- distribution / memory policy
    fsdp: bool = False  # additionally shard params over the data axis (ZeRO-3)
    optimizer: str = "adamw"  # adamw | adafactor (factored states, 1T-scale)
    remat: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # gradient-accumulation microbatches for the train_4k shape: bounds
    # saved-activation memory (remat keeps one layer input per layer per
    # LIVE microbatch).  Runtime-memory knob only; per-step flop totals are
    # microbatch-invariant, so the analysis compile uses microbatches=1.
    train_microbatches: int = 1
    # microbatch-accumulator dtype: float32 default; bfloat16 for the 1T
    # arch where a f32 grad tree alone is 16 GB/chip (4TB/256) — adafactor's
    # per-tensor normalization tolerates bf16 grads (EXPERIMENTS §Dry-run).
    grad_accum_dtype: str = "float32"
    # analysis mode: fully unroll layer scans so XLA cost_analysis counts
    # every layer (it counts loop bodies ONCE; verified — see DESIGN.md §10).
    # Runtime configs keep scans (small HLO, streaming FSDP); the dry-run
    # flips this on.
    scan_unroll: bool = False

    # --- §Perf hillclimb knobs (EXPERIMENTS.md; default off = baseline) ---
    # decode: unrolled layer loop with .at[i] cache updates so the donated
    # cache buffer is reused in place instead of scan double-buffering.
    decode_inplace: bool = False
    # decode: sliding-window layers keep a ring buffer of `local_window`
    # KV entries instead of the full seq_len cache (32x smaller at 32k).
    ring_local_cache: bool = False

    # --- which shapes are runnable (sub-quadratic rule from the brief)
    supports_long_context: bool = False  # long_500k cell
    # -----------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/head shard
        cleanly over 16-way TP (Megatron's make-vocab-size-divisible-by).
        Pad rows are masked to -inf in the loss and at sampling."""
        if self.vocab < 2048:
            return self.vocab  # smoke configs: keep exact
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % self.moe_every) == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        """hybrid only: which layers are attention (vs mamba)."""
        if self.family == "ssm":
            return False
        if self.attn_period == 0:
            return True
        return (i % self.attn_period) == self.attn_offset

    def is_global_attn_layer(self, i: int) -> bool:
        if self.local_window == 0 or self.locals_per_global == 0:
            return True
        return (i % (self.locals_per_global + 1)) == self.locals_per_global


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The brief's rule: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k skipped: pure full-attention architecture (O(L^2) "
            "prefill / full-cache decode); see DESIGN.md §Arch-applicability"
        )
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests (one fwd/train step)."""
    period = 1
    if cfg.attn_period:
        period = cfg.attn_period
    if cfg.locals_per_global:
        period = max(period, cfg.locals_per_global + 1)
    period = max(period, cfg.moe_every, 2)
    changes = dict(
        name=cfg.name + "-smoke",
        n_layers=max(period, cfg.first_dense_layers + period),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=256,
        vocab=512,
        head_dim=32,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2),
        d_expert=64 if cfg.d_expert else 0,
        # smoke configs are DROPLESS (capacity >= L*k) so prefill+decode is
        # bit-consistent with the full forward; training at scale uses the
        # real capacity_factor (token dropping), tested separately.
        capacity_factor=8.0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=8,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_frames=8 if cfg.n_frames else 0,
        n_patches=8 if cfg.n_patches else 0,
        patch_dim=64 if cfg.patch_dim else 0,
        fsdp=False,
        remat=False,
        param_dtype="float32",
        compute_dtype="float32",
    )
    return dataclasses.replace(cfg, **changes)
