"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; unverified, paper-table]: 384 experts
top-8 + 1 shared expert, first layer dense (DeepSeek-V3 lineage).
d_ff=2048 is the per-expert width; the dense layer uses 18432.
Optimizer states are factored (adafactor) -- 1T AdamW moments cannot fit a
256-chip v5e pod (see EXPERIMENTS.md dry-run table)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,          # dense-block FF width (first layer)
    vocab=163840,
    head_dim=128,
    qk_norm=True,
    n_experts=384,
    experts_per_token=8,
    d_expert=2048,
    n_shared_experts=1,
    first_dense_layers=1,
    fsdp=True,
    optimizer="adafactor",
    train_microbatches=16,
    grad_accum_dtype="bfloat16",
)
