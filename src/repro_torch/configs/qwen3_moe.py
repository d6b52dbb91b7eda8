"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]: 128 experts
top-8, every layer MoE, GQA kv=4, qk-norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,           # == expert width; no dense blocks
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    experts_per_token=8,
    d_expert=1536,
    fsdp=True,
    optimizer="adafactor",
    train_microbatches=16,
)
