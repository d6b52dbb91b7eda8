"""Jamba-v0.1-52B [arXiv:2403.19887; hf]: hybrid Mamba+attention 1:7
interleave (one attention layer per 8, offset 4), MoE 16e top-2 on every
other layer.  SSM decode state is O(1) => long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    n_experts=16,
    experts_per_token=2,
    d_expert=14336,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_period=8,
    attn_offset=4,
    fsdp=True,
    supports_long_context=True,
    train_microbatches=16,
)
