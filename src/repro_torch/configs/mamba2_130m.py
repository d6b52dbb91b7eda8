"""Mamba2-130M [arXiv:2405.21060; unverified]: SSD (state-space duality),
attention-free; O(1)-state decode => long_500k runs."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    supports_long_context=True,
    train_microbatches=2,
)
