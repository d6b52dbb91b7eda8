"""Gemma-3-27B [hf:google/gemma-3 family; unverified]: 5:1 local:global
sliding-window interleave (window 1024), qk-norm, 262k vocab, 128k ctx.

long_500k RUNS: the dominant attention cost is the 1024-token local window;
global layers are 1-in-6 and linear-in-cache at decode."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    local_window=1024,
    locals_per_global=5,
    tie_embeddings=True,
    fsdp=True,
    supports_long_context=True,
    train_microbatches=8,
)
