"""Whisper-medium [arXiv:2212.04356; unverified]: encoder-decoder transformer
backbone.  The conv audio frontend is a STUB: input_specs() provides
precomputed frame embeddings (1500 frames after 2x conv downsampling)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,          # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    head_dim=64,
    norm="layernorm",
    n_frames=1500,
    tie_embeddings=True,
    train_microbatches=2,
)
