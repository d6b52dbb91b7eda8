"""InternVL2-26B [arXiv:2404.16821; hf]: InternViT-6B vision frontend (STUB:
input_specs() provides precomputed patch embeddings of width 3200, projected
into the LM) + InternLM2-20B text backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    n_patches=256,
    patch_dim=3200,
    fsdp=True,
    train_microbatches=16,
)
