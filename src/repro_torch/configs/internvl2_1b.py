"""InternVL2-1B: VLM — InternViT frontend (STUB: precomputed patch embeddings)
+ LM backbone 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    num_patches=256,
    patch_embed_dim=1024,   # InternViT output dim (stubbed frontend)
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    num_patches=8,
    patch_embed_dim=32,
    rope_theta=1e6,
)
