"""Mixtral-8x7B: 32L d_model=4096 32H (GQA kv=8) expert_d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32000,
    layer_pattern=(("swa", "moe"),),
    window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    layer_pattern=(("swa", "moe"),),
    window=16,
    num_experts=4,
    num_experts_per_tok=2,
    moe_d_ff=128,
    rope_theta=1e6,
)
