"""Qwen3-30B-A3B: 48L d_model=2048 32H (GQA kv=4) moe_d_ff=768 vocab=151936,
MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,           # explicit head_dim (qwen3 style, != d_model/heads)
    d_ff=0,                 # all FFNs are MoE
    vocab_size=151936,
    layer_pattern=(("attn", "moe"),),
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
    use_qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=256,
    layer_pattern=(("attn", "moe"),),
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=96,
    use_qk_norm=True,
    rope_theta=1e6,
)
