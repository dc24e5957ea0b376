"""Falcon-Mamba-7B: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16, Mamba-1 architecture. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    layer_pattern=(("mamba", None),),
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    dt_rank=256,
    use_rope=False,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=256,
    layer_pattern=(("mamba", None),),
    ssm_state=8,
    d_inner=128,
    conv_width=4,
    dt_rank=8,
    use_rope=False,
)
