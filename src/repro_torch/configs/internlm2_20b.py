"""InternLM2-20B: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
[arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    rope_theta=1e6,
)
