"""RecurrentGemma-2B (Griffin): 26L d_model=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680 vocab=256000. RG-LRU + local attention, pattern (R, R, A).
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
    window=2048,
    lru_width=2560,
    attn_logit_softcap=0.0,
    rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,           # exercises both the scanned periods and the tail
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    layer_pattern=(("rglru", "mlp"), ("rglru", "mlp"), ("local", "mlp")),
    window=16,
    lru_width=64,
    rope_theta=10000.0,
    tie_embeddings=True,
)
