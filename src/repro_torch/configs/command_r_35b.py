"""Command-R-35B: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
GQA, no-bias, tied embeddings. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    tie_embeddings=True,
    rope_theta=8e6,
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    head_dim=8,
    d_ff=192,
    vocab_size=512,
    tie_embeddings=True,
    rope_theta=8e6,
)
