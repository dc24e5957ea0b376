"""Whisper-small: enc-dec, 12L(enc)+12L(dec) d_model=768 12H (MHA) d_ff=3072
vocab=51865. Conv audio frontend is a STUB: input_specs() provides precomputed
frame embeddings (B, 1500, 768). Shapes apply to the decoder. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,          # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    encoder_seq=1500,
    use_rope=False,
    learned_pos=True,
    max_position=32768,     # widened from 448 so the assigned shapes are well-defined
    tie_embeddings=True,
    use_bias=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    encoder_layers=2,
    encoder_seq=32,
    use_rope=False,
    learned_pos=True,
    max_position=128,
    tie_embeddings=True,
    use_bias=True,
)
