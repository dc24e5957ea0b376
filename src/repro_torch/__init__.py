"""PyTorch / CUDA port of the ZynqParrot co-emulation repro for one NVIDIA
H100. It sits beside the JAX package ``repro``, which stays the reference,
and imports nothing of it. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``."""
