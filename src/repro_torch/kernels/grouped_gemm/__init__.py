"""K5: the grouped (per-expert) matmul of the MoE FFN (CUDA kernel and its
plain version)."""
