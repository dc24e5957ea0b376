"""K3: the Mamba-1 selective scan (CUDA kernel and its plain version)."""
