"""K4: the RG-LRU linear recurrence (CUDA kernel and its plain version)."""
