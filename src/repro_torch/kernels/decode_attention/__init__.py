"""K2: decode attention over a ring KV cache."""
