"""K1: blocked GQA flash attention (the full-sequence forward)."""
