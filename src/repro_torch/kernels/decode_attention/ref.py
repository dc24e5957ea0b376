"""Plain PyTorch version of the decode-attention kernel (the oracle the
CUDA kernel is held against, and what host tensors run)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, pos, window: int, softcap: float = 0.0):
    """q: (B,H,hd); k/v: (B,W,K,hd); pos: scalar (int or 0-d tensor)
    -> (B,H,hd) in q's dtype."""
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg.float(), k.float()) \
        * (hd ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    slots = torch.arange(W, device=q.device)
    valid = (slots <= pos) | (pos + 1 >= window)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", w.to(v.dtype), v)
    return out.reshape(B, H, hd).to(q.dtype)
