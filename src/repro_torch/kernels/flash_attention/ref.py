"""Plain PyTorch version of the flash-attention kernel (the oracle the
CUDA kernel is held against, and what host tensors run): the full
softmax, scores in f32, weights cast to v's dtype before the PV product,
masks from the indices 0..S-1 and 0..T-1."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k.float()) \
        * (hd ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd).to(q.dtype)
