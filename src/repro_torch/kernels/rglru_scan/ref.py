"""Plain PyTorch version of the RG-LRU scan kernel (the oracle the CUDA
kernel is held against, and what host tensors run): the sequential
elementwise linear recurrence, one time step after another, in f32."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """a/b: (B,S,W); h0: (B,W). h_t = a_t h_{t-1} + b_t from h0, in f32.
    Returns h_all (B,S,W) and h_last (B,W)."""
    h = h0.float()
    a, b = a.float(), b.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
