"""Plain PyTorch version of the selective-scan kernel (the oracle the CUDA
kernel is held against, and what host tensors run): the sequential scan,
one time step after another, all in f32."""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, A, B_, C_, x):
    """dt/x: (B,S,Din); A: (Din,N); B_/C_: (B,S,N), all f32.

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t, from
    h_0 = 0. Returns y (B,S,Din) and h_last (B,Din,N)."""
    Bsz, S, Din = dt.shape
    N = A.shape[1]
    h = torch.zeros((Bsz, Din, N), dtype=torch.float32, device=dt.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t]
        dA = torch.exp(dt_t[..., None] * A)
        h = dA * h + (dt_t * x[:, t])[..., None] * B_[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    return torch.stack(ys, dim=1), h
