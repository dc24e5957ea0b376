"""Plain PyTorch version of the grouped-GEMM kernel (the oracle the CUDA
kernel is held against, and what host tensors run): a per-expert product
in f32, cast to x's dtype, and the expert FFN it composes into."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grouped_gemm_ref(x, w):
    """x: (E,M,K) @ w: (E,K,N) -> (E,M,N): f32 products and sums, the
    result in x's dtype."""
    return torch.einsum("emk,ekn->emn", x.float(), w.float()).to(x.dtype)


def moe_ffn_ref(disp, wg, wu, wd):
    """The expert FFN silu(x@wg) * (x@wu) @ wd, with the silu and the
    product in f32 and h rounded to disp's dtype before the down
    product."""
    g = F.silu(grouped_gemm_ref(disp, wg).float())
    u = grouped_gemm_ref(disp, wu).float()
    h = (g * u).to(disp.dtype)
    return grouped_gemm_ref(h, wd)
