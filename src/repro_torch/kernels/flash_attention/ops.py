"""Public wrapper of the flash-attention kernel (K1).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/flash_attention.cu`` on the current stream, or raises;
on host tensors it runs the plain version of ``ref.py``. Nothing is
padded: the kernel masks the ragged last q and k tiles itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,H,hd), k/v (B,T,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    if H % K:
        raise ValueError(f"H={H} must be a multiple of K={K}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if S < 1 or T < 1:
        raise ValueError("S and T must be positive")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window > 0 and S - window >= T:
        # the last query row would see no key; the tile skip and the full
        # softmax would then disagree on what such a row averages
        raise ValueError(f"window {window}: query row {S - 1} sees no key "
                         f"of T={T}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "reads it in 16-byte vectors)")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B,S,H,hd); k/v: (B,T,K,hd) -> (B,S,H,hd) in q's dtype.

    Query head h reads kv head h // (H/K). Masks come from the indices
    0..S-1 and 0..T-1: causal (key <= query), a sliding window of
    ``window`` keys (key > query - window), and ``softcap`` > 0 caps the
    logits with tanh."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, K, hd, int(bool(causal)), int(window), hd ** -0.5,
        float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
