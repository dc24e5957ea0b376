"""Public wrapper of the decode-attention kernel (K2).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/decode_attention.cu`` on the current stream, or raises;
on host tensors it runs the plain version of ``ref.py``. The cache is not
padded: the kernel masks the ragged last tile itself. ``pos`` stays a
device tensor, so a decode step never waits on the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16                     # query heads per kv head
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _check(q, k, v, pos, window):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,hd), k/v (B,W,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and cache {tuple(k.shape)} "
                         "disagree on batch or head_dim")
    K = k.shape[2]
    if H % K or H // K > MAX_GROUP:
        raise ValueError(f"H={H} must be a multiple of K={K} with at most "
                         f"{MAX_GROUP} query heads per kv head")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (torch.is_tensor(pos) and pos.dtype == torch.int32
            and pos.numel() == 1):
        raise TypeError("pos must be a one-element int32 tensor")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned (the kernel reads "
                         "them in 16-byte vectors)")
    if window < 1 or k.shape[1] < 1:
        raise ValueError("window and cache length must be positive")


def decode_attention(q, k, v, *, pos, window: int, softcap: float = 0.0):
    """q: (B,H,hd); k/v: (B,W,K,hd); pos: 0-d int32 tensor -> (B,H,hd).

    ``window`` is the ring length (slots wrap at it): slots above ``pos``
    are masked until the ring is full."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos=pos, window=window,
                                    softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    _check(q, k, v, pos, window)
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, W, K, H // K, hd, window, hd ** -0.5,
        float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
