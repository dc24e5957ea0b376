"""Public wrapper of the RG-LRU scan kernel (K4).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/rglru_scan.cu`` on the current stream, or raises; on
host tensors it runs the plain version of ``ref.py``. Inputs are cast to
f32 as the TPU wrapper casts them. Nothing is padded and no block size is
shrunk to a divisor: the kernel masks ragged S and W itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def _launcher():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def _check(a, b, h0):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a and b (B,S,W); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    Bsz, S, W = a.shape
    if tuple(h0.shape) != (Bsz, W):
        raise ValueError(f"want h0 ({Bsz},{W}); got {tuple(h0.shape)}")
    if S < 1 or W < 1 or not 1 <= Bsz <= 65535:
        raise ValueError(f"want S, W >= 1 and 1 <= B <= 65535; got "
                         f"{(Bsz, S, W)}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rglru_scan(a, b, h0):
    """a/b: (B,S,W); h0: (B,W) -> (h_all (B,S,W) f32, h_last (B,W) f32):

      h_t = a_t * h_{t-1} + b_t, elementwise, from h0."""
    a, b, h0 = a.float(), b.float(), h0.float()
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not "
                         f"{a.device}")
    _check(a, b, h0)
    Bsz, S, W = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    rc = _launcher()(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
        h_last.data_ptr(), Bsz, S, W,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc}")
    rglru_scan.launches += 1
    return h, h_last


rglru_scan.launches = 0
