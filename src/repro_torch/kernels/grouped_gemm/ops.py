"""Public wrappers of the grouped-GEMM kernel (K5) and the expert FFN it
composes into.

On CUDA tensors ``grouped_gemm`` launches the hand-written kernel of
``repro_torch/csrc/grouped_gemm.cu`` on the current stream, or raises; on
host tensors it runs the plain version of ``ref.py``. Nothing is padded:
the kernel masks ragged M, N and K itself, where the TPU wrapper pads
them to its blocks and slices the result back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# one grid row per 64-row tile of the f32 instance (the bf16 one's are 128)
_MAX_M = 65535 * 64


def _launcher():
    lib = _build.load("grouped_gemm")
    fn = lib.grouped_gemm_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def _check(x, w):
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (E,M,K) and w (E,K,N); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    E, M, K = x.shape
    N = w.shape[2]
    if min(E, M, K, N) < 1 or E > 65535 or M > _MAX_M:
        raise ValueError(f"want E, M, K, N >= 1, E <= 65535 and M <= "
                         f"{_MAX_M}; got {(E, M, K, N)}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one of {list(_DTYPE_CODE)}; "
                        f"got {x.dtype}, {w.dtype}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def grouped_gemm(x, w):
    """x: (E,M,K) @ w: (E,K,N) -> (E,M,N) per expert, with f32 sums and
    the result in x's dtype."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm runs on cuda or cpu tensors, not "
                         f"{x.device}")
    refuse_grad("grouped_gemm", x, w)
    _check(x, w)
    E, M, K = x.shape
    N = w.shape[2]
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    # 16-byte copies where every row of x and w starts on a 16-byte
    # boundary; element by element otherwise
    per16 = 16 // x.element_size()
    vec = int(K % per16 == 0 and N % per16 == 0
              and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    rc = _launcher()(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, M, K, N,
        _DTYPE_CODE[x.dtype], vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm launch failed: CUDA error {rc}")
    grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


def moe_ffn(disp, wg, wu, wd):
    """Expert FFN on dispatched tokens, silu(x@wg) * (x@wu) @ wd, as three
    ``grouped_gemm`` calls; the silu and the product in f32, h rounded to
    disp's dtype before the down product (the TPU wrapper's ``moe_ffn``)."""
    g = F.silu(grouped_gemm(disp, wg).float())
    u = grouped_gemm(disp, wu).float()
    h = (g * u).to(disp.dtype)
    return grouped_gemm(h, wd)
