"""Public wrapper of the flash-attention kernel (K1).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/flash_attention.cu`` on the current stream, or raises;
on host tensors it runs the plain version of ``ref.py``. Nothing is
padded: the kernel masks the ragged last q and k tiles itself.

Under ``torch.func.vmap`` (a lane-batched board: ``core/schedule.py::
LaneBatch`` vmaps a solo engine) the wrapper calls the custom op
``repro_torch::flash_attention`` (``torch.library.custom_op``), whose
vmap rule (``register_vmap``) folds the lane axis into the batch axis,
(L, B, S, H, hd) -> (L*B, S, H, hd), and launches the kernel ONCE for all
lanes. Each (batch row, head) attends alone, so each lane's rows are its
solo launch's to the bit. A custom op rather than an ``autograd.Function``
with a ``vmap`` staticmethod: the op boundary unwraps the batched tensors
before the launcher reads their pointers, the rule is registered once
beside the op, and an op with no autograd kernel cannot silently join a
graph (``refuse_grad`` still refuses first). Unbatched calls launch
directly: a direct call of a custom op leaves its arguments in a
reference cycle (torch's argument flattening) until the garbage
collector runs. The launch counter counts one launch per fused call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, fold_lane_axis,
                                  is_lane_batched, refuse_grad)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
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
    refuse_grad("flash_attention", q, k, v)
    args = (bool(causal), int(window), float(softcap))
    if is_lane_batched(q, k, v):
        return _flash_attention_op(q, k, v, *args)
    return _launch(q, k, v, *args)


def _launch(q, k, v, causal: bool, window: int, softcap: float):
    """One launch of the kernel on CUDA tensors, counted."""
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, K, hd, int(causal), window, hd ** -0.5, softcap,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc == -2:
        raise RuntimeError("flash_attention: the TMA maps of q, k and v "
                           "could not be encoded")
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int,
                        softcap: float) -> torch.Tensor:
    return _launch(q, k, v, causal, window, softcap)


@torch.library.register_vmap("repro_torch::flash_attention")
def _flash_attention_vmap(info, in_dims, q, k, v, causal, window, softcap):
    """The lanes of a vmapped call as one launch over L*B batch rows."""
    out = fold_lane_axis(
        lambda q2, k2, v2: _launch(q2, k2, v2, causal, window, softcap),
        info.batch_size, in_dims[:3], q, k, v)
    return out, 0


flash_attention.launches = 0
