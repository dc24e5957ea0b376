"""Public wrapper of the decode-attention kernel (K2).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/decode_attention.cu`` on the current stream, or raises;
on host tensors it runs the plain version of ``ref.py``. The cache is not
padded: the kernel masks the ragged last tile itself. ``pos`` stays a
device tensor, so a decode step never waits on the host.

The kernel splits the ring across the card (``split_plan``) and combines
the splits in the same launch: the splits of one (batch row, kv head) are
one thread-block cluster that merges its partials through distributed
shared memory. One call is one launch that allocates only its output
(``torch.empty``), with a grid fixed by B*K, W and the card's SM count,
so a CUDA graph can capture it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, count_launch, is_traced, nbytes,
                                  note_traced, refuse_grad, refuse_vmap,
                                  sm_count)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)
MAX_GROUP = 16                     # query heads per kv head
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                          # cache slots a block stages at a time
MAX_SPLIT = 16                     # blocks per (batch row, kv head): a cluster


def splits(W: int, n: int) -> tuple:
    """(chunk, n_split) for at most ``n`` splits of a ``W``-slot ring:
    ``chunk`` a multiple of TILE (the last split may be shorter), every
    split non-empty."""
    tiles = -(-W // TILE)
    chunk = -(-tiles // n) * TILE
    return chunk, -(-W // chunk)


def split_plan(bk: int, W: int, sms: int) -> tuple:
    """(chunk, n_split) for ``bk`` = B*K (batch row, kv head) pairs over a
    ``W``-slot ring on a card of ``sms`` SMs: each of bk * n_split blocks
    owns ``chunk`` slots; about one and a half blocks an SM (192 at
    glm4-9b's and qwen3-moe-30b-a3b's decode shapes on an H100's 132),
    at most MAX_SPLIT splits (one cluster). ``chip_smoke.py`` times the
    plans of 4 to 16 splits beside this one at the serve shapes. Host
    ints only, never ``pos``: the grid is fixed for a cache, so a CUDA
    graph can capture the launch."""
    return splits(W, min(-(-W // TILE), MAX_SPLIT,
                         max(1, 3 * sms // (2 * bk))))


def _launcher():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
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
    if not is_traced(q) and (q.data_ptr() % 16 or k.data_ptr() % 16
                             or v.data_ptr() % 16):
        raise ValueError("q, k and v must be 16-byte aligned (the kernel "
                         "copies them in 16-byte vectors)")
    if B * K > 65535:
        raise ValueError(f"B*K={B * K} over the grid's 65535 rows")
    if window < 1 or k.shape[1] < 1:
        raise ValueError("window and cache length must be positive")


def cost(q, k, v, *, slots: int | None = None) -> dict:
    """What one launch does over ``slots`` live cache slots (default: the
    whole ring, W; the kernel reads min(W, pos + 1) until the ring is
    full, which a trace, holding no value of ``pos``, cannot know):
    the QK^T and PV products (4·B·H·slots·hd FLOPs), q and pos read, the
    live slots of k and v read and the output written, once each."""
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    n = W if slots is None else min(W, slots)
    return {"flops": 4 * B * H * n * hd,
            "bytes": 2 * nbytes(q) + 2 * B * n * K * hd * k.element_size()
            + 4}


def decode_attention(q, k, v, *, pos, window: int, softcap: float = 0.0):
    """q: (B,H,hd); k/v: (B,W,K,hd); pos: 0-d int32 tensor -> (B,H,hd).

    ``window`` is the ring length (slots wrap at it): slots above ``pos``
    are masked until the ring is full."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, pos=pos, window=window,
                                    softcap=softcap)
    if is_traced(q):                    # the certifier's trace
        refuse_grad("decode_attention", q, k, v)
        _check(q, k, v, pos, window)
        note_traced(decode_attention, cost(q, k, v))
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu tensors, "
                         f"not {q.device}")
    refuse_vmap("decode_attention", "decode", q, k, v, pos)
    refuse_grad("decode_attention", q, k, v)
    _check(q, k, v, pos, window)
    B, K, W = q.shape[0], k.shape[2], k.shape[1]
    out = launch(q, k, v, pos, window, softcap,
                 *split_plan(B * K, W, sm_count(q.device)))
    count_launch(decode_attention)
    return out


def launch(q, k, v, pos, window, softcap, chunk, n_split):
    """One launch of the kernel on checked CUDA inputs with the split plan
    (chunk, n_split) into a new output, uncounted: ``decode_attention``
    picks the plan and counts its launches; a plan sweep passes others."""
    B, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, W, K, H // K, hd, window, chunk, n_split,
        hd ** -0.5, float(softcap), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{rc}")
    return out


decode_attention.launches = 0
