"""Public wrappers of the grouped-GEMM kernel (K5) and the expert FFN it
composes into.

On CUDA tensors ``grouped_gemm`` launches one of the hand-written kernels
of ``repro_torch/csrc/grouped_gemm.cu`` on the current stream, or raises;
on host tensors it runs the plain version of ``ref.py``. Nothing is
padded: the kernels mask ragged M, N and K themselves, where the TPU
wrapper pads them to its blocks and slices the result back.

Which kernel runs is decided from host ints only (``choose_path``):
``"wgmma"`` for bf16 wherever TMA can map the operands (the forward's and
the prefill's hundreds of rows an expert and the decode's eight alike),
``"mma"`` where it cannot and ``"fma"`` for f32. ``wgmma_plan`` gives the
persistent kernel its tiling and grid. One call is one launch whose only
allocation is its output, with a grid fixed by the shapes and the card's
SM count, so a CUDA graph can capture it. ``_launch`` forces one kernel
(the card tests and ``chip_smoke.py`` check and time each).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import (_build, refuse_grad, refuse_vmap,
                                  sm_count)
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the C interface's path codes; "fma" and "mma" share the tile kernels
_PATH_CODE = {"fma": 0, "mma": 0, "wgmma": 1}
PATHS = tuple(_PATH_CODE)
# one grid row per 64-row tile of the f32 instance (the bf16 one's are 128)
_MAX_M = 65535 * 64
# "wgmma" output tiles (rows of x, columns of w)
WG_TILE = (128, 256)


def _launcher():
    lib = _build.load("grouped_gemm")
    fn = lib.grouped_gemm_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp] + [ci] * 10 + [vp]
        fn.restype = ci
    return fn


def tma_maps(K: int, N: int, x_ptr: int, w_ptr: int) -> bool:
    """Whether TMA can map bf16 x (E,M,K) and w (E,K,N): every row a
    multiple of 16 bytes (K and N multiples of 8) and both bases 16-byte
    aligned."""
    return K % 8 == 0 and N % 8 == 0 and x_ptr % 16 == 0 \
        and w_ptr % 16 == 0


def choose_path(dtype, M: int, K: int, N: int, x_ptr: int,
                w_ptr: int) -> str:
    """The kernel for these operands, from host ints only: "fma" for f32;
    for bf16 "wgmma" where TMA can map the operands, else "mma"."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if tma_maps(K, N, x_ptr, w_ptr) else "mma"


def can_take(path: str, dtype, M: int, K: int, N: int, x_ptr: int,
             w_ptr: int) -> bool:
    """Whether kernel ``path`` takes these operands: "fma" f32 only, the
    others bf16 only; "wgmma" where TMA maps them."""
    if path == "fma":
        return dtype == torch.float32
    if dtype != torch.bfloat16 or path not in PATHS:
        return False
    return path == "mma" or tma_maps(K, N, x_ptr, w_ptr)


def wgmma_plan(E: int, M: int, N: int, sms: int) -> tuple:
    """(m-tiles, n-tiles, grid) of the "wgmma" launch: the 128 x 256
    output tiles that cover each expert's (M, N), and one block an SM, at
    most one a tile. The kernel walks the tiles from these (its header
    states the order); it refuses a tiling that does not cover the
    output. Host ints only."""
    tm = -(-M // WG_TILE[0])
    tn = -(-N // WG_TILE[1])
    return tm, tn, min(E * tm * tn, sms)


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
    the result in x's dtype, through the kernel ``choose_path`` names."""
    if x.device.type == "cpu":
        return grouped_gemm_ref(x, w)
    return _launch(x, w, None)


def _launch(x, w, path):
    """The launch behind ``grouped_gemm`` on CUDA tensors, through kernel
    ``path`` (one of PATHS, or None for ``choose_path``'s); a path that
    cannot take the operands raises ValueError."""
    if x.device.type != "cuda":
        raise ValueError(f"grouped_gemm runs on cuda or cpu tensors, not "
                         f"{x.device}")
    refuse_vmap("grouped_gemm", "MoE", x, w)
    refuse_grad("grouped_gemm", x, w)
    _check(x, w)
    E, M, K = x.shape
    N = w.shape[2]
    xp, wp = x.data_ptr(), w.data_ptr()
    if path is None:
        path = choose_path(x.dtype, M, K, N, xp, wp)
    elif not can_take(path, x.dtype, M, K, N, xp, wp):
        raise ValueError(f"path {path!r} cannot take {x.dtype} operands "
                         f"of shape {(E, M, K, N)}")
    out = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    # the tile kernels copy 16 bytes at a time where every row of x and w
    # starts on a 16-byte boundary, element by element otherwise
    per16 = 16 // x.element_size()
    vec = int(K % per16 == 0 and N % per16 == 0 and xp % 16 == 0
              and wp % 16 == 0)
    tiles = wgmma_plan(E, M, N, sm_count(x.device)) if path == "wgmma" \
        else (0, 0, 0)
    rc = _launcher()(
        xp, wp, out.data_ptr(), E, M, K, N, _DTYPE_CODE[x.dtype],
        _PATH_CODE[path], vec, *tiles,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_gemm launch failed ({path}): CUDA "
                           f"error {rc}")
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
