"""Public wrapper of the RG-LRU scan kernel (K4).

On CUDA tensors it launches one of the hand-written kernels of
``repro_torch/csrc/rglru_scan.cu`` on the current stream, or raises; on
host tensors it runs the plain version of ``ref.py``. Inputs are cast to
f32 as the TPU wrapper casts them. Nothing is padded and no block size is
shrunk to a divisor: the kernels mask ragged S and W themselves.

Which kernel runs is decided from host ints only (``choose_path``):
``"tma"`` where TMA can map a and b (W a multiple of 4, both bases
16-byte aligned) and the grid is thin (at most TMA_BLOCKS_PER_SM blocks an
SM, as at recurrentgemma-2b's forward), which feeds each block's consumer
warp from a ring of STAGES stages of STEPS steps in shared memory;
``"registers"`` elsewhere, one thread a channel with 64 steps of loads in
flight in registers. ``plan`` describes the launch (path, channels a
block, steps a stage, stages, blocks). Both walk every channel's steps in
time order and round each step as the plain version does, so both agree
with it to the bit. One call is one launch whose only allocations are its
two outputs, with a grid fixed by the shape, so a CUDA graph can capture
it. ``_launch`` forces a path (the card tests and ``chip_smoke.py`` check
and time each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, refuse_grad, refuse_vmap,
                                  sm_count)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

PATHS = ("tma", "registers")
_PATH_CODE = {"registers": 0, "tma": 1}
CHANNELS = 32          # a block's channels: one 128-byte f32 row
REG_AHEAD = 64         # "registers": steps in flight a thread
STEPS = 32             # "tma": steps a stage (the kernel's kSteps)
STAGES = 5             # "tma": stages of the ring (the kernel's kStages)
# "tma" where the grid holds at most this many blocks an SM; above it
# (the serve prefill's 640 blocks) the register kernel keeps as many
# bytes in flight as the card wants, and matched every TMA ring measured
# there on an H100 (PERF.md)
TMA_BLOCKS_PER_SM = 2


def _launcher():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 4 + [vp]
        fn.restype = ci
    return fn


def tma_maps(W: int, a_ptr: int, b_ptr: int) -> bool:
    """Whether TMA can map f32 a and b (B, S, W): each row of W floats a
    multiple of 16 bytes and both bases 16-byte aligned."""
    return W % 4 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0


def choose_path(B: int, W: int, a_ptr: int, b_ptr: int, sms: int) -> str:
    """The kernel for these operands on a card of ``sms`` SMs, from host
    ints only: "tma" where TMA can map a and b and the grid of B x
    ceil(W / CHANNELS) blocks holds at most TMA_BLOCKS_PER_SM an SM, else
    "registers"."""
    thin = B * -(-W // CHANNELS) <= TMA_BLOCKS_PER_SM * sms
    return "tma" if thin and tma_maps(W, a_ptr, b_ptr) else "registers"


def plan(B: int, S: int, W: int, sms: int, path: str | None = None) -> dict:
    """The launch of kernel ``path`` for (B, S, W) on a card of ``sms``
    SMs (host ints; None: ``choose_path``'s for 16-byte-aligned a and b,
    as fresh allocations are). Both paths take one block a (batch row,
    CHANNELS channels). Returns the path, channels a block, blocks and
    grid, and "tma"'s steps a stage and stages (its producer issues only
    the ceil(S / STEPS) stages S has) or "registers"' steps in flight a
    thread."""
    if path is None:
        path = choose_path(B, W, 0, 0, sms)
    elif path not in PATHS:
        raise ValueError(f"no path {path!r}; K4 has {PATHS}")
    gx = -(-W // CHANNELS)
    rec = {"path": path, "channels_per_block": CHANNELS, "blocks": B * gx,
           "grid": (gx, B)}
    if path == "tma":
        rec.update(steps_per_stage=STEPS, stages=STAGES)
    else:
        rec.update(steps_in_flight=REG_AHEAD)
    return rec


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
    return _launch(a, b, h0, None)


def _launch(a, b, h0, path):
    """The launch behind ``rglru_scan`` on CUDA f32 tensors, through
    kernel ``path`` (one of PATHS, or None for ``choose_path``'s); a path
    that cannot take the operands raises ValueError."""
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu tensors, not "
                         f"{a.device}")
    refuse_vmap("rglru_scan", "RG-LRU", a, b, h0)
    refuse_grad("rglru_scan", a, b, h0)
    _check(a, b, h0)
    Bsz, S, W = a.shape
    ap, bp = a.data_ptr(), b.data_ptr()
    if path is None:
        path = choose_path(Bsz, W, ap, bp, sm_count(a.device))
    elif path not in PATHS:
        raise ValueError(f"no path {path!r}; K4 has {PATHS}")
    elif path == "tma" and not tma_maps(W, ap, bp):
        raise ValueError(f"path 'tma' cannot map a and b of shape "
                         f"{(Bsz, S, W)} at offsets {ap % 16}, {bp % 16}")
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    rc = _launcher()(
        ap, bp, h0.data_ptr(), h.data_ptr(), h_last.data_ptr(), Bsz, S, W,
        _PATH_CODE[path], torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rglru_scan launch failed ({path}): CUDA error "
                           f"{rc}")
    rglru_scan.launches += 1
    return h, h_last


rglru_scan.launches = 0
