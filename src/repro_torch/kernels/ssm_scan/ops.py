"""Public wrapper of the selective-scan kernel (K3).

On CUDA tensors it launches the hand-written kernel of
``repro_torch/csrc/ssm_scan.cu`` on the current stream, or raises; on host
tensors it runs the plain version of ``ref.py``. Inputs are cast to f32 as
the TPU wrapper casts them. Nothing is padded: the kernel masks the
ragged last time chunk and channel block itself. ``plan`` gives the
kernel's decomposition for a shape: each channel's states split across a
group of lanes, each lane's partial sum of y added across the group in a
fixed tree. ``B_`` and ``C_`` may be strided views (the model splits them
off one projection): the kernel reads them through their batch and row
strides. ``_launch`` forces a lane group (the card tests check each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (_build, count_launch, is_traced,
                                  note_traced, refuse_grad, refuse_vmap,
                                  sm_count)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

STATE_SIZES = (4, 8, 16)
# the kernel's decomposition (csrc/ssm_scan.cu): each channel's N states
# held by one lane, or split across a group of N / STATES_PER_LANE lanes
# where one lane a channel puts fewer than WARPS_PER_SM warps on each SM;
# THREADS threads a block, time staged CHUNK steps at a time
STATES_PER_LANE = 4
THREADS = 256
CHUNK = 16
WARPS_PER_SM = 12


def lane_groups(N: int) -> tuple:
    """The lane groups the kernel has for state size N: one lane a
    channel, and N / 4 lanes (four states a lane)."""
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N} not in {STATE_SIZES}")
    return tuple(sorted({1, N // STATES_PER_LANE}))


def lane_group(B: int, Din: int, N: int, sms: int) -> int:
    """The lanes that share one channel's N states at (B, Din) on a card
    of ``sms`` SMs: one where B * Din threads put at least WARPS_PER_SM
    warps on each SM, else N / 4 (host ints only)."""
    if B * Din >= 32 * WARPS_PER_SM * sms:
        return 1
    return lane_groups(N)[-1]


def plan(B: int, Din: int, N: int, sms: int, group: int | None = None) \
        -> dict:
    """The launch the kernel makes for (B, Din, N) on a card of ``sms``
    SMs: its design, the lane group (``lane_group``'s unless given), the
    grid and the warps it puts on the card (host ints)."""
    if group is None:
        group = lane_group(B, Din, N, sms)
    elif group not in lane_groups(N):
        raise ValueError(f"no lane group of {group} at N={N}; the kernel "
                         f"has {lane_groups(N)}")
    channels = THREADS // group
    blocks = B * -(-Din // channels)
    return {"design": "lane groups", "group": group,
            "states_per_lane": N // group, "chunk": CHUNK,
            "channels_per_block": channels, "blocks": blocks,
            "threads_per_block": THREADS,
            "warps": blocks * THREADS // 32,
            "warps_per_sm": blocks * THREADS / 32 / sms}


def _launcher():
    lib = _build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 7 + [ci] * 5 + [cl] * 4 + [vp]
        fn.restype = ci
    return fn


def _check(dt, A, B_, C_, x):
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"want dt and x (B,S,Din); got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    Bsz, S, Din = dt.shape
    if A.dim() != 2 or A.shape[0] != Din:
        raise ValueError(f"want A (Din={Din}, N); got {tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B_", B_), ("C_", C_)):
        if tuple(t.shape) != (Bsz, S, N):
            raise ValueError(f"want {name} ({Bsz},{S},{N}); got "
                             f"{tuple(t.shape)}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} must be contiguous along its last "
                             "axis")
    if N not in STATE_SIZES:
        raise ValueError(f"state size N={N} not in {STATE_SIZES}")
    if S < 1 or Din < 1 or not 1 <= Bsz <= 65535:
        raise ValueError(f"want S, Din >= 1 and 1 <= B <= 65535; got "
                         f"{(Bsz, S, Din)}")
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C_", C_), ("x", x)):
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")
    for name, t in (("dt", dt), ("A", A), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def cost(dt, A, B_, C_, x) -> dict:
    """What one launch does, from the shapes, in f32: dt, x, A, B_ and C_
    read and y and h_last written once each; exp(dt·A) for every state
    of every (row, step, channel) (``exps``, at the special-function
    units' rate); per state dt·A, (dt·x)·B, the state's multiply-add and
    y's multiply-add, and dt·x per channel and step (6·N + 1 FLOPs an
    element of x)."""
    Bsz, S, Din = dt.shape
    N = A.shape[1]
    elems = Bsz * S * Din
    return {"flops": elems * (6 * N + 1),
            "bytes": 4 * (3 * elems + Din * N + 2 * Bsz * S * N
                          + Bsz * Din * N),
            "exps": elems * N}


def ssm_scan(dt, A, B_, C_, x):
    """Selective scan. dt/x: (B,S,Din); A: (Din,N); B_/C_: (B,S,N).
    Returns (y (B,S,Din) f32, h_last (B,Din,N) f32), from a zero state:

      h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t"""
    dt, A, B_, C_, x = (t.float() for t in (dt, A, B_, C_, x))
    if dt.device.type == "cpu":
        return ssm_scan_ref(dt, A, B_, C_, x)
    if is_traced(dt):                   # the certifier's trace
        refuse_grad("ssm_scan", dt, A, B_, C_, x)
        _check(dt, A, B_, C_, x)
        note_traced(ssm_scan, cost(dt, A, B_, C_, x))
        Bsz, _, Din = dt.shape
        return torch.empty_like(dt), dt.new_empty((Bsz, Din, A.shape[1]))
    return _launch(dt, A, B_, C_, x, None)


def _launch(dt, A, B_, C_, x, group):
    """The launch behind ``ssm_scan`` on CUDA f32 tensors, with ``group``
    lanes a channel (None: ``lane_group``'s choice)."""
    if dt.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu tensors, not "
                         f"{dt.device}")
    refuse_vmap("ssm_scan", "Mamba-1", dt, A, B_, C_, x)
    refuse_grad("ssm_scan", dt, A, B_, C_, x)
    _check(dt, A, B_, C_, x)
    Bsz, S, Din = dt.shape
    N = A.shape[1]
    group = plan(Bsz, Din, N, sm_count(dt.device), group)["group"]
    y = torch.empty_like(dt)
    h_last = torch.empty((Bsz, Din, N), dtype=torch.float32,
                         device=dt.device)
    rc = _launcher()(
        dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C_.data_ptr(),
        x.data_ptr(), y.data_ptr(), h_last.data_ptr(), Bsz, S, Din, N,
        group, B_.stride(0), B_.stride(1), C_.stride(0), C_.stride(1),
        torch.cuda.current_stream(dt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: CUDA error {rc}")
    count_launch(ssm_scan)
    return y, h_last


ssm_scan.launches = 0
