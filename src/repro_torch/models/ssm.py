"""Mamba-1 selective-scan block (falcon-mamba-7b): forward, prefill and
decode.

Under ``impl="cuda"`` the forward and the prefill run the selective scan
through the K3 wrapper (the CUDA kernel on the card, its plain sequential
version on host tensors), which returns the last state as well, so the
prefill hands the decode its state without a loop over the prompt. Under
``impl="xla"`` (the train path) they run ``mamba_ssm``, the reference's
chunked scan, each chunk recomputed in the backward as the reference's
``jax.checkpoint`` does. The decode takes one
step in plain torch and updates the conv and SSM state in place. Layouts
and dtypes follow the JAX package: params in the config dtype except
``dt_bias``, ``A_log`` and ``D_skip`` (f32); the scan in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.layers import (causal_conv, causal_conv_step,
                                       dense_apply, init_dense, normal)
from repro_torch.utils import dtype_of

_CHUNK = 128


def _dt_bias(g, Din: int, device) -> torch.Tensor:
    """softplus^-1 of dt ~ log-uniform [1e-3, 1e-1] (the mamba init), f32."""
    if torch.device(device).type == "meta":
        return torch.empty((Din,), dtype=torch.float32, device="meta")
    u = torch.rand((Din,), generator=g, device=device, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(u * (hi - lo) + lo)
    return dt + torch.log(-torch.expm1(-dt))


def init_mamba(g, cfg, device):
    dt = dtype_of(cfg.dtype)
    D, Din, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.dt_rank, cfg.conv_width)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": init_dense(g, D, 2 * Din, dt, device),
        "conv_w": normal(g, (W, Din), W ** -0.5, dt, device),
        "conv_b": torch.zeros((Din,), dtype=dt, device=device),
        "x_proj": init_dense(g, Din, R + 2 * N, dt, device),
        "dt_proj": init_dense(g, R, Din, dt, device),
        "dt_bias": _dt_bias(g, Din, device),
        "A_log": a_log.expand(Din, N).contiguous(),
        "D_skip": torch.ones((Din,), dtype=torch.float32, device=device),
        "out_proj": init_dense(g, Din, D, dt, device, scale=Din ** -0.5),
    }


def _ssm_inputs(p, cfg, x_c):
    """x_c: (B,S,Din) post-conv-silu -> dt (B,S,Din) f32, and B_, C_
    (B,S,N) f32 as views into one projection (row stride R + 2N)."""
    N, R = cfg.ssm_state, cfg.dt_rank
    dbc = dense_apply(p["x_proj"], x_c).float()
    dt_r, B_, C_ = torch.split(dbc, [R, N, N], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"]["w"].float() + p["dt_bias"])
    return dt, B_, C_


def _scan_chunk(A, h, dt, B_, C_, x_c):
    """Sequential scan over one chunk, all f32. dt, x_c: (B,c,Din);
    B_, C_: (B,c,N); h: (B,Din,N). Returns (y (B,c,Din), h)."""
    ys = []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)                 # (B,Din,N)
        dBx = (dt[:, t] * x_c[:, t])[..., None] * B_[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C_[:, t]))
    return torch.stack(ys, dim=1), h


def mamba_ssm(p, cfg, x_c, h0=None, *, chunk: int = _CHUNK):
    """The reference's selective scan y = SSM(x_c) with the D skip:
    (B,S,Din) -> (B,S,Din) f32, h_last. Chunks of ``chunk`` steps (one
    chunk where it does not divide S), each recomputed in the backward."""
    B, S, Din = x_c.shape
    A = -torch.exp(p["A_log"])
    dt, B_, C_ = _ssm_inputs(p, cfg, x_c)
    xf = x_c.float()
    h = h0 if h0 is not None else torch.zeros(
        (B, Din, cfg.ssm_state), dtype=torch.float32, device=x_c.device)
    c = min(chunk, S)
    if S % c:
        c = S
    ys = []
    for i in range(0, S, c):
        sl = slice(i, i + c)
        y, h = checkpoint(_scan_chunk, A, h, dt[:, sl], B_[:, sl],
                          C_[:, sl], xf[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        ys.append(y)
    return torch.cat(ys, dim=1) + p["D_skip"] * xf, h


def _mix(p, cfg, x, impl: str = "cuda"):
    """In-projection, conv, silu and the scan (K3 under "cuda",
    ``mamba_ssm`` under "xla"). Returns the mixer's output (B,S,D), the
    pre-conv x branch and the last state."""
    Din = cfg.d_inner
    xz = dense_apply(p["in_proj"], x)
    x_in, z = torch.split(xz, [Din, Din], dim=-1)
    x_c = F.silu(causal_conv(p, x_in))
    if impl == "xla":
        y, h_last = mamba_ssm(p, cfg, x_c)
    else:
        A = -torch.exp(p["A_log"])
        dt, B_, C_ = _ssm_inputs(p, cfg, x_c)
        xf = x_c.float()
        y, h_last = ssm_ops.ssm_scan(dt, A, B_, C_, xf)
        y = y + p["D_skip"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return dense_apply(p["out_proj"], y), x_in, h_last


def mamba_apply(p, cfg, x, *, impl: str = "cuda"):
    """Full mamba mixer over the sequence. x: (B,S,D) -> (B,S,D)."""
    return _mix(p, cfg, x, impl)[0]


# ----------------------------------------------------------------- decode ---
def mamba_state_spec(cfg, batch: int):
    """Shape and dtype of one mamba layer's decode state."""
    W = cfg.conv_width
    return {"conv": ((batch, W - 1, cfg.d_inner), dtype_of(cfg.dtype)),
            "ssm": ((batch, cfg.d_inner, cfg.ssm_state), torch.float32)}


def mamba_prefill(p, cfg, x, *, impl: str = "cuda"):
    """Full-sequence forward that also returns the decode state: the last
    W-1 pre-conv inputs and the scan's last state."""
    out, x_in, h_last = _mix(p, cfg, x, impl)
    W = cfg.conv_width
    return out, {"conv": x_in[:, -(W - 1):, :].contiguous(), "ssm": h_last}


def mamba_decode(p, cfg, x1, state):
    """One token. x1: (B,1,D); ``state`` per ``mamba_state_spec``, updated
    IN PLACE (the reference returns a new state to the same effect). All
    device ops: no host sync."""
    Din = cfg.d_inner
    xz = dense_apply(p["in_proj"], x1)
    x_in, z = torch.split(xz, [Din, Din], dim=-1)             # (B,1,Din)
    # a new tensor: the shift below then copies without overlap
    conv_buf = torch.cat([state["conv"], x_in], dim=1)        # (B,W,Din)
    x_c = F.silu(causal_conv_step(p, conv_buf))[:, None, :]  # (B,1,Din)
    A = -torch.exp(p["A_log"])
    dt, B_, C_ = _ssm_inputs(p, cfg, x_c)
    xf = x_c[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)
    dBx = (dt[:, 0] * xf)[..., None] * B_[:, 0, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, C_[:, 0])
    y = y + p["D_skip"] * xf
    y = y.to(x1.dtype)[:, None, :] * F.silu(z)
    state["conv"].copy_(conv_buf[:, 1:])
    state["ssm"].copy_(h)
    return dense_apply(p["out_proj"], y), state
