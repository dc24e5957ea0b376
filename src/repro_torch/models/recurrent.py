"""RG-LRU recurrent block (recurrentgemma-2b, Griffin): forward, prefill
and decode.

  x -> [linear -> gelu]                          (gate branch)
  x -> [linear -> causal conv1d -> RG-LRU]       (recurrent branch)
  out = linear(recurrent * gate)

  r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
  log_a_t = -8 softplus(Lambda) r_t
  h_t = exp(log_a_t) h_{t-1} + sqrt(1 - exp(2 log_a_t)) (i_t x_t)

Under ``impl="cuda"`` the forward and the prefill run the recurrence
through the K4 wrapper (the CUDA kernel on the card, its plain sequential
version on host tensors), which returns the last state as well, so the
prefill hands the decode its state without a loop over the prompt. Under
``impl="xla"`` (the train path) they run ``linear_scan_chunked``, the
reference's chunked scan, each chunk recomputed in the backward as the
reference's ``jax.checkpoint`` does. The decode takes one step in plain
torch and updates the conv buffer and ``h`` in place. Layouts, dtypes and the points where the
reference casts follow the JAX package: params in the config dtype except
``Lambda`` (f32); the gates and the scan in f32; GELU in its tanh form,
``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.models.layers import (causal_conv, causal_conv_step,
                                       dense_apply, init_dense, normal)
from repro_torch.utils import dtype_of

_C_GATE = 8.0
_CHUNK = 256


def _lambda(g, W: int, device) -> torch.Tensor:
    """softplus^-1(-log(u) / c) for u ~ U(0.9, 0.999), so a^c lies in
    (0.9, 0.999) (the reference's init), f32."""
    if torch.device(device).type == "meta":
        return torch.empty((W,), dtype=torch.float32, device="meta")
    u = torch.rand((W,), generator=g, device=device, dtype=torch.float32)
    u = 0.9 + (0.999 - 0.9) * u
    return torch.log(torch.expm1(-torch.log(u) / _C_GATE))


def init_rglru(g, cfg, device):
    dt = dtype_of(cfg.dtype)
    D, W = cfg.d_model, cfg.lru_width or cfg.d_model
    cw = cfg.conv_width
    return {
        "in_x": init_dense(g, D, W, dt, device),
        "in_z": init_dense(g, D, W, dt, device),
        "conv_w": normal(g, (cw, W), cw ** -0.5, dt, device),
        "conv_b": torch.zeros((W,), dtype=dt, device=device),
        "gate_a": init_dense(g, W, W, dt, device, use_bias=True),
        "gate_x": init_dense(g, W, W, dt, device, use_bias=True),
        "Lambda": _lambda(g, W, device),
        "out": init_dense(g, W, D, dt, device, scale=W ** -0.5),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(p, xc):
    """xc: (B,S,W) -> log_a, b (both (B,S,W) f32). The gate products run
    in the working dtype and are cast to f32 before the sigmoid, as in the
    reference."""
    r = torch.sigmoid(dense_apply(p["gate_a"], xc).float())
    i = torch.sigmoid(dense_apply(p["gate_x"], xc).float())
    log_a = -_C_GATE * F.softplus(p["Lambda"]) * r
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xc.float())
    return log_a, b


def _scan_chunk(h, a, b):
    """h_t = a_t * h_{t-1} + b_t over one chunk, a, b: (B,c,F) f32.
    Returns (every h_t (B,c,F), the last)."""
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def linear_scan_chunked(a, b, h0, *, chunk: int = _CHUNK):
    """h_t = a_t * h_{t-1} + b_t, elementwise. a, b: (B,S,F) f32. The
    reference's chunked scan: chunks of ``chunk`` steps (one chunk where
    it does not divide S), each recomputed in the backward. Returns
    (h_all (B,S,F), h_last)."""
    S = a.shape[1]
    c = min(chunk, S)
    if S % c:
        c = S
    h, outs = h0, []
    for i in range(0, S, c):
        ys, h = checkpoint(_scan_chunk, h, a[:, i:i + c], b[:, i:i + c],
                           use_reentrant=False, preserve_rng_state=False)
        outs.append(ys)
    return torch.cat(outs, dim=1), h


def _mix(p, x, impl: str = "cuda"):
    """Both branches and the scan (K4 under "cuda", the chunked scan under
    "xla"). Returns the block's output (B,S,D), the pre-conv x branch and
    the last state."""
    z = _gelu(dense_apply(p["in_z"], x))
    x_in = dense_apply(p["in_x"], x)
    xc = causal_conv(p, x_in)
    log_a, b = _gates(p, xc)
    B, _, W = xc.shape
    h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    scan = linear_scan_chunked if impl == "xla" else lru_ops.rglru_scan
    h, h_last = scan(torch.exp(log_a), b, h0)
    y = h.to(x.dtype) * z
    return dense_apply(p["out"], y), x_in, h_last


def rglru_apply(p, cfg, x, *, impl: str = "cuda"):
    """Full recurrent block, train/prefill. x: (B,S,D) -> (B,S,D)."""
    return _mix(p, x, impl)[0]


# ----------------------------------------------------------------- decode ---
def rglru_state_spec(cfg, batch: int):
    """Shape and dtype of one RG-LRU layer's decode state."""
    W = cfg.lru_width or cfg.d_model
    return {"conv": ((batch, cfg.conv_width - 1, W), dtype_of(cfg.dtype)),
            "h": ((batch, W), torch.float32)}


def rglru_prefill(p, cfg, x, *, impl: str = "cuda"):
    """Full-sequence forward that also returns the decode state: the last
    conv_width-1 pre-conv inputs (fewer for a shorter prompt, as in the
    reference) and the scan's last state."""
    out, x_in, h_last = _mix(p, x, impl)
    cw = cfg.conv_width
    return out, {"conv": x_in[:, -(cw - 1):, :].contiguous(), "h": h_last}


def rglru_decode(p, cfg, x1, state):
    """One token. x1: (B,1,D); ``state`` per ``rglru_state_spec``, updated
    IN PLACE (the reference returns a new state to the same effect). All
    device ops: no host sync."""
    z = _gelu(dense_apply(p["in_z"], x1))
    x_in = dense_apply(p["in_x"], x1)                         # (B,1,W)
    # a new tensor: the shift below then copies without overlap
    conv_buf = torch.cat([state["conv"], x_in], dim=1)        # (B,cw,W)
    xc = causal_conv_step(p, conv_buf)[:, None, :]            # (B,1,W)
    log_a, b = _gates(p, xc)
    h = torch.exp(log_a[:, 0]) * state["h"] + b[:, 0]
    y = h.to(x1.dtype)[:, None, :] * z
    state["conv"].copy_(conv_buf[:, 1:])
    state["h"].copy_(h)
    return dense_apply(p["out"], y), state
