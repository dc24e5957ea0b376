"""Shared primitive layers: dense, norms, GLU MLP, embeddings, RoPE, and
the depthwise causal conv of the Mamba-1 and RG-LRU mixers.

Functional style over plain tensor dicts, in the JAX package's layouts:
``init_*`` returns a param dict, ``*_apply`` is the forward. Dense weights
are (d_in, d_out). Params live in the config dtype except norm scales
(f32). Inits draw from an explicit ``torch.Generator`` on the target
device; on the ``meta`` device they only describe shapes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils import dtype_of


def normal(g, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in f32 and cast, as the reference initialises."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


# ----------------------------------------------------------------- dense ----
def init_dense(g, d_in: int, d_out: int, dtype, device, use_bias=False,
               scale: float | None = None):
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(g, (d_in, d_out), scale, dtype, device)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ----------------------------------------------------------------- norms ----
def init_rmsnorm(d: int, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def init_layernorm(d: int, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(p, x, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def init_norm(cfg, d: int, device):
    return init_layernorm(d, device) if cfg.use_bias \
        else init_rmsnorm(d, device)


def norm_apply(cfg, p, x):
    if "bias" in p:
        return layernorm_apply(p, x, cfg.norm_eps)
    return rmsnorm_apply(p, x, cfg.norm_eps)


# ----------------------------------------------------------- causal conv ----
def causal_conv(p, x):
    """Depthwise causal conv of width ``conv_w.shape[0]`` in the working
    dtype, summed tap by tap in the reference's order. x: (B, S, C)."""
    W = p["conv_w"].shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(W))
    return y + p["conv_b"]


def causal_conv_step(p, conv_buf):
    """The conv at one position. conv_buf: (B, W, C), the last W inputs
    -> (B, C)."""
    W = p["conv_w"].shape[0]
    return sum(conv_buf[:, i] * p["conv_w"][i] for i in range(W)) \
        + p["conv_b"]


# ------------------------------------------------------------------- MLP ----
def init_mlp(g, cfg, d_ff: int, device):
    dt = dtype_of(cfg.dtype)
    D = cfg.d_model
    return {
        "gate": init_dense(g, D, d_ff, dt, device, cfg.use_bias),
        "up": init_dense(g, D, d_ff, dt, device, cfg.use_bias),
        "down": init_dense(g, d_ff, D, dt, device, cfg.use_bias,
                           scale=d_ff ** -0.5),
    }


def mlp_apply(p, x):
    gate = F.silu(dense_apply(p["gate"], x))
    return dense_apply(p["down"], gate * dense_apply(p["up"], x))


# ------------------------------------------------------------- embedding ----
def init_embed(g, cfg, device):
    dt = dtype_of(cfg.dtype)
    p = {"tok": normal(g, (cfg.vocab_size, cfg.d_model), 0.02, dt, device)}
    if cfg.learned_pos:
        p["pos"] = normal(g, (cfg.max_position, cfg.d_model), 0.02, dt,
                          device)
    return p


def embed_apply(p, tokens, positions=None):
    x = F.embedding(tokens, p["tok"])
    if "pos" in p and positions is not None:
        x = x + F.embedding(positions, p["pos"])
    return x


def logits_apply(params, cfg, x):
    """f32 logits from the (bf16) hidden state and head, accumulated in f32
    without rounding the products to the working type. On a card the head
    stays in its own dtype (``mm`` with an f32 output); upcasting the
    4096 x 151552 head every token step would move ~3.7 GB a step. Where a
    gradient is taken (the train step) the product runs on f32 copies,
    which autograd differentiates, as on the host."""
    w = params["embed"]["tok"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        y = x2 @ w
    elif x.is_cuda and not (torch.is_grad_enabled()
                            and (x.requires_grad or w.requires_grad)):
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, w.shape[-1])


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return theta ** (-exps)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE. x: (..., S, H, hd); positions: (..., S) int32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (...,S,hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (...,S,1,hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
