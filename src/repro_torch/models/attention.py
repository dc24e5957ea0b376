"""GQA attention: full / sliding-window / local; forward, prefill and
decode paths, and the enc-dec decoder's cross-attention.

The forward (``attention_apply``, the path the commit-tapped model
forward and the Scale-Down replay run) goes through the K1 wrapper under
``impl="cuda"``, and under ``impl="xla"`` (the train path) through the
reference's plain attention, q-chunked above ``_Q_CHUNK`` query positions
so the S x S score tensor is never materialized whole. The prefill path
keeps that plain attention always, as the reference does. The decode
attends through K2 under "cuda" and plainly over the masked ring under
"xla". Decode uses a ring-buffer KV cache: bounded at
``cfg.window`` for swa/local mixers, full-length otherwise. Keys are
stored post-RoPE at their absolute positions, so ring overwrites stay
position-correct. Layouts follow the JAX package: q is (B,S,H,hd), a
layer's cache is (B,W,K,hd).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dense_apply, init_dense
from repro_torch.sharding import collectives as coll
from repro_torch.utils import dtype_of

NEG_INF = -1e30
_Q_CHUNK = 1024  # q-block size for the chunked path


def init_attention(g, cfg, device, cross: bool = False):
    """q, k, v, o projections, and the qk-norm scales where the config
    asks for them, except on a cross-attention (``cross=True``)."""
    dt = dtype_of(cfg.dtype)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "q": init_dense(g, D, H * hd, dt, device, cfg.use_bias),
        "k": init_dense(g, D, K * hd, dt, device, cfg.use_bias),
        "v": init_dense(g, D, K * hd, dt, device, cfg.use_bias),
        "o": init_dense(g, H * hd, D, dt, device, cfg.use_bias,
                        scale=(H * hd) ** -0.5),
    }
    if cfg.use_qk_norm and not cross:
        p["q_norm"] = {"scale": torch.ones((hd,), dtype=torch.float32,
                                           device=device)}
        p["k_norm"] = {"scale": torch.ones((hd,), dtype=torch.float32,
                                           device=device)}
    return p


def _headnorm(scale, x, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _project_qkv(p, cfg, xq, xkv, q_positions, kv_positions, rope: bool):
    B, Sq, _ = xq.shape
    Skv = xkv.shape[1]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense_apply(p["q"], xq).reshape(B, Sq, H, hd)
    k = dense_apply(p["k"], xkv).reshape(B, Skv, K, hd)
    v = dense_apply(p["v"], xkv).reshape(B, Skv, K, hd)
    if "q_norm" in p:
        q = _headnorm(p["q_norm"]["scale"], q, cfg.norm_eps)
        k = _headnorm(p["k_norm"]["scale"], k, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, q_positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _attend(cfg, q, k, v, mask):
    """q: (B,Sq,H,hd) k/v: (B,T,K,hd) mask: (Sq,T) or (B,Sq,T) or None.
    Scores and softmax in f32; the weights are cast to v's dtype before
    the PV product, as in the reference. q and k/v may differ in dtype
    (a cross-attention over f32 encoder states): the scores take both in
    f32 and the PV product runs in v's dtype, as JAX's promotion does."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    # the scale and the mask go in place on the fresh f32 scores (the same
    # values as out of place): at command-r-35b's serve prefill a 1024-row
    # chunk's scores are 4 GiB, and each out-of-place copy would be
    # another 4 GiB beside 56 GiB of weights
    scores = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), k.float())
    scores.mul_(hd ** -0.5)
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[None]
        scores.masked_fill_(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    del scores
    out = torch.einsum("bkgqt,btkh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


def _causal_window_mask(q_pos, kv_pos, window: int):
    """(Sq, T) bool: kv visible to q. q_pos/kv_pos: int32 vectors."""
    m = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    return m


def _chunked_causal(cfg, q, k, v, positions, window: int):
    """Loop over query chunks; scores are (B,K,G,Cq,T) per chunk only."""
    B, S, H, hd = q.shape
    pos = positions[0] if positions.dim() > 1 else positions
    outs = []
    for c0 in range(0, S, _Q_CHUNK):
        pi = pos[c0:c0 + _Q_CHUNK]
        mask = _causal_window_mask(pi, pos, window)
        outs.append(_attend(cfg, q[:, c0:c0 + _Q_CHUNK], k, v, mask))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------- forward path ----
def attention_apply(p, cfg, x, positions, *, window: int = 0,
                    causal: bool = True, impl: str = "cuda"):
    """Self-attention over the full sequence. x: (B,S,D); positions:
    (B,S) or (S,) int32. ``impl="cuda"``: the K1 wrapper (the CUDA kernel
    on the card, its plain version on host tensors), which masks from the
    indices 0..S-1 like the TPU kernel; positions are read by RoPE only.
    ``impl="xla"``: the reference's plain path, masked from the
    positions."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, x, positions, positions, rope=True)
    if impl == "xla":
        if causal and S > _Q_CHUNK and S % _Q_CHUNK == 0:
            out = _chunked_causal(cfg, q, k, v, positions, window)
        else:
            pos = positions[0] if positions.dim() > 1 else positions
            mask = _causal_window_mask(pos, pos, window) if causal \
                else None
            out = _attend(cfg, q, k, v, mask)
        return dense_apply(p["o"], out)
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.attn_logit_softcap)
    return dense_apply(p["o"], out.reshape(B, S, -1))


# ------------------------------------------------------ cross-attention ----
def cross_attention_apply(p, cfg, x, kv_cache):
    """Decoder cross-attention over precomputed encoder k/v
    (``make_cross_kv``): no RoPE, no mask, plain (the reference calls no
    kernel here). x: (B,S,D)."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = dense_apply(p["q"], x).reshape(B, S, H, hd)
    out = _attend(cfg, q, kv_cache["ck"], kv_cache["cv"], None)
    return dense_apply(p["o"], out)


def make_cross_kv(p, cfg, enc_out):
    """The cross-attention's k/v of the encoder output enc_out (B,T,D):
    {"ck", "cv"}, each (B,T,K,hd)."""
    B, T, _ = enc_out.shape
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {"ck": dense_apply(p["k"], enc_out).reshape(B, T, K, hd),
            "cv": dense_apply(p["v"], enc_out).reshape(B, T, K, hd)}


# ----------------------------------------------------------- decode path ----
def cache_spec(cfg, batch: int, max_len: int, window: int):
    """Shape and dtype of one attention layer's KV cache."""
    W = min(window, max_len) if window > 0 else max_len
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (batch, W, K, hd)
    dt = dtype_of(cfg.dtype)
    return {"k": (shape, dt), "v": (shape, dt)}


def init_cache(cfg, batch: int, max_len: int, window: int, device):
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, dt) in
            cache_spec(cfg, batch, max_len, window).items()}


def decode_attention_apply(p, cfg, x, cache, pos, *, window: int = 0,
                           impl: str = "cuda", mesh=None):
    """One-token decode. x: (B,1,D); pos: 0-d int32 device tensor (the
    current index).

    Writes the new k/v into ring slot ``pos % W`` of ``cache`` IN PLACE
    (the reference donates the cache to the same effect) and attends over
    it: under ``impl="cuda"`` through the K2 wrapper (the CUDA kernel on
    the card, its plain version on host tensors), under "xla" plainly,
    slots above ``pos`` masked as in the reference. The slot is a device
    index: no host sync per layer per step.

    With a ``mesh`` under "xla" the decode is the reference's
    sequence-sharded flash-decode (``_decode_attention_sharded``): x and
    the cache are this rank's blocks (``decode_specs``), the ring being
    ``cache["k"].shape[1] * |model|`` slots, p is whole on every rank,
    and the output is equal on the ranks of the model axis. A ring that
    does not divide over the model axis, which the reference decodes
    unsharded, is decoded here by a call without the mesh.
    """
    B = x.shape[0]
    W = cache["k"].shape[1]
    pvec = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _project_qkv(p, cfg, x, x, pvec, pvec, rope=True)
    if mesh is not None and impl == "xla":
        out, cache = _decode_attention_sharded(
            cfg, q, k, v, cache, pos, mesh=mesh,
            softcap=cfg.attn_logit_softcap)
        return _o_proj_sharded(p["o"], out, mesh), cache
    slot = torch.remainder(pos, W).reshape(1).long()
    ck, cv = cache["k"], cache["v"]
    ck.index_copy_(1, slot, k)
    cv.index_copy_(1, slot, v)

    if impl == "xla":
        mask = (torch.arange(W, device=x.device) <= pos)[None, :]
        return dense_apply(p["o"], _attend(cfg, q, ck, cv, mask)), cache
    out = da_ops.decode_attention(q[:, 0], ck, cv, pos=pos, window=W,
                                  softcap=cfg.attn_logit_softcap)
    return dense_apply(p["o"], out.reshape(B, 1, -1)), cache


# ------------------------------------------- distributed flash-decode -------
def decode_specs(batch: int, hd_total: int, mesh,
                 data_axes=("data",), model_axis: str = "model"):
    """The blocks of the sequence-sharded decode, as the reference's
    shard_map specs lay them out: {"x": x and q/k/v (batch over the data
    axes where they divide it), "cache": the ring (batch likewise,
    sequence over the model axis), "out": the attention output (its
    H*hd over the model axis where that divides)}."""
    dp = tuple(a for a in data_axes if a in mesh.axis_names)
    dp_size = mesh.axis_size(dp) if dp else 1
    b = dp if dp and batch % dp_size == 0 else None
    msize = mesh.shape[model_axis]
    out = model_axis if hd_total % msize == 0 else None
    return {"x": (b, None, None, None), "cache": (b, model_axis, None, None),
            "out": (b, None, out)}


def _decode_attention_sharded(cfg, q, k_new, v_new, cache, pos, *, mesh,
                              model_axis: str = "model",
                              softcap: float = 0.0):
    """Decode over a sequence-sharded KV cache WITHOUT gathering it: the
    reference's shard_map body. Each rank of the model axis holds
    ``W_loc`` ring slots of the ``ring = W_loc * |model|`` (``cache``:
    (b, W_loc, K, hd), updated in place); it computes partial flash statistics (max, exp-sum,
    weighted values) over its slots and a pmax and two psums combine
    them, so the wire carries O(B*H*hd) a layer instead of the cache. The
    ring slot lands on the rank that owns ``pos % ring``, by a masked
    device-side write: no host sync. q/k_new/v_new: (b, 1, ., hd), whole
    on every rank of the model axis. Returns (out, cache): out is this
    rank's (b, 1, H*hd / |model|) slice (the whole H*hd where that does
    not divide), in q's dtype."""
    b, _, H, hd = q.shape
    K = k_new.shape[2]
    G = H // K
    msize = mesh.shape[model_axis]
    ck, cv = cache["k"], cache["v"]
    W_loc = ck.shape[1]
    ring = W_loc * msize
    r = mesh.axis_index(model_axis)
    lslot = torch.remainder(pos, ring).long() - r * W_loc
    mine = (lslot >= 0) & (lslot < W_loc)
    li = lslot.clamp(0, W_loc - 1).reshape(1)
    for c, new in ((ck, k_new), (cv, v_new)):
        c.index_copy_(1, li, torch.where(mine, new, c.index_select(1, li)))

    gslots = r * W_loc + torch.arange(W_loc, device=q.device)
    valid = (gslots <= pos) | (pos + 1 >= ring)
    qg = q.reshape(b, 1, K, G, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), ck.float())
    s.mul_(hd ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s.masked_fill_(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                    # (b,K,G,1,1)
    M = coll.pmax(m, model_axis, mesh)
    pr = torch.exp(s - M)
    den = coll.psum(pr.sum(dim=-1), model_axis, mesh)  # (b,K,G,1)
    num = coll.psum(
        torch.einsum("bkgqt,btkh->bqkgh", pr.to(cv.dtype), cv),
        model_axis, mesh)                               # (b,1,K,G,hd)
    out = (num / den[..., None].permute(0, 3, 1, 2, 4)).reshape(b, 1,
                                                               H * hd)
    if (H * hd) % msize == 0:
        sz = (H * hd) // msize
        out = out[..., r * sz:(r + 1) * sz]
    return out.to(q.dtype), cache


def _o_proj_sharded(p, out, mesh, model_axis: str = "model"):
    """The o-projection of the sharded decode's output: this rank's rows
    of the whole o weight on its H*hd slice, summed over the model axis
    (the bias added once), or the plain projection where the output is
    whole."""
    w = p["w"]
    n = out.shape[-1]
    if n == w.shape[0]:
        return dense_apply(p, out)
    r = mesh.axis_index(model_axis)
    y = dense_apply({"w": w[r * n:(r + 1) * n]}, out)
    y = coll.psum(y, model_axis, mesh)
    return y + p["b"] if "b" in p else y
