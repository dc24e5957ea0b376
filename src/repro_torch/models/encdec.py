"""Whisper-style encoder-decoder. The conv audio frontend is a stub, as in
the JAX package: inputs are precomputed frame embeddings
(B, encoder_seq, d_model).

Decoder blocks: causal self-attention, cross-attention over the encoder
output, MLP. Each stack's params are stacked over its layers on a
leading axis (the reference's ``vmap``-ed init and layer scan; here a
Python loop walks it), in the reference's layout, so carried-across
weights line up. The encoder's attention is plain and non-causal; the
decoder's self-attention takes ``rt.attention_impl`` (K1 in the forward
under "cuda", K2 in the decode); the prefill's attention is plain, as in
the reference. Decode keeps a self-attention ring cache per layer,
updated in place (so ``core/graphs.py::WindowGraphs`` captures a decode
window as it captures ``stack_decode``), and per-layer cross-attention
K/V written once at prefill and only read after.

dtypes follow the reference's promotion: f32 frames (the pipeline's) run
the encoder and every cross-attention in f32 against bf16 weights, and
each layer casts its output back to the dtype of its carry. The
reference's prefill fails on such frames (its scan carry changes dtype);
``encdec_prefill`` raises a ``TypeError`` that says so, and the serve
entry point casts the frames to the model's dtype first.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (dense_apply, embed_apply, init_embed,
                                       init_mlp, init_norm, logits_apply,
                                       mlp_apply, norm_apply, normal)
from repro_torch.models.runtime import Runtime
from repro_torch.utils import checksum, dtype_of, tree_map


def _init_enc_block(g, cfg, device):
    return {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "attn": attn.init_attention(g, cfg, device),
        "norm2": init_norm(cfg, cfg.d_model, device),
        "mlp": init_mlp(g, cfg, cfg.d_ff, device),
    }


def _init_dec_block(g, cfg, device):
    return {
        "norm1": init_norm(cfg, cfg.d_model, device),
        "self": attn.init_attention(g, cfg, device),
        "norm_x": init_norm(cfg, cfg.d_model, device),
        "cross": attn.init_attention(g, cfg, device, cross=True),
        "norm2": init_norm(cfg, cfg.d_model, device),
        "mlp": init_mlp(g, cfg, cfg.d_ff, device),
    }


def init_encdec(g, cfg, device):
    """The reference's tree: each stack's blocks stacked over its layers
    (``transformer.init_stacked``)."""
    dt = dtype_of(cfg.dtype)
    return {
        "embed": init_embed(g, cfg, device),
        "enc_pos": normal(g, (cfg.encoder_seq, cfg.d_model), 0.02, dt,
                          device),
        "encoder": tfm.init_stacked(
            lambda g_, dev: _init_enc_block(g_, cfg, dev),
            cfg.encoder_layers, g, device),
        "enc_norm": init_norm(cfg, cfg.d_model, device),
        "decoder": tfm.init_stacked(
            lambda g_, dev: _init_dec_block(g_, cfg, dev),
            cfg.num_layers, g, device),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }


_layer = tfm._period    # layer i's slice of a stacked tree (views)


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _enc_layer(stack, i, x, cfg, pos):
    dt = x.dtype            # the layer's carry keeps its dtype
    p = _layer(stack, i)
    h = norm_apply(cfg, p["norm1"], x)
    x = x + attn.attention_apply(p["attn"], cfg, h, pos, causal=False,
                                 impl="xla")
    h2 = norm_apply(cfg, p["norm2"], x)
    return (x + mlp_apply(p["mlp"], h2)).to(dt)


def encode(params, cfg, frames, rt: Runtime):
    """frames: (B, T_enc, D), the stubbed frontend's output -> the encoder
    hidden state, in the frames' dtype (promoted with the weights')."""
    x = frames + params["enc_pos"].to(frames.dtype)
    B, T, _ = x.shape
    pos = _positions(B, T, x.device)
    body = rt.checkpoint(_enc_layer)
    for i in range(cfg.encoder_layers):
        x = body(params["encoder"], i, x, cfg, pos)
    return norm_apply(cfg, params["enc_norm"], x)


def _dec_block(p, cfg, x, positions, cross_kv, rt: Runtime):
    h = norm_apply(cfg, p["norm1"], x)
    x = x + attn.attention_apply(p["self"], cfg, h, positions,
                                 impl=rt.attention_impl)
    hx = norm_apply(cfg, p["norm_x"], x)
    x = x + attn.cross_attention_apply(p["cross"], cfg, hx, cross_kv)
    h2 = norm_apply(cfg, p["norm2"], x)
    return x + mlp_apply(p["mlp"], h2)


def _dec_layer(stack, i, x, cfg, positions, enc_out, rt):
    """Decoder layer ``i`` of the forward: (x in its carry's dtype, taps).
    The taps are pure outputs, so a remat recompute pushes nothing
    twice."""
    p = _layer(stack, i)
    ckv = attn.make_cross_kv(p["cross"], cfg, enc_out)
    x = _dec_block(p, cfg, x, positions, ckv, rt).to(x.dtype)
    aux = {"checksum": checksum(x)} if "commits" in rt.taps else {}
    return x, aux


def decode_hidden(params, cfg, tokens, enc_out, rt: Runtime):
    """tokens (B,S) over the encoder output -> final hidden (B,S,D) and
    the aux tree ({"scanned": (one dict of per-layer taps stacked over
    the layers,), "tail": ()}, the reference's layout). The decoder adds
    its learned position table at 0..S-1."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_apply(params["embed"], tokens, positions)
    body = rt.checkpoint(_dec_layer)
    auxes = []
    for i in range(cfg.num_layers):
        x, aux = body(params["decoder"], i, x, cfg, positions, enc_out, rt)
        auxes.append(aux)
    stacked = tree_map(lambda *a: torch.stack(a), *auxes)
    return norm_apply(cfg, params["final_norm"], x), {"scanned": (stacked,),
                                                      "tail": ()}


def encdec_logits(params, cfg, batch, rt: Runtime):
    """The commit-tapped forward: f32 logits (B,S,V) and the aux tree."""
    enc_out = encode(params, cfg, batch["frames"], rt)
    h, aux = decode_hidden(params, cfg, batch["tokens"], enc_out, rt)
    return logits_apply(params, cfg, h), aux


# ----------------------------------------------------------------- decode ---
def encdec_cache_spec(cfg, batch: int, max_len: int):
    """(shape, dtype) of every cache leaf, in the reference's layout."""
    dt = dtype_of(cfg.dtype)
    L, K, hd, T = (cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
                   cfg.encoder_seq)
    kv = attn.cache_spec(cfg, batch, max_len, 0)
    return {
        "self": {k: ((L,) + shape, d) for k, (shape, d) in kv.items()},
        "cross": {"ck": ((L, batch, T, K, hd), dt),
                  "cv": ((L, batch, T, K, hd), dt)},
        "pos": ((), torch.int32),
    }


def init_cache(cfg, batch: int, max_len: int, device) -> Dict[str, Any]:
    """A zero cache of ``encdec_cache_spec``'s layout on ``device``."""
    spec = encdec_cache_spec(cfg, batch, max_len)

    def zeros(node):
        if isinstance(node, tuple) and isinstance(node[1], torch.dtype):
            return torch.zeros(node[0], dtype=node[1], device=device)
        return {k: zeros(v) for k, v in node.items()}
    return zeros(spec)


def _check_frames(cfg, frames):
    """The reference's prefill scans its decoder with a carry in the
    model's dtype. Frames that promote it (f32 frames on a bf16 model)
    make the cross-attention output f32, and its ``lax.scan`` raises on
    the changed carry; the port raises here, naming the cause."""
    dt = dtype_of(cfg.dtype)
    if torch.promote_types(frames.dtype, dt) != dt:
        raise TypeError(
            f"encdec_prefill: frames are {frames.dtype}, the model "
            f"{dt}. The cross-attention output would be "
            f"{torch.promote_types(frames.dtype, dt)} and change the "
            f"decoder's {dt} carry, which the reference's prefill scan "
            f"refuses; cast the frames to {dt} first (as serve does)")


def encdec_prefill(params, cfg, batch, max_len: int, rt: Runtime):
    """Encode, then run the decoder over the prompt (plain attention, as in
    the reference), building the caches: each layer's self-attention k/v
    at slots 0..S-1 of a ``max_len`` ring, and its cross-attention k/v.
    Returns (cache, f32 logits of the last position)."""
    frames = batch["frames"]
    _check_frames(cfg, frames)
    enc_out = encode(params, cfg, frames, rt)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_apply(params["embed"], tokens, positions)
    cache = init_cache(cfg, B, max_len, tokens.device)
    pos = positions[0]
    for i in range(cfg.num_layers):
        p = _layer(params["decoder"], i)
        ckv = attn.make_cross_kv(p["cross"], cfg, enc_out)
        h = norm_apply(cfg, p["norm1"], x)
        q, k, v = attn._project_qkv(p["self"], cfg, h, h, positions,
                                    positions, rope=True)
        if S > attn._Q_CHUNK and S % attn._Q_CHUNK == 0:
            out = attn._chunked_causal(cfg, q, k, v, positions, 0)
        else:
            mask = attn._causal_window_mask(pos, pos, 0)
            out = attn._attend(cfg, q, k, v, mask)
        x = x + dense_apply(p["self"]["o"], out)
        hx = norm_apply(cfg, p["norm_x"], x)
        x = x + attn.cross_attention_apply(p["cross"], cfg, hx, ckv)
        h2 = norm_apply(cfg, p["norm2"], x)
        x = x + mlp_apply(p["mlp"], h2)
        cache["self"]["k"][i, :, :S] = k
        cache["self"]["v"][i, :, :S] = v
        cache["cross"]["ck"][i] = ckv["ck"]
        cache["cross"]["cv"][i] = ckv["cv"]
    x = norm_apply(cfg, params["final_norm"], x)
    cache["pos"].fill_(S)
    return cache, logits_apply(params, cfg, x[:, -1:])


def encdec_decode_step(params, cfg, cache, tokens1, rt: Runtime):
    """One new token a sequence against the standing cache: each layer's
    self-attention ring slot ``pos % W`` is written in place (K2 under
    "cuda"), the cross K/V only read. Returns (cache with ``pos``
    advanced on the device, f32 logits (B,1,V))."""
    B = tokens1.shape[0]
    pos = cache["pos"]
    x = embed_apply(params["embed"], tokens1, pos.reshape(1, 1).expand(B, 1))
    for i in range(cfg.num_layers):
        p = _layer(params["decoder"], i)
        h = norm_apply(cfg, p["norm1"], x)
        y, _ = attn.decode_attention_apply(p["self"], cfg, h,
                                           _layer(cache["self"], i), pos,
                                           impl=rt.attention_impl)
        x = x + y
        hx = norm_apply(cfg, p["norm_x"], x)
        x = x + attn.cross_attention_apply(p["cross"], cfg, hx,
                                           _layer(cache["cross"], i))
        h2 = norm_apply(cfg, p["norm2"], x)
        x = x + mlp_apply(p["mlp"], h2)
    x = norm_apply(cfg, params["final_norm"], x)
    return {**cache, "pos": pos + 1}, logits_apply(params, cfg, x)
