"""Decoder-only LM assembly: stacked periods plus an unrolled tail.

Layers are grouped into *periods* of ``len(cfg.layer_pattern)``; each
pattern position's params are stacked over periods on a leading axis (the
JAX package scans over that axis; here a Python loop walks it), and the
remainder (``num_layers % period``) is kept as ``tail``. The layout
``{"blocks": tuple, "tail": list}`` and the period-major layer order are
the reference's, so carried-across weights and per-layer streams line up.

The forward (``block_apply``, ``stack_apply``, ``lm_hidden``,
``lm_logits``) emits the reference's instrumentation ``aux`` tree under
``rt.taps``: per-layer activation checksums ("commits") and nan/inf bits
("coverage"), as ``{"scanned": tuple(pattern position) of dicts whose
leaves are stacked over periods on axis 0, "tail": tuple of dicts}``.
``core/commit.py`` reads that layout in period-major layer order.

The attention mixers (attn / swa / local), the RG-LRU mixer and the
Mamba-1 mixer are ported, with the GLU MLP, the MoE FFN or no FFN. Every
mixer, the decode's attention and the MoE expert products take
``rt.attention_impl``: the hand-written kernels under "cuda", the
reference's plain, differentiable code under "xla" (the train path). A MoE
block also emits its load-balance loss as ``aux["moe_aux_loss"]``, and
its router stats under ``aux["moe"]``: all of them under the "router"
tap, only the expert toggles under "coverage".
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (embed_apply, init_dense, init_embed,
                                       init_mlp, init_norm, logits_apply,
                                       mlp_apply, norm_apply)
from repro_torch.models.runtime import Runtime
from repro_torch.utils import checksum, dtype_of, has_nan_bit, tree_map

_ATTN_KINDS = ("attn", "swa", "local")


# ------------------------------------------------------------------ block ---
def _check_spec(spec):
    mixer, ffn = spec
    if mixer not in _ATTN_KINDS + ("mamba", "rglru"):
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in (None, "mlp", "moe"):
        raise ValueError(f"unknown ffn {ffn!r}")


def init_block(g, cfg, spec, device):
    _check_spec(spec)
    mixer, ffn = spec
    p: Dict[str, Any] = {"norm1": init_norm(cfg, cfg.d_model, device)}
    if mixer == "mamba":
        p["mamba"] = ssm_mod.init_mamba(g, cfg, device)
    elif mixer == "rglru":
        p["rglru"] = rec_mod.init_rglru(g, cfg, device)
    else:
        p["attn"] = attn.init_attention(g, cfg, device)
    if ffn is not None:
        p["norm2"] = init_norm(cfg, cfg.d_model, device)
        if ffn == "mlp":
            p["mlp"] = init_mlp(g, cfg, cfg.d_ff, device)
        else:
            p["moe"] = moe_mod.init_moe(g, cfg, device)
    return p


def _mixer_window(cfg, mixer):
    return cfg.window if mixer in ("swa", "local") else 0


def _ffn_apply(p, cfg, ffn, x, moe_impl: str, expert_impl: str):
    """The block's FFN on its residual stream x: (x, MoE stats or None)."""
    h2 = norm_apply(cfg, p["norm2"], x)
    if ffn == "mlp":
        return x + mlp_apply(p["mlp"], h2), None
    y2, stats = moe_mod.moe_apply(p["moe"], cfg, h2, impl=moe_impl,
                                  expert_impl=expert_impl)
    return x + y2, stats


def block_apply(p, cfg, spec, x, positions, rt: Runtime):
    """Full-sequence forward of one block. Returns (x, aux) with the taps
    of ``rt.taps``: "checksum" (commits) and "nan_bit" (coverage) of the
    block's output; for a MoE FFN the router stats ("router": all of
    them; "coverage": the expert toggles) and, always, its aux loss."""
    mixer, ffn = spec
    _check_spec(spec)
    impl = rt.attention_impl
    h = norm_apply(cfg, p["norm1"], x)
    if mixer == "mamba":
        x = x + ssm_mod.mamba_apply(p["mamba"], cfg, h, impl=impl)
    elif mixer == "rglru":
        x = x + rec_mod.rglru_apply(p["rglru"], cfg, h, impl=impl)
    else:
        x = x + attn.attention_apply(p["attn"], cfg, h, positions,
                                     window=_mixer_window(cfg, mixer),
                                     impl=impl)
    aux: Dict[str, Any] = {}
    if ffn is not None:
        x, stats = _ffn_apply(p, cfg, ffn, x, rt.moe_impl, impl)
        if stats is not None:
            if "router" in rt.taps:
                aux["moe"] = stats
            elif "coverage" in rt.taps:
                aux["moe"] = {"expert_toggles": stats["expert_toggles"]}
            aux["moe_aux_loss"] = stats["aux_loss"]
    if "commits" in rt.taps:
        aux["checksum"] = checksum(x)
    if "coverage" in rt.taps:
        aux["nan_bit"] = has_nan_bit(x)
    return x, aux


def block_cache_spec(cfg, spec, batch: int, max_len: int):
    _check_spec(spec)
    if spec[0] == "mamba":
        return ssm_mod.mamba_state_spec(cfg, batch)
    if spec[0] == "rglru":
        return rec_mod.rglru_state_spec(cfg, batch)
    return attn.cache_spec(cfg, batch, max_len, _mixer_window(cfg, spec[0]))


def block_decode(p, cfg, spec, x1, cache, pos, rt: Runtime = Runtime()):
    """One-token block step; ``cache`` is updated in place. A MoE FFN
    always takes the sort dispatch here, over the batch's B tokens."""
    mixer, ffn = spec
    _check_spec(spec)
    h = norm_apply(cfg, p["norm1"], x1)
    if mixer == "mamba":
        y, cache = ssm_mod.mamba_decode(p["mamba"], cfg, h, cache)
    elif mixer == "rglru":
        y, cache = rec_mod.rglru_decode(p["rglru"], cfg, h, cache)
    else:
        y, cache = attn.decode_attention_apply(
            p["attn"], cfg, h, cache, pos, window=_mixer_window(cfg, mixer),
            impl=rt.attention_impl)
    x1 = x1 + y
    if ffn is not None:
        x1, _ = _ffn_apply(p, cfg, ffn, x1, "sort", rt.attention_impl)
    return x1, cache


def block_prefill(p, cfg, spec, x, positions, max_len: int,
                  rt: Runtime = Runtime()):
    """Full-seq forward that also emits this block's decode cache; a MoE
    FFN takes ``rt.moe_impl``."""
    mixer, ffn = spec
    _check_spec(spec)
    h = norm_apply(cfg, p["norm1"], x)
    if mixer == "mamba":
        y, cache = ssm_mod.mamba_prefill(p["mamba"], cfg, h,
                                         impl=rt.attention_impl)
    elif mixer == "rglru":
        y, cache = rec_mod.rglru_prefill(p["rglru"], cfg, h,
                                         impl=rt.attention_impl)
    else:
        y, cache = _attention_prefill(p["attn"], cfg, mixer, h, positions,
                                      max_len)
    x = x + y
    if ffn is not None:
        x, _ = _ffn_apply(p, cfg, ffn, x, rt.moe_impl, rt.attention_impl)
    return x, cache


def _attention_prefill(p, cfg, mixer, h, positions, max_len: int):
    """Plain attention over the prompt (q-chunked above ``_Q_CHUNK``) and
    the layer's ring KV cache."""
    window = _mixer_window(cfg, mixer)
    B, S, _ = h.shape
    q, k, v = attn._project_qkv(p, cfg, h, h, positions, positions,
                                rope=True)
    pos = positions[0] if positions.dim() > 1 else positions
    if S > attn._Q_CHUNK and S % attn._Q_CHUNK == 0:
        out = attn._chunked_causal(cfg, q, k, v, positions, window)
    else:
        mask = attn._causal_window_mask(pos, pos, window)
        out = attn._attend(cfg, q, k, v, mask)
    y = attn.dense_apply(p["o"], out)
    W = min(window, max_len) if window > 0 else max_len
    ck = k.new_zeros((B, W) + k.shape[2:])
    cv = v.new_zeros((B, W) + v.shape[2:])
    if W >= S:
        ck[:, :S] = k
        cv[:, :S] = v
    else:
        # ring-consistent placement of the last W keys (slot = t % W)
        slots = torch.arange(S - W, S, device=h.device) % W
        ck.index_copy_(1, slots, k[:, S - W:])
        cv.index_copy_(1, slots, v[:, S - W:])
    return y, {"k": ck, "v": cv}


# --------------------------------------------------------------- assembly ---
def _partition(cfg):
    P_len = len(cfg.layer_pattern)
    n_periods = cfg.num_layers // P_len
    remainder = cfg.num_layers % P_len
    return P_len, n_periods, remainder


def _period(tree, i: int):
    """Period ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda t: t[i], tree)


def init_stacked(init_fn, n: int, g, device):
    """``n`` draws of ``init_fn(g, device)`` stacked on a leading axis,
    each drawn and copied into its slot, so init holds one block beyond
    the stack."""
    stacked = tree_map(lambda t: torch.empty(
        (n,) + tuple(t.shape), dtype=t.dtype, device=device),
        init_fn(None, "meta"))
    for i in range(n):
        tree_map(lambda dst, src: dst[i].copy_(src), stacked,
                 init_fn(g, device))
    return stacked


def init_stack(g, cfg, device):
    """Stacked period params + unrolled tail."""
    P_len, n_periods, remainder = _partition(cfg)
    pattern = cfg.layer_pattern
    blocks = tuple(init_stacked(
        lambda g_, dev, spec=pattern[j]: init_block(g_, cfg, spec, dev),
        n_periods, g, device) for j in range(P_len))
    tail = [init_block(g, cfg, pattern[i % P_len], device)
            for i in range(remainder)]
    return {"blocks": blocks, "tail": tail}


def _period_apply(blocks, i, x, cfg, positions, rt):
    """Period ``i`` of the stack: one block per pattern position. Returns
    (x, one aux dict per position). The taps are pure outputs, so a remat
    recompute pushes nothing twice."""
    auxes = []
    for j, spec in enumerate(cfg.layer_pattern):
        x, aux = block_apply(_period(blocks[j], i), cfg, spec, x, positions,
                             rt)
        auxes.append(aux)
    return x, tuple(auxes)


def _period_prefill(blocks, i, x, cfg, positions, max_len, rt):
    """Period ``i``'s prefill: (x, one cache per pattern position)."""
    caches = []
    for j, spec in enumerate(cfg.layer_pattern):
        x, c = block_prefill(_period(blocks[j], i), cfg, spec, x, positions,
                             max_len, rt)
        caches.append(c)
    return x, tuple(caches)


def stack_apply(stack, cfg, x, positions, rt: Runtime):
    """Forward through all layers in period-major order, each period's
    body under ``rt.checkpoint`` (the reference's remat of its scan body).
    Returns (x, aux) in the reference's layout: "scanned" (present when
    there is at least one period) holds one dict per pattern position with
    each tap stacked over periods; "tail" one dict per tail layer."""
    P_len, n_periods, _ = _partition(cfg)
    pattern = cfg.layer_pattern
    per_pos = [[] for _ in range(P_len)]
    body = rt.checkpoint(_period_apply)
    for i in range(n_periods):
        x, auxes = body(stack["blocks"], i, x, cfg, positions, rt)
        for j, aux in enumerate(auxes):
            per_pos[j].append(aux)
    aux_all: Dict[str, Any] = {}
    if n_periods > 0:
        aux_all["scanned"] = tuple(
            tree_map(lambda *a: torch.stack(a), *auxes) for auxes in per_pos)
    tail_aux = []
    for i, p in enumerate(stack["tail"]):
        x, aux = block_apply(p, cfg, pattern[i % P_len], x, positions, rt)
        tail_aux.append(aux)
    aux_all["tail"] = tuple(tail_aux)
    return x, aux_all


def stack_cache_spec(cfg, batch: int, max_len: int):
    """(shape, dtype) of every cache leaf, in the reference's layout."""
    P_len, n_periods, remainder = _partition(cfg)
    pattern = cfg.layer_pattern

    def stacked(spec_tree):
        return {k: ((n_periods,) + shape, dt)
                for k, (shape, dt) in spec_tree.items()}

    scanned = tuple(stacked(block_cache_spec(cfg, pattern[j], batch, max_len))
                    for j in range(P_len)) if n_periods else ()
    tail = tuple(block_cache_spec(cfg, pattern[i % P_len], batch, max_len)
                 for i in range(remainder))
    return {"scanned": scanned, "tail": tail, "pos": ((), torch.int32)}


def stack_decode(stack, cfg, x1, cache, rt: Runtime = Runtime()):
    """One-token decode through all layers; returns (x1, cache) with the
    layer caches updated in place and ``pos`` advanced on the device."""
    P_len, n_periods, _ = _partition(cfg)
    pattern = cfg.layer_pattern
    pos = cache["pos"]
    for i in range(n_periods):
        for j in range(P_len):
            x1, _ = block_decode(_period(stack["blocks"][j], i), cfg,
                                 pattern[j], x1,
                                 _period(cache["scanned"][j], i), pos, rt)
    for i, p in enumerate(stack["tail"]):
        x1, _ = block_decode(p, cfg, pattern[i % P_len], x1,
                             cache["tail"][i], pos, rt)
    return x1, {**cache, "pos": pos + 1}


def stack_prefill(stack, cfg, x, positions, max_len: int,
                  rt: Runtime = Runtime()):
    P_len, n_periods, _ = _partition(cfg)
    pattern = cfg.layer_pattern
    per_pos = [[] for _ in range(P_len)]
    body = rt.checkpoint(_period_prefill)
    for i in range(n_periods):
        x, caches = body(stack["blocks"], i, x, cfg, positions, max_len, rt)
        for j, c in enumerate(caches):
            per_pos[j].append(c)
    cache: Dict[str, Any] = {"scanned": tuple(
        tree_map(lambda *cs: torch.stack(cs), *cs) for cs in per_pos)
        if n_periods else ()}
    tail_c = []
    for i, p in enumerate(stack["tail"]):
        x, c = block_prefill(p, cfg, pattern[i % P_len], x, positions,
                             max_len, rt)
        tail_c.append(c)
    cache["tail"] = tuple(tail_c)
    cache["pos"] = torch.full((), x.shape[1], dtype=torch.int32,
                              device=x.device)
    return x, cache


# -------------------------------------------------------------- LM facade ---
def init_lm(g, cfg, device):
    params = {
        "embed": init_embed(g, cfg, device),
        "stack": init_stack(g, cfg, device),
        "final_norm": init_norm(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(g, cfg.d_model, cfg.vocab_size,
                                       dtype_of(cfg.dtype), device)
    return params


def lm_hidden(params, cfg, tokens, rt: Runtime, prefix_embeds=None,
              positions=None):
    """tokens (B,S) -> final hidden (B,S',D), aux. ``prefix_embeds`` (a
    VLM's projected patches, (B,P,D)) is prepended before the stack, so
    S' = P + S. Without ``positions`` the stack runs at 0..S'-1 and, as in
    the reference, a learned position table is not added (only RoPE
    reads the positions)."""
    x = embed_apply(params["embed"], tokens,
                    positions if cfg.learned_pos else None)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x, aux = stack_apply(params["stack"], cfg, x, positions, rt)
    return norm_apply(cfg, params["final_norm"], x), aux


def lm_logits(params, cfg, tokens, rt: Runtime, **kw):
    """tokens (B,S) -> f32 logits (B,S',V), aux; ``kw`` as ``lm_hidden``."""
    h, aux = lm_hidden(params, cfg, tokens, rt, **kw)
    return logits_apply(params, cfg, h), aux
