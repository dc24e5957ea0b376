"""Error-feedback int8 gradient compression.

int8 with a per-tensor scale cuts a gradient exchange 4x against f32;
error feedback carries the quantization residual into the next round
(Seide et al. / EF-SGD), so the scheme is unbiased over time.
``make_compressor`` applies it leaf by leaf to the gradients in the train
step (the wire format simulated end to end on one device);
``compressed_pmean`` is the exchange itself, over an axis of a mesh of
ranks (``launch.mesh.Mesh``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.sharding import collectives as coll
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32/bf16 -> (int8, scale). Symmetric per-tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback round: returns (decompressed g_hat, new residual)."""
    corrected = g.float() + residual
    q, scale = quantize(corrected)
    g_hat = dequantize(q, scale)
    return g_hat, corrected - g_hat


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def make_compressor():
    """Tree-level transform: (grads, residuals) -> (g_hat, residuals')."""
    def apply(grads, residuals):
        outs = [ef_compress_leaf(g, r) for g, r in
                zip(tree_leaves(grads), tree_leaves(residuals))]
        return (tree_unflatten(grads, [o[0] for o in outs]),
                tree_unflatten(grads, [o[1] for o in outs]))
    return apply


def compressed_pmean(x: torch.Tensor, axis_name, residual: torch.Tensor,
                     mesh):
    """int8-on-the-wire gradient mean with error feedback, over the ranks
    along ``axis_name`` of ``mesh``: returns (mean, new residual).

    A shared scale (the pmax of the local absmax: one scalar all-reduce)
    makes the int8 payloads sum-compatible; they are summed as int32, and
    the residual is taken against the shared scale, so feedback accounts
    for exactly what the wire lost. The reference's operations in its
    order, each rounding alike."""
    corrected = x.float() + residual
    local_max = corrected.abs().max()
    scale = torch.clamp(coll.pmax(local_max, axis_name, mesh),
                        min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127) \
        .to(torch.int8)
    new_residual = corrected - q.float() * scale
    n = coll.psum(torch.ones((), dtype=torch.float32, device=x.device),
                  axis_name, mesh)
    summed_q = coll.psum(q.to(torch.int32), axis_name, mesh)  # int8 payload
    out = summed_q.float() * scale / n
    return out, new_residual
