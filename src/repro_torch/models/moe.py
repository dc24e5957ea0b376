"""Mixture-of-Experts FFN: the router, the capacity-based sort dispatch
through the K5 wrapper, and the dense all-experts oracle.

- ``sort``:  route top-k, dispatch the tokens into uniform (E, C, D)
  expert batches (capacity C per expert; overflow dropped), run the expert
  FFN as three grouped products, and combine with the gates. The
  reference's single-device ``_moe_sort``. The products take
  ``expert_impl``: "cuda" runs them through the K5 wrapper (the kernel on
  the card, its plain version on host tensors); "xla" (the train path) as
  the reference's three einsums.
- ``dense``: every expert on every token, weighted by the gates, in plain
  torch: O(T * E). The golden model of the tests; never on the card path.

The reference's expert-parallel ``a2a`` dispatch and its sharded ``sort``
wait for the sharding slice (``Runtime`` refuses both).

Both impls share the router and emit the same stats tree, which feeds the
P-Shell: ``expert_toggles`` into the coverage CSR, ``load``,
``aux_loss`` and ``dropped_frac`` under the "router" tap.

Everything on the sort path stays on the device with shapes that follow
from the input's shape alone, so a decode window needs no host sync: the
capacity is a Python int, experts are counted by comparison and sum (not
``bincount``, which reads its maximum on the host), the offsets come from
``searchsorted`` over the sorted expert ids, and dropped entries go to a
trash slot instead of being selected by a boolean mask. The dispatch is a
gather (slot (e, c) reads the token of sorted entry offsets[e] + c), so
every expert row is written once, without atomics: a replay is bitwise.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.models.layers import normal
from repro_torch.utils import dtype_of


def init_moe(g, cfg, device):
    """Router (D, E) in f32 (drawn in the working dtype and widened, as
    the reference does); gate and up (E, D, F) and down (E, F, D) in the
    working dtype."""
    dt = dtype_of(cfg.dtype)
    D, E, Fd = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    return {
        "router": {"w": normal(g, (D, E), D ** -0.5, dt, device).float()},
        "gate": normal(g, (E, D, Fd), D ** -0.5, dt, device),
        "up": normal(g, (E, D, Fd), D ** -0.5, dt, device),
        "down": normal(g, (E, Fd, D), Fd ** -0.5, dt, device),
    }


def _route(p, cfg, x2):
    """x2: (T, D) -> gates (T,k) f32, idx (T,k) int64, probs (T,E) f32."""
    logits = x2.float() @ p["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, idx, probs


def _stats(cfg, idx, probs, dropped_frac):
    """Router stats: coverage toggles and the load-balance aux loss."""
    E = cfg.num_experts
    experts = torch.arange(E, device=idx.device)
    counts = (idx.reshape(-1, 1) == experts).sum(dim=0).float()
    load = counts / counts.sum().clamp_min(1.0)
    importance = probs.mean(dim=0)
    # Switch-style aux loss: E * sum(load_frac * mean_prob)
    aux_loss = E * (load * importance).sum()
    return {
        "expert_toggles": counts > 0,          # (E,) coverage bits
        "load": load,                          # (E,)
        "aux_loss": aux_loss,                  # scalar
        "dropped_frac": dropped_frac,          # scalar
    }


# ------------------------------------------------------------------ dense ---
def _moe_dense(p, cfg, x2):
    gates, idx, probs = _route(p, cfg, x2)
    combine = torch.zeros((x2.shape[0], cfg.num_experts),
                          dtype=torch.float32, device=x2.device)
    combine.scatter_(1, idx, gates)
    g = F.silu(torch.einsum("td,edf->tef", x2, p["gate"]))
    u = torch.einsum("td,edf->tef", x2, p["up"])
    y_e = torch.einsum("tef,efd->ted", g * u, p["down"])
    y = torch.einsum("ted,te->td", y_e.float(), combine)
    zero = torch.zeros((), dtype=torch.float32, device=x2.device)
    return y.to(x2.dtype), _stats(cfg, idx, probs, zero)


# ------------------------------------------------------------------- sort ---
def _capacity(cfg, n_tokens: int, n_experts: int) -> int:
    c = math.ceil(n_tokens * cfg.num_experts_per_tok * cfg.capacity_factor
                  / n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _sort_dispatch(cfg, x2, idx):
    """Returns (disp (E,C,D), slot (T*k,), keep (T*k,), inv_order (T*k,),
    counts (E,)), the reference's outputs: entries sorted stably by
    expert, the first C of each expert kept, the rest sent to the trash
    slot E*C."""
    T, D = x2.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(cfg, T, E)
    flat_e = idx.reshape(-1)                                  # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, dtype=sorted_e.dtype, device=x2.device)
    offsets = torch.searchsorted(sorted_e, experts)           # (E,)
    counts = torch.searchsorted(sorted_e, experts, right=True) - offsets
    pos = torch.arange(T * k, device=x2.device) - offsets[sorted_e]
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos, E * C)       # E*C = trash
    tok = order // k
    # slot (e, c) holds sorted entry offsets[e] + c while c < counts[e];
    # empty slots read the zero row T
    c_idx = torch.arange(C, device=x2.device)
    src = (offsets[:, None] + c_idx).clamp(max=T * k - 1)
    src_tok = torch.where(c_idx < counts[:, None], tok[src], T)
    xz = torch.cat([x2, x2.new_zeros((1, D))])
    disp = xz[src_tok.reshape(-1)].reshape(E, C, D)
    inv_order = torch.argsort(order)
    return disp, slot, keep, inv_order, counts


def _sort_combine(cfg, y_ecd, slot, keep, inv_order, gates, T, D):
    """Each entry reads its slot's expert output (0 where dropped), back
    in token order; the k outputs of a token summed in f32 by gate."""
    E, C = y_ecd.shape[:2]
    flat = y_ecd.reshape(E * C, D)
    vals_sorted = flat[slot.clamp(max=E * C - 1)]
    vals_sorted = torch.where(keep[:, None], vals_sorted, 0)
    vals = vals_sorted[inv_order]                             # (T*k, D)
    k = cfg.num_experts_per_tok
    return (vals.reshape(T, k, D).float() * gates[..., None]).sum(dim=1)


def _expert_ffn(p, h_ecd, impl: str = "cuda"):
    """silu(h @ gate) * (h @ up) @ down per expert, each product through
    the K5 wrapper ("cuda") or as the reference's einsum ("xla"); the silu
    and the gate product in h's dtype, as the reference has them."""
    if impl == "xla":
        g = F.silu(torch.einsum("ecd,edf->ecf", h_ecd, p["gate"]))
        u = torch.einsum("ecd,edf->ecf", h_ecd, p["up"])
        return torch.einsum("ecf,efd->ecd", g * u, p["down"])
    g = F.silu(gg_ops.grouped_gemm(h_ecd, p["gate"]))
    u = gg_ops.grouped_gemm(h_ecd, p["up"])
    return gg_ops.grouped_gemm(g * u, p["down"])


def _moe_sort(p, cfg, x2, expert_impl: str = "cuda"):
    T, D = x2.shape
    gates, idx, probs = _route(p, cfg, x2)
    disp, slot, keep, inv_order, _ = _sort_dispatch(cfg, x2, idx)
    y_ecd = _expert_ffn(p, disp, expert_impl)
    y = _sort_combine(cfg, y_ecd, slot, keep, inv_order, gates, T, D)
    dropped = 1.0 - keep.float().mean()
    return y.to(x2.dtype), _stats(cfg, idx, probs, dropped)


# ------------------------------------------------------------------ entry ---
def moe_apply(p, cfg, x, *, impl: str = "sort", expert_impl: str = "cuda"):
    """x: (B, S, D) -> (y, stats). ``expert_impl`` ("cuda" or "xla")
    chooses the sort dispatch's expert products."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    if impl == "dense":
        y, st = _moe_dense(p, cfg, x2)
    elif impl == "sort":
        y, st = _moe_sort(p, cfg, x2, expert_impl)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    return y.reshape(B, S, D), st
