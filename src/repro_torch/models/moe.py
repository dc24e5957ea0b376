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
- ``a2a``:   expert parallelism over the model axis of a mesh, with
  explicit all-to-all dispatch and return (``moe_apply(mesh=)``); with a
  mesh ``sort`` is Expert-TP. Both run on a rank's blocks, as the
  reference's shard_map bodies do; ``Runtime`` still refuses "a2a" and a
  mesh, which wait for the sharded model slice.

All impls share the router and emit the same stats tree, which feeds the
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
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.rules import spec_of
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


# -------------------------------------------------------------------- a2a ---
def _replicated_stats(st, mesh, all_axes):
    """The stats made equal on every rank: the toggles pmax'd, the rest
    pmean'd over every mesh axis."""
    return {k: (coll.pmax(v.to(torch.int32), all_axes, mesh) > 0)
            if v.dtype == torch.bool
            else coll.pmean(v.float(), all_axes, mesh)
            for k, v in st.items()}


def _moe_a2a_local(p, cfg, x_block, mesh, axis: str, all_axes,
                   expert_impl: str = "cuda"):
    """The per-rank body of the expert-parallel dispatch. x_block:
    (B_loc, S_loc, D); p's experts are this rank's E/|axis|. The tokens
    are routed and dispatched locally into (E, C, D), each expert's rows
    go to the rank that owns it by one all-to-all, the local experts run
    on (e_loc, |axis|*C, D), and a second all-to-all returns them."""
    B, S, D = x_block.shape
    E = cfg.num_experts
    ep = mesh.axis_size(axis)
    e_loc = E // ep                              # local experts per rank
    x2 = x_block.reshape(B * S, D)
    gates, idx, probs = _route(p, cfg, x2)
    disp, slot, keep, inv_order, _ = _sort_dispatch(cfg, x2, idx)
    C = disp.shape[1]

    send = disp.reshape(ep, e_loc * C, D)
    recv = coll.all_to_all(send, axis, mesh)     # (ep, e_loc*C, D)
    # rows grouped per local expert: (e_loc, ep*C, D)
    h = recv.reshape(ep, e_loc, C, D).transpose(0, 1) \
            .reshape(e_loc, ep * C, D)
    y_loc = _expert_ffn(p, h, expert_impl)       # local experts' output
    back = y_loc.reshape(e_loc, ep, C, D).transpose(0, 1) \
               .reshape(ep, e_loc * C, D)
    ret = coll.all_to_all(back, axis, mesh)      # (ep, e_loc*C, D)
    y_ecd = ret.reshape(E, C, D)
    y = _sort_combine(cfg, y_ecd, slot, keep, inv_order, gates, B * S, D)
    dropped = 1.0 - keep.float().mean()
    st = _replicated_stats(_stats(cfg, idx, probs, dropped), mesh,
                           all_axes)
    return y.reshape(B, S, D).to(x_block.dtype), st


def _moe_a2a(p, cfg, x, mesh, model_axis, expert_impl):
    """Expert parallelism: tokens seq-split over the model axis, experts
    owned by its ranks. Requires num_experts % |model| == 0
    (many-small-expert archs, e.g. qwen3 128e over 16). Few-large-expert
    archs (mixtral 8e) use Expert-TP instead (``impl="sort"`` on a mesh):
    no all-to-all, a single all-reduce, and zero load imbalance."""
    E = cfg.num_experts
    ep = mesh.shape[model_axis]
    if E % ep != 0:
        raise ValueError(
            f"a2a EP needs num_experts ({E}) % model axis ({ep}) == 0; "
            "use impl='sort' (Expert-TP) for few-expert archs")
    if p["gate"].shape[0] != E // ep:
        raise ValueError(f"a2a EP over {ep} ranks holds {E // ep} experts "
                         f"a rank, not {p['gate'].shape[0]}")
    return _moe_a2a_local(p, cfg, x, mesh, model_axis,
                          tuple(mesh.axis_names), expert_impl)


def _moe_sort_local(p, cfg, x, mesh, model_axis="model",
                    expert_impl: str = "cuda"):
    """The sort dispatch made rank-local (Expert-TP). Expert weights are
    d_ff-sharded over the model axis; every rank of it routes its
    (replicated) tokens identically, computes its F/|model| slice of each
    selected expert, and one psum over the axis completes the
    down-projection (silu is elementwise over F, so F-sharding is exact
    and the load is balanced). The dispatch stays token-local, and the
    psum carries the output in its working dtype (each partial is already
    an f32 sum over F/|model| terms), as the reference's."""
    b, s, d = x.shape
    y, st = _moe_sort(p, cfg, x.reshape(b * s, d), expert_impl)
    y = coll.psum(y.to(x.dtype), model_axis, mesh)
    st = _replicated_stats(st, mesh, tuple(mesh.axis_names))
    return y.reshape(b, s, d), st


def moe_specs(impl: str, data_axes=("data",), model_axis: str = "model"):
    """The blocks ``moe_apply(mesh=)`` takes and returns, as the
    reference's shard_map specs: ({param path: spec}, the spec of x and
    of y). "a2a": experts over the model axis, tokens' batch over the data
    axes and sequence over the model axis; "sort" (Expert-TP): each
    expert's d_ff over the model axis, tokens' batch over the data
    axes."""
    if impl == "a2a":
        w = (model_axis, None, None)
        params = {"down": w, "gate": w, "router/w": (None, None), "up": w}
        xs = (data_axes, model_axis, None)
    elif impl == "sort":
        params = {"down": (None, model_axis, None),
                  "gate": (None, None, model_axis),
                  "router/w": (None, None),
                  "up": (None, None, model_axis)}
        xs = (data_axes, None, None)
    else:
        raise ValueError(f"no mesh layout for moe impl {impl!r}")
    return params, spec_of(*xs)


# ------------------------------------------------------------------ entry ---
def moe_apply(p, cfg, x, *, impl: str = "sort", expert_impl: str = "cuda",
              mesh=None, model_axis: str = "model"):
    """x: (B, S, D) -> (y, stats). ``expert_impl`` ("cuda" or "xla")
    chooses the expert products.

    With a ``mesh`` (a ``launch.mesh.Mesh``) the dispatch is the
    reference's sharded one, on this rank's blocks as ``moe_specs`` lays
    them out (x cut along its data axes and ``model_axis``): "a2a" the
    expert-parallel all-to-all, "sort" Expert-TP. y comes back in x's
    layout; the stats are equal on every rank (pmax'd or pmean'd over
    every axis)."""
    B, S, D = x.shape
    if impl == "a2a":
        if mesh is None:
            raise ValueError("a2a MoE dispatch requires a mesh")
        return _moe_a2a(p, cfg, x, mesh, model_axis, expert_impl)
    if impl == "sort" and mesh is not None:
        return _moe_sort_local(p, cfg, x, mesh, model_axis, expert_impl)
    x2 = x.reshape(B * S, D)
    if impl == "dense":
        y, st = _moe_dense(p, cfg, x2)
    elif impl == "sort":
        y, st = _moe_sort(p, cfg, x2, expert_impl)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    return y.reshape(B, S, D), st
