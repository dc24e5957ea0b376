"""Sharding rules: map parameter, batch and cache trees to partition specs,
the JAX package's ``sharding/rules.py`` over the port's own tree paths.

Strategy:
  train : FSDP over ("pod","data") on one weight dim, TP over "model"
          (heads / d_ff / vocab), batch over ("pod","data").
  serve : weights TP over "model" only (replicated over data: no per-step
          gathers), batch over data, KV-cache *sequence* dim over "model"
          (flash-decoding-style sequence-parallel decode; kv_heads of the
          assigned archs never divide 16, so head-sharding is not viable).

Every spec passes through ``fit_spec``, which drops mesh axes that do not
divide the corresponding dim (e.g. whisper's vocab 51865 stays replicated).
MoE weights: EP over "model" on the expert dim for the a2a impl; Expert-TP
(d_ff over "model") otherwise.

A spec is a tuple of ``PartitionSpec`` entries, one per dim: None, an
axis name, or a tuple of names (normalised as JAX normalises them: a
one-name tuple is the name). A spec tree is a dict from a leaf's path
(``utils.tree_paths_sorted``'s, e.g. ``stack/blocks/0/attn/q/w``) to its
spec. The rules read shapes only: a tree of tensors (meta tensors do) or
of ``(shape, dtype)`` pairs (``Model.cache_spec``), on a ``Mesh`` or an
``AbstractMesh``. ``local_shard`` cuts a rank's block of a leaf by its
spec and ``gather`` rebuilds the whole leaf from the blocks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import collectives as coll

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class Axes:
    mesh: object
    dp: Tuple[str, ...]      # batch axes ("pod","data") or ("data",)
    fsdp: Tuple[str, ...]    # weight-shard axes in train mode, () in serve
    model: str = "model"

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp)


def make_axes(mesh, mode: str) -> Axes:
    names = tuple(mesh.axis_names)
    dp = tuple(a for a in names if a in ("pod", "data"))
    fsdp = dp if mode == "train" else ()
    return Axes(mesh=mesh, dp=dp, fsdp=fsdp)


# --------------------------------------------------------------- helpers ----
def _entry(e):
    """A spec entry as JAX's ``PartitionSpec`` stores it."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def spec_of(*entries) -> Spec:
    return tuple(_entry(e) for e in entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axsize(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def fit_spec(shape: Tuple[int, ...], spec: Spec, mesh) -> Spec:
    """Drop axes that do not evenly divide their dim (e.g. odd vocabs)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _axsize(mesh, entry)
        out.append(entry if (size > 1 and dim % size == 0) or size == 1
                   else None)
    return spec_of(*out)


def replicated(mesh) -> Spec:
    """The spec of a leaf held whole on every rank (JAX's ``P()``)."""
    return ()


def _is_shape_pair(t) -> bool:
    return isinstance(t, tuple) and len(t) == 2 \
        and isinstance(t[1], torch.dtype)


def _walk(tree, path, out):
    if torch.is_tensor(tree) or _is_shape_pair(tree):
        shape = tuple(tree.shape) if torch.is_tensor(tree) \
            else tuple(tree[0])
        out.append((path, shape))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (str(k),), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _walk(v, path + (str(i),), out)
    elif tree is not None:
        raise TypeError(f"{'/'.join(path)}: not a tensor or (shape, dtype)"
                        f" pair: {type(tree).__name__}")


def leaf_shapes(tree) -> Dict[str, Tuple[int, ...]]:
    """``{path: shape}`` of a tree of tensors or ``(shape, dtype)`` pairs,
    in the JAX flatten order."""
    out: list = []
    _walk(tree, (), out)
    return {"/".join(p): s for p, s in out}


# ---------------------------------------------------------- param rules -----
def _param_rule(names, ndim, ax: Axes, moe_ep: bool) -> Spec:
    n = set(names)
    last2 = names[-2:]
    f, m = ax.fsdp or None, ax.model

    # --- embeddings / heads ---
    if last2 == ("embed", "tok") or ("embed" in n and names[-1] == "tok"):
        return (m, f)
    if names[-1] == "pos" or names[-1] == "enc_pos":
        return (None, None)
    if "lm_head" in n:
        return (f, m) if names[-1] == "w" else (m,)
    if "patch_proj" in n:
        return (None, None) if names[-1] == "w" else ()

    # --- attention ---
    if any(a in n for a in ("attn", "self", "cross")):
        if names[-2] in ("q", "k", "v"):
            return (f, m) if names[-1] == "w" else (m,)
        if names[-2] == "o":
            return (m, f) if names[-1] == "w" else ()
        if names[-2] in ("q_norm", "k_norm"):
            return (None,)

    # --- MLP ---
    if "mlp" in n:
        if names[-2] in ("gate", "up"):
            return (f, m) if names[-1] == "w" else (m,)
        if names[-2] == "down":
            return (m, f) if names[-1] == "w" else ()

    # --- MoE ---
    if "moe" in n:
        if "router" in n:
            return (None, None)
        if names[-1] in ("gate", "up"):
            return (m, f, None) if moe_ep else (None, f, m)
        if names[-1] == "down":
            return (m, None, f) if moe_ep else (None, m, f)

    # --- Mamba ---
    if "mamba" in n:
        leaf, parent = names[-1], names[-2]
        if parent == "in_proj":
            return (f, m) if leaf == "w" else (m,)
        if leaf == "conv_w":
            return (None, m)
        if leaf == "conv_b":
            return (m,)
        if parent == "x_proj":
            return (m, None) if leaf == "w" else (None,)
        if parent == "dt_proj":
            return (None, m) if leaf == "w" else (m,)
        if leaf == "dt_bias":
            return (m,)
        if leaf == "A_log":
            return (m, None)
        if leaf == "D_skip":
            return (m,)
        if parent == "out_proj":
            return (m, f) if leaf == "w" else ()

    # --- RG-LRU ---
    if "rglru" in n:
        leaf, parent = names[-1], names[-2]
        if parent in ("in_x", "in_z"):
            return (f, m) if leaf == "w" else (m,)
        if leaf == "conv_w":
            return (None, m)
        if leaf == "conv_b":
            return (m,)
        if parent in ("gate_a", "gate_x"):
            return (None, m) if leaf == "w" else (m,)
        if leaf == "Lambda":
            return (m,)
        if parent == "out":
            return (m, f) if leaf == "w" else ()

    # norms and everything residual: replicate
    return (None,) * ndim


_STACKED_MARKERS = ("blocks", "encoder", "decoder")


def param_shardings(mesh, param_specs, mode: str = "train",
                    moe_ep: bool = False) -> Dict[str, Spec]:
    """A param tree (shapes) -> ``{path: spec}``."""
    ax = make_axes(mesh, mode)
    out = {}
    for path, shape in leaf_shapes(param_specs).items():
        names = tuple(path.split("/"))
        stacked = any(mk in names for mk in _STACKED_MARKERS) \
            and "tail" not in names
        ndim = len(shape) - (1 if stacked else 0)
        spec = _param_rule(names, ndim, ax, moe_ep)
        entries = list(spec)[:ndim] + [None] * (ndim - len(spec))
        if stacked:
            entries = [None] + entries
        out[path] = fit_spec(shape, entries, mesh)
    return out


# ----------------------------------------------------------- batch rules ----
def batch_shardings(mesh, batch_specs, mode: str = "train"
                    ) -> Dict[str, Spec]:
    ax = make_axes(mesh, mode)
    return {path: fit_spec(shape, (ax.dp,) + (None,) * (len(shape) - 1),
                           mesh)
            for path, shape in leaf_shapes(batch_specs).items()}


# ----------------------------------------------------------- cache rules ----
def cache_shardings(mesh, cache_specs, mode: str = "serve"
                    ) -> Dict[str, Spec]:
    """KV caches: batch over dp, *sequence* dim over "model" (seq-parallel
    decode). SSM/LRU states: feature dim over "model". Stacked leading dims
    (periods / layers) handled via path markers."""
    ax = make_axes(mesh, mode)
    m = ax.model
    out = {}
    for path, shape in leaf_shapes(cache_specs).items():
        names = tuple(path.split("/"))
        if names[-1] == "pos":
            out[path] = replicated(mesh)
            continue
        stacked = any(mk in names for mk in ("scanned", "self", "cross")) \
            and "tail" not in names
        base = 1 if stacked else 0
        entries = [None] * len(shape)
        if names[-1] in ("k", "v", "ck", "cv"):
            # (stack?, B, T, K, hd): batch over dp, seq over model
            entries[base + 0] = ax.dp
            entries[base + 1] = m
        elif names[-1] == "ssm":
            entries[base + 0] = ax.dp        # (B, Din, N)
            entries[base + 1] = m
        elif names[-1] == "h":
            entries[base + 0] = ax.dp        # (B, W)
            entries[base + 1] = m
        elif names[-1] == "conv":
            entries[base + 0] = ax.dp        # (B, cw-1, F)
            entries[base + 2] = m
        out[path] = fit_spec(shape, entries, mesh)
    return out


def opt_shardings(mesh, params_shardings: Dict[str, Spec]
                  ) -> Dict[str, Spec]:
    """AdamW state {"m","v","count"}: m/v mirror params, count
    replicated."""
    out = {f"m/{p}": s for p, s in params_shardings.items()}
    out.update({f"v/{p}": s for p, s in params_shardings.items()})
    out["count"] = replicated(mesh)
    return out


def state_shardings(mesh, params_shardings: Dict[str, Spec]
                    ) -> Dict[str, Spec]:
    """The train state {"params", "opt", "step"}'s specs (the reference
    test's ``shardings_for``)."""
    out = {f"params/{p}": s for p, s in params_shardings.items()}
    out.update({f"opt/{p}": s for p, s in
                opt_shardings(mesh, params_shardings).items()})
    out["step"] = replicated(mesh)
    return out


# ------------------------------------------------------- blocks of leaves ---
def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's block shape of a leaf of ``shape`` under ``spec``."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(d // _axsize(mesh, e) for d, e in zip(shape, entries))


def local_shard(t: torch.Tensor, spec: Spec, mesh,
                coords: Optional[dict] = None) -> torch.Tensor:
    """The block of the whole leaf ``t`` that the rank at ``coords`` (this
    rank's by default) holds under ``spec``: a view of ``t``."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = _axsize(mesh, entry)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split {n} ways ({spec})")
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.linear_index(axes, coords) * size, size)
    return t


def _spec_axes(spec: Spec) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in entry_axes(e))


def _assemble(blocks, members, spec, mesh, like):
    """The whole leaf from ``blocks``, the blocks of the ranks
    ``members``."""
    shape = tuple(d * _axsize(mesh, e) for d, e in
                  zip(like.shape, list(spec) + [None] * like.dim()))
    full = torch.empty(shape, dtype=like.dtype, device=blocks[0].device)
    for rank, block in zip(members, blocks):
        local_shard(full, spec, mesh, mesh.coords_of_rank(rank)).copy_(block)
    return full


def gather_blocks(t_local: torch.Tensor, spec: Spec, mesh, dst: int):
    """Every rank's block of a leaf under ``spec``, on the world rank
    ``dst`` (host tensors): ``(ranks, blocks)`` there, None elsewhere.
    Ranks that differ only along axes ``spec`` leaves out hold equal
    blocks, so the group along the spec's axes that holds ``dst`` sends
    them."""
    axes = _spec_axes(spec)
    if not axes:
        return ((dst,), [t_local.detach().to("cpu", copy=True)]) \
            if dist.get_rank() == dst else None
    members = mesh.members(axes)
    if dst not in members:
        return None
    blocks = coll.gather_to(t_local, axes, mesh, dst)
    return None if blocks is None else (members, blocks)


def gather(t_local: torch.Tensor, spec: Spec, mesh,
           dst: Optional[int] = None) -> Optional[torch.Tensor]:
    """The whole leaf rebuilt from every rank's block under ``spec``: on
    every rank (``dst`` None, on ``t_local``'s device), or on the world
    rank ``dst`` alone (a new host tensor; None elsewhere)."""
    axes = _spec_axes(spec)
    if dst is not None:
        got = gather_blocks(t_local, spec, mesh, dst)
        if got is None:
            return None
        ranks, blocks = got
        return _assemble(blocks, ranks, spec, mesh, t_local) if axes \
            else blocks[0]
    if not axes:
        return t_local
    blocks = coll.all_gather(t_local, axes, mesh)
    return _assemble(blocks, mesh.members(axes), spec, mesh, t_local)
