"""Carry weights across between the JAX package and the port.

The JAX parameter pytree, as numpy arrays (``jax.tree.map(np.asarray,
params)``), becomes the port's parameter tree leaf by leaf: same
``{"blocks": tuple, "tail": list}`` layout, same stacked leading period
axis, same dtypes. bf16 leaves cross through f32 numpy, which is exact.
Re-initialising from the same seed cannot match the reference's draw, so
weights are carried across, never re-derived. ``state_from_jax`` carries a
whole train state (params, AdamW moments and counts, and the EF residuals
where present) the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import build_model
from repro_torch.utils import resolve_device, tree_map

_NP_TO_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32}


def _to_torch(a, like: torch.Tensor, device, path: str) -> torch.Tensor:
    a = np.asarray(a)
    dt = _NP_TO_TORCH.get(a.dtype.name)
    if dt != like.dtype or tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{path}: got {a.dtype.name}{list(a.shape)}, the "
                         f"port expects {like.dtype}{list(like.shape)}")
    if dt == torch.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)
    return torch.from_numpy(np.array(a)).to(device)   # own, writable


def _walk(np_tree, like, device, path):
    if isinstance(like, dict):
        if not isinstance(np_tree, dict) or set(np_tree) != set(like):
            raise ValueError(f"{path}: keys {sorted(np_tree)} != "
                             f"{sorted(like)}")
        return {k: _walk(np_tree[k], like[k], device, f"{path}/{k}")
                for k in like}
    if isinstance(like, (tuple, list)):
        if len(np_tree) != len(like):
            raise ValueError(f"{path}: {len(np_tree)} entries, the port "
                             f"expects {len(like)}")
        return type(like)(_walk(a, b, device, f"{path}[{i}]")
                          for i, (a, b) in enumerate(zip(np_tree, like)))
    return _to_torch(np_tree, like, device, path)


def params_from_jax(np_tree, cfg, device=None):
    """The port's params from the JAX package's params as numpy arrays.
    Structure, shapes and dtypes are checked against the port's layout."""
    device = resolve_device(device)
    like = build_model(cfg).init(device="meta")
    return _walk(np_tree, like, device, "params")


def params_to_numpy(tree):
    """numpy arrays of the port's params, in the same layout; bf16 leaves
    come back as f32 (exact), so a round trip compares bitwise."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)


def state_from_jax(np_state, cfg, device=None):
    """The port's train state from the JAX package's (``init_state`` /
    a train step's output) as numpy arrays: ``{"params", "opt": {"m", "v",
    "count"}, "step"}`` and ``"ef"`` where present, each leaf checked
    against the port's layout (moments and residuals f32, counts 0-d
    int32)."""
    device = resolve_device(device)
    like = build_model(cfg).init(device="meta")
    f32 = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32,
                                         device="meta"), like)
    count = torch.empty((), dtype=torch.int32, device="meta")
    state = {
        "params": _walk(np_state["params"], like, device, "params"),
        "opt": {"m": _walk(np_state["opt"]["m"], f32, device, "opt/m"),
                "v": _walk(np_state["opt"]["v"], f32, device, "opt/v"),
                "count": _to_torch(np_state["opt"]["count"], count, device,
                                   "opt/count")},
        "step": _to_torch(np_state["step"], count, device, "step"),
    }
    if "ef" in np_state:
        state["ef"] = _walk(np_state["ef"], f32, device, "ef")
    return state
