"""AdamW, implemented directly: f32 moments over working-dtype params.

Mixed-precision policy, as in the reference: params stored in the model
dtype (bf16), moments in f32, the update in f32, cast back. Warmup, a
global-norm clip, and decoupled weight decay on leaves of ndim >= 2 only.

The step count, the learning rate and the clip scale stay 0-d tensors on
the params' device, so a step reads nothing back to the host and a CUDA
graph can hold it. ``adamw_update`` is pure by default; ``inplace=True``
(the train step) writes params and moments into their own storage, which
a graph replay then updates.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _schedule(cfg: OptConfig, count):
    """The learning rate of the step after ``count`` steps (linear warmup),
    a 0-d f32 tensor."""
    warm = torch.clamp((count + 1) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in f32 (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def adamw_update(cfg: OptConfig, params, grads, opt, inplace: bool = False):
    """One AdamW step: returns (params, opt, {"grad_norm", "lr"}). With
    ``inplace`` the returned trees are ``params`` and ``opt``'s own
    tensors, written in place; without, the inputs are left untouched."""
    count = opt["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    lr = _schedule(cfg, opt["count"])
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * pf
        p_new = (pf - lr * step).to(p.dtype)
        if not inplace:
            return p_new, m_new, v_new
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    res = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt["m"]),
        tree_leaves(opt["v"]))]
    if inplace:
        opt["count"].copy_(count)
        count = opt["count"]
    new_opt = {"m": tree_unflatten(params, [r[1] for r in res]),
               "v": tree_unflatten(params, [r[2] for r in res]),
               "count": count}
    return (tree_unflatten(params, [r[0] for r in res]), new_opt,
            {"grad_norm": gnorm, "lr": lr})
