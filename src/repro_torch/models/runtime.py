"""Runtime (non-architectural) knobs of the port.

Fields ported so far: ``attention_impl``, the implementation of every
place the reference's ``impl`` reaches ("cuda": the hand-written kernels
K1 to K5 on the card, each wrapper's plain version on host tensors, the
default, which serve, the forward and Scale-Down run; "xla": the
counterpart of the reference's plain ``impl="xla"`` code, which is
differentiable and which the train step runs, as the reference's does:
plain attention, the chunked RG-LRU and Mamba scans, the expert FFN as
three einsums); ``taps``, the P-Shell tap points that
``transformer.block_apply`` fills ("commits": per-layer activation
checksums; "coverage": per-layer nan/inf bits and, for MoE layers, the
expert toggles; "router": the full router stats of MoE layers);
``moe_impl``, the MoE dispatch ("sort": capacity-based sort dispatch;
"dense": the all-experts oracle in plain torch); and ``aux_loss_coef``,
the weight of the MoE load-balance loss in ``Model.loss``; and ``remat``,
what each period of the layer stack keeps for the backward
(``checkpoint``): "none" keeps everything; "full" keeps the period's
inputs and recomputes the rest in the backward; "dots" keeps the outputs
of the products without batch dimensions (the weight projections,
``aten.mm`` / ``aten.addmm``) and recomputes the rest, batched products
(``aten.bmm``: attention scores, the grouped expert product) included, as
the reference's ``checkpoint_dots_with_no_batch_dims`` does. torch's
einsum runs a product without batch dimensions as a ``bmm`` of batch 1,
so the one such einsum of the port, the all-experts "dense" MoE oracle,
is recomputed where the reference keeps it. Remat changes no value: a
recompute runs the same operations on the same inputs. The
reference's expert-parallel ``"a2a"`` dispatch and its ``mesh`` wait for
the sharding slice and raise here. ``seq_parallel`` and ``cost_mode``
arrive with the sharding slice (``cost_mode`` feeds the roofline's
composer, ``roofline/compose.py``, which comes with it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, FrozenSet

import torch

_SHARDING = "waits for the sharding slice of the port"
_REMAT = ("none", "dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs
    of the products without batch dimensions, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@dataclasses.dataclass(frozen=True)
class Runtime:
    attention_impl: str = "cuda"         # cuda | xla
    taps: FrozenSet[str] = frozenset()   # {"commits", "coverage", "router"}
    moe_impl: str = "sort"               # sort | dense
    aux_loss_coef: float = 0.01          # MoE load-balance loss weight
    remat: str = "none"                  # none | dots | full
    mesh: Any = None

    def __post_init__(self):
        if self.attention_impl not in ("cuda", "xla"):
            raise ValueError(
                f"unknown attention impl {self.attention_impl!r}")
        if self.moe_impl == "a2a":
            raise NotImplementedError(
                f"moe_impl 'a2a' (expert parallelism over a mesh) {_SHARDING}")
        if self.moe_impl not in ("sort", "dense"):
            raise ValueError(f"unknown moe impl {self.moe_impl!r}")
        if self.mesh is not None:
            raise NotImplementedError(f"a device mesh {_SHARDING}")
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat {self.remat!r}; one of "
                             f"{_REMAT}")

    def checkpoint(self, fn):
        """``fn`` under this runtime's remat: as it is for "none"; else
        through non-reentrant ``torch.utils.checkpoint`` ("dots" with the
        selective policy above). Where grad mode is off (prefill, decode,
        the forward under inference mode) nothing is saved, and ``fn``
        runs as it is. No RNG state is stashed: no model op draws random
        numbers, and a stash would read the generator inside a CUDA-graph
        capture."""
        if self.remat == "none":
            return fn
        from torch.utils.checkpoint import (
            checkpoint, create_selective_checkpoint_contexts)
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)

        @functools.wraps(fn)
        def run(*args):
            if not torch.is_grad_enabled():
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        return run

    def with_(self, **kw) -> "Runtime":
        return dataclasses.replace(self, **kw)
