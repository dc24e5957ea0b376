"""Runtime (non-architectural) knobs of the port.

Fields ported so far: ``taps``, the P-Shell tap points that
``transformer.block_apply`` fills ("commits": per-layer activation
checksums; "coverage": per-layer nan/inf bits and, for MoE layers, the
expert toggles; "router": the full router stats of MoE layers);
``moe_impl``, the MoE dispatch ("sort": capacity-based sort dispatch
through the K5 wrapper; "dense": the all-experts oracle in plain torch);
and ``aux_loss_coef``, the weight of the MoE load-balance loss in
``Model.loss``. The reference's ``attention_impl`` has no counterpart:
the port has one attention path, the K1 wrapper (the CUDA kernel on the
card, its plain version on host tensors). The reference's expert-parallel
``"a2a"`` dispatch and its ``mesh`` wait for the sharding slice and raise
here. ``remat``, ``seq_parallel`` and ``cost_mode`` arrive with the
slices that read them (training, sharding, the roofline).
"""
from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet

_SHARDING = "waits for the sharding slice of the port"


@dataclasses.dataclass(frozen=True)
class Runtime:
    taps: FrozenSet[str] = frozenset()   # {"commits", "coverage", "router"}
    moe_impl: str = "sort"               # sort | dense
    aux_loss_coef: float = 0.01          # MoE load-balance loss weight
    mesh: Any = None

    def __post_init__(self):
        if self.moe_impl == "a2a":
            raise NotImplementedError(
                f"moe_impl 'a2a' (expert parallelism over a mesh) {_SHARDING}")
        if self.moe_impl not in ("sort", "dense"):
            raise ValueError(f"unknown moe impl {self.moe_impl!r}")
        if self.mesh is not None:
            raise NotImplementedError(f"a device mesh {_SHARDING}")
