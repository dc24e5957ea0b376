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
the weight of the MoE load-balance loss in ``Model.loss``. The
reference's expert-parallel ``"a2a"`` dispatch and its ``mesh`` wait for
the sharding slice and raise here. ``remat``, ``seq_parallel`` and
``cost_mode`` arrive with the slices that read them (sharding, the
roofline).
"""
from __future__ import annotations

import dataclasses
from typing import Any, FrozenSet

_SHARDING = "waits for the sharding slice of the port"


@dataclasses.dataclass(frozen=True)
class Runtime:
    attention_impl: str = "cuda"         # cuda | xla
    taps: FrozenSet[str] = frozenset()   # {"commits", "coverage", "router"}
    moe_impl: str = "sort"               # sort | dense
    aux_loss_coef: float = 0.01          # MoE load-balance loss weight
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
