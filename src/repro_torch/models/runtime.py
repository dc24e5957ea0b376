"""Runtime (non-architectural) knobs of the port.

This slice ports the one field it reads: ``taps``, the P-Shell tap points
that ``transformer.block_apply`` fills ("commits": per-layer activation
checksums; "coverage": per-layer nan/inf bits). The reference's
``attention_impl`` has no counterpart: the port has one attention path,
the K1 wrapper (the CUDA kernel on the card, its plain version on host
tensors). ``moe_impl``, ``mesh``, ``remat``, ``aux_loss_coef``,
``seq_parallel`` and ``cost_mode`` arrive with the slices that read them
(MoE, sharding, training, the roofline).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet


@dataclasses.dataclass(frozen=True)
class Runtime:
    taps: FrozenSet[str] = frozenset()   # {"commits", "coverage"}
