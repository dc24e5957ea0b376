"""Config dataclasses for the repro framework.

A ModelConfig fully describes one architecture from the assigned pool.
A ShapeConfig describes one (seq_len, global_batch, kind) workload cell.

Layer heterogeneity (hybrid archs) is expressed with ``layer_pattern``:
a tuple of (mixer, ffn) pairs repeated cyclically over ``num_layers``.
Mixer kinds: "attn" (full/causal), "swa" (sliding window), "local"
(local attention, hybrid archs), "rglru" (RecurrentGemma RG-LRU),
"mamba" (Mamba-1 selective scan). FFN kinds: "mlp" (GLU), "moe", None.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

LayerSpec = Tuple[str, Optional[str]]  # (mixer_kind, ffn_kind)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[LayerSpec, ...] = (("attn", "mlp"),)

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    # --- attention ---
    window: int = 0  # sliding/local attention window (0 = full)
    rope_theta: float = 10000.0
    use_rope: bool = True
    use_qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    learned_pos: bool = False  # whisper-style learned positions
    max_position: int = 0      # for learned positions

    # --- SSM (mamba) ---
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0

    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # frame-embedding length from the (stubbed) frontend

    # --- VLM ---
    num_patches: int = 0
    patch_embed_dim: int = 0  # frontend output dim before projection

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_bias: bool = False
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "ssm" and self.d_inner == 0:
            object.__setattr__(self, "d_inner", 2 * self.d_model)
        if self.family == "ssm" and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", math.ceil(self.d_model / 16))

    # ------------------------------------------------------------------
    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Per-layer (mixer, ffn) for all num_layers layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer needs an unbounded-in-seq KV cache."""
        for mixer, _ in self.layer_specs:
            if mixer == "attn":
                return False
        if self.encoder_layers:  # enc-dec decoder is full attention
            return False
        return True

    @property
    def cache_window(self) -> int:
        """Max per-layer attention cache length for decode (0 = unbounded)."""
        w = 0
        for mixer, _ in self.layer_specs:
            if mixer == "attn":
                return 0
            if mixer in ("swa", "local"):
                w = max(w, self.window)
        return w

    # --- parameter counting (analytic; used by the roofline engine) -----
    def param_count(self, active_only: bool = False) -> int:
        D, V = self.d_model, self.vocab_size
        total = V * D  # token embedding
        if not self.tie_embeddings:
            total += D * V  # lm head
        if self.learned_pos and self.max_position:
            total += self.max_position * D
        if self.num_patches:
            total += self.patch_embed_dim * D  # patch projection
        total += D  # final norm

        def attn_params() -> int:
            q = D * self.num_heads * self.head_dim
            kv = 2 * D * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * D
            return q + kv + o + D  # + pre-norm

        def mlp_params(ff: int) -> int:
            return 3 * D * ff + D  # GLU (gate,up,down) + pre-norm

        def moe_params(active: bool) -> int:
            e = self.num_experts_per_tok if active else self.num_experts
            return e * 3 * D * self.moe_d_ff + D * self.num_experts + D

        def rglru_params() -> int:
            W = self.lru_width or D
            # in/out proj (x2 branches), conv, lru gates
            return 2 * D * W + W * D + self.conv_width * W + 2 * W * W + 3 * W + D

        def mamba_params() -> int:
            Din, N, R = self.d_inner, self.ssm_state, self.dt_rank
            total = 2 * D * Din          # in_proj (x and z branches)
            total += self.conv_width * Din
            total += Din * (R + 2 * N)   # x -> dt_rank, B, C
            total += R * Din             # dt proj
            total += Din * N + Din       # A_log, D skip
            total += Din * D             # out proj
            return total + D

        for mixer, ffn in self.layer_specs:
            if mixer in ("attn", "swa", "local"):
                total += attn_params()
            elif mixer == "rglru":
                total += rglru_params()
            elif mixer == "mamba":
                total += mamba_params()
            if ffn == "mlp":
                total += mlp_params(self.d_ff)
            elif ffn == "moe":
                total += moe_params(active_only)

        if self.encoder_layers:
            # encoder self-attn+mlp, decoder cross-attn (decoder blocks counted above)
            total += self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * attn_params()  # cross attention
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) per the assignment's sub-quadratic rule."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, (
            f"{cfg.name} has full (unbounded) attention; long_500k requires "
            "sub-quadratic attention per the assignment. Skipped (DESIGN.md §4)."
        )
    return True, ""
