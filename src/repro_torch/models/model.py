"""Model facade of the port: the dense decoder family's serve path.

``build_model(cfg)`` returns a Model with:
  init(seed, device) -> params
  cache_spec(batch, max_len) -> (shape, dtype) tree
  prefill(params, batch, max_len) -> (cache, last_logits)
  decode_step(params, cache, tokens1) -> (cache, logits)   [serve_step]

Other families (moe, ssm, hybrid, encdec, vlm) and the train path
(``logits`` / ``loss``) arrive with later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_apply, logits_apply, norm_apply
from repro_torch.utils import resolve_device


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (a later slice "
                "of the port); this slice serves the dense family")
        self.cfg = cfg

    # ----------------------------------------------------------- params ---
    def init(self, seed: int = 0, *, device=None):
        """Random params drawn on ``device`` from a generator seeded with
        ``seed``. They do not equal the JAX package's draw for the same
        seed: carry weights across with ``repro_torch.interop``."""
        device = resolve_device(device)
        g = None if device.type == "meta" \
            else torch.Generator(device=device).manual_seed(seed)
        return tfm.init_lm(g, self.cfg, device)

    # ------------------------------------------------------------ serve ---
    def cache_spec(self, batch: int, max_len: int):
        return tfm.stack_cache_spec(self.cfg, batch, max_len)

    def prefill(self, params, batch, max_len: int):
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x = embed_apply(params["embed"], tokens,
                        positions if cfg.learned_pos else None)
        x, cache = tfm.stack_prefill(params["stack"], cfg, x, positions,
                                     max_len)
        x = norm_apply(cfg, params["final_norm"], x)
        return cache, logits_apply(params, cfg, x[:, -1:])

    def decode_step(self, params, cache, tokens1):
        """serve_step: one new token against the standing cache, which is
        updated in place."""
        cfg = self.cfg
        pos = cache["pos"]
        B = tokens1.shape[0]
        x = embed_apply(params["embed"], tokens1,
                        pos.reshape(1, 1).expand(B, 1)
                        if cfg.learned_pos else None)
        x, cache = tfm.stack_decode(params["stack"], cfg, x, cache)
        x = norm_apply(cfg, params["final_norm"], x)
        return cache, logits_apply(params, cfg, x)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
