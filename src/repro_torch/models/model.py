"""Model facade of the port: the dense decoder, Mamba-1 SSM, RG-LRU hybrid
and MoE decoder families.

``build_model(cfg, rt)`` returns a Model with:
  init(seed, device) -> params
  logits(params, batch) -> (logits, aux)           [commit-tapped forward]
  loss(params, batch) -> (scalar, (metrics, aux))  [the train objective]
  cache_spec(batch, max_len) -> (shape, dtype) tree
  prefill(params, batch, max_len) -> (cache, last_logits)
  decode_step(params, cache, tokens1) -> (cache, logits)   [serve_step]

``aux`` carries the P-Shell taps that ``rt.taps`` asks for, and each MoE
layer's load-balance loss. ``loss`` is differentiable under
``rt.attention_impl="xla"`` (the train step, ``repro_torch.train``); the
other families (encdec, vlm) come with later slices of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_apply, logits_apply, norm_apply
from repro_torch.models.runtime import Runtime
from repro_torch.utils import resolve_device


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B,T,V) f32; labels (B,T) int -> mean NLL."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()


def _collect_moe_aux(aux, device) -> torch.Tensor:
    """The mean over MoE blocks (each pattern position's stacked losses
    averaged first) of their load-balance losses; a 0-d f32 zero where
    there is none."""
    vals = [blk["moe_aux_loss"].mean()
            for part in ("scanned", "tail") for blk in aux.get(part, ())
            if "moe_aux_loss" in blk]
    if not vals:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(vals).mean()


def _on_device(batch, params):
    """The batch as tensors on the params' device. Tensors stay where they
    are; host arrays go to the card (``resolve_device``, which raises
    without one), so only tensors already on the CPU run on the host."""
    out = {k: v if torch.is_tensor(v)
           else torch.from_numpy(v).to(resolve_device())
           for k, v in batch.items()}
    dev = params["embed"]["tok"].device
    for k, v in out.items():
        if v.device != dev:
            raise ValueError(f"batch[{k!r}] is on {v.device}, the params "
                             f"on {dev}")
    return out


class Model:
    def __init__(self, cfg: ModelConfig, rt: Runtime = Runtime()):
        if cfg.family not in ("dense", "ssm", "hybrid", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (a later slice "
                "of the port); the dense, ssm, hybrid and moe families "
                "are ported")
        self.cfg = cfg
        self.rt = rt

    # ----------------------------------------------------------- params ---
    def init(self, seed: int = 0, *, device=None):
        """Random params drawn on ``device`` from a generator seeded with
        ``seed``. They do not equal the JAX package's draw for the same
        seed: carry weights across with ``repro_torch.interop``."""
        device = resolve_device(device)
        g = None if device.type == "meta" \
            else torch.Generator(device=device).manual_seed(seed)
        return tfm.init_lm(g, self.cfg, device)

    # ---------------------------------------------------------- forward ---
    def logits(self, params, batch):
        """Commit-tapped forward: f32 logits (B,S,V) and the aux tree."""
        batch = _on_device(batch, params)
        return tfm.lm_logits(params, self.cfg, batch["tokens"], self.rt)

    def loss(self, params, batch):
        """Mean next-token cross-entropy plus ``rt.aux_loss_coef`` times
        the MoE load-balance loss (``moe_aux``, a 0-d f32 zero for the
        families without MoE layers)."""
        batch = _on_device(batch, params)
        logits, aux = self.logits(params, batch)
        ce = cross_entropy(logits, batch["labels"])
        moe_aux = _collect_moe_aux(aux, ce.device)
        loss = ce + self.rt.aux_loss_coef * moe_aux
        metrics = {"loss": loss, "ce": ce, "moe_aux": moe_aux}
        return loss, (metrics, aux)

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
                                     max_len, self.rt)
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
        x, cache = tfm.stack_decode(params["stack"], cfg, x, cache, self.rt)
        x = norm_apply(cfg, params["final_norm"], x)
        return cache, logits_apply(params, cfg, x)


def build_model(cfg: ModelConfig, rt: Runtime = Runtime()) -> Model:
    return Model(cfg, rt)
