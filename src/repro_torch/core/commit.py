"""Commit-stream definitions: how the model's ``aux`` feeds the P-Shell.

Per-layer activation checksums are the architectural commit records (the
analogue of the commit records a co-emulator compares against its golden
model); MoE router toggles and nan bits are the coverage coverpoints.
Everything here is a pure tensor op on the device: no host sync, no
data-dependent shape, FIFO overflow resolved with credit arithmetic.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.pshell import (FifoSpec, ShellConfig, csr_accum,
                                     csr_write, fifo_push_many)


def _per_layer(aux: Dict[str, Any], key: str):
    """Collect per-layer leaves named ``key`` in layer order (period-major
    over the scanned positions, then the tail). Returns an (L_present,
    ...) tensor or None."""
    rows = []
    scanned = aux.get("scanned", ())
    if scanned:
        present = [pos[key] for pos in scanned if key in pos]
        if present:
            # (n_periods, P_len_present, ...) -> interleave period-major
            stk = torch.stack(present, dim=1)
            rows.append(stk.reshape((-1,) + tuple(stk.shape[2:])))
    for blk in aux.get("tail", ()):
        if key in blk:
            rows.append(blk[key][None])
    if not rows:
        return None
    return torch.cat(rows, dim=0)


def layer_checksums(aux) -> torch.Tensor:
    """(L, 2) f32 commit checksums in layer order."""
    out = _per_layer(aux, "checksum")
    if out is None:
        raise ValueError("no 'checksum' taps in aux — enable 'commits' tap")
    return out


def moe_toggles(aux):
    """(n_moe_layers, E) router toggles, or None (always for the families
    without MoE blocks, which emit no "moe" tap). The scanned pattern
    positions come first, each with its periods in order, then the
    tail, as in the reference."""
    rows = []
    for pos in aux.get("scanned", ()):
        if "moe" in pos and "expert_toggles" in pos["moe"]:
            t = pos["moe"]["expert_toggles"]
            rows.append(t.reshape((-1,) + tuple(t.shape[2:]))
                        if t.dim() > 2 else t)
    for blk in aux.get("tail", ()):
        if "moe" in blk and "expert_toggles" in blk["moe"]:
            rows.append(blk["moe"]["expert_toggles"][None])
    if not rows:
        return None
    return torch.cat(rows, dim=0)


def nan_bits(aux):
    return _per_layer(aux, "nan_bit")


def default_shell_config(cfg, sample_interval: int = 1,
                         commit_depth: int | None = None) -> ShellConfig:
    """Parameterize the shell for one architecture.

    FIFO depths are sized per group: each fused window ingests
    ``sample_interval`` steps before the host drains, and every step pushes
    L commit rows, so the commits FIFO must hold >= sample_interval * L
    entries for lossless capture (interval=1 == cycle-accurate). Undersize
    it (``commit_depth``) and overflow is dropped deterministically with
    exact credit accounting, never blocking the device. A config with
    experts also gets the (n_moe, E) ``expert_toggles`` CSR and the
    ``router`` FIFO ([layer, aux_loss, dropped_frac] rows). As in the
    reference, nothing pushes the router FIFO yet: it is declared and
    drains empty."""
    L = cfg.num_layers + cfg.encoder_layers
    depth = commit_depth or max(4, sample_interval) * max(L, 1)
    csrs = {
        "steps": ((), torch.int32),
        "loss_last": ((), torch.float32),
        "nan_bits": ((max(L, 1),), torch.int32),
    }
    fifos = {
        # payload: [layer_id, mean, abs_mean]
        "commits": FifoSpec(depth=depth, shape=(3,), dtype=torch.float32),
    }
    if cfg.num_experts:
        n_moe = sum(1 for _, f in cfg.layer_specs if f == "moe")
        csrs["expert_toggles"] = ((n_moe, cfg.num_experts), torch.int32)
        fifos["router"] = FifoSpec(
            depth=max(4, sample_interval) * max(n_moe, 1), shape=(3,),
            dtype=torch.float32)  # [layer, aux_loss, dropped_frac]
    return ShellConfig(csrs=csrs, fifos=fifos,
                       sample_interval=sample_interval)


def make_ingest(cfg):
    """ingest(shell, aux, metrics) -> shell. Pure and shape-static, with
    no host sync, so it can run inside a window."""
    def ingest(shell, aux, metrics):
        cks = layer_checksums(aux)                        # (L, 2)
        L = cks.shape[0]
        payload = torch.cat(
            [torch.arange(L, dtype=torch.float32, device=cks.device)[:, None],
             cks.float()], dim=1)
        shell = fifo_push_many(shell, "commits", payload)
        nb = nan_bits(aux)
        if nb is not None:
            pad = shell["csr"]["nan_bits"].shape[0] - nb.shape[0]
            shell = csr_accum(shell, "nan_bits",
                              F.pad(nb.to(torch.int32), (0, pad)), op="or")
        tg = moe_toggles(aux)
        if tg is not None and "expert_toggles" in shell["csr"]:
            shell = csr_accum(shell, "expert_toggles", tg.to(torch.int32),
                              op="or")
        if "loss" in metrics:
            shell = csr_write(shell, "loss_last", metrics["loss"].float())
        return csr_accum(shell, "steps", 1, op="add")

    return ingest
