"""Scale-Down decomposition: extract any block with its exact interface,
capture real boundary traffic from an in-situ run, replay the extracted
block standalone, and verify bit-identity.

This is the paper's central claim made executable: a subsystem prototyped
behind a preserved interface behaves exactly as in situ (strict
non-interference of the DUT). On the card the replay runs the same
kernels on the same inputs as the in-situ run, so it must reproduce it
bit for bit.

Blocks come from a decoder-only layer stack (``params["stack"]``), the
dense, SSM, hybrid, MoE and VLM families; an enc-dec model has none, and
every entry point raises ValueError for it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.runtime import Runtime
from repro_torch.utils import dtype_of, tree_map


def _decoder_stack(params, cfg):
    """The decoder-only layer stack. An enc-dec model has none: the
    reference reads ``params["stack"]`` and fails with a KeyError; the
    port names the family."""
    if cfg.family == "encdec":
        raise ValueError(
            f"Scale-Down extracts blocks of a decoder-only layer stack; "
            f"{cfg.name!r} is of the encdec family (encoder and decoder "
            f"stacks, no params['stack']), which the reference's "
            f"decomposition does not reach either")
    return params["stack"]


def iter_layer_params(params, cfg):
    """Yield (layer_idx, spec, per-layer param tree) from the stacked stack,
    in period-major layer order. The trees are views, not copies. An
    enc-dec config raises ValueError."""
    stack = _decoder_stack(params, cfg)
    P_len = len(cfg.layer_pattern)
    n_periods = cfg.num_layers // P_len
    for period in range(n_periods):
        for pos in range(P_len):
            tree = tree_map(lambda a: a[period], stack["blocks"][pos])
            yield period * P_len + pos, cfg.layer_pattern[pos], tree
    for i, tree in enumerate(stack["tail"]):
        yield n_periods * P_len + i, cfg.layer_pattern[i % P_len], tree


@dataclasses.dataclass
class Subsystem:
    """An extracted block: a pure fn, its interface as (shape, dtype)
    pairs, and its own param slice, which ``fn`` closes over."""
    name: str
    layer_idx: int
    spec: Tuple[str, Optional[str]]
    fn: Callable          # (x, positions) -> x'
    input_specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    params: Any = None


def _block_subsystem(layer_idx: int, spec, tree, cfg, rt: Runtime,
                     batch: int, seq: int) -> Subsystem:
    def fn(x, positions):
        y, _ = tfm.block_apply(tree, cfg, spec, x, positions, rt)
        return y

    specs = {
        "x": ((batch, seq, cfg.d_model), dtype_of(cfg.dtype)),
        "positions": ((batch, seq), torch.int32),
    }
    return Subsystem(name=f"layer{layer_idx}:{spec[0]}+{spec[1]}",
                     layer_idx=layer_idx, spec=spec, fn=fn,
                     input_specs=specs, params=tree)


def extract_blocks(params, cfg, layer_idxs, rt: Runtime,
                   batch: int, seq: int) -> Dict[int, Subsystem]:
    """One walk over ``iter_layer_params`` takes exactly the requested
    layers' param slices."""
    want = set(layer_idxs)
    bad = sorted(li for li in want if not 0 <= li < cfg.num_layers)
    if bad:
        raise ValueError(
            f"layer_idx {bad[0]} out of range for arch {cfg.name!r}: "
            f"{cfg.num_layers} decoder layers (valid: 0.."
            f"{cfg.num_layers - 1})")
    out = {}
    for idx, spec, tree in iter_layer_params(params, cfg):
        if idx in want:
            out[idx] = _block_subsystem(idx, spec, tree, cfg, rt,
                                        batch, seq)
            if len(out) == len(want):
                break
    return out


def extract_block(params, cfg, layer_idx: int, rt: Runtime,
                  batch: int, seq: int) -> Subsystem:
    return extract_blocks(params, cfg, [layer_idx], rt,
                          batch, seq)[layer_idx]


def unrolled_capture(params, cfg, x, positions, rt: Runtime):
    """In-situ run with boundary capture: returns (x, records) with the
    (x_in, x_out) of every block boundary. Consecutive records share one
    tensor (a block's x_out is the next one's x_in), so the capture holds
    one activation per layer."""
    records = []
    for idx, spec, tree in iter_layer_params(params, cfg):
        x_in = x
        x, _ = tfm.block_apply(tree, cfg, spec, x, positions, rt)
        records.append({"layer": idx, "x_in": x_in, "x_out": x})
    return x, records


def verify_extraction(params, cfg, batch_x, positions, rt: Runtime,
                      layer_idx: int) -> Dict[str, Any]:
    """Capture in-situ traffic, replay the extracted block standalone, and
    report whether the replay equals the in-situ record bit for bit (the
    non-interference contract)."""
    _, records = unrolled_capture(params, cfg, batch_x, positions, rt)
    rec = records[layer_idx]
    sub = extract_block(params, cfg, layer_idx, rt,
                        batch_x.shape[0], batch_x.shape[1])
    replay = sub.fn(rec["x_in"], positions)
    bitwise = torch.equal(replay, rec["x_out"])
    max_abs = float((replay.float() - rec["x_out"].float()).abs().max())
    return {"subsystem": sub.name, "bitwise_identical": bool(bitwise),
            "max_abs_diff": max_abs}


def scanned_vs_unrolled(params, cfg, x, positions, rt: Runtime) -> float:
    """The production forward (periods of stacked params) against the
    unrolled composition of extracted blocks: max relative difference."""
    x_scan, _ = tfm.stack_apply(_decoder_stack(params, cfg), cfg, x,
                                positions, rt)
    x_unroll, _ = unrolled_capture(params, cfg, x, positions, rt)
    a, b = x_scan.float(), x_unroll.float()
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))
