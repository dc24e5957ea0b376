"""GPipe-style pipeline parallelism over a "pipe" axis of a mesh of ranks.

Layer periods are split contiguously across stages (the stacked period dim
of the block params is sharded over "pipe": ``pp_specs``); microbatches
stream through a fill-drain schedule of T = n_micro + n_stages - 1 ticks,
each rank one stage, activations passed on by ``ppermute``. As the
reference's ``lax.scan`` does, every tick computes on every stage and
masks the inactive ones, so every rank runs the same operations and the
same collectives in the same order, forward and backward. The last
stage's outputs reach every stage by a masked ``psum``. The collectives'
backwards are JAX's transposes (``sharding/collectives.py``), and the
stage function's boundary transposes as ``shard_map``'s: the cotangent of
the replicated input is summed over the stages, that of the replicated
output shared among them. So ``loss.backward()`` on every rank leaves each
stage the gradients of its blocks and every rank the whole gradients of
the replicated embedding, norm and head.

Restrictions (checked): homogeneous layer pattern, num_layers divisible by
n_stages, embed/head replicated across stages (computed outside the loop).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed_apply, logits_apply, norm_apply
from repro_torch.models.model import cross_entropy
from repro_torch.models.runtime import Runtime
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.rules import leaf_shapes
from repro_torch.utils import tree_leaves


def _check(cfg, n_stages: int):
    if len(cfg.layer_pattern) != 1:
        raise ValueError("PP requires a homogeneous layer pattern")
    if cfg.num_layers % n_stages:
        raise ValueError("num_layers must divide by n_stages")


def pp_specs(params, pipe_axis: str = "pipe"):
    """{path: spec} of a whole param tree under the pipeline: the stacked
    period dim of ``stack/blocks`` over ``pipe_axis``, the rest whole."""
    return {path: (pipe_axis,) + (None,) * (len(shape) - 1)
            if path.startswith("stack/blocks/") else ()
            for path, shape in leaf_shapes(params).items()}


def make_pp_loss(cfg, mesh, n_stages: int, n_micro: int,
                 pipe_axis: str = "pipe", rt: Runtime = None):
    """Returns loss_fn(params, batch) running the stack as a GPipe
    pipeline on this rank's stage. ``params`` is this rank's block of
    the param tree under ``pp_specs``: stage s holds periods
    [s*L/S, (s+1)*L/S) of the stack and the whole embedding, final norm
    and head. The loss is equal on every rank."""
    _check(cfg, n_stages)
    if mesh.shape[pipe_axis] != n_stages:
        raise ValueError(f"{n_stages} stages on a {pipe_axis!r} axis of "
                         f"{mesh.shape[pipe_axis]}")
    rt = rt or Runtime(attention_impl="xla")
    spec = cfg.layer_pattern[0]
    perm = [(i, i + 1) for i in range(n_stages - 1)]

    def stage_fn(blocks_stage, x, positions):
        for i in range(tree_leaves(blocks_stage)[0].shape[0]):
            x, _ = tfm.block_apply(tfm._period(blocks_stage, i), cfg, spec,
                                   x, positions, rt)
        return x

    def pipeline(blocks, x_mb, positions):
        """blocks: this stage's (periods/S, ...) stack; x_mb:
        (n_micro, mb, S, D) (meaningful input at stage 0). Returns
        (n_micro, mb, S, D) final hidden, equal on every stage."""
        stage = mesh.axis_index(pipe_axis)
        dev = x_mb.device
        T = n_micro + n_stages - 1
        mbshape = x_mb.shape[1:]
        x_mb = coll.replicated_input(x_mb, pipe_axis, mesh)
        first = torch.tensor(stage == 0, device=dev)
        is_last = stage == n_stages - 1
        prev = x_mb.new_zeros(mbshape)
        outputs = x_mb.new_zeros((n_micro,) + tuple(mbshape))
        for t in range(T):
            mb_idx = t - stage
            active = 0 <= mb_idx < n_micro
            idx = min(max(t if stage == 0 else mb_idx, 0), n_micro - 1)
            x_in = torch.where(first, x_mb[idx], prev)
            y = stage_fn(blocks, x_in, positions)
            y = torch.where(torch.tensor(active, device=dev), y,
                            torch.zeros_like(y))
            keep = torch.tensor(active and is_last, device=dev)
            outputs = outputs.index_copy(
                0, torch.tensor([idx], device=dev),
                torch.where(keep, y, outputs[idx])[None])
            prev = coll.ppermute(y, pipe_axis, perm, mesh)
        # broadcast the last stage's outputs to every stage
        h = coll.psum(outputs * float(is_last), pipe_axis, mesh)
        return coll.replicated_output(h, pipe_axis, mesh)

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        B, S = tokens.shape
        mb = B // n_micro
        x = embed_apply(params["embed"], tokens)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(mb, S)
        x_mb = x.reshape(n_micro, mb, S, -1)
        h = pipeline(params["stack"]["blocks"][0], x_mb,
                     positions).reshape(B, S, -1)
        h = norm_apply(cfg, params["final_norm"], h)
        logits = logits_apply(params, cfg, h)
        return cross_entropy(logits, labels)

    return loss_fn
