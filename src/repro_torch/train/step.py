"""The train step: gradients of ``Model.loss`` -> (EF compression) -> AdamW.

This step is the DUT of the co-emulation layer: the P-Shell taps thread
through ``model.loss`` and surface as the ``aux`` output (commit
checksums, coverage toggles, router stats). Instrumentation never feeds
back into the state update: non-interference is structural.

The state is ``{"params", "opt": {"m", "v", "count"}, "step"}`` (plus
``"ef"`` with ``grad_compress``), the reference's layout. A step updates
it IN PLACE, which stands in for the reference's donation of the state:
the same tensors carry every step, so a CUDA graph of a window
(``core/graphs.py``) holds them as its static buffers.

Gradients come from ``torch.autograd.grad`` of ``model.loss``, so the
model must run the differentiable ``attention_impl="xla"`` path, as the
reference trains on its ``impl="xla"`` path. Under "cuda" on the card the
kernel wrappers raise (they have no backward).

Options:
  grad_compress — error-feedback int8 gradient compression
  (``train/compress.py``); adds the ``ef`` residual tree to the state.
  accum_steps  — microbatch gradient accumulation over equal slices of
  the batch, in f32.

``make_group_step`` runs a whole clock-gated window (P-Shell
``sample_interval`` steps, plus the shell ingest) as one engine call;
per-step metrics stack on the device and nothing crosses to the host
until the window's drain.
"""
from __future__ import annotations

import torch

from repro_torch.train.compress import init_residuals, make_compressor
from repro_torch.train.optim import OptConfig, adamw_init, adamw_update
from repro_torch.utils import (resolve_device, tree_leaves, tree_map,
                               tree_unflatten)


def init_state(model, seed: int = 0, opt_cfg: OptConfig = OptConfig(),
               grad_compress: bool = False, *, device=None):
    """Params drawn from ``seed`` on ``device`` (``cuda`` unless the caller
    names another; it raises without one), zero moments and step."""
    device = resolve_device(device)
    params = model.init(seed, device=device)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if grad_compress:
        state["ef"] = init_residuals(params)
    return state


def state_specs(model, opt_cfg: OptConfig = OptConfig(),
                grad_compress: bool = False):
    """The state's layout as meta tensors (shapes and dtypes, no data)."""
    return init_state(model, opt_cfg=opt_cfg, grad_compress=grad_compress,
                      device="meta")


def _batch_on(batch, device):
    """The batch's arrays as tensors on ``device``."""
    return {k: v.to(device) if torch.is_tensor(v)
            else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(loss_fn, params, batch):
    """(loss, (metrics, aux), grads) of ``loss_fn(params, batch)``; grads
    in each param's dtype, zeros for a param the loss does not read.
    Metrics and aux come back detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, (metrics, aux) = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    detach = lambda t: t.detach() if torch.is_tensor(t) else t  # noqa: E731
    return (loss.detach(), (tree_map(detach, metrics), tree_map(detach, aux)),
            tree_unflatten(params, grads))


def _microbatch_grads(loss_fn, params, batch, accum_steps: int):
    """Mean loss and f32 grads over ``accum_steps`` equal slices of the
    batch, in slice order; the last slice's taps."""
    acc, total, aux = None, None, None
    for i in range(accum_steps):
        mb = {k: v[i * (v.shape[0] // accum_steps):
                   (i + 1) * (v.shape[0] // accum_steps)]
              for k, v in batch.items()}
        loss, (_, aux), grads = _value_and_grad(loss_fn, params, mb)
        g = [x.float() for x in tree_leaves(grads)]
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        total = loss if total is None else total + loss
    n = float(accum_steps)
    return total / n, tree_unflatten(params, [a / n for a in acc]), aux


def make_train_step(model, opt_cfg: OptConfig = OptConfig(),
                    with_aux: bool = True, grad_compress: bool = False,
                    accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics[, aux])``; the state is
    updated in place and returned. ``batch`` holds host arrays or tensors
    and is moved to the params' device."""
    compressor = make_compressor() if grad_compress else None

    def train_step(state, batch):
        params = state["params"]
        device = tree_leaves(params)[0].device
        batch = _batch_on(batch, device)
        if accum_steps > 1:
            loss, grads, aux = _microbatch_grads(model.loss, params, batch,
                                                 accum_steps)
            metrics = {"loss": loss, "ce": loss,
                       "moe_aux": torch.zeros((), dtype=torch.float32,
                                              device=device)}
        else:
            loss, (metrics, aux), grads = _value_and_grad(model.loss, params,
                                                          batch)
        if grad_compress:
            grads, ef = compressor(grads, state["ef"])
            tree_map(lambda dst, src: dst.copy_(src), state["ef"], ef)
        _, _, opt_metrics = adamw_update(opt_cfg, params, grads,
                                         state["opt"], inplace=True)
        state["step"].add_(1)
        metrics = {**metrics, **opt_metrics}
        if with_aux:
            return state, metrics, aux
        return state, metrics

    return train_step


def make_group_step(model, opt_cfg: OptConfig = OptConfig(), ingest=None,
                    grad_compress: bool = False, accum_steps: int = 1):
    """A fused clock-gated window: ``train_step`` (+ the P-Shell
    ``ingest``) over a stacked batch group, as one engine call.

    Returns ``group_step(state, shell, batch_stack) -> (state, shell,
    metrics_stack)``, the engine signature the ``WindowScheduler``
    dispatches; ``batch_stack`` leaves have a leading (g,) window axis and
    ``metrics_stack`` holds every step's metrics stacked on the device
    ((g,) per scalar). With ``ingest=None`` the shell (e.g. ``{}``) passes
    through untouched.

    The body is exactly one per-step ``train_step``, so a window equals the
    per-step loop bit for bit; on the card ``PShell.compile_group`` runs
    it as one CUDA-graph replay."""
    train_step = make_train_step(model, opt_cfg, with_aux=True,
                                 grad_compress=grad_compress,
                                 accum_steps=accum_steps)

    def group_step(state, shell, batch_stack):
        device = tree_leaves(state["params"])[0].device
        stack = _batch_on(batch_stack, device)
        g = next(iter(stack.values())).shape[0]
        per_step = []
        for i in range(g):
            state, metrics, aux = train_step(
                state, {k: v[i] for k, v in stack.items()})
            if ingest is not None:
                shell = ingest(shell, aux, metrics)
            per_step.append(metrics)
        metrics_stack = {k: torch.stack([m[k] for m in per_step])
                         for k in per_step[0]}
        return state, shell, metrics_stack

    return group_step
