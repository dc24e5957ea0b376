"""Serving CLI of the port: batched prefill + greedy decode, driven through
the WindowScheduler.

Decode runs as windows of ``sample_interval`` autoregressive steps. The
decode engine updates the KV cache in place, pushes per-token telemetry
([step, mean token id, max logit]) into the P-Shell decode FIFO and counts
emissions in a ``tokens`` CSR. On a card each window is ONE CUDA-graph
replay (``core/graphs.py``): the full window and the tail window are
captured once each, after a one-step warm-up on clones of the cache and
shell, before the first window runs; on host tensors a window runs its
steps eagerly. The scheduler double-buffers the shell, so the host drain
of window *i* (where the tokens and the per-window latency sample land)
overlaps window *i+1* queued on the device.

Every architecture of the registry serves. A VLM's cache holds its patch
prefix too (``max_len`` counts ``num_patches``, as in the reference). The
one difference from the reference: a batch's frame or patch embeddings
go to the device in the model's dtype before the prefill; the
reference's enc-dec prefill fails on the pipeline's f32 frames.

``scope=`` (or ``--scope N``) runs the decode with the ZP-Scope plane
(``core/scope.py``): device counters over each window's tokens, read every
N drains, reported under "scope". The tokens, the drained shell and the
cache are bit-identical with the plane on or off. With
``ScopeSpec(fuse=True)`` the counter update is captured into each window's
CUDA graph (still one replay a window); unfused it runs eagerly after the
replay.

A measured-window roofline capture (``roofline/capture.py``) rides the
decode: one decode step's cost counted on fake tensors before the decode
clock starts (outside every CUDA-graph capture, leaving the cache
untouched; once a process for a config and its shapes) and scaled by each
window's size, each window's pipelined
wall time and its device time (CUDA events around its enqueue), reported
under "roofline"; ``--save-measured`` writes the record for
``python -m repro_torch.roofline.report``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --sample-interval 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --no-smoke --batch 8 --prompt-len 2048 --gen 64 --sample-interval 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
      --no-smoke
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import Watchdog, WindowGraphs, WindowScheduler
from repro_torch.core.pshell import (FifoSpec, ShellConfig, csr_accum, drain,
                                     fifo_push, shell_init)
from repro_torch.core.schedule import plan_windows
from repro_torch.core.scope import ScopeSpec, as_plane, unwrap
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models import build_model
from repro_torch.roofline import WindowCapture, save_measured
from repro_torch.roofline.cost import count_cost
from repro_torch.serve import make_prefill_step
from repro_torch.utils import (dtype_of, resolve_device, sync, tree_leaves,
                               tree_map, tree_structure)


# a batch's stubbed modality-frontend outputs (whisper's frame embeddings,
# internvl2's patch embeddings)
_FRONTEND_INPUTS = ("frames", "patches")
# one decode step's cost by the signature it was counted on: a count
# depends only on the config and on the shapes, dtypes and devices of the
# weights, the cache and the shell (as a jit compile on its arguments'
# signature), so the serves of one cell count it once a process
_STEP_COSTS: dict = {}


def _signature(tree) -> tuple:
    return (tree_structure(tree), tuple(
        (tuple(x.shape), x.dtype, x.device.type) if torch.is_tensor(x)
        else repr(x) for x in tree_leaves(tree)))


def _step_cost(cfg, engine, params, state, shell) -> dict:
    """One decode step's cost: ``count_cost`` of a one-step window on
    fake tensors, counted once per signature."""
    key = (cfg, _signature((params, state, shell)))
    if key not in _STEP_COSTS:
        _STEP_COSTS[key] = count_cost(engine, state, shell, np.arange(1))
    return _STEP_COSTS[key]


def decode_shell_config(sample_interval: int) -> ShellConfig:
    """Decode-telemetry shell: one FIFO row per generated token (depth one
    clock-gated window — lossless at any interval), plus a token counter."""
    return ShellConfig(
        csrs={"tokens": ((), torch.int32)},
        fifos={"decode": FifoSpec(depth=max(1, sample_interval), shape=(3,),
                                  dtype=torch.float32)},
        sample_interval=sample_interval)


def _steps_on(idx_stack, device):
    """The window's step indices as a device tensor: a tensor already on
    ``device`` as it is, host indices through pinned memory (no host
    sync)."""
    if torch.is_tensor(idx_stack) and idx_stack.device == device:
        return idx_stack
    idx = torch.as_tensor(np.asarray(idx_stack))
    if device.type == "cuda":
        return idx.pin_memory().to(device, non_blocking=True)
    return idx.to(device)


def make_decode_engine(model, params, donate: bool = True, graph=None):
    """Scheduler engine for decode: state=(cache, last_token); runs one
    decode step per window slot, pushing telemetry into the shell. The
    step index of each FIFO row is read from a device tensor, so a
    captured window writes the indices of the window it replays.

    ``graph`` (default: whether ``params`` lie on a card) returns the
    engine as a ``WindowGraphs``, one CUDA-graph replay a window;
    ``graph=False`` on a card runs the steps eagerly (the comparison the
    graphs are held against). The cache is updated in place, which stands
    in for the reference's donation of the cache/token state; the shell is
    never written in place, so the snapshot survives until its overlapped
    drain. ``donate=False`` clones the incoming state first, so the
    caller's state stays valid (the reference's non-donating engine)."""
    on_card = tree_leaves(params)[0].is_cuda
    graph = on_card if graph is None else graph
    if graph and not on_card:
        raise ValueError("a CUDA-graph decode engine needs params on a card")

    def engine(state, shell, idx_stack):
        cache, tok = state
        if not donate:
            cache = tree_map(torch.clone, cache)
        idx = _steps_on(idx_stack, tok.device)
        toks = []
        for i in range(idx.shape[0]):
            cache, logits = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            payload = torch.stack([
                idx[i].float(),
                tok.float().mean(),
                logits.max().float()])
            shell = fifo_push(shell, "decode", payload)
            shell = csr_accum(shell, "tokens", tok.shape[0], op="add")
            toks.append(tok)
        return (cache, tok), shell, torch.stack(toks)

    return WindowGraphs(engine, warmup="clone") if graph else engine


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
          sample_interval: int = 4, device=None, params=None, timer=None,
          graph=None, return_cache: bool = False, scope=None):
    """Serve ``batch`` synthetic prompts of ``prompt_len`` tokens and
    generate ``gen`` tokens each. ``params=None`` draws random weights from
    ``seed`` on the device; otherwise ``params`` (e.g. carried across with
    ``repro_torch.interop``) must already be on it. ``timer`` is handed to
    the scheduler (its "device" phase wraps each window's dispatch).
    ``graph`` chooses the decode engine (``make_decode_engine``: CUDA-graph
    windows on a card by default); ``return_cache`` adds the final decode
    cache to the record, under "cache". The record's "roofline" is the
    decode's measured-window capture (its cost pass is not in
    ``decode_s``)."""
    device = resolve_device(device)
    model = build_model(cfg)
    with torch.inference_mode():
        return _serve(model, cfg, batch, prompt_len, gen, seed,
                      sample_interval, device, params, timer, graph,
                      return_cache, scope)


def _serve(model, cfg, batch, prompt_len, gen, seed, sample_interval,
           device, params, timer, graph, return_cache, scope):
    if params is None:
        params = model.init(seed, device=device)
    bf = make_batch_fn(cfg, batch, prompt_len, seed)
    # the stubbed frontends' embeddings go in the model's dtype: the
    # reference passes the pipeline's f32 frames on, and its enc-dec
    # prefill then fails (models/encdec.py::encdec_prefill)
    b = {k: torch.from_numpy(v).to(device, dtype_of(cfg.dtype)
                                   if k in _FRONTEND_INPUTS else None)
         for k, v in bf(0).items() if k != "labels"}
    max_len = prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0) \
        + gen + 8
    prefill = make_prefill_step(model, max_len)
    wd = Watchdog(timeout_s=120.0)

    # every clock read below follows a sync: the device has finished what
    # the interval measures, not just accepted it
    sync(device)
    t0 = time.perf_counter()
    cache, logits = prefill(params, b)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    sync(device)
    t1 = time.perf_counter()

    engine = make_decode_engine(model, params, graph=graph)
    sched = WindowScheduler(interval=max(1, sample_interval), overlap=True,
                            drain_fn=drain, timer=timer)
    sh = shell_init(decode_shell_config(sample_interval), device)
    # one decode step's cost, counted on fake tensors (a WindowGraphs
    # through its engine: nothing is captured, replayed or launched, and
    # the cache is not written), scaled by each window's size
    capture = WindowCapture().set_cost(
        _step_cost(cfg, engine, params, (cache, tok), sh), window_size=1)
    plane = None
    ran = engine            # the engine whose windows run
    if scope is not None:
        plane = as_plane(scope)
        capture.attach_scope(plane)
        # a fused plane's engine is a WindowGraphs of its own (the window
        # and the counter update in one capture); unfused, the update runs
        # after the inner engine's replay. The scheduler's bind finds the
        # same instrumented engine and composite shell again.
        instrumented = plane.instrument(engine)
        sh = plane.wrap_shell(sh)
        if isinstance(instrumented, WindowGraphs):
            ran = instrumented
    graphed = isinstance(ran, WindowGraphs)
    if graphed:
        # capture every window length of the run, in the order the windows
        # come (full, then tail: the order the shared pool needs), before
        # the first window, so no capture (and none of its syncs) falls
        # inside the decode
        prep_sh = sh if ran is not engine else unwrap(sh)
        for g in dict.fromkeys(p.size for p in plan_windows(
                gen - 1, sample_interval)):
            ran.prepare((cache, tok), prep_sh, np.arange(g))
    sync(device)
    t_decode = time.perf_counter()

    out_tokens = [tok.cpu().numpy()]
    dispatch_t: dict = {}
    window_ms: list = []
    drained: list = []
    fifo_rows = 0

    def on_dispatch(plan, state):
        # stamped after the enqueue, deliberately without a sync: a sync
        # here would serialise the pipeline this latency describes
        dispatch_t[plan.index] = time.perf_counter()
        wd.heartbeat()

    def on_drain(plan, records, toks):
        nonlocal fifo_rows
        out_tokens.append(toks.numpy()[:, :, 0].T)
        # dispatch-to-drain PIPELINED latency: the window's host copies
        # have completed (the scheduler waited on its event), and window
        # i+1 was dispatched before this drain ran
        window_ms.append((time.perf_counter() - dispatch_t[plan.index])
                         * 1e3)
        fifo = records["fifos"]["decode"]
        fifo_rows += fifo["count"]
        drained.append({"rows": fifo["data"].tolist(),
                        "count": fifo["count"], "dropped": fifo["dropped"],
                        "tokens_csr": int(records["csrs"]["tokens"])})

    od, odr = capture.callbacks(on_dispatch=on_dispatch, on_drain=on_drain)
    (cache, tok), _, sh = sched.run(
        engine, sched.windows(range(gen - 1)), (cache, tok), sh,
        on_dispatch=od, on_drain=odr, scope=plane,
        on_enqueue=capture.on_enqueue)
    sync(device)
    t2 = time.perf_counter()
    toks = np.concatenate(out_tokens, axis=1)
    n_windows = len(plan_windows(gen - 1, sample_interval))
    out = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "prefill_s": t1 - t0,
        "decode_s": t2 - t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t2 - t_decode, 1e-9),
        "decode_window_ms": [round(x, 2) for x in window_ms],
        "decode_fifo_rows": fifo_rows,
        "generated": toks[:, :8].tolist(),
        "tokens": toks.tolist(),
        "drained": drained,
        "hung": wd.should_restart(),
        "engine": "graph" if graphed else "eager",
        "windows_by_engine": dict(ran.windows) if graphed
        else {"graph": 0, "eager": n_windows},
        "capture_s": ran.capture_s if graphed else 0.0,
        "roofline": capture.report(),
    }
    if plane is not None:
        out["scope"] = plane.report()
    if return_cache:
        out["cache"] = cache
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="glm4-9b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (--no-smoke: the full one)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sample-interval", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scope", type=int, default=0, metavar="N",
                    help="enable the ZP-Scope instrumentation plane with "
                         "a read rate of every N window drains")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--save-measured", action="store_true",
                    help="persist the run's measured-window roofline "
                         "record for repro_torch.roofline.report")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    scope = ScopeSpec(every_n_windows=args.scope) if args.scope > 0 \
        else None
    out = serve(cfg, args.batch, args.prompt_len, args.gen, seed=args.seed,
                sample_interval=args.sample_interval, device=args.device,
                scope=scope)
    if args.save_measured:
        save_measured(out["roofline"], cfg.name, "serve")
    print(json.dumps(out, indent=1, default=float))


if __name__ == "__main__":
    main()
