"""Serving CLI of the port: batched prefill + greedy decode, driven through
the WindowScheduler.

Decode runs as windows of ``sample_interval`` autoregressive steps. Each
window is one dispatch of the decode engine, which updates the KV cache in
place, pushes per-token telemetry ([step, mean token id, max logit]) into
the P-Shell decode FIFO and counts emissions in a ``tokens`` CSR. The
scheduler double-buffers the shell, so the host drain of window *i*
(where the tokens and the per-window latency sample land) overlaps window
*i+1* queued on the device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --sample-interval 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --no-smoke --batch 8 --prompt-len 2048 --gen 64 --sample-interval 8
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import Watchdog, WindowScheduler
from repro_torch.core.pshell import (FifoSpec, ShellConfig, csr_accum, drain,
                                     fifo_push, shell_init)
from repro_torch.data.pipeline import make_batch_fn
from repro_torch.models import build_model
from repro_torch.serve import make_prefill_step
from repro_torch.utils import resolve_device, sync, tree_map


def decode_shell_config(sample_interval: int) -> ShellConfig:
    """Decode-telemetry shell: one FIFO row per generated token (depth one
    clock-gated window — lossless at any interval), plus a token counter."""
    return ShellConfig(
        csrs={"tokens": ((), torch.int32)},
        fifos={"decode": FifoSpec(depth=max(1, sample_interval), shape=(3,),
                                  dtype=torch.float32)},
        sample_interval=sample_interval)


def make_decode_engine(model, params, donate: bool = True):
    """Scheduler engine for decode: state=(cache, last_token); runs one
    decode step per window slot, pushing telemetry into the shell.

    The cache is updated in place, which stands in for the reference's
    donation of the cache/token state; the shell is never written in
    place, so the snapshot survives until its overlapped drain.
    ``donate=False`` clones the incoming state first, so the caller's
    state stays valid (the reference's non-donating engine)."""
    def engine(state, shell, idx_stack):
        cache, tok = state
        if not donate:
            cache = tree_map(torch.clone, cache)
        toks = []
        for idx in idx_stack:
            cache, logits = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            payload = torch.stack([
                torch.full((), float(idx), device=tok.device),
                tok.float().mean(),
                logits.max().float()])
            shell = fifo_push(shell, "decode", payload)
            shell = csr_accum(shell, "tokens", tok.shape[0], op="add")
            toks.append(tok)
        return (cache, tok), shell, torch.stack(toks)

    return engine


def serve(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
          sample_interval: int = 4, device=None, params=None, timer=None):
    """Serve ``batch`` synthetic prompts of ``prompt_len`` tokens and
    generate ``gen`` tokens each. ``params=None`` draws random weights from
    ``seed`` on the device; otherwise ``params`` (e.g. carried across with
    ``repro_torch.interop``) must already be on it. ``timer`` is handed to
    the scheduler (its "device" phase wraps each window's dispatch)."""
    device = resolve_device(device)
    model = build_model(cfg)
    with torch.inference_mode():
        return _serve(model, cfg, batch, prompt_len, gen, seed,
                      sample_interval, device, params, timer)


def _serve(model, cfg, batch, prompt_len, gen, seed, sample_interval,
           device, params, timer):
    if params is None:
        params = model.init(seed, device=device)
    bf = make_batch_fn(cfg, batch, prompt_len, seed)
    b = {k: torch.from_numpy(v).to(device) for k, v in bf(0).items()
         if k != "labels"}
    max_len = prompt_len + gen + 8
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

    engine = make_decode_engine(model, params)
    sched = WindowScheduler(interval=max(1, sample_interval), overlap=True,
                            drain_fn=drain, timer=timer)
    sh = shell_init(decode_shell_config(sample_interval), device)

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

    (cache, tok), _, sh = sched.run(
        engine, sched.windows(range(gen - 1)), (cache, tok), sh,
        on_dispatch=on_dispatch, on_drain=on_drain)
    sync(device)
    t2 = time.perf_counter()
    toks = np.concatenate(out_tokens, axis=1)
    return {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "prefill_s": t1 - t0,
        "decode_s": t2 - t1,
        "decode_tok_per_s": batch * (gen - 1) / max(t2 - t1, 1e-9),
        "decode_window_ms": [round(x, 2) for x in window_ms],
        "decode_fifo_rows": fifo_rows,
        "generated": toks[:, :8].tolist(),
        "tokens": toks.tolist(),
        "drained": drained,
        "hung": wd.should_restart(),
    }


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = serve(cfg, args.batch, args.prompt_len, args.gen, seed=args.seed,
                sample_interval=args.sample_interval, device=args.device)
    print(json.dumps(out, indent=1, default=float))


if __name__ == "__main__":
    main()
