"""Quickstart of the PyTorch/CUDA port: build an architecture, train a few
steps with the full P-Shell co-emulation stack (fused clock-gated windows
through the core WindowScheduler; on a card one CUDA-graph replay a
window), inspect commits and coverage, generate tokens.

  PYTHONPATH=src python examples/torch_quickstart.py [--arch glm4-9b]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu --steps 4

Training runs the plain, differentiable "xla" path; generation runs the
same weights through the kernels ("cuda": K2 on a card, each kernel's
plain version on host tensors).
"""
import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core import (CoverageMap, PShell, default_shell_config,
                              make_ingest)
from repro_torch.data import SyntheticPipeline
from repro_torch.models import Runtime, build_model
from repro_torch.serve import make_prefill_step, make_serve_step
from repro_torch.train import init_state, make_group_step
from repro_torch.utils import resolve_device, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. architecture (the reduced config; --arch picks the family)
    cfg = get_smoke_config(args.arch)
    rt = Runtime(attention_impl="xla",
                 taps=frozenset({"commits", "coverage", "router"}))
    model = build_model(cfg, rt)
    n_params = sum(t.numel() for t in
                   tree_leaves(model.init(0, device="meta")))
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={n_params / 1e6:.1f}M device={device}")

    # 2. train through the core WindowScheduler: each clock-gated window
    # (sample_interval steps) is ONE dispatch, and the host drain of
    # window i overlaps window i+1 on the device
    state = init_state(model, 0, device=device)
    ingest = make_ingest(cfg)
    shell = PShell(default_shell_config(cfg, sample_interval=2), ingest)
    cov = CoverageMap()
    pipe = SyntheticPipeline(cfg, batch=4, seq=32)

    def on_drain(i, rec):
        cov.update(rec["csrs"])
        commits = rec["fifos"]["commits"]
        losses = rec["metrics"]["loss"]
        print(f"window ..{i}: loss={float(losses[-1]):.3f} "
              f"commits={commits['count']} dropped={commits['dropped']} "
              f"coverage={cov.fraction():.2f}")

    try:
        batches = [next(pipe) for _ in range(args.steps)]
        state, _, _ = shell.run_grouped(
            make_group_step(model, ingest=ingest), state, batches,
            shell=shell.init(device), on_drain=on_drain)
    finally:
        pipe.close()

    # 3. serve: prefill a prompt, decode greedily, on the kernel path
    serving = build_model(cfg, rt.with_(attention_impl="cuda"))
    params = state["params"]
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                           dtype=torch.int32).to(device)
    toks = []
    with torch.inference_mode():
        cache, logits = make_prefill_step(serving, 64)(
            params, {"tokens": prompt})
        step = make_serve_step(serving)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        for _ in range(8):
            cache, logits = step(params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            toks.append(int(tok[0, 0]))
    print("generated:", toks)


if __name__ == "__main__":
    main()
