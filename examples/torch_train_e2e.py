"""End-to-end training of the PyTorch/CUDA port: a ~100M-class
model for a few hundred steps, with checkpoint/restart, watchdog,
coverage and live stall profiling (the full ZP-Farm host loop), the DUT
built with remat "dots".

  PYTHONPATH=src python examples/torch_train_e2e.py --steps 300
  PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --steps 2

Checkpoints go to a temporary directory, deleted at the end, unless
``--ckpt DIR`` names one (a later run with the same DIR resumes from it).
"""
import argparse
import dataclasses
import json
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.models import Runtime, build_model
from repro_torch.train import LoopConfig, OptConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    # ~100M-class: widen the granite smoke config
    cfg = dataclasses.replace(
        get_smoke_config("granite-8b"),
        name="granite-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=1408, vocab_size=32768)
    model = build_model(cfg, Runtime(
        attention_impl="xla", taps=frozenset({"commits", "coverage"}),
        remat="dots"))

    with tempfile.TemporaryDirectory(prefix="torch_e2e_ckpt_") as tmp:
        out = train_loop(
            model,
            LoopConfig(steps=args.steps, batch=8, seq=128,
                       sample_interval=10, checkpoint_every=100,
                       checkpoint_dir=args.ckpt or tmp),
            OptConfig(lr=3e-4, warmup_steps=50), device=args.device)
    n = len(out["losses"])
    print(json.dumps({
        "params_m": round(cfg.param_count() / 1e6, 1),
        "steps": n,
        "loss_start": sum(out["losses"][:10]) / min(10, n),
        "loss_end": sum(out["losses"][-10:]) / min(10, n),
        "profile_s": out["profile"],
        "coverage": out["coverage"],
    }, indent=1, default=float))


if __name__ == "__main__":
    main()
