"""Training CLI of the port: ``train_loop`` on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --steps 50 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4

``--smoke`` (the default) takes the reduced config, ``--no-smoke`` the
full one. The model trains on the plain, differentiable "xla" path with
the commit, coverage and router taps, as the reference's CLI does.
``--scope N`` runs the loop with the ZP-Scope plane read every N window
drains (its report is printed under "scope"). ``--save-measured`` waits
for the port's roofline and raises.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.scope import ScopeSpec
from repro_torch.models import Runtime, build_model
from repro_torch.train import LoopConfig, OptConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), default="granite-8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced config (--no-smoke: the full one)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sample-interval", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--scope", type=int, default=0, metavar="N",
                    help="enable the ZP-Scope instrumentation plane with "
                         "a read rate of every N window drains")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--save-measured", action="store_true",
                    help="persist the run's measured-window roofline "
                         "record (waits for the port's roofline)")
    args = ap.parse_args(argv)
    if args.save_measured:
        raise NotImplementedError(
            "--save-measured waits for the roofline slice of the port "
            "(roofline/, out['roofline'])")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rt = Runtime(attention_impl="xla",
                 taps=frozenset({"commits", "coverage", "router"}))
    model = build_model(cfg, rt)
    scope = ScopeSpec(every_n_windows=args.scope) if args.scope > 0 \
        else None
    out = train_loop(
        model,
        LoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                   sample_interval=args.sample_interval,
                   checkpoint_dir=args.checkpoint_dir,
                   grad_compress=args.grad_compress,
                   accum_steps=args.accum_steps, scope=scope),
        OptConfig(lr=args.lr, warmup_steps=10), device=args.device)
    rec = {
        "arch": cfg.name,
        "loss_first": out["losses"][0], "loss_last": out["losses"][-1],
        "coverage": out["coverage"], "profile_s": out["profile"],
    }
    if scope is not None:
        rec["scope"] = out["scope"]
    print(json.dumps(rec, indent=1, default=float))


if __name__ == "__main__":
    main()
