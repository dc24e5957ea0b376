"""Device memory that consecutive farm passes leave behind, on one NVIDIA
card.

  python3 tools/farm_memory.py [--passes 10] [--modes async,lockstep]

Draws glm4-9b's full-width weights on the card from seed 0 (as
``chip_smoke.py``'s phase 3), then runs the cell of ``chip_smoke.py``'s
phases 50 and 52 solo (``verify_subsystems`` on all 40 layers, 4 steps
of B=2, S=1024 in windows of 2, 8 virtual slots) ``--passes`` times in
one process for each mode in ``--modes``, through
``chip_smoke._farm_run``. After each pass it prints
``torch.cuda.memory_allocated()``, the bytes the pass left (allocated
after it minus before its capture) and the pass's seconds; the last line
is one JSON object with every number and the card's name and power
limit. Exits non-zero where there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--modes", default="async,lockstep")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("farm_memory: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = get_config(cs.ARCH)
    params = build_model(cfg).init(0, device="cuda")
    xs, pos = cs._farm_inputs(cfg)
    layers = list(range(cfg.num_layers))
    out = {"device": smi, "torch": torch.__version__, "passes": {}}
    for mode in args.modes.split(","):
        rows = []
        for i in range(args.passes):
            _, _, _, secs, _, mem = cs._farm_run(cfg, params, xs, pos,
                                                 layers, lanes=False,
                                                 mode=mode)
            left = mem["after_run"] - mem["before_capture"]
            rows.append({"allocated": mem["after_run"], "left": left,
                         "seconds": secs})
            print(f"{mode} pass {i}: allocated {mem['after_run']} "
                  f"left {left} seconds {secs:.3f}", flush=True)
        out["passes"][mode] = rows
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
