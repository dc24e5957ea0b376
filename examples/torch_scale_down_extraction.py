"""Scale-Down decomposition demo on the PyTorch/CUDA port: extract a
single block with its preserved interface, replay captured in-situ
traffic bit-identically, and compare the stacked "Scale-Up model" against
composed subsystems. On a card the blocks run the kernels (K1, K3, K4).

  PYTHONPATH=src python examples/torch_scale_down_extraction.py
  PYTHONPATH=src python examples/torch_scale_down_extraction.py \\
      --device cpu
"""
import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import decompose
from repro_torch.models import build_model
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in ("recurrentgemma-2b", "falcon-mamba-7b", "glm4-9b"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(0, device=device)
        g = torch.Generator().manual_seed(1)
        x = torch.randn(2, 16, cfg.d_model, generator=g).to(
            device=device, dtype=torch.bfloat16)
        pos = torch.arange(16, dtype=torch.int32,
                           device=device).expand(2, 16)

        subsystems = [s for _, s, _ in
                      decompose.iter_layer_params(params, cfg)]
        print(f"\n{arch}: {len(subsystems)} extractable blocks "
              f"({[m for m, _ in cfg.layer_specs]})")
        with torch.inference_mode():
            for layer in range(min(3, cfg.num_layers)):
                rep = decompose.verify_extraction(params, cfg, x, pos,
                                                  model.rt, layer)
                print(f"  {rep['subsystem']:26s} "
                      f"bitwise={rep['bitwise_identical']}")
                assert rep["bitwise_identical"], rep
            d = decompose.scanned_vs_unrolled(params, cfg, x, pos, model.rt)
        print(f"  scan-vs-composed rel diff: {d:.2e}")


if __name__ == "__main__":
    main()
