"""Time one full-width serve decode on one NVIDIA card, per engine, per
cuBLAS workspace setting, for this checkout and optionally another one.

  python3 tools/decode_ab.py                      # this checkout only
  python3 tools/decode_ab.py --parent DIR [--arch glm4-9b]

Each turn is its own process that imports ``repro_torch`` from the
checkout it times and serves ``--arch`` at chip_smoke.py's serve cell
(batch 8, prompt 2048, 64 generated tokens, windows of 8, random weights
from seed 0 drawn on the card), untraced. Turns, in order: DIR eager,
this eager, this eager and this graph with CUBLAS_WORKSPACE_CONFIG
=:4096:8, DIR eager with it, this graph without it (DIR's serve has no
graph engine where it predates the CUDA-graph windows). Prints one JSON
line a turn (decode tok/s, prefill s, windows by engine) and writes
chiprun_out/decode_ab.json. Exits non-zero where a turn fails or no card
is present.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKSPACE = ":4096:8"


def child(src: str, arch: str, graph: bool) -> None:
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = {"graph": graph} if "graph" in inspect.signature(serve).parameters \
        else {}
    if graph and not kw:
        raise SystemExit(f"{src}: serve() has no graph engine")
    out = serve(get_config(arch), 8, 2048, 64, seed=0, sample_interval=8,
                device="cuda", **kw)
    print(json.dumps({k: out.get(k) for k in (
        "decode_tok_per_s", "decode_s", "prefill_s", "engine",
        "windows_by_engine", "capture_s")}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--child", nargs=3, metavar=("SRC", "ARCH", "GRAPH"))
    args = ap.parse_args()
    if args.child:
        child(args.child[0], args.child[1], args.child[2] == "1")
        return 0
    here = str(ROOT / "src")
    there = str(Path(args.parent).resolve() / "src") if args.parent else None
    turns = [(there, False, False), (here, False, False),
             (here, False, True), (here, True, True), (there, False, True),
             (here, True, False)]
    results = []
    for src, graph, ws in turns:
        if src is None:
            continue
        env = {k: v for k, v in os.environ.items()
               if k != "CUBLAS_WORKSPACE_CONFIG"}
        if ws:
            env["CUBLAS_WORKSPACE_CONFIG"] = WORKSPACE
        proc = subprocess.run(
            [sys.executable, __file__, "--child", src, args.arch,
             "1" if graph else "0"], env=env, capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec.update(checkout="parent" if src == there else "this",
                   workspace_config=WORKSPACE if ws else None,
                   arch=args.arch)
        print(json.dumps(rec), flush=True)
        results.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_ab.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
