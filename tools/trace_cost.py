"""Host seconds that reading a torch.profiler trace of the card costs, two
ways, on one NVIDIA card.

  python3 tools/trace_cost.py [--ops 100000]

Profiles ``--ops`` small elementwise kernels on the card (device activity
only, as ``chip_smoke.py`` traces), then reads the trace's device events
through ``prof.events()`` (the FunctionEvent list) and through
``chip_smoke.device_events`` (the kineto results), timing each, and
checks that both see the same operations and the same device time. The
last line is one JSON object with the numbers and the card's name and
power limit. Exits non-zero where there is no card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", type=int, default=100_000)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("trace_cost: no CUDA device is available", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_events

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    x = torch.ones(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):   # CUPTI set-up
        x.add_(1)
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    for _ in range(args.ops):
        x.add_(1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    prof.stop()
    stop_s = time.perf_counter() - t
    t = time.perf_counter()
    raw = device_events(prof)
    raw_s = time.perf_counter() - t
    t = time.perf_counter()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    events_s = time.perf_counter() - t
    raw_us = sum(b - a for _, a, b in raw) / 1e3
    events_us = sum(e.time_range.elapsed_us() for e in evs)
    assert len(raw) == len(evs), (len(raw), len(evs))
    assert abs(raw_us - events_us) <= 1e-3 * events_us, (raw_us, events_us)
    print(json.dumps({"ops": args.ops, "device_events": len(raw),
                      "profiler_stop_s": stop_s,
                      "kineto_read_s": raw_s, "prof_events_s": events_s,
                      "device_us": raw_us, "prof_events_device_us": events_us,
                      "nvidia_smi": smi, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.exit(main())
