"""Time K3 (selective scan), K4 (RG-LRU scan) and K5 (grouped expert
GEMM) of one or two checkouts of the port on one NVIDIA card, in turns.

  python3 tools/kernel_ab.py                      # this checkout only
  python3 tools/kernel_ab.py --parent DIR         # DIR, this, this, DIR

Each turn is its own process that imports ``repro_torch`` from the
checkout it times, builds its kernels there (``build/kernels/``) and
times, with CUDA events over two distinct input sets, K5 at
qwen3-moe-30b-a3b's expert products (128 experts, gate/up (C, 2048) @
(2048, 768) and down (C, 768) @ (768, 2048), bf16, C = 640, 1280 and 8)
and K3 at falcon-mamba-7b's forward (B 2, S 4096) and prefill (B 8,
S 2048) shapes (Din 8192, N 16, f32, B_ and C_ strided); and the K5
wrapper's host time a call at the decode shape (200 calls enqueued
between two synchronises, host clock; the least and the median of five
passes). Where the checkout's K5 has a
``_launch`` that forces a kernel, each bf16 path is also checked against
the plain version and timed at each shape; where its K3 has one that
forces the lane group, each group is timed at both K3 shapes. K4 is
timed at recurrentgemma-2b's forward (B 2, S 4096) and prefill (B 8,
S 2048) shapes (W 2560, f32); where the checkout's K4 has a ``_launch``
that forces a kernel, each path is timed too, and checked equal to the
wrapper's output, and the wrapper's host time a call at the forward
shape; beside it a device copy of a (two thirds of K4's bytes). The turns
of this checkout also time ``tools/k3_floor.cu``, K3's step arithmetic
alone (inputs made in registers, nothing loaded), four states a thread
over every state and step of both shapes: the floor of K3's instruction
stream. Prints one JSON line per turn and a
summary, and writes chiprun_out/kernel_ab.json. Exits non-zero where a
turn fails or no card is present.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
E, D, F = 128, 2048, 768                 # qwen3-moe-30b-a3b's experts
CAPACITIES = {"forward": 640, "prefill": 1280, "decode": 8}
SSM = {"forward": (2, 4096), "prefill": (8, 2048)}
DIN, N_STATE, DT_RANK = 8192, 16, 256    # falcon-mamba-7b
LRU = {"forward": (2, 4096), "prefill": (8, 2048)}
LRU_W = 2560                             # recurrentgemma-2b's lru_width


def events_ms(torch, fn, n_args, reps):
    for i in range(n_args):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for i in range(n_args):
            fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_args)


def host_us(torch, fn, calls=200, repeats=5) -> dict:
    """Host time a call of fn(): ``calls`` calls enqueued between two
    synchronises, host clock, after a warm-up; the least and the median
    of ``repeats`` such passes."""
    for _ in range(20):
        fn()
    passes = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        passes.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return {"min": min(passes), "median": statistics.median(passes)}


def k4(torch, g) -> dict:
    """K4 of the imported checkout at both shapes (see the module's
    docstring)."""
    from repro_torch.kernels import sm_count
    from repro_torch.kernels.rglru_scan import ops as lru

    rec = {"paths": hasattr(lru, "_launch")}
    for name, (B, S) in LRU.items():
        sets = [(torch.rand(B, S, LRU_W, generator=g, device="cuda"),
                 torch.randn(B, S, LRU_W, generator=g, device="cuda"),
                 torch.randn(B, LRU_W, generator=g, device="cuda"))
                for _ in range(2)]
        row = {"ms": events_ms(torch, lambda i: lru.rglru_scan(*sets[i]), 2,
                               10)}
        row["ms_repeat"] = events_ms(
            torch, lambda i: lru.rglru_scan(*sets[i]), 2, 10)
        dst = torch.empty_like(sets[0][0])     # a device copy of a: the
        row["copy_ms"] = events_ms(            # card's streaming rate
            torch, lambda i: dst.copy_(sets[i][0]), 2, 10)
        if rec["paths"]:
            sms = sm_count(torch.device("cuda"))
            row["plan"] = lru.plan(B, S, LRU_W, sms)
            want = lru.rglru_scan(*sets[0])
            for p in lru.PATHS:
                got = lru._launch(*sets[0], p)
                row[f"{p}_equal"] = all(torch.equal(x, y)
                                        for x, y in zip(got, want))
                row[f"{p}_ms"] = events_ms(
                    torch, lambda i: lru._launch(*sets[i], p), 2, 10)
            if name == "forward":
                row["host_us_per_call"] = host_us(
                    torch, lambda: lru.rglru_scan(*sets[0]))
        rec[name] = row
        del sets
    return rec


def k3_floor(torch, build) -> dict:
    """ms of tools/k3_floor.cu over the states and steps of both shapes,
    four states a thread: the forward's 2,048 warps over 4,096 steps and
    the prefill's 8,192 over 2,048."""
    import ctypes

    from repro_torch.kernels import _build

    lib = build / "libk3_floor.so"
    build.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(ROOT / "tools" / "k3_floor.cu")], check=True,
                   capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(lib)).k3_floor_launch
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1024 * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rec = {}
    for name, (B, S) in SSM.items():
        blocks = B * DIN * 4 // 256
        rec[name] = events_ms(
            torch, lambda i: fn(out.data_ptr(), blocks, 256, S, stream), 1,
            5)
    return rec


def measure(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as Fn

    from repro_torch.kernels import _build
    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.kernels.ssm_scan import ops as ssm

    assert torch.cuda.is_available(), "no CUDA device"
    logs = _build.build("grouped_gemm", "ssm_scan", "rglru_scan")
    ptxas = [ln.strip() for text in logs.values() for ln in text.splitlines()
             if "Used" in ln or "spill" in ln or "wgmma" in ln.lower()
             or "Compiling entry" in ln]
    has_path = hasattr(gg, "_launch")
    has_group = hasattr(ssm, "_launch")
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rec: dict = {"tree": str(tree), "ptxas": ptxas, "k5": {}, "k3": {},
                 "paths": has_path, "groups": has_group}

    def k5_sets(M, K, N):
        return [(torch.randn(E, M, K, generator=g, device="cuda").to(bf16),
                 (torch.randn(E, K, N, generator=g, device="cuda")
                  * K ** -0.5).to(bf16)) for _ in range(2)]

    with torch.inference_mode():
        for name, C in CAPACITIES.items():
            for prod, (K, N) in (("gate_up", (D, F)), ("down", (F, D))):
                sets = k5_sets(C, K, N)
                ms = events_ms(torch, lambda i: gg.grouped_gemm(*sets[i]), 2,
                               10)
                bmm = events_ms(torch, lambda i: torch.bmm(*sets[i]), 2, 10)
                ms2 = events_ms(torch, lambda i: gg.grouped_gemm(*sets[i]),
                                2, 10)
                row = {"ms": ms, "ms_repeat": ms2, "bmm_ms": bmm}
                if has_path:
                    x, w = sets[0]
                    row["path"] = gg.choose_path(bf16, C, K, N, x.data_ptr(),
                                                 w.data_ptr())
                    ref = torch.bmm(x.float(), w.float())
                    for p in ("wgmma", "mma"):
                        out = gg._launch(x, w, p).float()
                        rel = float((out - ref).norm() / ref.norm())
                        row[f"{p}_rel_err"] = rel
                        row[f"{p}_ms"] = events_ms(
                            torch, lambda i: gg._launch(*sets[i], p), 2, 10)
                if name == "decode":
                    host = host_us(torch, lambda: gg.grouped_gemm(*sets[0]))
                    row["host_us_per_call"] = host["min"]
                    row["host_us_per_call_median"] = host["median"]
                rec["k5"][f"{name}_{prod}"] = row
                del sets
        for name, (B, S) in SSM.items():
            sets = []
            for _ in range(2):
                _, B_, C_ = torch.split(
                    torch.randn(B, S, DT_RANK + 2 * N_STATE, generator=g,
                                device="cuda"), [DT_RANK, N_STATE, N_STATE],
                    dim=-1)
                sets.append((Fn.softplus(torch.randn(B, S, DIN, generator=g,
                                                     device="cuda")),
                             -torch.exp(0.5 * torch.randn(
                                 DIN, N_STATE, generator=g, device="cuda")),
                             B_, C_,
                             torch.randn(B, S, DIN, generator=g,
                                         device="cuda")))
            ms = events_ms(torch, lambda i: ssm.ssm_scan(*sets[i]), 2, 5)
            ms2 = events_ms(torch, lambda i: ssm.ssm_scan(*sets[i]), 2, 5)
            rec["k3"][name] = {"ms": ms, "ms_repeat": ms2}
            if has_group:
                from repro_torch.kernels import sm_count
                rec["k3"][name]["group"] = ssm.lane_group(
                    B, DIN, N_STATE, sm_count(torch.device("cuda")))
                for G in ssm.lane_groups(N_STATE):
                    rec["k3"][name][f"group_{G}_ms"] = events_ms(
                        torch, lambda i: ssm._launch(*sets[i], G), 2, 5)
            del sets
        rec["k4"] = k4(torch, g)
    if tree == ROOT:
        rec["k3_floor_ms"] = k3_floor(torch, tree / "build" / "kernels")
    rec["device"] = torch.cuda.get_device_name(0)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a second checkout, timed before and after this one")
    ap.add_argument("--tree", type=Path, default=None,
                    help=argparse.SUPPRESS)   # one turn, in this process
    args = ap.parse_args()
    if args.tree is not None:
        print(json.dumps(measure(args.tree.resolve())), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    order = [ROOT] if args.parent is None else \
        [args.parent.resolve(), ROOT, ROOT, args.parent.resolve()]
    turns = []
    for tree in order:
        run = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                             capture_output=True, text=True, timeout=1500)
        sys.stderr.write(run.stderr[-4000:])
        if run.returncode != 0:
            print(f"turn {tree} failed: rc {run.returncode}", flush=True)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        rec["turn"] = "parent" if tree != ROOT else "change"
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    for rec in turns:
        k5 = ", ".join(f"{k} {v['ms']:.4f}" for k, v in rec["k5"].items())
        k3 = ", ".join(f"{k} {v['ms']:.4f}" for k, v in rec["k3"].items())
        k4 = ", ".join(f"{k} {rec['k4'][k]['ms']:.4f}" for k in LRU)
        host = rec["k5"]["decode_gate_up"]["host_us_per_call"]   # least
        print(f"{rec['turn']}: K5 ms {k5}; K3 ms {k3}; K4 ms {k4}; K5 host "
              f"{host:.2f} us a call; K3 floor "
              f"{rec.get('k3_floor_ms')}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(
        {"nvidia_smi": smi, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
