"""PanicRoom runner: the SAME benchmark runs under 'sim' and 'hw', the
paper's identical-in-simulation-and-hardware contract, with the compute
backend as the only swapped layer. In the port 'sim' runs the kernels'
plain PyTorch versions on host tensors (where the JAX package interprets
its Pallas kernels on the CPU) and 'hw' the hand-written kernels on the
card (where the JAX package runs jit-compiled XLA). The program does all
its I/O through the BSP and cannot tell which platform it is on."""
from __future__ import annotations

import time
from typing import Callable, Dict

from repro_torch.panicroom.syscalls import BSP


def run_benchmark(bench: Callable[[BSP, str], dict], platform: str,
                  stdin: bytes = b"", bsp: BSP = None) -> Dict:
    """bench(bsp, platform) must do ALL I/O through the BSP. ``platform``
    is 'sim' or 'hw' and selects the kernel execution mode only. ``bsp``
    (a fresh ``BSP(stdin=stdin)`` by default) lets a caller size the FS."""
    if platform not in ("sim", "hw"):
        raise ValueError(f"platform must be 'sim' or 'hw', not {platform!r}")
    bsp = bsp or BSP(stdin=stdin)
    bsp.init()
    t0 = time.perf_counter()
    result = bench(bsp, platform)
    dt = time.perf_counter() - t0
    if bsp.exited is None:
        bsp.exit(0)
    return {
        "platform": platform,
        "wall_s": dt,
        "exit_code": bsp.exited,
        "stdout": bsp.stdout.decode(errors="replace"),
        "syscalls": dict(bsp.counts),
        "result": result,
    }
