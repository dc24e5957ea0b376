"""Checks of the port on the card, shared by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``: a scheduler timer that forbids host syncs
inside a decode window, and K2 held against its plain version."""
from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# elementwise rtol = atol: the tolerances of tests/test_kernels.py
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# bf16 also holds ||out - ref|| / ||ref|| under this limit. At the serve
# shapes an output element is about 0.036, so the elementwise 2e-2 alone
# passes a slot wrongly masked in or out, which moves the output by 1.8e-2
# to 2.8e-2 normwise. The kernel and its plain version round to bf16 at
# different points (the kernel rounds weights before they are normalised)
# and differ by about 3e-3 normwise on an H100.
BF16_NORM_REL = 6e-3


class NoSyncInWindow:
    """Scheduler timer: each window's dispatch (the "device" phase) runs
    under CUDA sync-debug mode "error", so a host sync inside a decode
    window raises. Counts the windows it has seen."""

    def __init__(self):
        self.windows = 0

    @contextlib.contextmanager
    def phase(self, name):
        if name != "device":
            yield
            return
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
        self.windows += 1


def check_decode_attention(B, H, K, W, hd, pos, dtype, softcap=0.0, seed=0):
    """K2 on random inputs drawn on the card from ``seed``, against its
    plain version on the same inputs. Raises AssertionError where they
    disagree; returns (max abs error, normwise relative error)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, W, K, hd, generator=g, device=dev).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    out = ops.decode_attention(q, k, v, pos=p, window=W, softcap=softcap)
    ref = decode_attention_ref(q, k, v, pos=p, window=W, softcap=softcap)
    case = (f"K2 vs plain, B={B} H={H} K={K} W={W} hd={hd} pos={pos} "
            f"{dtype} softcap={softcap}")
    assert out.dtype == dtype and out.shape == q.shape, case
    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                               atol=TOL[dtype],
                               msg=lambda m: f"{case}: {m}")
    diff = out.float() - ref.float()
    rel = float(diff.norm() / ref.float().norm().clamp_min(1e-30))
    if dtype == torch.bfloat16:
        assert rel <= BF16_NORM_REL, f"{case}: normwise error {rel}"
    return float(diff.abs().max()), rel
