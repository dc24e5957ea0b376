"""Hand-written CUDA kernels of the port, each beside its plain version."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a CUDA kernel would silently cut a gradient.

    A kernel writes its result into a fresh tensor through ctypes, so the
    result carries no autograd history. Under grad mode with an input that
    requires grad that would drop the kernel's term from every gradient
    without an error; until the kernel has a backward, refuse instead.
    Under ``torch.no_grad()`` or ``torch.inference_mode()`` it does
    nothing."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward yet, so its result "
            "would carry no gradient; run it under torch.no_grad() or "
            "torch.inference_mode(), or on host tensors (the plain version "
            "differentiates)")
