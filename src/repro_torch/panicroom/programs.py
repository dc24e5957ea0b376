"""Programs that run on the PanicRoom BSP.

``grouped_gemm_program`` is the JAX package's PanicRoom benchmark
(``benchmarks/bench_panicroom.py::_bench``) written again for the port:
it writes its operands to the FS, reads them back, multiplies them
through the grouped GEMM (the K5 wrapper: its CUDA kernel on the card
under 'hw', its plain version on host tensors under 'sim'), writes the
product to the FS and prints its checksum. ``bsp_loc`` counts the BSP's
lines of code, the paper's portability figure.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.panicroom.fs import BLOCK

BSP_FILES = ("__init__.py", "fs.py", "syscalls.py", "runner.py")
# numpy has no bf16: its bytes go through the int16 view
_RAW = {torch.float32: (torch.float32, np.float32),
        torch.bfloat16: (torch.int16, np.int16)}


def _to_bytes(t: torch.Tensor) -> bytes:
    view, _ = _RAW[t.dtype]
    return t.contiguous().view(view).numpy().tobytes()


def _from_bytes(raw: bytes, shape, dtype) -> torch.Tensor:
    view, np_dtype = _RAW[dtype]
    a = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    return torch.from_numpy(a.copy()).view(dtype)


def fs_bytes(x_shape, w_shape, dtype=torch.float32) -> int:
    """A BlockFS size that holds x, w and the product, in whole blocks."""
    E, M, _ = x_shape
    n = int(np.prod(x_shape)) + int(np.prod(w_shape)) + E * M * w_shape[2]
    size = n * torch.empty((), dtype=dtype).element_size()
    return (size // BLOCK + 4) * BLOCK


def grouped_gemm_program(x_shape=(2, 32, 32), w_shape=None,
                         dtype=torch.float32, seed: int = 0):
    """The program bench(bsp, platform): x (E,M,K) and w (E,K,N) drawn
    from numpy's ``seed`` (w is x when ``w_shape`` is None, the JAX
    package's a @ a), in ``dtype``. Returns {"checksum", "out"}: the f32
    sum of the product and the product read back from the FS."""
    def bench(bsp, platform):
        rng = np.random.default_rng(seed)
        ops = [rng.standard_normal(x_shape, dtype=np.float32)]
        if w_shape is not None:
            ops.append(rng.standard_normal(w_shape, dtype=np.float32))
        names = ("x.bin", "w.bin")
        for name, a in zip(names, ops):
            fd = bsp.open(name, "w")
            bsp.write(fd, _to_bytes(torch.from_numpy(a).to(dtype)))
            bsp.close(fd)
        back = []
        for name, a in zip(names, ops):
            fd = bsp.open(name, "r")
            back.append(_from_bytes(bsp.read(fd), a.shape, dtype))
            bsp.close(fd)
        x, w = back[0], back[-1]
        if platform == "hw":       # the CUDA kernel on the card
            out = gg_ops.grouped_gemm(x.cuda(), w.cuda()).cpu()
        else:                      # its plain version on host tensors
            out = gg_ops.grouped_gemm(x, w)
        fd = bsp.open("out.bin", "w")
        bsp.write(fd, _to_bytes(out))
        bsp.close(fd)
        fd = bsp.open("out.bin", "r")
        out = _from_bytes(bsp.read(fd), tuple(out.shape), dtype)
        bsp.close(fd)
        checksum = float(out.float().sum())
        bsp.puts(f"checksum={checksum:.3f}")
        return {"checksum": checksum, "out": out}

    return bench


def bsp_loc() -> int:
    """Non-blank, non-comment lines of the BSP's modules."""
    root = pathlib.Path(__file__).resolve().parent
    return sum(1 for f in BSP_FILES for line in open(root / f)
               if line.strip() and not line.strip().startswith("#"))
