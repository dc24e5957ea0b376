"""Builder and loader of the port's CUDA kernels.

Each kernel ``name`` is one source, ``repro_torch/csrc/<name>.cu``, with a
plain C interface; the sources share PTX building blocks through the
headers of ``csrc/`` (``sm90.cuh``). It is compiled with nvcc for Hopper
(``sm_90a``) into a shared library under the checkout's
``build/kernels/`` at first use (one nvcc process per source; ``build``
starts several together) and loaded with ``ctypes``. ``load`` is safe
from several threads at first use (the async farm's slot threads): one
builds and loads, the others wait for it; a temporary output is named
by process and thread, so two builders never write one file. The library's file
name carries a hash of its source, the shared headers and the flags, so
an edited source or header is rebuilt and a stale library is never
loaded. Nothing here runs at import: the CPU tests import every module on
a host without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every shared
    header of ``csrc/`` (``*.cuh``) and the flags."""
    h = hashlib.sha1((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(*names: str) -> Dict[str, str]:
    """Compile the named kernels that are not built yet: one nvcc process
    per source, all started together, each waited for. Returns nvcc's log
    per kernel (registers, shared memory, spills; empty when nothing was
    compiled); raises with the logs of the builds that failed."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)      # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built on first use in this process."""
    lib = _loaded.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _loaded.get(name)
            if lib is None:
                build(name)
                lib = ctypes.CDLL(str(library_path(name)))
                _loaded[name] = lib
    return lib
