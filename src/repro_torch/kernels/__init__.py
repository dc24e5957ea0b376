"""Hand-written CUDA kernels of the port, each beside its plain version."""
from __future__ import annotations

import threading

import torch

_SMS: dict = {}                    # device index -> streaming multiprocessors
_COUNT_LOCK = threading.Lock()
_TALLIES = threading.local()       # .counts: kernel wrapper -> this thread's


def count_launch(fn, n: int = 1) -> None:
    """Add ``n`` launches to the kernel wrapper ``fn``: to its process
    total ``fn.launches`` (under a lock: a bare ``+=`` is a
    read-modify-write that two slot threads can interleave and lose a
    launch) and to the calling thread's own tally, which a CUDA-graph
    capture diffs to take back only the launches it recorded itself."""
    with _COUNT_LOCK:
        fn.launches += n
    tally = getattr(_TALLIES, "counts", None)
    if tally is None:
        tally = _TALLIES.counts = {}
    tally[fn] = tally.get(fn, 0) + n


def thread_launches(fn) -> int:
    """The launches ``fn`` counted on the calling thread."""
    return getattr(_TALLIES, "counts", {}).get(fn, 0)


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


def is_lane_batched(*tensors) -> bool:
    """True where a tensor is a ``torch.func.vmap`` batched tensor: one
    whose storage a ctypes launch cannot read."""
    return any(torch.is_tensor(t) and torch._C._functorch.is_batchedtensor(t)
               for t in tensors)


def refuse_vmap(name: str, what: str, *tensors) -> None:
    """Raise where a kernel without a vmap rule is reached under
    ``torch.func.vmap`` on CUDA tensors (a lane-batched board): its
    launcher reads raw pointers, which batched tensors do not have, and
    running the lanes one after another is not a fused launch."""
    if is_lane_batched(*tensors):
        raise NotImplementedError(
            f"{name} under torch.func.vmap on CUDA tensors waits for the "
            f"lane-batched {what} slice of the port, which adds its vmap "
            "rule (ROADMAP.md Queue 2); on host tensors its plain version "
            "vmaps")


def fold_lane_axis(fn, lanes: int, in_dims, *tensors):
    """The body of a kernel's vmap rule: each tensor's lane axis (its
    ``in_dims`` entry; None = shared by every lane) moves to the front
    and folds into the kernel's batch axis, (L, B, ...) -> (L*B, ...),
    ``fn`` runs ONCE on the folded tensors, and its output unfolds to
    (L, B, ...) with the lane axis first. Right for a kernel whose rows
    of the batch axis are independent (attention: each (batch, head)
    attends alone), where each lane's output then equals its solo
    launch's."""
    folded = []
    for t, d in zip(tensors, in_dims):
        t = (t.unsqueeze(0).expand(lanes, *t.shape) if d is None
             else t.movedim(d, 0))
        folded.append(t.reshape(lanes * t.shape[1], *t.shape[2:])
                      .contiguous())
    out = fn(*folded)
    return out.reshape(lanes, out.shape[0] // lanes, *out.shape[1:])


def sm_count(device) -> int:
    """The streaming multiprocessors of the card ``device`` names, read
    once per device (a host int: a grid sized from it stays fixed
    for a card, so a CUDA graph can hold the launch)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]
