"""Hand-written CUDA kernels of the port, each beside its plain version."""
from __future__ import annotations

import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

_SMS: dict = {}                    # device index -> streaming multiprocessors
_COUNT_LOCK = threading.Lock()
_TALLIES = threading.local()       # .counts: kernel wrapper -> this thread's
_TRACED = threading.local()        # .counts: kernel name -> this thread's
# calls on fake tensors (the board certifier's trace, the roofline's cost
# pass); .cost: their summed cost (flops, bytes, exps)


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


def is_traced(t) -> bool:
    """True for a fake tensor: one with a shape, a dtype and a device but
    no storage, as the board certifier (``analysis/boardcheck.py``) traces
    a window with. A wrapper handed one checks its shapes, returns an
    output of the kernel's shape and dtype on the input's device, and
    launches, builds and counts nothing (``note_traced`` records the call
    instead). A meta tensor is not one: the wrappers refuse it, as any
    device but the card and the host."""
    return isinstance(t, FakeTensor)


def note_traced(fn, cost: dict) -> dict:
    """Record one call of the kernel wrapper ``fn`` on traced tensors in
    the calling thread's trace tally: the call (``traced_counts``) and
    its ``cost`` (the wrapper's module's ``cost`` of the call's shapes:
    ``flops``, ``bytes`` and, for K3, ``exps``), added into the tally's
    summed cost (``traced_cost``). A launch is a ctypes call the dispatch
    modes of a trace never see, so this is how a window's count
    (``roofline/cost.py``) includes its kernels. Returns ``cost``."""
    counts = getattr(_TRACED, "counts", None)
    if counts is None:
        counts = _TRACED.counts = {}
    counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
    total = getattr(_TRACED, "cost", None)
    if total is None:
        total = _TRACED.cost = {}
    for k, v in cost.items():
        total[k] = total.get(k, 0) + v
    return cost


def traced_counts(reset: bool = False) -> dict:
    """The kernel calls the calling thread made on traced tensors, by
    kernel name (``reset``: start a new tally after reading it)."""
    counts = dict(getattr(_TRACED, "counts", {}))
    if reset:
        _TRACED.counts = {}
    return counts


def traced_cost(reset: bool = False) -> dict:
    """The summed cost of the kernel calls the calling thread made on
    traced tensors (``reset``: start a new sum after reading it)."""
    cost = dict(getattr(_TRACED, "cost", {}))
    if reset:
        _TRACED.cost = {}
    return cost


def nbytes(*tensors) -> int:
    """The bytes of ``tensors``, each counted once as it lies (numel x
    element size)."""
    return sum(t.numel() * t.element_size() for t in tensors)


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
