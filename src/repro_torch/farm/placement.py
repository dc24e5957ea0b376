"""Device placement for the ZP-Farm (the FireSim run-farm mapping step).

A *slot* is one co-emulation seat: a torch device plus a stable name the
watchdog and telemetry key on. On a multi-card host there is one slot per
visible CUDA device (one board per FPGA); on a single card the farm falls
back to ``min_slots`` round-robin VIRTUAL slots sharing that card
(``cuda:0#0``, ``cuda:0#1``, ...), so admission, per-slot heartbeats,
straggler eviction, and requeue all run the same code paths the real farm
runs — the scheduler already interleaves every client's dispatch on one
stream. With ``device="cpu"`` the slots are the host's (``cpu:0#k``, the
tests); no entry point chooses the host on its own.

Jobs are pinned at admission: state and shell are copied onto the slot's
device once, and every window's stacked payload follows through the
scheduler's ``place_fn`` dispatch hook, so a job's working set stays
device-resident across windows (the FASE lesson: never re-upload what the
board already holds). Host tensors travel through pinned memory with
non-blocking copies, so placement never waits on the card.

Streams: a card slot has one CUDA stream of its own for the life of the
process (``slot_stream``, made at first use and kept by slot name), on
which the async farm's dispatcher thread for that slot enqueues all of a
job's work. A stream made once per virtual seat keeps one cuBLAS
workspace per seat, not one per farm run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


@dataclasses.dataclass(frozen=True)
class DeviceSlot:
    """One farm seat: ``name`` is the watchdog/telemetry worker key
    (``cuda:0``, or ``cuda:0#2`` for the third virtual seat of a shared
    card); ``device`` is the backing ``torch.device``; ``lane_capacity``
    is how many identical-arch boards the seat will fuse into one
    lane-batched dispatch stream (1 = solo boards only)."""
    name: str
    device: Any
    index: int
    lane_capacity: int = 1


def enumerate_slots(min_slots: int = 1,
                    devices: Optional[Sequence] = None,
                    lane_capacity: int = 1,
                    device=None) -> List[DeviceSlot]:
    """One slot per device; when the host has fewer devices than
    ``min_slots`` (one card), extra virtual slots round-robin over the
    real devices so every farm code path still runs. ``devices`` defaults
    to every visible CUDA device (``device="cpu"``: the host), and raises
    without a card unless the caller names the host."""
    if devices is None:
        dev = resolve_device(device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    devices = list(devices)
    if not devices:
        raise RuntimeError("no devices to build a farm on")
    n = max(len(devices), min_slots)
    slots = []
    for i in range(n):
        d = torch.device(devices[i % len(devices)])
        base = f"{d.type}:{0 if d.index is None else d.index}"
        name = base if n <= len(devices) else f"{base}#{i // len(devices)}"
        slots.append(DeviceSlot(name=name, device=d, index=i,
                                lane_capacity=max(1, lane_capacity)))
    return slots


_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}   # (name, card) -> stream
_STREAMS_LOCK = threading.Lock()


def slot_stream(slot: DeviceSlot) -> Optional["torch.cuda.Stream"]:
    """The slot's own CUDA stream (``None`` for a host slot), made at its
    first use and kept for the process: a farm's slots of the same name
    on the same card share it across runs."""
    device = torch.device(slot.device)
    if device.type != "cuda":
        return None
    key = (slot.name, device.index)
    with _STREAMS_LOCK:
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=device)
        return _STREAMS[key]


def pick_slot(candidates: Sequence[DeviceSlot], avoid: Optional[str] = None,
              sole_candidate: bool = False) -> Optional[DeviceSlot]:
    """Shared admission pick over an already-filtered (healthy, in-pool,
    under-capacity) candidate list in preference order: the first slot
    that is not the requeue's ``avoid`` seat wins. ``sole_candidate=True``
    relaxes the avoid preference when the pool has only one live slot —
    a single-seat farm has no different seat to wait for."""
    for s in candidates:
        if s.name != avoid:
            return s
    if sole_candidate and candidates:
        return candidates[0]
    return None


def _to_device(x, device):
    """``x`` on ``device``: a tensor already there as it is (no copy, so
    identity-shared leaves stay shared), host data through pinned memory
    with a non-blocking copy; non-array leaves pass through."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if not torch.is_tensor(x):
        return x
    if x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def place(tree, slot: DeviceSlot):
    """Pin a job's state/shell tree onto its slot's device (admission
    time; stays resident across windows)."""
    if tree is None:
        return None
    device = torch.device(slot.device)
    return tree_map(lambda x: _to_device(x, device), tree)


def place_stack(stack, slot: DeviceSlot):
    """Device-aware dispatch hook: move one window's stacked payload onto
    the job's device (``run_many``'s ``place_fn``)."""
    return place(stack, slot)
