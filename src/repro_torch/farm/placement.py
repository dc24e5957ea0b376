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
job's work. The dispatcher thread is the seat's too (``take_seat``,
made at first use and kept by slot name): cuBLAS keeps one workspace per
(thread handle, stream) pair, and a thread made per farm run takes
whichever pooled handle a finished one returned, so each run could pair
a seat's stream with a new handle and leave another 32 MiB workspace
behind (10 consecutive async passes of glm4-9b's 40 boards on 8 seats
grew by 1.64 GB on an H100). A seat's one thread and one stream keep one
workspace per seat for the life of the process. A farm's loop holds its
seat for the length of a run (``take_seat``); a farm that finds a seat
still held by another farm's loop is refused, and a loop that outlives
its farm's run retires the seat's thread (``retire_seat_thread``).
"""
from __future__ import annotations

import atexit
import dataclasses
import queue as queue_mod
import threading
import traceback
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


class SeatThread(threading.Thread):
    """A seat's long-lived dispatcher thread: runs the callables put on
    ``tasks`` one after another, for the life of the process unless
    :func:`retire_seat_thread` retires it (a seat the farm wrote off as
    hung: the thread leaves after the task it is stuck in returns). A
    task that raises ends that task only, as a thread that died would
    end its work; the traceback goes to stderr. ``holder`` is the
    dispatcher loop that has the seat (:func:`take_seat`), None when
    the seat is free."""

    def __init__(self, name: str):
        super().__init__(name=f"farm-{name}", daemon=True)
        self.tasks: queue_mod.Queue = queue_mod.Queue()
        self.retired = False
        self.holder = None

    def run(self):
        while not self.retired:
            task = self.tasks.get()
            try:
                task()
            except BaseException:   # noqa: BLE001 — the task's death,
                traceback.print_exc()   # not the seat's


_SEATS: Dict[tuple, SeatThread] = {}        # (name, device) -> thread
_SEATS_LOCK = threading.Lock()


def _seat_key(slot: DeviceSlot) -> tuple:
    device = torch.device(slot.device)
    return (slot.name, device.type, device.index)


def take_seat(slot: DeviceSlot, holder) -> Optional[SeatThread]:
    """Give the slot's dispatcher thread to ``holder`` (a loop with
    ``is_alive()``) and return it: the thread is started at the seat's
    first use and kept for the process (a farm's slots of the same name
    on the same device share it across runs), or a new one where the
    last was retired. Returns None, taking nothing, while the seat's
    last holder is alive: another farm's loop still runs on it."""
    key = _seat_key(slot)
    with _SEATS_LOCK:
        t = _SEATS.get(key)
        if t is None:
            t = _SEATS[key] = SeatThread(slot.name)
            t.start()
        if t.holder is not None and t.holder.is_alive():
            return None
        t.holder = holder
        return t


def release_seat(t: SeatThread, holder):
    """``holder``'s loop has ended: the seat is free again."""
    with _SEATS_LOCK:
        if t.holder is holder:
            t.holder = None


def _retire(t: SeatThread):
    t.retired = True
    t.tasks.put(lambda: None)       # wake it if it is idle


def retire_seat_thread(slot: DeviceSlot, holder=None):
    """Retire the slot's thread (it may be stuck in a hung board; with
    ``holder``, only while that loop has the seat): the next
    :func:`take_seat` for the seat starts a new one, and the old one
    leaves once its current task returns."""
    key = _seat_key(slot)
    with _SEATS_LOCK:
        t = _SEATS.get(key)
        if t is None or (holder is not None and t.holder is not holder):
            return
        del _SEATS[key]
    _retire(t)


@atexit.register
def _retire_all_seats(timeout_s: float = 5.0):
    """At interpreter exit: every idle seat thread leaves and is joined,
    so none is left waiting while the interpreter tears down (a thread
    stuck in a hung board stays a daemon)."""
    with _SEATS_LOCK:
        seats = list(_SEATS.values())
        _SEATS.clear()
    for t in seats:
        _retire(t)
    for t in seats:
        t.join(timeout=timeout_s)


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
