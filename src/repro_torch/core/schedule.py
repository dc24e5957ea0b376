"""The window scheduler: one host loop for every P-Shell client.

The scheduler owns window pipelining (the FireSim lesson: keep the device
busy while the host lags):

  * batch stacking — each window's per-step items are stacked into one
    (g, ...) payload per leaf;
  * one dispatch per clock-gated window — the *engine* is any
    ``(state, shell, batch_stack) -> (state, shell_snapshot, ys)``
    callable;
  * double-buffered shell + overlapped drain — in ``overlap`` mode the
    window's output shell is kept aside as a drain snapshot while
    ``reset`` (``pshell.group_reset``) hands the next window a fresh
    shell. Right after the dispatch the snapshot and ys are queued for
    non-blocking copies into pinned host buffers, behind the window's own
    kernels, and a CUDA event is recorded. The drain of window *i* waits
    on that event only, so it runs while window *i+1*'s kernels are queued
    on the device. (A plain blocking ``.cpu()`` at the drain would queue
    behind window *i+1* on the one stream and silently serialise the
    pipeline.)
  * tail windows — a step count not divisible by the interval yields a
    final smaller window, executed and drained exactly once;
  * barrier points — a ``DrainBarrier`` forces the in-flight window to be
    drained and ACCEPTED by the host before its action runs.

Engines may update the model state in place (the reference donates it),
never the shell: the snapshot must survive until its deferred drain.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Any, Callable, Iterable, List, Optional, Sequence

import torch

from repro_torch.core.pshell import drain as shell_drain
from repro_torch.core.pshell import group_reset, stack_batches
from repro_torch.core.scope import as_plane
from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One clock-gated window: ``size`` consecutive steps from ``start``."""
    index: int          # window ordinal within the run
    start: int          # global index of the window's first step
    size: int           # steps in this window (the tail window may be short)

    @property
    def last(self) -> int:
        """Global index of the window's last step (the drain cadence id)."""
        return self.start + self.size - 1

    @property
    def boundary(self) -> int:
        """Step count after this window completes."""
        return self.start + self.size


@dataclasses.dataclass(frozen=True)
class DrainBarrier:
    """A host commit point: when a window crosses a multiple of ``every``,
    the scheduler drains that window (in overlap mode this forfeits ONE
    window's drain/compute overlap, no more) so the host has accepted every
    step up to the boundary, then calls ``action(state, boundary_step)``."""
    every: int
    action: Callable[[Any, int], None]

    def fires(self, plan: WindowPlan) -> bool:
        return plan.boundary // self.every > plan.start // self.every


def plan_windows(steps: int, interval: int, start: int = 0) -> List[WindowPlan]:
    """Partition steps [start, steps) into interval-sized windows plus a
    tail, aligned to ``start``."""
    interval = max(1, interval)
    plans = []
    i = start
    while i < steps:
        g = min(interval, steps - i)
        plans.append(WindowPlan(index=len(plans), start=i, size=g))
        i += g
    return plans


def iter_windows(items: Iterable[Any], interval: int):
    """Chunk a finite iterable of per-step items into window-sized lists."""
    interval = max(1, interval)
    buf: list = []
    for x in items:
        buf.append(x)
        if len(buf) == interval:
            yield buf
            buf = []
    if buf:
        yield buf


class _NullTimer:
    @contextmanager
    def phase(self, name: str):
        yield


def _to_host(tree):
    """Queue non-blocking copies of a tree's device tensors into fresh
    pinned host buffers on the current stream; returns (host_tree, event).
    The event completes when the copies have; host tensors pass through
    (with no event)."""
    leaves = [t for t in tree_leaves(tree) if torch.is_tensor(t)]
    if not any(t.is_cuda for t in leaves):
        return tree, None

    def copy(t):
        if not (torch.is_tensor(t) and t.is_cuda):
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    host = tree_map(copy, tree)
    event = torch.cuda.Event()
    event.record()
    return host, event


class WindowScheduler:
    """Owns the host loop shared by the port's P-Shell clients.

    Parameters
    ----------
    interval : the clock-gating granularity (steps per window) — used only
        by :meth:`windows`; ``run`` consumes whatever window lists it is
        given.
    overlap : double-buffer the shell and defer each window's drain until
        the next window has been dispatched. ``False`` drains serially in
        place.
    reset : device-side shell reset deriving the NEXT window's shell from
        the current snapshot (``pshell.group_reset`` by default whenever
        overlapping with the P-Shell ``drain_fn``). Explicit ``None`` +
        ``drain_fn=None`` passes the snapshot through (shell-less clients).
    drain_fn : host-side ``shell -> (records, reset_shell)``; ``None``
        for clients whose results ride entirely in ``ys``.
    stack_fn : stacks a window's item list into the engine payload;
        ``None`` hands the engine the raw item list.
    timer : object with a ``phase(name)`` context manager: "data" = window
        assembly, "device" = the dispatch (engine call, shell reset and the
        queued host copies: nothing in it may wait on the device), "host" =
        drains and barriers.
    """

    def __init__(self, interval: int = 1, *, overlap: bool = True,
                 reset: Optional[Callable] = None,
                 drain_fn: Optional[Callable] = shell_drain,
                 stack_fn: Optional[Callable] = stack_batches,
                 timer: Any = None):
        self.interval = max(1, interval)
        self.overlap = overlap
        if overlap and reset is None and drain_fn is not None:
            if drain_fn is shell_drain:
                reset = group_reset
            else:
                raise ValueError(
                    "overlap=True with a drain_fn needs a device-side "
                    "`reset` to double-buffer the shell — without one the "
                    "un-reset snapshot becomes the live shell and every "
                    "drain re-reads prior windows' rows (pass reset=, or "
                    "an explicit identity lambda for non-accumulating "
                    "shells)")
        self.reset = reset
        self.drain_fn = drain_fn
        self.stack_fn = stack_fn
        self.timer = timer if timer is not None else _NullTimer()

    def windows(self, items: Iterable[Any]):
        return iter_windows(items, self.interval)

    def run(self, engine, windows, state, shell, *, start_step: int = 0,
            on_drain: Optional[Callable] = None,
            on_dispatch: Optional[Callable] = None,
            on_window: Optional[Callable] = None,
            barriers: Sequence[DrainBarrier] = (),
            scope: Any = None):
        """Drive ``engine`` over ``windows`` (an iterable of per-step item
        lists). Returns ``(state, last_ys, shell)``. ``start_step`` is the
        global index of the first window's first step (a resumed run):
        plans, drain ids and barrier boundaries count from it.

        Callbacks: ``on_dispatch(plan, state)`` fires right after a
        window's dispatch is enqueued; ``on_drain(plan, records, ys)`` fires
        once per window in window order with the drained shell records and
        the window's ys as host tensors — raising here vetoes any barrier
        commit that depends on the window; ``on_window(plan, state)`` fires
        after the window's host phase (profiler step accounting).

        ``scope`` (a ``ScopeSpec`` or ``ScopePlane``) opts the pass into
        the ZP-Scope plane (``core/scope.py``): device counters ride
        beside the shell, and the plane samples them at its read rate
        from the drained snapshot (on the overlapped path, from the host
        copy queued above, so the plane adds no host sync). The returned
        state, ys and shell are bit-identical to an un-instrumented pass
        (``plane.finalize`` unwraps the composite shell before return).
        """
        timer = self.timer
        drain_fn, reset = self.drain_fn, self.reset
        plane = None
        if scope is not None:
            plane = as_plane(scope)
            engine, shell, drain_fn, reset = plane.bind(
                engine, shell, drain_fn, reset)
        pending = None              # (plan, host_snapshot, host_ys, event)
        last_ys = None
        step = start_step
        index = 0
        it = iter(windows)
        while True:
            with timer.phase("data"):
                try:
                    items = next(it)
                except StopIteration:
                    break
                if not items:
                    continue
                stack = self.stack_fn(items) if self.stack_fn else items
            plan = WindowPlan(index=index, start=step, size=len(items))
            with timer.phase("device"):
                state, snap, ys = engine(state, shell, stack)
                if self.overlap:
                    shell = reset(snap) if reset else snap
                    fetched = _to_host((snap, ys))
            if on_dispatch is not None:
                on_dispatch(plan, state)
            with timer.phase("host"):
                if self.overlap:
                    self._flush(pending, on_drain, drain_fn)
                    (host_snap, host_ys), event = fetched
                    pending = (plan, host_snap, host_ys, event)
                else:
                    records, shell = (drain_fn(snap) if drain_fn
                                      is not None else ({}, snap))
                    host_ys, event = _to_host(ys)
                    if event is not None:
                        event.synchronize()
                    self._emit(plan, records, host_ys, on_drain)
                for b in barriers:
                    if b.fires(plan):
                        # commit barrier: every window up to the boundary
                        # must be drained and accepted before the action
                        self._flush(pending, on_drain, drain_fn)
                        pending = None
                        b.action(state, plan.boundary)
            if on_window is not None:
                on_window(plan, state)
            last_ys = ys
            step += len(items)
            index += 1
        with timer.phase("host"):
            self._flush(pending, on_drain, drain_fn)
        if plane is not None:
            shell = plane.finalize(shell)
        return state, last_ys, shell

    def _flush(self, pending, on_drain, drain_fn):
        if pending is None:
            return
        plan, snap, ys, event = pending
        if event is not None:
            event.synchronize()     # this window's copies only
        # the snapshot's reset state is discarded: the live shell was
        # reset on the device
        records = drain_fn(snap)[0] if drain_fn is not None else {}
        self._emit(plan, records, ys, on_drain)

    @staticmethod
    def _emit(plan, records, ys, on_drain):
        if on_drain is not None:
            on_drain(plan, records, ys)
