"""Scheduler-driven roofline capture: MEASURED windows.

A ``WindowCapture`` is an ``on_dispatch``/``on_drain`` callback pair
attachable to any ``WindowScheduler`` client (train, verify, serve, any
farm job) plus an ``on_enqueue`` hook the scheduler holds around each
window's engine call. It records each window's wall time (dispatch to
drain, pipelined) and its device time, and pairs them with the window's
cost (``roofline/cost.py::count_cost``: one call of the engine on fake
tensors, the port's counterpart of the reference's read of XLA's
``cost_analysis``), so every windowed workload emits (cost, measured
time) rows without a harness of its own.

Wall-time semantics under overlap: the drain of window *i* runs after
window *i+1*'s dispatch, so a row's ``wall_s`` is "time until window
*i*'s results were in hand", the honest pipelined number, matching the
serve client's latency definition. Rates derived from it are a LOWER
bound on device throughput.

``device_s`` is the card's time for the window: two ``torch.cuda.Event``
s recorded on the dispatching thread's current stream (a farm slot's own
stream) right before and right after the window's engine call, outside
any graph capture (a capture runs on a side stream), and read at the
window's drain, whose wait already covers the second one: no sync is
added. It spans the stream from the window's first operation to its last,
so for an eager engine it includes the gaps where the card waited for the
host to enqueue (a CUDA-graph window is one replay and has none). On host
tensors there are no events and ``device_s`` is None: no host time goes
under a device key.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.roofline.cost import count_cost
from repro_torch.roofline.hw import HW_H100, Hardware
from repro_torch.utils import tree_leaves


def save_measured(report: Dict[str, Any], arch: str, source: str,
                  out_dir: str = "experiments/measured") -> str:
    """Persist a :meth:`WindowCapture.report` as a measured-windows record
    for ``roofline.report``."""
    d = pathlib.Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{arch}_{source}.json"
    path.write_text(json.dumps({"arch": arch, "source": source, **report},
                               indent=1, default=float))
    return str(path)


def _window_len(stack) -> int:
    for x in tree_leaves(stack):
        shape = getattr(x, "shape", None)
        if shape:
            return int(shape[0])
    return 1


def _card_of(state) -> Optional[torch.device]:
    for x in tree_leaves(state):
        if torch.is_tensor(x):
            return x.device if x.is_cuda else None
    return None


class WindowCapture:
    """Per-window (cost, measured wall time, device time) recorder.

    Attach to a scheduler run with ``sched.run(..., on_enqueue=
    capture.on_enqueue)`` and the :meth:`callbacks` pair (which chains
    with existing hooks), or hand it to a ``FarmJob(capture=...)``: the
    farm fires all three per window and calls :meth:`reset` on eviction,
    so a requeued job's replayed windows are not recorded twice. The
    in-flight stamps and the rows are guarded by a lock: an async farm
    dispatches and drains on a slot thread and resets on the control
    thread.

    Cost attribution: :meth:`attach_cost` counts one window dispatch on
    fake tensors and records the window size it was counted at; every
    window scales linearly by its size. :meth:`attach_engine` counts
    the first window the engine dispatches instead. Without a cost the
    rows still carry their times (cost fields stay None).
    """

    def __init__(self, hw: Hardware = HW_H100,
                 clock: Callable[[], float] = time.perf_counter):
        self.hw = hw
        self.clock = clock
        self.rows: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._t: Dict[int, float] = {}
        self._events: Dict[int, tuple] = {}
        self._cost: Optional[Dict[str, float]] = None
        self._cost_window: int = 0
        self._engine = None             # counted at its first dispatch
        self._scope = None              # ScopePlane, via attach_scope

    def attach_scope(self, plane):
        """Join a ZP-Scope plane's device-side counters to this capture:
        :meth:`report` then carries the scope's counter table next to the
        measured windows."""
        self._scope = plane
        return self

    # ------------------------------------------------------------- cost ---
    def attach_cost(self, engine, state, shell, stack,
                    window_size: Optional[int] = None):
        """Record the per-window cost of ``engine`` on these arguments
        (counted on fakes; ``window_size`` = steps in ``stack``, read
        from its leading axis by default)."""
        self.set_cost(count_cost(engine, state, shell, stack),
                      window_size=(_window_len(stack) if window_size is None
                                   else window_size))
        return self

    def set_cost(self, cost: Dict[str, float], window_size: int = 1):
        self._cost = dict(cost)
        self._cost_window = max(1, window_size)
        return self

    def attach_engine(self, engine):
        """Count the cost on the first window ``engine`` dispatches
        through this capture's :meth:`on_enqueue` (on that window's own
        arguments, before its device time starts; a window dispatched
        through a wrapper around ``engine``, such as a scope plane's, is
        not counted). Returns ``engine`` itself: a ``WindowGraphs`` stays
        one."""
        self._engine = engine
        return engine

    # -------------------------------------------------------- callbacks ---
    @contextlib.contextmanager
    def on_enqueue(self, plan, engine, state, shell, stack):
        """Held around one window's engine call by the scheduler: counts
        the attached engine's cost at its first window, then brackets the
        call with two CUDA events on the current stream where the state
        lies on a card."""
        if self._cost is None and self._engine is not None \
                and engine is self._engine:
            self.set_cost(count_cost(engine, state, shell, stack),
                          window_size=_window_len(stack))
        card = _card_of(state)
        if card is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(card))
        yield
        end.record(torch.cuda.current_stream(card))
        with self._lock:
            self._events[plan.index] = (start, end)

    def on_dispatch(self, plan, state):
        t = self.clock()
        with self._lock:
            self._t[plan.index] = t

    def on_drain(self, plan, records, ys):
        t = self.clock()
        with self._lock:
            t0 = self._t.pop(plan.index, None)
            events = self._events.pop(plan.index, None)
        row: Dict[str, Any] = {
            "window": plan.index, "start": plan.start, "size": plan.size,
            "wall_s": None if t0 is None else t - t0,
            "device_s": None, "flops": None, "bytes": None,
        }
        if events is not None:
            # the drain's wait covered the copies queued after the end
            # event, so both have completed and the read waits for
            # nothing; a drain that copied nothing waits here instead
            if not events[1].query():
                events[1].synchronize()
            row["device_s"] = events[0].elapsed_time(events[1]) / 1e3
        if self._cost is not None:
            scale = plan.size / self._cost_window
            row["flops"] = self._cost["flops"] * scale
            row["bytes"] = self._cost["bytes"] * scale
        with self._lock:
            self.rows.append(row)

    def callbacks(self, on_dispatch: Optional[Callable] = None,
                  on_drain: Optional[Callable] = None):
        """(on_dispatch, on_drain) pair for ``WindowScheduler.run``,
        chained in front of any existing callbacks."""
        def dispatch(plan, state):
            self.on_dispatch(plan, state)
            if on_dispatch is not None:
                on_dispatch(plan, state)

        def drain(plan, records, ys):
            self.on_drain(plan, records, ys)
            if on_drain is not None:
                on_drain(plan, records, ys)

        return dispatch, drain

    def reset(self, upto: Optional[int] = None):
        """Drop in-flight stamps and recorded rows from window ``upto``
        onward (farm eviction: the requeued job resumes at its snapshot
        cursor, so rows for committed windows stay and only the discarded
        tail is re-recorded; ``None`` or 0 clears everything, the full
        replay)."""
        with self._lock:
            if upto:
                self.rows = [r for r in self.rows if r["window"] < upto]
            else:
                self.rows.clear()
            self._t.clear()
            self._events.clear()

    # ----------------------------------------------------------- report ---
    def report(self) -> Dict[str, Any]:
        """Aggregate rows into roofline terms: measured seconds per step,
        achieved flops/bytes rates over the pipelined wall, the fraction
        of the hardware's bf16 and HBM peaks they reach, and the card's
        own time (``device_s``, None where no window was timed on a
        card). ``hlo_flops``/``hlo_bytes`` keep the reference's names for
        the counted cost (``roofline/cost.py``: eager operators and the
        kernels' own costs, not a compiled program's)."""
        with self._lock:
            rows = list(self.rows)
        timed = [r for r in rows if r["wall_s"] is not None]
        wall = sum(r["wall_s"] for r in timed)
        steps = sum(r["size"] for r in timed)
        dev = [r for r in rows if r["device_s"] is not None]
        device_s = sum(r["device_s"] for r in dev) if dev else None
        dev_steps = sum(r["size"] for r in dev)
        out: Dict[str, Any] = {
            "windows": len(rows),
            "steps": sum(r["size"] for r in rows),
            "wall_s": wall,
            "s_per_step": wall / steps if steps else None,
            "device_s": device_s,
            "device_s_per_step": (device_s / dev_steps
                                  if dev and dev_steps else None),
        }
        costed = [r for r in timed if r["flops"] is not None]
        if costed and wall > 0:
            flops = sum(r["flops"] for r in costed)
            bts = sum(r["bytes"] for r in costed)
            cw = sum(r["wall_s"] for r in costed)
            out.update({
                "hlo_flops": flops,
                "hlo_bytes": bts,
                "achieved_flops_s": flops / cw,
                "achieved_bytes_s": bts / cw,
                "peak_flops_fraction": flops / cw / self.hw.peak_flops_bf16,
                "peak_hbm_fraction": bts / cw / self.hw.hbm_bw,
            })
        if self._scope is not None:
            sc = self._scope.report()
            sc.pop("history", None)     # the measured record keeps the
            # counter table, not the per-sample stream
            out["scope"] = sc
        return out
