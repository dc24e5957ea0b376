"""Watchdogs, heartbeats, straggler detection (DESIGN C8 — ZP-Farm).

The paper's boards carry hardware watchdog timers so a hung DUT can never
take down the farm; the cluster analogue is worker heartbeats with a
checkpoint-restart policy and straggler flagging for 1000+-node runs.
Host-side pure Python; injected clock for deterministic tests. All
channels are lock-protected: in the async farm every slot's dispatcher
thread beats/observes concurrently while the control plane reads.

Two channels per worker, deliberately separate:

  liveness  — ``heartbeat(worker)``: "this worker made progress now".
              Dead-worker detection compares the last beat against
              ``timeout_s``. Under the async farm this is TRUE wall-time
              liveness: each slot thread beats at its own drain
              boundaries, so a hung board stops beating regardless of
              what its neighbors are doing (in the lockstep loop a hung
              board stalled everyone's beats at once).
  duration  — inter-heartbeat gaps (the default) OR explicit
              ``observe(worker, dt)`` samples. The LOCKSTEP host loop
              makes inter-drain gaps the ROUND time — identical for every
              board and useless for telling boards apart — so it observes
              each board's own dispatch duration explicitly and beats with
              ``gap=False``. The ASYNC farm observes each window's
              measured WALL time (dispatch to results-in-hand, taken on
              the slot's own thread), which is the true per-board
              divergence signal the straggler detector keys on. Each
              sample is tagged with the observing thread's name
              (``threads``) so per-thread attribution survives requeues.

A third channel closes the wall-clock-pollution flake class (ZP-Scope):

  work rate — ``observe(worker, dt, work=n)`` records ``dt / n`` seconds
              per DEVICE-SIDE work unit (tokens/steps counted by the
              on-device scope counters over a read-rate interval). Host
              wall alone punishes innocent boards whose windows were
              polluted by co-residence (a neighbor's jit compile, a
              results-queue stall — the ``prewarm`` workaround's reason
              to exist); the work rate amortizes one-off host noise over
              the whole interval and never even records intervals the
              scope tags as quiet (``observe(..., quiet=True)`` — e.g.
              admission/drain stalls where no device work retired).
              ``stragglers`` automatically prefers this channel once
              every sampled worker has work-rate samples.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional


class Watchdog:
    def __init__(self, timeout_s: float, clock: Callable[[], float] = None):
        self.timeout_s = timeout_s
        self.clock = clock or time.monotonic
        self.last_beat: Dict[str, float] = {}
        self.durations: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=64))
        self.work_rates: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=64))   # seconds per device work unit
        self.quiet: Dict[str, int] = defaultdict(int)   # excluded intervals
        self.threads: Dict[str, str] = {}   # worker -> last observing thread
        self._lock = threading.Lock()

    def heartbeat(self, worker: str = "w0", gap: bool = True):
        """Liveness beat. ``gap=True`` (default) also records the gap since
        the worker's previous beat as a duration sample; ``gap=False`` is a
        pure liveness beat for callers that feed durations via
        :meth:`observe` instead (both farm host loops)."""
        now = self.clock()
        with self._lock:
            if gap and worker in self.last_beat:
                self.durations[worker].append(now - self.last_beat[worker])
            self.last_beat[worker] = now
            self.threads[worker] = threading.current_thread().name

    def observe(self, worker: str, duration_s: float, lanes: int = 1,
                work: Optional[float] = None, quiet: bool = False):
        """Record an explicitly measured duration sample (one window's
        dispatch cost in lockstep mode, one window's measured wall in async
        mode) without touching liveness state. Tagged with the calling
        thread's name — in the async farm each worker's samples must all
        come from its own slot thread. ``lanes`` normalizes a lane-batched
        window to per-board cost: a 16-lane dispatch does 16 boards of
        work per window, and must not be flagged as a 16x straggler
        against solo boards on the same fleet.

        ``work`` switches the sample to the device-side WORK-RATE channel:
        ``duration_s`` spanned ``work`` on-device work units (scope
        tokens/steps over a read-rate interval, already summed across
        lanes), recorded as seconds-per-unit — the wall channel is left
        untouched (its per-window samples were observed as they
        happened). ``quiet=True`` records NOTHING but the exclusion
        count: the scope tagged the interval quiet (no device work
        retired — an admission/drain stall, not board slowness), so it
        must not enter any straggler statistic."""
        with self._lock:
            self.threads[worker] = threading.current_thread().name
            if quiet:
                self.quiet[worker] += 1
                return
            if work is not None:
                if work > 0:
                    self.work_rates[worker].append(duration_s / work)
                return
            self.durations[worker].append(duration_s / max(1, lanes))

    def forget(self, worker: str):
        """Drop a worker's history. Eviction/requeue: the slot's next
        tenant must not inherit the evicted straggler's durations (it
        would be flagged on arrival)."""
        with self._lock:
            self.last_beat.pop(worker, None)
            self.durations.pop(worker, None)
            self.work_rates.pop(worker, None)
            self.quiet.pop(worker, None)
            self.threads.pop(worker, None)

    def dead_workers(self) -> List[str]:
        now = self.clock()
        with self._lock:
            return [w for w, t in self.last_beat.items()
                    if now - t > self.timeout_s]

    def stragglers(self, factor: float = 2.0, min_fleet: int = 2,
                   min_s: float = 0.0, channel: str = "auto") -> List[str]:
        """Workers whose median duration exceeds ``factor`` x the fleet
        reference.

        Semantics (the ZP-Farm eviction contract):
          * a worker with NO duration samples (at most one gap-heartbeat
            ever, no ``observe`` calls) cannot be judged and is never
            flagged — absence of evidence is not slowness;
          * straggling is RELATIVE: with fewer than ``min_fleet`` sampled
            workers there is no fleet to compare against, so the answer is
            [] (a single worker is never a straggler of itself — use
            ``dead_workers`` for absolute hang detection);
          * the fleet reference is the LOWER median of per-worker medians:
            with an even worker count the upper median would let a dominant
            straggler drag the reference up and mask itself (in a
            two-worker farm the upper median IS the straggler, making
            detection impossible);
          * ``min_s`` is an absolute floor: a worker whose median is below
            it is never flagged, however large the RATIO — sub-millisecond
            dispatch costs are all timer jitter, and evicting a board that
            answers in microseconds buys nothing. The floor is always
            judged on the WALL scale (a worker's wall median), whichever
            channel the ratio used — a seconds-per-token rate has no
            meaningful absolute floor.

        ``channel`` selects the statistic the RATIO is computed on:
        ``"wall"`` = per-window host wall (the legacy signal), ``"work"``
        = device-side seconds-per-work-unit (ZP-Scope counters),
        ``"auto"`` (default) = work rates once EVERY wall-sampled worker
        also has work-rate samples, wall otherwise — a mixed fleet (some
        boards scoped, some not) can't be compared across units, so it
        stays on wall until the scope coverage is total.
        """
        with self._lock:
            wall = {w: sorted(d) for w, d in self.durations.items() if d}
            work = {w: sorted(d) for w, d in self.work_rates.items() if d}
        use_work = channel == "work" or (
            channel == "auto" and work and set(wall) <= set(work))
        samples = work if use_work else wall
        meds = {w: s[len(s) // 2] for w, s in samples.items()}
        if len(meds) < max(2, min_fleet):
            return []
        fleet = sorted(meds.values())[(len(meds) - 1) // 2]
        wall_meds = {w: s[len(s) // 2] for w, s in wall.items()}
        out = []
        for w, m in meds.items():
            if m <= factor * fleet:
                continue
            # min_s floor on the wall scale; a work-rate-only worker has
            # no wall median to gate on and passes (no evidence of being
            # microsecond-fast either)
            if w in wall_meds and wall_meds[w] < min_s:
                continue
            out.append(w)
        return out

    def should_restart(self) -> bool:
        return bool(self.dead_workers())
