"""FarmManager: the FireSim-manager analog for multi-device co-emulation.

The paper's end state is a *farm* of scaled-down DUTs — many independently
prototyped subsystems co-emulated concurrently behind one host. This
module is the orchestration layer over the core ``WindowScheduler``
machinery, in two host-loop modes:

  lockstep (``mode="lockstep"``) — ONE Python thread round-robins every
      slot through ``WindowScheduler.run_many``. Deterministic round
      structure, but one slow board's dispatch delays every other board's
      enqueue, and "straggler" is inferred from per-board dispatch cost
      because inter-drain gaps are the round time. Kept as the
      bit-identity ORACLE: the async mode must deliver byte-for-byte the
      same per-job outputs (tests assert it).

  async (``mode="async"``) — the paper's non-interference guarantee made
      real on the host side: each :class:`DeviceSlot` is driven by its own
      dispatcher thread (:class:`_SlotWorker`) with a bounded work queue,
      enqueueing on the slot's own CUDA stream
      (``placement.slot_stream``). The manager becomes an
      admission/eviction CONTROL PLANE: it feeds job assignments into
      slot queues, and each slot thread runs its own ``ClientDriver``
      pipeline (dispatch window *i+1* while draining window *i*), posting
      completed drains back over a results queue. A slow board slows only
      itself; the watchdog's straggler signal becomes measured per-window
      WALL time, and liveness heartbeats become true wall-time liveness
      (a hung board is abandoned and its job requeued, without taking
      down the farm).

Threading invariants:

  * ALL device interactions for a job — state/shell placement, window
    stacking, engine dispatch, shell reset, drain fetch, ``verify`` — stay
    on its slot's thread and stream (the ``ClientDriver`` is
    thread-confined). A slot stream first waits, by an event recorded at
    assignment, for the control thread's stream, which made the job's
    inputs (weights, captured activations, lane stacks); the slot thread
    synchronises its stream before it posts a run's end, so the results
    it hands over are complete before the control thread reads or frees
    them. Slot threads run under the control thread's autograd mode
    (``torch.inference_mode`` and grad mode are thread-local);
  * the control plane ingests outputs only at results-queue hand-off
    points, and the user-facing ``on_drain`` sink fires exactly-once, in
    window order, on the CONTROL thread after the job completes — so a
    stateful collector never sees concurrent or replayed windows;
  * eviction is signalled via a per-run flag that the slot thread checks
    at drain boundaries (between windows, never mid-dispatch), so a
    cancelled job's in-flight window is discarded, never delivered.

Semantics (both modes):

  * a job queue of :class:`FarmJob`\\ s — an engine + a replayable window
    stream + an expected-output verifier + optional per-job checkpoint
    ``DrainBarrier``\\ s (barrier actions are vetoed while the job has a
    recorded fault, so a checkpoint never publishes past a rejected
    window);
  * dynamic admission when a slot frees; requeue onto a DIFFERENT slot
    after eviction, so an evicted job's delivered outputs are
    bit-identical to an uninterrupted run;
  * checkpointed requeue (the paper's stop/inspect/resume contract at farm
    scale): every ACCEPTED barrier commit publishes a host-side job
    snapshot — engine carry, live shell, window/step cursor, and the
    verifier's oracle position — through the checkpoint store's atomic
    publish path (``MemorySnapshotStore`` by default, ``FarmJob.
    snapshot_store`` for on-disk). A requeued job restores the snapshot
    onto its NEW slot and resumes its window plan at the cursor instead of
    replaying from window 0; delivered windows before the cursor are
    retained, so the exactly-once ``on_drain`` sink still sees every
    window once, in order. A vetoed commit publishes NOTHING — a faulted
    attempt resumes from the barrier *before* the rejected window; a
    snapshot that fails its content digest falls back to the newest older
    verifiable one, or to window 0;
  * drain-veto fault handling — a job's ``verify`` raising at a drain
    counts a veto, faults the job, and takes the same evict + requeue
    path (a board whose outputs are wrong is as evictable as a slow one);
  * lanes — queued jobs sharing a ``lane_key`` (and
    :func:`lane_compatible`) coalesce into ONE vmap-fused run of up to the
    slot's lane capacity, with per-lane verify fan-out, per-lane
    snapshots, and lane-granular eviction (a vetoed lane requeues solo
    while the surviving lanes keep running);
  * ZP-Scope — ``FarmJob.scope`` opts a job into the instrumentation
    plane (``core/scope.py``); its samples land in telemetry and in the
    watchdog's device-side work-rate channel.

Failure-policy layer (``FarmManager(policy=FailurePolicy(...))`` — the
ZP-Chaos hardening; ``policy=None`` keeps the raise-on-failure semantics
exactly):

  * retry budgets + backoff — a failed attempt re-enters the queue only
    after an exponential backoff (``FarmJob.not_before``), so a crashing
    board cannot hot-loop through the farm's admission machinery;
  * quarantine / dead-letter — a job that exhausts its budget is
    QUARANTINED, not raised: the farm completes every other job and the
    report carries the dead-lettered ones;
  * slot circuit breaker — per-slot health scoring over the last
    ``breaker_window`` runs; a slot failing ``breaker_threshold`` of them
    is BENCHED (excluded from placement), then probed with a canary and
    only re-admitted after the canary passes;
  * graceful shutdown — ``request_shutdown()`` stops admission, cuts
    every running job at its next drain boundary (committed prefixes and
    published snapshots are kept), marks the cut jobs ``interrupted``,
    and lets ``run()`` return with the report intact (the SIGINT path in
    ``launch.farm``).

Deterministic fault injection (``repro_torch.farm.chaos``) threads
through the named points ``slot.dispatch`` / ``slot.drain`` /
``slot.commit`` (via ``ClientDriver``'s inject hook), ``worker.loop`` /
``slot.canary`` / ``results.post`` (the slot worker), and
``snapshot.publish`` — every fault the policy layer absorbs is
reproducible from a seed.

ZP-Ledger (``FarmManager(ledger=FarmLedger(dir))``, ``farm/ledger.py``):
every control-plane decision is journaled (fsync'd) at the reference's
points, committed windows are delivered to ``on_drain`` as their commits
land (``_deliver_upto``), and ``FarmManager.recover`` rebuilds a farm
from its journal after whole-process death: each job from its journaled
``JobSpec`` (``submit_spec``), resumed from the newest on-disk snapshot
``choose_resume`` accepts, with the windows the dead process delivered
suppressed — ``on_drain`` stays exactly-once across process lifetimes.
Each journal call fires the ``ledger.<kind>`` injection point after its
record is on disk (the chaos ``process_kill`` target).

What waits for a later slice raises NotImplementedError naming it:
``certify=True`` (ZP-Cert), ``FarmJob.capture`` (the measured-window
roofline).

The port's engines may update their state in place, so every attempt
dispatches from fresh copies of ``FarmJob.state``/``shell`` (or from
zero-arg factories), and snapshots are host copies: the job's own trees
stay valid replay sources across requeues.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue as queue_mod
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.annotations import any_thread, control_thread_only
from repro_torch.checkpoint.manager import MemorySnapshotStore
from repro_torch.core import scope as zp_scope
from repro_torch.core.pshell import drain as _shell_drain
from repro_torch.core.schedule import (Client, ClientPolicy, DrainBarrier,
                                       LaneBatch, WindowScheduler)
from repro_torch.core.watchdog import Watchdog
from repro_torch.farm.placement import (DeviceSlot, enumerate_slots,
                                        pick_slot, place, place_stack,
                                        release_seat, retire_seat_thread,
                                        slot_stream, take_seat)
from repro_torch.farm.ledger import choose_resume
from repro_torch.farm.registry import JobSpec
from repro_torch.farm.telemetry import FarmTelemetry
from repro_torch.utils import resolve_device, tree_leaves, tree_map, \
    tree_structure

class FarmError(RuntimeError):
    pass


def _slot_context(slot: DeviceSlot):
    """The slot's stream as the current stream (its card as the current
    device); nothing for a host slot."""
    stream = slot_stream(slot)
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _default_canary(slot: DeviceSlot):
    """The stock circuit-breaker probe: one tiny round trip through the
    slot's device and stream — placement, compute, fetch — raising if the
    seat cannot even do that. Jobs only re-land on a benched slot after
    this (or ``FailurePolicy.canary``) passes."""
    with _slot_context(slot):
        x = torch.arange(8, dtype=torch.float32, device=slot.device)
        y = float((x * 2.0).sum())
    if y != 56.0:
        raise FarmError(f"canary miscomputed on {slot.name}: {y}")


@dataclasses.dataclass(frozen=True)
class FailurePolicy:
    """The farm's failure-handling contract (pass to ``FarmManager``;
    ``None`` keeps the raise-on-failure semantics).

    ``max_retries``  — per-job retry budget override (``None`` = each
        job's own ``max_requeues``).
    ``backoff_base_s`` / ``backoff_factor`` / ``backoff_max_s`` —
        exponential backoff before a failed attempt re-enters admission:
        retry *n* waits ``min(base * factor**(n-1), max)`` seconds
        (``base=0`` disables the wait).
    ``quarantine``   — dead-letter jobs that exhaust their budget instead
        of failing the farm: the run completes, the report carries them.
    ``breaker_window`` / ``breaker_threshold`` — a slot accumulating
        ``threshold`` failed runs within its last ``window`` runs trips
        its circuit breaker and is benched.
    ``breaker_cooldown_s`` — wait before probing a benched slot.
    ``breaker_max_probes`` — consecutive canary failures after which a
        benched slot is written off entirely (leaves the pool).
    ``canary``       — ``fn(slot)`` probe dispatched to a benched slot;
        raising = still broken. ``None`` = :func:`_default_canary`.
    """
    max_retries: Optional[int] = None
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    quarantine: bool = True
    breaker_window: int = 6
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.0
    breaker_max_probes: int = 50
    canary: Optional[Callable[[DeviceSlot], None]] = None

    def backoff_for(self, attempt: int) -> float:
        if self.backoff_base_s <= 0:
            return 0.0
        return min(self.backoff_max_s,
                   self.backoff_base_s
                   * self.backoff_factor ** max(0, attempt - 1))


@dataclasses.dataclass(frozen=True)
class JobSnapshot:
    """Resume cursor of a job's last ACCEPTED barrier commit. The payload
    (state/shell/verifier host copies) lives in the job's snapshot store
    under ``step``; this handle carries only where the stream resumes:
    windows ``[0, window)`` / steps ``[0, step)`` are committed."""
    step: int
    window: int


def _replay_copy(tree):
    """Fresh-buffer copy of a state/shell tree. An engine may update the
    tensors it is handed in place, so every farm attempt must dispatch
    from copies — the job's own ``state``/``shell`` stay valid replay
    sources across requeues."""
    return tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, tree)


def _skeleton(tree):
    """A snapshot tree's restore target (``like``) for the checkpoint
    stores: each leaf as a meta-device tensor of the shape and dtype the
    store keeps it in (a host tensor; numpy and Python scalars become
    0-d tensors), so a restore lands on the host with its shapes and
    dtypes checked."""
    def meta(x):
        if x is None:
            return None
        t = x if torch.is_tensor(x) else torch.as_tensor(np.array(x))
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return tree_map(meta, tree)


def _lane_shape(tree):
    """(structure, leaf shapes) signature used to decide whether two
    jobs' states/shells pack into one lane batch; ``None`` for
    factories."""
    if callable(tree):
        return None
    return tree_structure(tree), tuple(
        tuple(x.shape) if torch.is_tensor(x) else np.shape(x)
        for x in tree_leaves(tree))


def lane_compatible(a: "FarmJob", b: "FarmJob") -> Optional[str]:
    """``None`` if ``b`` can ride in the same :class:`LaneBatch` as ``a``,
    else the reason it cannot (the coalescer then leaves ``b`` queued for
    its own — possibly solo — dispatch). The rules are exactly the fused
    execution's requirements: one shared engine object, identical
    scheduler plumbing, step-for-step zippable window streams, matching
    barrier cadences, stackable state/shell trees, and a fresh stream on
    both sides (a mid-stream resume has a solo cursor to honor)."""
    if a.lane_key is None or a.lane_key != b.lane_key:
        return "lane_key"
    if b.engine is not a.engine:
        return "engine"
    if a.stack_fn is None or b.stack_fn is not a.stack_fn:
        return "stack_fn"
    if b.drain_fn is not a.drain_fn or b.reset is not a.reset:
        return "shell plumbing"
    if a.scope != b.scope:
        return "scope spec"     # one plane instruments the whole fused run
    if a.drain_fn is not None and a.reset is None \
            and a.drain_fn is not _shell_drain:
        return "drain_fn without reset"     # fused drains are deferred
    if a.snapshot is not None or b.snapshot is not None \
            or a.committed_outputs or b.committed_outputs \
            or a.windows_delivered or b.windows_delivered:
        return "mid-stream resume"
    if callable(a.state) or callable(b.state) \
            or callable(a.shell) or callable(b.shell):
        return "state factory"
    if not isinstance(a.windows, list) or not isinstance(b.windows, list):
        return "window stream not a list"
    if len(a.windows) != len(b.windows) or any(
            len(x) != len(y) for x, y in zip(a.windows, b.windows)):
        return "window shape"
    if tuple(x.every for x in a.barriers) \
            != tuple(x.every for x in b.barriers):
        return "barrier cadence"
    if _lane_shape(a.state) != _lane_shape(b.state) \
            or _lane_shape(a.shell) != _lane_shape(b.shell):
        return "state/shell shape"
    return None


@dataclasses.dataclass
class FarmJob:
    """One farm workload. ``windows`` is a list of per-step item lists (or
    a zero-arg factory returning a fresh iterable — required if the stream
    cannot be materialized) so a requeued attempt can re-read it from its
    resume cursor.
    ``verify(plan, records, ys)`` raises to veto a window (stateless — it
    re-runs on replay; in async mode it runs on the job's slot thread);
    ``on_drain(plan, records, ys)`` is the exactly-once, in-order sink
    delivered at completion on the control thread. ``barriers`` are
    per-job :class:`DrainBarrier`\\ s (e.g. checkpoint saves) whose
    actions are skipped while the job has a recorded fault — the
    commit-veto contract; every ACCEPTED commit also publishes a resume
    snapshot to ``snapshot_store`` (``None`` = an in-memory
    :class:`~repro_torch.checkpoint.MemorySnapshotStore`; pass a per-job
    ``CheckpointManager`` for on-disk durability). ``verify`` may expose
    ``snapshot()``/``restore(snap)`` (the ``CommitStreamVerifier``
    protocol) to ride the same resume point. ``drain_fn`` / ``stack_fn``
    / ``reset`` are the per-client scheduler plumbing (``None`` =
    shell-less). ``spec`` is the registry's ``JobSpec`` the job was built
    from (``submit_spec``); ``capture`` (the roofline's
    ``WindowCapture``) is refused at submit until the roofline slice."""
    name: str
    engine: Callable
    windows: Any
    state: Any = None
    shell: Any = None
    verify: Optional[Callable] = None
    on_drain: Optional[Callable] = None
    drain_fn: Optional[Callable] = None
    stack_fn: Optional[Callable] = None
    reset: Optional[Callable] = None
    barriers: Sequence[DrainBarrier] = ()
    capture: Any = None                 # roofline.WindowCapture (refused)
    max_requeues: int = 1
    snapshot_store: Any = None          # CheckpointManager-like, per job
    lane_key: Optional[str] = None      # non-None: coalescible with same-key
    # jobs into ONE lane-batched (vmap-fused) run on a lane-capable slot
    scope: Any = None                   # ScopeSpec: opt into the ZP-Scope
    # instrumentation plane (per-attempt counters; restart on requeue)
    spec: Any = None                    # registry.JobSpec this job was
    # built from; journaled at submit so FarmManager.recover can rebuild
    # it after a process death

    # ----- runtime bookkeeping (owned by the manager) -----
    requeues: int = dataclasses.field(default=0, init=False)
    attempts: int = dataclasses.field(default=0, init=False)
    status: str = dataclasses.field(default="queued", init=False)
    error: Optional[str] = dataclasses.field(default=None, init=False)
    last_slot: Optional[str] = dataclasses.field(default=None, init=False)
    windows_drained: int = dataclasses.field(default=0, init=False)
    snapshot: Optional[JobSnapshot] = dataclasses.field(
        default=None, init=False)       # last accepted commit's cursor
    windows_replayed: int = dataclasses.field(default=0, init=False)
    not_before: float = dataclasses.field(default=0.0, init=False)
    # ^ backoff gate: a requeued job is not re-admitted before this time
    committed_outputs: List = dataclasses.field(
        default_factory=list, init=False)   # committed windows from _base:
    # committed_outputs[i] is window (_base + i)
    windows_delivered: int = dataclasses.field(default=0, init=False)
    # ^ exactly-once on_drain cursor: windows [0, windows_delivered) have
    # been handed to the sink (this process OR, after recover(), a dead
    # predecessor process — seeded from the journal)
    _base: int = dataclasses.field(default=0, init=False)
    # ^ recovery resume base: windows [0, _base) were committed by a dead
    # predecessor process and are not in committed_outputs (0 otherwise)
    _snap_like: Any = dataclasses.field(default=None, init=False)
    # ^ the snapshot store's restore target (meta-device skeleton)
    _verify_init: Any = dataclasses.field(default=None, init=False)

    def _window_iter(self):
        w = self.windows() if callable(self.windows) else self.windows
        return iter(w)

    def _initial(self, attr):
        v = getattr(self, attr)
        return v() if callable(v) else _replay_copy(v)


class _Run:
    """One admission of a job onto a slot (client index ``idx``). In async
    mode the slot thread owns everything here until it posts a terminal
    message; after ``closed`` is set by the control plane, late messages
    and callbacks from a stale (abandoned) thread are ignored."""

    def __init__(self, job: FarmJob, slot: DeviceSlot, idx: int,
                 t_assigned: float = 0.0):
        self.job = job
        self.slot = slot
        self.idx = idx
        self.t_assigned = t_assigned
        self.outputs: List = []
        self.fault: Optional[BaseException] = None
        self.evict_flag = threading.Event()
        self.evict_why: Optional[str] = None
        self.closed = False
        self.ready = None               # CUDA event: the inputs are made
        self.start_window = 0           # resume cursor this attempt began at
        self.snapshot: Optional[JobSnapshot] = None     # latest commit here
        # ----- ZP-Scope (per-attempt; counters restart on requeue) -----
        self.scope_plane = None         # bound ScopePlane, if job.scope
        self.scope_wall_acc = 0.0       # wall accumulated since last sample
        self.scope_first = True         # first sample carries warm-up
        # ----- lane-batched (fused) runs only -----
        self.lanes: Optional[List[FarmJob]] = None      # member jobs
        self.lane_batch = None                          # the LaneBatch
        self.lane_outputs: Optional[List[List]] = None  # per-lane drains
        self.lane_faults: Dict[int, BaseException] = {}  # lane -> veto
        self.lane_detached: set = set()                 # lanes requeued solo

    @property
    def lane_count(self) -> int:
        return len(self.lanes) if self.lanes else 1


_STOP = object()


@dataclasses.dataclass(frozen=True)
class _Canary:
    """Circuit-breaker probe task for one benched slot's worker thread."""
    slot: DeviceSlot


class _SlotWorker:
    """One device slot's dispatcher loop for one farm run: pulls job
    assignments off a bounded work queue and drives each through a
    thread-confined ``ClientDriver`` pipeline (dispatch window *i+1* while
    draining window *i*) on the slot's own stream. Every device
    interaction for the job happens HERE; the control plane only ever
    sees completed drains and terminal messages on the results queue.

    The loop runs on the seat's own thread (``placement.take_seat``,
    kept for the process like the seat's stream: a thread per run would
    leave a cuBLAS workspace per new handle and stream pair behind), under
    the autograd mode ``modes`` = (inference mode, grad mode) of the
    control thread that started it. ``start`` takes the seat and raises
    ``FarmError`` while another farm's loop holds it;
    ``join``/``is_alive`` are a thread's, for the loop."""

    def __init__(self, mgr: "FarmManager", slot: DeviceSlot, depth: int,
                 modes):
        self.mgr = mgr
        self.slot = slot
        self.stream = slot_stream(slot)
        self.modes = modes
        self.inbox: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
        self._idle_since: Optional[float] = None
        self._started = False
        self._ended = threading.Event()

    def start(self):
        self._started = True            # alive from the moment it holds
        seat = take_seat(self.slot, self)
        if seat is None:
            self._started = False
            raise FarmError(
                f"seat {self.slot.name} on {self.slot.device} is held by "
                f"another farm's dispatcher loop, which has not ended")
        self._seat = seat
        seat.tasks.put(self.run)

    def stop(self):
        """End the loop once its current task returns. What is still
        queued is dropped (at the end of a farm run only a canary the run
        no longer needs): a loop left waiting on its inbox would hold the
        seat's thread, which later farms share."""
        while True:
            try:
                self.inbox.get_nowait()
            except queue_mod.Empty:
                break
        self.inbox.put_nowait(_STOP)

    def join(self, timeout: Optional[float] = None):
        self._ended.wait(timeout)

    def is_alive(self) -> bool:
        return self._started and not self._ended.is_set()

    def run(self):
        inference, grad = self.modes
        try:
            with torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad), _slot_context(self.slot):
                while True:
                    task = self.inbox.get()
                    if task is _STOP:
                        return
                    if isinstance(task, _Canary):
                        self._canary()
                        continue
                    # worker.loop: an injected raise here ends the slot's
                    # loop, as a dead thread would (no crash message ever
                    # posts) — the liveness watchdog is the only thing
                    # that can notice, exactly the failure it exists for
                    self.mgr._inject("worker.loop", slot=self.slot.name,
                                     job=task.job.name)
                    self._drive(task)
        finally:
            # a finished worker lets go of its farm: the manager holds its
            # workers, so the pair would otherwise be a reference cycle
            # that keeps a pass's results alive until the collector runs
            self.mgr = None
            self._ended.set()
            release_seat(self._seat, self)

    def _sync(self):
        """Wait for the slot's stream: what the thread hands over next
        (a run's results, or its end) is complete on the card."""
        if self.stream is not None:
            self.stream.synchronize()

    def _canary(self):
        """Run the breaker probe on the slot's own thread (the same thread
        confinement real jobs get) and post the verdict."""
        mgr = self.mgr
        mgr.wd.heartbeat(self.slot.name, gap=False)
        try:
            mgr._inject("slot.canary", slot=self.slot.name)
            fn = ((mgr.policy.canary if mgr.policy else None)
                  or _default_canary)
            fn(self.slot)
            mgr._results.put(("canary", self.slot.name, True, None))
        except BaseException as e:  # noqa: BLE001 — verdict, not crash
            mgr._results.put(("canary", self.slot.name, False, e))

    # ------------------------------------------------------------ driving --
    def _drive(self, run: _Run):
        mgr = self.mgr
        job = run.job
        now = mgr.clock()
        mgr.telemetry.queue_wait(self.slot.name, now - run.t_assigned)
        if self._idle_since is not None:
            mgr.telemetry.idle(self.slot.name, now - self._idle_since)
        mgr.wd.heartbeat(self.slot.name, gap=False)   # picked up: alive
        if run.ready is not None:
            self.stream.wait_event(run.ready)   # the inputs are made
        t_dispatched: Dict[int, float] = {}           # window idx -> t0

        def on_drain(k, plan, records, ys):
            if run.closed:
                return
            t0 = mgr.clock()
            # the results are in hand HERE: ys and records are the host
            # copies whose event the scheduler waited for on this thread
            # (this window's copies only — a sync of the whole stream
            # would wait for the next window too and end the overlap)
            mgr.wd.heartbeat(self.slot.name, gap=False)
            td = t_dispatched.pop(plan.index, None)
            if td is not None and plan.index > 0:
                # measured window WALL (dispatch -> results in hand) is the
                # async straggler signal; window 0 pays one-off warm-up
                # (kernel builds, library loads, captures), not slowness; a
                # lane-batched window is N boards of work, normalized to
                # per-board cost
                wall = mgr.clock() - td
                mgr.wd.observe(self.slot.name, wall,
                               lanes=run.lane_count)
                if run.scope_plane is not None:
                    # accumulate measured walls over the scope interval;
                    # consumed (and zeroed) when the plane's next sample
                    # drains (_scope_observe)
                    run.scope_wall_acc += wall
            if run.lanes is not None:
                # per-lane fan-out + verify on the slot thread; a veto
                # masks ITS lane only (this thread owns lane_faults, so
                # later commits on this run already skip the lane)
                delivered, faulted = mgr._lane_ingest(run, plan,
                                                      records, ys)
                if faulted and len(run.lane_faults) == len(run.lanes):
                    run.fault = faulted[-1][1]      # every lane dead
                mgr.telemetry.drain(self.slot.name, mgr._key(run, plan),
                                    wall_s=mgr.clock() - t0)
                mgr._inject("results.post", job=job.name,
                            slot=self.slot.name)
                mgr._results.put(("lane_drain", run, plan, delivered,
                                  faulted))
                return
            if job.verify is not None and run.fault is None:
                try:
                    job.verify(plan, records, ys)
                except Exception as e:  # noqa: BLE001 — veto, not crash
                    mgr.telemetry.veto(self.slot.name)
                    run.fault = e
            mgr.telemetry.drain(self.slot.name, mgr._key(run, plan),
                                wall_s=mgr.clock() - t0)
            # results.post: an injected stall here models a results-queue
            # hand-off delay — the control plane simply sees the drain late
            mgr._inject("results.post", job=job.name, slot=self.slot.name)
            mgr._results.put(("drain", run, plan, records, ys))

        def on_commit(k, plan, state, shell):
            # an accepted barrier commit publishes the job's resume point;
            # a faulted or eviction-marked attempt publishes NOTHING (the
            # veto contract: resume from the barrier BEFORE the rejection)
            if run.closed or run.fault is not None \
                    or run.evict_flag.is_set():
                return
            mgr._publish_snapshot(run, plan, state, shell)
            if mgr.ledger is not None and run.lanes is None:
                # ledger mode: the commit makes its window deliverable
                # now. The window's drain went to the control plane just
                # before the commit, and the next one comes only after
                # the next window's commit (a whole snapshot save later),
                # so a crash in between would lose that window's delivery
                mgr._results.put(("commit", run))

        inject = None
        if mgr.injector is not None:
            def inject(k, point, plan):
                mgr._inject("slot." + point, job=job.name,
                            slot=self.slot.name, window=plan.index)
        try:
            client = mgr._client_for(run, self.slot)
            driver = mgr.sched.driver(
                client, key=run.idx, on_drain=on_drain,
                on_commit=on_commit,
                place_fn=lambda k, stack: place_stack(stack, self.slot),
                inject=inject)
            while True:
                t0 = mgr.clock()
                plan = driver.dispatch()
                if plan is None:
                    driver.flush()        # final window's deferred drain
                    self._sync()
                    if run.fault is not None:
                        mgr._results.put(("fault", run))
                    else:
                        mgr._results.put(
                            ("done", run, driver.state, driver.shell))
                    break
                t_dispatched[plan.index] = t0
                mgr.telemetry.dispatch(self.slot.name, mgr._key(run, plan),
                                       mgr.clock() - t0)
                driver.advance()          # drains window i-1 on THIS thread
                # drain boundary: the only cancellation points — a job is
                # never cut mid-dispatch, its in-flight window is simply
                # discarded undelivered
                if run.fault is not None:
                    driver.cancel()
                    self._sync()
                    mgr._results.put(("fault", run))
                    break
                if run.evict_flag.is_set():
                    driver.cancel()
                    self._sync()
                    mgr._results.put(("evicted", run))
                    break
        except BaseException as e:  # noqa: BLE001 — report, don't die
            try:
                self._sync()
            except Exception:       # noqa: BLE001 — the crash is the news
                pass
            mgr._results.put(("crash", run, e))
        self._idle_since = mgr.clock()


class FarmManager(ClientPolicy):
    """Job queue + placement + watchdog + eviction in two host-loop modes
    (see module docstring). ``slots`` may be a slot list, an int (minimum
    concurrency; virtual slots fill in on a single card), or None
    (``max(min_slots, n_devices)``, capped at the number of submitted
    jobs); auto-built slots sit on ``device`` (the visible CUDA devices by
    default, which must exist; ``"cpu"``: the host). ``mode`` is
    ``"lockstep"`` (one round-robin host thread — the bit-identity oracle)
    or ``"async"`` (one dispatcher thread and one CUDA stream per slot).
    ``slot_queue_depth`` bounds each slot's async work queue (1 = admit
    only to idle slots; 2 lets the next job pre-stage behind the current
    one). ``poll_s`` is the control plane's results-queue poll interval —
    the cadence of watchdog sweeps when no drains are arriving.
    ``policy`` is a :class:`FailurePolicy` (``None``: raise-on-failure).
    ``lanes`` sets the lane capacity of auto-built slots: at admission,
    queued jobs sharing a ``lane_key`` (and :func:`lane_compatible` in
    engine/plumbing/window shape) are coalesced into ONE vmap-fused run
    of up to that many boards per dispatch stream. ``clock`` times
    dispatch costs and window walls (the straggler signals), backoff
    gates and telemetry; tests inject one."""

    def __init__(self, slots: Any = None, min_slots: int = 3,
                 scheduler: Optional[WindowScheduler] = None,
                 watchdog: Optional[Watchdog] = None,
                 straggler_factor: float = 3.0,
                 straggler_min_s: float = 0.01,
                 evict_stragglers: bool = True,
                 telemetry: Optional[FarmTelemetry] = None,
                 mode: str = "lockstep",
                 slot_queue_depth: int = 1,
                 poll_s: float = 0.02,
                 policy: Optional[FailurePolicy] = None,
                 lanes: int = 1,
                 ledger: Any = None,
                 certify: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        if mode not in ("lockstep", "async"):
            raise ValueError(f"unknown farm mode: {mode!r}")
        if certify:
            raise NotImplementedError(
                "certify=True waits for ZP-Cert, the static board "
                "certifier of the port's analysis/ (the ZP-Cert slice)")
        self._slots_arg = slots
        self.device = (None if isinstance(slots, (list, tuple))
                       else resolve_device(device))
        self.min_slots = min_slots
        self.lanes = max(1, lanes)      # lane capacity for auto-built slots
        self.sched = scheduler or WindowScheduler(
            interval=1, overlap=True, drain_fn=None, stack_fn=None)
        self.wd = watchdog or Watchdog(timeout_s=600.0)
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.evict_stragglers = evict_stragglers
        self.telemetry = telemetry or FarmTelemetry(clock=clock)
        self.mode = mode
        self.slot_queue_depth = max(1, slot_queue_depth)
        self.poll_s = poll_s
        self.policy = policy
        self.ledger = ledger        # FarmLedger: durable journal (ZP-Ledger)
        self.clock = clock
        self.injector = None        # chaos harness hook (farm/chaos.py)

        self.queue: deque = deque()
        self.jobs: List[FarmJob] = []
        self.slots: List[DeviceSlot] = []
        self.results: Dict[str, Any] = {}       # name -> (state, shell)
        self.outputs: Dict[str, List] = {}      # name -> [(plan, rec, ys)]
        self._running: Dict[int, _Run] = {}     # client idx -> run
        self._free: List[DeviceSlot] = []
        self._avoid: Dict[str, str] = {}        # job -> slot to avoid
        self._evicted: set = set()              # client idxs, confirmed out
        self._mu = threading.Lock()             # guards _force (any thread
        self._force: set = set()                # may force_evict; the
        # control plane reads and clears marks at drain/finish boundaries)
        self._pre: Dict[int, float] = {}        # client idx -> t(place_fn)
        self._next_idx = 0
        # ----- async control plane state -----
        self._results: queue_mod.Queue = queue_mod.Queue()
        self._workers: Dict[str, _SlotWorker] = {}
        self._slot_load: Dict[str, int] = {}    # assigned-not-finished runs
        self._lost: set = set()                 # abandoned (hung) slots
        # ----- failure-policy state -----
        self._health: Dict[str, deque] = {}     # slot -> recent run bools
        self._benched: Dict[str, float] = {}    # slot -> benched-at time
        self._probing: set = set()              # slots with a canary out
        self._canary_fails: Dict[str, int] = {}  # consecutive probe fails
        self._shutdown = threading.Event()

    # ------------------------------------------------------------- intake --
    @control_thread_only
    def submit(self, job: FarmJob) -> FarmJob:
        if job.capture is not None:
            raise NotImplementedError(
                "FarmJob.capture (a measured-window roofline capture) "
                "waits for the measured-window roofline slice of the port "
                "(roofline/, WindowCapture)")
        self.jobs.append(job)
        self.queue.append(job)
        spec = None
        if job.spec is not None:
            try:
                spec = job.spec.to_json()
            except Exception:   # noqa: BLE001 — an unserializable spec
                spec = None     # journals as closure-built (dead-letters
                # on recovery with a reason instead of raising here)
        self._journal("submit", job=job.name, spec=spec)
        return job

    def submit_spec(self, spec, registry: Any = None) -> FarmJob:
        """Build and submit a serializable :class:`~repro_torch.farm.
        registry.JobSpec` — the durable intake path: the spec is journaled
        with the submit record, so ``recover()`` can re-instantiate the
        job after a process death."""
        return self.submit(spec.build(registry))

    # ------------------------------------------------- crash recovery --
    @classmethod
    def recover(cls, ledger, registry: Any = None, **kwargs
                ) -> "FarmManager":
        """Rebuild a farm from its journal after whole-process death
        (SIGKILL, OOM, power cut). For every job the journal shows
        incomplete: re-instantiate it from its journaled ``JobSpec``,
        cross-check the ledger's commit cursor against the newest
        *verifiable* on-disk snapshot (``choose_resume`` — a torn newest
        snapshot rewinds to an older one, none at all rewinds to window
        0), seed the ``windows_delivered`` suppression cursor from the
        journal's deliver records so ``on_drain`` stays exactly-once
        across process lifetimes, and rebase any unconsumed retry backoff
        onto this process's clock. Jobs that cannot be rebuilt (no
        serializable spec — closure-submitted — or a factory that fails)
        are DEAD-LETTERED with a reason, never raised. Terminal jobs
        (done/quarantined/failed) re-enter the report as stubs so the
        recovered run's report covers the whole campaign. ``kwargs`` go
        to the constructor (slots, mode, device, policy, ...)."""
        mgr = cls(ledger=ledger, **kwargs)
        state = ledger.replay()
        if ledger.dropped_records or ledger.dropped_bytes:
            mgr.telemetry.recovery(
                "<journal>", note=f"torn tail truncated: "
                f"{ledger.dropped_records} record(s), "
                f"{ledger.dropped_bytes} byte(s) dropped")
        for name, js in state.jobs.items():
            if js.status in ("done", "quarantined", "failed"):
                stub = FarmJob(name=name, engine=None, windows=[])
                stub.status = js.status
                stub.error = js.error
                stub.windows_drained = js.windows or 0
                stub.windows_delivered = max(js.delivered,
                                             js.windows or 0)
                mgr.jobs.append(stub)
                continue
            job, note = mgr._rebuild_job(js, registry)
            if job is None:
                mgr._dead_letter(name, note)
                continue
            mgr.jobs.append(job)
            mgr.queue.append(job)
            w = job.snapshot.window if job.snapshot else 0
            step = job.snapshot.step if job.snapshot else None
            mgr.telemetry.recovery(name, window=w, step=step,
                                   delivered=job.windows_delivered,
                                   note=note)
            mgr._journal("recover", job=name, window=w,
                         delivered=job.windows_delivered)
        return mgr

    def _rebuild_job(self, js, registry: Any = None):
        """One journal entry -> a live, resume-positioned FarmJob (or
        ``(None, reason)`` for the dead-letter path)."""
        if js.spec is None:
            return None, ("no serializable JobSpec in the journal "
                          "(submitted from closures — use submit_spec)")
        try:
            spec = JobSpec.from_json(js.spec)
            job = spec.build(registry)
        except Exception as e:      # noqa: BLE001 — dead-letter, not raise
            return None, f"JobSpec rebuild failed: {e!r}"
        job.attempts = js.attempts
        job.requeues = js.requeues
        job.windows_delivered = js.delivered
        if js.backoff_s > 0:
            # rebase the journal's RELATIVE backoff onto this process's
            # clock (the dead process's absolute not_before is meaningless
            # against a fresh monotonic origin)
            job.not_before = self.clock() + float(js.backoff_s)
        verify_fn = (job.snapshot_store.verify
                     if hasattr(job.snapshot_store, "verify") else None)
        window, step = choose_resume(js.commits, js.delivered, verify_fn)
        committed = max((int(c[1]) for c in js.commits), default=0)
        note = ""
        if window > 0:
            job.snapshot = JobSnapshot(step=int(step), window=int(window))
            job._base = window
            try:
                job._snap_like = self._skeleton_for(job)
            except Exception as e:  # noqa: BLE001 — skeleton from the
                # factory's initial trees failed; fall back to window 0
                job.snapshot = None
                job._base = 0
                window, step = 0, None
                note = f"resume skeleton failed ({e!r}); "
        if window == 0 and committed:
            note += ("no verifiable snapshot at or behind the delivered "
                     "cursor; window-0 replay")
        # work lost to the death: committed-or-delivered windows this
        # process must re-run (delivered-but-past-resume ones re-run
        # suppressed)
        job.windows_replayed = max(committed, js.delivered) - window
        return job, note

    def _skeleton_for(self, job: FarmJob):
        """The snapshot store's restore target in a fresh process (the
        dead one's ``_snap_like`` died with it): the skeleton
        (:func:`_skeleton`, meta-device leaves) of the tree
        ``_publish_snapshot`` saves, made from the job's initial
        state/shell (a factory is called once for it) and its verifier's
        position. Snapshots keep the leaves' shapes and dtypes, so the
        initial trees describe them."""
        state = job.state() if callable(job.state) else job.state
        shell = job.shell() if callable(job.shell) else job.shell
        vsnap = (job.verify.snapshot()
                 if hasattr(job.verify, "snapshot") else {})
        tree = {"state": state, "shell": zp_scope.unwrap(shell),
                "verify": vsnap,
                "cursor": {"step": np.int64(0), "window": np.int64(0)}}
        return _skeleton(tree)

    @control_thread_only
    def _dead_letter(self, name: str, why: str) -> FarmJob:
        """Quarantine an unrecoverable journal entry with its reason (a
        recovery must complete the rest of the campaign, not raise)."""
        job = FarmJob(name=name, engine=None, windows=[])
        job.status = "quarantined"
        job.error = why
        self.jobs.append(job)
        self.telemetry.quarantine(name, why)
        self._journal("quarantine", job=name, why=str(why))
        return job

    @any_thread
    def force_evict(self, job_name: str):
        """Mark a job for eviction at its next drain boundary (the
        deterministic test/CLI path — the watchdog path is wall-time).
        Safe from any thread: the mark set is shared with the control
        plane's sweep, so it is mutated under ``_mu``."""
        with self._mu:
            self._force.add(job_name)

    def request_shutdown(self):
        """Graceful stop (the SIGINT path): no new admissions, every
        running job is cut at its NEXT drain boundary keeping its
        committed prefix and published snapshots, queued + cut jobs are
        marked ``interrupted``, and ``run()`` returns with the report.
        Safe to call from a signal handler or another thread."""
        self._shutdown.set()

    @property
    def interrupted(self) -> bool:
        return self._shutdown.is_set()

    def _inject(self, point: str, **ctx):
        """Named fault-injection point (no-op without a chaos injector —
        the production fast path is one attribute check)."""
        if self.injector is not None:
            self.injector.fire(point, **ctx)

    @any_thread
    def _journal(self, kind: str, **fields):
        """Durably append one ledger record (no-op without a ledger).
        The ``ledger.<kind>`` injection point fires AFTER the record is
        on disk — a ``process_kill`` there models dying with the journal
        ahead of everything the manager would have done next, the exact
        edge ``recover()`` must close. Called from slot threads too (an
        async commit): ``FarmLedger.append`` takes its own lock."""
        if self.ledger is None:
            return
        self.ledger.append(kind, **fields)
        self._inject("ledger." + kind, job=fields.get("job"),
                     slot=fields.get("slot"))

    # -------------------------------------------- slot health / breaker --
    def _budget(self, job: FarmJob) -> int:
        if self.policy is not None and self.policy.max_retries is not None:
            return self.policy.max_retries
        return job.max_requeues

    @control_thread_only
    def _slot_result(self, slot_name: str, ok: bool, why: str = ""):
        """Score one finished run on a slot; trip the breaker when the
        failure count inside the scoring window crosses the threshold."""
        p = self.policy
        if p is None or slot_name in self._lost:
            return
        h = self._health.setdefault(
            slot_name, deque(maxlen=max(1, p.breaker_window)))
        h.append(ok)
        if ok or slot_name in self._benched:
            return
        fails = sum(1 for r in h if not r)
        if fails >= p.breaker_threshold:
            self._benched[slot_name] = self.clock()
            self.telemetry.breaker(slot_name, "trip",
                                   f"{fails}/{len(h)} failed: {why}")

    def _unavailable(self) -> set:
        """Slots placement must skip: lost, benched, or out on a probe."""
        return self._lost | set(self._benched) | self._probing

    @control_thread_only
    def _canary_verdict(self, slot_name: str, ok: bool, err):
        self._probing.discard(slot_name)
        if ok:
            self._benched.pop(slot_name, None)
            self._health.get(slot_name, deque()).clear()
            self._canary_fails[slot_name] = 0
            self.telemetry.breaker(slot_name, "canary_pass")
            self.telemetry.breaker(slot_name, "readmit")
            return
        self._benched[slot_name] = self.clock()     # re-arm the cooldown
        n = self._canary_fails.get(slot_name, 0) + 1
        self._canary_fails[slot_name] = n
        self.telemetry.breaker(slot_name, "canary_fail", repr(err))
        p = self.policy
        if p is not None and n >= p.breaker_max_probes:
            # a seat that cannot pass its own canary is not coming back:
            # write it off so the farm fails loudly instead of probing
            # forever with jobs stuck behind it
            self._benched.pop(slot_name, None)
            self._lost.add(slot_name)
            self.telemetry.breaker(slot_name, "written_off",
                                   f"{n} consecutive canary failures")

    # ------------------------------------------------------------ running --
    @control_thread_only
    def run(self, strict: bool = True) -> dict:
        if not self.jobs:
            return {"jobs": {}, "telemetry": self.telemetry.report()}
        if isinstance(self._slots_arg, int):
            self.slots = enumerate_slots(min_slots=self._slots_arg,
                                         lane_capacity=self.lanes,
                                         device=self.device)
        elif self._slots_arg is not None:
            self.slots = list(self._slots_arg)
        else:
            n_dev = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
            self.slots = enumerate_slots(
                min_slots=min(len(self.queue), max(self.min_slots, n_dev)),
                lane_capacity=self.lanes, device=self.device)
        if self.mode == "async":
            self._run_async()
        else:
            self._free = list(self.slots)
            # the initial client list MUST be empty: every client enters
            # via admit(), so the scheduler's positional indices stay in
            # lockstep with _next_idx and the callbacks route to the
            # right _Run
            self.sched.run_many([], on_drain=self._on_drain,
                                on_dispatch=self._on_dispatch,
                                place_fn=self._place, policy=self,
                                on_commit=self._on_commit,
                                inject=(self._inject_lockstep
                                        if self.injector else None))
            if self._shutdown.is_set():
                self._drain_interrupted()
        report = self.report()
        if strict:
            # quarantined jobs are the dead-letter REPORT, interrupted
            # ones a requested stop — neither is a farm failure
            failed = [n for n, j in report["jobs"].items()
                      if j["status"] not in ("done", "quarantined",
                                             "interrupted")]
            if failed:
                raise FarmError(f"farm jobs failed verification: {failed}")
        return report

    def report(self) -> dict:
        return {
            "mode": self.mode,
            "jobs": {j.name: {"status": j.status,
                              "windows": j.windows_drained,
                              "requeues": j.requeues,
                              "slot": j.last_slot,
                              "windows_committed": (j.snapshot.window
                                                    if j.snapshot else 0),
                              "windows_replayed": j.windows_replayed,
                              "windows_delivered": j.windows_delivered,
                              "error": j.error} for j in self.jobs},
            "quarantined": [j.name for j in self.jobs
                            if j.status == "quarantined"],
            "interrupted": self._shutdown.is_set(),
            "telemetry": self.telemetry.report(),
        }

    def scope_report(self) -> dict:
        """Fleet-wide ZP-Scope counter table (see
        :meth:`FarmTelemetry.scope_report`)."""
        return self.telemetry.scope_report()

    # ================================================== async control plane
    @control_thread_only
    def _run_async(self):
        modes = (torch.is_inference_mode_enabled(), torch.is_grad_enabled())
        self._workers = {s.name: _SlotWorker(self, s, self.slot_queue_depth,
                                             modes)
                         for s in self.slots}
        self._slot_load = {s.name: 0 for s in self.slots}
        self._lost = set()
        try:
            for w in self._workers.values():
                w.start()
            self._assign_async()
            while self._running or self.queue or self._probe_in_flight():
                if self._shutdown.is_set():
                    self._shutdown_async()
                try:
                    msg = self._results.get(timeout=self.poll_s)
                except queue_mod.Empty:
                    msg = None
                if msg is not None:
                    self._handle_async(msg)
                self._sweep_async()
                self._probe_async()
                self._assign_async()
        finally:
            for w in self._workers.values():
                w.stop()
            for w in self._workers.values():
                if w.slot.name not in self._lost and w.is_alive():
                    w.join(timeout=10.0)
                    if w.is_alive():    # a loop that outlives the run
                        # keeps its thread; later farms get a new one
                        retire_seat_thread(w.slot, holder=w)

    @control_thread_only
    def _assign_async(self):
        """Admission: feed queued jobs into slot work queues, honoring the
        requeue avoid-slot preference and each job's backoff gate, with
        the same progress guarantee as lockstep admit (the preference
        yields when nothing else can ever free a different slot)."""
        assigned = 0
        deferred = []
        backing_off = False
        now = self.clock()
        while self.queue:
            job = self.queue.popleft()
            if job.not_before > now:    # backoff: re-admission must wait
                deferred.append(job)
                backing_off = True
                continue
            slot = self._pick_async_slot(self._avoid.get(job.name))
            if slot is None:            # only its old slot has capacity:
                deferred.append(job)    # wait for a DIFFERENT one
                continue
            self._avoid.pop(job.name, None)
            self._dispatch_to_slot(job, slot)
            assigned += 1
        self.queue.extendleft(reversed(deferred))
        if not assigned and not self._running and self.queue \
                and not backing_off:
            # nothing running, nothing assigned: no other slot will ever
            # free, so the avoid preference must yield (progress guarantee)
            slot = self._pick_async_slot(None)
            if slot is not None:
                job = self.queue.popleft()
                self._avoid.pop(job.name, None)
                self._dispatch_to_slot(job, slot)
                assigned += 1
            elif not (set(self._benched) | self._probing):
                # no capacity anywhere and no benched slot a canary could
                # still heal: the farm is genuinely out of seats
                raise FarmError(
                    "no live slots left to place queued jobs "
                    f"(lost: {sorted(self._lost)})")
        if assigned:
            self.telemetry.occupancy(len(self._running), len(self.slots))

    @control_thread_only
    def _pick_async_slot(self, avoid: Optional[str]) -> Optional[DeviceSlot]:
        # least-loaded first: with slot_queue_depth >= 2 a fixed slot
        # order would double-book early slots while later ones sit idle
        out = self._unavailable()
        candidates = sorted(
            (s for s in self.slots
             if s.name not in out
             and self._slot_load[s.name] < self.slot_queue_depth),
            key=lambda s: (self._slot_load[s.name], s.index))
        live = [s for s in self.slots if s.name not in out]
        return pick_slot(candidates, avoid=avoid,
                         sole_candidate=len(live) == 1)

    @control_thread_only
    def _probe_async(self):
        """Dispatch a canary to every benched slot whose cooldown has
        elapsed (one probe in flight per slot)."""
        if self.policy is None or not self._benched:
            return
        now = self.clock()
        for name, t0 in list(self._benched.items()):
            if name in self._probing or name in self._lost:
                continue
            if now - t0 < self.policy.breaker_cooldown_s:
                continue
            try:
                self._workers[name].inbox.put_nowait(
                    _Canary(next(s for s in self.slots if s.name == name)))
            except queue_mod.Full:
                continue                # pre-bench backlog: retry next tick
            self._probing.add(name)
            self.telemetry.breaker(name, "probe")

    @control_thread_only
    def _probe_in_flight(self) -> bool:
        """A breaker canary is out on a slot whose loop still runs: its
        verdict (and the re-probe or readmission it brings) lands before
        the run ends, or the run would end with the verdict unread."""
        return any(n not in self._lost and self._workers[n].is_alive()
                   for n in self._probing)

    @control_thread_only
    def _shutdown_async(self):
        """Graceful-stop sweep: orphan the queue, cut every running job at
        its next drain boundary (its committed prefix stays delivered)."""
        self._orphan_queue()
        for run in self._running.values():
            if not run.evict_flag.is_set():
                run.evict_why = "shutdown"
                run.evict_flag.set()

    @control_thread_only
    def _dispatch_to_slot(self, job: FarmJob, slot: DeviceSlot):
        members = self._gather_lanes(job, slot)
        run = self._new_run(members, slot, t_assigned=self.clock())
        with self._mu:
            forced = bool({m.name for m in members} & self._force)
        if forced and not (
                run.lanes is None
                and run.job.requeues >= self._budget(run.job)):
            # signal a pre-existing force mark at assignment, not at the
            # next sweep: the control plane's first sweep runs after a
            # blocking results poll, and a short job can finish entirely
            # inside that window — the mark would never land
            run.evict_why = "forced"
            run.evict_flag.set()
        if torch.device(slot.device).type == "cuda":
            # everything the control thread queued for this job (weights,
            # captured activations, lane stacks) precedes this event; the
            # slot stream waits for it before the job's first window
            run.ready = torch.cuda.Event()
            run.ready.record(torch.cuda.current_stream(slot.device))
        self._slot_load[slot.name] += 1
        self.wd.heartbeat(slot.name, gap=False)   # assigned: alive
        self.telemetry.depth(slot.name,
                             self._workers[slot.name].inbox.qsize() + 1)
        self._workers[slot.name].inbox.put(run)

    @control_thread_only
    def _handle_async(self, msg):
        if msg[0] == "canary":
            _, slot_name, ok, err = msg
            self._canary_verdict(slot_name, ok, err)
            return
        kind, run = msg[0], msg[1]
        if run.closed:                  # stale message from an abandoned
            return                      # thread: the run is already gone
        if kind == "drain":
            _, _, plan, records, ys = msg
            run.outputs.append((plan, records, ys))
            self._deliver_committed(run)
            return
        if kind == "commit":            # ledger mode: deliver what the
            self._deliver_committed(run)    # commit made deliverable
            return
        if kind == "lane_drain":
            _, _, plan, delivered, faulted = msg
            for lane, rec, y in delivered:
                run.lane_outputs[lane].append((plan, rec, y))
            for lane, exc in faulted:
                self._detach_lane(run, lane, f"lane veto: {exc}")
            return
        run.closed = True
        self._running.pop(run.idx, None)
        self._slot_load[run.slot.name] -= 1
        if kind == "done":
            self._slot_result(run.slot.name, ok=run.fault is None)
            self._finish_run(run, msg[2], msg[3])
        elif kind == "fault":
            if run.lanes is None:
                # a lane veto is a job-content fault localized by the
                # fused verify, not a slot failure — don't score the seat
                self._slot_result(run.slot.name, ok=False,
                                  why=f"veto: {run.fault}")
            self._requeue_or_fail(run, f"drain veto: {run.fault}")
        elif kind == "evicted":
            if run.evict_why == "shutdown":
                self._retire_interrupted(run)
            else:
                self._requeue_or_fail(run, run.evict_why or "evicted")
        else:  # crash: a slot-thread exception is a board fault, not a
            # farm failure — score the seat, requeue or dead-letter
            self._slot_result(run.slot.name, ok=False,
                              why=f"crash: {msg[2]!r}")
            self._requeue_or_fail(run, f"slot thread crash: {msg[2]!r}")
        self.telemetry.occupancy(len(self._running), len(self.slots))

    @control_thread_only
    def _sweep_async(self):
        """Control-plane sweep: watchdog stragglers (measured window wall)
        + forced marks are SIGNALLED to the slot thread (honored at its
        next drain boundary); hung boards (liveness timeout) are abandoned
        — the slot leaves the pool, the job requeues elsewhere."""
        marks: Dict[int, str] = {}
        if self.evict_stragglers and self._running:
            # unlike the lockstep sweep, async jobs finish at their own
            # pace: a straggler is often the LAST one running, judged
            # against the departed fleet's retained samples — the
            # watchdog's own min_fleet (>= 2 sampled workers) is the gate
            slow = set(self.wd.stragglers(self.straggler_factor,
                                          min_s=self.straggler_min_s,
                                          channel=self._straggler_channel()))
            for idx, run in self._running.items():
                if run.slot.name in slow:
                    marks.setdefault(idx, "straggler")
        with self._mu:
            force = set(self._force)
        for idx, run in self._running.items():
            names = {run.job.name}
            if run.lanes is not None:   # force-marking a member cuts the
                names.update(m.name for m in run.lanes)  # whole fused run
            if names & force:
                marks.setdefault(idx, "forced")
        for idx, why in marks.items():
            run = self._running[idx]
            if run.evict_flag.is_set():
                continue                # already signalled
            if (run.lanes is None and run.fault is None
                    and run.job.requeues >= self._budget(run.job)):
                continue                # budget spent: let it limp home
                # (lane runs skip the gate: members budget at requeue)
            run.evict_why = why
            run.evict_flag.set()
        dead = set(self.wd.dead_workers())
        for run in [r for r in self._running.values()
                    if r.slot.name in dead]:
            self._abandon_async(run)

    @control_thread_only
    def _abandon_async(self, run: _Run):
        """A slot whose thread stopped beating past the watchdog timeout is
        HUNG mid-dispatch (it cannot even reach an eviction check). The
        board is written off: its thread is left as a daemon, the slot
        never returns to the pool, and the job requeues elsewhere."""
        # ingest everything already posted before writing the run off: the
        # hung board's last drains may still sit in the results queue, and
        # the requeue's committed-prefix math needs them in run.outputs
        while True:
            try:
                msg = self._results.get_nowait()
            except queue_mod.Empty:
                break
            self._handle_async(msg)
        if run.closed:          # the drained backlog finished the run
            return
        run.closed = True
        run.evict_flag.set()            # if the thread ever wakes, stop it
        self._running.pop(run.idx, None)
        self._slot_load[run.slot.name] -= 1
        self._lost.add(run.slot.name)
        # the seat's thread may stay stuck in the board: later farms on
        # this seat get a new one
        retire_seat_thread(run.slot, holder=self._workers[run.slot.name])
        # orphan any pre-staged (not yet started) assignments on the queue
        w = self._workers[run.slot.name]
        while True:
            try:
                staged = w.inbox.get_nowait()
            except queue_mod.Empty:
                break
            if staged is _STOP or isinstance(staged, _Canary) \
                    or staged.closed:
                continue
            staged.closed = True
            self._running.pop(staged.idx, None)
            self._slot_load[staged.slot.name] -= 1
            self._requeue_or_fail(staged, "slot lost (hung board)")
        self._requeue_or_fail(run, "hung board (liveness timeout)")

    @control_thread_only
    def _orphan_queue(self):
        """Mark everything still queued ``interrupted`` (journaled, so a
        recovery re-queues it instead of losing it)."""
        while self.queue:
            job = self.queue.popleft()
            if job.status != "done":
                job.status = "interrupted"
                self._journal("interrupted", job=job.name)

    # ---------------------------------------------------- lane coalescing --
    @control_thread_only
    def _gather_lanes(self, job: FarmJob, slot: DeviceSlot) -> List[FarmJob]:
        """Pull up to ``slot.lane_capacity - 1`` queued jobs compatible
        with ``job`` (same ``lane_key``, engine, plumbing, window shape —
        see :func:`lane_compatible`) to ride in one fused run. Skipped
        jobs stay queued in their original order."""
        cap = getattr(slot, "lane_capacity", 1)
        if cap <= 1 or job.lane_key is None or job.snapshot is not None \
                or job.committed_outputs or job.windows_delivered \
                or callable(job.state) or callable(job.shell):
            return [job]
        members, skipped = [job], []
        now = self.clock()
        while self.queue and len(members) < cap:
            cand = self.queue.popleft()
            if (cand.not_before <= now
                    and self._avoid.get(cand.name) != slot.name
                    and lane_compatible(job, cand) is None):
                members.append(cand)
            else:
                skipped.append(cand)
        self.queue.extendleft(reversed(skipped))
        return members

    @control_thread_only
    def _new_run(self, members: List[FarmJob], slot: DeviceSlot,
                 t_assigned: float = 0.0) -> _Run:
        if len(members) > 1:
            run = self._make_lane_run(members, slot, t_assigned)
        else:
            job = members[0]
            job.attempts += 1
            job.status = "running"
            job.last_slot = slot.name
            self._journal("admit", job=job.name, slot=slot.name,
                          attempt=job.attempts)
            run = _Run(job, slot, self._next_idx, t_assigned=t_assigned)
            self._next_idx += 1
        self.telemetry.lanes(slot.name, len(members))
        self._running[run.idx] = run
        return run

    @control_thread_only
    def _make_lane_run(self, members: List[FarmJob], slot: DeviceSlot,
                       t_assigned: float = 0.0) -> _Run:
        """Fuse N compatible queued jobs into ONE lane-batched run: a
        synthetic fused job (never in ``self.jobs``) carries the vmapped
        engine, zipped windows, and lane-packed state/shell. Member
        state/shell objects are packed DIRECTLY (no replay copies — the
        packed stack is a fresh tensor, which the fused engine may update
        in place), so a weight tree shared by identity across members
        stays one device copy."""
        lb = LaneBatch(members[0].engine,
                       windows=[m.windows for m in members],
                       states=[m.state for m in members],
                       shells=[m.shell for m in members],
                       stack_fn=members[0].stack_fn,
                       drain_fn=members[0].drain_fn,
                       reset=members[0].reset)
        fused = FarmJob(
            name="lanes[" + "+".join(m.name for m in members) + "]",
            engine=lb.engine, windows=lb.windows, state=lb.state,
            shell=lb.shell, drain_fn=lb.drain_fn, stack_fn=lb.stack_fn,
            reset=lb.reset, max_requeues=0,
            scope=members[0].scope)     # spec equality is a coalescing
        # rule, so ONE plane instruments the whole fused run (per-lane
        # counter slices via the lane axis)
        run = _Run(fused, slot, self._next_idx, t_assigned=t_assigned)
        self._next_idx += 1
        run.lanes = list(members)
        run.lane_batch = lb
        run.lane_outputs = [[] for _ in members]
        for m in members:
            m.attempts += 1
            m.status = "running"
            m.last_slot = slot.name
            self._avoid.pop(m.name, None)
            self._journal("admit", job=m.name, slot=slot.name,
                          attempt=m.attempts)
        return run

    def _lane_barriers(self, run: _Run, proto) -> tuple:
        """Fan a fused run's barrier commits out to its live members: each
        member's own barrier action fires with its lane's state slice, so
        per-job checkpoint saves keep their solo semantics. Vetoed lanes
        are skipped — a lane veto vetoes THAT lane's commit only."""
        def fan(j):
            def act(state, boundary):
                # one host fetch of the stacked leaves, N views — not N
                # device gathers (shared weights stay on the device)
                host = run.lane_batch.fetch_state(state)
                for k, m in enumerate(run.lanes):
                    if k in run.lane_faults or k in run.lane_detached:
                        continue
                    m.barriers[j].action(
                        run.lane_batch.slice_state(host, k), boundary)
            return act

        return tuple(DrainBarrier(every=b.every, action=fan(j))
                     for j, b in enumerate(proto))

    def _straggler_channel(self) -> str:
        """Which watchdog channel judges the eviction ratio. When EVERY
        running job is scoped, the device-side work-rate channel is the
        verdict outright — "auto" would fall back to wall during warm-up
        (the first scope sample per attempt is discarded), and a board
        legitimately doing more work per window reads as a wall straggler
        in exactly that gap. "work" is conservative instead: until enough
        rate samples exist there is no fleet, so no verdict. Any unscoped
        job in the fleet keeps the mixed-signal "auto" rule."""
        runs = self._running.values()
        if runs and all(r.job.scope is not None for r in runs):
            return "work"
        return "auto"

    # ------------------------------------------------- checkpointed resume --
    def _publish_snapshot(self, run: _Run, plan, state, shell):
        """Publish the job's resume point at an accepted barrier commit
        (on the thread that owns the job's device state — the slot thread
        in async mode). The payload is host-copied by the store's save,
        so it survives in-place updates and slot loss; the cursor handle
        on the run is what the control plane reads at requeue time."""
        job = run.job
        # snapshots hold the DUT shell only: scope counters ride BESIDE
        # the DUT and restart on requeue (observability, not progress)
        shell = zp_scope.unwrap(shell)
        self._inject("snapshot.publish", job=job.name, slot=run.slot.name)
        cursor = {"step": np.int64(plan.boundary),
                  "window": np.int64(plan.index + 1)}
        if run.lanes is not None:
            # per-lane publish: each live member's OWN store gets its lane
            # slice + its own verifier position, so a detached lane's solo
            # requeue resumes through the unchanged checkpointed path
            host_state = run.lane_batch.fetch_state(state)
            host_shell = run.lane_batch.fetch_shell(shell)
            for lane, m in enumerate(run.lanes):
                if lane in run.lane_faults or lane in run.lane_detached:
                    continue
                vsnap = (m.verify.snapshot()
                         if hasattr(m.verify, "snapshot") else {})
                tree = {"state": run.lane_batch.slice_state(host_state,
                                                            lane),
                        "shell": run.lane_batch.slice_shell(host_shell,
                                                            lane),
                        "verify": vsnap, "cursor": dict(cursor)}
                if m.snapshot_store is None:
                    m.snapshot_store = MemorySnapshotStore(keep=2)
                m.snapshot_store.save(tree, step=plan.boundary)
                m._snap_like = _skeleton(tree)
                m.snapshot = JobSnapshot(step=plan.boundary,
                                         window=plan.index + 1)
                self._journal("commit", job=m.name, slot=run.slot.name,
                              step=int(plan.boundary),
                              window=int(plan.index) + 1)
            run.snapshot = JobSnapshot(step=plan.boundary,
                                       window=plan.index + 1)
            return
        vsnap = (job.verify.snapshot()
                 if hasattr(job.verify, "snapshot") else {})
        tree = {"state": state, "shell": shell, "verify": vsnap,
                "cursor": cursor}
        if job.snapshot_store is None:
            job.snapshot_store = MemorySnapshotStore(keep=2)
        job.snapshot_store.save(tree, step=plan.boundary)   # atomic publish
        job._snap_like = _skeleton(tree)    # restore target: host tensors
        run.snapshot = JobSnapshot(step=plan.boundary,
                                   window=plan.index + 1)
        # journal AFTER the store publish: a journaled commit whose
        # snapshot never landed is exactly what recovery's verify
        # cross-check (choose_resume) exists to rewind past
        self._journal("commit", job=job.name, slot=run.slot.name,
                      step=int(plan.boundary), window=int(plan.index) + 1)

    @control_thread_only
    def _restore_snapshot(self, job: FarmJob, slot: DeviceSlot,
                          snap: JobSnapshot):
        """Integrity-checked snapshot restore for a requeue. A corrupt or
        partially-written snapshot falls back to the newest OLDER
        verifiable one — the delivered-prefix and replay bookkeeping are
        rewound with the cursor so exactly-once delivery still holds; no
        verifiable snapshot at all rewinds the job to a window-0 replay.
        Every fallback is logged in telemetry. Returns ``(tree, snap)``
        (``(None, None)`` = window-0)."""
        want = snap.step
        try:
            try:
                job.snapshot_store.wait()   # surfaces async save errors
            except Exception:               # noqa: BLE001 — a FAILED
                # publish: the store still holds the saves that landed;
                # restore below falls back to the newest of those
                self.telemetry.fault("snapshot.publish", "save_error",
                                     job=job.name, slot=slot.name,
                                     event="error")
            tree, got = job.snapshot_store.restore(
                job._snap_like, step=want, fallback=True)
        except Exception as e:  # noqa: BLE001 — nothing verifiable left
            self.telemetry.fallback(slot.name, job.name, want, None,
                                    repr(e))
            job.windows_replayed += snap.window
            job.committed_outputs = []      # windows re-run; the
            # windows_delivered cursor is NOT rewound — already-delivered
            # windows are suppressed on re-drain (exactly-once holds)
            job._base = 0
            job.snapshot = None
            return None, None
        if got != want:
            # landed on an older snapshot: rewind the cursor to ITS
            # recorded position and drop the committed prefix beyond it
            # (committed_outputs[i] is window _base + i for recovered jobs)
            new_window = int(np.asarray(
                tree.get("cursor", {}).get("window", 0)))
            self.telemetry.fallback(slot.name, job.name, want, got,
                                    f"corrupt snapshot at step {want}")
            job.windows_replayed += max(0, snap.window - new_window)
            keep = new_window - job._base
            if keep <= 0:
                job.committed_outputs = []
                job._base = new_window
            else:
                job.committed_outputs = job.committed_outputs[:keep]
            snap = JobSnapshot(step=got, window=new_window)
            job.snapshot = snap
        return tree, snap

    def _client_for(self, run: _Run, slot: DeviceSlot) -> Client:
        """Build the attempt's scheduler client: from the job's initial
        state (fresh copies) on a first attempt, or from its last accepted
        snapshot on a requeue — the window stream is sliced at the cursor
        and the plans keep their global step/window ids, so tail windows,
        barrier cadence, and the on_drain order are exactly an
        uninterrupted run's."""
        job = run.job
        if run.lanes is not None:
            # fused runs always start fresh (coalescing rejects mid-stream
            # resumes) and their packed trees are fresh stacks, so they
            # are placed WITHOUT replay copies: broadcast (identity-shared)
            # leaves stay one device copy across all lanes
            run.start_window = 0
            return Client(engine=job.engine, windows=job._window_iter(),
                          state=place(job.state, slot),
                          shell=place(job.shell, slot),
                          drain_fn=job.drain_fn, stack_fn=job.stack_fn,
                          reset=job.reset,
                          barriers=self._gated_barriers(run),
                          lanes=run.lane_count,
                          scope=self._scope_plane_for(run))
        snap = job.snapshot
        tree = None
        if snap is not None:
            tree, snap = self._restore_snapshot(job, slot, snap)
        if snap is None:
            state = place(job._initial("state"), slot)
            shell = place(job._initial("shell"), slot)
            if hasattr(job.verify, "restore") \
                    and hasattr(job.verify, "snapshot"):
                if job._verify_init is None:    # first admission: remember
                    job._verify_init = job.verify.snapshot()
                else:
                    # no-snapshot requeue (evicted before any accepted
                    # barrier, or every snapshot corrupt): the stream
                    # replays from window 0, so a stateful verifier must
                    # rewind to its starting position too
                    job.verify.restore(job._verify_init)
            windows = job._window_iter()
            start_step = start_index = 0
        else:
            state = place(tree["state"], slot)
            shell = place(tree["shell"], slot)
            if hasattr(job.verify, "restore") and tree.get("verify"):
                job.verify.restore(tree["verify"])
            windows = itertools.islice(job._window_iter(), snap.window,
                                       None)
            start_step, start_index = snap.step, snap.window
            self.telemetry.resume(slot.name, job.name, snap.window,
                                  snap.step)
        run.start_window = start_index
        return Client(engine=job.engine, windows=windows, state=state,
                      shell=shell, drain_fn=job.drain_fn,
                      stack_fn=job.stack_fn, reset=job.reset,
                      barriers=self._gated_barriers(run),
                      start_step=start_step, start_index=start_index,
                      scope=self._scope_plane_for(run))

    # ---------------------------------------------------------- ZP-Scope --
    def _scope_plane_for(self, run: _Run):
        """Bind a fresh per-attempt :class:`ScopePlane` for a scoped job
        (``None`` otherwise). One plane instruments the whole run — under
        lane batching the counters are per-lane via the lane axis.
        Drained samples land on the observing thread (the slot thread in
        async mode) and fan into telemetry + the watchdog's device-side
        work-rate channel."""
        job = run.job
        if job.scope is None:
            return None
        # the plane reaches its run by a weak reference: run -> plane ->
        # callback -> run would be a reference cycle
        ref = weakref.ref(run)
        plane = zp_scope.ScopePlane(
            job.scope, lanes=run.lane_count,
            on_sample=lambda s: self._scope_observe(ref(), s))
        run.scope_plane = plane
        run.scope_wall_acc = 0.0
        run.scope_first = True
        return plane

    def _scope_observe(self, run: _Run, sample: dict):
        """One drained scope sample: record it in telemetry and feed the
        straggler detector's work-rate channel with (accumulated measured
        wall) / (device-side work retired this interval). The FIRST
        sample of an attempt spans the warm-up — a known one-off, not
        slowness — and quiet intervals (no work retired) are excluded
        rather than averaged in. Telemetry records every sample (the
        counters are true device-side totals even from the finalize tail
        of a just-closed run); the straggler channel only takes samples
        from a LIVE attempt."""
        if run is None:                 # the attempt is gone
            return
        self.telemetry.scope(run.slot.name, run.job.name, sample)
        if run.closed:
            return
        wall, run.scope_wall_acc = run.scope_wall_acc, 0.0
        if run.scope_first:
            run.scope_first = False
            return
        d = sample.get("d_tokens") or 0
        work = sum(d) if isinstance(d, list) else d
        if sample.get("quiet") or wall <= 0 or work <= 0:
            self.wd.observe(run.slot.name, 0.0, quiet=True)
            return
        self.wd.observe(run.slot.name, wall, work=work)

    @control_thread_only
    def _on_commit(self, k: int, plan, state, shell):
        """Lockstep snapshot hook (the async path is the slot worker's
        closure): publish unless the attempt is faulted — the veto
        contract keeps the resume point BEFORE a rejected window."""
        run = self._running.get(k)
        if run is None or run.fault is not None:
            return
        self._publish_snapshot(run, plan, state, shell)
        self._deliver_committed(run)    # ledger mode: hand over the newly
        # committed windows now (lockstep's control thread owns delivery)

    def _inject_lockstep(self, k: int, point: str, plan):
        """Lockstep route for the ClientDriver injection points (the async
        route is the slot worker's closure)."""
        run = self._running.get(k)
        if run is None:
            return
        self._inject("slot." + point, job=run.job.name,
                     slot=run.slot.name, window=plan.index)

    def _gated_barriers(self, run: _Run):
        """Per-attempt barrier wrappers: a barrier action (e.g. a
        checkpoint save) is skipped while the run has a recorded fault —
        the drain verifier's rejection VETOES the commit, exactly the
        ``DrainBarrier`` contract in the single-client scheduler. A fused
        run's barriers fan out to its members (``_lane_barriers``). The
        wrappers live in the attempt's client only: stored on the run's
        job they would close a reference cycle (run -> job -> barriers ->
        run) that keeps a fused run's lane stacks alive until the garbage
        collector runs."""
        def gate(action):
            def act(state, boundary):
                if run.fault is None and not run.evict_flag.is_set():
                    action(state, boundary)
            return act

        barriers = (self._lane_barriers(run, run.lanes[0].barriers)
                    if run.lanes is not None else run.job.barriers)
        return tuple(DrainBarrier(every=b.every, action=gate(b.action))
                     for b in barriers)

    @control_thread_only
    def _finish_run(self, run: _Run, state, shell):
        if run.scope_plane is not None:
            # tail sample (counters since the last read-rate boundary),
            # then results publish the bare DUT shell
            shell = run.scope_plane.finalize(shell)
        if run.lanes is not None:
            self._finish_lanes(run, state, shell)
            return
        job = run.job
        with self._mu:                  # a stale mark must not outlive us
            self._force.discard(job.name)
        job.status = "done"
        # delivered stream = committed prefix retained across evictions +
        # this (final) attempt's windows from its resume cursor onward —
        # every window exactly once, in window order
        outputs = job.committed_outputs + run.outputs
        job.windows_drained = len(outputs)
        self.results[job.name] = (state, shell)
        self.outputs[job.name] = outputs
        if self.ledger is not None:
            # ledger mode delivers incrementally as commits land (so a
            # crash costs only the undelivered tail); this hands over
            # whatever remains past the last commit
            self._deliver_upto(job, outputs, job._base,
                               job._base + len(outputs))
        else:
            if job.on_drain is not None:
                for plan, records, ys in outputs:   # exactly-once, in order
                    job.on_drain(plan, records, ys)
            job.windows_delivered = len(outputs)
        self._journal("done", job=job.name,
                      windows=job._base + len(outputs))

    # ------------------------------------------------- ledger delivery --
    @control_thread_only
    def _deliver_upto(self, job: FarmJob, outputs: List, base: int,
                      upto: int):
        """Ledger-mode exactly-once delivery: hand windows
        ``[windows_delivered, upto)`` to the sink in order (window ``g``
        read from ``outputs[g - base]``) and journal the advanced cursor.
        The ``windows_delivered`` cursor — seeded from the journal by
        ``recover()`` — suppresses windows a dead predecessor already
        delivered, which is what makes ``on_drain`` exactly-once ACROSS
        process lifetimes. Control thread only (lockstep's control thread
        or the async control plane)."""
        upto = min(upto, base + len(outputs))
        if job.windows_delivered >= upto:
            return
        if job.on_drain is not None:
            while job.windows_delivered < upto:
                g = job.windows_delivered
                if g < base:            # defensively skip a gap below the
                    job.windows_delivered = base    # in-hand range
                    continue
                plan, records, ys = outputs[g - base]
                job.on_drain(plan, records, ys)
                job.windows_delivered = g + 1
        else:
            job.windows_delivered = upto
        # journaled AFTER the sink returns: a crash between the sink and
        # this record re-delivers at most the windows of this one batch —
        # the documented idempotent-sink edge of the WAL contract
        self._journal("deliver", job=job.name, upto=job.windows_delivered)

    @control_thread_only
    def _deliver_committed(self, run: _Run):
        """Deliver a solo run's committed prefix as commits land (ledger
        mode only — without a ledger delivery stays at completion).
        Called at drain/commit ingestion on the control thread; the
        cursor never passes ``min(committed, windows in hand)``."""
        if self.ledger is None or run.lanes is not None or run.closed:
            return
        snap = run.snapshot or run.job.snapshot
        if snap is None:
            return
        self._deliver_upto(run.job, run.outputs, run.start_window,
                           snap.window)

    # ------------------------------------------------------ lane lifecycle --
    def _lane_ingest(self, run: _Run, plan, records, ys):
        """Fan one fused window out to its live lanes and run each
        member's verify against ITS slice. A verify exception vetoes that
        lane alone: it is recorded in ``run.lane_faults`` (so later
        commits on this run skip the lane), stamped with the lane id, and
        the lane's window is not delivered. The ys are the scheduler's
        one host copy of the window's stacked outputs (pinned, fetched
        once), so each lane's slice is a host view. Returns
        ``(delivered, faulted)`` as ``[(lane, records, ys)...]`` /
        ``[(lane, exc)...]``."""
        delivered, faulted = [], []
        for lane, m in enumerate(run.lanes):
            if lane in run.lane_faults:
                continue
            rec, y = run.lane_batch.fan_out_one(records, ys, lane)
            if m.verify is not None:
                try:
                    m.verify(plan, rec, y)
                except Exception as e:  # noqa: BLE001 — veto, not crash
                    if getattr(e, "lane", None) is None:
                        try:
                            e.lane = lane       # divergence names the lane
                        except Exception:       # noqa: BLE001 — slotted
                            pass                # exceptions: telemetry has it
                    run.lane_faults[lane] = e
                    self.telemetry.veto(run.slot.name)
                    self.telemetry.lane_veto(run.slot.name, m.name, lane)
                    faulted.append((lane, e))
                    continue
            delivered.append((lane, rec, y))
        return delivered, faulted

    @control_thread_only
    def _adopt_lane(self, run: _Run, lane: int) -> int:
        """Adopt lane ``lane``'s committed prefix into its member job (the
        per-lane analog of :meth:`_adopt_progress`: a snapshot whose
        windows never reached the control plane is dropped, not trusted).
        Returns the resume cursor window."""
        m = run.lanes[lane]
        outs = run.lane_outputs[lane]
        snap = m.snapshot
        if snap is not None and snap.window <= len(outs):
            m.committed_outputs.extend(outs[:snap.window])
            return snap.window
        if snap is not None:
            m.snapshot = None
        return 0

    @control_thread_only
    def _detach_lane(self, run: _Run, lane: int, why: str):
        """Lane-granular eviction: mask the vetoed lane out of the (still
        running) fused run and requeue its member as a SOLO job resuming
        from its own last accepted per-lane snapshot. Idempotent — the
        control plane may see the same lane fault from several paths."""
        if lane in run.lane_detached:
            return
        run.lane_detached.add(lane)
        run.lane_faults.setdefault(lane, None)
        m = run.lanes[lane]
        cursor = self._adopt_lane(run, lane)
        if self.ledger is not None:
            self._deliver_upto(m, m.committed_outputs, m._base, cursor)
        # the vetoed window itself re-runs on the solo attempt too
        m.windows_replayed += max(
            0, len(run.lane_outputs[lane]) - cursor) + 1
        self.telemetry.eviction(run.slot.name, m.name, why)
        self._journal("evict", job=m.name, slot=run.slot.name,
                      why=str(why))
        self._requeue_member(m, run.slot.name, why)

    @control_thread_only
    def _retire_lanes(self, run: _Run, why: str, interrupted: bool = False):
        """A fused run finished badly (crash, forced eviction, every lane
        vetoed, shutdown): detach its vetoed lanes and requeue (or mark
        interrupted) the survivors from their committed prefixes."""
        self.wd.forget(run.slot.name)
        self.telemetry.eviction(run.slot.name, run.job.name, why)
        for lane, m in enumerate(run.lanes):
            if lane in run.lane_detached:
                continue
            if not interrupted and lane in run.lane_faults:
                self._detach_lane(run, lane,
                                  f"lane veto: {run.lane_faults[lane]}")
                continue
            run.lane_detached.add(lane)
            cursor = self._adopt_lane(run, lane)
            if self.ledger is not None:
                self._deliver_upto(m, m.committed_outputs, m._base, cursor)
            m.windows_replayed += max(
                0, len(run.lane_outputs[lane]) - cursor)
            if interrupted:
                m.status = "interrupted"
                self._journal("interrupted", job=m.name)
            else:
                self._requeue_member(m, run.slot.name, why)

    @control_thread_only
    def _requeue_member(self, job: FarmJob, slot_name: str, why: str):
        """The requeue/quarantine/fail tail shared by solo attempts and
        detached lane members (budget, backoff gate, avoid preference)."""
        with self._mu:
            self._force.discard(job.name)
        if job.requeues < self._budget(job):
            job.requeues += 1
            backoff = (self.policy.backoff_for(job.requeues)
                       if self.policy is not None else 0.0)
            if backoff > 0:
                job.not_before = self.clock() + backoff
            self.telemetry.retry(job.name, job.requeues, backoff, why)
            # backoff is journaled as the RELATIVE delay, not the
            # absolute not_before: self.clock() is a process-local
            # monotonic origin, so a recovering process REBASES the
            # remaining delay onto its own clock instead of inheriting a
            # timestamp that could stall re-admission arbitrarily long
            self._journal("requeue", job=job.name, attempt=job.requeues,
                          backoff_s=float(backoff), why=str(why))
            job.status = "queued"
            self._avoid[job.name] = slot_name
            self.queue.appendleft(job)
        elif self.policy is not None and self.policy.quarantine:
            job.status = "quarantined"
            job.error = why
            self.telemetry.quarantine(job.name, why)
            self._journal("quarantine", job=job.name, why=str(why))
        else:
            job.status = "failed"
            job.error = why
            self._journal("failed", job=job.name, why=str(why))

    @control_thread_only
    def _finish_lanes(self, run: _Run, state, shell):
        """Fused-run completion: every surviving lane delivers its full
        stream (committed prefix + this run's windows) exactly once and in
        order; lanes vetoed on the FINAL window detach here."""
        lb = run.lane_batch
        for lane, m in enumerate(run.lanes):
            if lane in run.lane_detached:
                continue
            if lane in run.lane_faults:
                self._detach_lane(run, lane,
                                  f"lane veto: {run.lane_faults[lane]}")
                continue
            with self._mu:
                self._force.discard(m.name)
            m.status = "done"
            outputs = m.committed_outputs + run.lane_outputs[lane]
            m.windows_drained = len(outputs)
            self.results[m.name] = (lb.slice_state(state, lane),
                                    lb.slice_shell(shell, lane))
            self.outputs[m.name] = outputs
            if self.ledger is not None:
                self._deliver_upto(m, outputs, m._base,
                                   m._base + len(outputs))
            else:
                if m.on_drain is not None:
                    for plan, records, ys in outputs:
                        m.on_drain(plan, records, ys)
                m.windows_delivered = len(outputs)
            self._journal("done", job=m.name,
                          windows=m._base + len(outputs))

    # ----------------------------------------------- ClientPolicy protocol --
    @control_thread_only
    def admit(self, round_idx: int):
        if self._shutdown.is_set():
            self._interrupt_lockstep()
            return ()
        self._process_evictions()
        if self._benched:
            self._probe_lockstep()
        admissions = []
        while True:
            deferred = []
            backing_off = False
            now = self.clock()
            while self.queue and self._free:
                job = self.queue.popleft()
                if job.not_before > now:    # backoff: re-admission waits
                    deferred.append(job)
                    backing_off = True
                    continue
                slot = self._pick_slot(self._avoid.get(job.name))
                if slot is None:    # only its old slot is free: wait for
                    deferred.append(job)    # a DIFFERENT one
                    continue
                self._avoid.pop(job.name, None)
                admissions.append(self._admit_one(job, slot))
            self.queue.extendleft(reversed(deferred))
            if admissions or self._running or not self.queue:
                break
            # STALLED: jobs queued, nothing running, nothing admitted.
            # Lockstep has no background tick — resolve the stall here or
            # run_many's round loop would exit with jobs stranded.
            if backing_off:
                # wait out the earliest backoff gate, then re-admit
                delay = min(j.not_before for j in self.queue) - self.clock()
                if delay > 0:
                    time.sleep(delay)
                continue
            slot = self._pick_slot(None)
            if slot is not None:
                # only the avoid preference blocks: no other slot will
                # ever free, so it must yield (progress guarantee)
                job = self.queue.popleft()
                self._avoid.pop(job.name, None)
                admissions.append(self._admit_one(job, slot))
                break
            if self._benched:
                # every placeable seat is benched: probe inline until one
                # heals or the breaker writes them all off
                self._probe_lockstep()
                if self._benched and self.policy is not None:
                    delay = (min(self._benched.values())
                             + self.policy.breaker_cooldown_s
                             - self.clock())
                    if delay > 0:
                        time.sleep(delay)
                continue
            raise FarmError(
                "no live slots left to place queued jobs "
                f"(lost: {sorted(self._lost)})")
        if self._running:
            self.telemetry.occupancy(len(self._running), len(self.slots))
        return admissions

    @control_thread_only
    def evict(self, k: int) -> bool:
        return k in self._evicted

    @control_thread_only
    def done(self, k: int, state, shell):
        run = self._running.pop(k)
        self._free.append(run.slot)
        if run.fault is not None:
            if run.lanes is None:       # lane vetoes don't score the seat
                self._slot_result(run.slot.name, ok=False,
                                  why=f"veto: {run.fault}")
            self._requeue_or_fail(run, f"drain veto: {run.fault}")
            return
        self._slot_result(run.slot.name, ok=True)
        self._finish_run(run, state, shell)

    @control_thread_only
    def crashed(self, k: int, exc: BaseException) -> bool:
        """Lockstep crash absorption (the ClientPolicy hook run_many
        offers a raising driver to): a client crashing mid-drive is a
        board fault, not a farm failure — free the seat, score the slot,
        requeue or dead-letter the job, keep the pass alive. Mirrors the
        async mode's slot-thread ``crash`` message."""
        run = self._running.pop(k, None)
        if run is None:
            return False
        self._free.append(run.slot)
        self._slot_result(run.slot.name, ok=False, why=f"crash: {exc!r}")
        self._requeue_or_fail(run, f"client crash: {exc!r}")
        return True

    # -------------------------------------------------- scheduler callbacks --
    @control_thread_only
    def _place(self, k: int, stack):
        self._pre[k] = self.clock()
        return place_stack(stack, self._running[k].slot)

    @control_thread_only
    def _on_dispatch(self, k: int, plan, state):
        run = self._running[k]
        cost = self.clock() - self._pre.pop(k, self.clock())
        if plan.index > 0:
            # window 0 of an attempt pays one-off warm-up (kernel builds,
            # library loads, vmap tracing) — a known one-off, not slowness;
            # a lane-batched window is N boards of work, normalized per
            # board
            self.wd.observe(run.slot.name, cost, lanes=run.lane_count)
            if run.scope_plane is not None:
                # lockstep's wall proxy is the dispatch cost; consumed by
                # _scope_observe at the next read-rate sample
                run.scope_wall_acc += cost
        self.telemetry.dispatch(run.slot.name, self._key(run, plan), cost)

    @control_thread_only
    def _on_drain(self, k: int, plan, records, ys):
        run = self._running[k]
        self.wd.heartbeat(run.slot.name, gap=False)
        self.telemetry.drain(run.slot.name, self._key(run, plan))
        if run.lanes is not None:
            delivered, faulted = self._lane_ingest(run, plan, records, ys)
            for lane, rec, y in delivered:
                run.lane_outputs[lane].append((plan, rec, y))
            for lane, exc in faulted:
                self._detach_lane(run, lane, f"lane veto: {exc}")
            if faulted and len(run.lane_faults) == len(run.lanes):
                run.fault = faulted[-1][1]          # every lane dead
            return
        if run.job.verify is not None and run.fault is None:
            try:
                run.job.verify(plan, records, ys)
            except Exception as e:          # noqa: BLE001 — veto, not crash
                self.telemetry.veto(run.slot.name)
                run.fault = e
        run.outputs.append((plan, records, ys))

    # ----------------------------------------------------------- internals --
    @staticmethod
    def _key(run: _Run, plan):
        return (run.job.name, run.job.attempts, plan.index)

    @control_thread_only
    def _pick_slot(self, avoid: Optional[str]) -> Optional[DeviceSlot]:
        out = self._unavailable()
        candidates = [s for s in self._free if s.name not in out]
        live = [s for s in self.slots if s.name not in out]
        s = pick_slot(candidates, avoid=avoid,
                      sole_candidate=len(live) == 1)
        if s is not None:
            self._free.remove(s)
        return s

    @control_thread_only
    def _probe_lockstep(self):
        """Inline breaker probe (lockstep has no slot threads): run the
        canary on the control thread for each benched slot past its
        cooldown, and apply the verdict immediately."""
        if self.policy is None:
            return
        now = self.clock()
        for name, t0 in list(self._benched.items()):
            if name in self._lost \
                    or now - t0 < self.policy.breaker_cooldown_s:
                continue
            slot = next(s for s in self.slots if s.name == name)
            self.telemetry.breaker(name, "probe")
            try:
                self._inject("slot.canary", slot=name)
                fn = self.policy.canary or _default_canary
                fn(slot)
            except BaseException as e:  # noqa: BLE001 — verdict, not crash
                self._canary_verdict(name, False, e)
            else:
                self._canary_verdict(name, True, None)

    @control_thread_only
    def _interrupt_lockstep(self):
        """Graceful stop (lockstep): cut every running client at this round
        boundary — run_many's evict check cancels it, its committed prefix
        and snapshots stay — and orphan the queue."""
        for k, run in list(self._running.items()):
            self._evicted.add(k)
            self._running.pop(k)
            self._free.append(run.slot)
            self._retire_interrupted(run)
        self._orphan_queue()

    @control_thread_only
    def _drain_interrupted(self):
        """Post-run sweep for a shutdown that landed after the last admit
        tick: everything still queued or running is interrupted."""
        for k, run in list(self._running.items()):
            self._running.pop(k)
            self._free.append(run.slot)
            self._retire_interrupted(run)
        self._orphan_queue()

    @control_thread_only
    def _retire_interrupted(self, run: _Run):
        """A shutdown-cut attempt: adopt its committed progress (snapshot
        + delivered prefix — a restarted farm resumes from there) and mark
        the job ``interrupted`` instead of requeueing."""
        if run.lanes is not None:
            self._retire_lanes(run, "shutdown", interrupted=True)
            return
        cursor = self._adopt_progress(run)
        if self.ledger is not None:
            self._deliver_upto(run.job, run.job.committed_outputs,
                               run.job._base, cursor)
        self.wd.forget(run.slot.name)
        run.job.status = "interrupted"
        self._journal("interrupted", job=run.job.name)

    @control_thread_only
    def _admit_one(self, job: FarmJob, slot: DeviceSlot) -> Client:
        members = self._gather_lanes(job, slot)
        run = self._new_run(members, slot)
        self.wd.heartbeat(slot.name, gap=False)
        return self._client_for(run, slot)

    @control_thread_only
    def _process_evictions(self):
        """Drain-boundary eviction sweep: watchdog stragglers + forced
        marks + drain-veto faults all take the same evict/requeue path."""
        marks: Dict[int, str] = {}
        if self.evict_stragglers and len(self._running) > 1:
            slow = set(self.wd.stragglers(self.straggler_factor,
                                          min_s=self.straggler_min_s,
                                          channel=self._straggler_channel()))
            for k, run in self._running.items():
                if run.slot.name in slow:
                    marks.setdefault(k, "straggler")
        with self._mu:
            force = set(self._force)
        for k, run in self._running.items():
            names = {run.job.name}
            if run.lanes is not None:   # force-marking a member cuts the
                names.update(m.name for m in run.lanes)  # whole fused run
            if names & force:
                marks.setdefault(k, "forced")
            if run.fault is not None:
                marks.setdefault(k, f"drain veto: {run.fault}")
        for k, why in marks.items():
            run = self._running[k]
            if (run.lanes is None and run.fault is None
                    and run.job.requeues >= self._budget(run.job)):
                continue                # budget spent: let it limp home
                # (lane runs skip the gate: members budget at requeue)
            self._evicted.add(k)
            self._running.pop(k)
            self._free.append(run.slot)
            if run.fault is not None and run.lanes is None:
                self._slot_result(run.slot.name, ok=False,
                                  why=f"veto: {run.fault}")
            self._requeue_or_fail(run, why)

    @control_thread_only
    def _adopt_progress(self, run: _Run) -> int:
        """Adopt a finished-badly attempt's last accepted snapshot as the
        job's resume point and retain the delivered windows up to its
        cursor. Returns the cursor window (0 = replay from the start).

        A snapshot whose windows never reached the control plane is NOT
        adopted: the job resumes from its previous cursor, so the
        exactly-once delivered prefix only ever grows from windows
        actually in hand."""
        job = run.job
        if (run.snapshot is not None and run.snapshot.window
                - run.start_window <= len(run.outputs)):
            job.committed_outputs.extend(
                run.outputs[:run.snapshot.window - run.start_window])
            job.snapshot = run.snapshot
        return job.snapshot.window if job.snapshot else 0

    @control_thread_only
    def _requeue_or_fail(self, run: _Run, why: str):
        """Shared evict/fault tail (boundary sweep AND the done()-path
        fault on a job's final window): adopt the attempt's committed
        progress, clear the slot's duration history so its next tenant is
        not judged against the evicted job's, drop any stale force mark,
        then requeue or fail on budget."""
        if run.lanes is not None:
            self._retire_lanes(run, why)
            return
        job = run.job
        cursor = self._adopt_progress(run)
        if self.ledger is not None:
            # the adopted committed prefix is deliverable NOW — held
            # windows would be lost if the process died before the
            # requeued attempt completed
            self._deliver_upto(job, job.committed_outputs, job._base,
                               cursor)
        # work lost to the eviction: drained-but-uncommitted windows that
        # the resumed attempt must re-run (0 when the evict landed on a
        # commit; the whole attempt under the no-barrier replay)
        job.windows_replayed += max(
            0, run.start_window + len(run.outputs) - cursor)
        self.wd.forget(run.slot.name)
        self.telemetry.eviction(run.slot.name, job.name, why)
        self._journal("evict", job=job.name, slot=run.slot.name,
                      why=str(why))
        self._requeue_member(job, run.slot.name, why)
