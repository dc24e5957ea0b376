"""FarmManager: the FireSim-manager analog for multi-device co-emulation.

The paper's end state is a *farm* of scaled-down DUTs — many independently
prototyped subsystems co-emulated concurrently behind one host. This
module is the orchestration layer over the core ``WindowScheduler``
machinery, in its lockstep host-loop mode:

  lockstep (``mode="lockstep"``) — ONE Python thread round-robins every
      slot through ``WindowScheduler.run_many``. Deterministic round
      structure, but one slow board's dispatch delays every other board's
      enqueue, and "straggler" is inferred from per-board dispatch cost
      because inter-drain gaps are the round time. It is the reference's
      bit-identity ORACLE for its async mode.

The async mode (one dispatcher thread per slot), the failure-policy layer
(``policy=FailurePolicy(...)``: retry backoff, quarantine, slot circuit
breakers), the durable journal (``ledger=``, ``FarmJob.spec``,
``submit_spec``, ``recover``) and fault injection (``injector``) are the
next slice of the port's farm; each raises NotImplementedError naming it.
``certify=True`` waits for ZP-Cert and ``FarmJob.capture`` for the
roofline slice.

Semantics:

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

The port's engines may update their state in place, so every attempt
dispatches from fresh copies of ``FarmJob.state``/``shell`` (or from
zero-arg factories), and snapshots are host copies: the job's own trees
stay valid replay sources across requeues.
"""
from __future__ import annotations

import dataclasses
import itertools
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
                                        pick_slot, place, place_stack)
from repro_torch.farm.telemetry import FarmTelemetry
from repro_torch.utils import resolve_device, tree_leaves, tree_map, \
    tree_structure

# what the port's lockstep farm refuses, and the slice that adds it
NEXT_SLICE = ("waits for the next slice of the port's farm (ROADMAP.md "
              "Queue 1 item 5: the async slot threads, the failure "
              "policy, the ledger, the registry, recover, ZP-Chaos and "
              "the farm CLI)")


def _refuse(what: str):
    raise NotImplementedError(f"{what} {NEXT_SLICE}")


class FarmError(RuntimeError):
    pass


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
    re-runs on replay); ``on_drain(plan, records, ys)`` is the
    exactly-once, in-order sink delivered at completion. ``barriers`` are
    per-job :class:`DrainBarrier`\\ s (e.g. checkpoint saves) whose
    actions are skipped while the job has a recorded fault — the
    commit-veto contract; every ACCEPTED commit also publishes a resume
    snapshot to ``snapshot_store`` (``None`` = an in-memory
    :class:`~repro_torch.checkpoint.MemorySnapshotStore`; pass a per-job
    ``CheckpointManager`` for on-disk durability). ``verify`` may expose
    ``snapshot()``/``restore(snap)`` (the ``CommitStreamVerifier``
    protocol) to ride the same resume point. ``drain_fn`` / ``stack_fn``
    / ``reset`` are the per-client scheduler plumbing (``None`` =
    shell-less). ``capture`` (the roofline's ``WindowCapture``) and
    ``spec`` (the registry's ``JobSpec``) are refused at submit until
    their slices land."""
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
    spec: Any = None                    # registry.JobSpec (refused)

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
    committed_outputs: List = dataclasses.field(
        default_factory=list, init=False)   # committed windows:
    # committed_outputs[i] is window (_base + i)
    windows_delivered: int = dataclasses.field(default=0, init=False)
    # ^ exactly-once on_drain cursor: windows [0, windows_delivered) have
    # been handed to the sink
    _base: int = dataclasses.field(default=0, init=False)
    # ^ recovery resume base (windows a dead predecessor process
    # delivered; 0 until the ledger's recover is ported)
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
    """One admission of a job onto a slot (client index ``idx``)."""

    def __init__(self, job: FarmJob, slot: DeviceSlot, idx: int):
        self.job = job
        self.slot = slot
        self.idx = idx
        self.outputs: List = []
        self.fault: Optional[BaseException] = None
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


class FarmManager(ClientPolicy):
    """Job queue + placement + watchdog + eviction over one lockstep
    ``WindowScheduler.run_many`` pass (see module docstring). ``slots``
    may be a slot list, an int (minimum concurrency; virtual slots fill in
    on a single card), or None (``max(min_slots, n_devices)``, capped at
    the number of submitted jobs); auto-built slots sit on ``device``
    (the visible CUDA devices by default, which must exist; ``"cpu"``:
    the host). ``lanes`` sets the lane capacity of auto-built slots: at
    admission, queued jobs sharing a ``lane_key`` (and
    :func:`lane_compatible` in engine/plumbing/window shape) are coalesced
    into ONE vmap-fused run of up to that many boards per dispatch
    stream. ``clock`` times dispatch costs (the straggler signal) and
    telemetry; tests inject one."""

    def __init__(self, slots: Any = None, min_slots: int = 3,
                 scheduler: Optional[WindowScheduler] = None,
                 watchdog: Optional[Watchdog] = None,
                 straggler_factor: float = 3.0,
                 straggler_min_s: float = 0.01,
                 evict_stragglers: bool = True,
                 telemetry: Optional[FarmTelemetry] = None,
                 mode: str = "lockstep",
                 policy: Any = None,
                 lanes: int = 1,
                 ledger: Any = None,
                 certify: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        if mode == "async":
            _refuse('mode="async" (one dispatcher thread per slot)')
        if mode != "lockstep":
            raise ValueError(f"unknown farm mode: {mode!r}")
        if policy is not None:
            _refuse("policy=FailurePolicy(...) (retry backoff, quarantine, "
                    "slot circuit breakers)")
        if ledger is not None:
            _refuse("ledger= (the durable farm journal)")
        if certify:
            raise NotImplementedError(
                "certify=True waits for ZP-Cert, the static board "
                "certifier of the port's analysis/ (ROADMAP.md Queue 1 "
                "item 6)")
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
        self.clock = clock

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
        self._shutdown = threading.Event()

    # ------------------------------------------------------------- intake --
    @property
    def injector(self):
        """The chaos harness hook (``None``: no fault injection)."""
        return None

    @injector.setter
    def injector(self, value):
        if value is not None:
            _refuse("a fault injector (ZP-Chaos)")

    @control_thread_only
    def submit(self, job: FarmJob) -> FarmJob:
        if job.spec is not None:
            _refuse("FarmJob.spec (the registry's serializable JobSpec)")
        if job.capture is not None:
            raise NotImplementedError(
                "FarmJob.capture (a measured-window roofline capture) "
                "waits for the roofline slice of the port (roofline/, "
                "WindowCapture)")
        self.jobs.append(job)
        self.queue.append(job)
        return job

    def submit_spec(self, spec, registry: Any = None) -> FarmJob:
        _refuse("submit_spec (journaled JobSpec intake)")

    @classmethod
    def recover(cls, ledger, registry: Any = None, **kwargs):
        _refuse("FarmManager.recover (rebuilding a farm from its journal)")

    @any_thread
    def force_evict(self, job_name: str):
        """Mark a job for eviction at its next drain boundary (the
        deterministic test/CLI path — the watchdog path is timing).
        Safe from any thread: the mark set is shared with the control
        plane's sweep, so it is mutated under ``_mu``."""
        with self._mu:
            self._force.add(job_name)

    def request_shutdown(self):
        """Graceful stop: no new admissions, every running job is cut at
        its NEXT drain boundary keeping its committed prefix and published
        snapshots, queued + cut jobs are marked ``interrupted``, and
        ``run()`` returns with the report. Safe to call from a signal
        handler or another thread."""
        self._shutdown.set()

    @property
    def interrupted(self) -> bool:
        return self._shutdown.is_set()

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
        self._free = list(self.slots)
        # the initial client list MUST be empty: every client enters via
        # admit(), so the scheduler's positional indices stay in lockstep
        # with _next_idx and the callbacks route to the right _Run
        self.sched.run_many([], on_drain=self._on_drain,
                            on_dispatch=self._on_dispatch,
                            place_fn=self._place, policy=self,
                            on_commit=self._on_commit)
        if self._shutdown.is_set():
            self._drain_interrupted()
        report = self.report()
        if strict:
            # interrupted jobs are a requested stop, not a farm failure
            failed = [n for n, j in report["jobs"].items()
                      if j["status"] not in ("done", "interrupted")]
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
            "interrupted": self._shutdown.is_set(),
            "telemetry": self.telemetry.report(),
        }

    def scope_report(self) -> dict:
        """Fleet-wide ZP-Scope counter table (see
        :meth:`FarmTelemetry.scope_report`)."""
        return self.telemetry.scope_report()

    @control_thread_only
    def _orphan_queue(self):
        """Mark everything still queued ``interrupted``."""
        while self.queue:
            job = self.queue.popleft()
            if job.status != "done":
                job.status = "interrupted"

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
        while self.queue and len(members) < cap:
            cand = self.queue.popleft()
            if (self._avoid.get(cand.name) != slot.name
                    and lane_compatible(job, cand) is None):
                members.append(cand)
            else:
                skipped.append(cand)
        self.queue.extendleft(reversed(skipped))
        return members

    @control_thread_only
    def _new_run(self, members: List[FarmJob], slot: DeviceSlot) -> _Run:
        if len(members) > 1:
            run = self._make_lane_run(members, slot)
        else:
            job = members[0]
            job.attempts += 1
            job.status = "running"
            job.last_slot = slot.name
            run = _Run(job, slot, self._next_idx)
            self._next_idx += 1
        self.telemetry.lanes(slot.name, len(members))
        self._running[run.idx] = run
        return run

    @control_thread_only
    def _make_lane_run(self, members: List[FarmJob],
                       slot: DeviceSlot) -> _Run:
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
        run = _Run(fused, slot, self._next_idx)
        self._next_idx += 1
        run.lanes = list(members)
        run.lane_batch = lb
        run.lane_outputs = [[] for _ in members]
        for m in members:
            m.attempts += 1
            m.status = "running"
            m.last_slot = slot.name
            self._avoid.pop(m.name, None)
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
        """Publish the job's resume point at an accepted barrier commit.
        The payload is host-copied by the store's save, so it survives
        in-place updates and slot loss; the cursor handle on the run is
        what the control plane reads at requeue time."""
        job = run.job
        # snapshots hold the DUT shell only: scope counters ride BESIDE
        # the DUT and restart on requeue (observability, not progress)
        shell = zp_scope.unwrap(shell)
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
        Drained samples fan into telemetry + the watchdog's device-side
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
        rather than averaged in."""
        if run is None:                 # the attempt is gone
            return
        self.telemetry.scope(run.slot.name, run.job.name, sample)
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
        """Snapshot hook: publish unless the attempt is faulted — the veto
        contract keeps the resume point BEFORE a rejected window."""
        run = self._running.get(k)
        if run is None or run.fault is not None:
            return
        self._publish_snapshot(run, plan, state, shell)

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
                if run.fault is None:
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
        if job.on_drain is not None:
            for plan, records, ys in outputs:       # exactly-once, in order
                job.on_drain(plan, records, ys)
        job.windows_delivered = len(outputs)

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
        # the vetoed window itself re-runs on the solo attempt too
        m.windows_replayed += max(
            0, len(run.lane_outputs[lane]) - cursor) + 1
        self.telemetry.eviction(run.slot.name, m.name, why)
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
            m.windows_replayed += max(
                0, len(run.lane_outputs[lane]) - cursor)
            if interrupted:
                m.status = "interrupted"
            else:
                self._requeue_member(m, run.slot.name, why)

    @control_thread_only
    def _requeue_member(self, job: FarmJob, slot_name: str, why: str):
        """The requeue/fail tail shared by solo attempts and detached lane
        members (budget, avoid preference)."""
        with self._mu:
            self._force.discard(job.name)
        if job.requeues < job.max_requeues:
            job.requeues += 1
            self.telemetry.retry(job.name, job.requeues, 0.0, why)
            job.status = "queued"
            self._avoid[job.name] = slot_name
            self.queue.appendleft(job)
        else:
            job.status = "failed"
            job.error = why

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
            if m.on_drain is not None:
                for plan, records, ys in outputs:
                    m.on_drain(plan, records, ys)
            m.windows_delivered = len(outputs)

    # ----------------------------------------------- ClientPolicy protocol --
    @control_thread_only
    def admit(self, round_idx: int):
        if self._shutdown.is_set():
            self._interrupt_lockstep()
            return ()
        self._process_evictions()
        admissions = []
        deferred = []
        while self.queue and self._free:
            job = self.queue.popleft()
            slot = self._pick_slot(self._avoid.get(job.name))
            if slot is None:        # only its old slot is free: wait for
                deferred.append(job)        # a DIFFERENT one
                continue
            self._avoid.pop(job.name, None)
            admissions.append(self._admit_one(job, slot))
        self.queue.extendleft(reversed(deferred))
        if not admissions and not self._running and self.queue:
            # STALLED: jobs queued, nothing running, nothing admitted —
            # only the avoid preference blocks, and no other slot will
            # ever free, so it must yield (progress guarantee); lockstep
            # has no background tick, so run_many's round loop would
            # otherwise exit with jobs stranded
            slot = self._pick_slot(None)
            if slot is None:
                raise FarmError("no live slots left to place queued jobs")
            job = self.queue.popleft()
            self._avoid.pop(job.name, None)
            admissions.append(self._admit_one(job, slot))
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
            self._requeue_or_fail(run, f"drain veto: {run.fault}")
            return
        self._finish_run(run, state, shell)

    @control_thread_only
    def crashed(self, k: int, exc: BaseException) -> bool:
        """Crash absorption (the ClientPolicy hook run_many offers a
        raising driver to): a client crashing mid-drive is a board fault,
        not a farm failure — free the seat, requeue or fail the job, keep
        the pass alive."""
        run = self._running.pop(k, None)
        if run is None:
            return False
        self._free.append(run.slot)
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
        s = pick_slot(self._free, avoid=avoid,
                      sole_candidate=len(self.slots) == 1)
        if s is not None:
            self._free.remove(s)
        return s

    @control_thread_only
    def _interrupt_lockstep(self):
        """Graceful stop: cut every running client at this round boundary
        — run_many's evict check cancels it, its committed prefix and
        snapshots stay — and orphan the queue."""
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
        self._adopt_progress(run)
        self.wd.forget(run.slot.name)
        run.job.status = "interrupted"

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
                    and run.job.requeues >= run.job.max_requeues):
                continue                # budget spent: let it limp home
                # (lane runs skip the gate: members budget at requeue)
            self._evicted.add(k)
            self._running.pop(k)
            self._free.append(run.slot)
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
        # work lost to the eviction: drained-but-uncommitted windows that
        # the resumed attempt must re-run (0 when the evict landed on a
        # commit; the whole attempt under the no-barrier replay)
        job.windows_replayed += max(
            0, run.start_window + len(run.outputs) - cursor)
        self.wd.forget(run.slot.name)
        self.telemetry.eviction(run.slot.name, job.name, why)
        self._requeue_member(job, run.slot.name, why)
