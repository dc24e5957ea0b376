"""ZP-Chaos: deterministic fault injection for the co-emulation farm.

A week-long farm campaign dies to the faults nobody rehearsed: a board
crashing mid-window, a hung drain, a torn checkpoint, a dispatcher thread
dying silently. This module makes every one of those REHEARSABLE: a
seeded, reproducible fault schedule is threaded into the farm's named
injection points, and a gate verifies that the failure-policy layer
(:class:`~repro_torch.farm.manager.FailurePolicy`) absorbed every injected
fault — with the surviving outputs bit-identical to a fault-free run.

Injection points (fired via ``FarmManager._inject`` /
``ClientDriver.inject``; every one is a no-op in production):

  ``slot.dispatch``   right before a window's engine call
  ``slot.drain``      as a window's drain starts retiring
  ``slot.commit``     right before a crossed barrier's actions
  ``job.verify``      inside the job's drain verifier (harness wrapper)
  ``snapshot.store``  right after a snapshot publish (harness wrapper)
  ``snapshot.publish``  at the manager's snapshot hook
  ``worker.loop``     a slot thread picking up an assignment (async)
  ``results.post``    before a drain posts to the results queue (async)
  ``slot.canary``     a circuit-breaker probe running
  ``ledger.<kind>``   right AFTER a ZP-Ledger journal record lands
                      (``ledger.commit``, ``ledger.deliver``, ...) — the
                      window where the journal is ahead of everything
                      the manager would have done next

Fault kinds and the recovery each must produce:

  ``dispatch_exc``      engine call raises        -> crash evict + requeue
  ``slot_crash``        drain path raises         -> crash evict + requeue
  ``commit_divergence`` verifier raises once      -> veto evict + replay
  ``snapshot_corrupt``  published bytes flipped   -> integrity fallback
  ``snapshot_truncate`` published snapshot torn   -> integrity fallback
  ``hung_drain``        drain sleeps past the watchdog  (async only)
                                                  -> board abandoned
  ``thread_death``      slot thread dies pre-job  (async only)
                                                  -> liveness requeue
  ``results_stall``     results hand-off delayed  (async only)
                                                  -> completion, late
  ``process_kill``      SIGKILL the whole farm process (ZP-Ledger only —
                        armed by the kill-restart harness, never by the
                        seeded menus)             -> FarmManager.recover
                        in a fresh process resumes from the journal

Determinism: occurrences are counted PER JOB (and per slot) at each
point. A job's own sequence of dispatch/drain/verify/store events is
deterministic regardless of how the async farm interleaves jobs across
slots, so a job-scoped :class:`Injection` fires at the same logical
moment on every run with the same seed. Chaos runs should disable
straggler eviction (wall-time heuristics are the one nondeterministic
eviction source) — ``launch.farm --chaos`` does.

Snapshot faults are scheduled as a PAIR: corrupt the snapshot published
at store-occurrence *k*, then crash the job at dispatch-occurrence *k+1*
— the very next window — so the corrupted snapshot is still the newest
when the requeue restores, before retention ages it out.
"""
from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading
import time
from collections import defaultdict
from typing import List, Optional

import torch

from repro_torch.checkpoint.manager import MemorySnapshotStore
from repro_torch.utils import tree_paths_sorted


class ChaosError(RuntimeError):
    """The exception every raising injection throws — recovery paths must
    treat it like any board fault (nothing matches on this type)."""


#: kinds whose injection raises ChaosError at the point (any kind not in
#: the sleep/corrupt sets raises — custom kinds in tests behave this way)
RAISE_KINDS = frozenset({"dispatch_exc", "slot_crash", "thread_death",
                         "commit_divergence"})
SLEEP_KINDS = frozenset({"hung_drain", "results_stall"})
CORRUPT_KINDS = frozenset({"snapshot_corrupt", "snapshot_truncate"})
#: whole-process death: os.kill(SIGKILL) — no handler, no cleanup, no
#: atexit; the only recovery is FarmManager.recover in a NEW process
KILL_KINDS = frozenset({"process_kill"})

#: the full fault menu per farm mode: the lockstep control thread cannot
#: detect its own hang, so the async-only kinds are excluded there
LOCKSTEP_KINDS = ("dispatch_exc", "slot_crash", "commit_divergence",
                  "snapshot_corrupt", "snapshot_truncate")
ASYNC_KINDS = LOCKSTEP_KINDS + ("hung_drain", "thread_death",
                                "results_stall")


@dataclasses.dataclass(frozen=True)
class Injection:
    """One scheduled fault: fire ``kind`` at the ``at``-th occurrence of
    ``point`` for ``scope``/``name`` (``scope="job"`` counts one job's
    events — deterministic under async interleaving; ``scope="slot"``
    counts one seat's, for breaker/canary tests). ``param`` is the sleep
    length for the sleeping kinds."""
    kind: str
    point: str
    scope: str
    name: str
    at: int
    param: float = 0.0


class ChaosInjector:
    """The armed schedule + occurrence counters behind every injection
    point. ``fire`` is called from control AND slot threads; matching is
    lock-protected, the fault effect itself (raise/sleep) runs outside
    the lock so a sleeping injection never blocks other threads' fires."""

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self._pending = {}          # (point, scope, name, at) -> Injection
        self._counts = defaultdict(int)     # (point, scope, name) -> n
        self.fired: List[Injection] = []
        self._lock = threading.Lock()

    def arm(self, schedule):
        with self._lock:    # arming can race already-running fires
            for inj in schedule:
                self._pending[(inj.point, inj.scope, inj.name,
                               inj.at)] = inj

    @property
    def pending(self) -> List[Injection]:
        with self._lock:
            return list(self._pending.values())

    def fire(self, point: str, job: Optional[str] = None,
             slot: Optional[str] = None, **ctx) -> Optional[Injection]:
        hit = None
        with self._lock:
            # scope "farm" counts EVERY occurrence of the point across
            # all jobs/slots (name "*") — how the kill-restart harness
            # says "die at the Nth journaled commit, whoever commits it"
            for scope, name in (("job", job), ("slot", slot),
                                ("farm", "*")):
                if name is None:
                    continue
                key = (point, scope, name)
                n = self._counts[key]
                self._counts[key] = n + 1
                inj = self._pending.pop((point, scope, name, n), None)
                if inj is not None and hit is None:
                    hit = inj
            if hit is not None:
                self.fired.append(hit)
        if hit is None:
            return None
        if self.telemetry is not None:
            self.telemetry.fault(point, hit.kind, job=job or "",
                                 slot=slot or "", event="injected")
        if hit.kind in SLEEP_KINDS:
            time.sleep(hit.param)
            return None
        if hit.kind in CORRUPT_KINDS:
            return hit              # the caller applies the corruption
        if hit.kind in KILL_KINDS:
            # whole-process death, the real thing: no exception to catch,
            # no finally blocks, no flushes — nothing below here runs
            os.kill(os.getpid(), signal.SIGKILL)
        raise ChaosError(
            f"injected {hit.kind} at {point} "
            f"({hit.scope} {hit.name}, occurrence {hit.at})")


class _VerifyTap:
    """Per-job verifier wrapper routing the ``job.verify`` point — a
    ``commit_divergence`` injection raises HERE, so the farm sees it as a
    drain veto (transient: the replayed window verifies clean)."""

    def __init__(self, injector: ChaosInjector, job: str, inner):
        self._injector = injector
        self._job = job
        self._inner = inner

    def __call__(self, plan, records, ys):
        self._injector.fire("job.verify", job=self._job)
        if self._inner is not None:
            self._inner(plan, records, ys)


class _StatefulVerifyTap(_VerifyTap):
    """Variant exposing the CommitStreamVerifier snapshot protocol only
    when the wrapped verifier has it (the manager feature-detects)."""

    def snapshot(self):
        return self._inner.snapshot()

    def restore(self, snap):
        self._inner.restore(snap)


def _wrap_verify(injector: ChaosInjector, job: str, inner):
    if hasattr(inner, "snapshot") and hasattr(inner, "restore"):
        return _StatefulVerifyTap(injector, job, inner)
    return _VerifyTap(injector, job, inner)


class ChaosSnapshotStore:
    """Snapshot-store wrapper applying ``snapshot_corrupt`` /
    ``snapshot_truncate`` injections to the snapshot JUST published —
    modelling a torn write or bit flip between publish and restore. Works
    on both store families: in-memory (a byte of the first leaf, in
    sorted-key order, flipped / tree replaced with a wrong-structure stub)
    and on-disk ``CheckpointManager`` (a leaf file's bytes flipped /
    truncated to half)."""

    def __init__(self, inner, injector: ChaosInjector, job: str):
        self.inner = inner
        self.injector = injector
        self.job = job

    def save(self, state, step: int, blocking: bool = True):
        self.inner.save(state, step=step)
        hit = self.injector.fire("snapshot.store", job=self.job)
        if hit is None:
            return
        self.inner.wait()           # the async write must land first
        if hasattr(self.inner, "_snaps"):       # MemorySnapshotStore
            s = max(self.inner._snaps)
            if hit.kind == "snapshot_truncate":
                self.inner._snaps[s] = {
                    "torn": torch.zeros(1, dtype=torch.uint8)}
            else:
                leaf = tree_paths_sorted(self.inner._snaps[s])[0][1]
                leaf.view(-1).view(torch.uint8)[0] ^= 0xFF
        else:                                   # CheckpointManager
            s = max(self.inner.steps())
            d = self.inner.dir / f"step_{s:08d}"
            fp = sorted(d.glob("*.npy"))[0]
            data = fp.read_bytes()
            if hit.kind == "snapshot_truncate":
                fp.write_bytes(data[:max(1, len(data) // 2)])
            else:
                torn = bytearray(data)
                torn[-1] ^= 0xFF
                fp.write_bytes(bytes(torn))

    def wait(self):
        self.inner.wait()

    def steps(self):
        return self.inner.steps()

    def verify(self, step):
        return self.inner.verify(step)

    def restore(self, like=None, step=None, fallback=False, **kw):
        return self.inner.restore(like, step=step, fallback=fallback, **kw)


def _n_windows(job) -> int:
    w = job.windows() if callable(job.windows) else job.windows
    return sum(1 for _ in w)


def build_schedule(seed: int, jobs, mode: str = "async",
                   hang_s: float = 3.0,
                   stall_s: float = 0.05) -> List[Injection]:
    """Seeded fault schedule over the submitted jobs: each fault kind in
    the mode's menu lands on a DIFFERENT job (at most one fault — or one
    corrupt+crash pair — per job keeps the occurrence arithmetic exact),
    at a seeded window. Jobs without barriers are skipped for the
    snapshot kinds; kinds with no eligible job left are dropped."""
    rng = random.Random(seed)
    kinds = list(LOCKSTEP_KINDS if mode == "lockstep" else ASYNC_KINDS)
    pool = sorted(jobs, key=lambda j: j.name)
    rng.shuffle(pool)
    sched: List[Injection] = []
    for kind in kinds:
        pick = None
        for i, j in enumerate(pool):
            if kind in CORRUPT_KINDS and not (
                    j.barriers and _n_windows(j) >= 2):
                continue
            pick = pool.pop(i)
            break
        if pick is None:
            continue
        name, n = pick.name, _n_windows(pick)
        if kind == "dispatch_exc":
            sched.append(Injection(kind, "slot.dispatch", "job", name,
                                   at=rng.randrange(n)))
        elif kind == "slot_crash":
            sched.append(Injection(kind, "slot.drain", "job", name,
                                   at=rng.randrange(n)))
        elif kind == "hung_drain":
            sched.append(Injection(kind, "slot.drain", "job", name,
                                   at=rng.randrange(n), param=hang_s))
        elif kind == "commit_divergence":
            sched.append(Injection(kind, "job.verify", "job", name,
                                   at=rng.randrange(n)))
        elif kind == "thread_death":
            sched.append(Injection(kind, "worker.loop", "job", name, at=0))
        elif kind == "results_stall":
            sched.append(Injection(kind, "results.post", "job", name,
                                   at=rng.randrange(n), param=stall_s))
        else:                       # snapshot_corrupt / snapshot_truncate
            k = rng.randrange(n - 1)
            sched.append(Injection(kind, "snapshot.store", "job", name,
                                   at=k))
            # the paired crash: evict at the NEXT dispatch so the corrupt
            # snapshot is the newest one the requeue tries to restore
            sched.append(Injection("dispatch_exc", "slot.dispatch", "job",
                                   name, at=k + 1))
    return sched


class ChaosHarness:
    """Arms a :class:`FarmManager` with a seeded fault schedule and gates
    its report: every scheduled fault fired, every fired fault shows its
    recovery evidence, every job landed ``done`` (or ``quarantined`` when
    genuinely poisoned). Bit-identity against the fault-free oracle is
    the CALLER's half of the gate (``launch.farm --chaos`` runs both)."""

    def __init__(self, mgr, seed: int, hang_s: Optional[float] = None,
                 stall_s: float = 0.05):
        self.mgr = mgr
        self.seed = seed
        timeout = float(getattr(mgr.wd, "timeout_s", 3.0))
        self.hang_s = timeout * 2.5 if hang_s is None else hang_s
        self.stall_s = stall_s
        self.injector = ChaosInjector(telemetry=mgr.telemetry)
        self.schedule: List[Injection] = []

    def arm(self) -> List[Injection]:
        """Build the schedule over the manager's submitted jobs, wrap
        each job's verifier and snapshot store, install the injector.
        Call after every ``submit()``, before ``run()``."""
        self.schedule = build_schedule(self.seed, self.mgr.jobs,
                                       mode=self.mgr.mode,
                                       hang_s=self.hang_s,
                                       stall_s=self.stall_s)
        self.injector.arm(self.schedule)
        for job in self.mgr.jobs:
            job.verify = _wrap_verify(self.injector, job.name, job.verify)
            if job.barriers:
                inner = job.snapshot_store or MemorySnapshotStore(keep=2)
                job.snapshot_store = ChaosSnapshotStore(
                    inner, self.injector, job.name)
        self.mgr.injector = self.injector
        return self.schedule

    def gate(self, report: dict,
             expect_quarantined=()) -> List[str]:
        """Return the list of gate violations (empty = chaos run passed):
        unfired injections, jobs in a non-recovered terminal status, and
        fired faults with no recovery evidence in the telemetry."""
        problems: List[str] = []
        left = self.injector.pending
        for inj in left:
            problems.append(f"never fired: {inj}")
        tele = report["telemetry"]
        evs = tele["evictions"]
        falls = tele["fallbacks"]
        fired = set(self.injector.fired)
        for inj in self.schedule:
            if inj not in fired:
                continue
            name = inj.name
            if inj.kind in ("dispatch_exc", "slot_crash"):
                ok = any(e["job"] == name and "crash" in e["why"]
                         for e in evs)
            elif inj.kind in ("thread_death", "hung_drain"):
                ok = any(e["job"] == name and ("hung" in e["why"]
                                               or "lost" in e["why"])
                         for e in evs)
            elif inj.kind == "commit_divergence":
                ok = any(e["job"] == name and "veto" in e["why"]
                         for e in evs)
            elif inj.kind in CORRUPT_KINDS:
                ok = any(f["job"] == name for f in falls)
            else:                   # results_stall: completing IS recovery
                ok = report["jobs"][name]["status"] == "done"
            if not ok:
                problems.append(f"no recovery evidence for {inj}")
        for name, j in report["jobs"].items():
            want = ("quarantined",) if name in expect_quarantined \
                else ("done",)
            if j["status"] not in want:
                problems.append(
                    f"job {name}: status {j['status']}, wanted {want}")
        n_logged = sum(f["event"] == "injected" for f in tele["faults"])
        if n_logged != len(self.injector.fired):
            problems.append(
                f"fault log records {n_logged} injections, "
                f"injector fired {len(self.injector.fired)}")
        return problems
