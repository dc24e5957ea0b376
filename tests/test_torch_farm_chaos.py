"""ZP-Chaos on the port (``repro_torch.farm.chaos``) and the farm's
failure-policy layer (``FailurePolicy``: retry budgets and backoff,
quarantine, slot circuit breakers; snapshot integrity fallback; graceful
shutdown) on the CPU: every case of the reference's
``tests/test_farm_chaos.py``, and the port held against the JAX package —
``build_schedule`` gives the reference's schedule for seeds 0–7 in both
modes, injection for injection, and ``run_chaos_smoke(7)`` fires and
recovers the same faults and quarantines the same board.

Every farm passes ``device="cpu"``. The backoff case runs on an injected
clock. The chaos gate (``run_chaos_smoke``) keeps the reference's wall
clock: its watchdog writes a board off after 1.5 s without a beat, and
its hung drain sleeps 2.5 times that, where a toy board's window takes
microseconds of host time.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    MemorySnapshotStore)
from repro_torch.core import DrainBarrier  # noqa: E402
from repro_torch.farm import (FailurePolicy, FarmError,  # noqa: E402
                              FarmJob, FarmManager, FarmTelemetry,
                              enumerate_slots)
from repro_torch.farm.chaos import (ChaosInjector,  # noqa: E402
                                    ChaosSnapshotStore, Injection,
                                    build_schedule)
from repro_torch.launch.farm import run_chaos_smoke  # noqa: E402


def _farm(**kw):
    return FarmManager(device="cpu", **kw)


def _submit(mgr, name, scale=2.0, n=6, barriers=True, max_requeues=6,
            engine=None):
    """One toy board: window w yields [w * scale] (bit-exact expected
    stream), optional per-window checkpoint barriers."""
    def body(state, shell, stack):
        return state + stack.sum(), shell, stack * scale

    outs: list = []
    job = FarmJob(
        name=name, engine=engine or body,
        windows=[[np.float32(w)] for w in range(n)],
        state=torch.tensor(0.0), shell={},
        stack_fn=lambda it: torch.as_tensor(np.stack(it)),
        on_drain=lambda p, r, y: outs.append(y),
        barriers=((DrainBarrier(every=1, action=lambda s, b: None),)
                  if barriers else ()),
        max_requeues=max_requeues)
    mgr.submit(job)
    return job, outs


def _assert_stream(outs, scale, n):
    assert len(outs) == n
    for w, got in enumerate(outs):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray([w * scale], np.float32))


class TickClock:
    """Injected clock: every read advances it by ``tick`` seconds (from
    any thread), so time passes as the farm runs, with no wall clock."""

    def __init__(self, tick=1e-3):
        self.t, self.tick = 0.0, tick
        self._lock = threading.Lock()

    def __call__(self) -> float:
        with self._lock:
            self.t += self.tick
            return self.t


# ------------------------------------------------------- the headline gate --
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("mode,seed", [("async", 7), ("lockstep", 7),
                                       ("async", 42)])
def test_chaos_smoke_recovers_every_fault(mode, seed):
    """The acceptance gate: a seeded schedule with >= 5 distinct fault
    kinds fires in full, every fault is recovered, non-quarantined boards
    deliver bit-identical-to-oracle outputs, and the genuinely poisoned
    board is dead-lettered instead of raising."""
    out = run_chaos_smoke(seed, mode=mode, slots=4, device="cpu")
    assert out["ok"], out["problems"]
    assert len({i["kind"] for i in out["schedule"]}) >= 5
    assert out["faults_injected"] == len(out["schedule"])
    assert out["quarantined"] == ["poison"]
    assert all(s == "done" for n, s in out["jobs"].items()
               if n != "poison")


def test_schedule_is_seed_deterministic_and_mode_scoped():
    mgr = _farm(slots=2, mode="lockstep")
    for i in range(8):
        _submit(mgr, f"b{i}")
    assert build_schedule(3, mgr.jobs) == build_schedule(3, mgr.jobs)
    assert build_schedule(3, mgr.jobs) != build_schedule(4, mgr.jobs)
    lock_kinds = {i.kind for i in
                  build_schedule(3, mgr.jobs, mode="lockstep")}
    # the control thread cannot detect its own hang: async-only kinds
    # never appear in a lockstep schedule
    assert not lock_kinds & {"hung_drain", "thread_death", "results_stall"}
    assert len(lock_kinds) >= 5


# ------------------------------------------------- quarantine / dead-letter --
@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_exhausted_budget_quarantines_instead_of_raising(mode):
    mgr = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01,
                policy=FailurePolicy(quarantine=True))

    def poison(state, shell, stack):
        raise RuntimeError("dead board")

    bad, _ = _submit(mgr, "bad", n=1, barriers=False, max_requeues=2,
                     engine=poison)
    _, outs = _submit(mgr, "good", scale=3.0, barriers=False)

    report = mgr.run(strict=True)       # must NOT raise
    assert report["jobs"]["bad"]["status"] == "quarantined"
    assert report["quarantined"] == ["bad"]
    assert bad.requeues == 2            # full budget consumed first
    assert report["jobs"]["good"]["status"] == "done"
    _assert_stream(outs, 3.0, 6)
    assert any(q["job"] == "bad"
               for q in report["telemetry"]["quarantined"])
    # every retry was logged with its attempt number
    attempts = [r["attempt"] for r in report["telemetry"]["retries"]
                if r["job"] == "bad"]
    assert attempts == [1, 2]


def test_legacy_no_policy_marks_failed_and_strict_raises():
    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False)

    def poison(state, shell, stack):
        raise RuntimeError("dead board")

    _submit(mgr, "bad", n=1, barriers=False, max_requeues=1, engine=poison)
    with pytest.raises(FarmError, match="bad"):
        mgr.run(strict=True)


def test_retry_backoff_gates_readmission():
    """A failed attempt re-enters admission only after its backoff, on
    the farm's injected clock: each attempt's first dispatch comes at
    least the logged backoff after the previous attempt's failure."""
    policy = FailurePolicy(backoff_base_s=0.05, backoff_factor=2.0,
                           backoff_max_s=0.2, quarantine=True)
    assert policy.backoff_for(1) == 0.05
    assert policy.backoff_for(2) == 0.10
    assert policy.backoff_for(10) == 0.2        # capped
    mgr = _farm(slots=2, mode="async", evict_stragglers=False,
                poll_s=0.005, policy=policy, clock=TickClock())
    flaky = {"left": 2}
    stamps = []

    def engine(state, shell, stack):
        stamps.append(mgr.clock())
        if flaky["left"] > 0:
            flaky["left"] -= 1
            raise RuntimeError("transient")
        return state + stack.sum(), shell, stack * 2.0

    _, outs = _submit(mgr, "flaky", n=3, barriers=False, max_requeues=4,
                      engine=engine)
    report = mgr.run()
    assert report["jobs"]["flaky"]["status"] == "done"
    _assert_stream(outs, 2.0, 3)
    backoffs = [r["backoff_s"] for r in report["telemetry"]["retries"]]
    assert backoffs[:2] == [0.05, 0.10]         # exponential, logged
    assert stamps[1] - stamps[0] >= 0.05
    assert stamps[2] - stamps[1] >= 0.10


# --------------------------------------------------------- circuit breaker --
def test_flapping_slot_trips_breaker_and_readmits_after_canary():
    """A slot failing threshold runs inside its scoring window is benched;
    it only re-enters placement after a PASSING canary probe — the first
    (injected-to-fail) probe re-arms the bench."""
    policy = FailurePolicy(breaker_window=4, breaker_threshold=2,
                           breaker_cooldown_s=0.0)
    slots = enumerate_slots(min_slots=2, device="cpu")
    mgr = _farm(slots=slots, mode="async", evict_stragglers=False,
                poll_s=0.01, policy=policy)
    flappy, healthy = slots[0].name, slots[1].name

    class HoldHealthy(ChaosInjector):
        """Holds the healthy slot's dispatches until the control plane has
        handled the flapping slot's first crash (the crashed job is back
        in the queue): otherwise the healthy slot can take every job
        first, and the flapping slot never gets the second job it must
        crash on to trip its breaker."""

        def fire(self, point, job=None, slot=None, **ctx):
            if point == "slot.dispatch" and slot == healthy:
                deadline = time.monotonic() + 30.0
                while not any(j.requeues for j in mgr.jobs) \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)
            return super().fire(point, job=job, slot=slot, **ctx)

    inj = HoldHealthy(telemetry=mgr.telemetry)
    inj.arm([
        Injection("slot_crash", "slot.dispatch", "slot", flappy, at=0),
        Injection("slot_crash", "slot.dispatch", "slot", flappy, at=1),
        Injection("canary_fail", "slot.canary", "slot", flappy, at=0),
    ])
    mgr.injector = inj
    outs = {}
    for i in range(4):
        _, outs[i] = _submit(mgr, f"j{i}", scale=float(i + 1), n=3,
                             barriers=False, max_requeues=3)

    report = mgr.run()
    assert not inj.pending                      # every injection fired
    for i in range(4):
        assert report["jobs"][f"j{i}"]["status"] == "done"
        _assert_stream(outs[i], float(i + 1), 3)
    assert report["telemetry"]["breaker_trips"] == {flappy: 1}
    events = [e["event"] for e in report["telemetry"]["breaker_events"]
              if e["slot"] == flappy]
    t = events.index("trip")
    after = events[t + 1:]
    # probe -> injected canary failure -> probe -> pass -> readmit, in
    # that order: re-admission strictly after a passing canary
    assert after.index("canary_fail") < after.index("canary_pass")
    assert after.index("canary_pass") < after.index("readmit")


# ------------------------------------------------------ snapshot integrity --
@pytest.mark.parametrize("kind", ["snapshot_truncate", "snapshot_corrupt"])
def test_torn_disk_snapshot_falls_back_to_previous_step(tmp_path, kind):
    """A truncated/corrupted ON-DISK snapshot: the requeue restores the
    newest older verifiable step, rewinds its cursor, logs the fallback,
    and still delivers a bit-identical stream."""
    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False,
                policy=FailurePolicy(quarantine=True))
    inj = ChaosInjector(telemetry=mgr.telemetry)
    job, outs = _submit(mgr, "ckpt", scale=2.0, n=6)
    job.snapshot_store = ChaosSnapshotStore(
        CheckpointManager(str(tmp_path / kind), keep=3), inj, "ckpt")
    # corrupt the snapshot published at the 3rd commit (step 3), then
    # crash at the very next dispatch so that snapshot is the newest one
    # the requeue tries to restore
    inj.arm([Injection(kind, "snapshot.store", "job", "ckpt", at=2),
             Injection("dispatch_exc", "slot.dispatch", "job", "ckpt",
                       at=3)])
    mgr.injector = inj

    report = mgr.run()
    assert not inj.pending
    assert report["jobs"]["ckpt"]["status"] == "done"
    falls = [f for f in report["telemetry"]["fallbacks"]
             if f["job"] == "ckpt"]
    assert falls and falls[0]["want_step"] == 3 \
        and falls[0]["got_step"] == 2
    _assert_stream(outs, 2.0, 6)                # exactly-once, in order
    assert report["jobs"]["ckpt"]["windows_replayed"] >= 1


def test_no_verifiable_snapshot_replays_from_window_zero():
    """Corrupting the job's ONLY published snapshot leaves nothing
    verifiable: the requeue rewinds to a window-0 replay (verifier
    included) and the fallback is logged with got_step=None."""
    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False,
                policy=FailurePolicy(quarantine=True))
    inj = ChaosInjector(telemetry=mgr.telemetry)
    job, outs = _submit(mgr, "solo", scale=2.0, n=4)
    job.snapshot_store = ChaosSnapshotStore(
        MemorySnapshotStore(keep=2), inj, "solo")
    inj.arm([Injection("snapshot_corrupt", "snapshot.store", "job",
                       "solo", at=0),
             Injection("dispatch_exc", "slot.dispatch", "job", "solo",
                       at=1)])
    mgr.injector = inj

    report = mgr.run()
    assert report["jobs"]["solo"]["status"] == "done"
    falls = [f for f in report["telemetry"]["fallbacks"]
             if f["job"] == "solo"]
    assert falls and falls[0]["got_step"] is None
    _assert_stream(outs, 2.0, 4)
    assert report["jobs"]["solo"]["windows_replayed"] >= 1


# -------------------------------------------- async checkpoint write errors --
def test_async_save_failure_surfaces_on_wait_and_next_save(
        tmp_path, monkeypatch):
    """A background checkpoint write failing (full disk) is never silent:
    the recorded error re-raises at the next wait() OR save(), exactly
    once, and the store still restores the last good step."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.arange(4, dtype=torch.float32)}
    mgr.save(state, step=1, blocking=True)

    real_save = np.save

    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(np, "save", full_disk)
    mgr.save(state, step=2)                     # async write fails
    with pytest.raises(OSError, match="No space"):
        mgr.save(state, step=3)                 # surfaces HERE, pre-write
    monkeypatch.setattr(np, "save", real_save)

    mgr.wait()                                  # error already consumed
    mgr.save(state, step=4)
    mgr.wait()
    tree, got = mgr.restore(state, fallback=True)
    assert got == 4
    assert torch.equal(tree["w"], torch.arange(4, dtype=torch.float32))
    # the torn step-2 attempt never became a restorable step
    assert 2 not in mgr.steps()


# ----------------------------------------------------------- graceful stop --
@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_request_shutdown_drains_at_barrier_and_keeps_snapshots(mode):
    """The long board asks for the shutdown from its verifier; in async
    mode its later dispatches hold until the stop is signalled, so it is
    cut mid-stream however fast its thread runs."""
    from test_torch_farm_async import hold_until_evicted

    mgr = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01)
    fired = {"done": False}

    def long_engine(state, shell, stack):
        if mode == "async" and fired["done"]:
            hold_until_evicted(mgr, "long")
        return state + stack.sum(), shell, stack * 2.0

    job, outs = _submit(mgr, "long", scale=2.0, n=40, engine=long_engine)
    _submit(mgr, "short", scale=3.0, n=2, barriers=False)

    def verify(plan, records, ys):
        if plan.index >= 5 and not fired["done"]:
            fired["done"] = True
            mgr.request_shutdown()

    job.verify = verify
    report = mgr.run(strict=True)       # interrupted is not a failure
    assert report["interrupted"] and mgr.interrupted
    assert report["jobs"]["long"]["status"] == "interrupted"
    assert report["jobs"]["short"]["status"] in ("done", "interrupted")
    # cut at a drain boundary WITH its committed snapshots intact: a
    # restarted farm could resume from the cursor
    assert report["jobs"]["long"]["windows_committed"] >= 1
    assert job.snapshot is not None
    assert job.snapshot_store.verify(job.snapshot.step)


# ------------------------------------------------------- bounded telemetry --
def test_telemetry_event_logs_are_bounded_with_dropped_counts():
    tele = FarmTelemetry(max_events=8)
    for i in range(20):
        tele.eviction("s0", f"j{i}", "why")
        tele.fault("slot.dispatch", "dispatch_exc", job=f"j{i}")
    r = tele.report()
    assert len(r["evictions"]) == 8
    assert len(r["faults"]) == 8
    assert r["events_dropped"] == {"evictions": 12, "faults": 12}
    # the newest events are the ones retained
    assert r["evictions"][-1]["job"] == "j19"
    assert "dropped:" in tele.summary()


# ----------------------------------------------------- injector determinism --
def test_injector_counts_per_scope_and_fires_exactly_once():
    inj = ChaosInjector()
    inj.arm([Injection("dispatch_exc", "slot.dispatch", "job", "a", at=2)])
    # occurrences 0 and 1 pass; other jobs/slots never match
    inj.fire("slot.dispatch", job="a", slot="s0")
    inj.fire("slot.dispatch", job="b", slot="s0")
    inj.fire("slot.dispatch", job="a", slot="s1")
    with pytest.raises(Exception, match="dispatch_exc"):
        inj.fire("slot.dispatch", job="a", slot="s0")
    assert not inj.pending
    assert len(inj.fired) == 1
    inj.fire("slot.dispatch", job="a")          # consumed: never re-fires


def test_injector_fire_is_thread_safe_single_winner():
    inj = ChaosInjector()
    inj.arm([Injection("boom", "p", "job", "j", at=50)])
    hits, lock = [], threading.Lock()

    def hammer():
        for _ in range(50):
            try:
                inj.fire("p", job="j")
            except Exception:
                with lock:
                    hits.append(1)

    ts = [threading.Thread(target=hammer) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in ts)
    assert len(hits) == 1                       # exactly one thread won
    assert not inj.pending


# -------------------------------------------------- against the reference --
@pytest.fixture(scope="module")
def jchaos():
    """The reference's chaos module, its farm manager and its farm CLI."""
    pytest.importorskip("jax")
    from test_torch_ssm import import_reference
    chaos, manager, cli = import_reference(
        "repro.farm.chaos", "repro.farm.manager", "repro.launch.farm")
    return dict(chaos=chaos, manager=manager, cli=cli)


def _toy_jobs(job_cls):
    """Eight boards of the chaos smoke's shape (6 windows, a barrier at
    every window) and two of other lengths, one without barriers (the
    schedule reads names, window counts and whether there are
    barriers)."""
    def job(name, n, barriers):
        return job_cls(
            name=name, engine=None,
            windows=[[np.float32(w)] for w in range(n)],
            barriers=(DrainBarrier(every=1, action=None),) if barriers
            else ())
    return [job(f"board{i}", 6, True) for i in range(8)] \
        + [job("long", 11, True), job("bare", 3, False)]


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_build_schedule_matches_the_reference(jchaos, mode):
    """For seeds 0-7, the port's schedule over the same jobs is the
    reference's, injection for injection (kind, point, scope, job,
    occurrence and parameter)."""
    jjobs = _toy_jobs(jchaos["manager"].FarmJob)
    tjobs = _toy_jobs(FarmJob)
    for seed in range(8):
        want = jchaos["chaos"].build_schedule(seed, jjobs, mode=mode)
        got = build_schedule(seed, tjobs, mode=mode)
        assert [dataclasses.astuple(i) for i in got] == \
            [dataclasses.astuple(i) for i in want], seed


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_chaos_smoke_matches_the_reference(jchaos, mode):
    """``run_chaos_smoke(7)`` in the port and in the reference: the same
    schedule fires in full, every fault recovered on both sides, the same
    jobs done and the same board quarantined."""
    want = jchaos["cli"].run_chaos_smoke(7, mode=mode, slots=4)
    got = run_chaos_smoke(7, mode=mode, slots=4, device="cpu")
    assert want["ok"] and got["ok"], (want["problems"], got["problems"])
    assert got["schedule"] == want["schedule"]
    assert got["faults_injected"] == want["faults_injected"]
    assert got["jobs"] == want["jobs"]
    assert got["quarantined"] == want["quarantined"] == ["poison"]
