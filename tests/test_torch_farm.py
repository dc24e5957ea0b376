"""The port's ZP-Farm (``repro_torch.farm``) on the CPU: every case of
the reference's ``tests/test_farm.py`` and the cases of
``tests/test_farm_resume.py`` that need no ledger, the refusals of what
waits for later slices, and ``verify_subsystems`` held against the JAX
package.

Every farm here runs on ``device="cpu"`` (virtual slots ``cpu:0#k``);
without a card and without it the farm raises. Straggler cases run on an
injected clock (an engine advances it by its own cost), never on the wall
clock. The resume cases run in both host loops (``mode``); the async
mode's own cases are in ``test_torch_farm_async.py``, the failure
policy's and ZP-Chaos's in ``test_torch_farm_chaos.py``. The ledger and
the roofline's ``WindowCapture`` wait for their slices (``ROADMAP.md``),
and refuse here by name.

Against the reference (``verify_subsystems`` on the glm4-9b and
recurrentgemma-2b smoke configs, weights redrawn from numpy by
``jax_weights`` and carried across with ``interop``, the same numpy
activations): the same report fields, each layer's max_rel_err within the
verifier's rtol of the reference's, and a fault at a stated layer named at
the same (step, layer), solo and lane-batched.
"""
import dataclasses
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    MemorySnapshotStore)
from repro_torch.core import (Client, DrainBarrier,  # noqa: E402
                              WindowScheduler, iter_windows)
from repro_torch.core.coemu import inject_fault, verify_subsystems  # noqa: E402
from repro_torch.core.watchdog import Watchdog  # noqa: E402
from repro_torch.farm import (DeviceSlot, FailurePolicy,  # noqa: E402
                              FarmError, FarmJob, FarmManager,
                              enumerate_slots, pick_slot, place,
                              place_stack)

RTOL = 5e-2                 # verify_subsystems' default, the reference's
# the port's checksums and relative errors against the reference's, f32
CK_RTOL, CK_ATOL = 1e-5, 1e-6


# ----------------------------------------------------------- toy workload --
def _engine(state, shell, stack):
    return state + stack.sum(), shell, stack * 2.0


def _windows(seed, n_items=6, group=2):
    items = [np.float32(seed * 100 + i) for i in range(n_items)]
    return list(iter_windows(items, group))


def _stack(items):
    return torch.as_tensor(np.stack(items))


def _submit(mgr, n_jobs=3, engines=None):
    col = {}
    for s in range(n_jobs):
        name = f"job{s}"
        col[name] = []
        mgr.submit(FarmJob(
            name=name, engine=(engines or {}).get(s, _engine),
            windows=_windows(s), state=torch.tensor(0.0), shell={},
            stack_fn=_stack,
            on_drain=(lambda p, r, y, n=name: col[n].append(y))))
    return col


def _baseline():
    """The same three clients straight through run_many (no farm)."""
    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=None)
    out = {}
    states = sched.run_many(
        [Client(_engine, _windows(s), torch.tensor(0.0), {},
                stack_fn=_stack, drain_fn=None) for s in range(3)],
        on_drain=lambda k, p, r, y: out.setdefault(k, []).append(y))
    return out, states


def _farm(**kw):
    return FarmManager(device="cpu", **kw)


# ------------------------------------------------------------- placement --
def test_enumerate_slots_single_device_fallback():
    fake = [torch.device("cuda", 0), torch.device("cuda", 1)]
    slots = enumerate_slots(min_slots=5, devices=fake)
    assert len(slots) == 5
    assert [s.device for s in slots] == [fake[0], fake[1]] * 2 + [fake[0]]
    assert len({s.name for s in slots}) == 5
    assert slots[0].name == "cuda:0#0" and slots[3].name == "cuda:1#1"
    slots = enumerate_slots(min_slots=1, devices=fake)
    assert len(slots) == 2 and "#" not in slots[0].name
    host = enumerate_slots(min_slots=3, device="cpu", lane_capacity=4)
    assert [s.name for s in host] == ["cpu:0#0", "cpu:0#1", "cpu:0#2"]
    assert all(s.lane_capacity == 4 for s in host)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")


def test_farm_and_slots_raise_without_a_card_unless_asked_for_the_host(
        no_card):
    """No fallback: without CUDA and without device="cpu" the farm, its
    slots and verify_subsystems raise."""
    with pytest.raises(RuntimeError, match="CUDA"):
        enumerate_slots(min_slots=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FarmManager(slots=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_subsystems(None, None, None, [], None, [0])


def test_pick_slot_avoid_preference_and_place():
    slots = enumerate_slots(min_slots=2, device="cpu")
    assert pick_slot(slots, avoid=slots[0].name) is slots[1]
    assert pick_slot(slots[:1], avoid=slots[0].name) is None
    assert pick_slot(slots[:1], avoid=slots[0].name,
                     sole_candidate=True) is slots[0]
    t = torch.ones(2)
    placed = place({"a": t, "b": np.zeros(3, np.float32), "c": None},
                   slots[0])
    assert placed["a"] is t                     # already there: no copy
    assert torch.is_tensor(placed["b"]) and placed["c"] is None
    assert place(None, slots[0]) is None
    assert torch.is_tensor(place_stack(np.ones(2), slots[0]))
    assert DeviceSlot("x", torch.device("cpu"), 0).lane_capacity == 1


# ------------------------------------------------------- farm bit-identity --
def test_farm_single_device_bit_identical_to_run_many():
    base, states = _baseline()
    mgr = _farm(slots=3)
    col = _submit(mgr)
    rep = mgr.run()
    assert rep["mode"] == "lockstep"
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    for s in range(3):
        got = col[f"job{s}"]
        assert len(got) == len(base[s]) == 3
        for a, b in zip(base[s], got):
            assert torch.equal(a, b)
        assert torch.equal(mgr.results[f"job{s}"][0], states[s][0])


def test_farm_runs_three_concurrent_jobs_and_queues_extras():
    mgr = _farm(slots=3)
    col = _submit(mgr, n_jobs=4)
    rep = mgr.run()
    t = rep["telemetry"]
    assert t["occupancy_peak"] == 3 and t["slots"] == 3
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert all(len(col[f"job{s}"]) == 3 for s in range(4))


def test_farm_forced_eviction_requeues_and_preserves_outputs():
    """Partial outputs are discarded, the stream replays on a DIFFERENT
    slot, and the delivered outputs after the eviction and requeue equal
    an uninterrupted run's to the bit."""
    base, _ = _baseline()
    mgr = _farm(slots=3)
    col = _submit(mgr)
    mgr.force_evict("job1")
    rep = mgr.run()
    ev = rep["telemetry"]["evictions"]
    assert len(ev) == 1 and ev[0]["job"] == "job1"
    assert rep["jobs"]["job1"]["requeues"] == 1
    assert rep["jobs"]["job1"]["slot"] != ev[0]["slot"]
    for s in range(3):
        got = col[f"job{s}"]
        assert len(got) == 3
        for a, b in zip(base[s], got):
            assert torch.equal(a, b)


def _clocked_engine(clock, cost):
    """An engine whose dispatch costs ``cost`` seconds on ``clock``."""
    def engine(state, shell, stack):
        clock["t"] += cost
        return _engine(state, shell, stack)
    return engine


def test_farm_watchdog_detects_and_evicts_straggler():
    """A board whose dispatch costs 50x its neighbours' on the farm's
    (injected) clock trips Watchdog.stragglers and is evicted + requeued,
    its outputs intact."""
    clock = {"t": 0.0}
    base, _ = _baseline()
    mgr = _farm(slots=3, straggler_factor=2.0, clock=lambda: clock["t"])
    engines = {s: _clocked_engine(clock, 0.001) for s in range(3)}
    engines[1] = _clocked_engine(clock, 0.05)
    col = _submit(mgr, engines=engines)
    rep = mgr.run()
    ev = rep["telemetry"]["evictions"]
    assert [e["job"] for e in ev] == ["job1"] and ev[0]["why"] == "straggler"
    assert rep["jobs"]["job1"]["status"] == "done"
    for s in range(3):
        for a, b in zip(base[s], col[f"job{s}"]):
            assert torch.equal(a, b)


def test_farm_straggler_floor_and_disabled_eviction():
    """Below ``straggler_min_s`` no ratio evicts; ``evict_stragglers=
    False`` never evicts."""
    for kw in ({"straggler_min_s": 1.0}, {"evict_stragglers": False}):
        clock = {"t": 0.0}
        mgr = _farm(slots=3, straggler_factor=2.0,
                    clock=lambda: clock["t"], **kw)
        engines = {s: _clocked_engine(clock, 0.001) for s in range(3)}
        engines[1] = _clocked_engine(clock, 0.05)
        _submit(mgr, engines=engines)
        assert mgr.run()["telemetry"]["evictions"] == []


def test_farm_drain_veto_faults_job_and_fails_after_budget():
    def bad_verify(plan, records, ys):
        raise AssertionError("expected-output mismatch")

    mgr = _farm(slots=3)
    col = _submit(mgr)
    mgr.jobs[1].verify = bad_verify
    with pytest.raises(FarmError, match="job1"):
        mgr.run()
    rep = mgr.report()
    assert rep["jobs"]["job1"]["status"] == "failed"
    assert "veto" in rep["jobs"]["job1"]["error"]
    assert rep["jobs"]["job1"]["requeues"] == 1
    assert rep["telemetry"]["drain_vetoes"] >= 2
    assert rep["jobs"]["job0"]["status"] == "done"
    assert rep["jobs"]["job2"]["status"] == "done"
    assert len(col["job0"]) == 3 and len(col["job2"]) == 3
    assert col["job1"] == []


def test_farm_single_slot_serial_farm_completes():
    base, _ = _baseline()
    mgr = _farm(slots=1)
    col = _submit(mgr)
    rep = mgr.run()
    assert rep["telemetry"]["occupancy_peak"] == 1
    for s in range(3):
        for a, b in zip(base[s], col[f"job{s}"]):
            assert torch.equal(a, b)


def test_farm_crashing_board_is_requeued_then_fails():
    """A board whose engine raises is a board fault: the farm requeues it
    (budget 1), fails it after the second crash, and finishes the rest."""
    def crash(state, shell, stack):
        raise RuntimeError("board fault")

    mgr = _farm(slots=2)
    col = _submit(mgr, engines={0: crash})
    rep = mgr.run(strict=False)
    assert rep["jobs"]["job0"]["status"] == "failed"
    assert "board fault" in rep["jobs"]["job0"]["error"]
    assert rep["jobs"]["job0"]["requeues"] == 1
    assert all(rep["jobs"][f"job{s}"]["status"] == "done" for s in (1, 2))
    assert col["job0"] == []


def test_request_shutdown_interrupts_running_and_queued_jobs():
    mgr = _farm(slots=1)

    def verify(plan, records, ys):
        mgr.request_shutdown()

    _submit(mgr, n_jobs=2)
    mgr.jobs[0].verify = verify
    rep = mgr.run()
    assert rep["interrupted"] and mgr.interrupted
    assert {j["status"] for j in rep["jobs"].values()} == {"interrupted"}


def test_empty_farm_reports_nothing():
    rep = _farm(slots=2).run()
    assert rep["jobs"] == {}


# ---------------------------------------------------- deferred options --
# The first three cases refused ``ledger=`` until the ledger slice; they
# keep their ids and now hold that the journal works in either host loop
# and under a failure policy. ZP-Cert still refuses by name.
@pytest.mark.parametrize("kw,match", [
    ({"mode": "async"}, None),
    ({"policy": FailurePolicy()}, None),
    ({}, None),
    ({"certify": True}, "ZP-Cert"),
], ids=["kw0-next slice", "kw1-next slice", "kw2-next slice",
        "kw3-ZP-Cert"])
def test_deferred_farm_options_raise_naming_their_slice(kw, match,
                                                        tmp_path):
    """ZP-Cert refuses by name; ``ledger=`` journals the pass (submit,
    admit, done for every job), delivers what an unjournaled farm
    delivers, and its journal replays to every job done with every
    window delivered."""
    from repro_torch.farm import FarmLedger

    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            _farm(slots=2, **kw)
        return
    ledger = FarmLedger(str(tmp_path))
    mgr = _farm(slots=2, ledger=ledger, **kw)
    col = _submit(mgr)
    rep = mgr.run()
    ledger.close()
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    base, _ = _baseline()
    for s_ in range(3):
        assert len(col[f"job{s_}"]) == len(base[s_])
        assert all(torch.equal(a, b)
                   for a, b in zip(col[f"job{s_}"], base[s_]))
    st = FarmLedger(str(tmp_path)).replay()
    kinds = Counter(r["kind"] for r in FarmLedger(str(tmp_path)).records())
    assert kinds["submit"] == kinds["admit"] == kinds["done"] == 3
    assert {n: (j.status, j.delivered) for n, j in st.jobs.items()} == \
        {n: ("done", len(_windows(0))) for n in col}


def test_deferred_job_options_raise_naming_their_slice(tmp_path):
    """A job's roofline capture still refuses, naming its slice;
    recovery from an empty journal is an empty farm, and the
    process_kill injection arms (it fires only at its point); an unknown
    mode is a ValueError."""
    from repro_torch.farm import FarmLedger
    from repro_torch.farm.chaos import ChaosInjector, Injection

    mgr = _farm(slots=2)
    job = dict(name="j", engine=_engine, windows=_windows(0),
               state=torch.tensor(0.0), shell={}, stack_fn=_stack)
    with pytest.raises(NotImplementedError, match="roofline"):
        mgr.submit(FarmJob(**job, capture=object()))
    rec = FarmManager.recover(FarmLedger(str(tmp_path)), device="cpu")
    assert rec.jobs == [] and rec.run()["jobs"] == {}
    inj = ChaosInjector()
    inj.arm([Injection("process_kill", "ledger.commit", "farm", "*",
                       at=0)])
    assert [i.kind for i in inj.pending] == ["process_kill"]
    assert inj.fire("ledger.deliver", job="j") is None   # another point
    assert mgr.jobs == []
    with pytest.raises(ValueError, match="mode"):
        _farm(mode="threads")


# -------------------------------------------------------------- watchdog --
def test_stragglers_single_sampled_worker_is_not_a_fleet():
    t = [0.0]
    wd = Watchdog(timeout_s=10.0, clock=lambda: t[0])
    for _ in range(4):
        wd.heartbeat("only")
        t[0] += 5.0
    assert wd.stragglers(factor=1.0) == []
    wd.heartbeat("newcomer")
    assert wd.stragglers(factor=1.0) == []


def test_stragglers_two_worker_fleet_uses_lower_median():
    wd = Watchdog(timeout_s=10.0, clock=lambda: 0.0)
    for _ in range(3):
        wd.observe("fast", 1.0)
        wd.observe("slow", 10.0)
    assert wd.stragglers(factor=2.0) == ["slow"]
    wd.forget("slow")
    assert wd.stragglers(factor=2.0) == []


def test_observe_and_gapless_heartbeat_channels():
    t = [0.0]
    wd = Watchdog(timeout_s=2.0, clock=lambda: t[0])
    wd.heartbeat("w", gap=False)
    t[0] += 100.0
    wd.heartbeat("w", gap=False)
    assert list(wd.durations.get("w", [])) == []
    wd.observe("w", 0.5)
    assert list(wd.durations["w"]) == [0.5]
    t[0] += 3.0
    assert wd.dead_workers() == ["w"]


# ----------------------------------------------------- checkpointed resume --
def _resume_windows(n_items=16, group=2):
    return list(iter_windows([np.float32(i) for i in range(n_items)], group))


def _submit_board(mgr, *, windows=None, engine=_engine, verify=None,
                  barrier_every=2, commits=None, name="j", **extra):
    got = []
    barriers = ()
    if barrier_every:
        action = (lambda s, b: commits.append((b, float(s)))
                  ) if commits is not None else (lambda s, b: None)
        barriers = (DrainBarrier(every=barrier_every, action=action),)
    mgr.submit(FarmJob(
        name=name, engine=engine,
        windows=_resume_windows() if windows is None else windows,
        state=torch.tensor(0.0), shell={}, stack_fn=_stack, verify=verify,
        on_drain=lambda p, r, y: got.append((p.index, p.start, y)),
        barriers=barriers, **extra))
    return got


def _resume_baseline(windows=None):
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, windows=windows)
    mgr.run()
    return got, mgr.results["j"][0]


def _evict_trigger(mgr, at_index, name="j"):
    fired = {"done": False}

    def verify(plan, records, ys):
        if plan.index >= at_index and not fired["done"]:
            fired["done"] = True
            mgr.force_evict(name)

    verify.fired = fired
    return verify


def _held(mgr, engine, trigger, name="j"):
    """``engine``, which on the job's first attempt, once ``trigger`` has
    marked the job, holds each dispatch until the async control plane has
    signalled the eviction (``hold_until_evicted``): the eviction then
    lands at the next drain boundary whatever the threads' timing."""
    from test_torch_farm_async import hold_until_evicted

    def held(state, shell, stack):
        if mgr.mode == "async" and trigger.fired["done"] \
                and mgr.jobs[0].attempts == 1:
            hold_until_evicted(mgr, name)
        return engine(state, shell, stack)
    return held


def _same(base, got):
    assert len(got) == len(base)
    for (ia, sa, ya), (ib, sb, yb) in zip(base, got):
        assert ia == ib and sa == sb
        assert torch.equal(ya, yb)


def test_lockstep_resume_zero_replay_and_bit_identical():
    base, base_state = _resume_baseline()
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, verify=_evict_trigger(mgr, 4))
    rep = mgr.run()
    j = rep["jobs"]["j"]
    assert j["status"] == "done" and j["requeues"] == 1
    assert j["windows_committed"] > 0
    assert j["windows_replayed"] == 0
    resumes = rep["telemetry"]["resumes"]
    assert len(resumes) == 1 and resumes[0]["window"] == \
        j["windows_committed"]
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_resumed_on_drain_never_redelivers_a_committed_window(mode):
    mgr = _farm(slots=3, evict_stragglers=False, mode=mode)
    trigger = _evict_trigger(mgr, 4)
    got = _submit_board(mgr, verify=trigger,
                        engine=_held(mgr, _engine, trigger))
    rep = mgr.run()
    assert rep["jobs"]["j"]["requeues"] == 1
    assert all(c == 1 for c in Counter(i for i, _, _ in got).values())
    assert [i for i, _, _ in got] == list(range(8))


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_veto_then_evict_resumes_from_barrier_before_the_veto(mode):
    base, _ = _resume_baseline()
    commits: list = []
    failed = {"n": 0}

    def verify(plan, records, ys):
        if plan.index == 3 and failed["n"] == 0:
            failed["n"] += 1
            raise AssertionError("synthetic commit divergence")

    mgr = _farm(slots=3, evict_stragglers=False, mode=mode)
    got = _submit_board(mgr, verify=verify, commits=commits)
    rep = mgr.run()
    j = rep["jobs"]["j"]
    assert j["status"] == "done" and j["requeues"] == 1
    assert rep["telemetry"]["drain_vetoes"] == 1
    resumes = rep["telemetry"]["resumes"]
    assert len(resumes) == 1 and resumes[0]["window"] == 3
    assert j["windows_replayed"] == 1
    assert [b for b, _ in commits] == [2, 4, 6, 8, 10, 12, 14, 16]
    _same(base, got)


def _in_place_engine(state, shell, stack):
    """Updates its state in place (the port's steps do): the farm must
    dispatch every attempt from copies."""
    state.add_(stack.sum())
    return state, shell, stack * 2.0


def test_in_place_engine_full_replay_after_eviction():
    """An engine that writes its state in place leaves the job's own
    state untouched (every attempt starts from a copy), so a requeue
    with no snapshot replays from window 0 bit-identically."""
    base, base_state = _resume_baseline()
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, engine=_in_place_engine, barrier_every=0)
    mgr.force_evict("j")
    rep = mgr.run()
    assert rep["jobs"]["j"]["requeues"] == 1
    assert rep["telemetry"]["resumes"] == []
    assert float(mgr.jobs[0].state) == 0.0
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_in_place_engine_snapshot_resume_bit_identical(mode):
    base, base_state = _resume_baseline()
    mgr = _farm(slots=3, evict_stragglers=False, mode=mode)
    trigger = _evict_trigger(mgr, 4)
    got = _submit_board(mgr, engine=_held(mgr, _in_place_engine, trigger),
                        verify=trigger)
    rep = mgr.run()
    j = rep["jobs"]["j"]
    assert j["status"] == "done" and j["requeues"] == 1
    assert any(r["window"] > 0 for r in rep["telemetry"]["resumes"])
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


def test_resume_keeps_tail_window_math_for_non_divisible_streams():
    windows = _resume_windows(n_items=7, group=2)
    base, base_state = _resume_baseline(windows=windows)
    assert [s for _, s, _ in base] == [0, 2, 4, 6]
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, windows=windows, verify=_evict_trigger(mgr, 2))
    rep = mgr.run()
    assert rep["jobs"]["j"]["requeues"] == 1
    assert rep["telemetry"]["resumes"][0]["window"] > 0
    assert [(i, s) for i, s, _ in got] == [(0, 0), (1, 2), (2, 4), (3, 6)]
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


def test_on_disk_snapshot_store_resumes_through_atomic_publish(tmp_path):
    base, base_state = _resume_baseline()
    store = CheckpointManager(str(tmp_path / "snaps"), keep=2)
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, verify=_evict_trigger(mgr, 4),
                        snapshot_store=store)
    rep = mgr.run()
    assert rep["jobs"]["j"]["requeues"] == 1
    assert rep["telemetry"]["resumes"][0]["window"] > 0
    store.wait()
    assert store.steps()
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


def test_corrupt_snapshot_falls_back_to_an_older_one():
    """A snapshot whose bytes change after publish fails its digest: the
    requeue restores the newest OLDER verifiable one, rewinds the
    committed prefix with the cursor, logs the fallback, and still
    delivers every window once, bit-identically."""
    class TornStore(MemorySnapshotStore):
        """Its newest snapshot's bytes change after publish, found at the
        first restore (``wait`` runs just before it)."""
        torn = False

        def wait(self):
            if not self.torn:
                self.torn = True
                self._snaps[max(self._snaps)]["state"].add_(1.0)

    base, base_state = _resume_baseline()
    store = TornStore(keep=3)
    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, verify=_evict_trigger(mgr, 5),
                        snapshot_store=store)
    rep = mgr.run()
    fb = rep["telemetry"]["fallbacks"]
    assert len(fb) == 1 and fb[0]["got_step"] < fb[0]["want_step"]
    assert rep["jobs"]["j"]["status"] == "done"
    assert [i for i, _, _ in got] == list(range(8))
    _same(base, got)
    assert torch.equal(mgr.results["j"][0], base_state)


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_stateful_verifier_rewinds_on_no_snapshot_requeue(mode):
    class PositionVerifier:
        def __init__(self):
            self.pos = 0

        def __call__(self, plan, records, ys):
            assert plan.index == self.pos, (plan.index, self.pos)
            self.pos += 1

        def snapshot(self):
            return {"pos": self.pos}

        def restore(self, snap):
            self.pos = int(snap["pos"])

    mgr = _farm(slots=3, evict_stragglers=False, mode=mode)
    got = _submit_board(mgr, verify=PositionVerifier(), barrier_every=1000)
    mgr.force_evict("j")
    rep = mgr.run()
    assert rep["jobs"]["j"]["status"] == "done"
    assert rep["jobs"]["j"]["requeues"] == 1
    assert rep["telemetry"]["resumes"] == []
    assert rep["telemetry"]["drain_vetoes"] == 0
    assert [i for i, _, _ in got] == list(range(8))


def test_stateful_verifier_restores_its_snapshot_on_resume():
    """A verifier with snapshot()/restore() rides the barrier snapshot: the
    resumed attempt restores its position, so it never misfires."""
    class PositionVerifier:
        def __init__(self):
            self.pos = 0
            self.evicted = False

        def __call__(self, plan, records, ys):
            assert plan.index == self.pos, (plan.index, self.pos)
            self.pos += 1
            if plan.index == 4 and not self.evicted:
                self.evicted = True
                mgr.force_evict("j")

        def snapshot(self):
            return {"pos": self.pos}

        def restore(self, snap):
            self.pos = int(snap["pos"])

    mgr = _farm(slots=3, evict_stragglers=False)
    got = _submit_board(mgr, verify=PositionVerifier())
    rep = mgr.run()
    assert rep["jobs"]["j"]["requeues"] == 1
    assert rep["telemetry"]["resumes"][0]["window"] > 0
    assert rep["telemetry"]["drain_vetoes"] == 0
    assert [i for i, _, _ in got] == list(range(8))


# --------------------------------------------------------------- multi-DUT --
def _smoke_inputs(cfg, steps=3, B=2, S=16, seed=0):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(B, S, cfg.d_model).astype(np.float32)
          for _ in range(steps)]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return xs, pos


def test_verify_subsystems_farm_localizes_fault():
    """Several extracted subsystems verify as independent boards in one
    farm pass; a fault injected into one layer's params diverges that
    subsystem ONLY, on every step (the reference's granite-8b case)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Runtime, build_model
    cfg = get_smoke_config("granite-8b")
    params = build_model(cfg).init(0, device="cpu")
    xs, pos = _smoke_inputs(cfg)
    xs = [torch.from_numpy(x).bfloat16() for x in xs]
    pos = torch.from_numpy(pos)
    clean = verify_subsystems(params, cfg, Runtime(), xs, pos, [0, 1],
                              group_size=2, device="cpu")
    assert set(clean) == {"layer0", "layer1"}
    assert not clean["layer0"].diverged and not clean["layer1"].diverged
    assert clean["layer0"].steps == clean["layer1"].steps == 3
    bad = inject_fault(params, cfg, 1)
    reps = verify_subsystems(params, cfg, Runtime(), xs, pos, [0, 1],
                             group_size=2, dut_params=bad, device="cpu")
    assert not reps["layer0"].diverged
    assert reps["layer1"].diverged
    assert (reps["layer1"].first.step, reps["layer1"].first.layer) == (0, 1)


def test_verify_subsystems_refuses_an_enc_dec_model():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Runtime, build_model
    cfg = get_smoke_config("whisper-small")
    params = build_model(cfg).init(0, device="cpu")
    x = torch.zeros(2, 8, cfg.d_model)
    with pytest.raises(ValueError, match="encdec"):
        verify_subsystems(params, cfg, Runtime(), [x],
                          torch.zeros(2, 8, dtype=torch.int32), [0],
                          device="cpu")


@pytest.fixture(scope="module")
def jref():
    """The reference's coemu module, configs, runtime and jnp."""
    jax = pytest.importorskip("jax")
    from test_torch_ssm import import_reference
    coemu, configs, runtime = import_reference(
        "repro.core.coemu", "repro.configs", "repro.models.runtime")
    return dict(coemu=coemu, configs=configs, Runtime=runtime.Runtime,
                jnp=jax.numpy, jax=jax)


@pytest.mark.parametrize("arch", ["glm4-9b", "recurrentgemma-2b"])
@pytest.mark.parametrize("lanes", [False, True])
def test_verify_subsystems_matches_the_reference(jref, arch, lanes):
    """The port's verify_subsystems and the reference's on the same
    weights (numpy-redrawn, carried across) and the same activations, f32:
    the same layers, steps and verdicts, max_rel_err within the rtol of
    each other; a fault at layer 1 (in the stacked periods, where
    inject_fault reaches) named at the same (step, layer) on both
    sides."""
    from jax_weights import seeded_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models import Runtime
    jax, jnp = jref["jax"], jref["jnp"]
    jcfg = dataclasses.replace(jref["configs"].get_smoke_config(arch),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = seeded_params(jcfg, 0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    xs, pos = _smoke_inputs(tcfg, steps=3, seed=7)
    layers = list(range(tcfg.num_layers))
    fault = 1
    jbad = jref["coemu"].inject_fault(jp, jcfg, fault)
    tbad = inject_fault(tp, tcfg, fault)
    for jd, td in ((None, None), (jbad, tbad)):
        want = jref["coemu"].verify_subsystems(
            jp, jcfg, jref["Runtime"](), [jnp.asarray(x) for x in xs],
            jnp.asarray(pos), layers, group_size=2, dut_params=jd,
            lanes=lanes)
        got = verify_subsystems(
            tp, tcfg, Runtime(), [torch.from_numpy(x) for x in xs],
            torch.from_numpy(pos), layers, group_size=2, dut_params=td,
            lanes=lanes, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].steps == want[k].steps
            assert got[k].diverged == want[k].diverged, (k, got[k], want[k])
            assert got[k].max_rel_err == pytest.approx(
                want[k].max_rel_err, rel=CK_RTOL, abs=CK_ATOL), k
            if want[k].first is not None:
                assert (got[k].first.step, got[k].first.layer) == \
                    (want[k].first.step, want[k].first.layer)
                assert got[k].first.rel_err == pytest.approx(
                    want[k].first.rel_err, rel=CK_RTOL), k
        if td is not None:
            assert got[f"layer{fault}"].first.layer == fault


@pytest.mark.parametrize("arch", ["glm4-9b", "recurrentgemma-2b"])
def test_subsystem_boards_checksums_match_the_reference(jref, arch):
    """Each board's numbers against the reference's on the same weights
    and activations, f32: the oracle's (abs-mean, rms) checksums of the
    in-situ capture, and the checksums the board's engine delivers over
    its captured inputs, from a clean and from a faulted DUT, within
    CK_RTOL; the lane keys equal."""
    from jax_weights import seeded_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.coemu import subsystem_boards
    from repro_torch.interop import params_from_jax
    from repro_torch.models import Runtime
    jax, jnp = jref["jax"], jref["jnp"]
    jcfg = dataclasses.replace(jref["configs"].get_smoke_config(arch),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = seeded_params(jcfg, 0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    xs, pos = _smoke_inputs(tcfg, steps=3, seed=7)
    layers = list(range(tcfg.num_layers))
    for jd, td in ((None, None),
                   (jref["coemu"].inject_fault(jp, jcfg, 1),
                    inject_fault(tp, tcfg, 1))):
        want = jref["coemu"].subsystem_boards(
            jp, jcfg, jref["Runtime"](), [jnp.asarray(x) for x in xs],
            jnp.asarray(pos), layers, dut_params=jd)
        with torch.inference_mode():
            got = subsystem_boards(
                tp, tcfg, Runtime(), [torch.from_numpy(x) for x in xs],
                torch.from_numpy(pos), layers, dut_params=td)
            delivered = [eng(st, {}, torch.stack(x_ins))[2].numpy()
                         for eng, st, x_ins, _, _ in got]
        for li, (w, g, d) in enumerate(zip(want, got, delivered)):
            w_eng, w_st, w_x, w_oracle, w_key = w
            assert g[4] == w_key, li
            np.testing.assert_allclose(g[3], w_oracle, rtol=CK_RTOL,
                                       err_msg=f"oracle layer {li}")
            w_cks = np.asarray(w_eng(w_st, {}, jnp.stack(w_x))[2])
            np.testing.assert_allclose(d, w_cks, rtol=CK_RTOL,
                                       err_msg=f"delivered layer {li}")
