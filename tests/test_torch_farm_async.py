"""The port's async ZP-Farm (``FarmManager(mode="async")``: one dispatcher
thread, and on a card one CUDA stream, per slot) on the CPU: every case
of the reference's ``tests/test_farm_async.py`` and its async-only case
of ``test_farm_resume.py`` (its other async cases, and those of
``test_farm_lanes.py`` and ``test_farm_scope.py``, are the ``mode``
parametrisations of ``test_torch_farm.py``, ``test_torch_farm_lanes.py``
and ``test_torch_farm_telemetry.py``, which import the helpers below),
and the thread-safety the slot threads need:
exact launch counts under threads, per-thread capture take-back, and
first-use kernel builds from two threads.

Every farm passes ``device="cpu"``. No case reads the wall clock: a
straggler is judged on an injected per-thread clock (each engine advances
its own thread's time by its cost), a hung board on an injected watchdog
clock, and every wait has a bound (no test can hang the suite).
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DrainBarrier, iter_windows  # noqa: E402
from repro_torch.core.watchdog import Watchdog  # noqa: E402
from repro_torch.farm import FarmJob, FarmManager  # noqa: E402


# ----------------------------------------------------------- toy workload --
def _engine(state, shell, stack):
    return state + stack.sum(), shell, stack * 2.0


def _windows(seed, n_items=6, group=2):
    items = [np.float32(seed * 100 + i) for i in range(n_items)]
    return list(iter_windows(items, group))


def _stack(items):
    return torch.as_tensor(np.stack(items))


def _farm(**kw):
    return FarmManager(device="cpu", **kw)


def _submit(mgr, n_jobs=3, engines=None, n_items=6, seed_base=0, **extra):
    col = {}
    for s in range(n_jobs):
        name = f"job{s}"
        col[name] = []
        mgr.submit(FarmJob(
            name=name, engine=(engines or {}).get(s, _engine),
            windows=_windows(seed_base + s, n_items=n_items),
            state=torch.tensor(0.0), shell={}, stack_fn=_stack,
            on_drain=(lambda p, r, y, n=name: col[n].append(y)), **extra))
    return col


def _run_mode(mode, n_jobs=3, n_items=6, seed_base=0, **mgr_kw):
    mgr = _farm(slots=3, mode=mode, **mgr_kw)
    col = _submit(mgr, n_jobs=n_jobs, n_items=n_items, seed_base=seed_base)
    rep = mgr.run()
    states = {n: mgr.results[n][0] for n in col}
    return col, states, rep


def _same(base, got):
    assert set(base) == set(got)
    for name in base:
        assert len(got[name]) == len(base[name])
        for a, b in zip(base[name], got[name]):
            assert torch.equal(a, b), name


class ThreadClock:
    """Injected clock of virtual seconds kept per thread: an engine
    advances its own thread's time by its cost, so a window's wall
    measured on a slot thread is that board's own cost, whatever the
    other threads do meanwhile."""

    def __init__(self):
        self._local = threading.local()

    def __call__(self) -> float:
        return getattr(self._local, "t", 0.0)

    def advance(self, seconds: float):
        self._local.t = self() + seconds


def wait_for(predicate, timeout=10.0):
    """Poll ``predicate`` until true or ``timeout`` real seconds pass."""
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("timed out waiting")
        time.sleep(0.001)


def hold_until_evicted(mgr, name, timeout=10.0):
    """Block the calling slot thread until the control plane has
    signalled the eviction of ``name``'s running attempt: the eviction
    then lands at that attempt's next drain boundary, however fast the
    threads run (the reference gives the control plane time with a
    wall-clock sleep instead)."""
    wait_for(lambda: any(r.job.name == name and r.evict_flag.is_set()
                         for r in list(mgr._running.values())), timeout)


# ----------------------------------------------------------- determinism --
@pytest.mark.parametrize("seed_base", [0, 7])
def test_async_bit_identical_to_lockstep(seed_base):
    """The headline contract: the threaded farm delivers byte-for-byte the
    outputs and final states of the lockstep oracle, for every job."""
    lock_col, lock_states, _ = _run_mode("lockstep", seed_base=seed_base)
    async_col, async_states, rep = _run_mode("async", seed_base=seed_base)
    assert rep["mode"] == "async"
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    _same(lock_col, async_col)
    assert all(len(c) == 3 for c in async_col.values())
    for name in lock_col:
        assert torch.equal(lock_states[name], async_states[name])


def test_async_forced_eviction_requeues_and_preserves_outputs():
    """Eviction under threads keeps the lockstep contract: partial outputs
    discarded, replay on a DIFFERENT slot, delivered outputs bit-identical
    to the no-eviction lockstep baseline, exactly once."""
    base, _, _ = _run_mode("lockstep")
    mgr = _farm(slots=3, mode="async")
    col = _submit(mgr)
    mgr.force_evict("job1")
    rep = mgr.run()
    ev = rep["telemetry"]["evictions"]
    assert len(ev) == 1 and ev[0]["job"] == "job1"
    assert ev[0]["why"] == "forced"
    assert rep["jobs"]["job1"]["requeues"] == 1
    assert rep["jobs"]["job1"]["slot"] != ev[0]["slot"]   # another seat
    _same(base, col)


def test_async_barrier_veto_midstream_then_requeue_commits_once():
    """A per-job checkpoint DrainBarrier is VETOED when the drain verifier
    rejects the window behind it; the evicted job replays on another slot
    and the replay's commits (and outputs) match the lockstep oracle."""
    def run_mode(mode):
        commits = []
        failed = {"n": 0}

        def verify(plan, records, ys):
            # reject the window starting at step 2 — first attempt only
            if plan.start == 2 and failed["n"] == 0:
                failed["n"] += 1
                raise AssertionError("synthetic commit divergence")

        got = []
        mgr = _farm(slots=3, mode=mode)
        mgr.submit(FarmJob(
            name="ckpt", engine=_engine, windows=_windows(0),
            state=torch.tensor(0.0), shell={}, stack_fn=_stack,
            verify=verify, on_drain=lambda p, r, y: got.append(y),
            barriers=(DrainBarrier(
                every=4, action=lambda state, step: commits.append(
                    (step, float(state)))),)))
        return commits, got, mgr.run()

    lock_commits, lock_got, lock_rep = run_mode("lockstep")
    async_commits, async_got, async_rep = run_mode("async")
    for rep in (lock_rep, async_rep):
        assert rep["jobs"]["ckpt"]["status"] == "done"
        assert rep["jobs"]["ckpt"]["requeues"] == 1
        assert rep["telemetry"]["drain_vetoes"] == 1
        assert "veto" in rep["telemetry"]["evictions"][0]["why"]
    # attempt 1 faulted at the window behind boundary 4: its commit was
    # vetoed, so the ONLY commit is the clean replay's
    assert async_commits == lock_commits
    assert len(async_commits) == 1 and async_commits[0][0] == 4
    _same({"ckpt": lock_got}, {"ckpt": async_got})


# ------------------------------------------------------- wall-time signals --
def test_async_watchdog_evicts_wall_time_straggler():
    """A slow board is flagged from its MEASURED window wall (observed on
    its own slot thread, on the injected per-thread clock) and evicted
    mid-stream; outputs are preserved via requeue + replay. On its first
    attempt the slow board holds its fourth window until the control
    plane has signalled the eviction, so the verdict is reached however
    fast the other threads run."""
    clock = ThreadClock()
    calls = {"n": 0}

    def fast(state, shell, stack):
        clock.advance(0.001)
        return _engine(state, shell, stack)

    def slow(state, shell, stack):
        clock.advance(0.05)
        if mgr.jobs[1].attempts == 1:
            calls["n"] += 1
            if calls["n"] == 4:
                hold_until_evicted(mgr, "job1")
        return _engine(state, shell, stack)

    base, _, _ = _run_mode("lockstep", n_items=10)
    mgr = _farm(slots=3, mode="async", straggler_factor=2.0, clock=clock)
    col = _submit(mgr, engines={0: fast, 1: slow, 2: fast}, n_items=10)
    rep = mgr.run()
    ev = rep["telemetry"]["evictions"]
    assert [e["job"] for e in ev] == ["job1"]
    assert ev[0]["why"] == "straggler"
    assert rep["jobs"]["job1"]["status"] == "done"
    assert all(len(c) == 5 for c in col.values())
    _same(base, col)


def test_async_thread_confinement_and_per_thread_tagging():
    """Every dispatch of one job attempt runs on exactly one slot thread
    (never the control thread), concurrent jobs really do run on distinct
    threads, and the watchdog's duration samples are tagged with the slot
    thread that observed them."""
    seen = {}
    lock = threading.Lock()

    def make_engine(name):
        def engine(state, shell, stack):
            with lock:
                seen.setdefault(name, set()).add(
                    threading.current_thread().name)
            return _engine(state, shell, stack)
        return engine

    mgr = _farm(slots=3, mode="async")
    _submit(mgr, engines={s: make_engine(f"job{s}") for s in range(3)})
    rep = mgr.run()
    main = threading.current_thread().name
    assert all(len(t) == 1 for t in seen.values())      # one thread per job
    assert all(main not in t for t in seen.values())    # never the control
    assert len(set().union(*seen.values())) == 3        # truly concurrent
    for name, j in rep["jobs"].items():
        tagged = mgr.wd.threads.get(j["slot"])
        assert tagged is not None and tagged.startswith("farm-")


def test_async_hung_board_abandoned_and_job_requeued():
    """True liveness: a board hung mid-dispatch stops beating, is written
    off past the watchdog timeout (its slot leaves the pool — a Python
    thread cannot be killed), and its job requeues elsewhere. The
    watchdog runs on an injected clock that the hung board moves past
    the timeout once the other job is done."""
    release = threading.Event()
    wd_time = [0.0]
    hung = {"n": 0}

    def hang_once(state, shell, stack):
        if hung["n"] == 0:
            hung["n"] += 1
            wait_for(lambda: mgr.jobs[0].status == "done")
            wd_time[0] += 10.0
            release.wait(timeout=30.0)
        return _engine(state, shell, stack)

    base, _, _ = _run_mode("lockstep", n_jobs=2)
    mgr = _farm(slots=2, mode="async",
                watchdog=Watchdog(timeout_s=0.3, clock=lambda: wd_time[0]),
                evict_stragglers=False)
    col = _submit(mgr, n_jobs=2, engines={1: hang_once})
    try:
        rep = mgr.run()
    finally:
        release.set()               # let the abandoned thread unwind
    assert rep["jobs"]["job1"]["status"] == "done"
    assert rep["jobs"]["job1"]["requeues"] == 1
    ev = rep["telemetry"]["evictions"]
    assert any("hung" in e["why"] for e in ev)
    lost_slot = next(e["slot"] for e in ev if "hung" in e["why"])
    assert rep["jobs"]["job1"]["slot"] != lost_slot
    _same(base, col)
    for w in mgr._workers.values():     # no thread leaks into other tests
        w.join(timeout=5.0)
        assert not w.is_alive()


def test_async_queue_depth_two_spreads_before_stacking():
    """With slot_queue_depth=2, admission is least-loaded-first: three
    equal jobs land on three DIFFERENT slots (full parallelism), not two
    pre-staged behind one board."""
    mgr = _farm(slots=3, mode="async", slot_queue_depth=2)
    _submit(mgr)
    rep = mgr.run()
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert len({j["slot"] for j in rep["jobs"].values()}) == 3
    assert rep["telemetry"]["occupancy_peak"] == 3


# ----------------------------------------------------------- telemetry ----
def test_async_telemetry_reports_host_overhead_channels():
    """The async report attributes per-slot host overhead: queue wait,
    dispatch wall, drain wall, and idle gaps all carry samples, and the
    printable summary includes the host line."""
    mgr = _farm(slots=2, mode="async")
    _submit(mgr, n_jobs=4)              # 4 jobs on 2 slots: queuing + idle
    rep = mgr.run()
    t = rep["telemetry"]
    assert t["occupancy_peak"] == 2 and t["slots"] == 2
    for slot, d in t["devices"].items():
        assert d["windows"] > 0
        assert d["queue_wait_ms"]["n"] > 0
        assert d["dispatch_ms"]["n"] > 0
        assert d["drain_ms"]["n"] > 0
        assert d["queue_depth_max"] >= 1
    # 4 jobs over 2 slots: at least one slot went idle between assignments
    assert any(d["idle_ms"]["n"] > 0 for d in t["devices"].values())
    assert "host:" in mgr.telemetry.summary()


def test_async_slot_threads_run_under_the_callers_autograd_mode():
    """Inference mode and grad mode are thread-local: the slot threads
    take the control thread's, so an engine that updates an inference
    tensor in place runs the same in both modes."""
    seen = []

    def engine(state, shell, stack):
        seen.append((torch.is_inference_mode_enabled(),
                     torch.is_grad_enabled()))
        state.add_(stack.sum())
        return state, shell, stack * 2.0

    for mode in ("lockstep", "async"):
        seen.clear()
        mgr = _farm(slots=2, mode=mode)
        with torch.inference_mode():
            _submit(mgr, n_jobs=2, engines={0: engine, 1: engine})
            rep = mgr.run()
        assert all(j["status"] == "done" for j in rep["jobs"].values())
        assert set(seen) == {(True, False)}, (mode, seen)


# ----------------------------------------------- checkpointed resume (async) --
def _resume_windows(n_items=16, group=2):
    return list(iter_windows([np.float32(i) for i in range(n_items)], group))


def _submit_board(mgr, *, engine=_engine, verify=None):
    got = []
    mgr.submit(FarmJob(
        name="j", engine=engine, windows=_resume_windows(),
        state=torch.tensor(0.0), shell={}, stack_fn=_stack, verify=verify,
        on_drain=lambda p, r, y: got.append((p.index, p.start, y)),
        barriers=(DrainBarrier(every=2, action=lambda s, b: None),)))
    return got


def test_async_resume_bit_identical_and_replays_less_than_committed():
    """Under per-slot dispatcher threads the evict lands at a drain
    boundary the slot thread reaches on its own schedule; the resumed job
    never re-runs more than the uncommitted tail (replayed < committed)
    and delivery is bit-identical."""
    base_mgr = _farm(slots=3, mode="lockstep", evict_stragglers=False)
    base = _submit_board(base_mgr)
    base_mgr.run()
    mgr = _farm(slots=3, mode="async", evict_stragglers=False)
    fired = {"done": False}

    def verify(plan, records, ys):
        if plan.index >= 3 and not fired["done"]:
            fired["done"] = True
            mgr.force_evict("j")

    def engine(state, shell, stack):
        # first attempt: hold one window until the mark is signalled
        if mgr.jobs[0].attempts == 1 and fired["done"]:
            hold_until_evicted(mgr, "j")
        return _engine(state, shell, stack)

    got = _submit_board(mgr, engine=engine, verify=verify)
    rep = mgr.run()
    j = rep["jobs"]["j"]
    assert j["status"] == "done" and j["requeues"] == 1
    assert j["windows_committed"] > 0
    assert j["windows_replayed"] < j["windows_committed"]
    assert any(r["job"] == "j" and r["window"] > 0
               for r in rep["telemetry"]["resumes"])
    assert len(got) == len(base)
    for (ia, sa, ya), (ib, sb, yb) in zip(base, got):
        assert ia == ib and sa == sb and torch.equal(ya, yb)
    assert torch.equal(mgr.results["j"][0], base_mgr.results["j"][0])


# ------------------------------------------------- counts and builds, threads --
def test_launch_counts_are_exact_under_threads():
    """More threads than cores each count 500 launches of one wrapper at
    once, with the interpreter switching threads every microsecond: the
    process total is exact (a bare ``+=`` loses some), and each thread's
    own tally holds only its own."""
    from repro_torch.kernels import count_launch, thread_launches

    def wrapper():
        pass
    wrapper.launches = 0
    n = (os.cpu_count() or 4) + 2
    tallies = []
    barrier = threading.Barrier(n)

    def work():
        barrier.wait()
        for _ in range(500):
            count_launch(wrapper)
        tallies.append(thread_launches(wrapper))

    threads = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 500 * n
    assert tallies == [500] * n
    assert thread_launches(wrapper) == 0        # none on this thread


def test_thread_counts_hold_only_the_calling_threads_launches():
    """A capture diffs its own thread's tally (``core/graphs.py``): the
    launches another thread counts meanwhile are in the process total
    but not in this thread's, so the take-back leaves them counted."""
    from repro_torch.core import graphs

    k1 = graphs.counted_kernels()["k1"]
    total, mine = k1.launches, graphs.thread_counts()["k1"]
    t = threading.Thread(target=graphs._add_counts, args=({"k1": 5},))
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    graphs._add_counts({"k1": 3})       # this thread's recorded launches
    delta = graphs.thread_counts()["k1"] - mine
    assert delta == 3
    delta = {"k1": delta}
    assert k1.launches == total + 8
    graphs._add_counts(delta, -1)       # the capture's take-back
    assert k1.launches == total + 5
    graphs._add_counts({"k1": 5}, -1)


def test_first_use_load_from_two_threads_builds_once(monkeypatch, tmp_path):
    """Two threads loading a kernel at its first use: one build runs, both
    get the same library; a temporary output is named by thread too, so
    two builders never write one file."""
    from repro_torch.kernels import _build

    built, opened = [], []
    barrier = threading.Barrier(2)

    def fake_build(*names):
        built.append(names)
        time.sleep(0.05)                # a slow nvcc: the other waits
        return {n: "" for n in names}

    def fake_cdll(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_BUILD", tmp_path)
    monkeypatch.delitem(_build._loaded, "ssm_scan", raising=False)
    libs = []

    def load():
        barrier.wait()
        libs.append(_build.load("ssm_scan"))

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert built == [("ssm_scan",)] and len(opened) == 1
    assert len(libs) == 2 and libs[0] is libs[1]
