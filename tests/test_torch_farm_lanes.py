"""Lane-batched boards in the port's lockstep farm on the CPU: every case
of the reference's ``tests/test_farm_lanes.py`` that lockstep mode
covers. N identical-arch DUTs fuse into ONE ``torch.func.vmap`` dispatch
stream; lane packing broadcasts identity-shared weight trees as one
copy; a fused run is bit-identical to the N solo runs it replaces
(tail windows included); the farm coalesces compatible queued jobs up to
the slot's lane capacity and refuses incompatible ones for a nameable
reason; a verify failure vetoes ONE lane — detached and requeued solo
from its per-lane barrier snapshot — while the survivors keep running;
and divergences, watchdog observations and subsystem verification stay
lane-aware. The reference's async-mode cases wait for the async slice.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DrainBarrier  # noqa: E402
from repro_torch.core.coemu import (CommitDivergence,  # noqa: E402
                                    CommitStreamVerifier, inject_fault,
                                    verify_subsystems)
from repro_torch.core.schedule import LaneBatch  # noqa: E402
from repro_torch.core.watchdog import Watchdog  # noqa: E402
from repro_torch.farm import FarmJob, FarmManager, lane_compatible  # noqa: E402

W = torch.as_tensor(np.random.RandomState(0).randn(8, 8).astype(np.float32))


# ----------------------------------------------------------- toy workload --
def _engine(state, shell, stack):
    bias, ys = state["bias"], []
    for i in range(stack.shape[0]):
        y = torch.tanh(stack[i] @ state["w"]) + bias
        bias = bias + 0.01 * y.sum()
        ys.append(y.sum(-1))
    return {"bias": bias, "w": state["w"]}, shell, torch.stack(ys)


def _stack(items):
    return torch.as_tensor(np.stack(items))


def _state(i):
    return {"bias": torch.tensor(i * 0.5), "w": W}


def _windows(seed, n_steps=7, group=2):
    rng = np.random.RandomState(seed)
    items = [rng.randn(4, 8).astype(np.float32) for _ in range(n_steps)]
    return [items[i:i + group] for i in range(0, n_steps, group)]


def _farm(**kw):
    return FarmManager(device="cpu", mode="lockstep", evict_stragglers=False,
                       **kw)


def _submit_lane_jobs(mgr, n, *, n_steps=7, group=2, lane_key="arch-a",
                      verify_for=None, verify=None, max_requeues=2):
    outs = {}
    for i in range(n):
        name = f"b{i}"
        outs[name] = []
        mgr.submit(FarmJob(
            name=name, engine=_engine, windows=_windows(i, n_steps, group),
            state=_state(i), shell={}, stack_fn=_stack,
            on_drain=lambda p, r, y, nm=name: outs[nm].append(
                (p.index, p.start, y)),
            barriers=(DrainBarrier(every=1, action=lambda s, b: None),),
            verify=verify if verify_for == i else None,
            lane_key=lane_key, max_requeues=max_requeues))
    return outs


def _same(solo, outs):
    assert len(outs) == len(solo)
    for (ia, sa, ya), (ib, sb, yb) in zip(solo, outs):
        assert ia == ib and sa == sb
        assert torch.equal(ya, yb)


# ------------------------------------------------------ farm bit-identity --
@pytest.mark.parametrize("n_steps,group", [(7, 2), (8, 2), (9, 4)])
def test_farm_lanes_bit_identical_to_solo(n_steps, group):
    """A lane-coalesced farm pass (tail windows included) delivers every
    board's outputs and final state bit-identical to the solo farm pass,
    and actually coalesced (one dispatch stream)."""
    n = 4
    solo_mgr = _farm(slots=2)
    solo = _submit_lane_jobs(solo_mgr, n, n_steps=n_steps, group=group,
                             lane_key=None)
    solo_mgr.run()
    mgr = _farm(slots=2, lanes=n)
    outs = _submit_lane_jobs(mgr, n, n_steps=n_steps, group=group)
    rep = mgr.run()
    assert rep["telemetry"]["lanes_per_dispatch_max"] == n
    for name in solo:
        _same(solo[name], outs[name])
        a, b = solo_mgr.results[name][0], mgr.results[name][0]
        assert torch.equal(a["bias"], b["bias"])
        assert torch.equal(a["w"], b["w"])
    # the shared weight stayed one tensor through the fused run
    assert all(mgr.results[f"b{i}"][0]["w"] is W for i in range(n))


def test_farm_lane_capacity_splits_queue():
    """5 compatible jobs on a capacity-4 slot: one 4-lane dispatch plus
    one solo run — never a partial merge beyond capacity."""
    mgr = _farm(slots=1, lanes=4)
    outs = _submit_lane_jobs(mgr, 5)
    rep = mgr.run()
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    stats = [d["lanes_per_dispatch"]
             for d in rep["telemetry"]["devices"].values()]
    assert rep["telemetry"]["lanes_per_dispatch_max"] == 4
    assert [s["n"] for s in stats] == [2]
    assert stats[0]["mean"] == pytest.approx(2.5)
    assert all(len(v) == 4 for v in outs.values())


# ---------------------------------------------------------- compatibility --
def test_lane_compatible_names_the_mismatch():
    def job(**kw):
        base = dict(name="j", engine=_engine, windows=_windows(0),
                    state=_state(0), shell={}, stack_fn=_stack,
                    lane_key="arch-a")
        base.update(kw)
        return FarmJob(**base)

    a = job()
    assert lane_compatible(a, job(name="k")) is None
    assert "lane_key" in lane_compatible(a, job(lane_key="arch-b"))
    assert "engine" in lane_compatible(a, job(engine=lambda s, h, x: 0))
    assert "stack_fn" in lane_compatible(
        a, job(stack_fn=lambda it: torch.as_tensor(np.stack(it))))
    assert "window" in lane_compatible(a, job(windows=_windows(1, 9, 2)))
    assert "shape" in lane_compatible(
        a, job(state={"bias": torch.zeros((3,)), "w": W}))
    assert "cadence" in lane_compatible(
        a, job(barriers=(DrainBarrier(every=2,
                                      action=lambda s, b: None),)))
    assert "plumbing" in lane_compatible(
        a, job(drain_fn=lambda s: ({}, s)))
    assert "factory" in lane_compatible(a, job(state=lambda: _state(0)))
    assert "not a list" in lane_compatible(
        a, job(windows=lambda: iter(_windows(0))))
    b = job()
    b.committed_outputs = [np.float32(1)]
    assert "resume" in lane_compatible(a, b)


# ------------------------------------------------------ lane-granular veto --
def test_lane_veto_evicts_only_the_faulted_lane(n=4, bad=2):
    """A verify failure mid-stream names ONE lane: that member is detached
    and requeued solo (resuming from its per-lane snapshot, not window 0),
    the survivors keep running, and every board — the vetoed one too —
    still delivers exactly-once outputs bit-identical to its solo run."""
    solo_mgr = _farm(slots=2)
    solo = _submit_lane_jobs(solo_mgr, n, lane_key=None)
    solo_mgr.run()

    marked = {"done": False}

    def chaos_verify(plan, records, ys):
        if plan.index == 2 and not marked["done"]:
            marked["done"] = True
            raise RuntimeError("injected lane fault")

    mgr = _farm(slots=2, lanes=n)
    outs = _submit_lane_jobs(mgr, n, verify_for=bad, verify=chaos_verify)
    rep = mgr.run(strict=False)
    vetoes = rep["telemetry"]["lane_vetoes"]
    assert len(vetoes) == 1 and vetoes[0]["job"] == f"b{bad}"
    assert vetoes[0]["lane"] == bad
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert rep["jobs"][f"b{bad}"]["requeues"] == 1
    assert all(rep["jobs"][f"b{i}"]["requeues"] == 0
               for i in range(n) if i != bad)
    j = rep["jobs"][f"b{bad}"]
    assert j["windows_committed"] > 0
    assert j["windows_replayed"] < len(_windows(bad))
    for name in solo:
        assert Counter(i for i, _, _ in outs[name]) \
            == Counter(range(len(solo[name])))
        _same(solo[name], outs[name])


def test_forced_eviction_of_a_member_cuts_the_fused_run():
    """Force-marking one member cuts the whole fused run at its next
    drain boundary; every member requeues (solo) from its own per-lane
    snapshot and delivers exactly its solo outputs."""
    n = 3
    solo_mgr = _farm(slots=2)
    solo = _submit_lane_jobs(solo_mgr, n, lane_key=None)
    solo_mgr.run()
    mgr = _farm(slots=2, lanes=n)
    fired = {"done": False}

    def verify(plan, records, ys):
        if plan.index == 1 and not fired["done"]:
            fired["done"] = True
            mgr.force_evict("b1")

    outs = _submit_lane_jobs(mgr, n, verify_for=0, verify=verify)
    rep = mgr.run()
    assert [e["job"] for e in rep["telemetry"]["evictions"]] == \
        ["lanes[b0+b1+b2]"]
    assert all(rep["jobs"][f"b{i}"]["requeues"] == 1 for i in range(n))
    assert all(r["window"] > 0 for r in rep["telemetry"]["resumes"])
    for name in solo:
        _same(solo[name], outs[name])


# ------------------------------------------------------- fused shell path --
def _shell_engine(state, shell, stack):
    s, _, ys = _engine(state, shell, stack)
    # gather, not a reduction, as the reference's case
    return s, {"acc": shell["acc"] + ys[-1, 0]}, ys


def _shell_drain(shell):
    return {"acc": shell["acc"]}, {"acc": torch.zeros_like(shell["acc"])}


def _shell_reset(shell):
    return {"acc": torch.zeros_like(shell["acc"])}


def test_fused_custom_drain_fans_records_out_per_lane(n=3):
    """Boards with a custom drain_fn/reset shell: the fused drain runs the
    base drain per lane against shell SLICES and each member's on_drain
    sees exactly the records its solo run produces."""
    def run(lanes):
        mgr = _farm(slots=1, lanes=lanes)
        recs = {}
        for i in range(n):
            name = f"b{i}"
            recs[name] = []
            mgr.submit(FarmJob(
                name=name, engine=_shell_engine, windows=_windows(i),
                state=_state(i), shell={"acc": torch.tensor(0.0)},
                stack_fn=_stack, drain_fn=_shell_drain, reset=_shell_reset,
                on_drain=lambda p, r, y, nm=name: recs[nm].append(
                    float(r["acc"])),
                lane_key="shelly"))
        return recs, mgr.run()

    solo, _ = run(lanes=1)
    fused, rep = run(lanes=n)
    assert rep["telemetry"]["lanes_per_dispatch_max"] == n
    assert fused == solo


# ------------------------------------------------------------- lane extras --
def test_commit_stream_verifier_stamps_the_lane():
    def oracle_step(state, batch):
        b = torch.tensor(float(batch))
        aux = {"scanned": (),
               "tail": ({"checksum": torch.stack([b, b * 2.0])},)}
        return state + b, {}, aux

    rows = np.asarray([[0.0, 5.0, 999.0]], np.float64)
    records = {"fifos": {"commits": {"data": rows, "count": 1,
                                     "dropped": 0}}}
    v = CommitStreamVerifier(oracle_step, torch.tensor(0.0), [5.0],
                             layers=1, lane=3)
    with pytest.raises(CommitDivergence, match="lane 3") as ei:
        v(0, records)
    assert ei.value.lane == 3 and ei.value.step == 0


def test_watchdog_observe_normalizes_by_lane_count():
    wd = Watchdog(timeout_s=10.0, clock=lambda: 0.0)
    wd.observe("solo", 0.1)
    wd.observe("fused", 1.6, lanes=16)
    assert wd.durations["fused"][-1] == pytest.approx(0.1)
    assert wd.stragglers(factor=2.0, min_fleet=2) == []


def test_lane_dispatch_cost_is_observed_per_board():
    """The farm observes a fused run's dispatch cost per board: a 3-lane
    run whose dispatch costs 3x a solo board's is not a straggler."""
    clock = {"t": 0.0}

    def engine(state, shell, stack):
        clock["t"] += 0.01
        return _engine(state, shell, stack)

    mgr = FarmManager(device="cpu", slots=2, lanes=3, straggler_factor=2.0,
                      clock=lambda: clock["t"])
    for i in range(3):
        mgr.submit(FarmJob(name=f"b{i}", engine=engine, windows=_windows(i),
                           state=_state(i), shell={}, stack_fn=_stack,
                           lane_key="k"))
    rep = mgr.run()
    assert rep["telemetry"]["evictions"] == []
    assert all(d == pytest.approx(0.01 / 3)
               for d in mgr.wd.durations.get("cpu:0#0", []))


def test_verify_subsystems_lanes_matches_solo_and_localizes_faults():
    """The subsystem pass under lane coalescing (recurrentgemma-2b's smoke
    config, where layers 0, 1, 3 and 4 share a spec): reports equal to
    the solo pass field for field, and an injected fault still localizes
    to its layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Runtime, build_model
    cfg = get_smoke_config("recurrentgemma-2b")
    params = build_model(cfg).init(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 16, cfg.d_model, generator=g).bfloat16()
          for _ in range(4)]
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    solo = verify_subsystems(params, cfg, Runtime(), xs, pos, [0, 1],
                             device="cpu")
    laned = verify_subsystems(params, cfg, Runtime(), xs, pos, [0, 1],
                              lanes=True, device="cpu")
    for k in solo:
        assert laned[k].diverged == solo[k].diverged is False
        assert laned[k].steps == solo[k].steps
        assert laned[k].max_rel_err == pytest.approx(solo[k].max_rel_err)
    bad = inject_fault(params, cfg, layer=1)
    rep = verify_subsystems(params, cfg, Runtime(), xs, pos, [0, 1],
                            dut_params=bad, lanes=True, device="cpu")
    assert not rep["layer0"].diverged
    assert rep["layer1"].diverged and rep["layer1"].first.layer == 1


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("scoped", [False, True])
def test_a_finished_fused_run_frees_its_stacks_without_the_collector(
        scoped, lanes):
    """No reference cycle keeps a run alive: once the farm and its
    results are dropped, the lane stacks (and with ``lanes=1`` the solo
    boards' states) are freed by reference counting alone (at full width
    a fused run of 8 layers stacks 3.3 GB; held until the garbage
    collector ran, they raised phase 50's peak)."""
    import gc
    import weakref
    from repro_torch.core.scope import ScopeSpec
    gc.collect()
    gc.disable()
    try:
        mgr = _farm(slots=2, lanes=lanes)
        _submit_lane_jobs(mgr, 3)
        for j in mgr.jobs:
            j.scope = ScopeSpec() if scoped else None
        mgr.run()
        stack = mgr.results["b0"][0]["bias"]
        ref = weakref.ref(stack._base if stack._base is not None else stack)
        del mgr, stack
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("drain", [None, "shell"])
def test_a_lane_batch_is_freed_without_the_collector(drain):
    """A LaneBatch holds no reference cycle (its fused stack and drain
    are bound on each read, not kept on it): dropped, it and its lane
    stacks go at once, also when its engine hands the packed state back
    unchanged, as a subsystem board's does."""
    import gc
    import weakref
    from repro_torch.core.pshell import drain as shell_drain

    def keep(state, shell, stack):
        return state, shell, stack.sum((1, 2))

    gc.collect()
    gc.disable()
    try:
        lb = LaneBatch(keep, [_windows(0), _windows(1)],
                       [_state(0), _state(1)], [{}, {}], stack_fn=_stack,
                       drain_fn=shell_drain if drain else None)
        state = lb.state
        ref, stack = weakref.ref(lb), weakref.ref(state["bias"])
        out, _, _ = lb.engine(state, lb.shell, lb.stack_fn(lb.windows[0]))
        assert out["bias"] is state["bias"]
        del lb, state, out
        assert ref() is None and stack() is None
    finally:
        gc.enable()
