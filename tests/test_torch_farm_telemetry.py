"""The port's farm telemetry and the ZP-Scope plane on the lockstep farm,
on the CPU: every case of the reference's ``tests/test_farm_telemetry.py``
(report schema with tail percentiles, per-slot stall-stack attribution,
the device-side scope channel, bounded logs under concurrent writers) and
the cases of ``tests/test_farm_scope.py`` that lockstep mode covers:
scope on/off bit-identity solo and lane-coalesced, the fleet scope
report, the work-rate channel, and coalescing that requires equal scope
specs. The reference's async-mode scope cases and its ``launch.farm``
smoke gate wait for the next slice; its straggler-by-device-counters
case is mirrored on an injected clock.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import iter_windows  # noqa: E402
from repro_torch.core.scope import ScopeSpec  # noqa: E402
from repro_torch.farm import FarmJob, FarmManager, lane_compatible  # noqa: E402
from repro_torch.farm.telemetry import (FarmTelemetry,  # noqa: E402
                                        _BoundedLog, _stats)


# ---------------------------------------------------------- percentiles --
def test_stats_reports_tail_percentiles():
    st = _stats([float(i) for i in range(1, 101)])
    assert st["n"] == 100
    assert st["mean"] == pytest.approx(50.5)
    assert st["p50"] == 51.0
    assert st["p95"] == 95.0
    assert st["p99"] == 99.0
    assert st["max"] == 100.0
    assert _stats([]) == {"n": 0}
    one = _stats([7.0])
    assert one["p50"] == one["p95"] == one["p99"] == one["max"] == 7.0


def test_report_channel_schema_includes_percentiles():
    fake = {"t": 0.0}
    tm = FarmTelemetry(clock=lambda: fake["t"])
    for i in range(20):
        tm.dispatch("slot0", i, cost_s=0.001 * (i + 1))
        fake["t"] += 0.010
        tm.drain("slot0", i, wall_s=0.002)
    dev = tm.report()["devices"]["slot0"]
    assert dev["windows"] == 20
    for ch in ("window_ms", "dispatch_ms", "drain_ms"):
        for k in ("n", "mean", "p50", "p95", "p99", "max"):
            assert k in dev[ch], (ch, k)
    assert dev["window_ms"]["p50"] == pytest.approx(10.0)
    assert dev["dispatch_ms"]["p99"] == pytest.approx(20.0)


# ------------------------------------------------------------ stall stack --
def test_dominant_stall_attribution_per_slot():
    tm = FarmTelemetry()
    tm.dispatch("slot0", 0, cost_s=0.050)
    tm.drain("slot0", 0, wall_s=0.002)
    dev = tm.report()["devices"]["slot0"]
    assert dev["dominant_stall"] == "dispatch"
    assert set(dev["stall_ms"]) == {"dispatch", "drain"}
    assert dev["stall_ms"]["dispatch"] == pytest.approx(50.0)
    assert "stall: dispatch" in tm.summary()


def test_dominant_stall_absent_without_samples():
    tm = FarmTelemetry()
    tm.dispatch("slot0", 0, cost_s=0.0)
    tm.drain("slot0", 0)
    assert tm.report()["devices"]["slot0"]["dominant_stall"] is None


# ------------------------------------------------------------ bounded log --
def test_bounded_log_reports_dropped_count():
    log = _BoundedLog(maxlen=4)
    for i in range(10):
        log.append(i)
    assert len(log) == 4
    assert list(log) == [6, 7, 8, 9]
    assert log.dropped == 6


def test_bounded_log_dropped_under_concurrent_slot_writers():
    tm = FarmTelemetry(max_events=64)
    threads, per_thread, n_threads = [], 200, 8

    def slot_writer(k):
        for i in range(per_thread):
            tm.scope(f"slot{k}", f"job{k}",
                     {"windows": i + 1, "steps": i + 1, "tokens": 1.0,
                      "d_windows": 1, "d_steps": 1, "d_tokens": 1.0,
                      "lanes": 1, "quiet": False})
            tm.eviction(f"slot{k}", f"job{k}", "straggler")

    for k in range(n_threads):
        t = threading.Thread(target=slot_writer, args=(k,),
                             name=f"slot{k}")
        threads.append(t)
        t.start()
    for t in threads:
        t.join()
    total = per_thread * n_threads
    assert len(tm.scope_samples) == 64
    assert tm.scope_samples.dropped == total - 64
    assert len(tm.evictions) == 64
    assert tm.evictions.dropped == total - 64
    rep = tm.report()
    assert rep["events_dropped"]["scope_samples"] == total - 64
    assert rep["events_dropped"]["evictions"] == total - 64
    assert len(rep["scope"]["jobs"]) == n_threads
    for k in range(n_threads):
        assert rep["scope"]["jobs"][f"job{k}"]["windows"] == per_thread


# ----------------------------------------------------------- scope channel --
def test_scope_report_schema_and_quiet_counts():
    tm = FarmTelemetry()
    tm.scope("slot0", "train",
             {"lanes": 1, "windows": 8, "steps": 16, "tokens": 64.0,
              "gates": [0, 0, 1, 1], "digest": 123, "d_windows": 8,
              "d_steps": 16, "d_tokens": 64.0, "quiet": False})
    tm.scope("slot0", "train",
             {"lanes": 1, "windows": 8, "steps": 16, "tokens": 64.0,
              "gates": [0, 0, 1, 1], "digest": 123, "d_windows": 0,
              "d_steps": 0, "d_tokens": 0.0, "quiet": True})
    tm.scope("slot1", "lanes",
             {"lanes": 2, "windows": 4, "steps": 8,
              "tokens": [16.0, 24.0], "gates": [[0, 0, 1, 1]] * 2,
              "digest": [5, 6], "d_windows": 4, "d_steps": 8,
              "d_tokens": 40.0, "quiet": False})
    sc = tm.scope_report()
    assert sc["samples"] == 3 and sc["samples_dropped"] == 0
    assert sc["quiet_samples"] == 1
    train = sc["jobs"]["train"]
    assert train["slot"] == "slot0"
    assert train["tokens_per_window"] == pytest.approx(8.0)
    assert train["quiet_samples"] == 1
    lanes = sc["jobs"]["lanes"]
    assert lanes["tokens_per_window"] == pytest.approx([4.0, 6.0])
    assert tm.report()["scope"]["jobs"].keys() == {"train", "lanes"}
    assert "scope: 3 samples over 2 jobs" in tm.summary()
    assert "1 quiet intervals excluded" in tm.summary()


def test_summary_lists_policy_and_lane_lines():
    tm = FarmTelemetry()
    tm.lanes("s", 3)
    tm.lane_veto("s", "b1", 1)
    tm.retry("j", 1, 0.0, "veto")
    tm.fallback("s", "j", 4, 2, "corrupt")
    line = tm.summary()
    assert "lanes: 3.0/dispatch mean, 3 max, 1 lane vetoes" in line
    assert "1 retries" in line and "1 snapshot fallbacks" in line


# -------------------------------------------------- ZP-Scope on the farm --
def _engine(state, shell, stack):
    return state + stack.sum(), shell, stack * 2.0


def _windows(seed, n_items=8, group=2):
    items = [np.float32(seed * 100 + i) for i in range(n_items)]
    return list(iter_windows(items, group))


def _stack(items):
    return torch.as_tensor(np.stack(items))


def test_lane_coalescing_requires_equal_scope_spec():
    def mk(scope):
        return FarmJob(name="j", engine=_engine, windows=_windows(0),
                       state=torch.tensor(0.0), shell={}, stack_fn=_stack,
                       lane_key="k", scope=scope)
    a, b = mk(ScopeSpec(every_n_windows=2)), mk(ScopeSpec(every_n_windows=4))
    assert lane_compatible(a, b) == "scope spec"
    assert lane_compatible(mk(ScopeSpec()), mk(None)) == "scope spec"
    assert lane_compatible(mk(ScopeSpec(every_n_windows=2)),
                           mk(ScopeSpec(every_n_windows=2))) is None


def _scoped_pass(scope, lanes=1):
    mgr = FarmManager(device="cpu", slots=2, evict_stragglers=False,
                      lanes=lanes)
    col = {}
    for i in range(2):
        name = f"job{i}"
        col[name] = []
        mgr.submit(FarmJob(
            name=name, engine=_engine, windows=_windows(i),
            state=torch.tensor(0.0), shell={}, stack_fn=_stack, scope=scope,
            lane_key="k" if lanes > 1 else None,
            on_drain=lambda p, r, y, n=name: col[n].append(y)))
    return mgr, mgr.run(), col


@pytest.mark.parametrize("lanes", [1, 2])
def test_scope_on_is_bit_identical_to_scope_off(lanes):
    """Scope-on outputs and states bit-identical to scope-off, no scope
    keys leaking into the published shells, a non-empty fleet report
    (per-lane counters under lanes)."""
    off, _, col_off = _scoped_pass(None, lanes)
    on, rep, col_on = _scoped_pass(ScopeSpec(every_n_windows=2), lanes)
    for n in col_off:
        assert len(col_on[n]) == len(col_off[n]) == 4
        for a, b in zip(col_off[n], col_on[n]):
            assert torch.equal(a, b)
        assert torch.equal(off.results[n][0], on.results[n][0])
        assert on.results[n][1] == {}
    sc = rep["telemetry"]["scope"]
    assert sc["samples"] > 0
    if lanes > 1:
        (row,) = sc["jobs"].values()
        assert row["lanes"] == lanes and len(row["tokens"]) == lanes


def test_farm_scope_report_and_work_channel_feed():
    """Scoped jobs populate the fleet scope report (cumulative counters
    per job) AND the watchdog's device-side work-rate channel."""
    mgr, rep, _ = _scoped_pass(ScopeSpec(every_n_windows=1))
    sc = rep["telemetry"]["scope"]
    assert set(sc["jobs"]) == {"job0", "job1"}
    for row in sc["jobs"].values():
        assert row["windows"] == 4 and row["steps"] == 8
        assert row["tokens_per_window"] == pytest.approx(2.0)
    assert sc["samples"] >= 2
    assert mgr.scope_report() == sc
    assert any(len(v) for v in mgr.wd.work_rates.values())


def test_device_counters_evict_true_straggler_not_heavy_board():
    """On the farm's injected clock: board "heavy" does 8x the device work
    a window (8x tokens) at 4x the dispatch cost, board "slow" the same
    work as the normal boards at 8x their cost. With every board scoped
    the watchdog judges seconds per token from the device counters: only
    "slow" is evicted, requeued, and still delivers outputs bit-identical
    to an undisturbed run."""
    clock = {"t": 0.0}

    def costing(cost, engine=_engine):
        def eng(state, shell, stack):
            clock["t"] += cost
            return engine(state, shell, stack)
        return eng

    def heavy_body(state, shell, stack):
        s, sh, ys = _engine(state, shell, stack)
        return s, sh, ys[:, None].repeat(1, 8)

    engines = {"norm0": costing(0.01), "norm1": costing(0.01),
               "heavy": costing(0.04, heavy_body), "slow": costing(0.08)}

    def submit_all(mgr, scope):
        col = {}
        for i, (name, eng) in enumerate(engines.items()):
            col[name] = []
            mgr.submit(FarmJob(
                name=name, engine=eng, windows=_windows(i, n_items=24),
                state=torch.tensor(0.0), shell={}, stack_fn=_stack,
                scope=scope,
                on_drain=lambda p, r, y, n=name: col[n].append(y)))
        return col

    oracle = FarmManager(device="cpu", slots=4, evict_stragglers=False)
    base = submit_all(oracle, None)
    oracle.run()
    mgr = FarmManager(device="cpu", slots=4, straggler_factor=2.0,
                      straggler_min_s=0.01, clock=lambda: clock["t"])
    col = submit_all(mgr, ScopeSpec(every_n_windows=1))
    rep = mgr.run()
    ev = rep["telemetry"]["evictions"]
    assert ev, "the slow board was never flagged"
    assert {e["job"] for e in ev} == {"slow"}
    assert all(e["why"] == "straggler" for e in ev)
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert any(len(v) for v in mgr.wd.work_rates.values())
    for name in base:
        assert len(col[name]) == len(base[name]) == 12
        for a, b in zip(base[name], col[name]):
            assert torch.equal(a, b)
        assert torch.equal(oracle.results[name][0], mgr.results[name][0])
