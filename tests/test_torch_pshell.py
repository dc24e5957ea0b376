"""The port's P-Shell and WindowScheduler on their own (host tensors):
credit accounting, the trash-row scatter, double-buffering, tail windows
and barriers. P-Shell invariant 3: a drain resets FIFO occupancy but never
the cumulative ``dropped`` counter."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DrainBarrier, FifoSpec, ShellConfig,  # noqa: E402
                              WindowScheduler, csr_accum, csr_write, drain,
                              fifo_push, fifo_push_many, group_reset,
                              iter_windows, plan_windows, shell_init,
                              stack_batches)
from repro_torch.utils import tree_leaves  # noqa: E402


def _cfg(depth=2):
    return ShellConfig(csrs={"tokens": ((), torch.int32),
                             "bits": ((), torch.int32)},
                       fifos={"f": FifoSpec(depth=depth, shape=(3,))})


def test_dropped_survives_drains():
    sh = shell_init(_cfg(depth=2))
    for i in range(3):
        sh = fifo_push(sh, "f", torch.full((3,), float(i)))
    rec, sh = drain(sh)
    f = rec["fifos"]["f"]
    assert f["count"] == 2 and f["dropped"] == 1
    assert np.array_equal(f["data"], [[0.0] * 3, [1.0] * 3])
    for i in range(4):
        sh = fifo_push(sh, "f", torch.full((3,), 10.0 + i))
    rec, sh = drain(sh)
    f = rec["fifos"]["f"]
    assert f["count"] == 2 and f["dropped"] == 3     # 1 + 2: cumulative
    assert np.array_equal(f["data"][:, 0], [10.0, 11.0])
    rec, _ = drain(sh)
    assert rec["fifos"]["f"]["count"] == 0
    assert rec["fifos"]["f"]["dropped"] == 3


def test_fifo_push_many_trash_row_and_credits():
    sh = shell_init(_cfg(depth=4))
    sh = fifo_push(sh, "f", torch.ones(3))
    payloads = torch.arange(15, dtype=torch.float32).reshape(5, 3) + 100
    sh = fifo_push_many(sh, "f", payloads)
    rec, _ = drain(sh)
    f = rec["fifos"]["f"]
    assert f["count"] == 4 and f["dropped"] == 2
    assert np.array_equal(f["data"][1:], payloads[:3].numpy())
    assert f["data"].shape == (4, 3)


def test_csrs_and_functional_updates():
    sh = shell_init(_cfg())
    sh2 = csr_accum(sh, "tokens", 5, op="add")
    sh2 = csr_accum(sh2, "tokens", torch.tensor(2), op="add")
    sh2 = csr_accum(sh2, "bits", 0b101)
    sh2 = csr_accum(sh2, "bits", 0b010)
    assert int(sh2["csr"]["tokens"]) == 7
    assert int(sh2["csr"]["bits"]) == 0b111
    assert int(sh["csr"]["tokens"]) == 0           # input untouched
    assert int(csr_write(sh2, "tokens", 42)["csr"]["tokens"]) == 42
    pushed = fifo_push(sh, "f", torch.ones(3))
    assert int(sh["fifo"]["f"]["count"]) == 0
    assert float(sh["fifo"]["f"]["buf"].abs().sum()) == 0.0
    assert int(pushed["fifo"]["f"]["count"]) == 1


def test_group_reset_hands_fresh_buffers():
    sh = fifo_push(shell_init(_cfg(depth=1)), "f", torch.ones(3))
    sh = fifo_push(sh, "f", torch.ones(3))             # dropped = 1
    sh = csr_accum(sh, "tokens", 3, op="add")
    nxt = group_reset(sh)
    for a, b in zip(tree_leaves(sh), tree_leaves(nxt)):
        assert a.data_ptr() != b.data_ptr()            # nothing aliased
    assert int(nxt["fifo"]["f"]["count"]) == 0
    assert int(nxt["fifo"]["f"]["dropped"]) == 1
    assert int(nxt["csr"]["tokens"]) == 3
    assert float(nxt["fifo"]["f"]["buf"].abs().sum()) == 0.0
    assert float(sh["fifo"]["f"]["buf"].sum()) == 3.0  # snapshot intact


def test_plan_and_iter_windows_tail():
    assert [(p.start, p.size) for p in plan_windows(7, 3)] == \
        [(0, 3), (3, 3), (6, 1)]
    assert [p.last for p in plan_windows(7, 3)] == [2, 5, 6]
    assert [p.start for p in plan_windows(9, 4, start=2)] == [2, 6]
    assert list(iter_windows(range(7), 3)) == [[0, 1, 2], [3, 4, 5], [6]]
    assert stack_batches([{"a": 1}, {"a": 2}])["a"].tolist() == [1, 2]


def _counting_engine(state, shell, stack):
    for x in stack:
        state = state + int(x)
        shell = fifo_push(shell, "f", torch.full((3,), float(x)))
        shell = csr_accum(shell, "tokens", 1, op="add")
    return state, shell, torch.as_tensor(stack)


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("interval", [1, 3, 8])
def test_scheduler_drains_every_window_once_in_order(overlap, interval):
    steps = 10
    sched = WindowScheduler(interval=interval, overlap=overlap)
    seen, dispatched = [], []
    state, last, shell = sched.run(
        _counting_engine, sched.windows(range(steps)), 0,
        shell_init(_cfg(depth=interval)),
        on_dispatch=lambda plan, st: dispatched.append(plan.index),
        on_drain=lambda plan, rec, ys: seen.append(
            (plan.index, plan.start, plan.size, rec["fifos"]["f"]["count"],
             int(rec["csrs"]["tokens"]), ys.tolist())))
    plans = plan_windows(steps, interval)
    assert state == sum(range(steps))
    assert dispatched == [p.index for p in plans]
    assert [s[:3] for s in seen] == [(p.index, p.start, p.size)
                                    for p in plans]
    assert [s[3] for s in seen] == [p.size for p in plans]   # lossless
    assert [s[4] for s in seen] == [p.boundary for p in plans]
    assert sum((s[5] for s in seen), []) == list(range(steps))
    assert last.tolist() == list(range(plans[-1].start, steps))


def test_scheduler_barrier_drains_before_its_action():
    sched = WindowScheduler(interval=2, overlap=True)
    log = []
    barrier = DrainBarrier(every=4, action=lambda st, b: log.append(
        ("commit", b, st)))
    sched.run(_counting_engine, sched.windows(range(9)), 0,
              shell_init(_cfg()),
              on_drain=lambda plan, rec, ys: log.append(("drain", plan.last)),
              barriers=[barrier])
    assert log == [("drain", 1), ("drain", 3), ("commit", 4, 6),
                   ("drain", 5), ("drain", 7), ("commit", 8, 28),
                   ("drain", 8)]


def test_watchdog_dead_workers_and_stragglers():
    """The serve loop's watchdog, on an injected clock: a worker that stops
    beating past the timeout is dead; straggling is relative to the
    fleet's lower median."""
    from repro_torch.core import Watchdog
    now = [0.0]
    wd = Watchdog(timeout_s=5.0, clock=lambda: now[0])
    for t in (1.0, 2.0, 3.0):
        now[0] = t
        wd.heartbeat("a")
        wd.heartbeat("b")
    assert wd.stragglers() == [] and not wd.should_restart()
    wd.observe("a", 1.0)
    wd.observe("b", 1.0)
    wd.observe("c", 9.0)
    assert wd.stragglers() == ["c"]
    assert wd.stragglers(min_s=10.0) == []
    now[0] = 8.5
    wd.heartbeat("b")
    assert wd.dead_workers() == ["a"] and wd.should_restart()
    wd.forget("a")
    assert not wd.should_restart()


def test_scheduler_overlap_needs_a_reset():
    with pytest.raises(ValueError, match="reset"):
        WindowScheduler(overlap=True, drain_fn=lambda s: ({}, s))
    WindowScheduler(overlap=True, drain_fn=lambda s: ({}, s),
                    reset=lambda s: s)
