"""The port's window scheduler (``repro_torch.core.schedule``) on the CPU:
every case of the reference's ``tests/test_schedule.py`` that this slice
covers, the multi-client half (``Client``, ``ClientPolicy``,
``ClientDriver``, ``run_many``), lane batching (``lane_pack``,
``lane_slice``, ``lane_fetch``, ``LaneBatch``), ``pshell.csr_read``, one
pass mixing serve's decode client with shell-less Scale-Down boards, and
the port held against the JAX package:

  * ``run_many``'s order of dispatch, drain and commit events over the
    same toy clients (numpy inputs), and its per-client plans and ys,
    equal to the reference's;
  * ``lane_pack``'s axes on the same trees equal to the reference's;
  * ``run_many`` with one client equal to ``run`` bit for bit.

The reference's scheduler is reached through
``test_torch_ssm.import_reference`` (``repro.core`` reads names newer jax
releases moved out of ``jax.core``). The reference's serve-through-the-
scheduler case (its roofline capture) waits for the roofline slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (Client, ClientDriver, ClientPolicy,  # noqa: E402
                              DrainBarrier, WindowPlan, WindowScheduler,
                              csr_read, csr_write, iter_windows,
                              plan_windows)
from repro_torch.core.pshell import (FifoSpec, ShellConfig,  # noqa: E402
                                     drain, fifo_push, shell_init)
from repro_torch.core.schedule import (LaneBatch, lane_fetch,  # noqa: E402
                                       lane_pack, lane_slice)
from repro_torch.core.scope import ScopeSpec  # noqa: E402
from repro_torch.kernels import fold_lane_axis, is_lane_batched  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)


@pytest.fixture(scope="module")
def ref():
    """The reference's repro.core.schedule."""
    pytest.importorskip("jax")
    from test_torch_ssm import import_reference
    schedule, = import_reference("repro.core.schedule")
    return schedule


# ---------------------------------------------------------------- planning --
def test_plan_windows_tail_and_resume():
    plans = plan_windows(10, 4)
    assert [(p.start, p.size) for p in plans] == [(0, 4), (4, 4), (8, 2)]
    assert plans[-1].last == 9 and plans[-1].boundary == 10
    plans = plan_windows(10, 4, start=6)
    assert [(p.start, p.size) for p in plans] == [(6, 4)]


def test_iter_windows_chunks_with_tail():
    assert list(iter_windows(range(7), 3)) == [[0, 1, 2], [3, 4, 5], [6]]
    assert list(iter_windows([], 3)) == []


def test_overlap_with_custom_drain_requires_reset():
    with pytest.raises(ValueError, match="reset"):
        WindowScheduler(overlap=True, drain_fn=lambda s: ({}, s))
    WindowScheduler(overlap=True, drain_fn=lambda s: ({}, s),
                    reset=lambda s: s)
    # a run_many client with its own drain and no reset is refused too
    sched = WindowScheduler(overlap=True, drain_fn=None, stack_fn=None)
    with pytest.raises(ValueError, match="reset"):
        sched.run_many([Client(lambda s, h, x: (s, h, x), [[1]], 0, {},
                               drain_fn=lambda s: ({}, s))])


def test_drain_barrier_fires_on_crossing():
    b = DrainBarrier(every=5, action=lambda s, i: None)
    assert not b.fires(WindowPlan(index=0, start=0, size=3))
    assert b.fires(WindowPlan(index=1, start=3, size=3))
    assert b.fires(WindowPlan(index=0, start=0, size=10))


def test_csr_read_returns_the_register():
    cfg = ShellConfig(csrs={"tokens": ((), torch.int32)},
                      fifos={"f": FifoSpec(depth=2, shape=(3,))})
    sh = csr_write(shell_init(cfg), "tokens", 7)
    assert int(csr_read(sh, "tokens")) == 7
    assert csr_read(sh, "tokens") is sh["csr"]["tokens"]


# ------------------------------------------------------------- run/overlap --
@pytest.mark.parametrize("overlap,expect", [
    (True, ["d0", "d1", "drain0", "d2", "drain1", "drain2"]),
    (False, ["d0", "drain0", "d1", "drain1", "d2", "drain2"]),
])
def test_run_overlap_defers_drain_by_one_window(overlap, expect):
    events = []

    def engine(state, shell, stack):
        events.append(f"d{state}")
        return state + 1, shell, stack

    sched = WindowScheduler(interval=2, overlap=overlap, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))
    state, last_ys, _ = sched.run(
        engine, sched.windows(range(5)), 0, {},
        on_drain=lambda plan, rec, ys: events.append(f"drain{plan.index}"))
    assert state == 3
    assert events == expect
    np.testing.assert_array_equal(last_ys, [4])


def test_run_barrier_flushes_pending_and_vetoes():
    commits, drained = [], []
    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))

    def engine(state, shell, stack):
        return state, shell, stack

    sched.run(engine, sched.windows(range(8)), 0, {},
              on_drain=lambda plan, rec, ys: drained.append(plan.boundary),
              barriers=[DrainBarrier(
                  every=4, action=lambda s, step: commits.append(step))])
    assert commits == [4, 8]
    assert drained == [2, 4, 6, 8]

    def verifier(plan, rec, ys):
        if plan.boundary == 4:
            raise RuntimeError("veto")

    with pytest.raises(RuntimeError, match="veto"):
        sched.run(engine, sched.windows(range(8)), 0, {},
                  on_drain=verifier,
                  barriers=[DrainBarrier(
                      every=4, action=lambda s, step: commits.append(step))])
    assert commits == [4, 8]


# ---------------------------------------------------------------- run_many --
def _event_engine(name, events):
    def engine(state, shell, stack):
        events.append(f"{name}:d{int(np.asarray(stack)[0])}")
        return state, shell, stack
    return engine


def test_run_many_interleaves_all_engines_before_drain():
    """Window w of every engine dispatches before any engine's window w-1
    drains; engines with fewer windows finish early."""
    events = []
    sched = WindowScheduler(interval=1, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))
    out = sched.run_many(
        [(_event_engine("a", events), iter_windows([0, 1], 1), "sa", {}),
         (_event_engine("b", events), iter_windows([0], 1), "sb", {})],
        on_drain=lambda k, plan, rec, ys: events.append(
            f"{'ab'[k]}:drain{plan.index}"))
    assert out == [("sa", {}), ("sb", {})]
    assert events == ["a:d0", "b:d0", "a:d1", "b:drain0", "a:drain0",
                      "a:drain1"]


def _toy_pass(schedule_mod, rows, overlap):
    """Three clients of different window counts with per-client barriers
    through ``run_many`` of ``schedule_mod`` (the port's or the
    reference's scheduler), on numpy inputs; returns the event log and
    the per-client (plan, ys) drains."""
    events, got = [], {}

    def make(name):
        def engine(state, shell, stack):
            x = np.asarray(stack, np.float32)
            events.append(("dispatch", name, int(x[0])))
            return state + float(x.sum()), shell, x * 2.0
        return engine

    def commit(name):
        return lambda state, boundary: events.append(
            ("commit", name, boundary, float(state)))

    sched = schedule_mod.WindowScheduler(
        interval=2, overlap=overlap, drain_fn=None,
        stack_fn=lambda items: np.stack(items))
    clients = [schedule_mod.Client(
        make(n), list(iter_windows(r, 2)), 0.0, {},
        barriers=(schedule_mod.DrainBarrier(every=4, action=commit(n)),))
        for n, r in zip("abc", rows)]

    def on_drain(k, plan, rec, ys):
        events.append(("drain", "abc"[k], plan.index))
        got.setdefault(k, []).append(
            (plan.index, plan.start, plan.size, np.asarray(ys).tolist()))

    out = sched.run_many(clients, on_drain=on_drain)
    return events, got, [float(s) for s, _ in out]


@pytest.mark.parametrize("overlap", [True, False])
def test_run_many_event_order_matches_the_reference(ref, overlap):
    """The same three toy clients (numpy inputs from a seed, 7 / 4 / 9
    steps in windows of 2, barriers every 4) through the port's and the
    reference's run_many: the same dispatch / drain / commit events in the
    same order, the same plans and ys, the same final states."""
    import repro_torch.core.schedule as port
    rng = np.random.RandomState(3)
    rows = [[np.float32(v) for v in rng.randn(n)] for n in (7, 4, 9)]
    assert _toy_pass(port, rows, overlap) == _toy_pass(ref, rows, overlap)


def _shell_client_parts(interval):
    cfg = ShellConfig(csrs={"n": ((), torch.int32)},
                      fifos={"f": FifoSpec(depth=interval, shape=(2,))},
                      sample_interval=interval)

    def engine(state, shell, stack):
        for i in range(stack.shape[0]):
            state = torch.tanh(state @ stack[i])
            shell = fifo_push(shell, "f", state[0, :2])
        return state, shell, state.sum(-1)

    g = torch.Generator().manual_seed(0)
    state = torch.randn(4, 4, generator=g)
    items = [torch.randn(4, 4, generator=g) for _ in range(7)]
    return cfg, engine, state, items


@pytest.mark.parametrize("overlap", [True, False])
def test_run_many_with_one_client_equals_run_bitwise(overlap):
    """A P-Shell client (the default drain and reset) alone in run_many
    delivers exactly what run delivers: the same plans, drained records
    and ys to the bit, the same final state and shell."""
    cfg, engine, state, items = _shell_client_parts(3)
    sched = WindowScheduler(interval=3, overlap=overlap)
    solo = []
    s1, _, sh1 = sched.run(engine, sched.windows(items), state.clone(),
                           shell_init(cfg),
                           on_drain=lambda p, r, y: solo.append((p, r, y)))
    many = []
    (s2, sh2), = sched.run_many(
        [(engine, sched.windows(items), state.clone(), shell_init(cfg))],
        on_drain=lambda k, p, r, y: many.append((p, r, y)))
    assert [p for p, _, _ in solo] == [p for p, _, _ in many]
    for (_, ra, ya), (_, rb, yb) in zip(solo, many):
        assert torch.equal(ya, yb)
        np.testing.assert_array_equal(ra["fifos"]["f"]["data"],
                                      rb["fifos"]["f"]["data"])
        assert ra["fifos"]["f"]["count"] == rb["fifos"]["f"]["count"]
    assert torch.equal(s1, s2)
    assert torch.equal(sh1["fifo"]["f"]["buf"], sh2["fifo"]["f"]["buf"])


def test_client_tuple_and_client_are_normalized_alike():
    sched = WindowScheduler(interval=1, overlap=True)
    a = sched._normalize_client((None, [], 1, {}))
    b = sched._normalize_client(Client(None, [], 1, {}))
    assert a == b
    assert a.drain_fn is drain and a.reset is not None
    c = sched._normalize_client(Client(None, [], 1, {}, drain_fn=None,
                                       reset=None, stack_fn=None))
    assert c.drain_fn is None and c.reset is None and c.stack_fn is None


class _Policy(ClientPolicy):
    """Admits a late client at round 1, evicts client 1 at round 2 and
    records done / crashed calls."""

    def __init__(self, late):
        self.late = late
        self.round = 0
        self.done_calls, self.crashes = [], []

    def admit(self, round_idx):
        self.round = round_idx
        return [self.late] if round_idx == 1 else ()

    def evict(self, k):
        return k == 1 and self.round >= 2

    def done(self, k, state, shell):
        self.done_calls.append((k, float(state)))

    def crashed(self, k, exc):
        self.crashes.append((k, str(exc)))
        return True


def _sum_engine(state, shell, stack):
    return state + float(np.sum(stack)), shell, np.asarray(stack) * 2


def test_policy_admits_evicts_and_frees_slots():
    """Dynamic admission appends a client at its round; an evicted
    client's in-flight window is discarded, never delivered; ``done``
    fires once per client that finished, with its final state."""
    sched = WindowScheduler(interval=1, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))
    pol = _Policy(Client(_sum_engine, iter_windows([5, 6], 1), 0.0, {}))
    got = []
    out = sched.run_many(
        [(_sum_engine, iter_windows([1, 2], 1), 0.0, {}),
         (_sum_engine, iter_windows([3, 4, 7, 8], 1), 0.0, {})],
        on_drain=lambda k, p, r, y: got.append((k, p.index)), policy=pol)
    assert len(out) == 3
    # client 1 dispatched windows 0 and 1 before its eviction: only window
    # 0 was drained (delivered); window 1 was in flight and discarded
    assert (1, 0) in got and (1, 1) not in got
    assert sorted(k for k, _ in pol.done_calls) == [0, 2]
    assert dict(pol.done_calls) == {0: 3.0, 2: 11.0}


def test_policy_absorbs_a_crashing_client():
    def boom(state, shell, stack):
        if int(np.asarray(stack)[0]) == 2:
            raise RuntimeError("board fault")
        return _sum_engine(state, shell, stack)

    sched = WindowScheduler(interval=1, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))
    pol = _Policy(None)
    pol.admit = lambda r: ()
    got = []
    sched.run_many([(boom, iter_windows([1, 2, 3], 1), 0.0, {}),
                    (_sum_engine, iter_windows([1, 2, 3], 1), 0.0, {})],
                   on_drain=lambda k, p, r, y: got.append((k, p.index)),
                   policy=pol)
    assert pol.crashes == [(0, "board fault")]
    assert [i for k, i in got if k == 1] == [0, 1, 2]
    assert (0, 1) not in got
    with pytest.raises(RuntimeError, match="board fault"):
        sched.run_many([(boom, iter_windows([1, 2, 3], 1), 0.0, {})])


def test_client_driver_protocol_inject_points_and_commit():
    """The driver's three injection points fire in order (dispatch before
    the engine call, drain as a window retires, commit before a crossed
    barrier's action); ``on_commit`` sees the accepted boundary's state
    and the live shell; ``cancel`` drops what is in flight."""
    log = []
    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))

    def engine(state, shell, stack):
        log.append(("engine", int(stack[0])))
        return state + 1, shell, stack

    client = Client(engine, iter_windows(range(6), 2), 0, {"live": 1},
                    barriers=(DrainBarrier(
                        every=4, action=lambda s, b: log.append(
                            ("action", b))),))
    d = sched.driver(
        client, key=7,
        on_drain=lambda k, p, r, y: log.append(("drain", k, p.index)),
        on_commit=lambda k, p, s, sh: log.append(("commit", k, s, sh)),
        inject=lambda k, point, p: log.append((point, p.index)))
    assert isinstance(d, ClientDriver)
    while d.dispatch() is not None:
        d.advance()
    d.flush()
    assert log == [
        ("dispatch", 0), ("engine", 0), ("drain", 0),
        ("dispatch", 1), ("engine", 2), ("drain", 1), ("drain", 7, 0),
        ("drain", 7, 1), ("commit", 1), ("action", 4),
        ("commit", 7, 2, {"live": 1}),
        ("dispatch", 2), ("engine", 4), ("drain", 2), ("drain", 7, 2)]
    d2 = sched.driver(Client(engine, iter_windows(range(4), 2), 0, {}),
                      on_drain=lambda k, p, r, y: log.append("late"))
    d2.dispatch()
    d2.cancel()
    d2.flush()
    assert d2.exhausted and log[-1] != "late"


def test_client_resume_cursor_keeps_global_plan_ids():
    """A client over the tail of a stream (start_step / start_index)
    emits the plans an uninterrupted run would, tail window included."""
    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=lambda items: np.asarray(items))
    windows = list(iter_windows(range(7), 2))
    full, tail = [], []
    sched.run_many([Client(_sum_engine, windows, 0.0, {})],
                   on_drain=lambda k, p, r, y: full.append(p))
    sched.run_many([Client(_sum_engine, windows[2:], 0.0, {},
                           start_step=4, start_index=2)],
                   on_drain=lambda k, p, r, y: tail.append(p))
    assert tail == full[2:]
    assert tail[-1] == WindowPlan(index=3, start=6, size=1)


def test_scoped_client_is_bit_identical_to_unscoped():
    """A client with ``scope=`` delivers the same records and ys and ends
    in the same state as without; the plane sampled every window."""
    cfg, engine, state, items = _shell_client_parts(2)
    sched = WindowScheduler(interval=2, overlap=True)
    runs = {}
    for sc in (None, ScopeSpec(every_n_windows=1)):
        got = []
        (s, sh), = sched.run_many(
            [Client(engine, sched.windows(items), state.clone(),
                    shell_init(cfg), scope=sc)],
            on_drain=lambda k, p, r, y: got.append((r, y)))
        runs[sc is None] = (s, got)
    (s0, g0), (s1, g1) = runs[True], runs[False]
    assert torch.equal(s0, s1)
    for (r0, y0), (r1, y1) in zip(g0, g1):
        assert torch.equal(y0, y1)
        np.testing.assert_array_equal(r0["fifos"]["f"]["data"],
                                      r1["fifos"]["f"]["data"])


# ------------------------------------------------------------------- lanes --
W = torch.as_tensor(np.random.RandomState(0).randn(8, 8).astype(np.float32))


def _lane_engine(state, shell, stack):
    bias, ys = state["bias"], []
    for i in range(stack.shape[0]):
        y = torch.tanh(stack[i] @ state["w"]) + bias
        bias = bias + 0.01 * y.sum()
        ys.append(y.sum(-1))
    return {"bias": bias, "w": state["w"]}, shell, torch.stack(ys)


def _lane_stack(items):
    return torch.as_tensor(np.stack(items))


def _lane_state(i):
    return {"bias": torch.tensor(i * 0.5), "w": W}


def _lane_windows(seed, n_steps=7, group=2):
    rng = np.random.RandomState(seed)
    items = [rng.randn(4, 8).astype(np.float32) for _ in range(n_steps)]
    return [items[i:i + group] for i in range(0, n_steps, group)]


def test_lane_pack_broadcasts_identity_shared_leaves():
    states = [_lane_state(i) for i in range(4)]
    packed, axes, flat = lane_pack(states)
    assert packed["w"] is W
    assert axes == {"bias": 0, "w": None}
    assert packed["bias"].shape == (4,)
    for k in range(4):
        sl = lane_slice(packed, flat, k)
        assert sl["w"] is W
        assert torch.equal(sl["bias"], states[k]["bias"])
    host = lane_fetch(packed, flat)
    assert host["w"] is W and torch.equal(host["bias"], packed["bias"])
    assert lane_pack([None, None]) == (None, None, [])


def test_lane_pack_axes_match_the_reference(ref):
    """The same trees (shared leaves by identity, per-lane leaves not)
    pack with the same axes tree and flat axes on both sides."""
    import jax.numpy as jnp
    rng = np.random.RandomState(1)
    shared = rng.randn(3, 3).astype(np.float32)
    lanes = [{"a": rng.randn(2).astype(np.float32), "b": shared,
              "c": (rng.randn(1).astype(np.float32), shared)}
             for _ in range(3)]
    jshared = jnp.asarray(shared)
    jtrees = [{"a": jnp.asarray(t["a"]), "b": jshared,
               "c": (jnp.asarray(t["c"][0]), jshared)} for t in lanes]
    tshared = torch.from_numpy(shared)
    ttrees = [{"a": torch.from_numpy(t["a"]), "b": tshared,
               "c": (torch.from_numpy(t["c"][0]), tshared)} for t in lanes]
    jpacked, jaxes, jflat = ref.lane_pack(jtrees)
    tpacked, taxes, tflat = lane_pack(ttrees)
    assert taxes == jaxes and tflat == jflat
    np.testing.assert_array_equal(tpacked["a"].numpy(),
                                  np.asarray(jpacked["a"]))


def test_lane_pack_rejects_structure_mismatch():
    with pytest.raises(ValueError, match="structure"):
        lane_pack([{"a": W}, {"b": W}])


def test_zip_windows_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="window count"):
        LaneBatch.zip_windows([_lane_windows(0, 7, 2),
                               _lane_windows(1, 9, 2)])
    with pytest.raises(ValueError, match="sizes differ"):
        LaneBatch.zip_windows([_lane_windows(0, 7, 2),
                               _lane_windows(1, 8, 2)])


def test_lane_batch_scheduler_bit_identity():
    """One fused client through the raw scheduler delivers, per lane,
    exactly the (plan ids, ys) each solo run delivers."""
    n = 4
    solo = []
    for i in range(n):
        got = []
        WindowScheduler(stack_fn=_lane_stack, drain_fn=None).run(
            _lane_engine, _lane_windows(i), _lane_state(i), {},
            on_drain=lambda p, r, y: got.append((p.index, p.start, y)))
        solo.append(got)
    lb = LaneBatch(_lane_engine, [_lane_windows(i) for i in range(n)],
                   [_lane_state(i) for i in range(n)], [{} for _ in range(n)],
                   stack_fn=_lane_stack)
    assert lb.state["w"] is W
    fused = []
    WindowScheduler(stack_fn=None, drain_fn=None).run_many(
        [lb.client()], on_drain=lambda k, p, r, y: fused.append((p, r, y)))
    assert len(fused) == len(solo[0])
    for plan, records, ys in fused:
        for k in range(n):
            _, lane_ys = lb.fan_out_one(records, ys, k)
            idx, start, want = solo[k][plan.index]
            assert (plan.index, plan.start) == (idx, start)
            assert torch.equal(lane_ys, want)


def test_lane_batch_fused_engine_is_cached_per_engine():
    mk = [LaneBatch(_lane_engine, [_lane_windows(i) for i in range(2)],
                    [_lane_state(i) for i in range(2)], [{}, {}],
                    stack_fn=_lane_stack) for _ in range(2)]
    assert mk[0].engine is mk[1].engine


def test_lane_batch_needs_a_stack_fn_and_a_reset():
    args = ([_lane_windows(0)], [_lane_state(0)], [{}])
    with pytest.raises(ValueError, match="stack_fn"):
        LaneBatch(_lane_engine, *args, stack_fn=None)
    with pytest.raises(ValueError, match="reset"):
        LaneBatch(_lane_engine, *args, stack_fn=_lane_stack,
                  drain_fn=lambda s: ({}, s))


def test_lane_batch_raises_where_the_engine_does_not_vmap():
    """An engine that reads a device value on the host inside the window
    cannot be fused: the vmap raises, naming the op; nothing runs the
    lanes one after another instead."""
    def reads_host(state, shell, stack):
        if float(stack.sum()) > 0:
            pass
        return state, shell, stack.sum(-1)

    lb = LaneBatch(reads_host, [_lane_windows(i) for i in range(2)],
                   [_lane_state(i) for i in range(2)], [{}, {}],
                   stack_fn=_lane_stack)
    with pytest.raises(RuntimeError, match="item|Tensor|vmap"):
        WindowScheduler(stack_fn=None, drain_fn=None).run_many(
            [lb.client()])


def test_fold_lane_axis_equals_each_lane_alone():
    """K1's vmap rule body on host tensors: lanes folded into the batch
    axis and one call of the plain attention give each lane's own
    result; a shared (unbatched) k/v is broadcast to every lane."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(3, 2, 12, 4, 8, generator=g)
    k = torch.randn(3, 2, 12, 2, 8, generator=g)
    v = torch.randn(3, 2, 12, 2, 8, generator=g)
    out = fold_lane_axis(flash_attention_ref, 3, (0, 0, 0), q, k, v)
    assert out.shape == q.shape
    for lane in range(3):
        assert torch.equal(out[lane],
                           flash_attention_ref(q[lane], k[lane], v[lane]))
    shared = fold_lane_axis(flash_attention_ref, 3, (0, None, None),
                            q, k[0], v[0])
    for lane in range(3):
        assert torch.equal(shared[lane],
                           flash_attention_ref(q[lane], k[0], v[0]))
    moved = fold_lane_axis(flash_attention_ref, 3, (1, 0, 0),
                           q.movedim(0, 1), k, v)
    assert torch.equal(moved, out)


def test_is_lane_batched_sees_vmapped_tensors_only():
    seen = []
    torch.func.vmap(lambda x: seen.append(is_lane_batched(x)) or x)(
        torch.zeros(2, 3))
    assert seen == [True]
    assert not is_lane_batched(torch.zeros(2), 1.0)


# ------------------------------------------------------ mixed shell-ful pass --
def test_decode_client_beside_shell_less_boards_in_one_pass():
    """serve's decode (P-Shell drain, the smoke glm4-9b) as one client
    beside two shell-less Scale-Down boards in ONE run_many pass: the
    greedy tokens equal serve()'s, and each board's checksums equal its
    own run."""
    from repro_torch.core.coemu import _stack_on_device, subsystem_boards
    from repro_torch.launch.serve import serve
    from repro_torch.models import Runtime, build_model
    from repro_torch.testing import serve_decode_client

    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cpu")
    want = serve(cfg, 2, 16, 9, sample_interval=3, device="cpu",
                 params=params)["tokens"]
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn(2, 16, cfg.d_model, generator=g).bfloat16()
          for _ in range(4)]
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    with torch.inference_mode():
        boards = subsystem_boards(params, cfg, Runtime(), xs, pos, [0, 1])
        decode, on_decode, tokens = serve_decode_client(
            cfg, params, 2, 16, 9, sample_interval=3, device="cpu")
        ys = {1: [], 2: []}

        def on_drain(k, plan, rec, y):
            on_decode(plan, rec, y) if k == 0 else ys[k].append(y)

        WindowScheduler(interval=3, overlap=True, drain_fn=None,
                        stack_fn=None).run_many(
            [decode] + [Client(e, list(iter_windows(x, 2)), s, {},
                               drain_fn=None, stack_fn=_stack_on_device,
                               reset=None) for e, s, x, _, _ in boards],
            on_drain=on_drain)
        for k, (engine, state, x_ins, _, _) in enumerate(boards, 1):
            alone = []
            WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=_stack_on_device).run(
                engine, iter_windows(x_ins, 2), state, {},
                on_drain=lambda p, r, y: alone.append(y))
            assert torch.equal(torch.cat(ys[k]), torch.cat(alone))
    assert tokens() == want
