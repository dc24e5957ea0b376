"""The port's measured-window roofline (``repro_torch.roofline``,
``repro_torch.core.timing``) on the CPU, held against the JAX package's
``repro.roofline`` and ``repro.core.timing`` where they compute the same
thing: the timing model and the report sections on the same records (with
a ``Hardware`` carrying the reference's v5e numbers), ``WindowCapture``'s
rows, tail scaling and report on the same window events, the farm's
reset on eviction and its committed rows across a resume (the cases of
the reference's ``tests/test_specs_and_roofline.py``, ``test_farm.py`` and
``test_farm_resume.py``), and the window and step counts ``train_loop``
and ``serve`` report (``tests/test_train.py``, ``tests/test_schedule.py``).

The cost pass (``roofline/cost.py``) has no reference counterpart (XLA's
``cost_analysis``): it is held to exact counts on a toy engine, each
kernel wrapper's traced branch to its ``cost`` formula, a window of g
steps to g times one step (the decode and the fused train engine), and
the real state to its bytes. The card-only cases (``device_s`` from CUDA
events, the cost pass launching nothing on a card) are in
``test_torch_gpu.py``.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.boardcheck import no_dispatch_guard  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (DrainBarrier, WindowScheduler,  # noqa: E402
                              iter_windows)
from repro_torch.core.timing import InterfaceTimer, Timeline  # noqa: E402
from repro_torch.farm import FarmJob, FarmManager  # noqa: E402
from repro_torch.kernels import traced_cost, traced_counts  # noqa: E402
from repro_torch.roofline import (HW_H100, Hardware,  # noqa: E402
                                  WindowCapture, save_measured)
from repro_torch.roofline import hw as hw_mod  # noqa: E402
from repro_torch.roofline import report as rep  # noqa: E402
from repro_torch.roofline.cost import count_cost  # noqa: E402
from repro_torch.utils import tree_clone, tree_leaves  # noqa: E402

# the reference's target (repro/roofline/hw.py::HW_V5E), for parity
V5E = Hardware(name="tpu_v5e", peak_flops_bf16=197e12, hbm_bw=819e9,
               ici_link_bw=50e9, ici_links=4, hbm_bytes=16e9,
               vmem_bytes=128 * 2**20)


@pytest.fixture(scope="module")
def ref():
    """The reference's timing model, capture and report generator."""
    from test_torch_ssm import import_reference
    timing, capture, report, hw = import_reference(
        "repro.core.timing", "repro.roofline.capture",
        "repro.roofline.report", "repro.roofline.hw")
    return types.SimpleNamespace(timing=timing, capture=capture,
                                 report=report, hw=hw)


# ------------------------------------------------------------ hardware --
def test_hardware_models_hold_the_stated_figures(ref):
    assert dataclasses_equal(V5E, ref.hw.HW_V5E)
    assert (HW_H100.peak_flops_bf16, HW_H100.peak_flops_f32, HW_H100.hbm_bw,
            HW_H100.hbm_bytes, HW_H100.vmem_bytes) == (
        989e12, 67e12, 3.35e12, 80e9, 228 * 1024)
    assert HW_H100.flops_rate(torch.bfloat16) == 989e12
    assert HW_H100.flops_rate(torch.float32) == 67e12
    # 16 a clock per SM x 132 SMs x 1980 MHz
    assert hw_mod.exp_rate(132, 1980e6) == pytest.approx(4.18176e12)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == {**dataclasses.asdict(b),
                                     "peak_flops_f32": 0.0}


# ------------------------------------------------------------- timing --
GROUPS = [{"compute_s": 0.1, "memory_s": 0.3, "collective_s": 0.2},
          {"compute_s": 0.5, "memory_s": 0.1, "collective_s": 0.7},
          {"compute_s": 0.2, "memory_s": 0.2}]


def test_interface_timer_and_dominants(ref):
    """The reference's case on the reference's numbers, then the port's
    timer and timeline against the reference's on the same events."""
    t = InterfaceTimer(V5E)
    assert t.compute(V5E.peak_flops_bf16) == pytest.approx(1.0)
    assert t.memory(V5E.hbm_bw) == pytest.approx(1.0)
    tl = Timeline(V5E, overlap=True)
    out = tl.simulate([GROUPS[0]])
    assert out["dominant"] == "memory"
    assert out["total_s"] == pytest.approx(0.3)
    rt = ref.timing.InterfaceTimer(ref.hw.HW_V5E)
    for kind, q in (("compute", 3e12), ("memory", 4e9),
                    ("collective", 5e8)):
        assert t.event("e", kind, q).duration_s == \
            rt.event("e", kind, q).duration_s
    for overlap in (True, False):
        assert Timeline(V5E, overlap=overlap).simulate(GROUPS) == \
            ref.timing.Timeline(overlap=overlap).simulate(GROUPS)
    # the port's default target is the H100
    assert InterfaceTimer().compute(989e12) == pytest.approx(1.0)
    assert InterfaceTimer().memory(3.35e12) == pytest.approx(1.0)


# ------------------------------------------------------------- report --
ROOF = {"arch": "granite-8b", "shape": "train_4k", "mesh": "16x16",
        "status": "ok", "compute_s": 1.0, "memory_s": 0.5,
        "memory_s_hlo": 1.5, "collective_s": 2.0,
        "dominant": "collective", "useful_ratio": 0.9,
        "roofline_fraction": 0.4, "roofline_fraction_kernel": 0.5,
        "step_time_bound_s": 2.0}
MEASURED = {"arch": "glm4-9b", "source": "serve", "windows": 8,
            "steps": 63, "wall_s": 0.63, "s_per_step": 0.01,
            "device_s": 0.504, "device_s_per_step": 0.008,
            "hlo_flops": 1.1e15, "hlo_bytes": 1.2e12,
            "achieved_flops_s": 1.7e13, "achieved_bytes_s": 1.9e12,
            "peak_flops_fraction": 0.0175, "peak_hbm_fraction": 0.57}


def _rows(md: str) -> list:
    """The table rows of a section (its header lines dropped)."""
    return [ln for ln in md.splitlines()
            if ln.startswith("| ") and not ln.startswith("| arch")]


def test_report_generation_from_records(ref):
    """The reference's case, and the port's rows equal the reference's on
    the same records; the headers name the H100's figures."""
    roofs = {("granite-8b", "train_4k", "16x16"): ROOF}
    md = rep.roofline_section(roofs)
    assert "granite-8b" in md and "40.0%" in md and "50.0%" in md
    assert "989 TF bf16" in md and "3350 GB/s HBM" in md and "v5e" not in md
    md2 = rep.timing_section(roofs)
    # core = max(C, M) = 1.0; serial = core + K = 3.0; overlap = max = 2.0
    assert "1.50x" in md2
    # the same numbers; the last cell's note names the card's units
    # (tensor cores, links), not the TPU's
    assert [r.split("|")[:-2] for r in _rows(md)] == \
        [r.split("|")[:-2] for r in _rows(ref.report.roofline_section(roofs))]
    assert "link-bound" in md
    assert _rows(md2) == _rows(ref.report.timing_section(roofs))


def test_report_measured_section_on_one_record(ref):
    measured = {("glm4-9b", "serve"): MEASURED}
    md = rep.measured_section(measured)
    (row,) = _rows(md)
    (ref_row,) = _rows(ref.report.measured_section(measured))
    cells, ref_cells = row.split("|"), ref_row.split("|")
    # the port adds the device seconds a step after the wall's
    assert cells[:6] + cells[7:] == ref_cells
    assert cells[6].strip() == "0.0080"
    assert "17.000" in row and "1.75%" in row and "57.00%" in row
    no_card = {("granite-smoke", "train"): {
        **MEASURED, "device_s_per_step": None}}
    assert "| n/a |" in rep.measured_section(no_card)


def test_report_main_renders_the_measured_records(tmp_path, monkeypatch,
                                                  capsys):
    """``python -m repro_torch.roofline.report``: the measured section
    from ``experiments/measured/``; the dry-run, roofline and timing
    sections only where their records exist."""
    monkeypatch.chdir(tmp_path)
    path = save_measured({k: v for k, v in MEASURED.items()
                          if k not in ("arch", "source")}, "glm4-9b", "serve")
    assert path == "experiments/measured/glm4-9b_serve.json"
    assert json.loads((tmp_path / path).read_text())["steps"] == 63
    rep.main()
    md = (tmp_path / "experiments" / "tables.md").read_text()
    assert "§Measured windows" in md and "glm4-9b | serve | 8 | 63" in md
    assert "§Dry-run" not in md and "§Roofline" not in md
    assert "wrote experiments/tables.md" in capsys.readouterr().out


# ------------------------------------------------------------ capture --
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _plan(index, start, size):
    return types.SimpleNamespace(index=index, start=start, size=size)


def _drive(cap, plans):
    """Window events in the overlapped scheduler's order: window i+1 is
    dispatched before window i drains."""
    prev = None
    for p in plans:
        cap.on_dispatch(p, None)
        if prev is not None:
            cap.on_drain(prev, {}, None)
        prev = p
    cap.on_drain(prev, {}, None)


def test_window_capture_matches_the_reference_on_the_same_events(ref):
    """The same window events and cost into both captures: the same rows
    (the port's add ``device_s``, None on the host) and the same report,
    plus ``device_s`` and ``device_s_per_step``."""
    plans = [_plan(0, 0, 2), _plan(1, 2, 2), _plan(2, 4, 1)]
    ours = WindowCapture(V5E, clock=_Clock())
    theirs = ref.capture.WindowCapture(clock=_Clock())
    for cap in (ours, theirs):
        cap.set_cost({"flops": 4e9, "bytes": 6e6}, window_size=2)
        _drive(cap, plans)
    assert [{k: v for k, v in r.items() if k != "device_s"}
            for r in ours.rows] == theirs.rows
    assert all(r["device_s"] is None for r in ours.rows)
    mine, want = ours.report(), theirs.report()
    assert {k: v for k, v in mine.items()
            if k not in ("device_s", "device_s_per_step")} == want
    assert mine["device_s"] is None and mine["device_s_per_step"] is None
    ours.reset(upto=2)
    theirs.reset(upto=2)
    assert [r["window"] for r in ours.rows] == \
        [r["window"] for r in theirs.rows] == [0, 1]


def _body_engine(w):
    def engine(state, shell, stack):
        y = stack @ w
        return state + y.sum(), shell, y
    return engine


def test_window_capture_records_cost_and_wall_pairs():
    """The reference's case (``tests/test_farm.py``): one row per window
    with measured wall time and size-scaled cost, tail window included."""
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    engine = _body_engine(w)
    items = [np.ones((4,), np.float32) * i for i in range(5)]

    def stack(items):
        return torch.as_tensor(np.stack(items))

    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=stack)
    cap = WindowCapture()
    cap.attach_cost(engine, torch.tensor(0.0), {}, stack(items[:2]))
    od, odr = cap.callbacks()
    sched.run(engine, sched.windows(items), torch.tensor(0.0), {},
              on_dispatch=od, on_drain=odr, on_enqueue=cap.on_enqueue)
    assert [r["size"] for r in cap.rows] == [2, 2, 1]
    assert all(r["wall_s"] > 0 for r in cap.rows)
    assert all(r["device_s"] is None for r in cap.rows)   # host tensors
    assert cap.rows[0]["flops"] == 2 * 2 * 4 * 3
    # tail window cost scales by size
    assert cap.rows[2]["flops"] == pytest.approx(cap.rows[0]["flops"] / 2)
    r = cap.report()
    assert r["windows"] == 3 and r["steps"] == 5
    assert r["achieved_flops_s"] > 0
    assert 0 < r["peak_flops_fraction"] < 1
    assert r["device_s"] is None


def test_attach_engine_counts_the_first_dispatched_window():
    """``attach_engine`` returns the engine itself and counts the cost of
    the first window it dispatches (its size the window's), before the
    engine runs; a window dispatched through a wrapper is not counted."""
    w = torch.ones(4, 3)
    engine = _body_engine(w)
    cap = WindowCapture()
    assert cap.attach_engine(engine) is engine
    order = []

    def traced(state, shell, stack):
        order.append("engine")
        return engine(state, shell, stack)

    sched = WindowScheduler(interval=3, overlap=True, drain_fn=None,
                            stack_fn=lambda xs: torch.stack(xs))
    items = [torch.ones(4) for _ in range(4)]
    od, odr = cap.callbacks()
    sched.run(engine, sched.windows(items), torch.tensor(0.0), {},
              on_dispatch=od, on_drain=odr, on_enqueue=cap.on_enqueue)
    assert cap.rows[0]["flops"] == 2 * 3 * 4 * 3
    assert cap.rows[1]["flops"] == 2 * 1 * 4 * 3
    other = WindowCapture()
    other.attach_engine(engine)
    od, odr = other.callbacks()
    sched.run(traced, sched.windows(items), torch.tensor(0.0), {},
              on_dispatch=od, on_drain=odr, on_enqueue=other.on_enqueue)
    assert order == ["engine", "engine"]
    assert all(r["flops"] is None for r in other.rows)


def test_on_enqueue_holds_the_engine_call_alone():
    """The scheduler enters the hook after the window's placement and
    leaves it right after the engine call, before ``on_dispatch``."""
    order = []

    class Hook:
        def __init__(self, plan):
            self.plan = plan

        def __enter__(self):
            order.append(("enter", self.plan.index))

        def __exit__(self, *exc):
            order.append(("exit", self.plan.index))

    def engine(state, shell, stack):
        order.append(("engine", int(stack.shape[0])))
        return state, shell, stack

    sched = WindowScheduler(interval=2, overlap=True, drain_fn=None,
                            stack_fn=lambda xs: torch.stack(xs))
    sched.run(engine, sched.windows([torch.ones(1)] * 3), torch.tensor(0.0),
              {}, on_enqueue=lambda plan, *a: Hook(plan),
              on_dispatch=lambda plan, st: order.append(("dispatch",
                                                         plan.index)))
    assert order == [("enter", 0), ("engine", 2), ("exit", 0),
                     ("dispatch", 0), ("enter", 1), ("engine", 1),
                     ("exit", 1), ("dispatch", 1)]


# ---------------------------------------------------------------- farm --
def _farm_engine(state, shell, stack):
    return state + stack.sum(), shell, stack * 2.0


def _windows(seed, n_items=6, group=2):
    return list(iter_windows([np.float32(seed * 100 + i)
                              for i in range(n_items)], group))


def _stack(items):
    return torch.as_tensor(np.stack(items))


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_window_capture_attaches_to_farm_job_and_resets_on_evict(mode):
    """The reference's case (``tests/test_farm.py``): a FarmJob capture
    records exactly the delivered windows; eviction resets it, so the
    replayed attempt's rows are not counted twice. In both host loops."""
    mgr = FarmManager(slots=2, device="cpu", mode=mode)
    cap = WindowCapture()
    mgr.submit(FarmJob(name="a", engine=_farm_engine, windows=_windows(0),
                       state=torch.tensor(0.0), shell={}, stack_fn=_stack,
                       capture=cap))
    mgr.submit(FarmJob(name="b", engine=_farm_engine, windows=_windows(1),
                       state=torch.tensor(0.0), shell={}, stack_fn=_stack))
    mgr.force_evict("a")
    rep_ = mgr.run()
    assert rep_["jobs"]["a"]["requeues"] >= 1
    assert [r["window"] for r in cap.rows] == [0, 1, 2]   # one attempt only
    assert cap.report()["steps"] == 6


def test_capture_rides_solo():
    """A job with a capture never rides a lane batch."""
    from repro_torch.farm.manager import lane_compatible
    kw = dict(engine=_farm_engine, windows=_windows(0),
              state=torch.tensor(0.0), shell={}, stack_fn=_stack,
              lane_key="k")
    a = FarmJob(name="a", **kw)
    assert lane_compatible(a, FarmJob(name="b", **kw)) is None
    assert lane_compatible(a, FarmJob(name="c", capture=WindowCapture(),
                                      **kw)) == "capture"


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_capture_keeps_committed_rows_across_resume(mode):
    """The reference's case (``tests/test_farm_resume.py``): a FarmJob
    capture under checkpointed requeue keeps the rows of committed
    windows across the eviction and re-records only the discarded tail:
    one row per window overall."""
    from test_torch_farm import _evict_trigger, _held, _submit_board

    cap = WindowCapture()
    mgr = FarmManager(slots=3, device="cpu", mode=mode,
                      evict_stragglers=False)
    trigger = _evict_trigger(mgr, 4)
    _submit_board(mgr, verify=trigger, capture=cap,
                  engine=_held(mgr, _farm_engine, trigger))
    r = mgr.run()
    assert r["jobs"]["j"]["requeues"] == 1
    assert r["telemetry"]["resumes"][0]["window"] > 0
    assert [row["window"] for row in cap.rows] == list(range(8))


# ------------------------------------------------------- entry points --
def test_train_loop_and_serve_report_the_reference_counts():
    """The counts the reference's own tests hold its defaults to: a
    6-step loop in windows of 2 reports 3 windows and 6 steps
    (``tests/test_train.py``); a serve of 8 tokens in windows of 3, 3
    windows and 7 steps (``tests/test_schedule.py``). Both carry a cost
    (one step counted and scaled) and no device time on the host."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import LoopConfig, train_loop

    cfg = get_smoke_config("granite-8b")
    model = build_model(cfg, Runtime(attention_impl="xla",
                                     taps=frozenset({"commits"})))
    out = train_loop(model, LoopConfig(steps=6, batch=2, seq=16,
                                       sample_interval=2), device="cpu")
    r = out["roofline"]
    assert r["windows"] == 3 and r["steps"] == 6 and r["s_per_step"] > 0
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["device_s"] is None and r["device_s_per_step"] is None
    out = serve(cfg, batch=2, prompt_len=8, gen=8, sample_interval=3,
                device="cpu")
    r = out["roofline"]
    assert r["windows"] == 3 and r["steps"] == 7 and r["s_per_step"] > 0
    assert r["hlo_flops"] > 0 and r["device_s"] is None


def test_serve_counts_a_cells_step_once(monkeypatch):
    """A decode step's cost is a function of the config and the shapes:
    serve counts it once a process for a cell (as a jit compile once a
    signature) and again for a new ring length, and every serve of the
    cell reports the same cost."""
    from repro_torch.launch import serve as serve_mod

    calls = []
    real = serve_mod.count_cost

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(serve_mod, "count_cost", counting)
    monkeypatch.setattr(serve_mod, "_STEP_COSTS", {})
    cfg = get_smoke_config("granite-8b")
    kw = dict(batch=2, prompt_len=8, sample_interval=2, device="cpu")
    a = serve_mod.serve(cfg, gen=5, **kw)["roofline"]
    b = serve_mod.serve(cfg, gen=5, seed=1, **kw)["roofline"]
    assert len(calls) == 1 and a["hlo_flops"] == b["hlo_flops"]
    c = serve_mod.serve(cfg, gen=7, **kw)["roofline"]
    assert len(calls) == 2
    assert c["hlo_flops"] / c["steps"] > a["hlo_flops"] / a["steps"]


def test_serve_cli_saves_the_measured_record(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve as serve_cli
    monkeypatch.chdir(tmp_path)
    serve_cli.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "5", "--sample-interval", "2",
                    "--save-measured"])
    out = json.loads(capsys.readouterr().out)
    saved = json.loads((tmp_path / "experiments" / "measured"
                        / "glm4-smoke_serve.json").read_text())
    assert saved["source"] == "serve" and saved["arch"] == "glm4-smoke"
    assert saved["windows"] == out["roofline"]["windows"] == 2
    assert saved["steps"] == 4


# ---------------------------------------------------------- cost pass --
def test_count_cost_is_exact_on_a_toy_engine():
    """2·M·N·K FLOPs for the product, and the bytes of each operator's
    tensor arguments read once and outputs written once; views and
    allocations count none."""
    M, K, N = 6, 8, 5
    w = torch.randn(K, N)
    bias = torch.randn(N)

    def engine(state, shell, stack):
        x = stack.reshape(M, K)                 # a view: free
        y = torch.addmm(bias, x, w)             # 2MNK
        out = torch.empty(M, N)                 # an allocation: free
        out.copy_(y)                            # y read, out written
        return state + y.sum(), shell, out

    c = count_cost(engine, torch.tensor(0.0), {}, torch.zeros(2, 3, K))
    f = 4
    assert c["flops"] == 2 * M * N * K
    assert c["bytes"] == (
        (N + M * K + K * N + M * N) * f        # addmm
        + 2 * M * N * f                        # copy_
        + (M * N + 1) * f                      # sum
        + 3 * f)                               # add
    assert c["exps"] == 0


def _fake_kernel_calls():
    from test_torch_analysis import _fake_kernel_calls as calls
    return calls()


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "ssm_scan", "rglru_scan",
                                    "grouped_gemm"])
def test_kernel_traced_branch_records_its_cost(kernel):
    """On fake CUDA tensors each wrapper's traced branch records its
    module's ``cost`` of the call's shapes (the formulas of PERF.md's
    bounds) in the thread's trace tally, and launches nothing."""
    import importlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    seen = []
    real = ops.cost

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    traced_counts(reset=True)
    traced_cost(reset=True)
    try:
        ops.cost = spy
        with no_dispatch_guard(), FakeTensorMode():
            _fake_kernel_calls()[kernel][0]()
    finally:
        ops.cost = real
    assert traced_counts(reset=True) == {kernel: 1}
    assert traced_cost(reset=True) == seen[0]
    want = {
        # B=2, S=T=16, H=4, hd=64, causal: 136 pairs; q, k, v, out bf16
        "flash_attention": {"flops": 4 * 2 * 4 * 136 * 64,
                            "bytes": 2 * (2 * 2 * 16 * 4 * 64
                                          + 2 * 2 * 16 * 2 * 64)},
        # B=2, H=4, hd=64, the whole 32-slot ring of K=2 kv heads
        "decode_attention": {"flops": 4 * 2 * 4 * 32 * 64,
                             "bytes": 2 * (2 * 2 * 4 * 64
                                           + 2 * 2 * 32 * 2 * 64) + 4},
        # B=2, S=8, Din=16, N=16 in f32
        "ssm_scan": {"flops": 256 * (6 * 16 + 1),
                     "bytes": 4 * (3 * 256 + 256 + 2 * 2 * 8 * 16
                                   + 2 * 16 * 16),
                     "exps": 256 * 16},
        "rglru_scan": {"flops": 2 * 256,
                       "bytes": 4 * (3 * 256 + 2 * 2 * 16)},
        "grouped_gemm": {"flops": 2 * 4 * 8 * 16 * 32,
                         "bytes": 2 * (4 * 8 * 16 + 4 * 16 * 32
                                       + 4 * 8 * 32)},
    }[kernel]
    assert seen[0] == want


def test_flash_attention_pairs_count_the_masks():
    from repro_torch.kernels.flash_attention.ops import pairs
    assert pairs(4, 4) == 10
    assert pairs(4, 4, causal=False) == 16
    assert pairs(5, 5, window=2) == 9
    assert pairs(4096, 4096) == 4096 * 4097 // 2


def test_bounds_from_the_module_reproduce_the_kernel_table():
    """The bounds of PERF.md's kernel table come from the kernels'
    ``cost`` and ``hw.bound`` on meta tensors of the timed shapes (the
    exponential rate of an H100 at 1,980 MHz for K3)."""
    from repro_torch.kernels.decode_attention import ops as k2
    from repro_torch.kernels.flash_attention import ops as k1
    from repro_torch.kernels.grouped_gemm import ops as k5
    from repro_torch.kernels.rglru_scan import ops as k4
    from repro_torch.kernels.ssm_scan import ops as k3

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    def ms(cost, dtype=torch.bfloat16, exps=0.0):
        return hw_mod.bound(cost, dtype, exps_per_s=exps)["bound_s"] * 1e3

    bf, f = torch.bfloat16, torch.float32
    q = t(2, 4096, 32, 128)
    kv = t(2, 4096, 2, 128)
    assert ms(k1.cost(q, kv, kv)) == pytest.approx(0.278, abs=5e-4)
    kv2 = t(8, 2120, 2, 128)
    assert ms(k2.cost(t(8, 32, 128), kv2, kv2, slots=2101)) * 1e3 == \
        pytest.approx(5.18, abs=5e-3)
    x = t(2, 4096, 8192, dtype=f)
    exps = hw_mod.exp_rate(132, 1980e6)
    k3c = k3.cost(x, t(8192, 16, dtype=f), t(2, 4096, 16, dtype=f),
                  t(2, 4096, 16, dtype=f), x)
    assert ms(k3c, f, exps) == pytest.approx(0.2568, abs=5e-5)
    a = t(2, 4096, 2560, dtype=f)
    assert ms(k4.cost(a, a, t(2, 2560, dtype=f)), f) == \
        pytest.approx(0.0751, abs=5e-5)
    assert ms(k5.cost(t(128, 640, 2048), t(128, 2048, 768))) == \
        pytest.approx(0.2606, abs=5e-5)
    assert bf is torch.bfloat16


def _decode_setup(arch="glm4-9b", batch=2, prompt=8, gen=8):
    from repro_torch.core.pshell import shell_init
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch.serve import (decode_shell_config,
                                          make_decode_engine)
    from repro_torch.models import build_model
    from repro_torch.serve import make_prefill_step

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in
         make_batch_fn(cfg, batch, prompt, 0)(0).items() if k != "labels"}
    cache, logits = make_prefill_step(model, prompt + gen + 8)(params, b)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    return (make_decode_engine(model, params), (cache, tok),
            shell_init(decode_shell_config(4), torch.device("cpu")))


def _train_setup(arch="granite-8b", batch=2, seq=16, interval=4):
    from repro_torch.core import PShell, default_shell_config, make_ingest
    from repro_torch.data import make_batch_fn
    from repro_torch.models import Runtime, build_model
    from repro_torch.train import OptConfig, init_state, make_group_step

    cfg = get_smoke_config(arch)
    model = build_model(cfg, Runtime(attention_impl="xla",
                                     taps=frozenset({"commits"})))
    ingest = make_ingest(cfg)
    shell = PShell(default_shell_config(cfg, interval), ingest)
    engine = shell.compile_group(
        make_group_step(model, OptConfig(warmup_steps=10), ingest=ingest),
        device="cpu")
    bf = make_batch_fn(cfg, batch, seq, 0)
    sched = shell.scheduler(overlap=True)
    return (engine, init_state(model, 0, device="cpu"),
            shell.init(torch.device("cpu")),
            lambda g: sched.stack_fn([bf(i) for i in range(g)]))


@pytest.mark.parametrize("g", [3, 4])
def test_one_step_times_g_equals_g_steps(g):
    """A window of g identical steps costs g times one step, to the FLOP
    and the byte, for the decode engine and the fused train engine: what
    lets the entry points count one step and scale it."""
    with torch.inference_mode():
        engine, state, shell = _decode_setup()
        one = count_cost(engine, state, shell, np.arange(1))
        many = count_cost(engine, state, shell, np.arange(g))
    assert one["flops"] > 0 and one["bytes"] > 0
    assert many == {k: g * v for k, v in one.items()}
    engine, state, shell, stack = _train_setup()
    one = count_cost(engine, state, shell, stack(1))
    many = count_cost(engine, state, shell, stack(g))
    assert one["flops"] > 0
    assert many == {k: g * v for k, v in one.items()}


def test_cost_pass_leaves_the_real_state_untouched():
    """The decode engine writes its cache in place and the train engine
    its state: on fakes only, never on the real tensors, and nothing
    dispatches."""
    with torch.inference_mode():
        engine, state, shell = _decode_setup()
        before = tree_clone((state, shell))
        with no_dispatch_guard():
            count_cost(engine, state, shell, np.arange(4))
    for a, b in zip(tree_leaves(before), tree_leaves((state, shell))):
        assert torch.equal(a, b)
    engine, state, shell, stack = _train_setup()
    before = tree_clone(state)
    with no_dispatch_guard():
        count_cost(engine, state, shell, stack(2))
    for a, b in zip(tree_leaves(before), tree_leaves(state)):
        assert torch.equal(a, b)


def test_count_cost_names_an_untraceable_engine():
    def engine(state, shell, stack):
        raise ValueError("boom")
    with pytest.raises(RuntimeError, match="boom"):
        count_cost(engine, torch.tensor(0.0), {}, torch.zeros(1))


def test_hw_bound_names_what_sets_it():
    b = hw_mod.bound({"flops": 989e12, "bytes": 1.0})
    assert b["bound_by"] == "operations" and b["bound_s"] == 1.0
    b = hw_mod.bound({"flops": 1.0, "bytes": 3.35e12}, torch.float32)
    assert b["bound_by"] == "bytes" and b["bound_s"] == 1.0
    with pytest.raises(ValueError, match="exps_per_s"):
        hw_mod.bound({"flops": 1.0, "bytes": 1.0, "exps": 5.0})
