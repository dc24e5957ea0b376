"""The port's fused clock-gated windows on the CPU: a window of
``make_group_step`` run by ``PShell.run_grouped`` must be
OBSERVATIONALLY INDISTINGUISHABLE from ``PShell.run`` step by step —
bit-identical model/optimizer state and drained records (the paper's
non-interference invariants on the fused path) — and its drained commit
stream must follow the reference's on the same weights and batches.

The bitwise cases hold the port against itself (host tensors; on the
card ``tests/test_torch_gpu.py`` holds the CUDA-graph replays the same
way). Against the reference (f32): FIFO counts, dropped credits, the
step CSR and the nan bits equal, the commit rows and losses within
STREAM_RTOL relative to each row's mean |x| (the frameworks sum in
another order, so a checksum's mean can differ by an f32 ulp of the
magnitudes it is summed from).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (CoverageMap, PShell,  # noqa: E402
                              default_shell_config, make_ingest)
from repro_torch.core.graphs import WindowGraphs  # noqa: E402
from repro_torch.data import SyntheticPipeline, make_batch_fn  # noqa: E402
from repro_torch.launch.serve import make_decode_engine, serve  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.testing import (assert_records_equal,  # noqa: E402
                                 assert_trees_equal, train_run)
from repro_torch.train import (init_state, make_group_step,  # noqa: E402
                               make_train_step)
from repro_torch.utils import tree_leaves  # noqa: E402

TAPS = frozenset({"commits", "coverage"})
STREAM_RTOL = 1e-5


def _setup(arch="granite-8b", **rt):
    cfg = get_smoke_config(arch)
    return cfg, Runtime(attention_impl="xla", taps=TAPS, **rt)


def _batches(cfg, n, batch=2, seq=16, seed=0):
    fn = make_batch_fn(cfg, batch, seq, seed)
    return [fn(i) for i in range(n)]


# ------------------------------------------------------ engine equivalence --
@pytest.mark.parametrize("interval", [1, 3, 4])
def test_grouped_bitwise_equals_per_step_with_tail(interval):
    """8 steps at intervals 1, 3 (a tail of 2) and 4: the fused engine's
    final state, every step's metrics and every drained record equal
    PShell.run's to the bit; drains at each window boundary, the tail's
    once."""
    cfg, rt = _setup()
    batches = _batches(cfg, 8)
    a = train_run(cfg, rt, batches, interval, device="cpu", grouped=False)
    b = train_run(cfg, rt, batches, interval, device="cpu")
    assert_trees_equal(a["state"], b["state"], "state")
    assert_records_equal(a["records"], b["records"], "records")
    expect = [min(i + interval, 8) - 1 for i in range(0, 8, interval)]
    assert [i for i, _ in b["records"]] == expect
    assert b["records"][-1][1]["metrics"]["loss"].shape == \
        (8 % interval or interval,)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b"])
def test_grouped_bitwise_equals_per_step_for_each_family(arch):
    cfg, rt = _setup(arch)
    batches = _batches(cfg, 5)
    a = train_run(cfg, rt, batches, 2, device="cpu", grouped=False)
    b = train_run(cfg, rt, batches, 2, device="cpu")
    assert_trees_equal(a["state"], b["state"], f"{arch} state")
    assert_records_equal(a["records"], b["records"], f"{arch} records")


def test_grouped_composes_with_accum_steps():
    cfg, rt = _setup()
    batches = _batches(cfg, 4, batch=4)
    a = train_run(cfg, rt, batches, 2, device="cpu", grouped=False,
                  accum_steps=2)
    b = train_run(cfg, rt, batches, 2, device="cpu", accum_steps=2)
    assert_trees_equal(a["state"], b["state"], "state")
    assert_records_equal(a["records"], b["records"], "records")


def test_group_step_without_shell():
    """ingest=None: the shell passes through untouched, the state equals
    the per-step loop's."""
    cfg, rt = _setup()
    model = build_model(cfg, rt)
    batches = _batches(cfg, 3)
    stack = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    state, shell, metrics = make_group_step(model)(
        init_state(model, 0, device="cpu"), {}, stack)
    assert shell == {}
    assert metrics["loss"].shape == (3,)
    step = make_train_step(model, with_aux=False)
    s = init_state(model, 0, device="cpu")
    for b in batches:
        s, _ = step(s, b)
    assert_trees_equal(s, state, "shell-less group step")


@pytest.mark.parametrize("interval", [1, 3, 8])
def test_shell_never_feeds_back_into_the_model_state(interval):
    """Invariant 1: the params are bit-identical with the shell on (at any
    interval) and off."""
    cfg, rt = _setup()
    batches = _batches(cfg, 6)
    on = train_run(cfg, rt, batches, interval, device="cpu")
    off = train_run(cfg, rt, batches, interval, device="cpu", shell=False)
    assert_trees_equal(on["state"], off["state"], "shell on vs off")
    assert all(r["fifos"]["commits"]["count"] == 0 and
               r["fifos"]["commits"]["dropped"] == 0
               for _, r in off["records"])


@pytest.mark.parametrize("interval", [2, 3])
def test_drop_credits_are_exact_across_windows(interval):
    """Invariant 3 with an undersized commit FIFO: each window drops
    exactly what exceeds the depth, the cumulative credit survives the
    drains, and both engines agree."""
    cfg, rt = _setup()
    L = cfg.num_layers
    depth = interval * L - 1
    batches = _batches(cfg, 7)
    a = train_run(cfg, rt, batches, interval, device="cpu", grouped=False,
                  commit_depth=depth)
    b = train_run(cfg, rt, batches, interval, device="cpu",
                  commit_depth=depth)
    assert_records_equal(a["records"], b["records"], "records")
    sizes = [min(interval, 7 - i) for i in range(0, 7, interval)]
    want = np.cumsum([max(0, g * L - depth) for g in sizes]).tolist()
    assert [r["fifos"]["commits"]["dropped"]
            for _, r in b["records"]] == want
    assert [r["fifos"]["commits"]["count"] for _, r in b["records"]] == \
        [min(g * L, depth) for g in sizes]


# -------------------------------------------------------- compile_group ----
def test_compile_group_is_keyed_on_the_function_object():
    cfg, rt = _setup()
    model = build_model(cfg, rt)
    ps = PShell(default_shell_config(cfg), make_ingest(cfg))
    g1 = make_group_step(model)
    g2 = make_group_step(model)           # same code, another object
    e1 = ps.compile_group(g1, device="cpu")
    assert e1 is g1                        # host tensors: the step itself
    assert ps.compile_group(g1, device="cpu") is e1
    assert ps.compile_group(g2, device="cpu") is g2
    assert ps.compile_group(g1, donate=False, device="cpu") is not e1
    assert any(k[0] is g1 for k in ps._compiled)   # the key holds the fn


def test_compile_group_without_donation_keeps_the_callers_state():
    cfg, rt = _setup()
    model = build_model(cfg, rt)
    ps = PShell(default_shell_config(cfg), make_ingest(cfg))
    engine = ps.compile_group(make_group_step(model), donate=False,
                              device="cpu")
    state = init_state(model, 0, device="cpu")
    before = [t.clone() for t in tree_leaves(state)]
    stack = {k: np.stack([b[k] for b in _batches(cfg, 2)])
             for k in ("tokens", "labels")}
    new, _, _ = engine(state, ps.init("cpu"), stack)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    assert int(new["step"]) == 2 and int(state["step"]) == 0


def test_graphs_need_a_card():
    """A CUDA-graph engine refuses host tensors; nothing falls back."""
    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="needs params on a card"):
        make_decode_engine(build_model(cfg), params, graph=True)
    with pytest.raises(ValueError, match="unknown warm-up"):
        WindowGraphs(lambda s, sh, xs: (s, sh, xs), warmup="lazy")
    graphs = WindowGraphs(lambda s, sh, xs: (s, sh, xs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs(torch.zeros(2), {}, np.arange(3))


def test_serve_on_the_host_runs_the_eager_engine():
    out = serve(get_smoke_config("glm4-9b"), 2, 8, 6, sample_interval=2,
                device="cpu", return_cache=True)
    assert out["engine"] == "eager"
    assert out["windows_by_engine"] == {"graph": 0, "eager": 3}
    rows = np.concatenate([np.asarray(d["rows"]) for d in out["drained"]])
    assert rows[:, 0].tolist() == list(range(5))   # device step indices
    assert int(out["cache"]["pos"]) == 8 + 5


# ------------------------------------------------------ the quickstart flow --
def test_quickstart_flow_through_the_ports_entry_points():
    """init_state, make_ingest, PShell(default_shell_config), run_grouped
    of make_group_step with CoverageMap.update on each drain, over a
    SyntheticPipeline (the reference's examples/quickstart.py)."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    rt = Runtime(attention_impl="xla",
                 taps=frozenset({"commits", "coverage", "router"}))
    model = build_model(cfg, rt)
    state = init_state(model, 0, device="cpu")
    ingest = make_ingest(cfg)
    shell = PShell(default_shell_config(cfg, sample_interval=2), ingest)
    cov = CoverageMap()
    pipe = SyntheticPipeline(cfg, batch=2, seq=16)
    seen = []

    def on_drain(i, rec):
        cov.update(rec["csrs"])
        seen.append((i, rec["fifos"]["commits"]["count"],
                     rec["metrics"]["loss"].shape))

    try:
        batches = [next(pipe) for _ in range(5)]
        state, _, _ = shell.run_grouped(make_group_step(model, ingest=ingest),
                                        state, batches, on_drain=on_drain)
    finally:
        pipe.close()
    L = cfg.num_layers
    assert seen == [(1, 2 * L, (2,)), (3, 2 * L, (2,)), (4, L, (1,))]
    assert int(state["step"]) == 5
    assert 0 < cov.fraction() <= 1


def test_pipeline_restart_replays():
    cfg = get_smoke_config("granite-8b")
    direct = make_batch_fn(cfg, 2, 8, seed=3)
    pipe = SyntheticPipeline(cfg, 2, 8, seed=3, start_step=5)
    try:
        got = next(pipe)
        np.testing.assert_array_equal(got["tokens"], direct(5)["tokens"])
        assert pipe.step == 6
    finally:
        pipe.close()


# ----------------------------------------------- against the reference ----
def test_drained_commit_stream_follows_the_reference():
    """run_grouped at interval 3 over 5 steps (a tail of 2) on the same
    f32 weights and batches through both packages."""
    from test_torch_ssm import import_reference
    jax = pytest.importorskip("jax")
    from jax_weights import seeded_params
    core, rstep, rcfgs = import_reference("repro.core", "repro.train.step",
                                          "repro.configs")
    from repro.models import build_model as jax_build
    from repro.models.runtime import Runtime as JaxRuntime
    from repro_torch.interop import state_from_jax

    jcfg = dataclasses.replace(rcfgs.get_smoke_config("granite-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("granite-8b"),
                               dtype="float32")
    jm = jax_build(jcfg, JaxRuntime(taps=TAPS))
    js = {**rstep.init_state(jm, jax.random.key(0)),
          "params": seeded_params(jcfg, 0)}
    init = jax.tree.map(np.asarray, js)
    batches = _batches(tcfg, 5)
    jrecs, trecs = [], []
    jshell = core.PShell(core.default_shell_config(jcfg, 3),
                         core.make_ingest(jcfg))
    jshell.run_grouped(rstep.make_group_step(jm,
                                             ingest=core.make_ingest(jcfg)),
                       js, batches, on_drain=lambda i, r: jrecs.append(
                           (i, r)))
    tm = build_model(tcfg, Runtime(attention_impl="xla", taps=TAPS))
    tshell = PShell(default_shell_config(tcfg, 3), make_ingest(tcfg))
    tshell.run_grouped(make_group_step(tm, ingest=make_ingest(tcfg)),
                       state_from_jax(init, tcfg, "cpu"), batches,
                       on_drain=lambda i, r: trecs.append((i, r)))
    assert [i for i, _ in trecs] == [i for i, _ in jrecs] == [2, 4]
    for (_, t), (_, j) in zip(trecs, jrecs):
        tf, jf = t["fifos"]["commits"], j["fifos"]["commits"]
        assert (tf["count"], tf["dropped"]) == (jf["count"], jf["dropped"])
        assert np.array_equal(tf["data"][:, 0], jf["data"][:, 0])
        scale = np.abs(jf["data"][:, 2:3]) + 1e-6
        err = float((np.abs(tf["data"][:, 1:] - jf["data"][:, 1:])
                     / scale).max())
        assert err <= STREAM_RTOL, err
        for name in ("steps", "nan_bits"):
            assert np.array_equal(t["csrs"][name], j["csrs"][name]), name
        loss_err = np.abs(t["metrics"]["loss"] - j["metrics"]["loss"]) \
            / np.abs(j["metrics"]["loss"])
        assert float(loss_err.max()) <= STREAM_RTOL
