"""The port's farm CLI (``python -m repro_torch.launch.farm``) and the job
registry (``repro_torch.farm.registry``) on the CPU: the CLI's gates in
both host loops (the restart, lanes and scope smokes; the reference's
``test_farm_scope.py::test_scope_smoke_bit_identity`` cases), ``prewarm``
on copies, the flags that wait for a later slice refused by name, the CLI
in a subprocess (``--steps 8`` exits 0; SIGINT once the farm runs exits
130 with a partial report), ``JobSpec`` / ``submit_spec``, and
``run_farm``'s workload held against the reference's ``run_farm``.

Against the reference: granite-8b's smoke config in f32, the same weights
(redrawn from numpy by ``jax_weights``, carried across by ``interop``)
and the same verify activations in both packages; in each host loop the
port's train losses within 1e-5 of the reference's (relative), the
greedy tokens equal, and the verify reports alike (the same verdicts,
max_rel_err within 1e-5).
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DrainBarrier  # noqa: E402
from repro_torch.farm import (FarmJob, FarmManager,  # noqa: E402
                              FactoryRegistry, JobSpec, REGISTRY)
from repro_torch.launch import farm as cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5        # the train step's f32 parity (test_torch_train)
CK_RTOL, CK_ATOL = 1e-5, 1e-6


# ----------------------------------------------------------- the gates --
@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_restart_smoke_resumes_from_the_last_barrier(mode):
    out = cli.run_restart_smoke(mode, device="cpu")
    assert out["ok"], out
    j = out["jobs"]["restart"]
    assert j["requeues"] == 1
    assert j["windows_replayed"] < j["windows_committed"]
    assert out["windows_delivered"] == 40 and out["preserved"]


@pytest.mark.parametrize("mode", ["lockstep", "async"])
@pytest.mark.parametrize("chaos_lane", [False, True])
def test_lanes_smoke_coalesces_and_evicts_only_the_chaos_lane(mode,
                                                              chaos_lane):
    out = cli.run_lanes_smoke(8, chaos_lane=chaos_lane, mode=mode,
                              device="cpu")
    assert out["ok"], out["problems"]
    assert out["lanes_per_dispatch_max"] == 8
    assert len(out["lane_vetoes"]) == (1 if chaos_lane else 0)


@pytest.mark.parametrize("mode,lanes", [("async", 1), ("lockstep", 1),
                                        ("async", 2), ("lockstep", 8)])
def test_scope_smoke_bit_identity(mode, lanes):
    """The gate's own checker: scope-on outputs/states bit-identical to
    scope-off, no scope keys leaking, non-empty fleet report."""
    out = cli.run_scope_smoke(mode=mode, lanes=lanes, every_n=2, slots=2,
                              n_steps=8, device="cpu")
    assert out["ok"], out["problems"]
    assert out["scope"]["samples"] > 0


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_run_farm_mixed_workload_on_the_host(mode):
    out = cli.run_farm("granite-8b", 8, 4, mode=mode, device="cpu")
    assert out["ok"], out["jobs"]
    assert out["train"]["steps"] == 8
    assert np.asarray(out["decode"]["tokens"]).shape == (2, 8)
    assert set(out["verify"]) == {"layer0", "layer1"}


def test_run_farm_lockstep_straggler_is_force_evicted():
    """Lockstep: the last verify board, slowed, is force-marked and must
    be evicted and requeued with its outputs intact (the run's own
    wall-clock straggler check may flag another board too on a loaded
    host; the gate is the forced eviction)."""
    out = cli.run_farm("granite-8b", 4, 3, mode="lockstep",
                       synthetic_straggler=True, device="cpu")
    assert out["ok"], out["jobs"]
    assert out["jobs"]["layer1"]["requeues"] == 1
    assert [e["why"] for e in out["telemetry"]["evictions"]
            if e["job"] == "layer1"] == ["forced"]


def test_prewarm_runs_each_engine_on_copies():
    """An engine that updates its state in place leaves the job's own
    state as it was: prewarm hands it fresh copies."""
    calls = []

    def engine(state, shell, stack):
        calls.append(stack.shape)
        state.add_(100.0)
        return state, shell, stack * 2.0

    mgr = FarmManager(device="cpu", slots=1)
    state = torch.zeros(3)
    mgr.submit(FarmJob(name="j", engine=engine,
                       windows=[[np.float32(1)], [np.float32(2)]],
                       state=state, shell={},
                       stack_fn=lambda it: torch.as_tensor(np.stack(it))))
    assert cli.prewarm(mgr) >= 0.0
    assert calls == [torch.Size([1])]           # the first window, once
    assert torch.equal(state, torch.zeros(3))
    assert mgr.run()["jobs"]["j"]["status"] == "done"


def test_write_telemetry_merges_runs_by_key(tmp_path):
    path = str(tmp_path / "t.json")
    k1 = cli.write_telemetry(path, {"telemetry": {"a": 1}}, "run")
    k2 = cli.write_telemetry(path, {"telemetry": {"a": 2}}, "run")
    data = json.loads(Path(path).read_text())
    assert (k1, k2) == ("run", "run#2") and set(data) == {"run", "run#2"}
    assert data["run#2"]["telemetry"] == {"a": 2}


# ------------------------------------------------------- refused flags --
# The first four cases refused the ledger flags until the ledger slice;
# they keep their ids and now run them: ``--ledger DIR`` a durable toy
# campaign, ``--recover`` over its journal, ``--kill-after-commits`` a
# victim (in a subprocess: it SIGKILLs its own process) and
# ``--killrestart-smoke`` the whole gate (lockstep here; both modes in
# test_torch_farm_ledger.py). The next two refused until ZP-Cert and now
# run: ``--certify`` the mixed farm behind the certification gate (every
# board admitted), ``--certify-smoke`` the admission gate (both modes in
# test_torch_certify_farm.py). The last refused until the roofline slice
# and now runs: ``--roofline`` the mixed farm with a capture on its train
# board (both modes in chip_smoke.py's phase 57).
@pytest.mark.parametrize("flags", [
    ["--ledger"],
    ["--recover"],
    ["--kill-after-commits", "3"],
    ["--killrestart-smoke", "--lockstep"],
    ["--certify", "--lockstep", "--steps", "4"],
    ["--certify-smoke", "--lockstep"],
    ["--roofline", "--lockstep", "--steps", "4"],
], ids=["flags0-ledger slice", "flags1-ledger slice", "flags2-ledger slice",
        "flags3-ledger slice", "flags4-ZP-Cert", "flags5-ZP-Cert",
        "flags6-roofline slice"])
def test_cli_refuses_what_waits_for_a_later_slice(flags, tmp_path, capsys):
    """Each flag of the reference's CLI that once waited for a later
    slice now runs and reports ok; none is ignored: the ledger, ZP-Cert
    and roofline flags."""
    led = ["--ledger", str(tmp_path), "--ledger-boards", "2",
           "--ledger-windows", "6", "--device", "cpu"]
    if flags[0] == "--kill-after-commits":
        done = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.farm", *led, *flags],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=120)
        assert done.returncode == -signal.SIGKILL, done.stderr[-2000:]
        flags = ["--recover"]           # and the campaign still finishes
    elif flags[0] == "--recover":
        cli.main(led)                   # a finished campaign to recover
        capsys.readouterr()
    if flags[0] in ("--killrestart-smoke", "--certify", "--certify-smoke",
                    "--roofline"):
        cli.main(flags + ["--device", "cpu"])
    else:
        cli.main(led + [f for f in flags if f != "--ledger"])
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] and not out.get("problems")
    if flags[0] == "--certify":
        assert all(j["status"] == "done" for j in out["jobs"].values())
        assert not any(c for c in out["telemetry"]["certifications"]
                       if not c["ok"])
    elif flags[0] == "--roofline":
        # the train board's capture: its 4 steps in windows of 2, each
        # costed (the board's first window counted on fake tensors)
        roof = out["roofline"]
        assert (roof["windows"], roof["steps"]) == (2, 4)
        assert roof["hlo_flops"] > 0 and roof["device_s"] is None
        assert out["train"]["steps"] == 4
    elif flags[0] == "--certify-smoke":
        assert [r["job"] for r in out["certify_fail_records"]] == ["poison"]
        assert out["jobs"]["poison"]["status"] == "quarantined"
    elif flags[0] == "--recover":
        assert out["recover"] and out["windows_delivered"] == 12
    elif flags[0] == "--ledger":
        assert not out["recover"] and set(out["jobs"]) == {"board0",
                                                          "board1"}
        assert len(cli._read_window_files(str(tmp_path / "outputs"))) == 12


# ------------------------------------------------------------ subprocess --
def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def test_cli_runs_the_mixed_farm_in_a_subprocess():
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.farm", "--steps", "8",
         "--device", "cpu", "--lockstep"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout)
    assert out["ok"] and out["mode"] == "lockstep"


def test_cli_sigint_drains_and_exits_130_with_a_partial_report():
    """SIGINT once the farm runs (the CLI says so on stderr): every board
    is cut at its next drain boundary, the partial report is printed,
    and the process exits 130. The soak board of --synthetic-straggler
    keeps the farm busy for seconds."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.farm", "--steps", "8",
         "--device", "cpu", "--synthetic-straggler"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        seen = []
        while True:
            line = proc.stderr.readline()
            seen.append(line)
            if not line or line.startswith("farm: running"):
                break
        assert line, "".join(seen)[-2000:]
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 130, err[-2000:]
    report = json.loads(out)
    assert report["interrupted"] and not report["ok"]
    assert report["jobs"]["soak"]["status"] == "interrupted"


# -------------------------------------------------------------- registry --
def _toy_parts(n_windows=4, scale=1.0):
    return dict(
        engine=lambda s, sh, x: (s + x.sum(), sh, x * scale),
        windows=[[np.float32(w)] for w in range(int(n_windows))],
        state=torch.tensor(0.0), shell={},
        stack_fn=lambda it: torch.as_tensor(np.stack(it)),
        barriers=(DrainBarrier(every=1, action=lambda s, b: None),))


def test_registry_refuses_a_second_factory_under_one_name():
    reg = FactoryRegistry()
    reg.register("toy", _toy_parts)
    reg.register("toy", _toy_parts)             # the same function: fine
    with pytest.raises(ValueError, match="already registered"):
        reg.register("toy", lambda: {})
    reg.register("toy", lambda: {"engine": None}, override=True)
    assert reg.names() == ["toy"]
    with pytest.raises(KeyError, match="unknown job factory"):
        reg.get("missing")


def test_job_spec_round_trips_and_refuses_non_json_kwargs():
    spec = JobSpec(name="a", factory="toy", kwargs={"n_windows": 3},
                   max_requeues=2, lane_key="k")
    assert JobSpec.from_json(json.loads(json.dumps(spec.to_json()))) == spec
    with pytest.raises(ValueError, match="kwargs\\['x'\\]"):
        JobSpec(name="a", factory="toy", kwargs={"x": torch.zeros(1)})
    with pytest.raises(TypeError, match="dict"):
        JobSpec(name="a", factory="toy", kwargs=[1])


def test_submit_spec_builds_the_job_and_runs_it(tmp_path):
    """``submit_spec`` builds the job from its registered factory (the
    spec's budget, lane key and on-disk snapshot store ride on the
    spec); the job carries its spec and runs like any other."""
    reg = FactoryRegistry()
    reg.register("toy", _toy_parts)
    bad = FactoryRegistry()
    bad.register("toy", lambda **kw: {"engine": None, "surprise": 1})
    mgr = FarmManager(device="cpu", slots=2)
    spec = JobSpec(name="a", factory="toy",
                   kwargs={"n_windows": 3, "scale": 2.0}, max_requeues=3,
                   snapshot_dir=str(tmp_path / "snaps"))
    job = mgr.submit_spec(spec, registry=reg)
    assert job.spec is spec and job.max_requeues == 3
    assert job.snapshot_store is not None
    with pytest.raises(TypeError, match="surprise"):
        spec.build(bad)
    out = []
    job.on_drain = lambda p, r, y: out.append(float(y[0]))
    rep = mgr.run()
    assert rep["jobs"]["a"]["status"] == "done"
    assert out == [0.0, 2.0, 4.0]
    assert job.snapshot_store.steps()


def test_the_cli_registers_its_train_board():
    """``zp.train_board`` is registered by the CLI's module, and its spec
    builds a train board that runs on the host."""
    assert "zp.train_board" in REGISTRY.names()
    spec = cli.train_board_spec("granite-8b", 4, 2, device="cpu")
    mgr = FarmManager(device="cpu", slots=1)
    job = mgr.submit_spec(spec)
    losses = []
    job.on_drain = lambda p, r, m: losses.extend(m["loss"].tolist())
    assert mgr.run()["jobs"]["train"]["status"] == "done"
    assert len(losses) == 4 and np.isfinite(losses).all()


# --------------------------------------------------- against the reference --
@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_run_farm_matches_the_reference(mode, monkeypatch):
    """``run_farm``'s workload (granite-8b smoke, f32, 8 steps, 4 slots)
    in the port and in the reference on the same weights and verify
    activations: the train losses within LOSS_RTOL, the greedy tokens
    equal, the verify reports alike."""
    jax = pytest.importorskip("jax")
    from jax_weights import seeded_params
    from test_torch_ssm import import_reference
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models import model as tmodel
    from repro_torch.utils import tree_map

    jfarm, jmodel, jconfigs = import_reference(
        "repro.launch.farm", "repro.models.model", "repro.configs")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("granite-8b"),
                               dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("granite-8b"),
                               dtype="float32")
    jp = seeded_params(jcfg, 0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    xs = [np.asarray(jax.random.normal(jax.random.key(i),
                                       (2, 16, tcfg.d_model)), np.float32)
          for i in range(2)]
    got = {"j": {}, "t": {}}

    def capture(side, key, fn):
        def wrapped(*a, **kw):
            got[side][key] = fn(*a, **kw)
            return got[side][key]
        return wrapped

    for side, mod in (("j", jfarm), ("t", cli)):
        for name in ("submit_train_job", "submit_decode_job",
                     "submit_subsystem_jobs"):
            monkeypatch.setattr(mod, name,
                                capture(side, name, getattr(mod, name)))
    monkeypatch.setattr(jfarm, "get_smoke_config", lambda arch: jcfg)
    monkeypatch.setattr(cli, "get_smoke_config", lambda arch: tcfg)
    monkeypatch.setattr(jmodel.Model, "init", lambda self, key: jp)
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, *, device=None:
                        tree_map(torch.clone, tp))
    monkeypatch.setattr(cli, "verify_inputs",
                        lambda cfg, n, B, S, seed, device:
                        [torch.from_numpy(x.copy()) for x in xs[:n]])

    want = jfarm.run_farm("granite-8b", 8, 4, mode=mode)
    out = cli.run_farm("granite-8b", 8, 4, mode=mode, device="cpu")
    assert want["ok"] and out["ok"]
    j_loss = np.asarray(got["j"]["submit_train_job"], np.float64)
    t_loss = np.asarray(got["t"]["submit_train_job"], np.float64)
    assert len(t_loss) == len(j_loss) == 8
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(
        np.concatenate(got["t"]["submit_decode_job"], axis=1),
        np.concatenate(got["j"]["submit_decode_job"], axis=1))
    j_rep = got["j"]["submit_subsystem_jobs"]()
    t_rep = got["t"]["submit_subsystem_jobs"]()
    assert set(t_rep) == set(j_rep) == {"layer0", "layer1"}
    for k in j_rep:
        assert t_rep[k].steps == j_rep[k].steps
        assert t_rep[k].diverged == j_rep[k].diverged is False
        assert t_rep[k].max_rel_err == pytest.approx(
            j_rep[k].max_rel_err, rel=CK_RTOL, abs=CK_ATOL), k
