"""ZP-Cert in the port's farm on the CPU (``FarmManager(certify=True)``,
the CLI's ``run_certify_smoke``): every case of the reference's
``tests/test_certify_farm.py`` that is about certification — the admission
gate dead-letters an uncertifiable board with a durable ``certify_fail``
record while co-submitted healthy jobs finish bit-identical to an
uncertified run, in both host loops; certification is off by default;
the smoke gate; every shipped smoke arch and factory certifies clean and
trace-only — and, at smoke size, the card's phase 56 cell: subsystem
boards, the decode board and the poison board behind the gate.

Every farm passes ``device="cpu"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.farm import FarmJob, FarmManager, JobSpec  # noqa: E402


def _farm(**kw):
    return FarmManager(device="cpu", **kw)


def _stack(items):
    return torch.as_tensor(np.stack(items))


# ------------------------------------------------------- admission gate --
def _poison_job():
    def engine(state, shell, stack):
        host = state.item()         # a host round-trip every window
        return state + host, shell, stack * 2.0

    return FarmJob(name="poison", engine=engine,
                   windows=[[np.float32(i)] for i in range(4)],
                   state=torch.tensor(0.0), shell={}, stack_fn=_stack)


def _healthy_job(name="healthy", n=6):
    def engine(state, shell, stack):
        return state + stack.sum(), shell, stack * 2.0

    outs = []
    job = FarmJob(name=name, engine=engine,
                  windows=[[np.float32(i)] for i in range(n)],
                  state=torch.tensor(0.0), shell={}, stack_fn=_stack,
                  on_drain=lambda p, r, y: outs.append(y.clone()))
    return job, outs


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_certify_gate_dead_letters_poison_board(mode):
    mgr = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01,
                certify=True)
    job, outs = _healthy_job()
    mgr.submit(job)
    poison = mgr.submit(_poison_job())
    # dead-lettered AT SUBMIT: quarantined, never queued, rule named
    assert poison.status == "quarantined"
    assert "ZC101" in poison.error
    assert all(j.name != "poison" for j in mgr.queue)

    report = mgr.run(strict=False)
    assert report["jobs"]["healthy"]["status"] == "done"
    assert report["jobs"]["poison"]["status"] == "quarantined"
    assert report["jobs"]["poison"]["windows"] == 0
    certs = report["telemetry"]["certifications"]
    assert any(c["job"] == "poison" and not c["ok"]
               and "ZC101" in c["rules"] for c in certs)
    assert any(q["job"] == "poison"
               for q in report["telemetry"]["quarantined"])
    assert "1 certify-failed of 1 flagged" in mgr.telemetry.summary()

    # the healthy board's stream is bit-identical to an uncertified run
    oracle = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01)
    ojob, oouts = _healthy_job()
    oracle.submit(ojob)
    oracle.run(strict=False)
    assert len(outs) == len(oouts) > 0
    for a, b in zip(outs, oouts):
        assert torch.equal(a, b)


def test_certify_gate_journals_certify_fail(tmp_path):
    from repro_torch.farm import FarmLedger
    ledger = FarmLedger(str(tmp_path))
    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False,
                ledger=ledger, certify=True)
    mgr.submit(_poison_job())
    recs = [r for r in ledger.records() if r["kind"] == "certify_fail"]
    assert len(recs) == 1
    assert recs[0]["job"] == "poison" and recs[0]["rules"] == ["ZC101"]
    # no submit record: the job never entered the durable queue
    assert not any(r["kind"] == "submit" and r["job"] == "poison"
                   for r in ledger.records())
    # replaying the journal shows the job terminally quarantined
    assert ledger.replay().jobs["poison"].status == "quarantined"
    ledger.close()


def test_certify_off_by_default():
    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False)
    poison = mgr.submit(_poison_job())
    assert poison.status == "queued"    # uncertified farms behave as before


def test_certifier_crash_is_zc100_and_intake_goes_on():
    """A board whose first window cannot even be stacked crashes the
    certifier: that is ZC100, the board is dead-lettered, and the next
    submit is admitted as usual."""
    def bad_stack(items):
        raise RuntimeError("no stack")

    mgr = _farm(slots=2, mode="lockstep", evict_stragglers=False,
                certify=True)
    job, _ = _healthy_job("broken")
    job.stack_fn = bad_stack
    mgr.submit(job)
    assert job.status == "quarantined" and "ZC100" in job.error
    ok, outs = _healthy_job()
    mgr.submit(ok)
    rep = mgr.run(strict=False)
    assert rep["jobs"]["healthy"]["status"] == "done" and len(outs) == 6


def test_warnings_are_reported_and_do_not_gate():
    def engine(state, shell, stack):
        return state + torch.randn(()), shell, stack   # global generator

    mgr = _farm(slots=1, mode="lockstep", evict_stragglers=False,
                certify=True)
    job = mgr.submit(FarmJob(name="noisy", engine=engine,
                             windows=[[np.float32(0)]],
                             state=torch.tensor(0.0), shell={},
                             stack_fn=_stack))
    assert job.status == "queued"
    rep = mgr.run(strict=False)
    assert rep["jobs"]["noisy"]["status"] == "done"
    (cert,) = rep["telemetry"]["certifications"]
    assert cert["ok"] and cert["rules"] == ["ZC106"]


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_certify_smoke_gate(tmp_path, mode):
    from repro_torch.launch.farm import run_certify_smoke
    out = run_certify_smoke(work_dir=str(tmp_path), mode=mode,
                            n_boards=2, n_windows=4, device="cpu")
    assert out["ok"], out["problems"]
    assert [r["job"] for r in out["certify_fail_records"]] == ["poison"]
    assert out["windows_delivered"] == 8


def test_prewarm_skips_a_dead_lettered_board():
    from repro_torch.launch.farm import prewarm
    ran = []
    poison = _poison_job()
    real = poison.engine
    poison.engine = lambda *a: (ran.append(1), real(*a))[1]
    mgr = _farm(slots=1, mode="lockstep", certify=True)
    mgr.submit(poison)
    ran.clear()                         # the certifier's trace called it
    prewarm(mgr)
    assert ran == []


# ------------------------------------------- shipped boards stay clean --
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_smoke_arch_certifies_clean(arch):
    import repro_torch.launch.farm  # noqa: F401 — registers the factories
    from repro_torch.analysis import certify_spec, no_dispatch_guard
    with no_dispatch_guard():
        r = certify_spec(JobSpec(
            name=f"cert:{arch}", factory="zp.train_board",
            kwargs={"arch": arch, "steps": 2, "interval": 2,
                    "device": "cpu"}))
    assert r.errors == [], r.summary()


def test_shipped_factories_certify_clean_trace_only():
    import repro_torch.launch.farm  # noqa: F401
    from repro_torch.analysis import certify_job, no_dispatch_guard
    from repro_torch.farm.registry import REGISTRY
    job = JobSpec(name="cert:ledger", factory="zp.ledger_board",
                  kwargs={"n_windows": 4}).build(REGISTRY)
    with no_dispatch_guard():       # the ENGINE certification is trace-only
        assert certify_job(job).ok


# ------------------------------------ the card's phase 56 at smoke size --
def _phase56_farm(mode, certify):
    """glm4-9b's smoke config: its layers as subsystem boards, the CLI's
    decode board and (certified only) the CLI's poison board, on one
    farm. Returns (report, tokens, checksums by board, poison runs)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.coemu import submit_subsystem_jobs
    from repro_torch.kernels import is_traced
    from repro_torch.launch.farm import (_poison_board, prewarm,
                                         submit_decode_job)
    from repro_torch.models import Runtime, build_model

    cfg = get_smoke_config("glm4-9b")
    params = build_model(cfg).init(0, device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 16, cfg.d_model, generator=g).to(torch.bfloat16)
          for _ in range(4)]
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    mgr = _farm(slots=2, mode=mode, evict_stragglers=False, poll_s=0.01,
                certify=certify)
    toks = submit_decode_job(mgr, cfg, gen=9, interval=4, batch=2,
                             prompt_len=8, seed=0, device="cpu",
                             params=params)
    with torch.inference_mode():
        finalize = submit_subsystem_jobs(
            mgr, params, cfg, Runtime(), xs, pos.contiguous(),
            list(range(cfg.num_layers)), group_size=2)
    ran = []
    if certify:
        poison = _poison_board()
        real = poison.engine

        def engine(state, shell, stack):
            if not is_traced(state):
                ran.append(1)
            return real(state, shell, stack)
        poison.engine = engine
        mgr.submit(poison)
    prewarm(mgr)
    rep = mgr.run(strict=False)
    assert not any(r.diverged for r in finalize().values())
    cks = {n: torch.cat([y for _, _, y in outs])
           for n, outs in mgr.outputs.items() if n.startswith("layer")}
    return rep, np.concatenate(toks, axis=1), cks, ran


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_certified_farm_of_boards_decode_and_poison(mode):
    rep, toks, cks, ran = _phase56_farm(mode, certify=True)
    assert ran == [], "the poison board's engine ran"
    assert rep["jobs"].pop("poison")["status"] == "quarantined"
    assert all(j["status"] == "done" for j in rep["jobs"].values())
    assert [c["job"] for c in rep["telemetry"]["certifications"]
            if not c["ok"]] == ["poison"]
    orep, otoks, ocks, _ = _phase56_farm(mode, certify=False)
    np.testing.assert_array_equal(toks, otoks)
    assert set(cks) == set(ocks) and all(torch.equal(cks[n], ocks[n])
                                         for n in cks)
