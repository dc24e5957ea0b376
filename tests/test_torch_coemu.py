"""The port's co-emulation layer (``repro_torch.core.coemu``) on the CPU:
each case of the reference's co-emulation tests (``tests/test_core.py``
and ``tests/test_group_fused.py``) at smoke size, the port's own contract
that the caller's states are never stepped, the verified-snapshot
``CommitStreamVerifier``, and the port held against the JAX package.

Against the reference (weights from ``jax_weights``, the train state
carried across with ``interop.state_from_jax``, the same batches, f32):
  * each step's ``layer_checksums`` of the train step within STREAM_RTOL
    of the reference's, relative to each checksum's |x| mean (the two
    frameworks sum in another order);
  * a fault the reference injects and carries across is localized by both
    packages' ``verify`` to the same (step, layer);
  * ``inject_fault`` of the port equal to the reference's to the bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (CoEmulator, PShell,  # noqa: E402
                              default_shell_config, make_ingest)
from repro_torch.core.commit import layer_checksums  # noqa: E402
from repro_torch.core.coemu import (CommitDivergence,  # noqa: E402
                                    CommitStreamVerifier, inject_fault)
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.testing import assert_trees_equal  # noqa: E402
from repro_torch.train import (init_state, make_group_step,  # noqa: E402
                               make_train_step)
from repro_torch.utils import tree_clone, tree_leaves  # noqa: E402

COMMITS = frozenset({"commits"})
STREAM_RTOL = 1e-4


def _step(arch, dtype=None):
    cfg = get_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg, Runtime(attention_impl="xla", taps=COMMITS))
    return cfg, model, make_train_step(model, with_aux=True)


def _batches(cfg, n, seed=0):
    fn = make_batch_fn(cfg, 2, 16, seed)
    return [fn(i) for i in range(n)]


# ------------------------------------------------------------ co-emulation --
def test_coemu_pass_and_determinism():
    cfg, model, step = _step("granite-8b")
    state = init_state(model, 1, device="cpu")
    emu = CoEmulator(step, step, rtol=1e-6)
    rep = emu.verify(state, state, _batches(cfg, 1, seed=7))
    assert not rep.diverged, rep.summary()
    assert rep.max_rel_err == 0.0 and rep.steps == 1
    assert CoEmulator.determinism(step, state, _batches(cfg, 1, seed=7)[0])


@pytest.mark.parametrize("fault_layer", [0, 1])
def test_coemu_localizes_injected_fault(fault_layer):
    """Mutation test: a fault injected at layer k must be reported with
    first-divergence layer == k (the Dromajo-style debugging contract)."""
    cfg, model, step = _step("glm4-9b")
    good = init_state(model, 1, device="cpu")
    bad = {**good, "params": inject_fault(good["params"], cfg, fault_layer)}
    rep = CoEmulator(step, step, rtol=5e-2).verify(bad, good,
                                                   _batches(cfg, 1, seed=9))
    assert rep.diverged
    assert rep.first.layer == fault_layer, rep.summary()
    assert rep.summary().startswith("FAIL: first divergence at step 0 "
                                    f"layer {fault_layer}")


@pytest.mark.parametrize("fault_layer", [0, 1])
def test_coemu_group_locked_localizes_fault(fault_layer):
    """Group-locked verify (one dispatch per window per side) localizes an
    injected fault to the exact (step, layer) — identical to step-locked."""
    cfg, model, step = _step("glm4-9b")
    state = init_state(model, 1, device="cpu")
    bad = {**state, "params": inject_fault(state["params"], cfg,
                                           fault_layer)}
    batches = _batches(cfg, 4)
    emu = CoEmulator(step, step, rtol=5e-2)
    rep_s = emu.verify(bad, state, batches)
    rep_g = emu.verify(bad, state, batches, group_size=4)
    assert rep_s.diverged and rep_g.diverged
    assert (rep_g.first.step, rep_g.first.layer) == \
        (rep_s.first.step, rep_s.first.layer) == (0, fault_layer)
    assert rep_g.steps == rep_s.steps == 4


def test_coemu_group_locked_matches_step_locked_clean():
    cfg, model, step = _step("granite-8b")
    state = init_state(model, 2, device="cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg, 4)]
    emu = CoEmulator(step, step, rtol=1e-6)
    rep_s = emu.verify(state, state, batches)
    rep_g = emu.verify(state, state, batches, group_size=2)
    assert not rep_s.diverged and not rep_g.diverged
    assert rep_g.steps == 4


def test_inject_fault_raises_without_stacked_leaf():
    cfg = get_smoke_config("granite-8b")
    params = {"stack": {"blocks": ({"w": torch.ones((4, 4))},)}}
    with pytest.raises(ValueError, match="ndim >= 3"):
        inject_fault(params, cfg, 0)
    # a layer past the stacked periods (the reference's update would be
    # dropped silently out of bounds)
    params = build_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="not in the stacked periods"):
        inject_fault(params, cfg, cfg.num_layers)


@pytest.mark.parametrize("interval", [3, 8])
def test_scheduler_coemu_equivalence_with_tail(interval):
    """verify(group_size=N) (fused windows, overlapped fetch) vs the
    step-locked loop over 10 steps: identical CoEmuReport fields on a
    clean run, and the serial (overlap=False) baseline agrees too."""
    cfg, model, step = _step("granite-8b")
    state = init_state(model, 2, device="cpu")
    batches = _batches(cfg, 10)
    emu = CoEmulator(step, step, rtol=1e-6)
    rep_s = emu.verify(state, state, batches)
    rep_g = emu.verify(state, state, batches, group_size=interval)
    rep_ser = emu.verify(state, state, batches, group_size=interval,
                         overlap=False)
    for rep in (rep_s, rep_g, rep_ser):
        assert rep.steps == 10
        assert not rep.diverged and rep.first is None
    assert rep_g == rep_s == rep_ser


def test_coemu_group_cache_never_aliases_distinct_fns():
    def make_step(tag):
        def step(state, batch):
            return state, {"loss": torch.tensor(tag)}, {"scanned": (),
                                                        "tail": ()}
        return step

    s1 = make_step(1.0)
    s2 = make_step(2.0)
    emu = CoEmulator(s1, s2)
    g1 = emu._cached_group(s1)
    assert emu._cached_group(s1) is g1
    del s1
    g2 = emu._cached_group(s2)
    assert g2 is not g1
    assert len(emu._group_fns) == 2


# ------------------------------------------- the caller's states stay put --
@pytest.mark.parametrize("group_size", [1, 2])
def test_verify_leaves_the_callers_states_unchanged(group_size):
    """The train step updates its state in place; ``verify(state,
    state)`` steps two working copies of its own, and a second verify
    refills the same copies."""
    cfg, model, step = _step("granite-8b")
    state = init_state(model, 3, device="cpu")
    before = tree_clone(state)
    batches = _batches(cfg, 4)
    emu = CoEmulator(step, step, rtol=1e-6)
    first = emu.verify(state, state, batches, group_size=group_size)
    assert_trees_equal(state, before, "caller's state after verify")
    dut, orc = emu._work["dut"], emu._work["orc"]
    assert int(dut["step"]) == int(orc["step"]) == 4
    assert not {t.data_ptr() for t in tree_leaves(dut)} & \
        {t.data_ptr() for t in tree_leaves(orc)}
    again = emu.verify(state, state, batches, group_size=group_size)
    assert emu._work["dut"] is dut and emu._work["orc"] is orc
    assert again == first and not first.diverged
    assert_trees_equal(state, before, "caller's state after two verifies")


def test_determinism_leaves_the_callers_state_unchanged():
    cfg, model, step = _step("glm4-9b")
    state = init_state(model, 4, device="cpu")
    before = tree_clone(state)
    assert CoEmulator.determinism(step, state, _batches(cfg, 1)[0])
    assert_trees_equal(state, before, "caller's state after determinism")

    def noisy(state, batch):
        return state, {"loss": torch.rand(())}, {}
    assert not CoEmulator.determinism(noisy, state, None)


# ---------------------------------------------- the commit-stream verifier --
def _drained(cfg, model, state, batches, interval=2):
    """The DUT's drained commit records, one per window."""
    ingest = make_ingest(cfg)
    shell = PShell(default_shell_config(cfg, interval), ingest)
    recs = []
    shell.run_grouped(make_group_step(model, ingest=ingest),
                      tree_clone(state), batches,
                      on_drain=lambda i, r: recs.append((i, r)))
    return recs


@pytest.fixture(scope="module")
def verifier_setup():
    cfg, model, step = _step("granite-8b")
    state = init_state(model, 5, device="cpu")
    batches = _batches(cfg, 6)
    return cfg, model, step, state, batches, _drained(cfg, model, state,
                                                      batches)


def test_commit_verifier_accepts_a_clean_stream(verifier_setup):
    cfg, model, step, state, batches, recs = verifier_setup
    ver = CommitStreamVerifier(step, tree_clone(state), batches,
                               layers=cfg.num_layers)
    for last, rec in recs:
        ver(last, rec)
    assert ver.step == 6 and int(ver.state["step"]) == 6


@pytest.mark.parametrize("fault_layer", [0, 1])
def test_commit_verifier_raises_at_the_faulted_layer(verifier_setup,
                                                     fault_layer):
    cfg, model, step, state, batches, recs = verifier_setup
    bad = {**tree_clone(state),
           "params": inject_fault(state["params"], cfg, fault_layer)}
    ver = CommitStreamVerifier(step, bad, batches, layers=cfg.num_layers,
                               start_step=10, lane=3)
    with pytest.raises(CommitDivergence) as e:
        ver(*recs[0])
    assert (e.value.step, e.value.layer, e.value.lane) == \
        (10, fault_layer, 3)
    assert "checkpoint vetoed" in str(e.value)


def test_commit_verifier_snapshot_and_restore_rewind(verifier_setup):
    """A snapshot after window 0, restored (twice, and into a fresh
    verifier), re-verifies window 1 from the snapshot's oracle state and
    stream position; the snapshot itself stays as it was."""
    cfg, model, step, state, batches, recs = verifier_setup
    ver = CommitStreamVerifier(step, tree_clone(state), batches,
                               layers=cfg.num_layers)
    ver(*recs[0])
    snap = ver.snapshot()
    kept = tree_clone(snap["state"])
    ver(*recs[1])
    after = tree_clone(ver.state)
    for v in (ver, ver,
              CommitStreamVerifier(step, tree_clone(state),
                                   lambda: iter(batches),
                                   layers=cfg.num_layers)):
        v.restore(snap)
        assert v.step == 2
        v(*recs[1])
        assert v.step == 4
        assert_trees_equal(v.state, after, "state after the rewound window")
    assert_trees_equal(snap["state"], kept, "snapshot after restores")


def test_commit_verifier_refuses_to_rewind_a_one_shot_iterator(
        verifier_setup):
    cfg, model, step, state, batches, recs = verifier_setup
    ver = CommitStreamVerifier(step, tree_clone(state), iter(batches),
                               layers=cfg.num_layers)
    ver(*recs[0])
    with pytest.raises(ValueError, match="re-iterable"):
        ver.restore(ver.snapshot())


def test_commit_verifier_digest_path_waits_for_scope(verifier_setup):
    """The digest first pass (ZP-Scope's slice): a drained digest that
    misses the expected one falls through to the row compare; one that
    matches skips it and the oracle still steps."""
    cfg, model, step, state, batches, recs = verifier_setup
    ver = CommitStreamVerifier(step, tree_clone(state), batches,
                               layers=cfg.num_layers,
                               expected_digests={0: 1, 1: 7})
    ver(recs[0][0], recs[0][1], digest=7, window=0)
    assert ver.digest_hits == 0 and ver.step == 2
    tampered = {**recs[1][1], "fifos": {"commits": {
        **recs[1][1]["fifos"]["commits"],
        "data": recs[1][1]["fifos"]["commits"]["data"] + 99.0}}}
    ver(recs[1][0], tampered, digest=7, window=1)
    assert ver.digest_hits == 1 and ver.step == 4
    assert int(ver.state["step"]) == 4


# ----------------------------------------------- against the reference ----
@pytest.fixture(scope="module")
def ref():
    """The reference's co-emulator, its jitted f32 glm4-9b smoke train
    step and state (weights from ``jax_weights``), and the port's step and
    the carried state."""
    jax = pytest.importorskip("jax")
    from test_torch_ssm import import_reference
    from jax_weights import seeded_params
    from repro_torch.interop import state_from_jax
    coemu, rstep, rcfgs, rmodels, rrt = import_reference(
        "repro.core.coemu", "repro.train.step", "repro.configs",
        "repro.models", "repro.models.runtime")
    jcfg = dataclasses.replace(rcfgs.get_smoke_config("glm4-9b"),
                               dtype="float32")
    jm = rmodels.build_model(jcfg, rrt.Runtime(taps=COMMITS))
    jstate = {**rstep.init_state(jm, jax.random.key(0)),
              "params": seeded_params(jcfg, 0)}
    cfg, model, step = _step("glm4-9b", "float32")
    return {"coemu": coemu, "jcfg": jcfg, "jstate": jstate,
            "jstep": jax.jit(rstep.make_train_step(jm, with_aux=True)),
            "cfg": cfg, "step": step, "jax": jax,
            "carry": lambda s: state_from_jax(jax.tree.map(np.asarray, s),
                                              cfg, "cpu")}


def test_layer_checksum_stream_follows_the_reference(ref):
    """Three train steps from the same state on the same batches: every
    step's (L, 2) checksums within STREAM_RTOL of the reference's."""
    jnp = ref["jax"].numpy
    jstate, state = ref["jstate"], ref["carry"](ref["jstate"])
    for i, batch in enumerate(_batches(ref["cfg"], 3)):
        jstate, jm, jaux = ref["jstep"](
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m, aux = ref["step"](state, batch)
        want = np.asarray(ref["coemu"].layer_checksums(jaux), np.float64)
        got = layer_checksums(aux).double().numpy()
        scale = np.abs(want[:, 1:2]) + 1e-6
        err = float((np.abs(got - want) / scale).max())
        assert err <= STREAM_RTOL, (i, err)
        assert abs(float(m["loss"]) - float(jm["loss"])) \
            <= STREAM_RTOL * abs(float(jm["loss"]))


@pytest.mark.parametrize("fault_layer,group_size", [(0, 1), (1, 1),
                                                    (1, 2)])
def test_verify_names_the_same_fault_as_the_reference(ref, fault_layer,
                                                      group_size):
    """The reference injects the fault; both states cross to the port;
    each package's verify(bad, good) names the same (step, layer)."""
    jstate = ref["jstate"]
    jbad = {**jstate, "params": ref["coemu"].inject_fault(
        jstate["params"], ref["jcfg"], fault_layer)}
    batches = _batches(ref["cfg"], 4)
    jnp = ref["jax"].numpy
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    want = ref["coemu"].CoEmulator(ref["jstep"], ref["jstep"]).verify(
        jbad, jstate, jb, group_size=group_size)
    got = CoEmulator(ref["step"], ref["step"]).verify(
        ref["carry"](jbad), ref["carry"](jstate), batches,
        group_size=group_size)
    assert want.diverged and got.diverged
    assert (got.first.step, got.first.layer) == \
        (want.first.step, want.first.layer) == (0, fault_layer)
    assert got.steps == want.steps == 4


@pytest.mark.parametrize("arch,layer", [
    ("glm4-9b", 0), ("glm4-9b", 1), ("falcon-mamba-7b", 1),
    ("recurrentgemma-2b", 0), ("recurrentgemma-2b", 2),
    ("qwen3-moe-30b-a3b", 1)])
def test_inject_fault_equals_the_reference_bitwise(ref, arch, layer):
    """The same leaf (sorted-key order: ``attn/k/w`` of a dense block, not
    the insertion-order ``attn/q/w``), scaled the same way, in the
    config's own dtype."""
    from jax_weights import seeded_params
    from repro_torch.interop import params_from_jax, params_to_numpy
    from test_torch_ssm import import_reference
    rcfgs, = import_reference("repro.configs")
    jcfg = rcfgs.get_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jparams = seeded_params(jcfg, 0)
    jax = ref["jax"]
    want = jax.tree.map(np.asarray, ref["coemu"].inject_fault(
        jparams, jcfg, layer))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got = inject_fault(params, cfg, layer)
    got_np = params_to_numpy(got)
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = jax.tree_util.tree_leaves(got_np)
    assert len(flat_w) == len(flat_g)
    changed = 0
    for w, g, p in zip(flat_w, flat_g, jax.tree_util.tree_leaves(
            params_to_numpy(params))):
        np.testing.assert_array_equal(np.asarray(w, np.float32), g)
        changed += not np.array_equal(g, p)
    assert changed == 1
