"""The port's train loop and checkpoints (``repro_torch.train.loop``,
``repro_torch.checkpoint``, ``repro_torch.core.profiler``) on the CPU:
each case of the reference's checkpoint and loop tests
(``tests/test_train.py``, ``tests/test_group_fused.py``) at smoke size,
the verified-snapshot workflow (a ``CommitStreamVerifier`` whose raise at a
drain vetoes the checkpoint), and checkpoints that cross between the two
packages bit for bit (the reference's on-disk layout: sorted leaf paths,
bf16 stored as its uint16 view).
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    MemorySnapshotStore,
                                    SnapshotIntegrityError, step_to_window)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (Profiler, StallStack,  # noqa: E402
                              WindowScheduler)
from repro_torch.core.coemu import CommitDivergence  # noqa: E402
from repro_torch.core.scope import ScopeSpec  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.testing import assert_trees_equal  # noqa: E402
from repro_torch.train import (LoopConfig, OptConfig,  # noqa: E402
                               init_state, make_train_step, train_loop)
from repro_torch.utils import (tree_clone, tree_leaves,  # noqa: E402
                               tree_paths_sorted)

TAPS = frozenset({"commits", "coverage"})


def _model(arch="granite-8b", taps=frozenset({"commits"})):
    return build_model(get_smoke_config(arch),
                       Runtime(attention_impl="xla", taps=taps))


def _stepped_state(arch="glm4-9b"):
    """A smoke train state after one step (moments and counts non-zero)."""
    model = _model(arch)
    state = init_state(model, 0, device="cpu")
    state, _, _ = make_train_step(model)(
        state, make_batch_fn(model.cfg, 2, 16, 0)(0))
    return state


# ------------------------------------------------------------- checkpoint ---
def test_checkpoint_roundtrip_and_integrity(tmp_path):
    state = init_state(_model("glm4-9b"), 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(state, 1, blocking=True)
    restored, step = mgr.restore(state)
    assert step == 1
    assert_trees_equal(state, restored, "restored state")

    # corruption detection
    mgr.save(state, 2, blocking=True)
    d = tmp_path / "step_00000002"
    victim = sorted(d.glob("*.npy"))[0]
    arr = np.load(victim)
    np.save(victim, arr + 1 if arr.dtype.kind in "fiu" else arr)
    with pytest.raises(IOError):
        mgr.restore(state, step=2)
    assert not mgr.verify(2) and mgr.verify(1)

    # retention
    for s in (3, 4, 5):
        mgr.save(state, s, blocking=True)
    assert mgr.steps() == [4, 5]


def test_restore_falls_back_past_a_corrupt_newest_snapshot(tmp_path):
    """The newest snapshot torn (a leaf's bytes flipped) and the one
    before it missing its manifest: ``fallback=True`` lands on the newest
    one that verifies; without it the restore raises."""
    state = _stepped_state()
    later = tree_clone(state)
    later["step"].add_(5)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(state, 4, blocking=True)
    mgr.save(later, 8)
    mgr.save(later, 12)
    mgr.wait()
    victim = sorted((tmp_path / "step_00000012").glob("*.npy"))[-1]
    raw = np.load(victim)
    raw.reshape(-1)[0] ^= 1
    np.save(victim, raw)
    (tmp_path / "step_00000008" / "manifest.json").unlink()
    with pytest.raises(SnapshotIntegrityError) as e:
        mgr.restore(state)
    assert e.value.step == 12
    restored, step = mgr.restore(state, fallback=True)
    assert step == 4
    assert_trees_equal(restored, state, "fallback restore")
    # the sharded path walks back alike: every leaf whole (spec ()) on a
    # one-rank layout is the state itself
    specs = {p: () for p, _ in tree_paths_sorted(state)}
    one_rank = types.SimpleNamespace(device=torch.device("cpu"))
    restored, step = mgr.restore(state, fallback=True, shardings=specs,
                                 mesh=one_rank)
    assert step == 4
    assert_trees_equal(restored, state, "sharded fallback restore")


def test_a_failed_background_write_is_raised(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = {"w": torch.ones(3)}
    (tmp_path / "ckpt" / "step_00000001.tmp").write_text("a file, not a dir")
    mgr.save(state, 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.save(state, 2)                   # the error was raised once
    mgr.wait()
    assert mgr.steps() == [2]


def test_memory_snapshot_store():
    state = _stepped_state()
    store = MemorySnapshotStore(keep=2)
    for s in (2, 4, 6):
        store.save(state, s)
        state["step"].add_(1)            # the caller's state moves on
    assert store.steps() == [4, 6]
    snap, step = store.restore()
    assert step == 6 and int(snap["step"]) == 3
    snap["step"].add_(100)               # restore hands out copies
    assert store.verify(6)
    # in-process corruption of the stored bytes is caught at restore
    store._snaps[6]["params"]["embed"]["tok"].view(-1)[0] += 1
    assert not store.verify(6)
    with pytest.raises(SnapshotIntegrityError):
        store.restore()
    restored, step = store.restore(like=state, fallback=True)
    assert step == 4 and int(restored["step"]) == 2
    assert restored["params"]["embed"]["tok"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        MemorySnapshotStore().restore()


@pytest.mark.parametrize("step,interval,window", [
    (0, 4, 0), (4, 4, 1), (5, 4, 2), (8, 4, 2), (7, 1, 7), (3, 0, 3)])
def test_step_to_window(step, interval, window):
    assert step_to_window(step, interval) == window


# ----------------------------------------------- profiler and scheduler ----
def test_profiler_phases_and_stall_stacks():
    prof = Profiler(sample_interval=2)
    for _ in range(3):
        with prof.phase("device"):
            pass
        with prof.phase("host"):
            sum(range(20000))
        prof.step_done()
    assert prof.steps == 3 and len(prof.samples) == 1
    stack = prof.live_stack()
    assert set(stack.seconds) == {"device", "host"}
    assert stack.dominant() == "host"
    assert abs(sum(stack.fractions().values()) - 1.0) < 1e-12
    model = Profiler.model_stack([{"compute_s": 1.0, "memory_s": 3.0},
                                  {"collective_s": 0.5}])
    assert model == StallStack({"compute": 1.0, "memory": 3.0,
                                "collective": 0.5})
    assert model.dominant() == "memory"


def test_scheduler_counts_plans_from_start_step_and_calls_on_window():
    seen = []
    sched = WindowScheduler(interval=3, overlap=False, drain_fn=None,
                            stack_fn=None)

    def engine(state, shell, items):
        return state + len(items), shell, list(items)
    state, last, _ = sched.run(
        engine, sched.windows(range(7)), 0, {}, start_step=4,
        on_drain=lambda plan, rec, ys: seen.append(("drain", plan.start,
                                                    plan.last)),
        on_window=lambda plan, state: seen.append(("window", plan.index,
                                                   state)))
    assert state == 7 and last == [6]
    assert seen == [("drain", 4, 6), ("window", 0, 3), ("drain", 7, 9),
                    ("window", 1, 6), ("drain", 10, 10), ("window", 2, 7)]


# ------------------------------------------------------------------ loop ---
def _lc(tmp_path=None, **kw):
    base = dict(steps=8, batch=2, seq=16, sample_interval=2,
                checkpoint_every=4)
    if tmp_path is not None:
        base["checkpoint_dir"] = str(tmp_path)
    return LoopConfig(**{**base, **kw})


@pytest.mark.parametrize("interval", [1, 3, 8])
def test_train_loop_engines_agree_with_tail(interval):
    """Both engines, 10 steps: bit-identical losses, state, coverage, and
    drain cadence at every interval."""
    lc = dict(steps=10, batch=2, seq=16, sample_interval=interval)
    drains_f, drains_p = [], []
    fused = train_loop(_model(taps=TAPS), LoopConfig(fused=True, **lc),
                       on_drain=lambda i, r: drains_f.append(i),
                       resume=False, device="cpu")
    plain = train_loop(_model(taps=TAPS), LoopConfig(fused=False, **lc),
                       on_drain=lambda i, r: drains_p.append(i),
                       resume=False, device="cpu")
    assert len(fused["losses"]) == 10
    assert fused["losses"] == plain["losses"]
    assert drains_f == drains_p
    assert drains_f[-1] == 9            # tail window drained exactly once
    assert_trees_equal(fused["state"], plain["state"], "loop state")
    assert fused["coverage"]["fraction"] == plain["coverage"]["fraction"]
    assert set(fused) == {"state", "losses", "coverage", "profile",
                          "stragglers", "final_step", "roofline"}
    assert set(fused["profile"]) == {"data", "device", "host"}
    # the measured-window roofline rode both engines: the same windows
    assert fused["roofline"]["windows"] == plain["roofline"]["windows"] \
        == -(-10 // interval)


def test_train_loop_checkpoint_resume(tmp_path):
    full = train_loop(_model(), _lc(tmp_path, steps=6), resume=False,
                      device="cpu")
    assert CheckpointManager(str(tmp_path)).steps() == [4]
    # simulate preemption: a fresh process resumes from step 4's checkpoint
    resumed = train_loop(_model(), _lc(tmp_path, steps=6), resume=True,
                         device="cpu")
    # the resumed run re-executes steps 4..5 on identical data, to the bit
    assert resumed["losses"] == full["losses"][4:]
    assert_trees_equal(resumed["state"], full["state"], "resumed state")


def test_train_loop_waits_for_its_slices():
    """The ZP-Scope plane has its slice (a report under "scope"; anything
    but a ScopeSpec or ScopePlane refused), and so has the roofline: its
    report under "roofline", with the plane's counters joined."""
    out = train_loop(_model(), _lc(scope=ScopeSpec()), device="cpu")
    assert out["scope"]["steps"] == len(out["losses"])
    assert out["roofline"]["steps"] == len(out["losses"])
    assert out["roofline"]["scope"]["steps"] == len(out["losses"])
    assert out["roofline"]["hlo_flops"] > 0
    with pytest.raises(TypeError, match="ScopeSpec"):
        train_loop(_model(), _lc(scope=object()), device="cpu")


# ------------------------------------------------- verified checkpoints ----
def test_commit_verifier_clean_oracle_publishes_checkpoints(tmp_path):
    model = _model()
    out = train_loop(model, _lc(tmp_path), resume=False,
                     oracle_step=make_train_step(model), device="cpu")
    assert len(out["losses"]) == 8
    assert CheckpointManager(str(tmp_path)).steps() == [4, 8]


@pytest.mark.parametrize("fused", [True, False])
def test_commit_verifier_faulted_engine_blocks_checkpoint(tmp_path, fused):
    """A diverging commit stream raises at the drain, which vetoes the
    checkpoint DrainBarrier in either engine: the save never publishes,
    and the caller's oracle state is not stepped."""
    model = _model()
    bad_state = init_state(model, 99, device="cpu")
    kept = tree_clone(bad_state)
    with pytest.raises(CommitDivergence) as e:
        train_loop(model, _lc(tmp_path, steps=4, fused=fused),
                   resume=False, oracle_step=make_train_step(model),
                   oracle_state=bad_state, device="cpu")
    assert e.value.step == 0
    assert CheckpointManager(str(tmp_path)).steps() == []   # save vetoed
    assert_trees_equal(bad_state, kept, "caller's oracle state")


def test_commit_verifier_survives_checkpoint_resume(tmp_path):
    """On resume the default oracle starts from the RESTORED state, so a
    healthy resumed run verifies clean and keeps publishing."""
    model = _model()
    oracle = make_train_step(model)
    first = train_loop(model, _lc(tmp_path, steps=4), resume=False,
                       oracle_step=oracle, device="cpu")
    assert CheckpointManager(str(tmp_path)).steps() == [4]
    out = train_loop(model, _lc(tmp_path), resume=True, oracle_step=oracle,
                     device="cpu")
    assert len(out["losses"]) == 4                  # steps 4..7 replayed
    assert CheckpointManager(str(tmp_path)).steps() == [4, 8]
    whole = train_loop(model, _lc(), resume=False, device="cpu")
    assert first["losses"] + out["losses"] == whole["losses"]


# ----------------------------------------------- across the two packages ---
@pytest.fixture(scope="module")
def ref():
    """The reference's checkpoint manager and a glm4-9b smoke train state
    (bf16 params, f32 moments) after one of its train steps."""
    jax = pytest.importorskip("jax")
    from jax_weights import seeded_params
    from repro.checkpoint import CheckpointManager as RefManager
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import build_model as jax_build
    from repro.models.runtime import Runtime as JaxRuntime
    from repro.train import step as jstep
    jcfg = jax_smoke("glm4-9b")
    jm = jax_build(jcfg, JaxRuntime())
    state = {**jstep.init_state(jm, jax.random.key(0)),
             "params": seeded_params(jcfg, 0)}
    batch = make_batch_fn(get_smoke_config("glm4-9b"), 2, 16, 0)(0)
    state, _, _ = jax.jit(jstep.make_train_step(jm, OptConfig()))(
        state, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    return {"jax": jax, "Manager": RefManager, "state": state}


def _manifest(d, step):
    return json.loads((d / f"step_{step:08d}" / "manifest.json").read_text())


def test_reference_checkpoint_restores_in_the_port_bitwise(ref, tmp_path):
    from repro_torch.interop import state_from_jax
    jax = ref["jax"]
    ref["Manager"](str(tmp_path)).save(ref["state"], 3, blocking=True)
    cfg = get_smoke_config("glm4-9b")
    like = init_state(_model("glm4-9b"), 1, device="cpu")
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 3
    want = state_from_jax(jax.tree.map(np.asarray, ref["state"]), cfg, "cpu")
    assert_trees_equal(restored, want, "reference checkpoint in the port")
    assert restored["params"]["embed"]["tok"].dtype == torch.bfloat16
    assert [tuple(t.shape) for t in tree_leaves(restored)] == \
        [tuple(t.shape) for t in tree_leaves(like)]


def test_port_checkpoint_restores_in_the_reference_bitwise(ref, tmp_path):
    """The port writes the same files as the reference (paths, dtype names,
    raw bytes, crc32s), and the reference restores them."""
    from repro_torch.interop import state_from_jax
    jax = ref["jax"]
    cfg = get_smoke_config("glm4-9b")
    state = state_from_jax(jax.tree.map(np.asarray, ref["state"]), cfg,
                           "cpu")
    CheckpointManager(str(tmp_path / "port")).save(state, 3, blocking=True)
    ref["Manager"](str(tmp_path / "ref")).save(ref["state"], 3,
                                               blocking=True)
    got, want = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "ref",
                                                          3)
    strip = [{k: v for k, v in leaf.items() if k != "sharding"}
             for leaf in want["leaves"]]
    assert [{k: v for k, v in leaf.items() if k != "sharding"}
            for leaf in got["leaves"]] == strip
    restored, step = ref["Manager"](str(tmp_path / "port")).restore(
        ref["state"])
    assert step == 3
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref["state"])):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_memory_store_digest_matches_the_reference(ref):
    from repro.checkpoint import manager as rmanager
    from repro_torch.checkpoint import manager as tmanager
    from repro_torch.interop import state_from_jax
    from repro_torch.utils import tree_paths_sorted
    jax = ref["jax"]
    state = state_from_jax(jax.tree.map(np.asarray, ref["state"]),
                           get_smoke_config("glm4-9b"), "cpu")
    assert tmanager._tree_digest([t for _, t in tree_paths_sorted(state)]) \
        == rmanager._tree_digest(jax.tree.leaves(ref["state"]))
    assert tmanager._leaf_paths(state) == rmanager._leaf_paths(ref["state"])
