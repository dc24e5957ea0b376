"""The port's ZP-Scope plane (``repro_torch.core.scope``) against the JAX
package's ``repro.core.scope`` on the CPU, from the same seeded numpy
inputs.

Limits: the digest folds (host twin, device fold) equal the reference's
to the bit on f32, bf16 and int32 leaves, including -0.0, +-inf and NaN;
gates, counters, digests and trace ids and nonfinite flags exact; the
trace's mean and max |x| within 1e-6 relative (reductions in another
order). With the plane on, fused or unfused, overlapped or serial, the
scheduler's state, ys and shell equal an un-instrumented pass to the bit.
The reference is imported through ``test_torch_ssm.import_reference``
(the ``jax.core`` alias shim ``repro.core`` needs on newer jax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16 as np_bf16  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import CoverageMap, WindowScheduler  # noqa: E402
from repro_torch.core import scope as tscope  # noqa: E402
from repro_torch.core.coemu import (CommitDivergence,  # noqa: E402
                                    CommitStreamVerifier)
from repro_torch.core.scope import (GATE_NAMES, ScopePlane,  # noqa: E402
                                    ScopeSpec, as_plane, digest_tree,
                                    fold_dev, fold_host, is_scoped,
                                    scope_init)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.data import make_batch_fn  # noqa: E402
from repro_torch.testing import (assert_trees_equal,  # noqa: E402
                                 check_scope_digests, serve_window_digests,
                                 train_window_digests)
from repro_torch.train import (LoopConfig, OptConfig,  # noqa: E402
                               init_state, make_train_step, train_loop)
from test_torch_ssm import import_reference  # noqa: E402

GROUP = 2
TRACE_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    schedule, scope, coemu, coverage = import_reference(
        "repro.core.schedule", "repro.core.scope", "repro.core.coemu",
        "repro.core.coverage")
    return schedule, scope, coemu, coverage


# ------------------------------------------------------------- digesting --
def _special_f32(seed, n=257):
    """Seeded f32 values with -0.0, +0.0, +-inf and NaNs of either sign
    among them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)).astype(
        np.float32)
    x[:7] = [-0.0, 0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45]
    return rng.permutation(x)


def _leaves(seed):
    """(name, numpy value, torch value) for an f32, a bf16 and an int32
    leaf of awkward shapes."""
    f = _special_f32(seed).reshape(257, 1)
    b = _special_f32(seed + 1, 96).astype(np_bf16).reshape(4, 24)
    rng = np.random.default_rng(seed + 2)
    i = rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 5, 7), dtype=np.int32)
    return [("f32", f, torch.from_numpy(f.copy())),
            ("bf16", b, torch.from_numpy(b.view(np.int16).copy()).view(
                torch.bfloat16)),
            ("int32", i, torch.from_numpy(i.copy()))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_folds_match_the_reference_bitwise(ref, seed):
    """The port's host twin and device fold and the reference's host twin
    and jitted device fold agree on every leaf, specials included."""
    _, jscope, _, _ = ref
    for name, npv, tv in _leaves(seed):
        want = jscope.fold_host(npv)
        assert int(jax.jit(lambda a: jscope._fold_dev(a, 1))(
            jnp.asarray(npv))) == want, name
        assert fold_host(npv) == want, name
        assert fold_host(tv) == want, name
        assert int(fold_dev(tv)) == want, name


def test_device_fold_is_exact_across_chunks(monkeypatch):
    """Chunked int64 sums equal one numpy uint32 fold: small chunks, and
    position weights far past 2**32 (the 16-bit split keeps every product
    below 2**48)."""
    x = _special_f32(5, 1001)
    want = fold_host(x)
    for chunk in (1, 7, 64, 1000, 1 << 22):
        monkeypatch.setattr(tscope, "_CHUNK", chunk)
        assert int(fold_dev(torch.from_numpy(x))) == want, chunk
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    got = tscope._mul32(torch.from_numpy(a.astype(np.int64)),
                        torch.from_numpy((b & 0xFFFF).astype(np.int64)),
                        torch.from_numpy((b >> 16).astype(np.int64)))
    want = [(int(p) * int(q)) % 2 ** 32 for p, q in zip(a, b)]
    assert got.tolist() == want


def test_lane_folds_match_the_reference(ref):
    _, jscope, _, _ = ref
    x = _special_f32(3, 3 * 40).reshape(3, 8, 5)
    want = np.asarray(jax.jit(lambda a: jscope._fold_dev(a, 3))(
        jnp.asarray(x))).tolist()
    assert fold_dev(torch.from_numpy(x), 3).tolist() == want


def test_digest_tree_walks_sorted_keys_like_the_reference(ref):
    """A dict whose insertion order differs from its sorted order: the
    port's digest of the tensors equals the reference's of the arrays."""
    _, jscope, _, _ = ref
    (_, f, tf), (_, b, tb), (_, i, ti) = _leaves(7)
    np_tree = {"zeta": f, "alpha": {"y": b, "b": i}, "mid": (i, f)}
    t_tree = {"zeta": tf, "alpha": {"y": tb, "b": ti}, "mid": (ti, tf)}
    want = jscope.digest_tree({k: v for k, v in np_tree.items()})
    assert digest_tree(t_tree) == want
    assert digest_tree(np_tree) == want
    swapped = {"zeta": t_tree["zeta"], "alpha": t_tree["alpha"],
               "mid": (tf, ti)}
    assert digest_tree(swapped) != want       # the combine is ordered


def test_lane_update_matches_the_reference(ref):
    """One counter update over a lane-batched window (3 lanes, 4 steps)
    equals the reference's jitted update, tree for tree."""
    _, jscope, _, _ = ref
    spec = ScopeSpec(every_n_windows=2, ring_slots=3)
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 4, 5)).astype(np.float32)
    a[1, 2, 3] = np.nan
    b = rng.integers(-3, 4, (3, 4, 2)).astype(np.int32)
    ys_np = {"b": b, "a": a}
    jsc = jscope._jit_update(spec, 3)(jscope.scope_init(spec, 3),
                                      {k: jnp.asarray(v)
                                       for k, v in ys_np.items()})
    tsc = tscope.make_update(spec, 3)(
        scope_init(spec, 3), {k: torch.from_numpy(v)
                              for k, v in ys_np.items()})
    for k in jsc:
        want = np.asarray(jsc[k])
        got = tsc[k].numpy()
        if k == "trace":
            np.testing.assert_allclose(got, want, rtol=TRACE_RTOL)
        else:
            assert got.tolist() == want.astype(np.int64 if k in (
                "digest", "win_digests") else want.dtype).tolist(), k


# ------------------------------------------------------ the toy scheduler --
@jax.jit
def _jengine(state, shell, stack):
    def body(x, idx):
        x = x + idx.astype(jnp.float32)
        return x, jnp.stack([x, -x])
    x, ys = jax.lax.scan(body, state, stack)
    return x, shell, ys


def _tengine(state, shell, stack):
    x, ys = state, []
    for idx in stack:
        x = x + idx.to(torch.float32)
        ys.append(torch.stack([x, -x]))
    return x, shell, torch.stack(ys)


def _jrun(ref, scope, overlap, n_steps=12, collect=None):
    jsched, _, _, _ = ref
    sched = jsched.WindowScheduler(interval=GROUP, overlap=overlap,
                                   drain_fn=None, reset=None)
    on_drain = None
    if collect is not None:
        on_drain = lambda plan, records, ys: collect.append(  # noqa: E731
            (plan.index, np.asarray(ys)))
    return sched.run(_jengine,
                     sched.windows(jnp.arange(n_steps, dtype=jnp.int32)),
                     jnp.float32(1.0), {}, scope=scope, on_drain=on_drain)


def _trun(scope, overlap, n_steps=12, collect=None):
    sched = WindowScheduler(interval=GROUP, overlap=overlap, drain_fn=None,
                            reset=None)
    on_drain = None
    if collect is not None:
        on_drain = lambda plan, records, ys: collect.append(  # noqa: E731
            (plan.index, ys.numpy().copy()))
    return sched.run(_tengine,
                     sched.windows(torch.arange(n_steps,
                                                dtype=torch.int32)),
                     torch.tensor(1.0), {}, scope=scope, on_drain=on_drain)


def _assert_reports_equal(got, want):
    """The port's report against the reference's: everything exact but
    the trace's mean and max |x| (TRACE_RTOL)."""
    assert set(got) == set(want)
    for k in want:
        if k != "history":
            assert got[k] == want[k], k
    assert len(got["history"]) == len(want["history"])
    for sg, sw in zip(got["history"], want["history"]):
        assert set(sg) == set(sw)
        for k in sw:
            if k != "trace":
                assert sg[k] == sw[k], k
        if "trace" not in sw:
            continue
        tg, tw = np.asarray(sg["trace"]), np.asarray(sw["trace"])
        assert tg.shape == tw.shape
        if tw.size:
            assert tg[:, 0].tolist() == tw[:, 0].tolist()
            assert tg[:, 3].tolist() == tw[:, 3].tolist()
            np.testing.assert_allclose(tg[:, 1:3], tw[:, 1:3],
                                       rtol=TRACE_RTOL)


SPECS = [ScopeSpec(every_n_windows=2), ScopeSpec(every_n_windows=4),
         ScopeSpec(every_n_windows=8, ring_slots=4),
         ScopeSpec(every_n_windows=2, fuse=True),
         ScopeSpec(every_n_windows=3, digest=False, gates=False,
                   ring_slots=0)]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_scheduler_report_matches_the_reference(ref, spec, overlap):
    """``report()`` of a scoped scheduler pass equals the reference's, and
    state, last ys, drained ys and shell equal the unscoped pass's to the
    bit."""
    _, jscope, _, _ = ref
    jplane = jscope.ScopePlane(jscope.ScopeSpec(**spec.__dict__))
    _jrun(ref, jplane, overlap)
    off, on = [], []
    s_off, ys_off, sh_off = _trun(None, overlap, collect=off)
    plane = ScopePlane(spec)
    s_on, ys_on, sh_on = _trun(plane, overlap, collect=on)
    _assert_reports_equal(plane.report(), jplane.report())
    assert torch.equal(s_off, s_on) and torch.equal(ys_off, ys_on)
    assert len(off) == len(on) == 6
    for (i, a), (j, b) in zip(off, on):
        assert i == j and np.array_equal(a, b)
    assert sh_on == sh_off == {} and not is_scoped(sh_on)


def test_counters_and_read_rate():
    """12 steps / 6 windows at every_n=4: one sample at the 4th drain and
    one finalize tail sample for the last 2 windows."""
    plane = ScopePlane(ScopeSpec(every_n_windows=4))
    _trun(plane, True)
    s1, s2 = plane.samples
    assert (s1["windows"], s1["steps"]) == (4, 8)
    assert (s2["windows"], s2["steps"]) == (6, 12)
    assert (s1["d_windows"], s2["d_windows"]) == (4, 2)
    assert s1["tokens"] == 16.0 and s2["tokens"] == 24.0
    rep = plane.report()
    assert rep["tokens_per_window"] == 4.0
    assert rep["samples"] == 2 and rep["quiet_samples"] == 0
    gates = dict(zip(GATE_NAMES, rep["gates"]))
    assert gates == {"nonfinite": 0, "zero": 0, "negative": 1,
                     "positive": 1}


def test_device_digests_equal_the_host_twin_of_the_drained_ys():
    collect = []
    plane = ScopePlane(ScopeSpec(every_n_windows=4))
    _trun(plane, True, collect=collect)
    host_win = {i: digest_tree(ys) for i, ys in collect}
    cum = 0
    for i in range(len(collect)):
        cum = ((cum * tscope._FNV) + host_win[i]) & tscope._M32
    assert plane.samples[-1]["digest"] == cum
    assert plane.samples[0]["win_digests"] == [host_win[i]
                                               for i in range(4)]
    assert plane.samples[-1]["win_digests"] == [host_win[4], host_win[5],
                                                host_win[2], host_win[3]]


def test_trace_ring_keeps_the_newest_steps_in_order():
    collect = []
    plane = ScopePlane(ScopeSpec(every_n_windows=8, ring_slots=4))
    _trun(plane, True, collect=collect)
    s = plane.samples[-1]
    assert s["trace_steps"] == 12
    rows = np.asarray(s["trace"])
    assert rows[:, 0].tolist() == [8, 9, 10, 11]
    ys = np.concatenate([collect[4][1], collect[5][1]])
    np.testing.assert_allclose(rows[:, 1], np.abs(ys).mean(axis=1),
                               rtol=TRACE_RTOL)
    np.testing.assert_allclose(rows[:, 2], np.abs(ys).max(axis=1),
                               rtol=TRACE_RTOL)
    assert rows[:, 3].tolist() == [0, 0, 0, 0]


def test_plumbing_normalisation_caching_and_lane_shapes():
    plane = ScopePlane(ScopeSpec())
    assert as_plane(plane) is plane
    assert isinstance(as_plane(ScopeSpec()), ScopePlane)
    with pytest.raises(TypeError):
        as_plane({"every_n_windows": 4})
    for spec in (ScopeSpec(), ScopeSpec(fuse=True)):
        p = ScopePlane(spec)
        assert p.instrument(_tengine) is p.instrument(_tengine)
    assert ScopeSpec(every_n_windows=4) == ScopeSpec(every_n_windows=4)
    assert ScopeSpec(every_n_windows=4) != ScopeSpec(every_n_windows=8)
    assert hash(ScopeSpec()) == hash(ScopeSpec())
    tree = scope_init(ScopeSpec(ring_slots=4), lanes=3)
    assert tree["tokens"].shape == (3,)
    assert tree["gates"].shape == (3, len(GATE_NAMES))
    assert tree["win_digests"].shape == (3, 1)
    assert tree["trace"].shape == (3, 4, 4)
    assert tree["windows"].shape == ()


# ------------------------------------------------------------ coverage ---
def test_update_gates_matches_the_reference(ref):
    _, _, _, jcov = ref
    a, b = CoverageMap(), jcov.CoverageMap()
    rng = np.random.default_rng(4)
    for gates in ([0, 1, 0, 1], [1, 1, 0, 0], [1, 1, 0, 1],
                  rng.integers(0, 2, (3, 4)).tolist()):
        name = "lanes" if np.ndim(gates) == 2 else "scope_gates"
        assert a.update_gates(gates, name) == b.update_gates(gates, name)
        assert a.fraction() == b.fraction()
    assert a.summary() == b.summary()


# ------------------------------------------- verifier digest first pass --
def _toy_oracle(scale=2.0):
    def oracle_step(state, batch):
        b = torch.tensor(batch, dtype=torch.float32)
        aux = {"scanned": (),
               "tail": ({"checksum": torch.stack([b, b * scale])},)}
        return state + b, {}, aux
    return oracle_step


def _commit_records(batches, scale=2.0):
    rows = np.asarray([[0.0, b, b * scale] for b in batches], np.float64)
    return {"fifos": {"commits": {"data": rows, "count": len(rows),
                                  "dropped": 0}}}


def test_verifier_digest_match_skips_the_row_compare():
    batches = [1.0, 2.0, 3.0, 4.0]
    v = CommitStreamVerifier(_toy_oracle(), torch.tensor(0.0), batches,
                             layers=1, expected_digests={0: 12345})
    tampered = _commit_records(batches[0:2])
    tampered["fifos"]["commits"]["data"][0, 1] += 99.0
    v(1, tampered, digest=12345, window=0)
    assert v.digest_hits == 1
    assert v.step == 2                          # the oracle stepped
    assert float(v.state) == 3.0


def test_verifier_digest_mismatch_falls_through_to_the_row_compare():
    batches = [1.0, 2.0, 3.0, 4.0]
    v = CommitStreamVerifier(_toy_oracle(), torch.tensor(0.0), batches,
                             layers=1, expected_digests={0: 12345, 1: 777})
    v(1, _commit_records(batches[0:2]), digest=999, window=0)
    assert v.digest_hits == 0                   # clean rows still pass
    bad = _commit_records(batches[2:4])
    bad["fifos"]["commits"]["data"][0, 1] += 99.0
    with pytest.raises(CommitDivergence):
        v(3, bad, digest=999, window=1)


def test_verifier_without_digest_keys_is_unchanged():
    batches = [1.0, 2.0]
    v = CommitStreamVerifier(_toy_oracle(), torch.tensor(0.0), batches,
                             layers=1)
    bad = _commit_records(batches)
    bad["fifos"]["commits"]["data"][1, 2] += 5.0
    with pytest.raises(CommitDivergence):
        v(1, bad)
    assert v.digest_hits == 0


# ----------------------------------------------------- scoped entry points --
def _loop(model, on_drain=None, **kw):
    lc = LoopConfig(steps=6, batch=2, seq=16, sample_interval=2,
                    checkpoint_dir=None, **kw)
    return train_loop(model, lc, OptConfig(warmup_steps=10),
                      on_drain=on_drain, resume=False, device="cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_scoped_train_loop_is_bitwise_and_reports(fused):
    """granite smoke, 6 steps in windows of 2: losses and state equal to
    the unscoped loop's to the bit; the report counts every step; the
    last sample's gate bits land in the coverage map; the fused engine's
    window digests equal the host twin of the drained metrics."""
    model = build_model(get_smoke_config("granite-8b"),
                        Runtime(attention_impl="xla",
                                taps=frozenset({"commits", "coverage"})))
    off = _loop(model, fused=fused)
    on = _loop(model, fused=fused, scope=ScopeSpec())
    assert on["losses"] == off["losses"]
    assert_trees_equal(off["state"], on["state"], "scoped loop state")
    rep = on["scope"]
    assert rep["steps"] == (6 if fused else 3)  # per step: 1 a window
    assert rep["windows"] == 3 and rep["samples"] == 3
    # the per-step engine's ys are the losses (finite, positive); the fused
    # engine's are every metric, moe_aux = 0 among them
    assert rep["gates"] == [0, 1 if fused else 0, 0, 1]
    assert "scope_gates" in on["coverage"]["per_map"]
    assert "scope" not in off
    if fused:
        # the fused engine's ys are the window's stacked metrics; their
        # losses are the loop's
        assert [s["trace"][-1][1] for s in rep["history"]] == pytest.approx(
            [abs(x) for x in off["losses"][1::2]], rel=TRACE_RTOL)


@pytest.mark.parametrize("spec", [ScopeSpec(every_n_windows=2),
                                  ScopeSpec(every_n_windows=3, fuse=True)],
                         ids=str)
def test_scoped_serve_is_bitwise_and_digests_the_tokens(spec):
    """glm4 smoke serve on the host: tokens and drained rows equal to the
    unscoped run's; every sample's digest ring and cumulative digest equal
    the host twin of the same windows' tokens (ys of shape (g, B, 1))."""
    cfg = get_smoke_config("glm4-9b")
    kw = dict(batch=2, prompt_len=8, gen=11, sample_interval=2,
              device="cpu", return_cache=True)
    off = serve(cfg, **kw)
    on = serve(cfg, scope=spec, **kw)
    assert on["tokens"] == off["tokens"] and on["drained"] == off["drained"]
    assert_trees_equal(off["cache"], on["cache"], "scoped serve cache")
    rep = on["scope"]
    assert rep["windows"] == 5 and rep["steps"] == 10
    assert check_scope_digests(
        rep, serve_window_digests(on["tokens"], 2)) == len(rep["history"])


def test_verifier_digest_pass_on_a_scoped_train_loop():
    """The fused loop's drained window digests against the expected
    digests of the same step run as the oracle: every window verified by
    digest alone; an oracle from another seed misses the digest, falls
    through to the row compare and raises at the first window."""
    model = build_model(get_smoke_config("glm4-9b"),
                        Runtime(attention_impl="xla",
                                taps=frozenset({"commits"})))
    cfg = model.cfg
    batches = [make_batch_fn(cfg, 2, 16, 0)(i) for i in range(6)]
    drains = []
    out = _loop(model, scope=ScopeSpec(),
                on_drain=lambda last, rec: drains.append((last, rec)))
    got = [s["win_digests"][0] for s in out["scope"]["history"]]
    step = make_train_step(model, OptConfig(warmup_steps=10))
    for seed, hits in ((0, 3), (99, None)):
        def state():
            return init_state(model, seed, device="cpu")
        exp = train_window_digests(step, state(), batches, 2)
        assert (exp == dict(enumerate(got))) == (seed == 0)
        v = CommitStreamVerifier(step, state(), batches,
                                 layers=cfg.num_layers,
                                 expected_digests=exp)
        if hits is None:
            with pytest.raises(CommitDivergence):
                v(*drains[0], digest=got[0], window=0)
            continue
        for w, (last, rec) in enumerate(drains):
            v(last, rec, digest=got[w], window=w)
        assert v.digest_hits == hits
