"""ZP-Cert of the port (``repro_torch.analysis``) on the CPU: every case of
the reference's ``tests/test_analysis.py`` in the port's idiom (one fixture
engine per boardcheck rule, each tripping exactly its rule, with a clean
twin; certification held trace-only under the no-dispatch guard; the race
lint's rule fixtures as module source strings; the port's farm sources
lint clean; the CLI gate in-process), the five kernel wrappers' traced
branch on fake CUDA tensors, and the port held against the JAX package in
one process: the race lint's findings identical on the same sources, each
rule's reference fixture and its port twin giving the same rule set, and
every arch's smoke train board certified clean on both sides.

The reference's ``repro.analysis`` is imported through
``test_torch_ssm.import_reference`` (``boardcheck.py`` reads names that
jax 0.9 moved out of ``jax.core``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (CertReport, certify_engine,  # noqa: E402
                                  certify_job, certify_spec,
                                  no_dispatch_guard)
from repro_torch.analysis.racecheck import (check_paths,  # noqa: E402
                                            check_source, farm_sources)
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core.scope import ScopeSpec  # noqa: E402
from repro_torch.farm import FarmJob, JobSpec  # noqa: E402
from repro_torch.kernels import count_launch, traced_counts  # noqa: E402
from test_torch_ssm import import_reference  # noqa: E402


# ------------------------------------------------------------- fixtures --
def _state():
    return torch.zeros(4)


def _shell():
    return {"acc": torch.zeros(())}


def _stack():
    return torch.ones(2, 4)


def _clean_engine(state, shell, stack):
    s = state + stack.sum(0)
    return s, {"acc": shell["acc"] + 1.0}, stack * 2.0


def _inplace_engine(state, shell, stack):
    state.add_(stack.sum(0))        # the port's "donation": arg 0 in place
    return state, {"acc": shell["acc"] + 1.0}, stack * 2.0


def _certify(engine, state=None, shell=None, stack=None, **kw):
    return certify_engine(engine, _state() if state is None else state,
                          _shell() if shell is None else shell,
                          _stack() if stack is None else stack, **kw)


def _rules(report: CertReport):
    return sorted({f.rule for f in report.findings})


# the port's twin of each reference fixture (tests/test_analysis.py)
def _zc100(state, shell, stack):
    state.data_ptr()                # a raw pointer: no fake tensor has one
    return state, shell, stack


def _zc101(state, shell, stack):
    host = state.sum().item()       # a host round-trip every window
    return state + host, shell, stack * 2.0


def _zc102(state, shell, stack):
    shell["acc"].add_(1.0)          # the drain snapshot written in place
    return state + stack.sum(0), shell, stack * 2.0


def _zc104_dtype(state, shell, stack):
    return state.to(torch.bfloat16), shell, stack


def _zc104_tree(state, shell, stack):
    return state, {"acc": shell["acc"], "extra": state}, stack


def _zc104_pair(state, shell, stack):
    return state, stack


def _zc105(state, shell, stack):
    return state + torch.tensor(1.0), shell, stack


def _zc106_reseed(state, shell, stack):
    g = state["gen"]
    g.manual_seed(0)                # every window draws the same stream
    a = torch.randn(4, generator=g)
    return state, shell, stack + a


def _zc106_split(state, shell, stack):
    noise = torch.randn(4, generator=state["gen"])
    return state, shell, stack + noise


def _zc106_loop_clean(state, shell, stack):
    x = state["x"]
    for _ in range(2):
        x = x + torch.randn(4, generator=state["gen"])
    return {"gen": state["gen"], "x": x}, shell, stack


def _zc106_loop_reseed(state, shell, stack):
    x = state["x"]
    for _ in range(2):
        torch.manual_seed(0)        # the global generator, re-seeded
        x = x + torch.randn(4)
    return {"gen": state["gen"], "x": x}, shell, stack


def _gen_state(with_x=False):
    st = {"gen": torch.Generator().manual_seed(0)}
    if with_x:
        st["x"] = torch.zeros(4)
    return st


# ------------------------------------------------------ per-rule fixtures --
def test_clean_engine_certifies_clean():
    r = _certify(_clean_engine)
    assert r.findings == [] and r.ok and r.writes == []


def test_zc100_untraceable_engine():
    assert _rules(_certify(_zc100)) == ["ZC100"]


def test_zc101_host_sync_in_body():
    r = _certify(_zc101)
    assert _rules(r) == ["ZC101"]
    assert "_local_scalar_dense" in r.findings[0].summary


def test_zc101_host_copies_of_a_card_tensor():
    """On a (fake) card state: ``.cpu()``, ``.numpy()`` and
    ``torch.cuda.synchronize`` in the body are host syncs; a copy of host
    data to the card is not, and none of them runs for real."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        state = torch.zeros(4, device="cuda")

    def copies(state, shell, stack):
        host = state.cpu().numpy()
        torch.cuda.synchronize()
        return state + torch.as_tensor(host).to(state.device), shell, stack

    r = _certify(copies, state=state)
    assert _rules(r) == ["ZC101"]
    said = " ".join(f.summary for f in r.findings)
    assert "_to_copy" in said and ".numpy()" in said \
        and "torch.cuda.synchronize()" in said

    def upload(state, shell, stack):
        return state + torch.tensor([1.0, 2.0, 3.0, 4.0],
                                    device=state.device), shell, stack
    assert _certify(upload, state=state).findings == []


def test_zc102_shell_or_stack_written_in_place():
    assert _rules(_certify(_zc102)) == ["ZC102"]

    def stack_writer(state, shell, stack):
        stack.mul_(2.0)
        return state, shell, stack
    r = _certify(stack_writer)
    assert _rules(r) == ["ZC102"] and r.writes == ["stack"]
    assert _rules(_certify(_clean_engine)) == []    # writes nothing


def test_zc103_inplace_state_without_replay_copy():
    r = _certify(_inplace_engine)
    assert _rules(r) == ["ZC103"] and r.writes == ["state"]
    # a state FACTORY, or the solo farm's replay copy, makes it safe
    assert _rules(_certify(_inplace_engine, state_is_factory=True)) == []
    assert _rules(_certify(_inplace_engine, replay_copy=True)) == []


def test_zc104_carry_dtype_drift():
    r = _certify(_zc104_dtype)
    assert _rules(r) == ["ZC104"]
    assert "state" in r.findings[0].summary


def test_zc104_carry_tree_change():
    r = _certify(_zc104_tree)
    assert _rules(r) == ["ZC104"]
    assert "shell" in r.findings[0].summary


def test_zc104_not_a_triple():
    assert _rules(_certify(_zc104_pair)) == ["ZC104"]


def test_zc105_bare_number_becomes_tensor():
    r = _certify(_zc105, state=1.0)
    assert _rules(r) == ["ZC105"]
    assert all(f.severity == "warning" for f in r.findings)


def test_zc106_generator_reseeded():
    r = _certify(_zc106_reseed, state=_gen_state())
    assert _rules(r) == ["ZC106"]
    assert all(f.severity == "warning" for f in r.findings)


def test_zc106_carried_generator_is_clean():
    gen = _gen_state()
    before = gen["gen"].get_state()
    assert _certify(_zc106_split, state=gen).findings == []
    # certification draws from and seeds a private copy only
    assert torch.equal(gen["gen"].get_state(), before)


def test_zc106_carried_generator_in_a_loop_is_clean():
    assert _certify(_zc106_loop_clean,
                    state=_gen_state(with_x=True)).findings == []


def test_zc106_global_generator_in_a_loop_is_reuse():
    before = torch.random.get_rng_state()
    r = _certify(_zc106_loop_reseed, state=_gen_state(with_x=True))
    assert _rules(r) == ["ZC106"]
    # the body's torch.manual_seed was recorded, not run
    assert torch.equal(torch.random.get_rng_state(), before)

    def global_draw(state, shell, stack):
        return state + torch.randn(4), shell, stack
    assert _rules(_certify(global_draw)) == ["ZC106"]


def test_zc107_fused_scope_over_inplace_engine():
    r = _certify(_inplace_engine, state_is_factory=True,
                 scope=ScopeSpec(fuse=True))
    assert _rules(r) == ["ZC107"]
    # the unfused plane over the same engine is fine
    r2 = _certify(_inplace_engine, state_is_factory=True,
                  scope=ScopeSpec(fuse=False))
    assert r2.findings == []


# -------------------------------------------------------- trace-only --
def test_certification_is_trace_only():
    """Every rule fixture certifies without a launch, a build, a replay
    or an allocation, and the engine's in-place writes land on fakes."""
    state = _state()
    with no_dispatch_guard():
        assert _certify(_clean_engine).ok
        assert _rules(_certify(_inplace_engine, state=state)) == ["ZC103"]
        for engine in (_zc100, _zc101, _zc102, _zc104_dtype):
            assert not _certify(engine).ok
    assert torch.equal(state, torch.zeros(4))


def test_no_dispatch_guard_trips_on_real_dispatch():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import flash_attention
    n = flash_attention.launches
    try:
        with pytest.raises(AssertionError, match="trace-only"):
            with no_dispatch_guard():
                count_launch(flash_attention)   # what a launch counts
    finally:
        flash_attention.launches = n
    with no_dispatch_guard():
        with pytest.raises(AssertionError, match="trace-only"):
            _build.load("flash_attention")


def test_certify_job_duck_typing():
    job = FarmJob(name="toy", engine=_clean_engine,
                  windows=[[np.ones((4,), np.float32)] * 2],
                  state=_state(), shell=_shell(),
                  stack_fn=lambda it: torch.as_tensor(np.stack(it)))
    with no_dispatch_guard():
        r = certify_job(job)
    assert r.name == "toy" and r.findings == []


def test_lane_keyed_inplace_board_needs_a_factory():
    """A solo job dispatches from a replay copy; a lane-keyed one may be
    packed without one, so its in-place state update is ZC103 unless the
    state is a zero-arg factory."""
    kw = dict(engine=_inplace_engine, windows=[[np.float32(1.0)] * 4],
              shell=_shell(), stack_fn=lambda it: torch.as_tensor(
                  np.stack(it)))
    assert certify_job(FarmJob(name="solo", state=_state(), **kw)).ok
    r = certify_job(FarmJob(name="lanes", state=_state(), lane_key="k",
                            **kw))
    assert _rules(r) == ["ZC103"]
    assert certify_job(FarmJob(name="factory", state=_state, lane_key="k",
                               **kw)).ok


# ------------------------------------------- the kernels' traced branch --
def _fake_kernel_calls():
    """Each of the five wrappers on fake CUDA tensors of a small shape:
    (name, call, expected output shapes)."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.grouped_gemm.ops import grouped_gemm
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssm_scan.ops import ssm_scan

    def t(*shape, dtype=torch.float32):
        return torch.empty(*shape, device="cuda", dtype=dtype)
    bf = torch.bfloat16
    return {
        "flash_attention": (lambda: flash_attention(
            t(2, 16, 4, 64, dtype=bf), t(2, 16, 2, 64, dtype=bf),
            t(2, 16, 2, 64, dtype=bf)), [(2, 16, 4, 64)]),
        "decode_attention": (lambda: decode_attention(
            t(2, 4, 64, dtype=bf), t(2, 32, 2, 64, dtype=bf),
            t(2, 32, 2, 64, dtype=bf),
            pos=torch.zeros((), dtype=torch.int32, device="cuda"),
            window=32), [(2, 4, 64)]),
        "ssm_scan": (lambda: ssm_scan(t(2, 8, 16), t(16, 16), t(2, 8, 16),
                                      t(2, 8, 16), t(2, 8, 16)),
                     [(2, 8, 16), (2, 16, 16)]),
        "rglru_scan": (lambda: rglru_scan(t(2, 8, 16), t(2, 8, 16),
                                          t(2, 16)),
                       [(2, 8, 16), (2, 16)]),
        "grouped_gemm": (lambda: grouped_gemm(t(4, 8, 16, dtype=bf),
                                              t(4, 16, 32, dtype=bf)),
                         [(4, 8, 32)]),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "ssm_scan", "rglru_scan",
                                    "grouped_gemm"])
def test_kernel_wrapper_traced_branch_on_fake_cuda(kernel):
    """On fake CUDA tensors (no card here) a wrapper checks its shapes,
    returns fakes of the kernel's shape on the input's device, notes the
    call in the thread's trace tally, and launches, builds and counts
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.core.graphs import launch_counts

    before = launch_counts()
    traced_counts(reset=True)
    with no_dispatch_guard(), FakeTensorMode():
        call, shapes = _fake_kernel_calls()[kernel]
        out = call()
    outs = out if isinstance(out, tuple) else (out,)
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(isinstance(o, FakeTensor) and o.device.type == "cuda"
               for o in outs)
    assert traced_counts(reset=True) == {kernel: 1}
    assert launch_counts() == before


def test_kernel_wrapper_traced_branch_checks_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention.ops import flash_attention
    with FakeTensorMode():
        q = torch.empty(2, 16, 4, 48, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(q, q, q)


# ------------------------------------------------------------ racecheck --
_RC201_SRC = '''
import threading
from repro_torch.analysis.annotations import any_thread

class Mgr:
    def __init__(self):
        self._mu = threading.Lock()
        self._marks = set()

    def sweep(self):
        with self._mu:
            self._marks.clear()

    @any_thread
    def force(self, name):
        self._marks.add(name)       # the force_evict shape
'''

_RC202_SRC = '''
from repro_torch.analysis.annotations import control_thread_only

class Mgr:
    def __init__(self):
        self.queue = []

    @control_thread_only
    def admit(self, j):
        self.queue.append(j)

    def poke(self, j):              # unannotated: any thread may call
        self.queue.append(j)
'''

_RC203_SRC = '''
from repro_torch.analysis.annotations import (control_thread_only,
                                              slot_thread_only)

class Mgr:
    @control_thread_only
    def a(self):
        self.shared = 1

    @slot_thread_only
    def b(self):
        self.shared = 2
'''

_INIT_SRC = '''
class C:
    def __init__(self):
        self.items = []             # pre-concurrency: exempt
'''


def test_rc201_unlocked_mutation():
    fs = check_source(_RC201_SRC, "fixture.py")
    assert [f.rule for f in fs] == ["RC201"]
    assert fs[0].attr == "_marks" and fs[0].method == "force"


def test_rc202_cross_thread_write():
    fs = check_source(_RC202_SRC, "fixture.py")
    assert [f.rule for f in fs] == ["RC202"]
    assert fs[0].attr == "queue" and fs[0].method == "poke"


def test_rc203_mixed_owners():
    fs = check_source(_RC203_SRC, "fixture.py")
    assert [f.rule for f in fs] == ["RC203"]
    assert fs[0].attr == "shared"


def test_suppression_comment():
    src = _RC201_SRC.replace("self._marks.add(name)",
                             "self._marks.add(name)  # zp-cert: ok")
    assert check_source(src, "fixture.py") == []


def test_thread_confined_class_is_skipped():
    src = ("from repro_torch.analysis.annotations import thread_confined\n"
           + _RC201_SRC.replace("class Mgr:",
                                "@thread_confined\nclass Mgr:"))
    assert check_source(src, "fixture.py") == []


def test_init_is_exempt():
    assert check_source(_INIT_SRC, "fixture.py") == []


def test_shipped_farm_sources_lint_clean():
    srcs = farm_sources()
    assert srcs[0].endswith("repro_torch/farm") \
        and srcs[1].endswith("repro_torch/core/schedule.py")
    assert check_paths(srcs) == []


def test_slot_thread_writing_control_state_is_a_finding():
    """The delivery fix's contract: had the slot thread's commit hook
    advanced a control-owned cursor itself (instead of asking the control
    plane and waiting), the lint would name it."""
    src = '''
from repro_torch.analysis.annotations import (control_thread_only,
                                              slot_thread_only)

class Mgr:
    @control_thread_only
    def deliver(self, n):
        self.delivered = n

    @slot_thread_only
    def on_commit(self, n):
        self.delivered = n
'''
    assert [f.rule for f in check_source(src, "fixture.py")] == ["RC203"]


# ------------------------------------------------------------------ CLI --
def test_cli_racecheck_strict_passes():
    from repro_torch.analysis.__main__ import main
    assert main(["--no-boards", "--strict"]) == 0


def test_cli_boardcheck_factories_strict_passes(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--no-races", "--strict", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cert:zp.ledger_board: certified clean" in out
    assert "0 board errors" in out


def test_cli_json_names_every_board(capsys):
    import json

    from repro_torch.analysis.__main__ import main
    assert main(["--json", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["errors"] == 0 and out["races"] == []
    assert {"cert:zp.ledger_board", "cert:zp.train_board"} <= \
        set(out["boards"])


# ============================================== against the reference ==
@pytest.fixture(scope="module")
def ref():
    boardcheck, racecheck = import_reference("repro.analysis.boardcheck",
                                             "repro.analysis.racecheck")
    return boardcheck, racecheck


def _key(f):
    return (f.rule, f.line, f.cls, f.method, f.attr)


@pytest.mark.parametrize("src", ["rc201", "rc202", "rc203", "init",
                                 "suppressed", "confined"])
def test_race_lint_matches_the_reference_on_fixtures(ref, src):
    """The same source text gives the same findings (rule, line, class,
    method, attribute) under both lints; the reference's fixtures import
    ``repro.analysis.annotations``, which the lint reads by name only."""
    text = {"rc201": _RC201_SRC, "rc202": _RC202_SRC, "rc203": _RC203_SRC,
            "init": _INIT_SRC,
            "suppressed": _RC201_SRC.replace(
                "self._marks.add(name)",
                "self._marks.add(name)  # zp-cert: ok"),
            "confined": ("from repro_torch.analysis.annotations import "
                         "thread_confined\n" + _RC201_SRC.replace(
                             "class Mgr:", "@thread_confined\nclass Mgr:"))
            }[src]
    for t in (text, text.replace("repro_torch.analysis", "repro.analysis")):
        mine = [_key(f) for f in check_source(t, "fixture.py")]
        theirs = [_key(f) for f in ref[1].check_source(t, "fixture.py")]
        assert mine == theirs


def test_race_lint_matches_the_reference_on_the_port_farm(ref):
    """Both lints read the port's own farm sources alike (all clean), and
    the reference's farm sources alike too."""
    for path in farm_sources() + ref[1].farm_sources():
        paths = [path]
        mine = [_key(f) for f in check_paths(paths)]
        theirs = [_key(f) for f in ref[1].check_paths(paths)]
        assert mine == theirs == []
    # and a port source with every decorator stripped, where both lints
    # find the same unowned mutations
    import os
    with open(os.path.join(farm_sources()[0], "manager.py")) as f:
        text = f.read().replace("with self._mu:", "if True:")
    mine = [_key(f) for f in check_source(text, "manager.py")]
    theirs = [_key(f) for f in ref[1].check_source(text, "manager.py")]
    assert mine == theirs and mine


def _ref_fixtures(jax, jnp):
    """The reference's fixture engines (tests/test_analysis.py) with the
    state each is certified on and the certify keywords."""
    S = jnp.zeros((4,), jnp.float32)
    key = {"key": jax.random.PRNGKey(0)}

    def clean(state, shell, stack):
        return (state + jnp.sum(stack, axis=0),
                {"acc": shell["acc"] + 1.0}, stack * 2.0)

    def zc100(state, shell, stack):
        if float(jnp.sum(state)) > 0:
            return state, shell, stack
        return state, shell, stack

    def zc101(state, shell, stack):
        host = jax.pure_callback(lambda x: np.asarray(x),
                                 jax.ShapeDtypeStruct(S.shape, S.dtype),
                                 state)
        return state + host, shell, stack * 2.0

    def zc104_dtype(state, shell, stack):
        return state.astype(jnp.bfloat16), shell, stack

    def zc104_tree(state, shell, stack):
        return state, {"acc": shell["acc"], "extra": state}, stack

    def zc104_pair(state, shell, stack):
        return state, stack

    def zc105(state, shell, stack):
        return state + jnp.float32(1.0), shell, stack

    def zc106(state, shell, stack):
        k = state["key"]
        return {"key": k}, shell, (stack + jax.random.normal(k, (4,))
                                   + jax.random.normal(k, (4,)))

    def zc106_split(state, shell, stack):
        k1, k2 = jax.random.split(state["key"])
        return {"key": k2}, shell, stack + jax.random.normal(k1, (4,))

    donate0 = jax.jit(clean, donate_argnums=(0,))
    return {
        "clean": (clean, S, {}),
        "ZC100": (zc100, S, {}),
        "ZC101": (zc101, S, {}),
        "ZC102": (jax.jit(clean, donate_argnums=(1,)), S, {}),
        "ZC103": (donate0, S, {}),
        "ZC103-factory": (donate0, S, {"state_is_factory": True}),
        "ZC104-dtype": (zc104_dtype, S, {}),
        "ZC104-tree": (zc104_tree, S, {}),
        "ZC104-pair": (zc104_pair, S, {}),
        "ZC105": (zc105, 1.0, {}),
        "ZC106": (zc106, key, {}),
        "ZC106-clean": (zc106_split, key, {}),
        "ZC107": (donate0, S, {"state_is_factory": True}, True),
        "ZC107-unfused": (donate0, S, {"state_is_factory": True}, False),
    }


_PORT_TWINS = {
    "clean": (_clean_engine, None, {}),
    "ZC100": (_zc100, None, {}),
    "ZC101": (_zc101, None, {}),
    "ZC102": (_zc102, None, {}),
    "ZC103": (_inplace_engine, None, {}),
    "ZC103-factory": (_inplace_engine, None, {"state_is_factory": True}),
    "ZC104-dtype": (_zc104_dtype, None, {}),
    "ZC104-tree": (_zc104_tree, None, {}),
    "ZC104-pair": (_zc104_pair, None, {}),
    "ZC105": (_zc105, 1.0, {}),
    "ZC106": (_zc106_reseed, "gen", {}),
    "ZC106-clean": (_zc106_split, "gen", {}),
    "ZC107": (_inplace_engine, None, {"state_is_factory": True}, True),
    "ZC107-unfused": (_inplace_engine, None, {"state_is_factory": True},
                      False),
}


@pytest.mark.parametrize("case", list(_PORT_TWINS))
def test_rule_fixture_twins_match_the_reference(ref, case):
    """Each reference fixture and its port twin yield the same rules."""
    import jax
    import jax.numpy as jnp
    from repro.core.scope import ScopeSpec as RefScopeSpec

    r_engine, r_state, r_kw, *r_fuse = _ref_fixtures(jax, jnp)[case]
    if r_fuse:
        r_kw = dict(r_kw, scope=RefScopeSpec(fuse=r_fuse[0]))
    theirs = ref[0].certify_engine(
        r_engine, r_state, {"acc": jnp.zeros((), jnp.float32)},
        jnp.ones((2, 4), jnp.float32), **r_kw)
    p_engine, p_state, p_kw, *p_fuse = _PORT_TWINS[case]
    if p_fuse:
        p_kw = dict(p_kw, scope=ScopeSpec(fuse=p_fuse[0]))
    state = _gen_state() if p_state == "gen" else p_state
    mine = _certify(p_engine, state=state, **p_kw)
    assert _rules(mine) == sorted({f.rule for f in theirs.findings})
    assert [f.severity for f in mine.findings] == \
        [f.severity for f in theirs.findings]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_train_board_certifies_clean_on_both_sides(ref, arch):
    import repro.launch.farm  # noqa: F401 — registers the factories
    from repro.farm.registry import JobSpec as RefJobSpec

    import repro_torch.launch.farm  # noqa: F401
    kw = {"arch": arch, "steps": 2, "interval": 2}
    theirs = ref[0].certify_spec(RefJobSpec(
        name=f"cert:{arch}", factory="zp.train_board", kwargs=kw))
    with no_dispatch_guard():
        mine = certify_spec(JobSpec(
            name=f"cert:{arch}", factory="zp.train_board",
            kwargs=dict(kw, device="cpu")))
    assert theirs.errors == [], theirs.summary()
    assert mine.errors == [], mine.summary()
    assert _rules(mine) == sorted({f.rule for f in theirs.findings})
