"""The port's Mamba-1 slice (falcon-mamba-7b) against the JAX package on the
CPU: K3's plain version against the reference's kernel (interpret mode)
and its sequential oracle, the mixer's forward, prefill and decode, the
commit-tapped Model.loss, greedy serve tokens, the Scale-Down replay and
the interop round trip. Weights are the reference's param trees redrawn
from numpy (``jax_weights``) and carried across; inputs are numpy arrays
from a seed, handed to both sides.

Tolerances: the scan in f32 at 1e-4, the reference's own (test_ssm_scan);
the mixer in f32 at 1e-5 of the output's largest magnitude; in bf16 at
3e-2 elementwise, the tolerance of the reference's test_mamba_impl_parity,
and at a normwise relative error of 2e-2, about twice the readings (5e-3
to 9e-3: the two frameworks round to bf16 at a few different points,
e.g. inside silu and the conv's tap sums). The model's
loss and checksums at the co-emulator's relative error, 1e-5 in f32 and
5e-2 in bf16, as test_torch_forward.py holds the dense family.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.ssm_scan import ops as jssm_ops  # noqa: E402
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jssm_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import commit as tcommit  # noqa: E402
from repro_torch.core import decompose as tdec  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as tssm_ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Runtime  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from jax_weights import seeded, seeded_params  # noqa: E402
from test_torch_decompose import _inputs  # noqa: E402
from test_torch_forward import (_setup, _port_loss, _jax_loss,  # noqa: E402
                                _rel_close)
from test_torch_model import _run_both, _check  # noqa: E402
from test_torch_modules import JDT, TDT, _np, _pair, _to_torch  # noqa: E402
from test_torch_serve import _jax_serve  # noqa: E402

ARCH = "falcon-mamba-7b"
TAPS = frozenset({"commits", "coverage"})
SCAN_TOL = 1e-4
BF16_TOL, BF16_NORM_REL = 3e-2, 2e-2
IMPLS = ("pallas_interpret", "xla")
_MOVED = ("ClosedJaxpr", "Jaxpr", "Literal", "ShapedArray", "Var")


def import_reference(*names):
    """The named modules of the JAX package. ``repro.core`` imports
    ``repro.analysis``, which reads four names that newer jax releases
    moved from ``jax.core`` to ``jax.extend.core``: they are aliased for
    these imports and the aliases removed again."""
    import jax.core
    import jax.extend.core
    added = [n for n in _MOVED if not hasattr(jax.core, n)]
    for n in added:
        setattr(jax.core, n, getattr(jax.extend.core, n))
    try:
        return [importlib.import_module(n) for n in names]
    finally:
        for n in added:
            delattr(jax.core, n)


@pytest.fixture(scope="module")
def ref():
    """The reference's commit stream, decomposition, scheduler, P-Shell
    and serve engine."""
    core, commit, decompose, pshell, launch = import_reference(
        "repro.core", "repro.core.commit", "repro.core.decompose",
        "repro.core.pshell", "repro.launch.serve")
    return types.SimpleNamespace(
        commit=commit, decompose=decompose,
        WindowScheduler=core.WindowScheduler, drain=pshell.drain,
        shell_init=pshell.shell_init,
        decode_shell_config=launch.decode_shell_config,
        make_decode_engine=launch.make_decode_engine)


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **kw))


def _close(a, b, dtype, what=""):
    """f32: within 1e-5 of b's largest magnitude. bf16: elementwise at
    BF16_TOL and normwise at BF16_NORM_REL. Returns the normwise error."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    if dtype == "float32":
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), what
    else:
        assert_allclose(a, b, rtol=BF16_TOL, atol=BF16_TOL, err_msg=what)
        assert rel <= BF16_NORM_REL, (what, rel)
    return rel


# --------------------------------------------------------------------- K3 ---
def _scan_inputs(B, S, Din, N, seed=6):
    """The reference test's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(n(B, S, Din)))
    A = -np.exp(0.5 * n(Din, N))
    return dt, A, n(B, S, N), n(B, S, N), n(B, S, Din)


@pytest.mark.parametrize("B,S,Din,N", [(2, 64, 32, 8), (1, 100, 48, 4),
                                       (2, 37, 24, 16)],
                         ids=["grid0", "grid1", "ragged"])
def test_plain_scan_matches_the_reference_kernel(B, S, Din, N):
    """K3's plain version (the wrapper on host tensors) against the TPU
    kernel in interpret mode and its sequential oracle, y and h_last."""
    arrs = _scan_inputs(B, S, Din, N)
    before = tssm_ops.ssm_scan.launches
    y, h = tssm_ops.ssm_scan(*(torch.from_numpy(a) for a in arrs))
    assert tssm_ops.ssm_scan.launches == before      # no kernel on host
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, Din) and tuple(h.shape) == (B, Din, N)
    ja = [jnp.asarray(a) for a in arrs]
    for jy, jh in (jssm_ops.ssm_scan(*ja, block_d=16, chunk=16,
                                     interpret=True), jssm_ref(*ja)):
        assert_allclose(y.numpy(), np.asarray(jy), rtol=SCAN_TOL,
                        atol=SCAN_TOL)
        assert_allclose(h.numpy(), np.asarray(jh), rtol=SCAN_TOL,
                        atol=SCAN_TOL)


def test_scan_takes_strided_views_and_casts_to_f32():
    """B_ and C_ as views into one projection, as the model splits them,
    and bf16 inputs cast to f32 as the TPU wrapper casts them."""
    dt, A, B_, C_, x = (torch.from_numpy(a)
                        for a in _scan_inputs(2, 20, 16, 8))
    dbc = torch.cat([torch.zeros(2, 20, 5), B_, C_], dim=-1)
    _, Bv, Cv = torch.split(dbc, [5, 8, 8], dim=-1)
    assert not Bv.is_contiguous()
    y0, h0 = tssm_ops.ssm_scan(dt, A, B_, C_, x)
    y1, h1 = tssm_ops.ssm_scan(dt, A, Bv, Cv, x)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    bf = [t.to(torch.bfloat16) for t in (dt, A, B_, C_, x)]
    y2, h2 = tssm_ops.ssm_scan(*bf)
    y3, h3 = tssm_ops.ssm_scan(*(t.float() for t in bf))
    assert y2.dtype == torch.float32
    assert torch.equal(y2, y3) and torch.equal(h2, h3)


def test_scan_refuses_other_devices():
    z = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tssm_ops.ssm_scan(z, torch.zeros(8, 4, device="meta"),
                          torch.zeros(1, 4, 4, device="meta"),
                          torch.zeros(1, 4, 4, device="meta"), z)


# ------------------------------------------------------------------ mixer ---
def _mamba_params(jcfg, seed=10):
    return seeded(jssm.init_mamba(jax.random.key(seed), jcfg), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_both_impls(dtype):
    """The port's one path (the K3 wrapper, its plain version on host
    tensors) against impl="pallas_interpret" and impl="xla"."""
    jcfg, tcfg = _cfgs(dtype)
    p = _mamba_params(jcfg)
    jx, tx = _pair(np.random.default_rng(11), (2, 32, jcfg.d_model), dtype)
    out = tssm.mamba_apply(_to_torch(p), tcfg, tx)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(jx.shape)
    for impl in IMPLS:
        _close(out, jssm.mamba_apply(p, jcfg, jx, impl=impl), dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_prefill_output_and_state(dtype):
    jcfg, tcfg = _cfgs(dtype)
    p = _mamba_params(jcfg, 12)
    jx, tx = _pair(np.random.default_rng(13), (2, 21, jcfg.d_model), dtype)
    jout, jstate = jssm.mamba_prefill(p, jcfg, jx)
    tout, tstate = tssm.mamba_prefill(_to_torch(p), tcfg, tx)
    spec = tssm.mamba_state_spec(tcfg, 2)
    jspec = jssm.mamba_state_spec(jcfg, 2)
    for k in ("conv", "ssm"):
        shape, dt = spec[k]
        assert tuple(tstate[k].shape) == shape == jspec[k].shape
        assert tstate[k].dtype == dt == TDT[str(jspec[k].dtype)]
        assert tstate[k].is_contiguous()
    _close(tout, jout, dtype, "out")
    _close(tstate["conv"], jstate["conv"], dtype, "conv")
    # the state is f32 in both dtypes; its error follows the inputs'
    _close(tstate["ssm"], jstate["ssm"], dtype, "ssm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_steps_update_the_state_in_place(dtype):
    """Five decode steps from a prefilled state, the same tokens' hidden
    states on both sides; the port writes its state into the same
    storage."""
    jcfg, tcfg = _cfgs(dtype)
    p = _mamba_params(jcfg, 14)
    tp = _to_torch(p)
    rng = np.random.default_rng(15)
    jx, tx = _pair(rng, (2, 9, jcfg.d_model), dtype)
    _, jstate = jssm.mamba_prefill(p, jcfg, jx)
    _, tstate = tssm.mamba_prefill(tp, tcfg, tx)
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    for step in range(5):
        jx1, tx1 = _pair(rng, (2, 1, jcfg.d_model), dtype)
        jy, jstate = jssm.mamba_decode(p, jcfg, jx1, jstate)
        ty, tstate2 = tssm.mamba_decode(tp, tcfg, tx1, tstate)
        assert tstate2 is tstate
        assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs
        _close(ty, jy, dtype, f"y step {step}")
        _close(tstate["conv"], jstate["conv"], dtype, f"conv step {step}")
        _close(tstate["ssm"], jstate["ssm"], dtype, f"ssm step {step}")


# ------------------------------------------------------------------ model ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_and_commit_taps_match(ref, dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp, jb, tb = _setup(jcfg, tcfg)
    tloss, (tmet, taux) = _port_loss(tcfg, tp, tb)
    tcks = tcommit.layer_checksums(taux)
    assert tuple(tcks.shape) == (jcfg.num_layers, 2)
    rtol = {"float32": 1e-5, "bfloat16": 5e-2}[dtype]
    for impl in IMPLS:
        jloss, (jmet, jaux) = _jax_loss(jcfg, jp, jb, impl)
        _rel_close(tloss, jloss, rtol, f"loss {impl}")
        _rel_close(tmet["ce"], jmet["ce"], rtol, f"ce {impl}")
        _rel_close(tcks, ref.commit.layer_checksums(jaux), rtol,
                   f"checksums {impl}")
        assert np.array_equal(tcommit.nan_bits(taux).numpy(),
                              np.asarray(ref.commit.nan_bits(jaux)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match(dtype, impl):
    """Model.prefill and four decode_steps (the serve path's model calls)
    against the reference's, logits and every state leaf."""
    jcfg, tcfg = _cfgs(dtype)
    _check(_run_both(jcfg, tcfg, jimpl=impl), dtype)


@pytest.mark.parametrize("batch,prompt_len,gen,interval",
                         [(2, 12, 8, 3), (3, 16, 9, 4)])
def test_serve_tokens_match_the_reference(ref, batch, prompt_len, gen,
                                          interval):
    """serve() on the host against the reference's serve loop, f32: the
    same greedy tokens, FIFO counts and CSRs."""
    jcfg, tcfg = _cfgs("float32")
    jp = seeded_params(jcfg)
    ref_toks, ref_drained = _jax_serve(ref, jcfg, jp, batch, prompt_len,
                                       gen, interval)
    out = serve(tcfg, batch, prompt_len, gen, sample_interval=interval,
                device="cpu",
                params=params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu"))
    assert np.array_equal(np.asarray(out["tokens"]), ref_toks)
    assert out["decode_fifo_rows"] == gen - 1
    assert [d["count"] for d in out["drained"]] \
        == [d["count"] for d in ref_drained]
    assert [d["tokens_csr"] for d in out["drained"]] \
        == [d["tokens_csr"] for d in ref_drained]


def test_cache_spec_matches_the_reference():
    jcfg, tcfg = _cfgs("bfloat16", num_layers=3)
    jspec = jtfm.stack_cache_spec(jcfg, 2, 20)
    tspec = ttfm.stack_cache_spec(tcfg, 2, 20)
    for k in ("scanned", "tail"):
        mine = jax.tree.leaves(
            jax.tree.map(lambda s: (tuple(s[0]), str(s[1])[6:]), tspec[k],
                         is_leaf=lambda s: isinstance(s, tuple)
                         and len(s) == 2 and isinstance(s[1], torch.dtype)))
        theirs = jax.tree.leaves(jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), jspec[k]))
        assert mine == theirs


# ------------------------------------------------------------- Scale-Down ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_extraction_and_scanned_vs_unrolled(ref, dtype):
    """Every layer's standalone replay equals its in-situ run bit for bit
    and the reference's replay of the same block on the same boundary
    input; the stacked forward equals the unrolled one exactly."""
    jcfg, tcfg = _cfgs(dtype, num_layers=3)
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _, jpos, tx, tpos = _inputs(jcfg, jp, tp)
    trt = Runtime(taps=TAPS)
    with torch.inference_mode():
        _, trecs = tdec.unrolled_capture(tp, tcfg, tx, tpos, trt)
        assert tdec.scanned_vs_unrolled(tp, tcfg, tx, tpos, trt) == 0.0
    B, S = tx.shape[:2]
    for layer in range(tcfg.num_layers):
        with torch.inference_mode():
            rep = tdec.verify_extraction(tp, tcfg, tx, tpos, trt, layer)
        assert rep["bitwise_identical"] is True and rep["max_abs_diff"] \
            == 0.0, rep
        jsub = ref.decompose.extract_block(
            jp, jcfg, layer, JaxRuntime(taps=TAPS,
                                        attention_impl="pallas_interpret"),
            B, S)
        assert rep["subsystem"] == jsub.name == f"layer{layer}:mamba+None"
        x_in = trecs[layer]["x_in"].float().numpy()
        jreplay = jsub.fn(jnp.asarray(x_in).astype(JDT[dtype]), jpos)
        _close(trecs[layer]["x_out"], jreplay, dtype, f"layer {layer}")


# ---------------------------------------------------------------- interop ---
def test_interop_round_trip_keeps_the_f32_leaves_bitwise():
    """bf16 model, f32 dt_bias / A_log / D_skip: both cross exactly."""
    jcfg = jax_smoke(ARCH)
    jp = seeded_params(jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, get_smoke_config(ARCH), "cpu")
    mp = tp["stack"]["blocks"][0]["mamba"]
    assert mp["in_proj"]["w"].dtype == torch.bfloat16
    for k in ("dt_bias", "A_log", "D_skip"):
        assert mp[k].dtype == torch.float32, k
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32),
                              b.astype(np.float32).view(np.uint32))
