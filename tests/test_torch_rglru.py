"""The port's RG-LRU hybrid slice (recurrentgemma-2b) against the JAX package
on the CPU: K4's plain version against the reference's kernel (interpret
mode) and its sequential oracle, the chaining property, the RG-LRU
block's forward, prefill and decode, the commit-tapped Model.loss, greedy
serve tokens, the Scale-Down replay, the interop round trip, and the
plain K1 and K2 at recurrentgemma's head_dim 256. Weights are the
reference's param trees redrawn from numpy (``jax_weights``) and carried
across; inputs are numpy arrays from a seed, handed to both sides.

Tolerances: the scan in f32 at 1e-5, the reference's own
(test_rglru_scan); the block in f32 at 1e-5 of the output's largest
magnitude; in bf16 at 3e-2 elementwise, the tolerance of the reference's
test_rglru_impl_parity, and at a normwise relative error of 2e-2 (the two
frameworks round to bf16 at a few different points, e.g. inside the tanh
GELU and the conv's tap sums). softplus: torch's switches to the identity
above 20, jax's does not; Lambda lies near -9 to -4, where both compute
log1p(exp(x)), and the f32 tolerance holds. The model's loss and
checksums at the co-emulator's relative error, 1e-5 in f32 and 5e-2 in
bf16, as test_torch_forward.py holds the dense family. K1 and K2 at the
tolerances of tests/test_kernels.py, f32 2e-5 and bf16 2e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.decode_attention import ops as jda_ops  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jda_ref)
from repro.kernels.rglru_scan import ops as jlru_ops  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jlru_ref  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import commit as tcommit  # noqa: E402
from repro_torch.core import decompose as tdec  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tda_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as tlru_ops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Runtime  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from jax_weights import seeded, seeded_params  # noqa: E402
from test_torch_decompose import _inputs  # noqa: E402
from test_torch_forward import (_setup, _port_loss, _jax_loss,  # noqa: E402
                                _rel_close)
from test_torch_kernels import _fa_both  # noqa: E402
from test_torch_model import _run_both, _check  # noqa: E402
from test_torch_modules import JDT, TDT, _pair, _to_torch  # noqa: E402
from test_torch_serve import _jax_serve  # noqa: E402
from test_torch_ssm import (IMPLS, TAPS, _close,  # noqa: E402,F401
                            import_reference, ref)

# repro.core and repro.analysis of the reference are imported, under the
# aliases, as this module is collected, so every pytest-xdist worker holds
# them before its first test. repro.analysis imports only under the
# aliases, and tests/test_certify_farm.py imports it at test time:
# without this, whether those tests could, and so their results, would
# depend on which files the scheduler gave their worker first.
import_reference("repro.core", "repro.analysis")

ARCH = "recurrentgemma-2b"
SCAN_TOL = 1e-5
KTOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jax_smoke(ARCH), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(ARCH), dtype=dtype, **kw))


# --------------------------------------------------------------------- K4 ---
def _scan_inputs(B, S, W, seed=7):
    """The reference test's distributions, from numpy: a in (0, 1), b and
    a nonzero h0 normal."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = (1.0 / (1.0 + np.exp(-n(B, S, W)))).astype(np.float32)
    return a, n(B, S, W), n(B, W)


@pytest.mark.parametrize("B,S,W", [(2, 64, 32), (1, 96, 64), (2, 37, 24)],
                         ids=["grid0", "grid1", "ragged"])
def test_plain_scan_matches_the_reference_kernel(B, S, W):
    """K4's plain version (the wrapper on host tensors) against the TPU
    kernel in interpret mode and its sequential oracle, h_all and h_last,
    from a nonzero h0."""
    arrs = _scan_inputs(B, S, W)
    before = tlru_ops.rglru_scan.launches
    h, h_last = tlru_ops.rglru_scan(*(torch.from_numpy(a) for a in arrs))
    assert tlru_ops.rglru_scan.launches == before    # no kernel on host
    assert h.dtype == h_last.dtype == torch.float32
    assert tuple(h.shape) == (B, S, W) and tuple(h_last.shape) == (B, W)
    ja = [jnp.asarray(a) for a in arrs]
    for jh, jh_last in (jlru_ops.rglru_scan(*ja, block_w=16, chunk=16,
                                            interpret=True), jlru_ref(*ja)):
        assert_allclose(h.numpy(), np.asarray(jh), rtol=SCAN_TOL,
                        atol=SCAN_TOL)
        assert_allclose(h_last.numpy(), np.asarray(jh_last), rtol=SCAN_TOL,
                        atol=SCAN_TOL)


@pytest.mark.parametrize("s1,s2", [(8, 8), (9, 24), (17, 13), (24, 11)])
def test_plain_scan_chaining_property(s1, s2):
    """A split sequence fed the first part's h_last equals one pass
    (tests/test_kernels.py::test_rglru_scan_chaining_property), and both
    equal the reference kernel's split run."""
    a, b, h0 = (torch.from_numpy(x) for x in _scan_inputs(1, s1 + s2, 16,
                                                          seed=s1 * 100 + s2))
    h_all, h_last = tlru_ops.rglru_scan(a, b, h0)
    h1, h1_last = tlru_ops.rglru_scan(a[:, :s1], b[:, :s1], h0)
    h2, h2_last = tlru_ops.rglru_scan(a[:, s1:], b[:, s1:], h1_last)
    assert_allclose(h2_last.numpy(), h_last.numpy(), rtol=SCAN_TOL,
                    atol=SCAN_TOL)
    assert_allclose(torch.cat([h1, h2], 1).numpy(), h_all.numpy(),
                    rtol=SCAN_TOL, atol=SCAN_TOL)
    ja, jb, jh0 = (jnp.asarray(x.numpy()) for x in (a, b, h0))
    _, jh1 = jlru_ops.rglru_scan(ja[:, :s1], jb[:, :s1], jh0, block_w=16,
                                 chunk=8, interpret=True)
    jy2, jh2 = jlru_ops.rglru_scan(ja[:, s1:], jb[:, s1:], jh1, block_w=16,
                                   chunk=8, interpret=True)
    assert_allclose(h2.numpy(), np.asarray(jy2), rtol=SCAN_TOL,
                    atol=SCAN_TOL)
    assert_allclose(h2_last.numpy(), np.asarray(jh2), rtol=SCAN_TOL,
                    atol=SCAN_TOL)


def test_scan_casts_to_f32():
    """bf16 inputs are cast to f32 as the TPU wrapper casts them."""
    bf = [torch.from_numpy(x).to(torch.bfloat16)
          for x in _scan_inputs(2, 20, 16)]
    h0, l0 = tlru_ops.rglru_scan(*bf)
    h1, l1 = tlru_ops.rglru_scan(*(t.float() for t in bf))
    assert h0.dtype == l0.dtype == torch.float32
    assert torch.equal(h0, h1) and torch.equal(l0, l1)


def test_scan_refuses_other_devices():
    z = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tlru_ops.rglru_scan(z, z, torch.zeros(1, 8, device="meta"))


# ------------------------------------------------------------------ block ---
def _rglru_params(jcfg, seed=20):
    return seeded(jrec.init_rglru(jax.random.key(seed), jcfg), seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_apply_matches_both_impls(dtype):
    """The port's one path (the K4 wrapper, its plain version on host
    tensors) against impl="pallas_interpret" and impl="xla"."""
    jcfg, tcfg = _cfgs(dtype)
    p = _rglru_params(jcfg)
    jx, tx = _pair(np.random.default_rng(21), (2, 32, jcfg.d_model), dtype)
    out = trec.rglru_apply(_to_torch(p), tcfg, tx)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(jx.shape)
    for impl in IMPLS:
        _close(out, jrec.rglru_apply(p, jcfg, jx, impl=impl), dtype, impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [21, 2], ids=["prompt21", "prompt2"])
def test_rglru_prefill_output_and_state(dtype, S):
    """Output and decode state against the reference's prefill (its XLA
    scan). A 2-token prompt keeps a 2-row conv state on both sides: the
    reference's quirk, mirrored."""
    jcfg, tcfg = _cfgs(dtype)
    p = _rglru_params(jcfg, 22)
    jx, tx = _pair(np.random.default_rng(23), (2, S, jcfg.d_model), dtype)
    jout, jstate = jrec.rglru_prefill(p, jcfg, jx)
    tout, tstate = trec.rglru_prefill(_to_torch(p), tcfg, tx)
    spec = trec.rglru_state_spec(tcfg, 2)
    jspec = jrec.rglru_state_spec(jcfg, 2)
    for k in ("conv", "h"):
        shape, dt = spec[k]
        assert shape == jspec[k].shape
        assert tstate[k].dtype == dt == TDT[str(jspec[k].dtype)]
        assert tuple(tstate[k].shape) == tuple(jstate[k].shape)
        assert tstate[k].is_contiguous()
    assert tuple(tstate["conv"].shape) == (
        (2, 3, 64) if S == 21 else (2, 2, 64))
    _close(tout, jout, dtype, "out")
    _close(tstate["conv"], jstate["conv"], dtype, "conv")
    # h is f32 in both dtypes; its error follows the inputs'
    _close(tstate["h"], jstate["h"], dtype, "h")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps_update_the_state_in_place(dtype):
    """Five decode steps from a prefilled state, the same tokens' hidden
    states on both sides; the port writes its state into the same
    storage."""
    jcfg, tcfg = _cfgs(dtype)
    p = _rglru_params(jcfg, 24)
    tp = _to_torch(p)
    rng = np.random.default_rng(25)
    jx, tx = _pair(rng, (2, 9, jcfg.d_model), dtype)
    _, jstate = jrec.rglru_prefill(p, jcfg, jx)
    _, tstate = trec.rglru_prefill(tp, tcfg, tx)
    ptrs = {k: v.data_ptr() for k, v in tstate.items()}
    for step in range(5):
        jx1, tx1 = _pair(rng, (2, 1, jcfg.d_model), dtype)
        jy, jstate = jrec.rglru_decode(p, jcfg, jx1, jstate)
        ty, tstate2 = trec.rglru_decode(tp, tcfg, tx1, tstate)
        assert tstate2 is tstate
        assert {k: v.data_ptr() for k, v in tstate.items()} == ptrs
        _close(ty, jy, dtype, f"y step {step}")
        _close(tstate["conv"], jstate["conv"], dtype, f"conv step {step}")
        _close(tstate["h"], jstate["h"], dtype, f"h step {step}")


# ------------------------------------------------------------------ model ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_loss_and_commit_taps_match(ref, dtype):
    """The 5-layer smoke model (one period of rglru, rglru, local and a
    tail of two rglru layers): loss, ce, per-layer checksums and nan bits
    against both reference impls."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp, jb, tb = _setup(jcfg, tcfg)
    tloss, (tmet, taux) = _port_loss(tcfg, tp, tb)
    tcks = tcommit.layer_checksums(taux)
    assert tuple(tcks.shape) == (jcfg.num_layers, 2)
    assert len(taux["tail"]) == 2
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
    """Model.prefill and four decode_steps against the reference's, logits
    and every state leaf. The prompt (20) is longer than the local
    layer's window (16), so the prefill places the last 16 keys in the
    ring and every decode step overwrites a slot."""
    jcfg, tcfg = _cfgs(dtype)
    _check(_run_both(jcfg, tcfg, jimpl=impl), dtype)


@pytest.mark.parametrize("batch,prompt_len,gen,interval",
                         [(2, 12, 8, 3), (3, 16, 9, 4)])
def test_serve_tokens_match_the_reference(ref, batch, prompt_len, gen,
                                          interval):
    """serve() on the host against the reference's serve loop, f32: the
    same greedy tokens, FIFO counts and CSRs. The second case fills the
    16-slot ring in the prefill and wraps it in the decode."""
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


@pytest.mark.parametrize("max_len", [20, 12])
def test_cache_spec_matches_the_reference(max_len):
    """The rglru states and the local layer's ring (window 16, or max_len
    where that is shorter) in the reference's layout."""
    jcfg, tcfg = _cfgs("bfloat16")
    jspec = jtfm.stack_cache_spec(jcfg, 2, max_len)
    tspec = ttfm.stack_cache_spec(tcfg, 2, max_len)
    for k in ("scanned", "tail"):
        mine = jax.tree.leaves(
            jax.tree.map(lambda s: (tuple(s[0]), str(s[1])[6:]), tspec[k],
                         is_leaf=lambda s: isinstance(s, tuple)
                         and len(s) == 2 and isinstance(s[1], torch.dtype)))
        theirs = jax.tree.leaves(jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), jspec[k]))
        assert mine == theirs
    assert tspec["scanned"][2]["k"][0] == (1, 2, min(16, max_len), 1, 16)


# ------------------------------------------------------------- Scale-Down ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_extraction_and_scanned_vs_unrolled(ref, dtype):
    """Every layer's standalone replay equals its in-situ run bit for bit
    and the reference's replay of the same block on the same boundary
    input; the stacked forward equals the unrolled one exactly."""
    jcfg, tcfg = _cfgs(dtype)
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _, jpos, tx, tpos = _inputs(jcfg, jp, tp)
    trt = Runtime(taps=TAPS)
    with torch.inference_mode():
        _, trecs = tdec.unrolled_capture(tp, tcfg, tx, tpos, trt)
        assert tdec.scanned_vs_unrolled(tp, tcfg, tx, tpos, trt) == 0.0
    B, S = tx.shape[:2]
    mixers = ["rglru", "rglru", "local", "rglru", "rglru"]
    for layer in range(tcfg.num_layers):
        with torch.inference_mode():
            rep = tdec.verify_extraction(tp, tcfg, tx, tpos, trt, layer)
        assert rep["bitwise_identical"] is True and rep["max_abs_diff"] \
            == 0.0, rep
        jsub = ref.decompose.extract_block(
            jp, jcfg, layer, JaxRuntime(taps=TAPS,
                                        attention_impl="pallas_interpret"),
            B, S)
        assert rep["subsystem"] == jsub.name \
            == f"layer{layer}:{mixers[layer]}+mlp"
        x_in = trecs[layer]["x_in"].float().numpy()
        jreplay = jsub.fn(jnp.asarray(x_in).astype(JDT[dtype]), jpos)
        _close(trecs[layer]["x_out"], jreplay, dtype, f"layer {layer}")


# ---------------------------------------------------------------- interop ---
def test_interop_round_trip_keeps_the_f32_leaves_bitwise():
    """bf16 model with an f32 Lambda and biased gate denses: every leaf
    crosses exactly, both ways."""
    jcfg = jax_smoke(ARCH)
    jp = seeded_params(jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, get_smoke_config(ARCH), "cpu")
    rp = tp["stack"]["blocks"][0]["rglru"]
    assert rp["in_x"]["w"].dtype == torch.bfloat16
    assert rp["Lambda"].dtype == torch.float32
    assert tuple(rp["Lambda"].shape) == (1, 64)
    assert set(rp["gate_a"]) == set(rp["gate_x"]) == {"w", "b"}
    assert torch.equal(
        tp["stack"]["tail"][1]["rglru"]["Lambda"],
        torch.from_numpy(np.array(np_tree["stack"]["tail"][1]["rglru"]
                                  ["Lambda"])))
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32),
                              b.astype(np.float32).view(np.uint32))


def test_lambda_init_lies_in_the_reference_range():
    """The port's own init draws Lambda as the reference does: a^c =
    exp(-8 softplus(Lambda)) in (0.9, 0.999), f32."""
    p = trec.init_rglru(torch.Generator().manual_seed(0),
                        get_smoke_config(ARCH), "cpu")
    lam = p["Lambda"]
    assert lam.dtype == torch.float32 and tuple(lam.shape) == (64,)
    ac = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(ac.min()) >= 0.9 - 1e-6 and float(ac.max()) <= 0.999 + 1e-6


# ------------------------------------------------------- K1, K2 at hd 256 ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window", [(96, 48), (70, 0)])
def test_flash_attention_plain_at_head_dim_256(S, window, dtype):
    """recurrentgemma's local attention shape, narrowed: H=10 query heads
    on one kv head, head_dim 256, causal with and without a window,
    against the reference's Pallas kernel (interpret) and its oracle."""
    _fa_both(30, 1, S, 10, 1, 256, dtype, causal=True, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [30, 47, 48, 70], ids=lambda p: f"pos{p}")
def test_decode_attention_plain_at_head_dim_256(pos, dtype):
    """A 48-slot ring, G=10, head_dim 256: filling (30), just full (47)
    and wrapped (48, 70), against the reference's Pallas kernel
    (interpret) and its oracle."""
    B, H, K, W, hd = 2, 10, 1, 48, 256
    rng = np.random.default_rng(31)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, W, K, hd), (B, W, K, hd))]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    out = tda_ops.decode_attention(
        *(torch.from_numpy(a).to(TDT[dtype]) for a in arrs),
        pos=torch.tensor(pos, dtype=torch.int32), window=W)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (B, H, hd)
    pallas = jda_ops.decode_attention(*jx, pos=jnp.int32(pos), window=W,
                                      block_k=16, interpret=True)
    oracle = jda_ref(*jx, pos=pos, window=W)
    tol = KTOL[dtype]
    for want in (pallas, oracle):
        assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                        rtol=tol, atol=tol)
