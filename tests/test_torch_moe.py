"""The port's MoE slice (qwen3-moe-30b-a3b, mixtral-8x7b) against the JAX
package on the CPU: K5's plain version against the reference's kernel
(interpret mode) and its oracle, the expert FFN it composes into, the
router, the sort dispatch and combine index for index (a capacity
overflow included), moe_apply in both impls with its stats, the MoE
block, the 2-layer smoke models (logits, loss with the aux loss,
checksums, expert toggles through make_ingest into the P-Shell), greedy
serve tokens, the Scale-Down replay and the interop round trip. Weights
are the reference's param trees redrawn from numpy (``jax_weights``) and
carried across; inputs are numpy arrays from a seed, handed to both
sides.

Tolerances: K5 at the reference's own (tests/test_kernels.py ``tol``:
2e-5 in f32, 2e-2 in bf16), the composed expert FFN at its 1e-4. Modules
in f32 within 1e-5 of the output's largest magnitude; in bf16 at 3e-2
elementwise and 2e-2 normwise (``test_torch_ssm._close``: the two
frameworks round to bf16 at different points, e.g. inside silu). Router
probabilities and gates at 1e-6 in f32; expert ids, slots, keep flags,
orders and counts exactly. The model's loss, aux loss and checksums at
the co-emulator's relative error, 1e-5 in f32 and 5e-2 in bf16, as
test_torch_forward.py holds the dense family.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.grouped_gemm import ops as jgg_ops  # noqa: E402
from repro.kernels.grouped_gemm.ref import (  # noqa: E402
    grouped_gemm_ref as jgg_ref, moe_ffn_ref as jffn_ref)
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import commit as tcommit  # noqa: E402
from repro_torch.core import decompose as tdec  # noqa: E402
from repro_torch.core.pshell import drain, shell_init  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.kernels.grouped_gemm import ops as tgg_ops  # noqa: E402
from repro_torch.kernels.grouped_gemm.ref import (  # noqa: E402
    grouped_gemm_ref as tgg_ref, moe_ffn_ref as tffn_ref)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from jax_weights import seeded, seeded_params  # noqa: E402
from test_torch_decompose import _inputs  # noqa: E402
from test_torch_forward import _rel_close, _setup  # noqa: E402
from test_torch_model import _check, _run_both  # noqa: E402
from test_torch_modules import JDT, TDT, _pair, _to_torch  # noqa: E402
from test_torch_serve import _jax_serve  # noqa: E402
from test_torch_ssm import _close, ref  # noqa: E402,F401

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
ROUTER = frozenset({"commits", "coverage", "router"})
KTOL = {"float32": 2e-5, "bfloat16": 2e-2}
FFN_TOL = 1e-4
PROB_TOL = 1e-6
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


# --------------------------------------------------------------------- K5 ---
def _gemm_inputs(E, M, K, N, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, M, K)).astype(np.float32),
            rng.standard_normal((E, K, N)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,K,N", [(4, 128, 64, 128), (3, 50, 33, 17),
                                     (1, 8, 8, 8), (8, 256, 128, 64)])
def test_plain_grouped_gemm_matches_the_reference_kernel(E, M, K, N, dtype):
    """K5's plain version (the wrapper on host tensors) against the TPU
    kernel in interpret mode and its oracle, on the reference's grid."""
    xa, wa = _gemm_inputs(E, M, K, N)
    tx, tw = (torch.from_numpy(a).to(TDT[dtype]) for a in (xa, wa))
    before = tgg_ops.grouped_gemm.launches
    out = tgg_ops.grouped_gemm(tx, tw)
    assert tgg_ops.grouped_gemm.launches == before    # no kernel on host
    assert out.dtype == TDT[dtype] and tuple(out.shape) == (E, M, N)
    jx, jw = (jnp.asarray(a).astype(JDT[dtype]) for a in (xa, wa))
    tol = KTOL[dtype]
    for want in (jgg_ops.grouped_gemm(jx, jw, block_m=32, block_n=32,
                                      block_k=32, interpret=True),
                 jgg_ref(jx, jw)):
        assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                        rtol=tol, atol=tol)


def test_moe_ffn_matches_the_reference():
    """The composed expert FFN (three K5 calls), the reference's test
    shape, against its Pallas composition and its oracle at 1e-4."""
    rng = np.random.default_rng(5)
    E, C, D, F = 4, 64, 32, 48
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((E, C, D), (E, D, F), (E, D, F), (E, F, D))]
    before = tgg_ops.grouped_gemm.launches
    out = tgg_ops.moe_ffn(*(torch.from_numpy(a) for a in arrs))
    assert tgg_ops.grouped_gemm.launches == before
    assert torch.equal(out, tffn_ref(*(torch.from_numpy(a) for a in arrs)))
    j = [jnp.asarray(a) for a in arrs]
    for want in (jgg_ops.moe_ffn(*j, interpret=True), jffn_ref(*j)):
        assert_allclose(out.numpy(), np.asarray(want), rtol=FFN_TOL,
                        atol=FFN_TOL)


def test_grouped_gemm_refuses_other_devices():
    z = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgg_ops.grouped_gemm(z, torch.zeros(1, 8, 4, device="meta"))


def test_grouped_gemm_plain_rounds_once_from_f32():
    """bf16 in, products and sums in f32, one rounding to bf16 at the end,
    as the reference's einsum with preferred_element_type=f32."""
    xa, wa = _gemm_inputs(2, 9, 40, 7, seed=8)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (xa, wa))
    out = tgg_ref(tx, tw)
    want = torch.einsum("emk,ekn->emn", tx.double(), tw.double())
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.float().to(torch.bfloat16))


# ----------------------------------------------------------------- router ---
def _moe_params(jcfg, seed=40):
    return seeded(jmoe.init_moe(jax.random.key(seed), jcfg), seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(arch):
    """Top-k experts in the same order, gates and probabilities at 1e-6."""
    jcfg, tcfg = _cfgs(arch, "float32")
    p = _moe_params(jcfg)
    jx, tx = _pair(np.random.default_rng(41), (48, jcfg.d_model), "float32")
    jg, ji, jpr = jmoe._route(p, jcfg, jx)
    tg, ti, tpr = tmoe._route(_to_torch(p), tcfg, tx)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert_allclose(tg.numpy(), np.asarray(jg), rtol=PROB_TOL, atol=PROB_TOL)
    assert_allclose(tpr.numpy(), np.asarray(jpr), rtol=PROB_TOL,
                    atol=PROB_TOL)


@pytest.mark.parametrize("T", [1, 8, 48, 1000, 8192])
def test_capacity_matches(T):
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, "float32")
        E = tcfg.num_experts
        assert tmoe._capacity(tcfg, T, E) == jmoe._capacity(jcfg, T, E)
    # qwen3-moe-30b-a3b at the forward, serve-prefill and decode shapes
    q = get_config("qwen3-moe-30b-a3b")
    assert [tmoe._capacity(q, t, 128) for t in (8192, 16384, 8)] \
        == [640, 1280, 8]


def _skewed_idx(rng, T, E, k):
    """Top-k expert ids, distinct per token, most tokens on experts 0 and
    1, so their capacity overflows."""
    w = np.full(E, 1.0)
    w[:2] = 8.0
    return np.stack([rng.choice(E, size=k, replace=False, p=w / w.sum())
                     for _ in range(T)]).astype(np.int32)


@pytest.mark.parametrize("case", ["routed", "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sort_dispatch_and_combine_match_index_for_index(arch, case):
    """slot, keep, inv_order and counts equal exactly, the dispatched
    batches and the combined output match; ``overflow`` sends most
    entries to two experts, so tokens are dropped on both sides."""
    jcfg, tcfg = _cfgs(arch, "float32")
    T, D, E, k = 48, jcfg.d_model, jcfg.num_experts, jcfg.num_experts_per_tok
    rng = np.random.default_rng(42)
    jx, tx = _pair(rng, (T, D), "float32")
    if case == "routed":
        p = _moe_params(jcfg)
        jg, ji, _ = jmoe._route(p, jcfg, jx)
        idx = np.array(ji)
        gates = np.array(jg)
    else:
        idx = _skewed_idx(rng, T, E, k)
        gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    jd, jslot, jkeep, jinv, jcounts = jmoe._sort_dispatch(
        jcfg, jx, jnp.asarray(idx))
    td, tslot, tkeep, tinv, tcounts = tmoe._sort_dispatch(
        tcfg, tx, torch.from_numpy(idx).long())
    C = tmoe._capacity(tcfg, T, E)
    assert tuple(td.shape) == tuple(jd.shape) == (E, C, D)
    for mine, theirs in ((tslot, jslot), (tkeep, jkeep), (tinv, jinv),
                         (tcounts, jcounts)):
        assert np.array_equal(mine.numpy(), np.asarray(theirs))
    assert torch.equal(td, torch.from_numpy(np.array(jd)))
    if case == "overflow":
        assert not bool(tkeep.all())
    ry = np.random.default_rng(43).standard_normal((E, C, D)) \
        .astype(np.float32)
    jy = jmoe._sort_combine(jcfg, jnp.asarray(ry), jslot, jkeep, jinv,
                            jnp.asarray(gates), T, D)
    ty = tmoe._sort_combine(tcfg, torch.from_numpy(ry), tslot, tkeep, tinv,
                            torch.from_numpy(gates), T, D)
    assert ty.dtype == torch.float32
    _close(ty, jy, "float32", "combine")


# -------------------------------------------------------------- moe_apply ---
def _stats_close(ts, js, dtype, what):
    assert set(ts) == set(js) == {"expert_toggles", "load", "aux_loss",
                                  "dropped_frac"}
    assert np.array_equal(ts["expert_toggles"].numpy(),
                          np.asarray(js["expert_toggles"])), what
    assert float(ts["dropped_frac"]) == float(js["dropped_frac"]), what
    if dtype == "float32":
        assert_allclose(ts["load"].numpy(), np.asarray(js["load"]),
                        rtol=PROB_TOL, atol=PROB_TOL, err_msg=what)
    _rel_close(ts["aux_loss"], js["aux_loss"], RTOL[dtype], what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["sort", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_both_impls(arch, impl, dtype):
    """With a capacity that drops nothing, both impls of the port against
    both of the reference: outputs and stats."""
    jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=8.0)
    p = _moe_params(jcfg)
    jx, tx = _pair(np.random.default_rng(44), (2, 24, jcfg.d_model), dtype)
    ty, ts = tmoe.moe_apply(_to_torch(p), tcfg, tx, impl=impl)
    assert ty.dtype == TDT[dtype] and tuple(ty.shape) == tuple(jx.shape)
    assert float(ts["dropped_frac"]) == 0.0
    for jimpl in ("sort", "dense"):
        jy, js = jmoe.moe_apply(p, jcfg, jx, impl=jimpl)
        _close(ty, jy, dtype, f"{impl} vs {jimpl}")
        _stats_close(ts, js, dtype, f"{impl} vs {jimpl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sort_drops_the_same_tokens(arch, dtype):
    """Capacity factor 0.5: every expert's overflow is dropped, the same
    entries on both sides (dropped_frac > 0 and equal), the outputs
    match."""
    jcfg, tcfg = _cfgs(arch, dtype, capacity_factor=0.5)
    p = _moe_params(jcfg, 45)
    jx, tx = _pair(np.random.default_rng(46), (2, 24, jcfg.d_model), dtype)
    ty, ts = tmoe.moe_apply(_to_torch(p), tcfg, tx, impl="sort")
    jy, js = jmoe.moe_apply(p, jcfg, jx, impl="sort")
    assert float(ts["dropped_frac"]) > 0.0
    _stats_close(ts, js, dtype, "dropped")
    _close(ty, jy, dtype, "sort with drops")


def test_runtime_refuses_the_sharded_dispatch():
    with pytest.raises(NotImplementedError, match="sharded model slice"):
        Runtime(moe_impl="a2a")
    with pytest.raises(NotImplementedError, match="sharded model slice"):
        Runtime(mesh=object())
    # seq_parallel and cost_mode are not fields until their slices
    with pytest.raises(TypeError):
        Runtime(seq_parallel=True)
    with pytest.raises(TypeError):
        Runtime(cost_mode="flops")
    with pytest.raises(ValueError, match="requires a mesh"):
        tmoe.moe_apply({}, None, torch.zeros(1, 1, 1), impl="a2a")
    with pytest.raises(ValueError, match="unknown moe impl"):
        Runtime(moe_impl="ragged")
    rt = Runtime()
    assert (rt.moe_impl, rt.aux_loss_coef) == ("sort", 0.01)


# ------------------------------------------------------------------ block ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_and_its_taps_match(arch, dtype):
    """block_apply of the (attention, moe) block: the output, the router
    tap's full stats, the coverage tap's toggles alone, and the aux loss
    under no tap at all."""
    jcfg, tcfg = _cfgs(arch, dtype)
    spec = jcfg.layer_pattern[0]
    p = seeded(jtfm.init_block(jax.random.key(47), jcfg, spec), 47)
    tp = _to_torch(p)
    B, S = 2, 20
    jx, tx = _pair(np.random.default_rng(48), (B, S, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    for taps, keys in ((ROUTER, {"expert_toggles", "load", "aux_loss",
                                 "dropped_frac"}),
                       (frozenset({"coverage"}), {"expert_toggles"}),
                       (frozenset(), None)):
        jy, jaux = jtfm.block_apply(p, jcfg, spec, jx, jnp.asarray(pos),
                                    JaxRuntime(taps=taps))
        with torch.inference_mode():
            ty, taux = ttfm.block_apply(tp, tcfg, spec, tx,
                                        torch.from_numpy(pos),
                                        Runtime(taps=taps))
        _close(ty, jy, dtype, f"block {sorted(taps)}")
        assert set(taux) == set(jaux)
        _rel_close(taux["moe_aux_loss"], jaux["moe_aux_loss"], RTOL[dtype],
                   "aux loss")
        if keys is None:
            assert "moe" not in taux
            continue
        assert set(taux["moe"]) == set(jaux["moe"]) == keys
        if len(keys) > 1:
            _stats_close(taux["moe"], jaux["moe"], dtype, "router tap")


# ------------------------------------------------------------------ model ---
def _losses(jcfg, tcfg, B=2, S=24):
    jp, tp, jb, tb = _setup(jcfg, tcfg, B=B, S=S)
    with torch.inference_mode():
        tout = build_model(tcfg, Runtime(taps=ROUTER)).loss(tp, tb)
    jm = jax_build(jcfg, JaxRuntime(taps=ROUTER))
    return tout, jax.jit(jm.loss)(jp, jb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_aux_and_commit_taps_match(ref, arch, dtype):
    """The 2-layer smoke model: loss = ce + 0.01 * moe_aux, each term, the
    per-layer checksums and nan bits, the expert toggles, and the P-Shell
    after make_ingest (commit rows, the (2, E) expert-toggle CSR, the
    declared and empty router FIFO) against the reference's."""
    jcfg, tcfg = _cfgs(arch, dtype)
    (tloss, (tmet, taux)), (jloss, (jmet, jaux)) = _losses(jcfg, tcfg)
    rtol = RTOL[dtype]
    for name in ("loss", "ce", "moe_aux"):
        _rel_close(tmet[name], jmet[name], rtol, name)
    assert float(tmet["moe_aux"]) > 0.0
    assert torch.equal(tloss, tmet["loss"])
    assert torch.equal(tmet["loss"], tmet["ce"] + 0.01 * tmet["moe_aux"])
    _rel_close(tcommit.layer_checksums(taux),
               ref.commit.layer_checksums(jaux), rtol, "checksums")
    assert np.array_equal(tcommit.nan_bits(taux).numpy(),
                          np.asarray(ref.commit.nan_bits(jaux)))
    ttg = tcommit.moe_toggles(taux)
    assert tuple(ttg.shape) == (2, tcfg.num_experts)
    assert np.array_equal(ttg.numpy(),
                          np.asarray(ref.commit.moe_toggles(jaux)))
    tspec = tcommit.default_shell_config(tcfg)
    jspec = ref.commit.default_shell_config(jcfg)
    assert {k: tuple(s) for k, (s, _) in tspec.csrs.items()} \
        == {k: tuple(v.shape) for k, v in jspec.csrs.items()}
    assert {k: (f.depth, f.shape) for k, f in tspec.fifos.items()} \
        == {k: (f.depth, f.shape) for k, f in jspec.fifos.items()}
    trec, _ = drain(tcommit.make_ingest(tcfg)(shell_init(tspec), taux,
                                              tmet))
    jrec, _ = ref.drain(ref.commit.make_ingest(jcfg)(
        ref.shell_init(jspec), jaux, jmet))
    assert np.array_equal(trec["csrs"]["expert_toggles"],
                          jrec["csrs"]["expert_toggles"])
    assert trec["csrs"]["expert_toggles"].any()
    assert trec["fifos"]["commits"]["count"] \
        == jrec["fifos"]["commits"]["count"] == 2
    assert trec["fifos"]["router"]["count"] \
        == jrec["fifos"]["router"]["count"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_with_the_dense_impl(arch):
    """Runtime(moe_impl="dense") reaches the dense oracle through the
    model: the same loss as the reference's dense impl, in f32."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp, tp, jb, tb = _setup(jcfg, tcfg)
    with torch.inference_mode():
        tloss, _ = build_model(tcfg, Runtime(moe_impl="dense")).loss(tp, tb)
    jloss, _ = jax.jit(jax_build(jcfg, JaxRuntime(moe_impl="dense")).loss)(
        jp, jb)
    _rel_close(tloss, jloss, RTOL["float32"], "dense loss")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype):
    """Model.prefill and four decode_steps (the sort dispatch over the
    batch's tokens) against the reference's, logits and every cache leaf;
    mixtral's 16-slot window rings wrap in the decode.

    In bf16 the reference runs op by op (``jax.disable_jit``). Jitted,
    XLA fuses its attention and rounds the result differently, and in
    mixtral's smoke prefill one token of layer 0 (row 38, a top-2 margin
    of 4.8e-4 in the router's probabilities) then takes another expert:
    the jitted reference is 5.9e-2 normwise from its own op-by-op run in
    that layer's output, and the layer-1 keys 6.5e-2. The port routes
    that token as the op-by-op reference does."""
    jcfg, tcfg = _cfgs(arch, dtype)
    _check(_run_both(jcfg, tcfg, jimpl="xla", jit=dtype == "float32"),
           dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_match_the_reference(ref, arch):
    """serve() on the host against the reference's serve loop, f32: the
    same greedy tokens, FIFO counts and CSRs."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp = seeded_params(jcfg)
    batch, prompt_len, gen, interval = 3, 16, 9, 4
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


# ------------------------------------------------------------- Scale-Down ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_extraction_and_scanned_vs_unrolled(ref, arch, dtype):
    """Every layer's standalone replay equals its in-situ run bit for bit
    and the reference's replay of the same block on the same boundary
    input; the stacked forward equals the unrolled one exactly."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    _, jpos, tx, tpos = _inputs(jcfg, jp, tp)
    trt = Runtime(taps=ROUTER)
    with torch.inference_mode():
        _, trecs = tdec.unrolled_capture(tp, tcfg, tx, tpos, trt)
        assert tdec.scanned_vs_unrolled(tp, tcfg, tx, tpos, trt) == 0.0
    B, S = tx.shape[:2]
    mixer = tcfg.layer_pattern[0][0]
    for layer in range(tcfg.num_layers):
        with torch.inference_mode():
            rep = tdec.verify_extraction(tp, tcfg, tx, tpos, trt, layer)
        assert rep["bitwise_identical"] is True and rep["max_abs_diff"] \
            == 0.0, rep
        jsub = ref.decompose.extract_block(jp, jcfg, layer,
                                           JaxRuntime(taps=ROUTER), B, S)
        assert rep["subsystem"] == jsub.name == f"layer{layer}:{mixer}+moe"
        x_in = trecs[layer]["x_in"].float().numpy()
        jreplay = jsub.fn(jnp.asarray(x_in).astype(JDT[dtype]), jpos)
        _close(trecs[layer]["x_out"], jreplay, dtype, f"layer {layer}")


# ---------------------------------------------------------------- interop ---
def test_interop_round_trip_keeps_the_expert_leaves_bitwise():
    """bf16 model: the stacked (n_periods, E, D, F) expert leaves and the
    f32 router cross over exactly, both ways."""
    jcfg = jax_smoke("qwen3-moe-30b-a3b")
    jp = seeded_params(jcfg)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, get_smoke_config("qwen3-moe-30b-a3b"),
                         "cpu")
    mp = tp["stack"]["blocks"][0]["moe"]
    E, D, F = jcfg.num_experts, jcfg.d_model, jcfg.moe_d_ff
    assert tuple(mp["gate"].shape) == tuple(mp["up"].shape) == (2, E, D, F)
    assert tuple(mp["down"].shape) == (2, E, F, D)
    assert mp["gate"].dtype == torch.bfloat16
    assert mp["router"]["w"].dtype == torch.float32
    assert tuple(mp["router"]["w"].shape) == (2, D, E)
    assert torch.equal(mp["router"]["w"], torch.from_numpy(np.array(
        np_tree["stack"]["blocks"][0]["moe"]["router"]["w"])))
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32),
                              b.astype(np.float32).view(np.uint32))
    # the full config's layout, which params_from_jax checks leaf by leaf
    full = build_model(get_config("qwen3-moe-30b-a3b")).init(device="meta")
    fm = full["stack"]["blocks"][0]["moe"]
    jfull = jax.eval_shape(lambda: jax_build(jax_config(
        "qwen3-moe-30b-a3b")).init(jax.random.key(0)))["stack"]["blocks"][
        0]["moe"]
    for name in ("gate", "up", "down"):
        assert tuple(fm[name].shape) == jfull[name].shape
        assert fm[name].dtype == torch.bfloat16
    assert tuple(fm["gate"].shape) == (48, 128, 2048, 768)
    assert tuple(fm["router"]["w"].shape) == jfull["router"]["w"].shape \
        == (48, 2048, 128)
    assert fm["router"]["w"].dtype == torch.float32 \
        and jfull["router"]["w"].dtype == jnp.float32


def test_redrawn_expert_weights_have_the_reference_scales():
    """``jax_weights`` redraws a leaf of shape (..., d_in, d_out) at
    d_in ** -0.5: for the MoE leaves that is the reference's own scale
    (router and gate/up D ** -0.5, down F ** -0.5), checked on a widened
    config against the reference's init and the redraw alike; dtypes are
    kept (router f32)."""
    jcfg = dataclasses.replace(jax_smoke("qwen3-moe-30b-a3b"), d_model=256,
                               num_experts=64, moe_d_ff=192)
    D, F = jcfg.d_model, jcfg.moe_d_ff
    orig = jmoe.init_moe(jax.random.key(49), jcfg)
    red = seeded(orig, 49)
    want = {"router": D ** -0.5, "gate": D ** -0.5, "up": D ** -0.5,
            "down": F ** -0.5}
    for name, scale in want.items():
        a = orig[name]["w"] if name == "router" else orig[name]
        b = red[name]["w"] if name == "router" else red[name]
        assert a.dtype == b.dtype
        for leaf in (a, b):
            std = float(np.asarray(leaf, np.float32).std())
            assert abs(std / scale - 1.0) < 0.05, (name, std, scale)
    assert red["router"]["w"].dtype == jnp.float32


def test_port_init_follows_the_reference_layout():
    """The port's own MoE init: shapes, dtypes and scales of the
    reference's."""
    tcfg = get_smoke_config("qwen3-moe-30b-a3b")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    jshapes = jax.eval_shape(
        lambda: jmoe.init_moe(jax.random.key(0), jax_smoke(
            "qwen3-moe-30b-a3b")))
    for name in ("gate", "up", "down"):
        assert tuple(p[name].shape) == jshapes[name].shape
        assert str(p[name].dtype)[6:] == str(jshapes[name].dtype)
    assert p["router"]["w"].dtype == torch.float32
    assert tuple(p["router"]["w"].shape) == jshapes["router"]["w"].shape
    block = ttfm.init_block(None, tcfg, ("attn", "moe"), "meta")
    assert set(block) == {"norm1", "attn", "norm2", "moe"}
