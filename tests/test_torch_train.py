"""The port's train step (``repro_torch.train``) against the JAX package's
``repro.train`` on the CPU, from the same weights (``jax_weights``) and
state (carried across with ``interop.state_from_jax``) and the same
batches, and the "xla" functions it differentiates against the
reference's ``impl="xla"`` ones.

Limits:
  * the optimizer on identical gradients: params within 1 ulp of the
    reference's, the gradient norm within 1e-6 (a sum of squares in
    another order), the moments within 2 f32 ulps of
    each tensor's largest element (the frameworks may round a fused f32
    expression once and twice, and the moment sums can cancel), the
    schedule to the bit;
  * the "xla" functions in f32: outputs and gradients within OUT_TOL and
    GRAD_TOL of the reference's, elementwise relative to each tensor's
    largest magnitude (the scans and products sum in another order);
  * a train step in f32: loss and gradient norm within STEP_RTOL; the
    first step's first moment m = 0.1 * clip * g (the gradients) within
    GRAD_TOL of each leaf's largest; after three steps every parameter
    within LR_ATOL times the summed learning rates, since a gradient
    element near zero can change sign between the frameworks and an
    early Adam update is about lr * sign(g); in bf16 (glm4 smoke) the
    loss at the co-emulator's relative error BF16_RTOL and parameters
    within LR_ATOL * sum(lr) plus one bf16 ulp of their magnitude.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.interop import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.train import compress as tcomp  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from repro_torch.train import (OptConfig, init_state,  # noqa: E402
                               make_train_step, state_specs)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from jax_weights import seeded_params  # noqa: E402

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_RTOL = 1e-5
LR_ATOL = 3.0
BF16_RTOL = 2e-2
FAMILIES = ["glm4-9b", "falcon-mamba-7b", "recurrentgemma-2b",
            "qwen3-moe-30b-a3b"]


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _ulps(a, b):
    """Largest distance in units in the last place of ``a``'s dtype (f32,
    or bf16 compared through f32) between arrays of one sign pattern."""
    step = 1 << 16 if torch.is_tensor(a) and a.dtype == torch.bfloat16 \
        else 1
    a = np.ascontiguousarray(_np(a), np.float32).view(np.int32)
    b = np.ascontiguousarray(_np(b), np.float32).view(np.int32)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) \
        // step


def _within_ulp_of_largest(a, b, what):
    """|a - b| within two f32 ulps of the largest |b| of the tensor: a sum
    that cancels (b1 m + (1 - b1) g) may be rounded once (fused) on one
    side and twice on the other, which is an ulp of its terms, not of
    the small result."""
    a, b = _np(a), _np(b)
    err = float(np.abs(a - b).max())
    assert err <= 2 * 2.0 ** -23 * float(np.abs(b).max()), (what, err)


def _rel_close(a, b, tol, what):
    a, b = _np(a), _np(b)
    scale = max(float(np.abs(b).max()), 1e-30)
    err = float(np.abs(a - b).max()) / scale
    assert err <= tol, f"{what}: {err} > {tol}"


# -------------------------------------------------------------- optimizer --
def _opt_inputs(seed):
    """Params (bf16 matrix, f32 vector, f32 stacked), grads, moments."""
    rng = np.random.default_rng(seed)
    shapes = {"a": ((8, 16), "bfloat16"), "b": ((16,), "float32"),
              "c": ((2, 4, 8), "float32")}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in
         shapes.items()}
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in
         p.items()}
    m = {k: 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    v = {k: 0.01 * rng.random(x.shape).astype(np.float32)
         for k, x in p.items()}
    dts = {k: d for k, (_, d) in shapes.items()}
    return p, g, m, v, dts


def _both(x, dtype):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("count", [0, 5, 300])
@pytest.mark.parametrize("grad_scale,clip", [(1.0, 1.0), (1e3, 1.0),
                                             (1.0, 0.0)])
def test_adamw_update_matches_the_reference_on_identical_grads(
        count, grad_scale, clip):
    p, g, m, v, dts = _opt_inputs(count)
    cfg = dict(grad_clip=clip, warmup_steps=10)
    jp, tp = {}, {}
    jg, tg = {}, {}
    for k in p:
        jp[k], tp[k] = _both(p[k], dts[k])
        jg[k], tg[k] = _both(g[k] * grad_scale, dts[k])
    jopt = {"m": {k: jnp.asarray(x) for k, x in m.items()},
            "v": {k: jnp.asarray(x) for k, x in v.items()},
            "count": jnp.int32(count)}
    topt = {"m": {k: torch.from_numpy(x.copy()) for k, x in m.items()},
            "v": {k: torch.from_numpy(x.copy()) for k, x in v.items()},
            "count": torch.tensor(count, dtype=torch.int32)}
    for _ in range(3):          # three chained steps on the same grads
        jp, jopt, jmet = joptim.adamw_update(joptim.OptConfig(**cfg), jp,
                                             jg, jopt)
        tp, topt, tmet = toptim.adamw_update(OptConfig(**cfg), tp, tg, topt)
        for k in p:
            assert _ulps(tp[k], jp[k]) <= 1, k
            _within_ulp_of_largest(topt["m"][k], jopt["m"][k], k)
            _within_ulp_of_largest(topt["v"][k], jopt["v"][k], k)
        assert int(topt["count"]) == int(jopt["count"])
        gn, jgn = float(tmet["grad_norm"]), float(jmet["grad_norm"])
        assert abs(gn - jgn) <= 1e-6 * jgn, (gn, jgn)
        assert _ulps(tmet["lr"], jmet["lr"]) == 0


def test_adamw_update_in_place_equals_the_pure_update():
    p, g, m, v, dts = _opt_inputs(1)
    tp = {k: torch.from_numpy(x).to(getattr(torch, dts[k]))
          for k, x in p.items()}
    tg = {k: torch.from_numpy(x) for k, x in g.items()}
    opt = {"m": {k: torch.from_numpy(x.copy()) for k, x in m.items()},
           "v": {k: torch.from_numpy(x.copy()) for k, x in v.items()},
           "count": torch.tensor(3, dtype=torch.int32)}
    before = tree_map(torch.clone, (tp, opt))
    pure_p, pure_opt, _ = toptim.adamw_update(OptConfig(), tp, tg, opt)
    for a, b in zip(tree_leaves(before), tree_leaves((tp, opt))):
        assert torch.equal(a, b)            # the pure update wrote nothing
    ptrs = [t.data_ptr() for t in tree_leaves((tp, opt))]
    new_p, new_opt, _ = toptim.adamw_update(OptConfig(), tp, tg, opt,
                                            inplace=True)
    assert [t.data_ptr() for t in tree_leaves((new_p, new_opt))] == ptrs
    for a, b in zip(tree_leaves((pure_p, pure_opt)),
                    tree_leaves((new_p, new_opt))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_global_norm_and_the_clip_match_the_reference(scale):
    p, g, _, _, dts = _opt_inputs(7)
    jg = {k: jnp.asarray(x * scale) for k, x in g.items()}
    tg = {k: torch.from_numpy(x * scale) for k, x in g.items()}
    assert _ulps(toptim.global_norm(tg), joptim.global_norm(jg)) <= 1
    # the clip: grads scaled to norm 1 and the unclipped ones give the
    # same update once the norm exceeds grad_clip
    norm = float(toptim.global_norm(tg))
    tp = {k: torch.from_numpy(x) for k, x in p.items()}
    opt = toptim.adamw_init(tp)
    a, _, ma = toptim.adamw_update(OptConfig(), tp, tg, opt)
    unit = {k: v / norm for k, v in tg.items()}
    b, _, _ = toptim.adamw_update(OptConfig(), tp, unit, opt)
    assert float(ma["grad_norm"]) == norm
    if norm > 1.0:
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)


def test_warmup_schedule_matches_the_reference_to_the_bit():
    for warm in (1, 10, 100):
        cfg = OptConfig(warmup_steps=warm)
        jcfg = joptim.OptConfig(warmup_steps=warm)
        counts = np.arange(0, 3 * warm + 2, dtype=np.int32)
        t = np.array([float(toptim._schedule(cfg, torch.tensor(c)))
                      for c in counts], np.float32)
        j = np.array([float(joptim._schedule(jcfg, jnp.int32(c)))
                      for c in counts], np.float32)
        np.testing.assert_array_equal(t, j)
        assert t[-1] == np.float32(cfg.lr)


# ------------------------------------------------------------ compression --
@pytest.mark.parametrize("scale,n", [(1e-3, 4), (0.37, 17), (1.0, 64),
                                     (12.5, 33), (1e3, 8)])
def test_ef_compression_conservation_and_the_reference(scale, n):
    """EF invariant g_hat + residual' == g + residual (f32), quantization
    error at most one scale step, and each output equal to the
    reference's."""
    rng = np.random.default_rng(n)
    g = (rng.standard_normal(n) * scale).astype(np.float32)
    r = (rng.standard_normal(n) * scale * 0.1).astype(np.float32)
    tg, tr = torch.from_numpy(g), torch.from_numpy(r)
    g_hat, r2 = tcomp.ef_compress_leaf(tg, tr)
    np.testing.assert_allclose(_np(g_hat + r2), _np(tg + tr), rtol=1e-6,
                               atol=1e-6)
    q, s = tcomp.quantize(tg + tr)
    assert q.dtype == torch.int8
    assert float((tcomp.dequantize(q, s) - (tg + tr)).abs().max()) \
        <= float(s)
    jq, js = jcomp.quantize(jnp.asarray(g + r))
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    assert _ulps(s, js) <= 1
    jg_hat, jr2 = jcomp.ef_compress_leaf(jnp.asarray(g), jnp.asarray(r))
    assert _ulps(g_hat, jg_hat) <= 1
    np.testing.assert_allclose(_np(r2), np.asarray(jr2), rtol=0,
                               atol=2 * float(s) * 2 ** -23 + 1e-30)


def test_ef_sgd_converges_on_quadratic():
    A = torch.diag(torch.tensor([1.0, 0.5, 0.1, 2.0]))
    b = torch.tensor([1.0, -2.0, 3.0, 0.5])
    x = torch.zeros(4)
    r = torch.zeros(4)
    for _ in range(400):
        g_hat, r = tcomp.ef_compress_leaf(A @ x - b, r)
        x = x - 0.3 * g_hat
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(A, b).numpy(),
                               rtol=1e-2, atol=1e-2)


def test_compressor_tree_and_the_collective_waits():
    grads = {"a": torch.randn(3, 4), "b": [torch.randn(5)]}
    res = tcomp.init_residuals(grads)
    g_hat, res2 = tcomp.make_compressor()(grads, res)
    for g, h, r in zip(tree_leaves(grads), tree_leaves(g_hat),
                       tree_leaves(res2)):
        torch.testing.assert_close(h + r, g, rtol=1e-6, atol=1e-6)
    # on a one-rank axis the collective is one error-feedback round,
    # bitwise (the multi-rank cases: test_torch_distributed.py)
    one = AbstractMesh((1,), ("pod",))
    res["a"].normal_()
    out, r2 = tcomp.compressed_pmean(grads["a"], "pod", res["a"], one)
    want, want_r = tcomp.ef_compress_leaf(grads["a"], res["a"])
    assert torch.equal(out, want) and torch.equal(r2, want_r)


# ------------------------------------------- the "xla" functions (f32) ---
def _cfg32(arch):
    return (dataclasses.replace(jax_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _block_params(jcfg, key, sub):
    p = seeded_params(jcfg, 0)["stack"]["blocks"][0]
    return tree_map(lambda a: np.asarray(a)[0], dict(p))[sub]


def _torch_tree(p_np):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)


def _grad_pair(jfn, tfn, p_np, x_np, seed=3):
    """Output and gradients (params and x) of sum(f(p, x) * r) on both
    sides, r drawn from ``seed``."""
    jp, jx = jax.tree.map(jnp.asarray, p_np), jnp.asarray(x_np)
    jy = jax.jit(jfn)(jp, jx)
    r = np.random.default_rng(seed).standard_normal(
        np.shape(jy)).astype(np.float32)
    jloss = lambda p, x: jnp.sum(jfn(p, x) * r)  # noqa: E731
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jx)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a))
                  .requires_grad_(True), p_np)
    tx = torch.from_numpy(np.array(x_np)).requires_grad_(True)
    ty = tfn(tp, tx)
    grads = torch.autograd.grad((ty * torch.from_numpy(r)).sum(),
                                tree_leaves(tp) + [tx], allow_unused=True)
    return jy, ty, jax.tree.leaves(jgp) + [jgx], grads, tree_leaves(tp)


def _check_grads(jy, ty, jgs, tgs, what):
    _rel_close(ty, jy, OUT_TOL, f"{what} output")
    for i, (j, t) in enumerate(zip(jgs, tgs)):
        t = torch.zeros(np.shape(j)) if t is None else t
        _rel_close(t, j, GRAD_TOL, f"{what} grad {i}")


def _sorted_leaves(tree):
    """A tree's leaves in JAX's order (dict keys sorted, sequences in
    order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


@pytest.mark.parametrize("S,window,softcap", [(24, 0, 0.0), (24, 7, 0.0),
                                              (24, 0, 30.0), (2048, 0, 0.0)])
def test_attention_xla_matches_the_reference_and_its_gradient(S, window,
                                                              softcap):
    """S = 2048 takes the q-chunked path (two 1024-query chunks)."""
    jcfg, tcfg = _cfg32("glm4-9b")
    if softcap:
        jcfg = dataclasses.replace(jcfg, attn_logit_softcap=softcap)
        tcfg = dataclasses.replace(tcfg, attn_logit_softcap=softcap)
    if S > 1024:
        jcfg = dataclasses.replace(jcfg, d_model=32, num_heads=2,
                                   num_kv_heads=1, head_dim=16)
        tcfg = dataclasses.replace(tcfg, d_model=32, num_heads=2,
                                   num_kv_heads=1, head_dim=16)
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.key(1),
                                                      jcfg))
    p = tree_map(lambda a: (np.random.default_rng(a.size).standard_normal(
        a.shape) * 0.2).astype(np.float32), p)
    x = np.random.default_rng(0).standard_normal(
        (1, S, jcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    jfn = lambda p, x: jattn.attention_apply(  # noqa: E731
        p, jcfg, x, jnp.asarray(pos), window=window, impl="xla")
    tfn = lambda p, x: tattn.attention_apply(  # noqa: E731
        p, tcfg, x, torch.from_numpy(pos), window=window, impl="xla")
    jy, ty, jgs, tgs, _ = _grad_pair(jfn, tfn, p, x)
    tgs = _reorder(p, tgs)
    _check_grads(jy, ty, jgs, tgs, f"attention S={S}")


def _reorder(p, tgs):
    """The port's grads (insertion-order leaves, then x) in JAX's sorted
    key order."""
    idx = {id(t): i for i, t in enumerate(tree_leaves(p))}
    order = [idx[id(t)] for t in _sorted_leaves(p)]
    return [tgs[i] for i in order] + [tgs[-1]]


@pytest.mark.parametrize("S", [16, 512])
def test_rglru_xla_matches_the_reference_and_its_gradient(S):
    """S = 512: two 256-step chunks, each recomputed in the backward."""
    jcfg, tcfg = _cfg32("recurrentgemma-2b")
    p = _block_params(jcfg, 0, "rglru")
    x = np.random.default_rng(1).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    jfn = lambda p, x: jrec.rglru_apply(p, jcfg, x, impl="xla")  # noqa
    tfn = lambda p, x: trec.rglru_apply(p, tcfg, x, impl="xla")  # noqa
    jy, ty, jgs, tgs, _ = _grad_pair(jfn, tfn, p, x)
    _check_grads(jy, ty, jgs, _reorder(p, tgs), f"rglru S={S}")


@pytest.mark.parametrize("S", [16, 256])
def test_mamba_xla_matches_the_reference_and_its_gradient(S):
    """S = 256: two 128-step chunks, each recomputed in the backward."""
    jcfg, tcfg = _cfg32("falcon-mamba-7b")
    p = _block_params(jcfg, 0, "mamba")
    x = np.random.default_rng(2).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    jfn = lambda p, x: jssm.mamba_apply(p, jcfg, x, impl="xla")  # noqa
    tfn = lambda p, x: tssm.mamba_apply(p, tcfg, x, impl="xla")  # noqa
    jy, ty, jgs, tgs, _ = _grad_pair(jfn, tfn, p, x)
    _check_grads(jy, ty, jgs, _reorder(p, tgs), f"mamba S={S}")


def test_moe_xla_expert_ffn_matches_the_reference_and_its_gradient():
    jcfg, tcfg = _cfg32("qwen3-moe-30b-a3b")
    p = _block_params(jcfg, 0, "moe")
    x = np.random.default_rng(4).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    jfn = lambda p, x: jmoe.moe_apply(p, jcfg, x, impl="sort")[0]  # noqa
    tfn = lambda p, x: tmoe.moe_apply(  # noqa: E731
        p, tcfg, x, impl="sort", expert_impl="xla")[0]
    jy, ty, jgs, tgs, _ = _grad_pair(jfn, tfn, p, x)
    _check_grads(jy, ty, jgs, _reorder(p, tgs), "moe sort")


def test_runtime_refuses_an_unknown_attention_impl():
    assert Runtime().attention_impl == "cuda"
    with pytest.raises(ValueError, match="attention impl"):
        Runtime(attention_impl="pallas")


# ------------------------------------------------------------ train step --
TAPS = frozenset({"commits", "coverage", "router"})


@functools.lru_cache(maxsize=None)
def _reference_run(arch, dtype, steps=3):
    """The reference's train state after each of ``steps`` jitted steps
    (numpy), its metrics, and the initial state, from ``seeded_params``."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    jm = jax_build(jcfg, JaxRuntime(taps=TAPS))
    state = jstep.init_state(jm, jax.random.key(0))
    state = {**state, "params": seeded_params(jcfg, 0)}
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jstep.make_train_step(jm, joptim.OptConfig(
        warmup_steps=10)))
    fn = make_batch_fn(get_smoke_config(arch), 2, 16, 0)
    states, metrics = [], []
    for i in range(steps):
        state, m, _ = step(state, {k: jnp.asarray(v) for k, v in
                                   fn(i).items()})
        states.append(jax.tree.map(np.asarray, state))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return init, states, metrics


def _port_run(arch, dtype, init, steps=3):
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    model = build_model(tcfg, Runtime(attention_impl="xla", taps=TAPS))
    state = state_from_jax(init, tcfg, "cpu")
    step = make_train_step(model, OptConfig(warmup_steps=10))
    fn = make_batch_fn(tcfg, 2, 16, 0)
    states, metrics = [], []
    for i in range(steps):
        state, m, _ = step(state, fn(i))
        states.append(tree_map(torch.clone, state))
        metrics.append({k: _np(v) for k, v in m.items()})
    return states, metrics


def _by_sorted_keys(port_tree, ref_tree):
    """The port's leaves in the reference's leaf order (JAX sorts keys),
    beside the reference's."""
    return _sorted_leaves(port_tree), jax.tree.leaves(ref_tree)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_the_reference_in_f32(arch):
    """One step: loss, gradient norm and the first moment (0.1 x clip x the
    gradients) tightly; three steps: losses, and every parameter within
    the learning-rate limit."""
    init, jstates, jmet = _reference_run(arch, "float32")
    tstates, tmet = _port_run(arch, "float32", init)
    for i in range(3):
        for k in ("loss", "grad_norm"):
            rel = abs(float(tmet[i][k]) - float(jmet[i][k])) \
                / abs(float(jmet[i][k]))
            assert rel <= STEP_RTOL, (arch, i, k, rel)
        assert float(tmet[i]["lr"]) == float(jmet[i]["lr"])
    t_m, j_m = _by_sorted_keys(tstates[0]["opt"]["m"], jstates[0]["opt"]["m"])
    for i, (a, b) in enumerate(zip(t_m, j_m)):
        _rel_close(a, b, GRAD_TOL, f"{arch} m leaf {i}")
    lr_sum = sum(float(m["lr"]) for m in jmet)
    t_p, j_p = _by_sorted_keys(tstates[-1]["params"], jstates[-1]["params"])
    err = max(float(np.abs(_np(a) - _np(b)).max())
              for a, b in zip(t_p, j_p))
    assert err <= LR_ATOL * lr_sum, (arch, err, lr_sum)
    assert int(tstates[-1]["step"]) == int(jstates[-1]["step"]) == 3
    assert int(tstates[-1]["opt"]["count"]) == 3


def test_train_step_matches_the_reference_in_bf16():
    """glm4-9b smoke in bf16: the losses at the co-emulator's relative
    error, params after three steps within the learning-rate limit plus
    one bf16 ulp."""
    init, jstates, jmet = _reference_run("glm4-9b", "bfloat16")
    tstates, tmet = _port_run("glm4-9b", "bfloat16", init)
    for i in range(3):
        rel = abs(float(tmet[i]["loss"]) - float(jmet[i]["loss"])) \
            / (abs(float(jmet[i]["loss"])) + 1e-6)
        assert rel <= BF16_RTOL, (i, rel)
    lr_sum = sum(float(m["lr"]) for m in jmet)
    t_p, j_p = _by_sorted_keys(tstates[-1]["params"], jstates[-1]["params"])
    for i, (a, b) in enumerate(zip(t_p, j_p)):
        a, b = _np(a), _np(b)
        limit = LR_ATOL * lr_sum + np.abs(b) * 2.0 ** -8
        assert (np.abs(a - b) <= limit).all(), (i, float(
            np.abs(a - b).max()))


def test_grad_accumulation_equivalence():
    """accum_steps=2 (two f32 microbatch gradients averaged) against one
    batch, as the reference's test holds it."""
    cfg = get_smoke_config("granite-8b")
    model = build_model(cfg, Runtime(attention_impl="xla"))
    batch = make_batch_fn(cfg, 4, 16)(0)

    def run(accum):
        state = init_state(model, 1, device="cpu")
        step = make_train_step(model, OptConfig(lr=1e-3), accum_steps=accum)
        state, m, _ = step(state, batch)
        return float(m["loss"]), state["params"]

    l1, p1 = run(1)
    l2, p2 = run(2)
    assert abs(l1 - l2) < 3e-2
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=3e-2, atol=3e-2)


def test_grad_compress_tracks_uncompressed():
    cfg = get_smoke_config("granite-8b")
    model = build_model(cfg, Runtime(attention_impl="xla"))
    batchf = make_batch_fn(cfg, 4, 16)

    def run(compress):
        state = init_state(model, 2, grad_compress=compress, device="cpu")
        if compress:
            assert set(state) == {"params", "opt", "step", "ef"}
        step = make_train_step(model, OptConfig(lr=1e-3, warmup_steps=2),
                               grad_compress=compress)
        losses = []
        for i in range(10):
            state, m, _ = step(state, batchf(i))
            losses.append(float(m["loss"]))
        return losses, state

    plain, _ = run(False)
    comp, state = run(True)
    assert np.isfinite(comp).all()
    assert abs(np.mean(comp[-3:]) - np.mean(plain[-3:])) < 1.0
    assert any(float(r.abs().max()) > 0 for r in tree_leaves(state["ef"]))


def test_state_from_jax_carries_the_reference_state_and_checks_it():
    jcfg = jax_smoke("granite-8b")
    jm = jax_build(jcfg)
    js = jax.tree.map(np.asarray, jstep.init_state(jm, jax.random.key(0),
                                                   grad_compress=True))
    tcfg = get_smoke_config("granite-8b")
    ts = state_from_jax(js, tcfg, "cpu")
    assert set(ts) == {"params", "opt", "step", "ef"}
    assert ts["opt"]["count"].dtype == torch.int32
    assert all(t.dtype == torch.float32 for t in
               tree_leaves((ts["opt"]["m"], ts["opt"]["v"], ts["ef"])))
    like = state_specs(build_model(tcfg), grad_compress=True)
    assert [t.shape for t in tree_leaves(ts)] == \
        [t.shape for t in tree_leaves(like)]
    assert all(t.device.type == "meta" for t in tree_leaves(like))
    params = params_from_jax(js["params"], tcfg, "cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(ts["params"])):
        assert torch.equal(a, b)
    bad = {**js, "opt": {**js["opt"], "m": js["params"]}}   # bf16 moments
    with pytest.raises(ValueError, match="opt/m"):
        state_from_jax(bad, tcfg, "cpu")


def test_init_state_runs_on_the_card_unless_the_host_is_asked_for():
    model = build_model(get_smoke_config("granite-8b"))
    state = init_state(model, 0, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(state))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_state(model, 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_the_xla_train_step_calls_no_kernel_wrapper(arch, monkeypatch):
    """Under attention_impl="xla" a train step (forward and backward)
    reaches none of the five kernel wrappers, so on the card it runs no
    kernel and no kernel's plain version."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called")
    for mod, name in ((fa_ops, "flash_attention"),
                      (da_ops, "decode_attention"), (ssm_ops, "ssm_scan"),
                      (lru_ops, "rglru_scan"), (gg_ops, "grouped_gemm")):
        monkeypatch.setattr(mod, name, refuse)
    cfg = get_smoke_config(arch)
    model = build_model(cfg, Runtime(attention_impl="xla", taps=TAPS))
    state = init_state(model, 0, device="cpu")
    state, m, _ = make_train_step(model)(state, make_batch_fn(cfg, 2, 16)(0))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("pos", [5, 40])
def test_decode_attention_xla_matches_the_reference(pos):
    """The decode step's plain attention over the ring (slots above pos
    masked until it fills; pos 40 has wrapped the 32-slot ring)."""
    jcfg, tcfg = _cfg32("glm4-9b")
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.key(2),
                                                      jcfg))
    rng = np.random.default_rng(pos)
    W, K, hd = 32, jcfg.num_kv_heads, jcfg.head_dim
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, W, K, hd)).astype(np.float32)
    cv = rng.standard_normal((2, W, K, hd)).astype(np.float32)
    jy, jc = jattn.decode_attention_apply(
        p, jcfg, jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        jnp.int32(pos), impl="xla")
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    ty, tc = tattn.decode_attention_apply(
        _torch_tree(p), tcfg, torch.from_numpy(x), tc,
        torch.tensor(pos, dtype=torch.int32), impl="xla")
    _rel_close(ty, jy, OUT_TOL, "decode attention")
    for k in ("k", "v"):
        _rel_close(tc[k], jc[k], OUT_TOL, f"cache {k}")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_prefill_xla_scan_state_matches_the_reference(arch):
    """Under "xla" the prefill's chunked scan hands the decode the same
    state as the reference's prefill."""
    jcfg, tcfg = _cfg32(arch)
    sub, jmod, tmod, fn = (("mamba", jssm, tssm, "mamba_prefill")
                           if arch.startswith("falcon") else
                           ("rglru", jrec, trec, "rglru_prefill"))
    p = _block_params(jcfg, 0, sub)
    x = np.random.default_rng(5).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    jy, js = getattr(jmod, fn)(jax.tree.map(jnp.asarray, p), jcfg,
                               jnp.asarray(x))
    ty, ts = getattr(tmod, fn)(_torch_tree(p), tcfg, torch.from_numpy(x),
                               impl="xla")
    _rel_close(ty, jy, OUT_TOL, f"{arch} prefill output")
    for k in js:
        _rel_close(ts[k], js[k], OUT_TOL, f"{arch} prefill state {k}")
