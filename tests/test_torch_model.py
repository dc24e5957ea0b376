"""The port's Model (prefill + decode_step) against the JAX package's on
the CPU, on weights carried across with repro_torch.interop, and the
interop round trip itself.

Tolerances: f32 1e-4 elementwise; bf16 3e-2 as a normwise relative error
||a - b|| / ||b|| over each tensor, since the frameworks round to bf16 at
a few different points and a whole model carries those differences into
single logits near zero. Decode feeds both sides the same tokens, so the
comparison holds step by step without depending on argmax ties.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from jax_weights import seeded_params  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x,
                                                                  np.float32)


def _close(a, b, dtype):
    a, b = _np(a), _np(b)
    if dtype == "float32":
        assert_allclose(a, b, rtol=TOL[dtype], atol=TOL[dtype])
    else:
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= TOL[dtype], err


def _run_both(jcfg, tcfg, *, jimpl, B=2, S=20, steps=4, seed=0, jit=True):
    """The port's one decode path against the reference's ``jimpl``,
    jitted, or op by op under ``jax.disable_jit()`` where ``jit`` is
    False."""
    jm = jax_build(jcfg, JaxRuntime(attention_impl=jimpl))
    tm = build_model(tcfg)
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    step_toks = rng.integers(0, jcfg.vocab_size,
                             size=(steps, B, 1)).astype(np.int32)
    max_len = S + steps + 4
    jprefill = jax.jit(jm.prefill, static_argnums=2) if jit else jm.prefill
    jdecode = jax.jit(jm.decode_step) if jit else jm.decode_step
    eager = contextlib.nullcontext if jit else jax.disable_jit
    with eager():
        jc, jl = jprefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    with torch.inference_mode():
        tc, tl = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len)
    yield "prefill", jc, jl, tc, tl
    for i in range(steps):
        with eager():
            jc, jl = jdecode(jp, jc, jnp.asarray(step_toks[i]))
        with torch.inference_mode():
            tc, tl = tm.decode_step(tp, tc, torch.from_numpy(step_toks[i]))
        yield f"step{i}", jc, jl, tc, tl


def _check(gen, dtype):
    for _, jc, jl, tc, tl in gen:
        assert tl.dtype == torch.float32
        _close(tl, jl, dtype)
        assert int(tc["pos"]) == int(jc["pos"])
        for a, b in zip(tree_leaves(tc["scanned"]) + tree_leaves(tc["tail"]),
                        jax.tree.leaves(jc["scanned"])
                        + jax.tree.leaves(jc["tail"])):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b, dtype)


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_prefill_and_decode_match(arch, dtype, impl):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    _check(_run_both(jcfg, tcfg, jimpl=impl), dtype)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_sliding_window_ring_cache(impl):
    """swa with window 8 < prompt 20: the prefill places the last W keys at
    slot t % W, and every decode step runs with the ring full."""
    kw = dict(layer_pattern=(("swa", "mlp"),), window=8, dtype="float32")
    jcfg = dataclasses.replace(jax_smoke("glm4-9b"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("glm4-9b"), **kw)
    gen = _run_both(jcfg, tcfg, jimpl=impl, steps=10)
    first = next(gen)
    assert tuple(first[3]["scanned"][0]["k"].shape)[2] == 8   # W = window
    _check([first], "float32")
    _check(gen, "float32")


def test_serve_steps_match_the_reference():
    """serve/engine: make_prefill_step then make_serve_step, f32, glm4."""
    from repro.serve import make_prefill_step as jprefill_step
    from repro.serve import make_serve_step as jserve_step
    from repro_torch.serve import make_prefill_step, make_serve_step
    jcfg = dataclasses.replace(jax_smoke("glm4-9b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("glm4-9b"), dtype="float32")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 9)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, size=(2, 1)).astype(np.int32)
    jc, jl = jax.jit(jprefill_step(jm, 16))(jp, {"tokens": jnp.asarray(toks)})
    jc, jl = jax.jit(jserve_step(jm))(jp, jc, jnp.asarray(nxt))
    with torch.inference_mode():
        tc, _ = make_prefill_step(tm, 16)(tp, {"tokens":
                                              torch.from_numpy(toks)})
        k0 = tc["scanned"][0]["k"]
        tc, tl = make_serve_step(tm)(tp, tc, torch.from_numpy(nxt))
    assert tc["scanned"][0]["k"] is k0                  # cache in place
    _check([("step", jc, jl, tc, tl)], "float32")


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
def test_interop_round_trip_is_bitwise(arch):
    cfg = jax_smoke(arch)
    jp = seeded_params(cfg)
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(np_tree, get_smoke_config(arch), "cpu")
    assert tp["embed"]["tok"].dtype == torch.bfloat16
    assert tp["final_norm"]["scale"].dtype == torch.float32
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint32),
                              b.astype(np.float32).view(np.uint32))


def test_interop_rejects_a_mismatched_tree():
    cfg = jax_smoke("glm4-9b")
    np_tree = jax.tree.map(np.asarray, seeded_params(cfg))
    with pytest.raises(ValueError, match="expects"):
        params_from_jax(np_tree, get_smoke_config("granite-8b"), "cpu")
    np_tree["final_norm"]["scale"] = np_tree["final_norm"]["scale"][:3]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(np_tree, get_smoke_config("glm4-9b"), "cpu")
