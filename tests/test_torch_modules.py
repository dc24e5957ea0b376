"""The port's layers and attention modules against the JAX package on the
CPU, on the same weights and inputs (numpy from a seed, handed to both).

Tolerances: f32 1e-4 (same arithmetic, another summation order); bf16
3e-2 (the two frameworks round to bf16 at a few different points, e.g.
inside silu). The forward attention (``attention_apply``) is held tighter:
f32 at 1e-5 of the output's largest magnitude, bf16 at 2e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402
from jax_weights import seeded  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _to_torch(tree):
    """JAX tree -> torch tree, bf16 through f32 numpy (exact)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, tree)


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), \
        torch.from_numpy(a).to(TDT[dtype])


def _close(a, b, dtype):
    assert_allclose(_np(a), _np(b), rtol=TOL[dtype], atol=TOL[dtype])


# ----------------------------------------------------------------- layers ---
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_mlp_rope_embed_logits(dtype):
    jcfg, tcfg = _cfgs("glm4-9b", dtype)
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, jcfg.d_model), dtype)
    scale = rng.standard_normal(jcfg.d_model).astype(np.float32)
    bias = rng.standard_normal(jcfg.d_model).astype(np.float32)
    _close(tlayers.rmsnorm_apply({"scale": torch.from_numpy(scale)}, tx, 1e-5),
           jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jx, 1e-5),
           dtype)
    _close(tlayers.layernorm_apply({"scale": torch.from_numpy(scale),
                                    "bias": torch.from_numpy(bias)}, tx, 1e-5),
           jlayers.layernorm_apply({"scale": jnp.asarray(scale),
                                    "bias": jnp.asarray(bias)}, jx, 1e-5),
           dtype)

    mlp = seeded(jlayers.init_mlp(jax.random.key(1), jcfg, jcfg.d_ff), 1)
    _close(tlayers.mlp_apply(_to_torch(mlp), tx),
           jlayers.mlp_apply(mlp, jx), dtype)

    jq, tq = _pair(rng, (2, 5, 4, 16), dtype, scale=2.0)
    pos = rng.integers(0, 3000, size=(2, 5)).astype(np.int32)
    _close(tlayers.apply_rope(tq, torch.from_numpy(pos), 10000.0),
           jlayers.apply_rope(jq, jnp.asarray(pos), 10000.0), dtype)

    emb = seeded({"embed": jlayers.init_embed(jax.random.key(2), jcfg)},
                 2)["embed"]
    head = seeded(jlayers.init_dense(jax.random.key(3), jcfg.d_model,
                                     jcfg.vocab_size, JDT[dtype]), 3)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 5)).astype(np.int32)
    _close(tlayers.embed_apply(_to_torch(emb), torch.from_numpy(toks)),
           jlayers.embed_apply(emb, jnp.asarray(toks)), dtype)
    tparams = {"embed": _to_torch(emb), "lm_head": _to_torch(head)}
    out = tlayers.logits_apply(tparams, tcfg, tx)
    ref = jlayers.logits_apply({"embed": emb, "lm_head": head}, jcfg, jx)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(out, ref, dtype)
    tied = dataclasses.replace(tcfg, tie_embeddings=True)
    jtied = dataclasses.replace(jcfg, tie_embeddings=True)
    _close(tlayers.logits_apply({"embed": _to_torch(emb)}, tied, tx),
           jlayers.logits_apply({"embed": emb}, jtied, jx), dtype)


# -------------------------------------------------------------- attention ---
@pytest.mark.parametrize("arch,kw", [
    ("glm4-9b", {}),
    ("granite-8b", {}),
    ("glm4-9b", {"use_qk_norm": True}),
    ("granite-8b", {"attn_logit_softcap": 30.0}),
], ids=["glm4", "granite", "glm4-qk_norm", "granite-softcap"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 7], ids=["attn", "swa"])
def test_attention_apply(arch, kw, dtype, window):
    """The forward's one path (the K1 wrapper, its plain version on host
    tensors) against both impl="pallas_interpret" and impl="xla"."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    p = seeded(jattn.init_attention(jax.random.key(14), jcfg), 14)
    if jcfg.use_qk_norm:        # non-trivial norm scales
        rng = np.random.default_rng(15)
        for n in ("q_norm", "k_norm"):
            p[n]["scale"] = jnp.asarray(
                1 + 0.5 * rng.standard_normal(jcfg.head_dim), jnp.float32)
    rng = np.random.default_rng(16)
    B, S = 2, 40
    jx, tx = _pair(rng, (B, S, jcfg.d_model), dtype, scale=2.0)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    out = tattn.attention_apply(_to_torch(p), tcfg, tx, torch.from_numpy(pos),
                                window=window)
    assert out.dtype == TDT[dtype] and tuple(out.shape) == tuple(jx.shape)
    for impl in ("pallas_interpret", "xla"):
        ref = jattn.attention_apply(p, jcfg, jx, jnp.asarray(pos),
                                    window=window, impl=impl)
        a, b = _np(out), _np(ref)
        if dtype == "float32":
            assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), impl
        else:
            assert_allclose(a, b, rtol=2e-2, atol=2e-2, err_msg=impl)



@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [3, 19, 45])   # ring filling, just full, wrapped
def test_decode_attention_apply(arch, dtype, pos):
    """The port's one path (the K2 wrapper, its plain version on host
    tensors) against both impl="pallas_interpret" and impl="xla": the
    output and the in-place ring-slot write of the cache."""
    jcfg, tcfg = _cfgs(arch, dtype)
    p = seeded(jattn.init_attention(jax.random.key(4), jcfg), 4)
    rng = np.random.default_rng(pos)
    B, W = 2, 20
    jx, tx = _pair(rng, (B, 1, jcfg.d_model), dtype)
    jk, tk = _pair(rng, (B, W, jcfg.num_kv_heads, jcfg.head_dim), dtype)
    jv, tv = _pair(rng, (B, W, jcfg.num_kv_heads, jcfg.head_dim), dtype)
    for jimpl in ("pallas_interpret", "xla"):
        y, c = jattn.decode_attention_apply(
            p, jcfg, jx, {"k": jk, "v": jv}, jnp.int32(pos), impl=jimpl)
        tc = {"k": tk.clone(), "v": tv.clone()}
        ty, tc2 = tattn.decode_attention_apply(
            _to_torch(p), tcfg, tx, tc, torch.tensor(pos, dtype=torch.int32))
        assert tc2["k"] is tc["k"]                 # updated in place
        _close(ty, y, dtype)
        _close(tc["k"], c["k"], dtype)
        _close(tc["v"], c["v"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_prefill_chunked_causal(dtype):
    """S=2048 takes the q-chunked branch (S > 1024, S % 1024 == 0) on a
    narrow config; output and the emitted (padded) cache match."""
    kw = dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64)
    jcfg, tcfg = _cfgs("glm4-9b", dtype, **kw)
    spec = ("attn", "mlp")
    p = seeded(jtfm.init_block(jax.random.key(5), jcfg, spec), 5)
    rng = np.random.default_rng(6)
    S, max_len = 2048, 2056
    jx, tx = _pair(rng, (1, S, jcfg.d_model), dtype)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    y, c = jtfm.block_prefill(p, jcfg, spec, jx, jnp.asarray(pos), max_len,
                              JaxRuntime())
    ty, tc = ttfm.block_prefill(_to_torch(p), tcfg, spec, tx,
                                torch.from_numpy(pos.copy()), max_len)
    assert tuple(tc["k"].shape) == tuple(c["k"].shape) == (1, max_len, 1, 16)
    _close(ty, y, dtype)
    _close(tc["k"], c["k"], dtype)
    _close(tc["v"], c["v"], dtype)


def test_attend_and_masks_match():
    jcfg, tcfg = _cfgs("granite-8b", "float32", attn_logit_softcap=20.0)
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng, (2, 9, 4, 16), "float32", scale=3.0)
    jk, tk = _pair(rng, (2, 9, 2, 16), "float32", scale=3.0)
    jv, tv = _pair(rng, (2, 9, 2, 16), "float32")
    pos = np.arange(9, dtype=np.int32)
    for window in (0, 4):
        jm = jattn._causal_window_mask(jnp.asarray(pos), jnp.asarray(pos),
                                       window)
        tm = tattn._causal_window_mask(torch.from_numpy(pos),
                                       torch.from_numpy(pos), window)
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        _close(tattn._attend(tcfg, tq, tk, tv, tm),
               jattn._attend(jcfg, jq, jk, jv, jm), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checksum_and_nan_bit_match(dtype):
    from repro import utils as jutils
    from repro_torch import utils as tutils
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng, (3, 7, 16), dtype, scale=4.0)
    assert tutils.dtype_of(dtype) == TDT[dtype]
    _close(tutils.checksum(tx), jutils.checksum(jx), "float32")
    assert tutils.checksum(tx).dtype == torch.float32
    for bad in (None, float("inf"), float("nan")):
        a, b = jx, tx.clone()
        if bad is not None:
            a = jx.at[1, 2, 3].set(bad)
            b[1, 2, 3] = bad
        assert bool(tutils.has_nan_bit(b)) == bool(jutils.has_nan_bit(a)) \
            == (bad is not None)


@pytest.mark.parametrize("pattern,window", [((("attn", "mlp"),), 0),
                                            ((("swa", "mlp"),
                                              ("attn", "mlp")), 8)])
def test_cache_specs_and_init_cache_match(pattern, window):
    """Ring length min(window, max_len) for swa, max_len for attn; stacked
    over periods, with the remainder as the tail."""
    jcfg, tcfg = _cfgs("granite-8b", "bfloat16", layer_pattern=pattern,
                       window=window, num_layers=3)
    jspec = jtfm.stack_cache_spec(jcfg, 2, 20)
    tspec = ttfm.stack_cache_spec(tcfg, 2, 20)
    assert tspec["pos"] == ((), torch.int32)
    for k in ("scanned", "tail"):
        assert _spec_leaves(tspec[k]) == jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), jspec[k])
    for mixer_window in (0, window):
        jc = jattn.init_cache(jcfg, 2, 20, mixer_window)
        tc = tattn.init_cache(tcfg, 2, 20, mixer_window, "cpu")
        for name in ("k", "v"):
            assert tuple(tc[name].shape) == jc[name].shape
            assert tc[name].dtype == TDT[str(jc[name].dtype)]
            assert not tc[name].any()


def _spec_leaves(tree):
    """(shape, dtype) leaves of a port cache spec, as the JAX side prints
    them."""
    if isinstance(tree, dict):
        return {k: _spec_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and len(tree) == 2 \
            and isinstance(tree[1], torch.dtype):
        return (tuple(tree[0]), str(tree[1]).replace("torch.", ""))
    return type(tree)(_spec_leaves(v) for v in tree)


def test_init_shapes_follow_the_reference_layout():
    jcfg, tcfg = _cfgs("granite-8b", "bfloat16", use_qk_norm=True,
                       use_bias=True)
    jp = seeded(jtfm.init_lm(jax.random.key(0), jcfg))
    tp = ttfm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = tree_map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), tp)
    assert tshapes == jshapes
    assert isinstance(tp["stack"]["blocks"], tuple)
    assert isinstance(tp["stack"]["tail"], list)
