"""The port's last four architectures against the JAX package on the CPU:
whisper-small (enc-dec), internvl2-1b (VLM prefix), internlm2-20b and
command-r-35b (dense), at their smoke sizes, on weights carried across
with ``repro_torch.interop`` from ``jax_weights.seeded``.

Limits:
  * the forward (``Model.loss`` / ``Model.logits`` with the commit tap)
    on the pipeline's f32 frames and patches, against the reference's
    ``impl="pallas_interpret"`` (its kernel path, as the port's forward
    takes K1): in f32 the loss and each checksum component at 1e-5 as the
    co-emulator's relative error |a-b| / (|b|+1e-6), the logits within
    1e-5 of their largest magnitude; in bf16 the loss and each
    checksum's mean |x| at the co-emulator's rtol 5e-2, each checksum's
    mean within 5e-2 of its layer's mean |x| (a mean near zero is
    ill-conditioned alone, as ``testing.check_forward_parity`` says), the
    logits at 5e-2 normwise;
  * prefill and three greedy decode steps with the frames and patches in
    the model's dtype: the same tokens at every step, the logits and the
    caches within the forward's limits;
  * one train step in f32 on the "xla" path against ``repro.train``: the
    limits of ``tests/test_torch_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.coemu import inject_fault  # noqa: E402
from repro_torch.core.decompose import (extract_blocks,  # noqa: E402
                                        scanned_vs_unrolled,
                                        verify_extraction)
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.interop import (params_from_jax,  # noqa: E402
                                 params_to_numpy, state_from_jax)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models.layers import dense_apply, embed_apply  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from jax_weights import seeded_params  # noqa: E402
from test_torch_train import _sorted_leaves  # noqa: E402

ARCHS = ["whisper-small", "internvl2-1b", "internlm2-20b", "command-r-35b"]
TAPS = frozenset({"commits"})
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
_FRONTEND = ("frames", "patches")
# a first moment under this share of the largest is round-off of a zero
# gradient
ZERO_GRAD = 1e-6


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _weights(jcfg, tcfg):
    jp = seeded_params(jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _rel(a, b):
    """The co-emulator's relative error, max over elements."""
    a, b = _np(a), _np(b)
    return float((np.abs(a - b) / (np.abs(b) + 1e-6)).max())


def _close(a, b, dtype, what):
    """f32: within RTOL of the largest magnitude elementwise; bf16:
    normwise."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if dtype == "float32":
        assert_allclose(a, b, rtol=0, atol=RTOL[dtype] * np.abs(b).max(),
                        err_msg=what)
    else:
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= RTOL[dtype], (what, err)


def _checksums_close(a, b, dtype, what):
    """(L, 2) checksums [mean, mean |x|]: f32 componentwise; bf16 the mean
    |x| relative and the mean relative to its layer's mean |x|."""
    a, b = _np(a), _np(b)
    if dtype == "float32":
        assert _rel(a, b) <= RTOL[dtype], (what, _rel(a, b))
        return
    assert _rel(a[:, 1], b[:, 1]) <= RTOL[dtype], (what, a, b)
    scaled = np.abs(a[:, 0] - b[:, 0]) / (np.abs(b[:, 1]) + 1e-6)
    assert scaled.max() <= RTOL[dtype], (what, a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_checksums_match_the_reference(arch, dtype):
    """The pipeline's f32 frames / patches as they come: on a bf16 model
    the encoder, the cross-attention and the patch projection run in f32
    on both sides (JAX's promotion, ``dense_apply``'s on the port)."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, tcfg)
    batch = make_batch_fn(tcfg, 2, 24, 3)(0)
    for k in _FRONTEND:
        if k in batch:
            assert batch[k].dtype == np.float32
    jm = jax_build(jcfg, JaxRuntime(attention_impl="pallas_interpret",
                                    taps=TAPS))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, (_, jaux) = jax.jit(jm.loss)(jp, jb)
    jlogits, _ = jax.jit(jm.logits)(jp, jb)
    model = build_model(tcfg, Runtime(taps=TAPS))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        tloss, (tmet, taux) = model.loss(tp, tb)
        tlogits, _ = model.logits(tp, tb)
    assert tlogits.dtype == torch.float32
    P = tcfg.num_patches if tcfg.family == "vlm" else 0
    assert tuple(tlogits.shape) == (2, 24, tcfg.vocab_size) \
        and tb["tokens"].shape[1] == 24 - P
    assert _rel(tloss, jloss) <= RTOL[dtype], (_rel(tloss, jloss))
    _close(tlogits, jlogits, dtype, "logits")
    assert set(taux) == set(jaux) == {"scanned", "tail"}
    _checksums_close(taux["scanned"][0]["checksum"],
                     jaux["scanned"][0]["checksum"], dtype, "checksums")
    assert taux["scanned"][0]["checksum"].shape == (tcfg.num_layers, 2)


def _in_model_dtype(batch, cfg):
    dt = {"float32": np.float32, "bfloat16": jnp.bfloat16}[cfg.dtype]
    return {k: v.astype(dt) if k in _FRONTEND else v
            for k, v in batch.items() if k != "labels"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_greedy_decode_match_the_reference(arch, dtype):
    """Frames and patches in the model's dtype (the reference's prefill
    needs that for the enc-dec); each side decodes its own greedy tokens,
    which must be equal at every step."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _weights(jcfg, tcfg)
    batch = _in_model_dtype(make_batch_fn(tcfg, 2, 20, 5)(0), tcfg)
    P = tcfg.num_patches if tcfg.family == "vlm" else 0
    max_len = 20 + P + 8
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jc, jl = jax.jit(jm.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, max_len)
    tb = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, dtype)) if k in _FRONTEND else torch.from_numpy(v)
        for k, v in batch.items()}
    with torch.inference_mode():
        tc, tl = tm.prefill(tp, tb, max_len)
    jdecode = jax.jit(jm.decode_step)
    for step in range(4):
        _close(tl, jl, dtype, f"logits {step}")
        assert int(tc["pos"]) == int(jc["pos"])
        jleaves = jax.tree.leaves({k: v for k, v in jc.items()
                                   if k != "pos"})
        tleaves = _sorted_leaves({k: v for k, v in tc.items()
                                  if k != "pos"})
        assert len(tleaves) == len(jleaves)
        for a, b in zip(tleaves, jleaves):
            _close(a, b, dtype, f"cache {step}")
        jt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        tt = torch.argmax(tl[:, -1], -1).to(torch.int32)
        assert np.array_equal(tt.numpy(), jt), (step, tt, jt)
        if step == 3:
            break
        jc, jl = jdecode(jp, jc, jnp.asarray(jt[:, None]))
        with torch.inference_mode():
            tc, tl = tm.decode_step(tp, tc, tt[:, None])


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(arch):
    """f32, the "xla" path, batches from the pipeline (f32 frames,
    patches) against ``repro.train.step``: loss and gradient norm within
    STEP_RTOL, the first moment within GRAD_TOL of each leaf's largest
    (a leaf whose gradient is zero analytically: both sides under
    ZERO_GRAD of the largest moment), params within LR_ATOL x lr."""
    import test_torch_train as tt
    init, jstates, jmet = tt._reference_run(arch, "float32", steps=1)
    tstates, tmet = tt._port_run(arch, "float32", init, steps=1)
    for k in ("loss", "grad_norm"):
        rel = abs(float(tmet[0][k]) - float(jmet[0][k])) \
            / abs(float(jmet[0][k]))
        assert rel <= tt.STEP_RTOL, (arch, k, rel)
    assert float(tmet[0]["lr"]) == float(jmet[0]["lr"])
    t_m = [_np(a) for a in _sorted_leaves(tstates[0]["opt"]["m"])]
    j_m = [_np(b) for b in jax.tree.leaves(jstates[0]["opt"]["m"])]
    assert len(t_m) == len(j_m)
    largest = max(np.abs(b).max() for b in j_m)
    for i, (a, b) in enumerate(zip(t_m, j_m)):
        if np.abs(b).max() < ZERO_GRAD * largest:
            # a gradient that is zero analytically (a key projection's
            # bias: the softmax ignores what it adds to every score)
            # holds round-off only, on both sides
            assert np.abs(a).max() < ZERO_GRAD * largest, (arch, i)
            continue
        assert np.abs(a - b).max() <= tt.GRAD_TOL * np.abs(b).max(), \
            (arch, i)
    err = max(float(np.abs(_np(a) - _np(b)).max()) for a, b in zip(
        _sorted_leaves(tstates[0]["params"]),
        jax.tree.leaves(jstates[0]["params"])))
    assert err <= tt.LR_ATOL * float(jmet[0]["lr"]), (arch, err)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_train_windows_carry_frames_and_patches_as_f32(arch):
    """PShell.run_grouped of make_group_step stacks each window's batches
    (``stack_batches``), frames or patches in f32 as the pipeline makes
    them, and equals PShell.run step by step to the bit on the host: the
    train state and every drained record."""
    from repro_torch.core.pshell import stack_batches
    from repro_torch.testing import (assert_records_equal,
                                     assert_trees_equal, train_run)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rt = Runtime(attention_impl="xla", taps=frozenset({"commits",
                                                       "coverage"}))
    batches = [make_batch_fn(cfg, 2, 16, 0)(i) for i in range(5)]
    key = "frames" if cfg.family == "encdec" else "patches"
    stacked = stack_batches(batches[:2])
    assert stacked[key].dtype == np.float32 and stacked[key].shape[0] == 2
    a = train_run(cfg, rt, batches, 2, grouped=False, device="cpu")
    b = train_run(cfg, rt, batches, 2, device="cpu")
    assert_trees_equal(a["state"], b["state"], f"{arch} train state")
    assert_records_equal(a["records"], b["records"], f"{arch} records")
    assert [r["fifos"]["commits"]["count"] for _, r in b["records"]] == \
        [2 * cfg.num_layers, 2 * cfg.num_layers, cfg.num_layers]


def test_f32_frames_fail_the_reference_prefill_and_the_port_names_it():
    """On a bf16 model the reference's ``encdec_prefill`` raises inside
    ``lax.scan`` (its carry turns f32 through the cross-attention); the
    port raises a TypeError naming the frames. bf16 frames pass both."""
    jcfg, tcfg = _cfgs("whisper-small", "bfloat16")
    jp, tp = _weights(jcfg, tcfg)
    batch = {k: v for k, v in make_batch_fn(tcfg, 2, 8, 0)(0).items()
             if k != "labels"}
    assert batch["frames"].dtype == np.float32
    with pytest.raises(TypeError, match="carry"):
        jencdec.encdec_prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, 16, JaxRuntime())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = build_model(tcfg)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="frames are torch.float32"):
            model.prefill(tp, tb, 16)
        cache, logits = model.prefill(
            tp, {**tb, "frames": tb["frames"].to(torch.bfloat16)}, 16)
    assert cache["self"]["k"].dtype == torch.bfloat16
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_serve_equals_the_reference_model_on_cast_inputs(arch):
    """serve() on the host, in the config's bf16, against the reference's
    jitted prefill and greedy decode on the same prompts with the frames
    or patches cast to bf16 (what serve feeds; the reference's own serve
    passes the f32 frames on and fails), and the reference's max_len
    (the patch prefix counted)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _weights(jcfg, tcfg)
    B, prompt, gen = 2, 16, 6
    out = serve(tcfg, B, prompt, gen, sample_interval=2, device="cpu",
                params=tp, return_cache=True)
    jm = jax_build(jcfg)
    P = jcfg.num_patches if jcfg.family == "vlm" else 0
    batch = _in_model_dtype(make_batch_fn(tcfg, B, prompt, 0)(0), tcfg)
    jc, jl = jax.jit(jm.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        prompt + P + gen + 8)
    tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    decode = jax.jit(jm.decode_step)
    for _ in range(gen - 1):
        jc, jl = decode(jp, jc, tok)
        tok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    ref = np.concatenate(toks, axis=1)
    assert np.array_equal(np.asarray(out["tokens"]), ref), (out["tokens"],
                                                            ref)
    cache = out["cache"]
    W = (cache["self"]["k"] if arch == "whisper-small"
         else cache["scanned"][0]["k"]).shape[-3]
    assert W == prompt + P + gen + 8
    assert out["decode_fifo_rows"] == gen - 1


def test_scale_down_and_inject_fault_refuse_the_encdec_family():
    """The reference's decomposition and ``inject_fault`` read
    ``params["stack"]``, which an enc-dec model lacks (KeyError); the
    port raises ValueError naming the family. The VLM's decoder stack
    replays bitwise and takes a fault."""
    from test_torch_ssm import import_reference
    jdecompose, jcoemu = import_reference("repro.core.decompose",
                                          "repro.core.coemu")
    jcfg, tcfg = _cfgs("whisper-small", "float32")
    jp, tp = _weights(jcfg, tcfg)
    with pytest.raises(KeyError, match="stack"):
        list(jdecompose.iter_layer_params(jp, jcfg))
    with pytest.raises(KeyError, match="stack"):
        jcoemu.inject_fault(jp, jcfg, 0)
    rt = Runtime()
    x = torch.zeros(1, 4, tcfg.d_model)
    pos = torch.arange(4, dtype=torch.int32)[None]
    for call in (lambda: verify_extraction(tp, tcfg, x, pos, rt, 0),
                 lambda: extract_blocks(tp, tcfg, [0], rt, 1, 4),
                 lambda: scanned_vs_unrolled(tp, tcfg, x, pos, rt),
                 lambda: inject_fault(tp, tcfg, 1)):
        with pytest.raises(ValueError, match="encdec"):
            call()

    vcfg = get_smoke_config("internvl2-1b")
    vp = build_model(vcfg).init(0, device="cpu")
    toks = torch.from_numpy(make_batch_fn(vcfg, 2, 16, 0)(0)["tokens"])
    x = embed_apply(vp["embed"], toks)
    pos = torch.arange(x.shape[1], dtype=torch.int32).expand(2, -1)
    with torch.inference_mode():
        for layer in range(vcfg.num_layers):
            rep = verify_extraction(vp, vcfg, x, pos, rt, layer)
            assert rep["bitwise_identical"], rep
        assert scanned_vs_unrolled(vp, vcfg, x, pos, rt) == 0.0
    bad = inject_fault(vp, vcfg, 1)
    assert not torch.equal(bad["stack"]["blocks"][0]["attn"]["k"]["w"][1],
                           vp["stack"]["blocks"][0]["attn"]["k"]["w"][1])


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_interop_carries_encdec_and_vlm_trees(arch):
    """params_from_jax / params_to_numpy round trip bitwise, and
    state_from_jax takes the reference's whole train state, for the two
    new trees (encoder and decoder stacks; the patch projection)."""
    from repro.train import step as jstep
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    np_tree = jax.tree.map(np.asarray, seeded_params(jcfg))
    tp = params_from_jax(np_tree, tcfg, "cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(np_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert np.array_equal(a.view(np.uint32),
                              b.astype(np.float32).view(np.uint32))
    state = jstep.init_state(jax_build(jcfg), jax.random.key(0))
    ts = state_from_jax(jax.tree.map(np.asarray, state), tcfg, "cpu")
    assert len(tree_leaves(ts["opt"]["m"])) == len(tree_leaves(tp))
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts["opt"]["v"]))
    np_tree.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(np_tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_and_init_match_the_reference(arch):
    """cache_spec's shapes and dtypes (the VLM's max_len counts its
    prefix where serve sets it), and init's tree against the reference's
    param shapes."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jspec = jax_build(jcfg).cache_spec(2, 40)
    tspec = build_model(tcfg).cache_spec(2, 40)

    def flat(spec):
        if isinstance(spec, dict):
            return [x for k in sorted(spec) for x in flat(spec[k])]
        if isinstance(spec, tuple) and len(spec) == 2 \
                and isinstance(spec[1], torch.dtype):
            return [(tuple(spec[0]), str(spec[1]).replace("torch.", ""))]
        return [x for v in spec for x in flat(v)]

    assert flat(tspec) == [(tuple(s.shape), str(s.dtype))
                           for s in jax.tree.leaves(jspec)]
    meta = build_model(tcfg).init(device="meta")
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.key(0))
    assert [tuple(t.shape) for t in _sorted_leaves(meta)] == \
        [tuple(s.shape) for s in jax.tree.leaves(shapes)]


def test_patch_projection_promotes_as_jax_does():
    """dense_apply on mixed dtypes: bf16 x f32 gives f32 from the upcast
    bf16 operand (JAX's promotion); equal dtypes keep their product."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g)
    w = torch.randn(5, 4, generator=g).to(torch.bfloat16)
    y = dense_apply({"w": w}, x)
    assert y.dtype == torch.float32
    assert torch.equal(y, x @ w.float())
    jy = jnp.asarray(x.numpy()) @ jnp.asarray(w.float().numpy()).astype(
        jnp.bfloat16)
    assert jy.dtype == jnp.float32
    assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    yb = dense_apply({"w": w, "b": torch.ones(4, dtype=torch.bfloat16)},
                     x.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, x.to(torch.bfloat16) @ w
                       + torch.ones(4, dtype=torch.bfloat16))
