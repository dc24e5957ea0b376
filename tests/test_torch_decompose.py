"""The port's Scale-Down decomposition (core/decompose.py) against the JAX
package's on the CPU: the same per-layer walk, the same interface specs,
a standalone replay of every extracted block that reproduces its in-situ
run bit for bit, and replayed outputs that equal the reference's replay
of the same block on the same boundary input (f32 at 1e-5, bf16 at 2e-2,
elementwise). Weights are the reference's
param tree redrawn from numpy and carried across with
repro_torch.interop; the stack's input is the token embedding of one
make_batch_fn batch on each side.

The ``ref`` fixture aliases four names that newer jax releases moved from
``jax.core`` to ``jax.extend.core`` for its one import of
``repro.core.decompose`` (``repro.core`` imports ``repro.analysis``,
which reads them) and removes the aliases again.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import decompose as tdec  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.interop import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import Runtime  # noqa: E402
from jax_weights import seeded_params  # noqa: E402

_MOVED = ("ClosedJaxpr", "Jaxpr", "Literal", "ShapedArray", "Var")
TAPS = frozenset({"commits", "coverage"})
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jdec():
    """The reference's repro.core.decompose."""
    import jax.core
    import jax.extend.core
    added = [n for n in _MOVED if not hasattr(jax.core, n)]
    for n in added:
        setattr(jax.core, n, getattr(jax.extend.core, n))
    try:
        return importlib.import_module("repro.core.decompose")
    finally:
        for n in added:
            delattr(jax.core, n)


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _params(jcfg, tcfg, seed=0):
    """The reference's param tree with every drawn leaf redrawn from numpy
    (its own init salts keys with Python's per-process string hash), and
    the port's copy of it."""
    jp = seeded_params(jcfg, seed)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _inputs(jcfg, jp, tp, B=2, S=24, seed=5):
    """The stack's input as the model makes it: the token embeddings of a
    make_batch_fn batch, with positions 0..S-1."""
    toks = make_batch_fn(jcfg, B, S, seed)(0)["tokens"]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return (jp["embed"]["tok"][jnp.asarray(toks)], jnp.asarray(pos),
            tp["embed"]["tok"][torch.from_numpy(toks).long()],
            torch.from_numpy(pos))


ARCHS = [("glm4-9b", {}), ("granite-8b", {}),
         ("glm4-9b", {"num_layers": 3, "window": 8,
                      "layer_pattern": (("swa", "mlp"), ("attn", "mlp"))})]
ARCH_IDS = ["glm4", "granite", "swa-attn-tail"]


@pytest.mark.parametrize("arch,kw", ARCHS, ids=ARCH_IDS)
def test_iter_layer_params_walks_the_reference_order(jdec, arch, kw):
    jcfg, tcfg = _cfgs(arch, "float32", **kw)
    jp, tp = _params(jcfg, tcfg)
    mine = list(tdec.iter_layer_params(tp, tcfg))
    theirs = list(jdec.iter_layer_params(jp, jcfg))
    assert [(i, s) for i, s, _ in mine] == [(i, s) for i, s, _ in theirs]
    assert [i for i, _, _ in mine] == list(range(tcfg.num_layers))
    for (_, _, a), (_, _, b) in zip(mine, theirs):
        same = jax.tree.map(
            lambda u, v: np.array_equal(np.asarray(u, np.float32), v),
            b, params_to_numpy(a))
        assert all(jax.tree.leaves(same))


@pytest.mark.parametrize("arch,kw", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_extraction_is_bitwise_and_matches_the_reference(
        jdec, arch, kw, dtype):
    """Every layer: the port's standalone replay equals its in-situ run
    bit for bit, and equals the reference's replay at the tolerance."""
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jp, tp = _params(jcfg, tcfg)
    _, jpos, tx, tpos = _inputs(jcfg, jp, tp)
    jrt = JaxRuntime(taps=TAPS, attention_impl="pallas_interpret")
    trt = Runtime(taps=TAPS)
    with torch.inference_mode():
        _, trecs = tdec.unrolled_capture(tp, tcfg, tx, tpos, trt)
    B, S = tx.shape[:2]
    for layer in range(tcfg.num_layers):
        with torch.inference_mode():
            rep = tdec.verify_extraction(tp, tcfg, tx, tpos, trt, layer)
            tsub = tdec.extract_block(tp, tcfg, layer, trt, B, S)
            treplay = tsub.fn(trecs[layer]["x_in"], tpos)
        assert rep["bitwise_identical"] is True, rep
        assert rep["max_abs_diff"] == 0.0
        jsub = jdec.extract_block(jp, jcfg, layer, jrt, B, S)
        assert rep["subsystem"] == tsub.name == jsub.name
        assert torch.equal(treplay, trecs[layer]["x_out"])
        # the reference's replay of the same block on the same boundary
        # input (the in-situ inputs of later layers already differ by
        # the earlier layers' rounding)
        x_in = trecs[layer]["x_in"].float().numpy()
        jreplay = jsub.fn(jnp.asarray(x_in).astype(JDT[dtype]), jpos)
        assert treplay.dtype == TDT[dtype]
        assert_allclose(treplay.float().numpy(),
                        np.asarray(jreplay, np.float32),
                        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch,kw", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scanned_vs_unrolled_is_zero(arch, kw, dtype):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    jp, tp = _params(jcfg, tcfg)
    _, _, tx, tpos = _inputs(jcfg, jp, tp)
    with torch.inference_mode():
        assert tdec.scanned_vs_unrolled(tp, tcfg, tx, tpos,
                                        Runtime(taps=TAPS)) == 0.0


def test_extract_blocks_specs_and_range(jdec):
    jcfg, tcfg = _cfgs("granite-8b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    mine = tdec.extract_blocks(tp, tcfg, [1, 0], Runtime(), 2, 24)
    theirs = jdec.extract_blocks(jp, jcfg, [1, 0], JaxRuntime(), 2, 24)
    assert sorted(mine) == sorted(theirs) == [0, 1]
    for i in (0, 1):
        assert mine[i].name == theirs[i].name
        assert mine[i].layer_idx == theirs[i].layer_idx == i
        assert mine[i].spec == theirs[i].spec
        assert {k: (tuple(s), str(d).replace("torch.", ""))
                for k, (s, d) in mine[i].input_specs.items()} \
            == {k: (tuple(v.shape), str(v.dtype))
                for k, v in theirs[i].input_specs.items()}
    for bad in (2, -1):
        with pytest.raises(ValueError, match="granite-smoke") as mine_err:
            tdec.extract_block(tp, tcfg, bad, Runtime(), 2, 24)
        with pytest.raises(ValueError) as their_err:
            jdec.extract_block(jp, jcfg, bad, JaxRuntime(), 2, 24)
        assert str(mine_err.value) == str(their_err.value)
