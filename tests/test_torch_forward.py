"""The port's commit-tapped forward (Model.logits / Model.loss) and its
commit stream (core/commit.py into the P-Shell, core/coverage.py) against
the JAX package on the CPU, on weights carried across with
repro_torch.interop and the same make_batch_fn batch.

The port runs its one attention path (the K1 wrapper, its plain version
on host tensors); the reference runs both impl="pallas_interpret" and its
default impl="xla". Tolerances: f32 at 1e-5 (the loss and the (L,2)
checksums as the co-emulator's relative error |a-b|/(|b|+1e-6), the
logits against 1e-5 of their largest magnitude); bf16 at 5e-2, the
co-emulator's default rtol, with the logits as a normwise relative error.
nan bits, FIFO rows and counts, dropped credits and CSRs match exactly
(FIFO checksum rows at the checksum tolerance).

The reference's ``repro.core`` package imports ``repro.analysis``, which
reads four names from ``jax.core`` that newer jax releases keep only in
``jax.extend.core``. The ``ref`` fixture aliases them for that one import
and removes the aliases again; nothing of the JAX package is changed.
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
from repro.data.pipeline import make_batch_fn as jax_batch_fn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import commit as tcommit  # noqa: E402
from repro_torch.core.coverage import CoverageMap  # noqa: E402
from repro_torch.core.pshell import drain, shell_init  # noqa: E402
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models.model import cross_entropy  # noqa: E402
from jax_weights import seeded_params  # noqa: E402

_MOVED = ("ClosedJaxpr", "Jaxpr", "Literal", "ShapedArray", "Var")
TAPS = frozenset({"commits", "coverage"})
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def ref():
    """The reference's commit stream, P-Shell and coverage map."""
    import jax.core
    import jax.extend.core
    added = [n for n in _MOVED if not hasattr(jax.core, n)]
    for n in added:
        setattr(jax.core, n, getattr(jax.extend.core, n))
    try:
        commit = importlib.import_module("repro.core.commit")
        pshell = importlib.import_module("repro.core.pshell")
        coverage = importlib.import_module("repro.core.coverage")
    finally:
        for n in added:
            delattr(jax.core, n)
    return types.SimpleNamespace(commit=commit, pshell=pshell,
                                 CoverageMap=coverage.CoverageMap)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _rel_close(a, b, rtol, what):
    """The co-emulator's comparison: |a-b| / (|b| + 1e-6) <= rtol."""
    a, b = _np(a), _np(b)
    err = np.abs(a - b) / (np.abs(b) + 1e-6)
    assert err.max() <= rtol, (what, float(err.max()))


def _logits_close(a, b, dtype):
    a, b = _np(a), _np(b)
    if dtype == "float32":
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    else:
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= RTOL[dtype], err


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _setup(jcfg, tcfg, B=2, S=24, seed=3):
    """JAX params and the port's copy; the same batch for both sides."""
    jp = seeded_params(jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb = {k: jnp.asarray(v)
          for k, v in jax_batch_fn(jcfg, B, S, seed)(0).items()}
    tb = {k: torch.from_numpy(v)
          for k, v in make_batch_fn(tcfg, B, S, seed)(0).items()}
    return jp, tp, jb, tb


def _port_loss(tcfg, tp, tb):
    with torch.inference_mode():
        return build_model(tcfg, Runtime(taps=TAPS)).loss(tp, tb)


def _jax_loss(jcfg, jp, jb, impl):
    jm = jax_build(jcfg, JaxRuntime(taps=TAPS, attention_impl=impl))
    return jax.jit(jm.loss)(jp, jb)


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_loss_and_commit_taps_match(ref, arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp, jb, tb = _setup(jcfg, tcfg)
    with torch.inference_mode():
        model = build_model(tcfg, Runtime(taps=TAPS))
        tlogits, taux = model.logits(tp, tb)
    tloss, (tmet, taux2) = _port_loss(tcfg, tp, tb)
    assert tlogits.dtype == torch.float32
    assert set(tmet) == {"loss", "ce", "moe_aux"}
    assert tmet["moe_aux"].dtype == torch.float32 \
        and tmet["moe_aux"].dim() == 0 and float(tmet["moe_aux"]) == 0.0
    assert torch.equal(tmet["loss"], tmet["ce"])
    tcks = tcommit.layer_checksums(taux2)
    assert tuple(tcks.shape) == (jcfg.num_layers, 2)
    assert torch.equal(tcks, tcommit.layer_checksums(taux))
    for impl in ("pallas_interpret", "xla"):
        jm = jax_build(jcfg, JaxRuntime(taps=TAPS, attention_impl=impl))
        jlogits, _ = jax.jit(jm.logits)(jp, jb)
        jloss, (jmet, jaux) = _jax_loss(jcfg, jp, jb, impl)
        _logits_close(tlogits, jlogits, dtype)
        _rel_close(tloss, jloss, RTOL[dtype], f"loss {impl}")
        _rel_close(tmet["ce"], jmet["ce"], RTOL[dtype], f"ce {impl}")
        _rel_close(tcks, ref.commit.layer_checksums(jaux), RTOL[dtype],
                   f"checksums {impl}")
        assert np.array_equal(tcommit.nan_bits(taux2).numpy(),
                              np.asarray(ref.commit.nan_bits(jaux)))
        assert tcommit.moe_toggles(taux2) is None \
            and ref.commit.moe_toggles(jaux) is None


def test_cross_entropy_matches():
    from repro.models.model import cross_entropy as jax_ce
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, size=(2, 7)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    assert_allclose(float(got), float(want), rtol=1e-6)


def _two_position(dtype):
    """One period of (swa, attn) and a tail of one swa layer."""
    return _cfgs("glm4-9b", dtype, num_layers=3, window=8,
                 layer_pattern=(("swa", "mlp"), ("attn", "mlp")))


def test_commit_order_is_period_major_with_a_tail(ref):
    jcfg, tcfg = _two_position("float32")
    jp, tp, jb, tb = _setup(jcfg, tcfg, S=20)
    _, (_, taux) = _port_loss(tcfg, tp, tb)
    _, (_, jaux) = _jax_loss(jcfg, jp, jb, "pallas_interpret")
    assert len(taux["scanned"]) == len(jaux["scanned"]) == 2
    assert len(taux["tail"]) == len(jaux["tail"]) == 1
    assert tuple(taux["scanned"][0]["checksum"].shape) == (1, 2)
    tcks = tcommit.layer_checksums(taux)
    jcks = np.asarray(ref.commit.layer_checksums(jaux))
    assert tuple(tcks.shape) == jcks.shape == (3, 2)
    for layer in range(3):          # row for row, in layer order
        _rel_close(tcks[layer], jcks[layer], 1e-5, f"layer {layer}")
    # the rows are distinct, so a permuted order could not pass
    assert len({tuple(np.round(r, 6)) for r in jcks}) == 3


def _ingest_both(ref, jcfg, tcfg, steps, commit_depth=None):
    """Ingest the same forward ``steps`` times on both sides, then drain."""
    jp, tp, jb, tb = _setup(jcfg, tcfg, S=20)
    _, (tmet, taux) = _port_loss(tcfg, tp, tb)
    _, (jmet, jaux) = _jax_loss(jcfg, jp, jb, "pallas_interpret")
    tsh = shell_init(tcommit.default_shell_config(
        tcfg, commit_depth=commit_depth))
    jsh = ref.pshell.shell_init(ref.commit.default_shell_config(
        jcfg, commit_depth=commit_depth))
    ting, jing = tcommit.make_ingest(tcfg), ref.commit.make_ingest(jcfg)
    for _ in range(steps):
        tsh = ting(tsh, taux, tmet)
        jsh = jing(jsh, jaux, jmet)
    trec, _ = drain(tsh)
    jrec, _ = ref.pshell.drain(jsh)
    return trec, jrec


def _same_records(trec, jrec):
    tf, jf = trec["fifos"]["commits"], jrec["fifos"]["commits"]
    assert tf["count"] == jf["count"] and tf["dropped"] == jf["dropped"]
    assert tf["data"].shape == jf["data"].shape
    assert np.array_equal(tf["data"][:, 0], jf["data"][:, 0])  # layer ids
    _rel_close(tf["data"][:, 1:], jf["data"][:, 1:], 1e-5, "fifo rows")
    assert set(trec["csrs"]) == set(jrec["csrs"])
    assert int(trec["csrs"]["steps"]) == int(jrec["csrs"]["steps"])
    assert np.array_equal(trec["csrs"]["nan_bits"], jrec["csrs"]["nan_bits"])
    _rel_close(trec["csrs"]["loss_last"], jrec["csrs"]["loss_last"], 1e-5,
               "loss_last")


def test_ingest_fills_the_shell_as_the_reference(ref):
    jcfg, tcfg = _two_position("float32")
    tspec = tcommit.default_shell_config(tcfg, sample_interval=2)
    jspec = ref.commit.default_shell_config(jcfg, sample_interval=2)
    assert tspec.fifos["commits"].depth == jspec.fifos["commits"].depth \
        == 4 * 3
    assert {k: tuple(s) for k, (s, _) in tspec.csrs.items()} \
        == {k: tuple(v.shape) for k, v in jspec.csrs.items()}
    trec, jrec = _ingest_both(ref, jcfg, tcfg, steps=2)
    assert trec["fifos"]["commits"]["count"] == 6
    assert trec["fifos"]["commits"]["dropped"] == 0
    _same_records(trec, jrec)
    tcov, jcov = CoverageMap(), ref.CoverageMap()
    assert tcov.update(trec["csrs"]) == jcov.update(jrec["csrs"])
    assert tcov.fraction() == jcov.fraction()
    assert tcov.summary() == jcov.summary()


def test_undersized_commit_fifo_drops_the_same_rows(ref):
    """Depth 4 for 3 layers over 2 steps: rows 0-2 and 0 kept, the last
    two dropped and counted, on both sides."""
    jcfg, tcfg = _two_position("float32")
    trec, jrec = _ingest_both(ref, jcfg, tcfg, steps=2, commit_depth=4)
    assert trec["fifos"]["commits"]["count"] == 4
    assert trec["fifos"]["commits"]["dropped"] == 2
    assert trec["fifos"]["commits"]["data"][:, 0].tolist() == [0, 1, 2, 0]
    _same_records(trec, jrec)


def test_nan_bits_reach_the_csr_and_coverage(ref):
    """A non-finite activation sets that layer's bit on both sides (an
    inf planted in the final block's MLP output weights)."""
    jcfg, tcfg = _cfgs("granite-8b", "float32")
    jp, tp, jb, tb = _setup(jcfg, tcfg, S=16)
    tp["stack"]["blocks"][0]["mlp"]["down"]["w"][1, 0, 0] = float("inf")
    jw = jp["stack"]["blocks"][0]["mlp"]["down"]["w"]
    jp["stack"]["blocks"][0]["mlp"]["down"]["w"] = jw.at[1, 0, 0].set(
        jnp.inf)
    _, (tmet, taux) = _port_loss(tcfg, tp, tb)
    _, (jmet, jaux) = _jax_loss(jcfg, jp, jb, "xla")
    assert tcommit.nan_bits(taux).tolist() == [False, True]
    assert np.asarray(ref.commit.nan_bits(jaux)).tolist() == [False, True]
    tsh = tcommit.make_ingest(tcfg)(
        shell_init(tcommit.default_shell_config(tcfg)), taux, tmet)
    jsh = ref.commit.make_ingest(jcfg)(
        ref.pshell.shell_init(ref.commit.default_shell_config(jcfg)), jaux,
        jmet)
    trec, _ = drain(tsh)
    jrec, _ = ref.pshell.drain(jsh)
    assert np.array_equal(trec["csrs"]["nan_bits"], jrec["csrs"]["nan_bits"])
    tcov, jcov = CoverageMap(), ref.CoverageMap()
    assert tcov.update(trec["csrs"]) == jcov.update(jrec["csrs"]) == 1
    assert tcov.fraction() == jcov.fraction() == 0.5
