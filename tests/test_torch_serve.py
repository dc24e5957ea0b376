"""The port's serve slice as a whole against the JAX package's own serve
pieces (make_prefill_step, make_decode_engine(donate=False) and the
WindowScheduler with the P-Shell drain), on the same carried-across
weights and the same prompts, in f32 on the CPU.

Greedy tokens must be identical; the drained decode-FIFO rows match at
1e-4 (they carry a max logit); counts, dropped credits, the ``tokens``
CSR and the number of drained windows match exactly.

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
from repro.serve import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from jax_weights import seeded_params  # noqa: E402


_MOVED = ("ClosedJaxpr", "Jaxpr", "Literal", "ShapedArray", "Var")


@pytest.fixture(scope="module")
def ref():
    """The reference's scheduler, P-Shell and decode engine."""
    import jax.core
    import jax.extend.core
    added = [n for n in _MOVED if not hasattr(jax.core, n)]
    for n in added:
        setattr(jax.core, n, getattr(jax.extend.core, n))
    try:
        core = importlib.import_module("repro.core")
        pshell = importlib.import_module("repro.core.pshell")
        launch = importlib.import_module("repro.launch.serve")
    finally:
        for n in added:
            delattr(jax.core, n)
    return types.SimpleNamespace(
        WindowScheduler=core.WindowScheduler, drain=pshell.drain,
        shell_init=pshell.shell_init,
        decode_shell_config=launch.decode_shell_config,
        make_decode_engine=launch.make_decode_engine)


def _jax_serve(ref, cfg, params, batch, prompt_len, gen, sample_interval,
               seed=0):
    """The reference's serve() loop, on given params."""
    model = jax_build(cfg)
    b = {k: jnp.asarray(v)
         for k, v in jax_batch_fn(cfg, batch, prompt_len, seed)(0).items()
         if k != "labels"}
    prefill = jax.jit(jax_prefill_step(model, prompt_len + gen + 8))
    cache, logits = prefill(params, b)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    engine = ref.make_decode_engine(model, params, donate=False)
    sched = ref.WindowScheduler(interval=sample_interval, overlap=True,
                                drain_fn=ref.drain)
    toks, drained = [np.asarray(tok)], []

    def on_drain(plan, records, ys):
        toks.append(np.asarray(ys)[:, :, 0].T)
        f = records["fifos"]["decode"]
        drained.append({"rows": f["data"], "count": f["count"],
                        "dropped": f["dropped"],
                        "tokens_csr": int(records["csrs"]["tokens"])})

    sched.run(engine, sched.windows(range(gen - 1)), (cache, tok),
              ref.shell_init(ref.decode_shell_config(sample_interval)),
              on_drain=on_drain)
    return np.concatenate(toks, axis=1), drained


@pytest.mark.parametrize("arch", ["glm4-9b", "granite-8b"])
@pytest.mark.parametrize("batch,prompt_len,gen,interval",
                         [(2, 12, 8, 3),      # windows 3, 3, 1 (tail)
                          (3, 16, 9, 4)])     # windows 4, 4
def test_serve_slice_matches_reference(ref, arch, batch, prompt_len, gen,
                                       interval):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = seeded_params(jcfg)
    ref_toks, ref_drained = _jax_serve(ref, jcfg, jp, batch, prompt_len, gen,
                                       interval)
    out = serve(tcfg, batch, prompt_len, gen, sample_interval=interval,
                device="cpu",
                params=params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       "cpu"))
    toks = np.asarray(out["tokens"])
    assert toks.shape == (batch, gen)
    assert np.array_equal(toks, ref_toks)
    assert out["generated"] == ref_toks[:, :8].tolist()
    assert len(out["drained"]) == len(ref_drained) \
        == len(out["decode_window_ms"]) == -(-(gen - 1) // interval)
    for mine, theirs in zip(out["drained"], ref_drained):
        assert mine["count"] == theirs["count"]
        assert mine["dropped"] == theirs["dropped"] == 0
        assert mine["tokens_csr"] == theirs["tokens_csr"]
        assert_allclose(np.asarray(mine["rows"], np.float32),
                        theirs["rows"], rtol=1e-4, atol=1e-4)
    assert out["decode_fifo_rows"] == gen - 1
    assert not out["hung"]
    assert out["device"] == "cpu"


def test_serve_draws_its_own_weights_from_seed():
    cfg = get_smoke_config("granite-8b")
    a = serve(cfg, 2, 8, 5, seed=3, sample_interval=2, device="cpu")
    b = serve(cfg, 2, 8, 5, seed=3, sample_interval=2, device="cpu")
    assert a["tokens"] == b["tokens"]
    assert a["decode_fifo_rows"] == 4 and len(a["drained"]) == 2
    assert a["drained"][-1]["tokens_csr"] == 2 * 4
