"""``Runtime.remat`` of the port on the CPU: each family's smoke config
trained one step under remat "none", "dots" and "full".

Limits: loss, gradients, commit stream, metrics and the updated state
bitwise equal across the three under deterministic mode (a recompute runs
the same operations on the same inputs); the bytes the forward leaves
allocated for the backward strictly falling from "none" to "dots" to
"full"; and the port's "dots" step against the reference's
``remat="dots"`` step (weights from ``jax_weights``, state through
``interop.state_from_jax``) at ``tests/test_torch_train.py``'s
tolerances.

The bytes are counted by a dispatch mode that keeps a weak reference to
the storage of every tensor an operation creates in the forward: what is
still alive when the forward returns is what the autograd graph holds for
the backward (plus the outputs, the same in every mode). Saved-tensor
hooks cannot count it: ``torch.utils.checkpoint`` installs its own hooks
inside a checkpointed region, and the selective policy keeps its saved
products in a cache of its own.
"""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.runtime import Runtime as JaxRuntime  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (PShell, default_shell_config,  # noqa: E402
                              drain, make_ingest)
from repro_torch.data.pipeline import make_batch_fn  # noqa: E402
from repro_torch.interop import state_from_jax  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.testing import assert_trees_equal, deterministic  # noqa: E402
from repro_torch.train import OptConfig, init_state, make_train_step  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402
from repro_torch.utils import tree_leaves, tree_unflatten  # noqa: E402
from jax_weights import seeded_params  # noqa: E402
from test_torch_train import (GRAD_TOL, STEP_RTOL, _by_sorted_keys,  # noqa: E402
                              _rel_close)

FAMILIES = ["glm4-9b", "falcon-mamba-7b", "recurrentgemma-2b",
            "qwen3-moe-30b-a3b"]
REMATS = ("none", "dots", "full")
TAPS = frozenset({"commits", "coverage", "router"})


def _model(arch, remat, dtype=None):
    cfg = get_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return build_model(cfg, Runtime(attention_impl="xla", taps=TAPS,
                                    remat=remat))


def test_runtime_refuses_an_unknown_remat():
    with pytest.raises(ValueError):
        Runtime(remat="dot")
    fn = lambda x: x  # noqa: E731
    assert Runtime().checkpoint(fn) is fn
    with torch.no_grad():
        assert Runtime(remat="full").checkpoint(fn)(3) == 3


def _one_step(arch, remat):
    """Gradients, then one train step with the shell's ingest: (grads,
    state, metrics, drained records)."""
    model = _model(arch, remat)
    state = init_state(model, 0, device="cpu")
    batch = make_batch_fn(model.cfg, 2, 16, 0)(0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _, grads = _value_and_grad(model.loss, state["params"], tb)
    shell = PShell(default_shell_config(model.cfg, 1),
                   make_ingest(model.cfg))
    sh = shell.init("cpu")
    state, metrics, sh = shell.wrap(make_train_step(model))(state, batch, sh)
    records, _ = drain(sh)
    return loss, grads, state, metrics, records


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_modes_are_bitwise_equal(arch):
    with deterministic():
        runs = {r: _one_step(arch, r) for r in REMATS}
    base = runs["none"]
    for r in ("dots", "full"):
        loss, grads, state, metrics, records = runs[r]
        assert torch.equal(loss, base[0]), r
        assert_trees_equal(base[1], grads, f"{arch} grads, {r}")
        assert_trees_equal(base[2], state, f"{arch} state, {r}")
        assert_trees_equal(base[3], metrics, f"{arch} metrics, {r}")
        for name, f in base[4]["fifos"].items():
            g = records["fifos"][name]
            assert np.array_equal(f["data"], g["data"]), (r, name)
            assert (f["count"], f["dropped"]) == (g["count"], g["dropped"])
        for name, v in base[4]["csrs"].items():
            assert np.array_equal(v, records["csrs"][name]), (r, name)
    commits = base[4]["fifos"]["commits"]
    assert commits["count"] == get_smoke_config(arch).num_layers


class _HeldBytes(TorchDispatchMode):
    """Bytes of the storages that operations create while active and that
    are still alive at ``held()`` (storages in ``exclude`` not counted)."""

    def __init__(self, exclude):
        super().__init__()
        self.exclude = exclude
        self.seen = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not torch.is_tensor(t):
                continue
            s = t.untyped_storage()
            p = s.data_ptr()
            if p in self.exclude or s.nbytes() == 0:
                continue
            old = self.seen.get(p)
            if old is None or old[0].expired():
                self.seen[p] = (StorageWeakRef(s), s.nbytes())
        return out

    def held(self) -> int:
        gc.collect()
        return sum(n for ref, n in self.seen.values() if not ref.expired())


def _held_for_backward(arch, remat):
    model = _model(arch, remat)
    params = init_state(model, 0, device="cpu")["params"]
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch_fn(model.cfg, 2, 16, 0)(0).items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    mode = _HeldBytes({t.untyped_storage().data_ptr()
                       for t in leaves + list(batch.values())})
    with mode:
        loss, _ = model.loss(tree_unflatten(params, leaves), batch)
    held = mode.held()
    loss.backward()
    return held


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_holds_strictly_less_for_the_backward(arch):
    held = {r: _held_for_backward(arch, r) for r in REMATS}
    assert held["none"] > held["dots"] > held["full"] > 0, held


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_step_matches_the_reference_dots_step(arch):
    """One f32 step of the port under remat "dots" against the
    reference's jitted ``remat="dots"`` step from the same weights and
    batch: loss and gradient norm within STEP_RTOL, the learning rate to
    the bit, the first moment (0.1 x clip x the gradients) within GRAD_TOL
    of each leaf's largest."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    jm = jax_build(jcfg, JaxRuntime(taps=TAPS, remat="dots"))
    jstate = {**jstep.init_state(jm, jax.random.key(0)),
              "params": seeded_params(jcfg, 0)}
    init = jax.tree.map(np.asarray, jstate)
    batch = make_batch_fn(get_smoke_config(arch), 2, 16, 0)(0)
    jnew, jmet, _ = jax.jit(jstep.make_train_step(jm, joptim.OptConfig(
        warmup_steps=10)))(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    model = _model(arch, "dots", "float32")
    state = state_from_jax(init, model.cfg, "cpu")
    state, met, _ = make_train_step(model, OptConfig(warmup_steps=10))(
        state, batch)
    for k in ("loss", "grad_norm"):
        rel = abs(float(met[k]) - float(jmet[k])) / abs(float(jmet[k]))
        assert rel <= STEP_RTOL, (arch, k, rel)
    assert float(met["lr"]) == float(jmet["lr"])
    t_m, j_m = _by_sorted_keys(state["opt"]["m"], jnew["opt"]["m"])
    for i, (a, b) in enumerate(zip(t_m, j_m)):
        _rel_close(a, b, GRAD_TOL, f"{arch} m leaf {i}")
