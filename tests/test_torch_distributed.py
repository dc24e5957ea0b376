"""The shard_map half of the port's sharded path against the JAX package,
on host ranks: the a2a and Expert-TP MoE, the sequence-sharded
flash-decode, ``compressed_pmean``, the GPipe pipeline and
``CheckpointManager.restore(shardings=)``.

The ranks are eight spawned processes joined in one gloo world through a
FileStore of their own (``launch.mesh.run_ranks``), run once for the
module (``repro_torch.sharding.cells``, a plan of every cell, deadline
240 s); each cell runs on the mesh its reference test names, a mesh of a
subset of the ranks where it has fewer. The reference's results are
computed here, on one device: its sort dispatch, its unsharded "xla"
decode, its plain ``model.loss``, and its ``compressed_pmean`` under
``jax.vmap`` with a named axis, which runs the reference's own
collectives over a 4-way axis in one process. Inputs and weights go to
the ranks as ``.npz`` files (the reference's param trees redrawn from
numpy by ``jax_weights``).

Tolerances: the reference's own where it has one (a2a and Expert-TP
against its sort at 3e-2 relative in bf16; GPipe's loss at 2e-2 and
gradients at 6e-2 against its plain loss), K2's for the decode (2e-5 in
f32, 2e-2 in bf16), 1e-5 of the largest magnitude against the port's own
single-rank functions in f32, and bitwise for the decode's ring (the
same k/v written), ``compressed_pmean`` (the same operations in the same
order) and the restore.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train import compress as jcomp  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, run_ranks  # noqa: E402
from repro_torch.models import Runtime, build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.sharding import cells  # noqa: E402
from repro_torch.utils import tree_paths_sorted  # noqa: E402
from jax_weights import seeded, seeded_params  # noqa: E402

WORLD = 8
DEADLINE_S = 240
MESHES = {
    "m24": {"shape": [2, 4], "axes": ["data", "model"]},
    "m22": {"shape": [2, 2], "axes": ["data", "model"], "ranks": [0, 1, 2, 3]},
    "dp4": {"shape": [4], "axes": ["dp"], "ranks": [0, 1, 2, 3]},
    "pipe": {"shape": [2], "axes": ["pipe"], "ranks": [0, 1]},
    "m42": {"shape": [4, 2], "axes": ["data", "model"]},
}
DECODE = {"batch": 4, "ring": 32, "start": 26, "steps": 10}   # wraps at 32
PP = {"batch": (4, 16), "micro": 2}
PM_SHAPE = (64,)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if jnp.asarray(a).dtype == jnp.bfloat16 else np.asarray(a)


def _t(a, dtype):
    """A numpy array as a torch tensor of ``dtype`` (bf16 exact)."""
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _moe_cfg(arch, dtype):
    return dataclasses.replace(jax_smoke(arch), dtype=dtype,
                               capacity_factor=8.0)


# --------------------------------------------------------------- inputs ---
def _moe_case(work, name, arch, impl, dtype, mesh, seed, grad=False):
    cfg = _moe_cfg(arch, dtype)
    p = seeded(jmoe.init_moe(jax.random.key(0), cfg), seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(JDT[dtype])
    y, st = jax.jit(lambda p, x: jmoe.moe_apply(p, cfg, x, impl="sort"))(
        p, jx)
    inputs = {"router/w": _t(p["router"]["w"], "float32"),
              "gate": _t(p["gate"], dtype), "up": _t(p["up"], dtype),
              "down": _t(p["down"], dtype), "x": _t(x, dtype)}
    if grad:
        inputs["c"] = _t(rng.standard_normal(x.shape), dtype)
    cells.save_npz(work / f"in_{name}.npz", inputs)
    cell = {"name": name, "kind": "moe", "impl": impl, "mesh": mesh,
            "arch": arch, "smoke": True, "dtype": dtype,
            "overrides": {"capacity_factor": 8.0}, "npz": f"in_{name}.npz",
            "grad": grad}
    ref = {"y": _np(y), "dropped": float(st["dropped_frac"])}
    return cell, ref, inputs


def _port_sort(inputs, arch, dtype, grad):
    """The port's single-rank sort on the same inputs; with ``grad`` the
    f32 gradients of sum(y * c)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              capacity_factor=8.0)
    leaves = {k: inputs[k].clone().requires_grad_(grad)
              for k in ("router/w", "gate", "up", "down", "x")}
    p = {"router": {"w": leaves["router/w"]}, "gate": leaves["gate"],
         "up": leaves["up"], "down": leaves["down"]}
    y, _ = tmoe.moe_apply(p, cfg, leaves["x"], impl="sort",
                          expert_impl="xla" if grad else "cuda")
    out = {"y": y.detach().float()}
    if grad:
        (y.float() * inputs["c"].float()).sum().backward()
        out.update({f"grad/{k}": t.grad for k, t in leaves.items()})
    return out


def _decode_case(work, name, dtype, body, seed):
    cfg = dataclasses.replace(jax_smoke("glm4-9b"), dtype=dtype)
    B, W, T, s0 = (DECODE[k] for k in ("batch", "ring", "steps", "start"))
    H, K, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    rng = np.random.default_rng(seed)
    dt = JDT[dtype]

    def draw(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)) \
            .astype(dt)

    ring = {"k": draw(B, W, K, hd), "v": draw(B, W, K, hd)}
    inputs = {"ring/k": ring["k"], "ring/v": ring["v"]}
    ck, cv = ring["k"], ring["v"]
    outs = []
    if body:
        q, k, v = draw(T, B, 1, H, hd), draw(T, B, 1, K, hd), \
            draw(T, B, 1, K, hd)
        inputs.update(q=q, k=k, v=v)
        for t in range(T):
            pos = s0 + t
            slot = pos % W
            ck = jax.lax.dynamic_update_slice(ck, k[t], (0, slot, 0, 0))
            cv = jax.lax.dynamic_update_slice(cv, v[t], (0, slot, 0, 0))
            mask = (jnp.arange(W) <= pos)[None, :]
            outs.append(jattn._attend(cfg, q[t], ck, cv, mask))
    else:
        p = seeded(jattn.init_attention(jax.random.key(0), cfg), seed)
        x = draw(T, B, 1, D)
        inputs.update({f"p/{path}": a for path, a in _paths(p)}, x=x)
        cache = dict(ring)
        step = jax.jit(lambda p, x, c, pos: jattn.decode_attention_apply(
            p, cfg, x, c, pos, impl="xla"))
        for t in range(T):
            y, cache = step(p, x[t], cache, jnp.int32(s0 + t))
            outs.append(y)
        ck, cv = cache["k"], cache["v"]
    cells.save_npz(work / f"in_{name}.npz",
                   {k: _t(_np(a), dtype if k[:2] != "p/" or
                          a.dtype == jnp.bfloat16 else "float32")
                    for k, a in inputs.items()})
    cell = {"name": name, "kind": "decode", "mesh": "m24", "arch": "glm4-9b",
            "smoke": True, "dtype": dtype, "ring": W, "start": s0,
            "steps": T, "body": body, "npz": f"in_{name}.npz"}
    return cell, {"out": np.stack([_np(o) for o in outs]),
                  "ring/k": _np(ck), "ring/v": _np(cv)}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _pmean_case(work):
    rng = np.random.default_rng(11)
    g = rng.standard_normal((4,) + PM_SHAPE).astype(np.float32)
    r = np.zeros_like(g)
    f = jax.vmap(lambda g, r: jcomp.compressed_pmean(g, "dp", r),
                 axis_name="dp")
    o1, r1 = f(jnp.asarray(g), jnp.asarray(r))
    o2, r2 = f(jnp.asarray(g), r1)
    cells.save_npz(work / "in_pmean.npz", {"g": g, "r": r})
    cell = {"name": "pmean", "kind": "pmean", "mesh": "dp4", "rounds": 2,
            "npz": "in_pmean.npz"}
    return cell, {"out": np.asarray(o2), "resid": np.asarray(r2), "g": g}


def _pipe_case(work, dtype):
    jcfg = dataclasses.replace(jax_smoke("granite-8b"), dtype=dtype)
    np_params = jax.tree.map(np.asarray, seeded_params(jcfg, 21))
    rng = np.random.default_rng(22)
    B, S = PP["batch"]
    tok = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    model = jax_build(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b)[0]))(
            jax.tree.map(jnp.asarray, np_params),
            {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    tcfg = dataclasses.replace(get_smoke_config("granite-8b"), dtype=dtype)
    params = params_from_jax(np_params, tcfg, device="cpu")
    inputs = {f"p/{path}": t for path, t in tree_paths_sorted(params)}
    inputs.update(tokens=tok, labels=lab)
    cells.save_npz(work / f"in_pipe_{dtype}.npz", inputs)
    cell = {"name": f"pipe_{dtype}", "kind": "pipe", "mesh": "pipe",
            "arch": "granite-8b", "smoke": True, "dtype": dtype,
            "micro": PP["micro"], "npz": f"in_pipe_{dtype}.npz"}
    ref = {"loss": float(loss),
           "grads": {p: _np(a) for p, a in _paths(_tuple_free(grads))}}
    return cell, ref, params, tok, lab


def _tuple_free(tree):
    """A JAX param tree with its tuples and lists as index-keyed dicts (the
    port's path strings)."""
    if isinstance(tree, dict):
        return {k: _tuple_free(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return {str(i): _tuple_free(v) for i, v in enumerate(tree)}
    return tree


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every cell's inputs and references, and one run of the eight
    ranks over all of them."""
    work = tmp_path_factory.mktemp("mesh")
    plan_cells, refs, inputs = [], {}, {}
    for name, arch, impl, dtype, mesh, grad in (
            ("a2a_bf16", "qwen3-moe-30b-a3b", "a2a", "bfloat16", "m24", 0),
            ("a2a_f32", "qwen3-moe-30b-a3b", "a2a", "float32", "m24", 1),
            ("etp_bf16", "mixtral-8x7b", "sort", "bfloat16", "m22", 0),
            ("etp_f32", "mixtral-8x7b", "sort", "float32", "m22", 1)):
        cell, refs[name], inputs[name] = _moe_case(
            work, name, arch, impl, dtype, mesh, len(plan_cells), bool(grad))
        plan_cells.append(cell)
    for dtype in ("float32", "bfloat16"):
        for body in (True, False):
            name = f"decode_{'body' if body else 'layer'}_{dtype}"
            cell, refs[name] = _decode_case(work, name, dtype, body,
                                            len(plan_cells))
            plan_cells.append(cell)
    cell, refs["pmean"] = _pmean_case(work)
    plan_cells.append(cell)
    for dtype in ("float32", "bfloat16"):
        cell, refs[cell["name"]], *inputs[cell["name"]] = _pipe_case(work,
                                                                     dtype)
        plan_cells.append(cell)
    plan_cells.append({"name": "restore", "kind": "restore", "mesh": "m22",
                       "to": "m42", "arch": "glm4-9b", "smoke": True,
                       "dtype": "float32", "seed": 5})
    plan = {"device": "cpu", "meshes": MESHES, "cells": plan_cells}
    t0 = time.perf_counter()
    _, results = cells.run_plan(work, plan, WORLD, timeout_s=DEADLINE_S)
    return {"results": results, "refs": refs, "inputs": inputs,
            "wall_s": time.perf_counter() - t0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-6))


def _f(t):
    return t.float().numpy()


# ------------------------------------------------------------------ MoE ---
@pytest.mark.parametrize("name", ["a2a_bf16", "a2a_f32", "etp_bf16",
                                  "etp_f32"])
def test_sharded_moe_matches_the_reference_sort(world, name):
    """a2a on (2, 4) and Expert-TP on (2, 2) against the reference's sort
    at its 3e-2 relative, nothing dropped on either side."""
    out, metrics = world["results"][name]
    ref = world["refs"][name]
    assert ref["dropped"] == 0.0
    assert float(out["stats/dropped_frac"]) == 0.0
    assert _rel(_f(out["y"]), ref["y"]) < 3e-2, name
    # on host tensors the expert products run K5's plain version
    assert all(m["k5_launches"] == 0 and m["host_copies"] == 0
               for m in metrics if m["member"])


@pytest.mark.parametrize("name", ["a2a_f32", "etp_f32"])
def test_sharded_moe_matches_the_port_sort_in_f32(world, name):
    out, _ = world["results"][name]
    arch = "qwen3-moe-30b-a3b" if name.startswith("a2a") else "mixtral-8x7b"
    want = _port_sort(world["inputs"][name], arch, "float32", grad=False)
    assert _rel(_f(out["y"]), _f(want["y"])) < 1e-5


@pytest.mark.parametrize("name", ["a2a_f32", "etp_f32"])
def test_sharded_moe_gradients_match_the_port_sort(world, name):
    """The f32 gradients of sum(y * c) through the all-to-all's (a2a) or
    the psum's (Expert-TP) transpose, gathered whole, against the port's
    single-rank sort's."""
    out, _ = world["results"][name]
    arch = "qwen3-moe-30b-a3b" if name.startswith("a2a") else "mixtral-8x7b"
    want = _port_sort(world["inputs"][name], arch, "float32", grad=True)
    for k in ("x", "router/w", "gate", "up", "down"):
        assert _rel(_f(out[f"grad/{k}"]), _f(want[f"grad/{k}"])) < 1e-5, k


def test_a2a_refuses_experts_that_do_not_split():
    cfg = get_smoke_config("qwen3-moe-30b-a3b")          # 8 experts
    with pytest.raises(ValueError, match="num_experts"):
        tmoe.moe_apply({}, cfg, torch.zeros(1, 3, cfg.d_model), impl="a2a",
                       mesh=AbstractMesh((1, 3), ("data", "model")))


# --------------------------------------------------------------- decode ---
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_decode_matches_the_reference_unsharded_decode(world,
                                                               dtype):
    """The sequence-sharded body on (data 2, model 4), a ring of 32 slots
    that wraps, against the reference's unsharded "xla" decode on the same
    q, k, v: outputs at K2's tolerance, the ring bitwise."""
    out, _ = world["results"][f"decode_body_{dtype}"]
    ref = world["refs"][f"decode_body_{dtype}"]
    np.testing.assert_allclose(_f(out["out"]), ref["out"],
                               rtol=TOL[dtype], atol=TOL[dtype])
    for n in ("ring/k", "ring/v"):
        assert np.array_equal(_f(out[n]), ref[n]), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_decode_layer_matches_the_reference_layer(world, dtype):
    """decode_attention_apply(mesh=) with the o-projection summed over the
    model axis against the reference's decode_attention_apply: outputs
    and ring at the same tolerance, the projections being each
    framework's own."""
    out, _ = world["results"][f"decode_layer_{dtype}"]
    ref = world["refs"][f"decode_layer_{dtype}"]
    for n in ("out", "ring/k", "ring/v"):
        np.testing.assert_allclose(_f(out[n]), ref[n], rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=n)


# ---------------------------------------------------- compressed_pmean ---
def test_compressed_pmean_is_bitwise_the_reference(world):
    """Two error-feedback rounds over a 4-way axis: every rank's mean and
    residual bitwise the reference's (under jax.vmap with the axis named),
    the mean within the int8 bound of the f32 mean, the residual
    nonzero."""
    out, _ = world["results"]["pmean"]
    ref = world["refs"]["pmean"]
    assert np.array_equal(_f(out["out"]), ref["out"])
    assert np.array_equal(_f(out["resid"]), ref["resid"])
    g = ref["g"]
    err = np.max(np.abs(_f(out["out"])[0] - g.mean(axis=0)))
    assert err <= np.max(np.abs(g)) / 127.0 + 1e-6
    assert np.max(np.abs(_f(out["resid"]))) > 0


# ----------------------------------------------------------------- GPipe ---
def test_gpipe_matches_the_port_plain_loss_in_f32(world):
    """2 stages x 2 microbatches: the loss and every gradient within 1e-5
    of the port's plain ``Model.loss``."""
    out, _ = world["results"]["pipe_float32"]
    params, tok, lab = world["inputs"]["pipe_float32"]
    for t in (t for _, t in tree_paths_sorted(params)):
        t.requires_grad_(True)
    model = build_model(dataclasses.replace(
        get_smoke_config("granite-8b"), dtype="float32"),
        Runtime(attention_impl="xla"))
    loss, _ = model.loss(params, {"tokens": torch.from_numpy(tok).long(),
                                  "labels": torch.from_numpy(lab).long()})
    loss.backward()
    loss = float(loss.detach())
    assert abs(float(out["loss"][0]) - loss) < 1e-5 * abs(loss)
    for path, t in tree_paths_sorted(params):
        assert _rel(_f(out[f"grad/{path}"]), _f(t.grad)) < 1e-5, path


def test_gpipe_matches_the_reference_plain_loss(world):
    """bf16, against the reference's plain loss and gradients at its
    pipeline test's 2e-2 and 6e-2."""
    out, _ = world["results"]["pipe_bfloat16"]
    ref = world["refs"]["pipe_bfloat16"]
    assert abs(float(out["loss"][0]) - ref["loss"]) < 2e-2
    gd = max(float(np.max(np.abs(_f(out[f"grad/{p}"]) - g)))
             for p, g in ref["grads"].items())
    assert gd < 6e-2, gd


# --------------------------------------------------------------- restore ---
def test_restore_across_meshes_is_bitwise(world):
    """A train state saved from blocks on (2, 2) and restored onto (4, 2):
    every block of its spec's shape and equal to the same block of the
    state saved, and the smallest split leaf rebuilt on every rank."""
    out, metrics = world["results"]["restore"]
    n = int(out["leaves"][0])
    assert n > 0 and int(out["equal"][0]) == n and int(out["step"][0]) == 1
    assert all(m["shapes_ok"] == n and m["all_gather_equal"]
               for m in metrics)


# ---------------------------------------------------------------- ranks ---
def test_every_rank_ran_within_its_deadline(world):
    assert world["wall_s"] < DEADLINE_S
    for name, (_, metrics) in world["results"].items():
        assert len(metrics) == WORLD and all(
            m["wall_s"] >= 0 for m in metrics), name


def test_run_ranks_raises_on_a_failing_rank_and_on_its_deadline(tmp_path):
    from torch.multiprocessing.spawn import ProcessException
    with pytest.raises(ProcessException):
        run_ranks(cells.rank_main, 2, str(tmp_path / "no_plan"),
                  timeout_s=120)
    with pytest.raises(TimeoutError):
        run_ranks(time.sleep, 2, timeout_s=0.5)
