"""The port's sharding rules (``repro_torch.sharding.rules``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's, on shapes only:
the spec of every leaf equal to the reference's, for all ten archs' smoke
configs in both modes (and expert-parallel MoE weights) on the reference's
1x1 test mesh and on a (2, 4) mesh, where ``fit_spec`` drops axes that do
not divide; for glm4-9b and qwen3-moe-30b-a3b at full size on the
production meshes (16, 16) and (2, 16, 16); cache and batch specs
likewise. The reference's meshes beyond one device are
``jax.sharding.AbstractMesh``es, the port's ``AbstractMesh``es: nothing
runs. ``local_shard``'s blocks tile a leaf."""
import functools
import itertools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JaxAbstractMesh  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.mesh import make_test_mesh as jax_test_mesh  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import input_specs  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.launch.mesh import (AbstractMesh,  # noqa: E402
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MODES = ("train", "serve")


def _meshes(name):
    shape, axes = MESHES[name]
    jm = jax_test_mesh(shape, axes) if name == "1x1" \
        else JaxAbstractMesh(shape, axes)
    return jm, AbstractMesh(shape, axes)


def _flat(tree):
    """The reference's sharding tree as {path: spec tuple}."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(jrules._names(path))] = tuple(s.spec)
    return out


@functools.lru_cache(maxsize=None)
def _param_shapes(arch, smoke):
    cfg = (jax_smoke if smoke else jax_config)(arch)
    return jax.eval_shape(jax_build(cfg).init, jax.random.key(0))


def _port_params(arch, smoke):
    cfg = (get_smoke_config if smoke else get_config)(arch)
    return build_model(cfg).init(device="meta")


def _check_params(arch, mesh_name, smoke):
    jm, tm = _meshes(mesh_name)
    shapes, meta = _param_shapes(arch, smoke), _port_params(arch, smoke)
    for mode, ep in itertools.product(MODES, (False, True)):
        want = _flat(jrules.param_shardings(jm, shapes, mode, moe_ep=ep))
        got = rules.param_shardings(tm, meta, mode, moe_ep=ep)
        assert got == want, (arch, mesh_name, mode, ep)


@pytest.mark.parametrize("mesh_name", ["1x1", "2x4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh_name):
    _check_params(arch, mesh_name, smoke=True)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b"])
def test_full_size_specs_match_the_reference(arch, mesh_name):
    """Params, the serve cache (batch 128 over a 32k ring) and the train
    batch, at full size on the production meshes."""
    _check_params(arch, mesh_name, smoke=False)
    jm, tm = _meshes(mesh_name)
    jcache = jax_build(jax_config(arch)).cache_spec(128, 32768)
    tcache = build_model(get_config(arch)).cache_spec(128, 32768)
    assert rules.cache_shardings(tm, tcache) == \
        _flat(jrules.cache_shardings(jm, jcache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_the_reference(arch):
    """Smoke caches on (2, 4): the ring's sequence over "model" where the
    length divides, the recurrent states' features likewise."""
    for mesh_name, (B, T) in (("1x1", (4, 64)), ("2x4", (4, 64)),
                              ("2x4", (3, 30))):
        jm, tm = _meshes(mesh_name)
        jcache = jax_build(jax_smoke(arch)).cache_spec(B, T)
        tcache = build_model(get_smoke_config(arch)).cache_spec(B, T)
        assert rules.cache_shardings(tm, tcache) == \
            _flat(jrules.cache_shardings(jm, jcache)), (mesh_name, B, T)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_the_reference(arch):
    for mesh_name, mode, (S, B) in (("2x4", "train", (64, 4)),
                                    ("2x4", "serve", (64, 3)),
                                    ("2x16x16", "train", (64, 64))):
        jm, tm = _meshes(mesh_name)
        specs = input_specs(jax_smoke(arch), ShapeConfig("t", S, B, mode))
        meta = {k: torch.empty(v.shape, device="meta")
                for k, v in specs.items()}
        assert rules.batch_shardings(tm, meta, mode) == \
            _flat(jrules.batch_shardings(jm, specs, mode))


def test_fit_spec_and_axes_as_the_reference():
    jm, tm = _meshes("2x4")
    for shape, spec in (((7, 8), ("data", "model")), ((8, 7), ("data", "model")),
                        ((6,), ("model",)), ((8, 8), (("data", "model"),)),
                        ((16, 3), (("data", "model"), None))):
        want = tuple(jrules.fit_spec(shape, jax.sharding.PartitionSpec(
            *spec), jm))
        assert rules.fit_spec(shape, spec, tm) == want, (shape, spec)
    for mode in MODES:
        for name in ("2x4", "2x16x16"):
            jm, tm = _meshes(name)
            ja, ta = jrules.make_axes(jm, mode), rules.make_axes(tm, mode)
            assert (ta.dp, ta.fsdp, ta.model, ta.dp_size) == \
                (ja.dp, ja.fsdp, ja.model, ja.dp_size)
    assert rules.replicated(tm) == tuple(jrules.replicated(jm).spec)


def test_meshes_as_the_reference():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).axis_names == \
        ("pod", "data", "model")
    m = make_test_mesh((2, 4))
    assert isinstance(m, AbstractMesh) and m.size == 8
    # row-major, as jax.make_mesh lays out devices
    assert [tuple(m.coords_of(i).values()) for i in range(8)] == \
        list(itertools.product(range(2), range(4)))


@pytest.mark.parametrize("spec", [("data", "model"), ("model", None),
                                  (("data", "model"), None), (None, "data"),
                                  ()])
def test_local_shard_blocks_tile_the_leaf(spec):
    """Every rank's block of a (8, 12) leaf, placed by the spec, covers
    each element once; ranks that differ only along axes the spec leaves
    out hold the same block."""
    m = AbstractMesh((2, 4), ("data", "model"))
    t = torch.arange(96).reshape(8, 12)
    seen = torch.zeros_like(t)
    blocks = {}
    for i in range(m.size):
        c = m.coords_of(i)
        b = rules.local_shard(t, spec, m, coords=c)
        assert tuple(b.shape) == rules.local_shape(t.shape, spec, m)
        key = tuple(m.linear_index(rules.entry_axes(e), c) for e in spec)
        if key in blocks:
            assert torch.equal(blocks[key], b)
            continue
        blocks[key] = b
        seen[torch.isin(t, b.contiguous())] += 1
    assert torch.equal(seen, torch.ones_like(t))


def test_state_specs_mirror_the_params():
    """The train state's specs (the reference test's ``shardings_for``):
    moments as their params, counts replicated."""
    tm = AbstractMesh((4, 2), ("data", "model"))
    ps = rules.param_shardings(tm, _port_params("glm4-9b", True), "train")
    st = rules.state_shardings(tm, ps)
    assert st["step"] == () and st["opt/count"] == ()
    for p, s in ps.items():
        assert st[f"params/{p}"] == st[f"opt/m/{p}"] == st[f"opt/v/{p}"] == s
    assert len(st) == 3 * len(ps) + 2
