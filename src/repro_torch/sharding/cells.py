"""Rank programs of the sharded bodies, shared by the CPU tests
(``tests/test_torch_distributed.py``: smoke widths on host ranks, held
against the JAX package) and ``chip_smoke.py``'s phase 59 (full widths on
ranks that share the card, held against the single-rank port).

A run is a directory holding ``plan.json``: the device, the meshes (built
on every rank in order) and the cells. ``run_plan`` spawns the ranks
(``launch.mesh.run_ranks``); each rank runs every cell whose mesh holds
it. A cell takes its whole inputs from an ``.npz`` file of the directory
(``save_npz``) or draws them from a seed on its device (``draw_inputs``,
which the caller's reference draws alike), cuts this rank's blocks by the
rules (``rules.local_shard``), runs the body, and gathers the whole
outputs on the mesh's first rank, which writes them to
``out_<cell>.npz``. Every rank writes ``metrics_<cell>_<rank>.json``: the
cell's wall time between world barriers, the device's peak memory, the
host copies the collectives staged and the K5 launches.

Kinds: "moe" (``moe_apply`` on a mesh: "a2a" or Expert-TP "sort"; with
``grad`` the f32 gradients too), "decode" (the sequence-sharded
flash-decode, its body on given q/k/v or the whole layer), "pmean"
(``compressed_pmean``), "pipe" (the GPipe loss and gradients), "restore"
(a sharded save on one mesh restored onto another, each rank's block
compared with the same block of the leaf drawn again).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.models import Runtime, build_model
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules
from repro_torch.train.compress import compressed_pmean
from repro_torch.train.pipeline import make_pp_loss, pp_specs
from repro_torch.train.step import state_specs
from repro_torch.utils import tree_paths_sorted, tree_unflatten_sorted

# numpy has no bf16: its bits go through uint16, marked in the key
_BF16 = "@bfloat16"


# ------------------------------------------------------------ npz files ---
def save_npz(path, tensors: dict):
    """Tensors (or numpy arrays) by name; "/" in a name is kept."""
    arrays = {}
    for name, t in tensors.items():
        key = name.replace("/", "|")
        if torch.is_tensor(t):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                arrays[key + _BF16] = t.view(torch.uint16).numpy()
                continue
            t = t.numpy()
        arrays[key] = np.asarray(t)
    np.savez(path, **arrays)


def load_npz(path, device="cpu") -> dict:
    out = {}
    with np.load(path) as z:
        for key in z.files:
            t = torch.from_numpy(z[key])     # a fresh array a member
            name = key.replace("|", "/")
            if name.endswith(_BF16):
                t = t.view(torch.bfloat16)
                name = name[:-len(_BF16)]
            out[name] = t.to(device)
    return out


# ---------------------------------------------------------------- plans ---
def cell_config(cell):
    """The cell's model config: ``arch`` at full size or smoke size
    (``smoke``), ``dtype``, and ``overrides`` of its fields."""
    cfg = (get_smoke_config if cell.get("smoke") else get_config)(
        cell["arch"])
    return dataclasses.replace(cfg, dtype=cell["dtype"],
                               **cell.get("overrides", {}))


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def draw_inputs(cell, device) -> dict:
    """A cell's whole inputs drawn from its ``seed`` on ``device`` (the
    same on every rank and in the caller's reference)."""
    g = _generator(cell["seed"], device)
    if cell["kind"] == "pmean":
        n = cell["ranks"]
        return {"g": torch.randn((n,) + tuple(cell["shape"]), generator=g,
                                 device=device),
                "r": torch.zeros((n,) + tuple(cell["shape"]),
                                 device=device)}
    cfg = cell_config(cell)
    dt = torch.bfloat16 if cell["dtype"] == "bfloat16" else torch.float32
    if cell["kind"] == "moe":
        p = moe_mod.init_moe(g, cfg, device)
        B, S = cell["batch"]
        x = torch.randn((B, S, cfg.d_model), generator=g, device=device)
        return {"router/w": p["router"]["w"], "gate": p["gate"],
                "up": p["up"], "down": p["down"], "x": x.to(dt)}
    if cell["kind"] == "pipe":
        params = build_model(cfg).init(cell["seed"], device=device)
        B, S = cell["batch"]
        out = {f"p/{path}": t for path, t in tree_paths_sorted(params)}
        for name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                      device=device, dtype=torch.int32)
        return out
    raise ValueError(f"no draw for a {cell['kind']!r} cell")


def _inputs(cell, work, device):
    if "npz" in cell:
        return load_npz(work / cell["npz"], device)
    return draw_inputs(cell, device)


def _params_tree(cfg, inputs, prefix="p/"):
    like = build_model(cfg).init(device="meta")
    return tree_unflatten_sorted(
        like, [inputs[prefix + path] for path, _ in tree_paths_sorted(like)])


def _root(mesh):
    return mesh.ranks[0]


def _unmentioned(spec, mesh):
    named = {a for e in spec for a in rules.entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a not in named)


def _grad_of_block(t, spec, mesh):
    """The whole gradient of a leaf from its block's: summed over the
    axes its spec leaves out (shard_map's transpose of a replicated
    input), then gathered on the mesh's first rank."""
    g = t.grad if t.grad is not None else torch.zeros_like(t)
    rest = _unmentioned(spec, mesh)
    if rest:
        g = coll.psum(g, rest, mesh)
    return rules.gather(g, spec, mesh, dst=_root(mesh))


# ---------------------------------------------------------------- cells ---
def moe_cell(cell, meshes, work, device):
    mesh = meshes[cell["mesh"]]
    cfg = cell_config(cell)
    inp = _inputs(cell, work, device)
    data_axes = tuple(cell.get("data_axes", ("data",)))
    pspecs, xspec = moe_mod.moe_specs(cell["impl"], data_axes)

    def blocks():
        p = {k: rules.local_shard(inp[path], pspecs[path], mesh)
             .contiguous() for k, path in (("gate", "gate"), ("up", "up"),
                                           ("down", "down"))}
        p["router"] = {"w": rules.local_shard(inp["router/w"],
                                              pspecs["router/w"], mesh)}
        return p, rules.local_shard(inp["x"], xspec, mesh).contiguous()

    p, x = blocks()
    before = gg_ops.grouped_gemm.launches
    with torch.no_grad():
        y, st = moe_mod.moe_apply(
            p, cfg, x, impl=cell["impl"],
            expert_impl=cell.get("expert_impl", "cuda"), mesh=mesh)
    launches = gg_ops.grouped_gemm.launches - before
    out = {"y": rules.gather(y, xspec, mesh, dst=_root(mesh))}
    out.update({f"stats/{k}": v for k, v in st.items()})
    if cell.get("grad"):
        p, x = blocks()
        leaves = {"gate": p["gate"], "up": p["up"], "down": p["down"],
                  "router/w": p["router"]["w"], "x": x}
        for t in leaves.values():
            t.requires_grad_(True)
        y, _ = moe_mod.moe_apply(p, cfg, x, impl=cell["impl"],
                                 expert_impl="xla", mesh=mesh)
        rest = _unmentioned(xspec, mesh)
        if rest:        # y equal on the ranks along them (Expert-TP)
            y = coll.replicated_output(y, rest, mesh)
        c = rules.local_shard(inp["c"], xspec, mesh)
        (y.float() * c.float()).sum().backward()
        for name, t in leaves.items():
            spec = xspec if name == "x" else pspecs[name]
            out[f"grad/{name}"] = _grad_of_block(t, spec, mesh)
    return out, {"k5_launches": launches}


def decode_cell(cell, meshes, work, device):
    """Teacher-forced decode steps from ``start`` over a ring of ``ring``
    slots: the body on given q/k/v (``body``) or the whole layer on given
    hidden states."""
    mesh = meshes[cell["mesh"]]
    cfg = cell_config(cell)
    inp = _inputs(cell, work, device)
    data_axes = tuple(cell.get("data_axes", ("data",)))
    B = inp["ring/k"].shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    specs = attn.decode_specs(B, H * hd, mesh, data_axes)
    b = specs["cache"][0]
    cache = {n: rules.local_shard(inp[f"ring/{n}"], specs["cache"], mesh)
             .clone() for n in ("k", "v")}
    p = _nest({k[2:]: v for k, v in inp.items() if k.startswith("p/")})
    outs = []
    with torch.no_grad():
        for t in range(cell["steps"]):
            pos = torch.tensor(cell["start"] + t, dtype=torch.int32,
                               device=device)
            if cell.get("body"):
                q, k, v = (rules.local_shard(inp[n][t], specs["x"], mesh)
                           for n in ("q", "k", "v"))
                o, cache = attn._decode_attention_sharded(
                    cfg, q, k, v, cache, pos, mesh=mesh,
                    softcap=cfg.attn_logit_softcap)
            else:
                x = rules.local_shard(inp["x"][t], (b, None, None), mesh)
                o, cache = attn.decode_attention_apply(
                    p, cfg, x, cache, pos, impl="xla", mesh=mesh)
            outs.append(o)
    out_spec = (None,) + (specs["out"] if cell.get("body")
                          else (b, None, None))
    root = _root(mesh)
    return {"out": rules.gather(torch.stack(outs), out_spec, mesh, dst=root),
            "ring/k": rules.gather(cache["k"], specs["cache"], mesh,
                                   dst=root),
            "ring/v": rules.gather(cache["v"], specs["cache"], mesh,
                                   dst=root)}, {}


def _nest(flat):
    """{"a/b": t} -> {"a": {"b": t}}."""
    out: dict = {}
    for path, t in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = t
    return out


def pmean_cell(cell, meshes, work, device):
    """``rounds`` error-feedback rounds of ``compressed_pmean``: rank i
    of the axis holds gradient g[i] and residual r[i]."""
    mesh = meshes[cell["mesh"]]
    axis = mesh.axis_names[0]
    inp = _inputs(cell, work, device)
    i = mesh.axis_index(axis)
    g, r = inp["g"][i], inp["r"][i].clone()
    del inp
    with torch.no_grad():
        for _ in range(cell.get("rounds", 1)):
            out, r = compressed_pmean(g, axis, r, mesh)
    spec = (axis,) + (None,) * g.dim()
    return {"out": rules.gather(out[None], spec, mesh, dst=_root(mesh)),
            "resid": rules.gather(r[None], spec, mesh, dst=_root(mesh))}, {}


def pipe_cell(cell, meshes, work, device):
    """The GPipe loss and its gradients on this rank's stage; the whole
    gradients gathered on the mesh's first rank."""
    mesh = meshes[cell["mesh"]]
    cfg = cell_config(cell)
    inp = _inputs(cell, work, device)
    params = _params_tree(cfg, inp)
    specs = pp_specs(params)
    local = {path: rules.local_shard(t, specs[path], mesh).detach().clone()
             .requires_grad_(t.is_floating_point())
             for path, t in tree_paths_sorted(params)}
    del params
    tree = tree_unflatten_sorted(build_model(cfg).init(device="meta"),
                                 [local[k] for k in sorted(local)])
    loss_fn = make_pp_loss(cfg, mesh, mesh.shape["pipe"], cell["micro"],
                           rt=Runtime(attention_impl="xla"))
    loss = loss_fn(tree, {"tokens": inp["tokens"].long(),
                          "labels": inp["labels"].long()})
    loss.backward()
    out = {"loss": loss.detach().float().reshape(1)}
    for path, t in local.items():
        if t.is_floating_point():
            g = t.grad if t.grad is not None else torch.zeros_like(t)
            out[f"grad/{path}"] = rules.gather(g, specs[path], mesh,
                                               dst=_root(mesh))
    return out, {}


def draw_leaf(seed: int, index: int, shape, dtype, device):
    """Leaf ``index`` of a drawn train state: N(0, 1) floats, small
    integers."""
    g = _generator(seed * 1000003 + index, device)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=device).to(dtype)
    return torch.randint(0, 1000, shape, generator=g, device=device,
                         dtype=dtype)


def restore_cell(cell, meshes, work, device):
    """A train state drawn leaf by leaf, held as blocks of mesh ``mesh``,
    saved, restored onto mesh ``to``, and every rank's block held against
    the same block of its leaf drawn again. The outputs are counts:
    leaves whose every block equals its draw, blocks of their spec's
    shape."""
    src, dst = meshes[cell["mesh"]], meshes[cell["to"]]
    cfg = cell_config(cell)
    like = state_specs(build_model(cfg))
    flat = tree_paths_sorted(like)

    def specs(mesh):
        return rules.state_shardings(mesh, rules.param_shardings(
            mesh, like["params"], "train"))

    mgr = CheckpointManager(str(work / f"ckpt_{cell['name']}"))
    t0 = time.perf_counter()
    if src.member:
        s_from = specs(src)
        blocks = []
        for i, (path, t) in enumerate(flat):
            whole = draw_leaf(cell["seed"], i, t.shape, t.dtype, device)
            blocks.append(rules.local_shard(whole, s_from[path], src)
                          .clone())
            del whole
        mgr.save(tree_unflatten_sorted(like, blocks), 1, blocking=True,
                 shardings=s_from, mesh=src)
        del blocks
    save_s = time.perf_counter() - t0
    dist.barrier()
    out = {}
    if dst.member:
        t0 = time.perf_counter()
        s_to = specs(dst)
        restored, step = mgr.restore(like, shardings=s_to, mesh=dst)
        restore_s = time.perf_counter() - t0
        shapes_ok = 0
        same = torch.zeros(len(flat), dtype=torch.int64)
        for i, (path, t) in enumerate(tree_paths_sorted(restored)):
            spec = s_to[path]
            shapes_ok += tuple(t.shape) == rules.local_shape(
                flat[i][1].shape, spec, dst)
            # this rank's block against the same block of the leaf drawn
            # again, on its device (gathering the state onto one rank
            # would stage all of it through host memory)
            want = draw_leaf(cell["seed"], i, flat[i][1].shape,
                             flat[i][1].dtype, device)
            same[i] = bool(torch.equal(t, rules.local_shard(want, spec,
                                                             dst)))
            del want
        # a leaf is equal where every rank of the new mesh found its block
        # equal
        equal = int((coll.psum(same, dst.axis_names, dst)
                     == dst.size).sum())
        # and rebuilt on every rank (the all-gather): the smallest leaf
        # the new mesh splits
        i, path = min((math.prod(t.shape), i, p) for i, (p, t) in
                      enumerate(flat)
                      if any(rules.entry_axes(e) for e in s_to[p]))[1:]
        whole = rules.gather(dict(tree_paths_sorted(restored))[path],
                             s_to[path], dst)
        everywhere = bool(torch.equal(whole, draw_leaf(
            cell["seed"], i, flat[i][1].shape, flat[i][1].dtype, device)))
        out = {"leaves": torch.tensor([len(flat)]),
               "equal": torch.tensor([equal]),
               "shapes_ok": torch.tensor([shapes_ok]),
               "step": torch.tensor([step])}
        return out, {"save_s": save_s, "restore_s": restore_s,
                     "shapes_ok": shapes_ok, "all_gather_equal": everywhere}
    return None, {"save_s": save_s}


KINDS = {"moe": moe_cell, "decode": decode_cell, "pmean": pmean_cell,
         "pipe": pipe_cell, "restore": restore_cell}


# ---------------------------------------------------------------- ranks ---
def _host_copies(meshes):
    return sum(m.host_copies for m in meshes.values() if m.member)


def rank_main(rank: int, work: str):
    """One rank of a plan (``run_plan``)."""
    work = pathlib.Path(work)
    plan = json.loads((work / "plan.json").read_text())
    device = torch.device(plan["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        # host ranks compute on one thread each: the world shares the
        # host's cores with whatever else runs there
        torch.set_num_threads(1)
    meshes = {name: Mesh(m["shape"], m["axes"], device=device,
                         ranks=m.get("ranks")) for name, m in
              plan["meshes"].items()}
    for cell in plan["cells"]:
        mesh = meshes[cell["mesh"]]
        runs = mesh.member or cell["kind"] == "restore"
        dist.barrier()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        copies = _host_copies(meshes)
        t0 = time.perf_counter()
        out, metrics = KINDS[cell["kind"]](cell, meshes, work, device) \
            if runs else (None, {})
        if device.type == "cuda":
            torch.cuda.synchronize()
        metrics.update(
            rank=rank, member=mesh.member,
            wall_s=time.perf_counter() - t0,
            host_copies=_host_copies(meshes) - copies,
            peak_bytes=torch.cuda.max_memory_allocated()
            if device.type == "cuda" else None)
        if out is not None \
                and rank == _root(meshes[cell.get("to", cell["mesh"])]):
            save_npz(work / f"out_{cell['name']}.npz",
                     {k: v for k, v in out.items() if v is not None})
        (work / f"metrics_{cell['name']}_{rank}.json").write_text(
            json.dumps(metrics))
        del out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()


def run_plan(work, plan: dict, world: int, timeout_s: float = 300.0):
    """Write ``plan`` into the directory ``work``, run it on ``world``
    spawned ranks and return (wall seconds, {cell: (outputs on the host,
    [metrics of each rank])})."""
    work = pathlib.Path(work)
    (work / "plan.json").write_text(json.dumps(plan))
    wall = run_ranks(rank_main, world, str(work), timeout_s=timeout_s)
    results = {}
    for cell in plan["cells"]:
        name = cell["name"]
        f = work / f"out_{name}.npz"
        results[name] = (load_npz(f) if f.exists() else None,
                         [json.loads((work / f"metrics_{name}_{r}.json")
                                     .read_text()) for r in range(world)])
    return wall, results
