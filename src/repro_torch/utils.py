"""Small shared utilities: dtypes, devices, commit checksums, tree maps."""
from __future__ import annotations

from typing import Any, Callable

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises rather than falling back to the CPU when no card is
    present, so a measurement never runs silently on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host explicitly")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def checksum(x: torch.Tensor) -> torch.Tensor:
    """Commit-stream checksum of a tensor: (mean, mean|x|) in f32."""
    xf = x.float()
    return torch.stack([xf.mean(), xf.abs().mean()])


def has_nan_bit(x: torch.Tensor) -> torch.Tensor:
    """Single-bit 'activation overflow' coverage toggle (f32 nan/inf)."""
    return ~torch.isfinite(x.float()).all()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts, tuples and lists (the
    parameter and cache layouts), keeping the containers' types."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_clone(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor leaf cloned."""
    return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _walk_sorted(t: Any, path: tuple, out: list) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _walk_sorted(t[k], path + (str(k),), out)
    elif isinstance(t, (tuple, list)):
        for i, v in enumerate(t):
            _walk_sorted(v, path + (str(i),), out)
    elif t is not None:
        out.append(("/".join(path), t))


def tree_paths_sorted(tree: Any) -> list:
    """``(path, leaf)`` pairs in the JAX package's flatten order
    (``jax.tree_util.tree_flatten_with_path``): dict keys sorted, tuples
    and lists in order, ``None`` holding no leaf. A path joins the keys
    and indices with "/" (e.g. ``params/stack/blocks/0/attn/k/w``)."""
    # module-level walkers, not nested recursive closures: a closure that
    # calls itself sits in a reference cycle, which would keep the leaves
    # (gigabytes of device memory) alive until the garbage collector runs
    out: list = []
    _walk_sorted(tree, (), out)
    return out


def _rebuild(t: Any, path: tuple, by_path: dict) -> Any:
    if isinstance(t, dict):
        return {k: _rebuild(v, path + (str(k),), by_path)
                for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_rebuild(v, path + (str(i),), by_path)
                       for i, v in enumerate(t))
    return None if t is None else by_path["/".join(path)]


def tree_unflatten_sorted(tree: Any, leaves) -> Any:
    """``tree``'s containers, in their own key order, with its leaves
    replaced by ``leaves`` given in ``tree_paths_sorted`` order."""
    leaves = list(leaves)
    paths = [p for p, _ in tree_paths_sorted(tree)]
    if len(leaves) != len(paths):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(paths)}")
    return _rebuild(tree, (), dict(zip(paths, leaves)))


def tree_structure(tree: Any) -> Any:
    """A hashable description of ``tree``'s containers (types, keys and
    nesting, not the leaves): two trees with equal structures pair leaf
    for leaf in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, tree_structure(v))
                                 for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(tree_structure(v)
                                              for v in tree)
    return "*"


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree``'s containers with its leaves replaced, in ``tree_leaves``
    order, by ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
