"""Device meshes over ``torch.distributed``, and the processes behind them.

A ``Mesh`` is the JAX package's ``jax.sharding.Mesh`` for a port whose
ranks are processes: axis names and a ``shape`` mapping, this rank's
coordinates, its device, and one gloo process group for every subset of
the axes (a collective over ``("pod", "data")`` or over every axis runs on
the subset's group). Ranks are laid out row-major over the shape, as
``jax.make_mesh`` lays out devices. A mesh may span only some ranks of
the world (``ranks=``); every rank of the world still builds it, because
creating a process group is collective, and ranks outside it hold a mesh
with ``member`` False.

An ``AbstractMesh`` has a shape and no processes: the sharding rules run
on it (``make_production_mesh``'s (16, 16) and (2, 16, 16) are abstract;
nobody starts 256 processes).

The backend is gloo: on host tensors, and on the card too while ranks
share one device (NCCL refuses two ranks on one device). The world is
joined through a ``FileStore`` in a temporary directory, never a fixed TCP
port, and every group has a timeout, so a hung collective fails instead of
hanging. ``run_ranks`` spawns the ranks, joins them against a deadline and
raises if any rank fails or outlives it.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from repro_torch.utils import resolve_device

# every collective and process group of a world fails after this long
TIMEOUT_S = 120.0


class AbstractMesh:
    """Axis names and sizes, no processes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.size = math.prod(self.shape.values())
        self.coords = None

    def axis_size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of
        names)."""
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[a] for a in axes)

    def coords_of(self, index: int) -> Dict[str, int]:
        """The coordinates of the ``index``-th rank of the mesh
        (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            index, out[a] = divmod(index, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def linear_index(self, axes, coords=None) -> int:
        """The row-major index of ``coords`` (this rank's on a ``Mesh``)
        along ``axes`` in the order given: the block a dim sharded over
        ``axes`` gives this rank."""
        if isinstance(axes, str):
            axes = (axes,)
        coords = self.coords if coords is None else coords
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
        return idx

    def __repr__(self):
        return f"{type(self).__name__}({self.shape})"


def _subsets(names):
    return [c for n in range(1, len(names) + 1)
            for c in itertools.combinations(names, n)]


class Mesh(AbstractMesh):
    """This rank's view of a mesh over the ranks ``ranks`` of the world
    (all of them by default); build it on every rank of the world, in the
    same order, after ``init_distributed``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, ranks: Optional[Sequence[int]] = None):
        import torch.distributed as dist
        super().__init__(shape, axis_names)
        world = dist.get_world_size()
        self.ranks = tuple(range(world) if ranks is None else ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"a mesh of {self.size} ranks over "
                             f"{len(self.ranks)}: {self.ranks}")
        self.device = resolve_device(device)
        me = dist.get_rank()
        self.member = me in self.ranks
        self.index = self.ranks.index(me) if self.member else None
        self.coords = self.coords_of(self.index) if self.member else None
        # staged copies of CUDA tensors through pinned host memory, for the
        # collectives gloo does not run on CUDA tensors (collectives.py)
        self.host_copies = 0
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        for axes in _subsets(self.axis_names):
            for ranks_ in self._partition(axes):
                group = dist.new_group(list(ranks_), timeout=timeout,
                                       backend="gloo")
                if me in ranks_:
                    self._groups[axes] = group
                    self._members[axes] = ranks_

    def _partition(self, axes):
        """The rank groups along ``axes``: ranks that share every other
        coordinate, each tuple sorted (the group's rank order)."""
        groups: Dict[tuple, list] = {}
        for i, r in enumerate(self.ranks):
            c = self.coords_of(i)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append(r)
        return [tuple(sorted(g)) for g in groups.values()]

    def _key(self, axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(axes)
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in {self}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        """The process group of this rank along ``axes``."""
        self._require_member()
        return self._groups[self._key(axes)]

    def members(self, axes) -> Tuple[int, ...]:
        """The world ranks of this rank's group along ``axes``, in the
        group's rank order."""
        self._require_member()
        return self._members[self._key(axes)]

    def coords_of_rank(self, rank: int) -> Dict[str, int]:
        return self.coords_of(self.ranks.index(rank))

    def axis_index(self, name: str) -> int:
        self._require_member()
        return self.coords[name]

    def _require_member(self):
        if not self.member:
            raise RuntimeError(f"this rank is not in {self}")

    def __repr__(self):
        return f"Mesh({self.shape}, ranks={self.ranks})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production layouts, (16, 16) data x model or (2, 16, 16) pod x
    data x model, as abstract meshes: the rules run on their shapes."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *, device=None,
                   ranks=None):
    """A small mesh: abstract where no process group is up (the rules'
    tests), else over the world's ranks."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return AbstractMesh(shape, axes)
    return Mesh(shape, axes, device=device, ranks=ranks)


# ------------------------------------------------------------ processes ---
def init_distributed(rank: int, world: int, store_path: str):
    """Join the world of ``world`` ranks through the FileStore at
    ``store_path`` (gloo, every collective bounded by TIMEOUT_S)."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _rank_entry(rank, fn, world, store_path, args):
    import torch.distributed as dist
    init_distributed(rank, world, store_path)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args,
              timeout_s: float = 300.0) -> float:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined into
    one gloo world through a FileStore of their own. ``fn`` must be a
    module-level function (it is pickled by name). Raises if a rank raises
    or exits non-zero, or if the ranks are not all done ``timeout_s``
    after the spawn (then every rank is killed). Returns the wall time."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="zp_mesh_") as d:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, os.path.join(d, "store"), args),
            nprocs=world, join=False, start_method="spawn")
        deadline = t0 + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.perf_counter()))):
                if time.perf_counter() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__qualname__} still running "
                        f"after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    return time.perf_counter() - t0
