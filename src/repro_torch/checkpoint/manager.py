"""Fault-tolerant checkpointing: async, integrity-checked, on the JAX
package's on-disk layout.

Layout (one directory per step), the reference's exactly:
    <dir>/step_000042/manifest.json     paths, shapes, dtypes, crc32s
    <dir>/step_000042/<leaf-path>.npy   one file per leaf

Leaves are named by their logical path in the JAX package's flatten order
(``utils.tree_paths_sorted``: sorted dict keys), and bf16 (and fp8) leaves
are stored as their raw unsigned-integer view with the logical dtype name
in the manifest, as the reference stores ``ml_dtypes`` arrays. So a
checkpoint written by either package restores in the other, bit for bit.

Contract pieces:
  - atomic publish: write into step_X.tmp, then rename — a crash mid-save
    can never corrupt the latest checkpoint;
  - async: the device-to-host copy happens at save() call (forced host
    copies: the next window writes the train state in place), the file
    I/O in a background thread; a background write that FAILS is never
    silent — the error is recorded and re-raised on the next ``wait()``
    or ``save()`` call;
  - integrity: per-leaf crc32 verified on restore (detects torn writes),
    raised as :class:`SnapshotIntegrityError`; ``restore(fallback=True)``
    walks back to the newest VERIFIABLE snapshot instead of raising on a
    corrupt/partial one;
  - retention: keep the newest ``keep`` checkpoints.

Sharded states (the elastic path): ``save(shardings=, mesh=)`` gathers
each whole leaf from the ranks' blocks onto the rank that writes (the
mesh's first), one leaf at a time, and the snapshot keeps its on-disk
format; ``restore(shardings=, mesh=)`` reads the whole-leaf snapshot one
leaf at a time and returns this rank's block of every leaf under the
specs given for the (possibly different) new mesh.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.sharding import rules
from repro_torch.utils import tree_paths_sorted, tree_unflatten_sorted

# numpy has no bf16 or fp8: such a leaf is stored as its raw view and the
# logical dtype name goes into the manifest (the reference's _EXOTIC)
# leaf files written or read at once by one save or restore
_IO_THREADS = 8
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8)}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _encode(t: torch.Tensor):
    """A host tensor as the numpy array written to disk and its logical
    dtype name."""
    name = _dtype_name(t)
    if name in _EXOTIC:
        return t.view(_EXOTIC[name][1]).numpy(), name
    return t.numpy(), name


def _decode(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(raw)
    return t.view(_EXOTIC[dtype_name][0]) if dtype_name in _EXOTIC else t


def _host_copy(x):
    """A forced host copy: never a view of a buffer the caller (or the
    next window's replay) writes again."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(x))


def _leaf_paths(tree) -> List[str]:
    return [p for p, _ in tree_paths_sorted(tree)]


class SnapshotIntegrityError(IOError):
    """A snapshot failed its content-digest check (torn write, truncated
    directory, bit flip). Carries the offending ``step`` so a fallback
    path can log exactly which snapshot was written off."""

    def __init__(self, message: str, step: Optional[int] = None):
        super().__init__(message)
        self.step = step


def _tree_digest(leaves) -> int:
    """Order-sensitive crc32 over every leaf's raw bytes — the snapshot's
    content digest (bf16 leaves by their raw 2-byte words, as the
    reference digests ``ml_dtypes`` arrays)."""
    crc = 0
    for x in leaves:
        raw = _encode(x.detach().cpu())[0] if torch.is_tensor(x) \
            else np.asarray(x)
        crc = zlib.crc32(np.ascontiguousarray(raw), crc)
    return crc


def step_to_window(step: int, interval: int) -> int:
    """Step→window mapping for resume cursors: the number of
    ``interval``-sized windows fully contained in ``step`` committed steps
    (the tail window of a non-divisible stream counts once it completed —
    ceil division, matching ``plan_windows`` boundaries)."""
    interval = max(1, interval)
    return -(-step // interval)


def _place(tree, like, copy: bool = True):
    """``tree``'s tensors, each on the device of ``like``'s leaf at its
    path (the host where ``like`` is None or on the meta device), copied
    even where already there unless ``copy=False``; shapes and dtypes must
    match ``like``'s."""
    if like is None:
        return tree_unflatten_sorted(
            tree, [t.clone() for _, t in tree_paths_sorted(tree)])
    out = []
    for (path, t), (ref_path, ref) in zip(tree_paths_sorted(tree),
                                          tree_paths_sorted(like),
                                          strict=True):
        if path != ref_path or tuple(t.shape) != tuple(ref.shape) \
                or t.dtype != ref.dtype:
            raise ValueError(f"{path}: the snapshot holds {t.dtype}"
                             f"{list(t.shape)}, the state {ref.dtype}"
                             f"{list(ref.shape)}")
        device = "cpu" if ref.device.type == "meta" else ref.device
        out.append(t.to(device, copy=copy))
    return tree_unflatten_sorted(like, out)


class MemorySnapshotStore:
    """In-process snapshot target with the :class:`CheckpointManager`
    save/restore contract (atomic publish, retention, latest-step restore)
    but no file I/O: leaves are host-copied at ``save`` and the snapshot
    becomes visible in one reference swap. ``restore`` returns copies
    (onto ``like``'s devices where given), because the port's steps update
    their state in place and would otherwise write into the snapshot."""

    def __init__(self, keep: int = 2):
        self.keep = keep
        self._snaps: Dict[int, Any] = {}
        self._digests: Dict[int, int] = {}

    def save(self, state, step: int, blocking: bool = True):
        flat = tree_paths_sorted(state)
        host = [_host_copy(x) for _, x in flat]
        self._digests[step] = _tree_digest(host)
        self._snaps[step] = tree_unflatten_sorted(state, host)
        for s in sorted(self._snaps)[:-self.keep]:
            del self._snaps[s]
            self._digests.pop(s, None)

    def wait(self):
        pass                                        # saves are synchronous

    def steps(self) -> List[int]:
        return sorted(self._snaps)

    def verify(self, step: int) -> bool:
        """Re-digest a snapshot's leaves against the digest recorded at
        save time — False means the stored bytes were mutated after
        publish."""
        if step not in self._snaps:
            return False
        leaves = [x for _, x in tree_paths_sorted(self._snaps[step])]
        return _tree_digest(leaves) == self._digests.get(step)

    def restore(self, like=None, step: Optional[int] = None,
                fallback: bool = False):
        if not self._snaps:
            raise FileNotFoundError("no snapshots published")
        step = max(self._snaps) if step is None else step
        candidates = [step] + ([s for s in sorted(self._snaps, reverse=True)
                                if s < step] if fallback else [])
        for s in candidates:
            if s in self._snaps and self.verify(s):
                return _place(self._snaps[s], like), s
        raise SnapshotIntegrityError(
            f"snapshot digest mismatch at step {step}"
            + (" (no older verifiable snapshot)" if fallback else ""),
            step=step)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save ---
    def save(self, state, step: int, blocking: bool = False, *,
             shardings=None, mesh=None):
        """Snapshot to host memory now; write files asynchronously. A
        prior async save that FAILED (disk full, permission lost) raises
        here — a failed write must never be silently absorbed while the
        caller keeps training past it.

        A sharded ``state`` (this rank's blocks under ``shardings``,
        ``{path: spec}``, on ``mesh``) is saved by every rank of the
        mesh: each whole leaf is gathered onto the mesh's first rank,
        which alone writes; the others return once the gathers are
        done."""
        self.wait()                                # one in-flight save max
        flat = tree_paths_sorted(state)
        paths = [p for p, _ in flat]
        if shardings is None:
            host_leaves = [_host_copy(x) for _, x in flat]
        else:
            # each gathered leaf is a new host tensor on the writer
            writer = mesh.ranks[0]
            host_leaves = [rules.gather(x, shardings[p], mesh, dst=writer)
                           for p, x in flat]
            if mesh.index != 0:
                return

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            final = self.dir / f"step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)

            def write_leaf(p, t):
                fp = tmp / (p.replace("/", "__") + ".npy")
                raw, dtype_name = _encode(t)
                np.save(fp, raw)
                return {
                    "path": p, "file": fp.name,
                    "shape": list(t.shape), "dtype": dtype_name,
                    # crc32 reads the array's own buffer: no copy, and
                    # zlib lets the other threads run meanwhile
                    "crc32": zlib.crc32(np.ascontiguousarray(raw)),
                    # whole leaves, however the state was sharded
                    "sharding": "None",
                }

            # leaves written and checksummed in parallel (np.save's write
            # and zlib release the interpreter lock), listed in order
            with ThreadPoolExecutor(_IO_THREADS) as pool:
                manifest = {"step": step, "leaves": list(
                    pool.map(write_leaf, paths, host_leaves))}
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)                       # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — surfaced at
                    self._error = e         # the next wait()/save()
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore ---
    def steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if p.is_dir() and not p.name.endswith(".tmp"))

    def verify(self, step: int) -> bool:
        """Integrity-check one on-disk snapshot without building a tree:
        readable manifest, every leaf file present, every crc32 matching.
        False on ANY torn/partial/corrupt state."""
        d = self.dir / f"step_{step:08d}"
        try:
            with open(d / "manifest.json") as f:
                manifest = json.load(f)
            for meta in manifest["leaves"]:
                raw = np.load(d / meta["file"])
                if zlib.crc32(np.ascontiguousarray(raw)) != meta["crc32"]:
                    return False
        except Exception:       # noqa: BLE001 — unreadable IS unverifiable
            return False
        return True

    def _load_step(self, like, step: int, convert=None):
        """The snapshot's leaves in ``like``'s structure, each passed
        through ``convert(path, leaf)`` as soon as it is read and checked
        (so one whole leaf at a time is held) where one is given."""
        d = self.dir / f"step_{step:08d}"

        def unreadable(e):
            # torn write: missing/truncated/unparseable
            return SnapshotIntegrityError(
                f"unreadable snapshot at step {step}: {e!r}", step=step)

        try:
            with open(d / "manifest.json") as f:
                manifest = json.load(f)
            by_path = {l["path"]: l for l in manifest["leaves"]}
        except Exception as e:  # noqa: BLE001 — unreadable IS corrupt
            raise unreadable(e) from e
        def read_leaf(p):
            try:
                meta = by_path[p]
                raw = np.load(d / meta["file"])
            except Exception as e:
                raise unreadable(e) from e
            if zlib.crc32(np.ascontiguousarray(raw)) != meta["crc32"]:
                raise SnapshotIntegrityError(
                    f"checksum mismatch for {p} in step {step}", step=step)
            try:
                return _decode(raw, meta["dtype"])
            except Exception as e:
                raise unreadable(e) from e

        # leaves read and checked in parallel, at most _IO_THREADS ahead
        # of the one taken (so few whole leaves are held at once), and
        # taken in order
        paths = _leaf_paths(like)
        leaves = []
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            ahead = [pool.submit(read_leaf, p)
                     for p in paths[:_IO_THREADS]]
            try:
                for i, p in enumerate(paths):
                    t = ahead[i].result()
                    ahead[i] = None
                    if i + _IO_THREADS < len(paths):
                        ahead.append(pool.submit(read_leaf,
                                                 paths[i + _IO_THREADS]))
                    leaves.append(t if convert is None else convert(p, t))
                    del t
            finally:
                for f in ahead:
                    if f is not None:
                        f.cancel()
        return tree_unflatten_sorted(like, leaves)

    def restore(self, like, step: Optional[int] = None,
                shardings=None, fallback: bool = False, *,
                mesh=None) -> Any:
        """Load into the structure of ``like``, each leaf onto the device
        of ``like``'s leaf (the host for a meta-device ``like``). A
        corrupt or partially-written snapshot raises
        :class:`SnapshotIntegrityError`; with ``fallback=True`` the restore
        walks back to the newest OLDER snapshot that verifies instead (the
        returned step tells the caller how far back it landed). Returns
        ``(tree, step)``.

        With ``shardings`` (``{path: spec}`` for the new ``mesh``), the
        elastic path: ``like`` gives the whole leaves' structure, shapes
        and dtypes (meta tensors do), and the tree returned holds this
        rank's block of each leaf, on ``mesh.device``, read one whole leaf
        at a time."""
        convert = None
        if shardings is not None:
            shapes = {p: (tuple(t.shape), t.dtype)
                      for p, t in tree_paths_sorted(like)}

            def convert(path, t):
                if (tuple(t.shape), t.dtype) != shapes[path]:
                    raise ValueError(
                        f"{path}: the snapshot holds {t.dtype}"
                        f"{list(t.shape)}, the state {shapes[path][1]}"
                        f"{list(shapes[path][0])}")
                block = rules.local_shard(t, shardings[path], mesh)
                return block.to(mesh.device, copy=True).contiguous()
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step = steps[-1] if step is None else step
        candidates = [step] + ([s for s in sorted(steps, reverse=True)
                                if s < step] if fallback else [])
        tree, landed, err = None, None, None
        for s in candidates:
            try:
                tree, landed = self._load_step(like, s, convert), s
                break
            except SnapshotIntegrityError as e:
                err = err or e
        if tree is None:
            raise err or SnapshotIntegrityError(
                f"no verifiable snapshot at or below step {step}",
                step=step)
        if shardings is not None:
            return tree, landed
        return _place(tree, like, copy=False), landed
