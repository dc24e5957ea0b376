"""ZP-Scope: the on-device instrumentation plane of the port (the
AutoCounter/TracerV analog).

ZynqParrot observes the DUT without interfering with it, at any
granularity. The plane does that with counters that ride the DUT's own
window stream:

  counters — per-window step and token (output element) accumulators;
  gates    — coverage toggle bits OR-accumulated on the device (nonfinite /
             zero / negative / positive activity over the output leaves),
             the saturating-bitmap semantics ``CoverageMap`` applies to
             drained CSRs;
  trace    — a bounded ring of per-step records, fixed slots so shapes stay
             static, each row ``[global_step, mean_abs, max_abs,
             nonfinite]`` from the window's first output leaf;
  digest   — a per-window commit digest (an order-sensitive uint32 fold
             over the output leaves' bit patterns), cumulative and in a
             ring of ``every_n_windows`` slots, which gives
             ``CommitStreamVerifier`` a first-pass check.

Non-interference is structural: the counter tree rides BESIDE the engine's
shell in a composite ``{"zp_dut": shell, "zp_scope": counters}``, and the
DUT never reads a counter, so state, outputs and shell are bit-identical
with the plane on or off. The counters accumulate on the device; the host
reads them every ``every_n_windows`` drains (the read rate), plus one
final tail sample. On the scheduler's overlapped path that read comes from
the host copy of the window's snapshot the scheduler already queues, so
the plane adds no host sync there.

The update runs no host sync and no Python branch on a device value (the
ring slots are device tensors written with ``index_copy``), so it can be
captured into a CUDA graph. With ``spec.fuse`` and an engine that is a
``WindowGraphs`` (``core/graphs.py``), it is: the window and the update are
one capture, and a window stays one replay. Otherwise (``fuse=False``, or
an engine that is not graphed) the update runs eagerly after the engine,
on the same stream.

uint32 arithmetic: torch has few uint32 operations (``arange`` and
``sum`` are missing on the CPU), so the device fold runs in int64 on the
``int32`` view of the f32 cast, masked to 32 bits. A product of two 32-bit
values needs 64 bits, so the weight is split into 16-bit halves and every
product stays below 2**48; each element's term is masked before the sum,
and long leaves are summed in chunks, so each int64 sum is exact. The
device fold, the numpy twin ``fold_host`` and the JAX package's fold agree
bit for bit.

Leaf order: leaves are walked in sorted-key order
(``utils.tree_paths_sorted``, the JAX flatten order), since the digest
combine is order-sensitive and the first leaf feeds the trace ring.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.graphs import WindowGraphs
from repro_torch.utils import tree_leaves, tree_map, tree_paths_sorted

# Composite-shell keys. The counter tree rides beside the DUT shell under
# these reserved names; ``is_scoped`` keys off the exact pair, so a plain
# user shell (any other dict) is never mistaken for an instrumented one.
DUT_KEY = "zp_dut"
SCOPE_KEY = "zp_scope"

GATE_NAMES = ("nonfinite", "zero", "negative", "positive")

# Digest constants (Knuth multiplicative hash + FNV-like leaf combine),
# exact arithmetic mod 2**32.
_PHI = 2654435761
_SALT = 40503
_FNV = 16777619
_M32 = 0xFFFFFFFF
_LO16 = 0xFFFF
# elements a device-fold chunk sums at once: each term is below 2**32, so
# an int64 sum of up to 2**31 terms is exact; smaller chunks bound the
# int64 temporaries
_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class ScopeSpec:
    """Configuration of one plane. Frozen and hashable, so planes that are
    to share one counter tree can require equal specs.

    every_n_windows — the read rate: the host reads the counter tree every
        N window drains (plus one final tail sample).
    ring_slots — per-step trace ring capacity (0 disables the ring).
    digest / gates — enable the commit-digest fold / the gate bits.
    fuse — run the counter update inside the engine's own dispatch: for a
        ``WindowGraphs`` engine, captured into the same CUDA graph as the
        window. The default runs it as its own small eager pass after
        the engine, which leaves the engine's graphs untouched.
    """
    every_n_windows: int = 1
    ring_slots: int = 16
    digest: bool = True
    gates: bool = True
    fuse: bool = False


def is_scoped(shell) -> bool:
    """True if ``shell`` is a scope composite (DUT shell + counter tree)."""
    return (isinstance(shell, dict)
            and set(shell.keys()) == {DUT_KEY, SCOPE_KEY})


def unwrap(shell):
    """The DUT shell inside a scope composite (identity on plain shells)."""
    return shell[DUT_KEY] if is_scoped(shell) else shell


def scope_tree(shell):
    """The device-side counter tree, or ``None`` for plain shells."""
    return shell[SCOPE_KEY] if is_scoped(shell) else None


# ------------------------------------------------------------- digesting --
def _as_f32_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()           # exact: bf16 is the top half of f32
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x, np.float32)).reshape(-1)


def fold_host(x) -> int:
    """Host twin of the device fold over ONE array (numpy or tensor): cast
    to f32, reinterpret the bit patterns as uint32, weight by position,
    sum mod 2**32."""
    bits = _as_f32_numpy(x).view(np.uint32)
    n = bits.size
    if n == 0:
        return 0
    w = np.arange(n, dtype=np.uint32) * np.uint32(_PHI) + np.uint32(_SALT)
    return int((bits * w).sum(dtype=np.uint32))


def digest_tree(ys) -> int:
    """Host twin of the per-window digest: fold every output leaf in
    sorted-key order and combine. ``CommitStreamVerifier`` compares a
    drained window's digest against this over an oracle's outputs."""
    d = 0
    for _, leaf in tree_paths_sorted(ys):
        d = ((d * _FNV) + fold_host(leaf)) & _M32
    return d


def _mul32(a, b_lo: Any, b_hi: Any):
    """(a * b) mod 2**32 in int64 for 0 <= a, b < 2**32, b given as its
    16-bit halves: each product stays below 2**48."""
    return (a * b_lo + (((a * b_hi) & _LO16) << 16)) & _M32


def fold_dev(x: torch.Tensor, lanes: int = 1) -> torch.Tensor:
    """Device digest fold: an int64 scalar in [0, 2**32), or a ``(lanes,)``
    vector folding each lane slice (axis 0) where ``lanes > 1``."""
    f = x.detach().to(torch.float32).contiguous()
    bits = f.view(torch.int32).to(torch.int64) & _M32
    bits = bits.reshape(lanes, -1) if lanes > 1 else bits.reshape(-1)
    n = bits.shape[-1]
    total = torch.zeros(bits.shape[:-1], dtype=torch.int64,
                        device=bits.device)
    for start in range(0, n, _CHUNK):
        b = bits[..., start:start + _CHUNK]
        i = torch.arange(start, start + b.shape[-1], dtype=torch.int64,
                         device=bits.device) & _M32
        w = (_mul32(i, _PHI & _LO16, _PHI >> 16) + _SALT) & _M32
        term = _mul32(b, w & _LO16, w >> 16)
        total = (total + term.sum(-1)) & _M32
    return total


# ----------------------------------------------------------- scope state --
def scope_init(spec: ScopeSpec, lanes: int = 1, device=None):
    """A fresh counter tree on ``device`` (the host where None). All shapes
    are static: counters are scalars (per-lane vectors under a lane
    batch), the trace ring and the per-window digest ring have fixed slot
    counts. Digests are int64 holding uint32 values."""
    device = torch.device("cpu") if device is None else torch.device(device)

    def z(shape, dtype, per_lane=True):
        if lanes > 1 and per_lane:
            shape = (lanes,) + shape
        return torch.zeros(shape, dtype=dtype, device=device)

    tree = {"windows": z((), torch.int32, False),
            "steps": z((), torch.int32, False),
            "tokens": z((), torch.float32)}
    if spec.gates:
        tree["gates"] = z((len(GATE_NAMES),), torch.int32)
    if spec.digest:
        tree["digest"] = z((), torch.int64)
        tree["win_digests"] = z((max(1, spec.every_n_windows),),
                                torch.int64)
    if spec.ring_slots > 0:
        tree["trace"] = z((spec.ring_slots, 4), torch.float32)
        tree["trace_pos"] = z((), torch.int32, False)
    return tree


def make_update(spec: ScopeSpec, lanes: int = 1) -> Callable:
    """The per-window counter update ``(scope, ys) -> scope``: new tensors
    from the window's stacked outputs, never touching the DUT's values,
    with no host sync (capturable in a CUDA graph)."""
    L = max(1, lanes)

    def update(scope, ys):
        dev = scope["windows"].device
        leaves = [x if torch.is_tensor(x) else torch.as_tensor(x, device=dev)
                  for _, x in tree_paths_sorted(ys)]
        leaves = [x.detach() for x in leaves]
        if leaves and leaves[0].device != dev:
            # a tree made before the engine's device was known
            scope = tree_map(lambda t: t.to(leaves[0].device), scope)
            dev = leaves[0].device
        out = dict(scope)
        out["windows"] = scope["windows"] + 1
        if not leaves:
            return out
        # the step axis: stacked outputs lead with the window's step count
        # (after the lane axis under a lane batch)
        first = leaves[0]
        step_ax = 1 if lanes > 1 else 0
        g = first.shape[step_ax] if first.dim() > step_ax else 1
        out["steps"] = scope["steps"] + g

        flats = []
        tokens = 0.0
        for x in leaves:
            f = x.to(torch.float32)
            flats.append(f.reshape(lanes, -1) if lanes > 1
                         else f.reshape(-1))
            tokens += x.numel() / L     # output elements a board
        out["tokens"] = scope["tokens"] + float(np.float32(tokens))

        if spec.gates:
            bits = None
            for f in flats:
                b = torch.stack([(~torch.isfinite(f)).any(-1),
                                 (f == 0).any(-1), (f < 0).any(-1),
                                 (f > 0).any(-1)], -1).to(torch.int32)
                bits = b if bits is None else bits | b
            out["gates"] = scope["gates"] | bits

        if spec.digest:
            d = torch.zeros((lanes,) if lanes > 1 else (),
                            dtype=torch.int64, device=dev)
            for x in leaves:
                d = (d * _FNV + fold_dev(x, lanes)) & _M32
            slot = (scope["windows"] % max(1, spec.every_n_windows)).long()
            ring = scope["win_digests"]
            ring = (ring.index_copy(1, slot.view(1), d.view(L, 1))
                    if lanes > 1
                    else ring.index_copy(0, slot.view(1), d.view(1)))
            out["digest"] = (scope["digest"] * _FNV + d) & _M32
            out["win_digests"] = ring

        if spec.ring_slots > 0:
            slots = spec.ring_slots
            x = first.to(torch.float32)
            if x.dim() <= step_ax:      # scalar ys: one pseudo-step
                x = x.reshape((lanes, 1, 1) if lanes > 1 else (1, 1))
            else:
                x = (x.reshape(lanes, g, -1) if lanes > 1
                     else x.reshape(g, -1))
            gg = min(g, slots)          # the ring holds at most `slots`
            x = x[..., g - gg:, :]      # the newest steps win
            ar = torch.arange(gg, device=dev)
            ids = (scope["steps"] + (g - gg) + ar).to(torch.float32)
            if lanes > 1:
                ids = ids[None].expand(lanes, gg)
            xa = x.abs()
            rows = torch.stack(
                [ids, xa.mean(-1), xa.amax(-1),
                 (~torch.isfinite(x)).any(-1).to(torch.float32)], -1)
            idx = (scope["trace_pos"] + (g - gg) + ar) % slots
            out["trace"] = scope["trace"].index_copy(
                1 if lanes > 1 else 0, idx, rows)
            out["trace_pos"] = scope["trace_pos"] + g
        return out

    return update


def _composite(engine: Callable, update: Callable) -> Callable:
    """``engine`` on the composite shell: the DUT shell in, the window's
    outputs folded into the counter tree after it."""
    def wrapped(state, shell, stack):
        state, snap, ys = engine(state, shell[DUT_KEY], stack)
        return state, {DUT_KEY: snap,
                       SCOPE_KEY: update(shell[SCOPE_KEY], ys)}, ys
    return wrapped


def _host(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# -------------------------------------------------------------- the plane --
class ScopePlane:
    """Host handle of one instrumented run: owns the spec, the drain-rate
    counter and the drained samples. Binds an engine and its scheduler
    plumbing so the counter tree threads through the window carry:

        engine' : runs the DUT untouched, then folds the window's stacked
                  outputs into the counter tree (its own eager pass, or
                  in the window's CUDA graph with ``spec.fuse``);
        reset'  : double-buffers the DUT shell as before and carries the
                  counter tree forward (counters are cumulative);
        drain'  : drains the DUT shell as before; every ``every_n_windows``
                  drains it also reads the counter tree as one sample.

    ``on_sample(sample)`` fires on the draining thread.
    ``finalize(shell)`` drains the tail interval and returns the inner DUT
    shell. The counter tree starts on the DUT shell's device (the host
    where the shell holds no tensor; the first update moves it to the
    outputs' device)."""

    def __init__(self, spec: ScopeSpec, lanes: int = 1,
                 on_sample: Optional[Callable[[dict], None]] = None):
        self.spec = spec
        self.lanes = max(1, lanes)
        self.on_sample = on_sample
        self.samples: List[dict] = []
        self._lock = threading.Lock()
        self._drained = 0               # windows since the last sample
        self._prev = {"steps": 0, "tokens": 0.0, "windows": 0}
        self._upd = make_update(spec, self.lanes)
        # engine id -> (engine, instrumented engine): a fused plane must
        # not capture a window length twice; the entry keeps the engine
        # alive, so its id is never recycled while the entry exists
        self._wrapped: dict = {}

    # ------------------------------------------------------------- binding --
    def instrument(self, engine: Callable) -> Callable:
        """Wrap ``(state, shell, stack) -> (state, snap, ys)`` so the
        composite shell threads the counter tree beside the DUT's. With
        ``spec.fuse`` and a ``WindowGraphs`` engine, the result is a new
        ``WindowGraphs`` (the same warm-up, a pool of its own) over the
        engine's function and the update: one capture, one replay a
        window. The inner engine's graphs are then never used."""
        hit = self._wrapped.get(id(engine))
        if hit is not None:
            return hit[1]
        if self.spec.fuse and isinstance(engine, WindowGraphs):
            wrapped = WindowGraphs(_composite(engine.engine, self._upd),
                                   warmup=engine.warmup)
        else:
            wrapped = _composite(engine, self._upd)
        self._wrapped[id(engine)] = (engine, wrapped)
        return wrapped

    def wrap_shell(self, shell):
        if is_scoped(shell):            # e.g. a composite made by the caller
            return shell
        device = next((t.device for t in tree_leaves(shell)
                       if torch.is_tensor(t)), None)
        return {DUT_KEY: shell,
                SCOPE_KEY: scope_init(self.spec, self.lanes, device)}

    def wrap_reset(self, reset: Optional[Callable]) -> Callable:
        def reset2(snap):
            dut = reset(snap[DUT_KEY]) if reset is not None \
                else snap[DUT_KEY]
            return {DUT_KEY: dut, SCOPE_KEY: snap[SCOPE_KEY]}
        return reset2

    def wrap_drain(self, drain_fn: Optional[Callable]) -> Callable:
        def drain2(snap):
            if drain_fn is not None:
                records, dut = drain_fn(snap[DUT_KEY])
            else:
                records, dut = {}, snap[DUT_KEY]
            sc = snap[SCOPE_KEY]
            take = False
            with self._lock:
                self._drained += 1
                if self._drained >= max(1, self.spec.every_n_windows):
                    self._drained = 0
                    take = True
            if take:
                self._sample(sc)
            return records, {DUT_KEY: dut, SCOPE_KEY: sc}
        return drain2

    def bind(self, engine, shell, drain_fn, reset):
        """One-call binding of a client's plumbing."""
        return (self.instrument(engine), self.wrap_shell(shell),
                self.wrap_drain(drain_fn), self.wrap_reset(reset))

    def finalize(self, shell):
        """Stream end: sample the tail interval (windows since the last
        read-rate boundary) and hand back the inner DUT shell."""
        if not is_scoped(shell):
            return shell
        with self._lock:
            tail, self._drained = self._drained, 0
        if tail:
            self._sample(shell[SCOPE_KEY])
        return shell[DUT_KEY]

    # ------------------------------------------------------------ sampling --
    def _sample(self, sc):
        host = {k: _host(v) for k, v in sc.items()}     # the read-rate fetch
        lanes = self.lanes
        steps = int(host["steps"])
        windows = int(host["windows"])
        tok = np.asarray(host["tokens"], np.float64)
        tokens_total = float(tok.sum())
        sample = {
            "seq": len(self.samples),
            "lanes": lanes,
            "windows": windows,
            "steps": steps,
            "tokens": (tok.tolist() if lanes > 1 else float(tok)),
            "d_windows": windows - self._prev["windows"],
            "d_steps": steps - self._prev["steps"],
            "d_tokens": tokens_total - self._prev["tokens"],
        }
        sample["quiet"] = sample["d_steps"] == 0
        if self.spec.gates:
            sample["gates"] = np.asarray(host["gates"]).tolist()
        if self.spec.digest:
            dig = np.asarray(host["digest"], np.int64)
            ring = np.asarray(host["win_digests"], np.int64)
            sample["digest"] = dig.tolist() if lanes > 1 else int(dig)
            sample["win_digests"] = ring.tolist()
        if self.spec.ring_slots > 0:
            pos = int(host["trace_pos"])
            n = min(pos, self.spec.ring_slots)
            tr = np.asarray(host["trace"])
            head = pos % self.spec.ring_slots
            order = (np.arange(head - n, head) % self.spec.ring_slots
                     if n else np.arange(0))
            sample["trace"] = (tr[:, order] if lanes > 1
                               else tr[order]).tolist()
            sample["trace_steps"] = pos     # total written: pos - n dropped
        self._prev = {"steps": steps, "tokens": tokens_total,
                      "windows": windows}
        with self._lock:
            self.samples.append(sample)
        if self.on_sample is not None:
            self.on_sample(sample)

    # ------------------------------------------------------------- report --
    def report(self) -> dict:
        """The plane's counter table (JSON-safe)."""
        with self._lock:
            samples = list(self.samples)
        last = samples[-1] if samples else {}
        out = {
            "spec": dataclasses.asdict(self.spec),
            "lanes": self.lanes,
            "samples": len(samples),
            "windows": last.get("windows", 0),
            "steps": last.get("steps", 0),
            "tokens": last.get("tokens", 0.0),
            "quiet_samples": sum(bool(s.get("quiet")) for s in samples),
        }
        if self.spec.gates:
            out["gates"] = last.get("gates")
            out["gate_names"] = list(GATE_NAMES)
        if self.spec.digest:
            out["digest"] = last.get("digest")
        w = out["windows"]
        if w:
            tok = out["tokens"]
            tot = (float(np.sum(tok)) if isinstance(tok, list)
                   else float(tok))
            out["tokens_per_window"] = tot / w
        out["history"] = samples
        return out


def instrument(engine: Callable, spec: ScopeSpec, *, lanes: int = 1,
               on_sample: Optional[Callable] = None):
    """``engine2, plane = scope.instrument(engine, spec)``. The returned
    engine consumes and produces the composite shell: pair it with
    ``plane.wrap_shell`` / ``wrap_drain`` / ``wrap_reset``, or pass
    ``scope=spec`` to ``WindowScheduler.run``, which binds the same way."""
    plane = ScopePlane(spec, lanes=lanes, on_sample=on_sample)
    return plane.instrument(engine), plane


def as_plane(scope: Any, lanes: int = 1,
             on_sample: Optional[Callable] = None) -> "ScopePlane":
    """Normalise a ``scope=`` argument: a ScopeSpec builds a fresh plane,
    a ScopePlane passes through."""
    if isinstance(scope, ScopePlane):
        return scope
    if isinstance(scope, ScopeSpec):
        return ScopePlane(scope, lanes=lanes, on_sample=on_sample)
    raise TypeError(f"scope= takes a ScopeSpec or ScopePlane, "
                    f"got {type(scope).__name__}")
