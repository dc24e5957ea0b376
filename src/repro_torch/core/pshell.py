"""P-Shell: the ZynqParrot host<->DUT interface, on torch tensors.

The shell carries two kinds of state beside the device computation:

  CSRs      — named control/status registers. Host writes land at step
              boundaries (clock edges); reads never block the DUT.
  SB-FIFOs  — bounded ring buffers with the semi-blocking contract: the
              device side NEVER blocks (a push into a full FIFO increments a
              ``dropped`` credit counter instead — credit/valid semantics),
              and the host drains between clock-gated windows.

Device-side operations are functional (each returns a new shell and never
writes a tensor it was given), so a window's output shell stays valid as
a drain snapshot while the next window runs, and every count and index
stays on the device: nothing here waits on the host.

Clock-gating analogue: the device runs ``sample_interval`` steps between
host drains. interval=1 == cycle-accurate co-emulation; larger intervals
trade completeness for speed (the paper's gating-granularity knob).

``PShell`` drives a step function through the core ``WindowScheduler``:
``run`` dispatches one step at a time and drains serially (the per-step
baseline); ``run_grouped`` runs each clock-gated window as ONE dispatch
of a group step (``train.step.make_group_step``) — on the card one
CUDA-graph replay (``core/graphs.py``) — with the drain of window *i*
overlapped with window *i+1* through the double-buffered shell.

Non-interference invariants (the tests assert all three):
  1. Shell state is threaded BESIDE the model state and never feeds back
     into it: the model state is bit-identical with the shell enabled,
     disabled, and at any interval.
  2. Grouped execution is bit-identical to per-step execution: final
     model/optimizer state AND the drained records (FIFO payload order,
     counts, cumulative dropped credits, CSR values).
  3. A drain resets FIFO occupancy but never the cumulative ``dropped``
     credit counter: overflow accounting is exact across windows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_clone, tree_leaves


@dataclasses.dataclass(frozen=True)
class FifoSpec:
    depth: int
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class ShellConfig:
    # name -> (shape, dtype)
    csrs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = \
        dataclasses.field(default_factory=dict)
    fifos: Dict[str, FifoSpec] = dataclasses.field(default_factory=dict)
    sample_interval: int = 1


def shell_init(cfg: ShellConfig, device="cpu"):
    state = {"csr": {}, "fifo": {}}
    for name, (shape, dt) in cfg.csrs.items():
        state["csr"][name] = torch.zeros(shape, dtype=dt, device=device)
    for name, f in cfg.fifos.items():
        state["fifo"][name] = {
            "buf": torch.zeros((f.depth,) + tuple(f.shape), dtype=f.dtype,
                               device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "dropped": torch.zeros((), dtype=torch.int32, device=device),
        }
    return state


# ------------------------------------------------------------ device side ---
def csr_write(state, name: str, value):
    cur = state["csr"][name]
    new = torch.as_tensor(value, device=cur.device).to(cur.dtype) \
        .reshape(cur.shape)
    return {**state, "csr": {**state["csr"], name: new}}


def csr_accum(state, name: str, value, op: str = "or"):
    """Accumulating CSR write (toggle bitmaps OR in, counters add). A
    Python number is folded in on the device without a host copy."""
    cur = state["csr"][name]
    if torch.is_tensor(value):
        value = value.to(cur.dtype).reshape(cur.shape)
    new = cur | value if op == "or" else cur + value
    return {**state, "csr": {**state["csr"], name: new}}


def csr_read(state, name: str):
    return state["csr"][name]


def fifo_push(state, name: str, payload):
    """Non-blocking single push (credit/valid: full => dropped += 1)."""
    f = state["fifo"][name]
    depth = f["buf"].shape[0]
    ok = f["count"] < depth
    idx = torch.clamp(f["count"], max=depth - 1).reshape(1).long()
    payload = payload.to(f["buf"].dtype).reshape((1,) + f["buf"].shape[1:])
    row = torch.where(ok, payload, f["buf"].index_select(0, idx))
    new = {"buf": f["buf"].index_copy(0, idx, row),
           "count": f["count"] + ok.int(),
           "dropped": f["dropped"] + (~ok).int()}
    return {**state, "fifo": {**state["fifo"], name: new}}


def fifo_push_many(state, name: str, payloads):
    """Vectorized push of ``payloads`` (n, *shape) — e.g. all per-layer
    commits of one step. Entries beyond the free space are dropped and
    counted (never blocks)."""
    f = state["fifo"][name]
    depth = f["buf"].shape[0]
    n = payloads.shape[0]
    start = f["count"]
    slots = start + torch.arange(n, dtype=torch.int32, device=start.device)
    ok = slots < depth
    # overflow entries scatter into a trash row (index `depth`) so duplicate
    # indices never race with a valid write
    idxs = torch.where(ok, slots, depth).long()
    padded = torch.cat([f["buf"], f["buf"].new_zeros((1,)
                                                     + f["buf"].shape[1:])])
    buf = padded.index_put((idxs,), payloads.to(f["buf"].dtype))[:depth]
    pushed = ok.int().sum(dtype=torch.int32)
    new = {"buf": buf, "count": start + pushed,
           "dropped": f["dropped"] + (n - pushed)}
    return {**state, "fifo": {**state["fifo"], name: new}}


def group_reset(shell):
    """Device-side inter-window reset: FIFO occupancy returns to zero in a
    FRESH buffer; the cumulative ``dropped`` counter and the CSRs carry
    forward as copies. The window's output shell therefore shares no
    tensor with the next window's, and stays a valid host-drain snapshot
    while the next window runs."""
    new_fifo = {}
    for name, f in shell["fifo"].items():
        new_fifo[name] = {"buf": torch.zeros_like(f["buf"]),
                          "count": torch.zeros_like(f["count"]),
                          "dropped": f["dropped"].clone()}
    csr = {k: v.clone() for k, v in shell["csr"].items()}
    return {"csr": csr, "fifo": new_fifo}


def stack_batches(group):
    """Stack a window's per-step items into one (g, ...) stack per leaf:
    host arrays into a host-numpy stack, tensors with ``torch.stack`` on
    their own device."""
    first = group[0]
    if isinstance(first, dict):
        return {k: stack_batches([g[k] for g in group]) for k in first}
    if torch.is_tensor(first):
        return torch.stack(list(group))
    return np.stack([np.asarray(x) for x in group])


# -------------------------------------------------------------- host side ---
def drain(state):
    """Host-side drain: returns (records, reset_state). On host tensors (the
    scheduler's snapshot copies) this reads nothing from the device; on
    device tensors it waits for them."""
    records = {}
    new_fifo = {}
    for name, f in state["fifo"].items():
        n = int(f["count"])
        records[name] = {
            "data": f["buf"][:n].cpu().numpy(),
            "count": n,
            "dropped": int(f["dropped"]),
        }
        new_fifo[name] = {"buf": f["buf"],
                          "count": torch.zeros_like(f["count"]),
                          "dropped": f["dropped"]}
    csrs = {k: v.cpu().numpy() for k, v in state["csr"].items()}
    return {"fifos": records, "csrs": csrs}, {**state, "fifo": new_fifo}


# ------------------------------------------------------------------ shell ---
class PShell:
    """Wraps a step function with shell-state threading and runs the
    host-side drain loop at the configured gating granularity."""

    def __init__(self, cfg: ShellConfig,
                 ingest: Callable[[Any, Any, Any], Any]):
        self.cfg = cfg
        self.ingest = ingest
        self._compiled: Dict[Any, Callable] = {}

    def init(self, device=None):
        """A zeroed shell on ``device`` (``cuda`` unless named)."""
        return shell_init(self.cfg, resolve_device(device))

    def _init_like(self, state):
        return self.init(tree_leaves(state)[0].device)

    def wrap(self, step_fn):
        """step_fn(state, batch) -> (state, metrics, aux)  ==>
        wrapped(state, batch, shell) -> (state, metrics, shell)."""
        ingest = self.ingest

        def wrapped(state, batch, shell):
            state, metrics, aux = step_fn(state, batch)
            shell = ingest(shell, aux, metrics)
            return state, metrics, shell

        return wrapped

    def scheduler(self, overlap: bool = True, timer=None,
                  stacked: bool = True):
        """The core WindowScheduler configured for this shell: P-Shell
        drain, device-side ``group_reset`` double-buffering when
        overlapping, windows of ``sample_interval`` steps.
        ``stacked=False`` hands engines the raw per-step batch list."""
        from repro_torch.core.schedule import WindowScheduler
        return WindowScheduler(
            interval=max(1, self.cfg.sample_interval), overlap=overlap,
            reset=group_reset if overlap else None, drain_fn=drain,
            stack_fn=stack_batches if stacked else None, timer=timer)

    def run(self, wrapped_step, state, batches, shell=None,
            on_drain: Optional[Callable[[int, dict], None]] = None):
        """Per-step baseline: one dispatch per step, serial drain every
        ``sample_interval`` steps (tail window included), through the
        core WindowScheduler. Returns (state, last_metrics, shell)."""
        shell = self._init_like(state) if shell is None else shell
        sched = self.scheduler(overlap=False, stacked=False)

        def engine(state, sh, batches):
            metrics = None
            for batch in batches:
                state, metrics, sh = wrapped_step(state, batch, sh)
            return state, sh, metrics

        def emit(plan, records, ys):
            if on_drain is not None:
                on_drain(plan.last, records)

        return sched.run(engine, sched.windows(batches), state, shell,
                         on_drain=emit)

    def compile_group(self, group_step, donate: bool = True, device=None):
        """The group step as the engine of one dispatch a window, cached
        per (function object, donation, device type). On a card: a
        ``WindowGraphs`` that runs the first window of each length eagerly
        (a train state is too large to clone), captures that length when
        it comes again and replays one CUDA graph a window from then on.
        On host tensors: the group step itself. ``donate=False`` clones the incoming state
        first, so the caller's state survives (the reference's
        non-donating dispatch).

        The cache is keyed on the function OBJECT (kept alive by the key),
        never on ``id()``: a recycled id would silently hand a different
        step function a stale compiled group."""
        device = resolve_device(device)
        key = (group_step, donate, device.type)
        if key not in self._compiled:
            engine = group_step
            if not donate:
                def engine(state, shell, xs, _fn=group_step):
                    return _fn(tree_clone(state), shell, xs)
            if device.type == "cuda":
                from repro_torch.core.graphs import WindowGraphs
                engine = WindowGraphs(engine, warmup="eager")
            self._compiled[key] = engine
        return self._compiled[key]

    def run_grouped(self, group_step, state, batches, shell=None,
                    on_drain: Optional[Callable[[int, dict], None]] = None,
                    donate: bool = True):
        """Fused host loop: ONE dispatch per clock-gated window (on a card
        one CUDA-graph replay), scheduled by the core WindowScheduler in
        overlap mode: the window's batches are stacked and dispatched, the
        next window's shell derived on the device (``group_reset``), and
        only then is the PREVIOUS window's snapshot drained on the host.

        Returns (state, last_metrics_stack, shell). ``on_drain(i, records)``
        fires with i = the last step index of the drained window, matching
        ``run``'s cadence; records also carry the window's stacked per-step
        metrics under "metrics" (numpy)."""
        shell = self._init_like(state) if shell is None else shell
        engine = self.compile_group(group_step, donate=donate,
                                    device=tree_leaves(state)[0].device)
        sched = self.scheduler(overlap=True)

        def emit(plan, records, metrics):
            if on_drain is not None:
                records["metrics"] = {k: v.cpu().numpy()
                                      for k, v in metrics.items()}
                on_drain(plan.last, records)

        return sched.run(engine, sched.windows(batches), state, shell,
                         on_drain=emit)
