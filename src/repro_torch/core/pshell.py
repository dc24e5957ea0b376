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

Invariant 3 of the reference holds: a drain resets FIFO occupancy but
never the cumulative ``dropped`` credit counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


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
    """Stack a window's per-step items into one (g, ...) host-numpy stack
    per leaf."""
    first = group[0]
    if isinstance(first, dict):
        return {k: stack_batches([g[k] for g in group]) for k in first}
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
