"""Event-driven timing models (DESIGN C4): the VPS-side interface timing.

In ZynqParrot, I/O timing models live in host software: the DUT emits a
request, the VPS computes the predicted latency of the modelled interface
(e.g. an HBM part), and hardware timers enforce it. Here the "interfaces"
are the card's memory system, its tensor cores and its links; the events
are per-op (or per-layer) costs (``roofline/cost.py`` counts them for a
window); and the timeline predicts step time under an overlap model
(collectives on a stream of their own, overlapping compute).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.roofline.hw import HW_H100, Hardware


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str                   # compute | memory | collective | host
    duration_s: float
    stream: Optional[str] = None  # default: kind-based stream


class InterfaceTimer:
    """Latency model per interface: the HBM-request timing analogue."""

    def __init__(self, hw: Hardware = HW_H100):
        self.hw = hw

    def compute(self, flops: float) -> float:
        return flops / self.hw.peak_flops_bf16

    def memory(self, nbytes: float) -> float:
        return nbytes / self.hw.hbm_bw

    def collective(self, wire_bytes: float) -> float:
        # effective wire bytes already account for the ring algorithm; the
        # card pushes them through its links
        return wire_bytes / (self.hw.ici_link_bw * self.hw.ici_links)

    def event(self, name: str, kind: str, quantity: float) -> Event:
        dur = {"compute": self.compute, "memory": self.memory,
               "collective": self.collective}[kind](quantity)
        return Event(name=name, kind=kind, duration_s=dur)


class Timeline:
    """Two-stream virtual clock: the compute stream serializes compute and
    memory events (the roofline max is applied per event group); the
    collective stream runs async. ``overlap=True`` models async
    collectives (started early, joined at the next dependency);
    ``overlap=False`` is the fully serialized bound.
    """

    def __init__(self, hw: Hardware = HW_H100, overlap: bool = True):
        self.hw = hw
        self.overlap = overlap

    def simulate(self, groups: Iterable[Dict[str, float]]) -> Dict:
        """groups: per-layer dicts {compute_s, memory_s, collective_s}.
        Per group: core time = max(compute, memory) [roofline]; total =
        sum over groups of max(core, collective) if overlapped else
        core + collective."""
        total = 0.0
        per_kind = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
        bound_counts = {"compute": 0, "memory": 0, "collective": 0}
        for g in groups:
            c = g.get("compute_s", 0.0)
            m = g.get("memory_s", 0.0)
            k = g.get("collective_s", 0.0)
            core = max(c, m)
            step = max(core, k) if self.overlap else core + k
            total += step
            per_kind["compute"] += c
            per_kind["memory"] += m
            per_kind["collective"] += k
            dominant = max(("compute", c), ("memory", m), ("collective", k),
                           key=lambda t: t[1])[0]
            bound_counts[dominant] += 1
        dominant = max(per_kind, key=per_kind.get)
        return {"total_s": total, "per_kind": per_kind,
                "bound_counts": bound_counts, "dominant": dominant,
                "overlap": self.overlap}
