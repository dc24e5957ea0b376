"""Stall-stack profiling with tunable sampling granularity.

Two modalities, mirroring the paper's coarse-regression vs fine-analysis:

  live  — wall-clock attribution of the host loop: the dispatch ("device":
          the enqueue only, nothing here waits on the card), host drains and
          barriers ("host": the wait for window *i* lands here, at its
          drain, while window *i+1* is in flight), and window assembly
          ("data"). The profiler IS the ``WindowScheduler``'s phase timer;
          the sampling interval is the P-Shell gating granularity.
  model — per-layer compute/memory/collective terms folded into one stall
          stack (time-proportional: every layer of every step accounted).

A host-dominated live stack therefore means "the host waits on the card",
not "host work dominates". Host-side pure Python.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

CATEGORIES = ("device", "host", "data")


@dataclasses.dataclass
class StallStack:
    """Normalized attribution over categories (a 'cycle stack')."""
    seconds: Dict[str, float]

    def fractions(self) -> Dict[str, float]:
        tot = sum(self.seconds.values()) or 1.0
        return {k: v / tot for k, v in self.seconds.items()}

    def dominant(self) -> str:
        return max(self.seconds, key=self.seconds.get)


class Profiler:
    def __init__(self, sample_interval: int = 1):
        self.sample_interval = sample_interval
        self._acc = defaultdict(float)
        self._steps = 0
        self.samples: List[Dict[str, float]] = []

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0

    def step_done(self):
        self._steps += 1
        if self._steps % self.sample_interval == 0:
            self.samples.append(dict(self._acc))

    def live_stack(self) -> StallStack:
        return StallStack(seconds=dict(self._acc))

    @property
    def steps(self) -> int:
        return self._steps

    # ------------------------------------------------------------ model ---
    @staticmethod
    def model_stack(layer_terms: List[Dict[str, float]]) -> StallStack:
        """Per-layer roofline terms -> aggregate compute/memory/collective
        stall stack (time-proportional: all layers, all steps)."""
        acc = {"compute": 0.0, "memory": 0.0, "collective": 0.0}
        for g in layer_terms:
            acc["compute"] += g.get("compute_s", 0.0)
            acc["memory"] += g.get("memory_s", 0.0)
            acc["collective"] += g.get("collective_s", 0.0)
        return StallStack(seconds=acc)
