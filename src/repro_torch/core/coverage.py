"""Toggle coverage — the RFUZZ mux-toggle analogue (numpy only).

Coverpoints are single-bit, data-dependent routing decisions: (layer,
expert) selection toggles for MoE archs, per-layer nan/inf overflow bits
for all archs. Device-side they are OR-accumulated CSR bitmaps (cheap,
under-representing); host-side this class accumulates drained CSRs across
step groups and reports coverage increments (the hook a coverage-guided
fuzzer would use for early termination). ``update_gates`` folds in the
ZP-Scope plane's gate bits as one more bitmap.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class CoverageMap:
    def __init__(self):
        self.bitmaps: Dict[str, np.ndarray] = {}
        self.history = []          # coverage fraction after each update

    def update(self, csrs: Dict[str, np.ndarray]) -> int:
        """Ingest drained CSRs; returns the coverage increment (new bits)."""
        new_bits = 0
        for name in ("expert_toggles", "nan_bits"):
            if name not in csrs:
                continue
            bits = np.asarray(csrs[name]).astype(bool)
            if name not in self.bitmaps:
                self.bitmaps[name] = np.zeros_like(bits)
            new_bits += int((bits & ~self.bitmaps[name]).sum())
            self.bitmaps[name] |= bits
        self.history.append(self.fraction())
        return new_bits

    def update_gates(self, gates, name: str = "scope_gates") -> int:
        """Ingest ZP-Scope gate toggle bits (value-class coverpoints
        OR-accumulated on the device by the plane, the same
        under-representing CSR semantics as the mux toggles). ``gates`` is
        the drained int bit vector ((lanes, bits) under a lane batch,
        flattened so each lane's bits are distinct coverpoints). Returns
        the coverage increment like :meth:`update`."""
        bits = np.asarray(gates).astype(bool).reshape(-1)
        if name not in self.bitmaps:
            self.bitmaps[name] = np.zeros_like(bits)
        new_bits = int((bits & ~self.bitmaps[name]).sum())
        self.bitmaps[name] |= bits
        self.history.append(self.fraction())
        return new_bits

    def fraction(self, name: Optional[str] = None) -> float:
        maps = ([self.bitmaps[name]] if name else list(self.bitmaps.values()))
        maps = [m for m in maps if m.size]
        if not maps:
            return 0.0
        covered = sum(int(m.sum()) for m in maps)
        total = sum(m.size for m in maps)
        return covered / total

    def summary(self) -> Dict[str, object]:
        return {
            "fraction": self.fraction(),
            "per_map": {k: {"covered": int(v.sum()), "total": int(v.size)}
                        for k, v in self.bitmaps.items()},
            "saturated": bool(self.history) and len(self.history) >= 2
            and self.history[-1] == self.history[-2],
        }
