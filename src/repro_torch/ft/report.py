"""Structured fault-tolerance outcome records (counterpart of
``repro.ft.report``; plain dataclasses, safe to import from anywhere in
the stack without cycles)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FtReport:
    """What a protected driver saw: every detection is a checksum
    mismatch (exact integer inequality — zero false positives), every
    retry a recompute of the offending step from its verified
    predecessor state."""
    detections: int = 0
    retries: int = 0
    failed: bool = False                  # retry budget exhausted
    sites: list = dataclasses.field(default_factory=list)

    def merge(self, other: "FtReport") -> "FtReport":
        self.detections += other.detections
        self.retries += other.retries
        self.failed = self.failed or other.failed
        self.sites.extend(other.sites)
        return self


@dataclasses.dataclass
class SolveReport:
    """Outcome of a graceful-degradation solve (lapack.refine
    ``rgesv_guarded``): which rung of the mp -> ir -> plain ladder
    produced x, why the monitor stopped, and the fault/retry totals."""
    outcome: str                # converged | stalled | diverged | nar | plain
    solver: str                           # rgesv_mp | rgesv_ir | rgetrs
    sweeps: int = 0
    r_norm: float = 0.0
    r_norm0: float = 0.0
    detections: int = 0
    retries: int = 0
    fallbacks: tuple = ()                 # ladder rungs abandoned, in order
