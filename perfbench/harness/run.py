"""What a driver is given and what it hands back."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from perfbench.harness.trace import Spans, TraceSummary


class WindowClosed(Exception):
    """Raised by the benchmark's wrappers inside the program's loop when
    the measured window has closed."""


@dataclasses.dataclass
class RunContext:
    cell_name: str
    cell: dict            # workloads/<cell>.json
    config: dict          # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float        # perf_counter at the process's start


@dataclasses.dataclass
class LayerContext:
    """What the per-layer readers read: the traced window's device
    summary and host spans, the program's counters over that window, the
    shapes of the kernel calls made in it, and the configuration."""
    trace: TraceSummary
    spans: Spans
    counts: Dict[str, float]
    calls: Dict[str, list]
    config: dict


@dataclasses.dataclass
class RunResult:
    e2e: Dict[str, float]
    checks: List[Tuple[str, float, float]]     # (name, value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer: Optional[LayerContext] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.checks)
