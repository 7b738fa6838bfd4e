"""The card's published peaks and the roofline share built on them.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the 700 W power
limit: 3.35 TB/s of HBM bandwidth and 989 TFLOP/s in bf16 on the tensor
cores. A card set to a lower power
limit runs slower under load, so every share is reported with the card's
power limit beside it (``power_limit_w``).
"""
from __future__ import annotations

import subprocess
from typing import Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def least_time(ops: float, nbytes: float, op_peak: Optional[float]
               ) -> Tuple[float, str]:
    """The least seconds the card allows for ``ops`` operations at
    ``op_peak`` and ``nbytes`` moved at HBM bandwidth, and which of the
    two bounds it (``compute`` or ``memory``). With no operations
    counted, the bytes alone bound it."""
    t_ops = ops / op_peak if ops else 0.0
    t_mem = nbytes / HBM_BYTES_PER_S
    return (t_ops, "compute") if t_ops >= t_mem else (t_mem, "memory")


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
