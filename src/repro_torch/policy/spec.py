"""Policy description: declarative preset + tensor form.

``Policy`` keeps the human-readable preset (strings name the mechanism at
each decision point). ``PolicyArrays`` is the form the compute paths use:
one-hot select weights over the mechanism menus plus scalar knobs, as a
NamedTuple of float32 tensors. ``stack_policies`` adds a leading policy
axis; the engine facade runs one simulation per policy row.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

F32 = torch.float32

# mechanism menus — index order is the select-weight order everywhere
BYPASS_MECHS = ("none", "medic", "pcal", "pcbyp", "rand")   # ②
INSERT_MECHS = ("lru", "medic", "eaf")                      # ③
SCHED_MECHS = ("frfcfs", "medic")                           # ④
LABEL_MECHS = ("online", "stale", "oracle")                 # ① labeling


@dataclasses.dataclass(frozen=True)
class Policy:
    """Which mechanism drives each decision point (declarative preset)."""
    name: str
    bypass: str = "none"       # none | medic | pcal | pcbyp | rand
    insertion: str = "lru"     # lru | medic | eaf
    scheduler: str = "frfcfs"  # frfcfs | medic
    rand_p: float = 0.5        # rand bypass probability
    pcal_frac: float = 0.375   # fraction of warps holding tokens
    # ① how warp-type labels track drift: online (periodic
    # reclassification, the paper), stale (classify once, then freeze) or
    # oracle (ground-truth per-phase labels from the trace generator)
    labeling: str = "online"
    # sampling window in accesses; 0 = the SimParams default
    reclass_interval: int = 0
    # probe cadence in accesses (every Nth access of a bypassing warp
    # still takes the cache path); 0 = the SimParams default (8)
    probe_interval: int = 0

    def __post_init__(self):
        if self.bypass not in BYPASS_MECHS:
            raise ValueError(f"unknown bypass mechanism {self.bypass!r}")
        if self.insertion not in INSERT_MECHS:
            raise ValueError(f"unknown insertion mechanism {self.insertion!r}")
        if self.scheduler not in SCHED_MECHS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.labeling not in LABEL_MECHS:
            raise ValueError(f"unknown labeling mechanism {self.labeling!r}")
        if self.reclass_interval < 0 or \
                self.reclass_interval != int(self.reclass_interval):
            raise ValueError(
                f"reclass_interval must be a non-negative int, got "
                f"{self.reclass_interval!r}")
        if self.probe_interval < 0 or \
                self.probe_interval != int(self.probe_interval):
            raise ValueError(
                f"probe_interval must be a non-negative int, got "
                f"{self.probe_interval!r}")


class PolicyArrays(NamedTuple):
    """A ``Policy`` as float32 tensors; a leading batch axis (added by
    ``stack_policies``) makes this a stacked policy batch."""
    bypass_sel: torch.Tensor    # f32[5] one-hot over BYPASS_MECHS
    ins_sel: torch.Tensor       # f32[3] one-hot over INSERT_MECHS
    sched_medic: torch.Tensor   # f32[]  1.0 iff scheduler == "medic"
    rand_p: torch.Tensor        # f32[]
    pcal_frac: torch.Tensor     # f32[]
    label_sel: torch.Tensor     # f32[3] one-hot over LABEL_MECHS
    reclass_interval: torch.Tensor  # f32[] 0 = SimParams default
    probe_interval: torch.Tensor    # f32[] 0 = SimParams default


def _one_hot(index: int, n: int, device) -> torch.Tensor:
    out = torch.zeros((n,), dtype=F32, device=device)
    out[index] = 1.0
    return out


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


def to_arrays(pol: Policy, device="cpu") -> PolicyArrays:
    return PolicyArrays(
        bypass_sel=_one_hot(BYPASS_MECHS.index(pol.bypass),
                            len(BYPASS_MECHS), device),
        ins_sel=_one_hot(INSERT_MECHS.index(pol.insertion),
                         len(INSERT_MECHS), device),
        sched_medic=_scalar(1.0 if pol.scheduler == "medic" else 0.0,
                            device),
        rand_p=_scalar(pol.rand_p, device),
        pcal_frac=_scalar(pol.pcal_frac, device),
        label_sel=_one_hot(LABEL_MECHS.index(pol.labeling),
                           len(LABEL_MECHS), device),
        reclass_interval=_scalar(pol.reclass_interval, device),
        probe_interval=_scalar(pol.probe_interval, device),
    )


def stack_policies(policies: Sequence[Policy], device="cpu") -> PolicyArrays:
    """Stack presets into one batched ``PolicyArrays`` (leading axis P)."""
    if not policies:
        raise ValueError("stack_policies needs at least one policy")
    rows = [to_arrays(p, device) for p in policies]
    return PolicyArrays(*(torch.stack(leaf) for leaf in zip(*rows)))


def policy_row(pa: PolicyArrays, i: int) -> PolicyArrays:
    """Row ``i`` of a stacked ``PolicyArrays``."""
    return PolicyArrays(*(leaf[i] for leaf in pa))


def arrays_from_numpy(fields: Mapping, device) -> PolicyArrays:
    """``PolicyArrays`` from the reference's fields given as numpy arrays
    (``{name: array}``, e.g. ``repro.policy.to_arrays(p)._asdict()``
    passed through ``np.asarray``), pinned to float32 on ``device``."""
    return PolicyArrays(**{
        f: torch.tensor(np.asarray(fields[f])).to(device=device, dtype=F32)
        for f in PolicyArrays._fields})
