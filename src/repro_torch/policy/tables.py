"""Host-side decision tables derived from the branchless policy ops.

The serving pool's control plane runs on the host (numpy) but must make
the *same* ②③④ decisions as the simulator. Since each of those
decisions, for a control plane without PC tables or PCAL tokens, is a pure
function of the warp/sequence type, the port's own ``policy.ops`` are
evaluated once over all ``NUM_TYPES`` types on CPU tensors and the result
is kept as numpy lookup tables — the ops remain the single source of truth
for mechanism semantics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import warp_types as WT
from repro_torch.policy import ops
from repro_torch.policy.spec import PolicyArrays

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DecisionTables:
    """Per-warp-type decisions for one policy, as numpy arrays."""
    bypass_by_type: np.ndarray   # bool[NUM_TYPES]  ②
    rank_by_type: np.ndarray     # i64[NUM_TYPES]   ③
    hp_by_type: np.ndarray       # bool[NUM_TYPES]  ④

    @staticmethod
    def from_arrays(pa: PolicyArrays, rrip_max: int) -> "DecisionTables":
        pa = PolicyArrays(*(t.to("cpu") for t in pa))
        n = WT.NUM_TYPES
        types = torch.arange(n, dtype=I32)
        # signals a host control plane does not have are neutralized:
        # no probe, token held (PCAL never bypasses), empty PC table,
        # rand_u = 1 (rand never fires).
        byp = ops.bypass_decision(
            pa, wtype=types, probe=torch.zeros(n, dtype=torch.bool),
            token_bit=torch.ones(n, dtype=torch.bool),
            pc_hits=torch.zeros(n, dtype=I32),
            pc_acc=torch.zeros(n, dtype=I32),
            pc_req=torch.zeros(n, dtype=I32),
            rand_u=torch.ones(n, dtype=F32))
        rank = ops.insertion_rank(
            pa, wtype=types, eaf_bit=torch.zeros(n, dtype=torch.bool),
            rrip_max=rrip_max)
        hp = ops.is_high_priority(pa, types)
        return DecisionTables(
            bypass_by_type=byp.numpy().astype(bool),
            rank_by_type=rank.numpy().astype(np.int64),
            hp_by_type=hp.numpy().astype(bool))
