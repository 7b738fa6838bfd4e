"""Branchless policy decision ops (paper mechanisms ②③④), in torch.

Every function computes the candidate decision of *each* mechanism on the
menu and selects the active one with a one-hot dot product against the
``PolicyArrays`` select weights — no Python dispatch on the policy. A
policy row may carry a leading simulation axis (the event engine's
[N] batch): every op then works elementwise per simulation.

``hash_index`` is the reference's uint32 multiplicative hash. Torch's
uint32 support is partial, so it runs in int64 on the low 32 bits, with
the 32×32-bit product split into 16-bit halves so no int64 product
overflows; inactive lanes (``addr = -1``) wrap to 0xFFFFFFFF as a uint32
cast does.
"""
from __future__ import annotations

import torch

from repro_torch.core import warp_types as WT
from repro_torch.policy.spec import PolicyArrays

F32 = torch.float32
I32 = torch.int32

#: default classifier probe cadence (accesses), deferred to when
#: ``PolicyArrays.probe_interval`` is 0 (via ``SimParams.probe_interval``)
DEFAULT_PROBE_INTERVAL = 8

#: PC-table probe cadence (requests): every Nth request hitting a PC entry
#: takes the cache path even if the entry's ratio says bypass. The clock
#: is ``SimState.pc_req`` (all valid requests), which keeps ticking while
#: the entry bypasses.
PC_PROBE_INTERVAL = 16

_MASK32 = 0xFFFFFFFF
_HASH_MUL = 2654435761
_HASH_SALT = 0x9E3779B9


def hash_index(x: torch.Tensor, salt: int, mod: int) -> torch.Tensor:
    """Knuth-style multiplicative hash -> i32 in [0, mod). Shared by the
    simulator's set/bank/channel indexing and the policy ops."""
    u = torch.as_tensor(x).to(torch.int64) & _MASK32
    lo, hi = u & 0xFFFF, u >> 16
    h = (lo * _HASH_MUL + (((hi * _HASH_MUL) & 0xFFFF) << 16)) & _MASK32
    h = (h + ((salt * _HASH_SALT) & _MASK32)) & _MASK32
    h = h ^ (h >> 15)
    return (h % mod).to(I32)


def _select(sel: torch.Tensor, cand) -> torch.Tensor:
    """``tensordot(sel, stack(cand), axes=1)`` in float32 (the candidates
    share one dtype). A stacked ``sel`` [N, k] (one policy row per
    simulation) selects elementwise from candidates [N]: one-hot weights
    times 0/1 or small-integer candidates, so the sum is exact in any
    order."""
    if sel.ndim == 1:
        return torch.tensordot(sel, torch.stack(cand).to(F32), dims=1)
    return (sel * torch.stack(cand, -1).to(F32)).sum(-1)


def bypass_decision(pa: PolicyArrays, *, wtype, probe, token_bit,
                    pc_hits, pc_acc, pc_req, rand_u):
    """② Should this request skip the shared cache?

    wtype: i32 current warp type (mechanism "medic"); probe: bool periodic
    re-learning probe (forces the cache path); token_bit: bool PCAL token
    ownership ("pcal"); pc_hits/pc_acc: i32 PC-table cache-path counters
    ("pcbyp"); pc_req: i32 PC-table all-request cadence counter; rand_u:
    f32 uniform variate in [0, 1) ("rand").
    """
    c_none = torch.zeros(wtype.shape, dtype=torch.bool, device=wtype.device)
    c_medic = WT.is_bypass_type(wtype) & ~probe
    c_pcal = ~token_bit
    pc_ratio = pc_hits / torch.clamp_min(pc_acc, 1)
    # probe on the Nth request of each cadence window (not the zeroth)
    pc_probe = (pc_req % PC_PROBE_INTERVAL) == PC_PROBE_INTERVAL - 1
    c_pcbyp = (pc_acc > 32) & (pc_ratio < 0.25) & ~pc_probe
    c_rand = rand_u < pa.rand_p
    return _select(pa.bypass_sel,
                   [c_none, c_medic, c_pcal, c_pcbyp, c_rand]) > 0.5


def insertion_rank(pa: PolicyArrays, *, wtype, eaf_bit, rrip_max: int):
    """③ RRIP insertion rank for a filled line (eaf_bit: the address was
    seen in the evicted-address filter)."""
    r_lru = torch.zeros(wtype.shape, dtype=I32, device=wtype.device)
    r_medic = WT.insertion_rank(wtype, rrip_max - 1)
    r_eaf = torch.where(eaf_bit, 0, rrip_max - 1).to(I32)   # int64 -> i32
    return torch.round(_select(pa.ins_sel, [r_lru, r_medic, r_eaf])).to(I32)


def is_high_priority(pa: PolicyArrays, wtype):
    """④ Does this request take the strict-priority high queue?"""
    return (pa.sched_medic > 0.5) & WT.is_priority_type(wtype)


def select_label(pa: PolicyArrays, clf_wtype, oracle_wtype):
    """① Which warp-type label drives decisions ②③④: the oracle label
    when ``label_sel`` picks "oracle", else the classifier's."""
    return torch.where(pa.label_sel[..., 2] > 0.5, oracle_wtype, clf_wtype)


def reclass_interval(pa: PolicyArrays, default):
    """① Effective classifier sampling window (accesses); 0 defers to the
    SimParams default."""
    return torch.where(pa.reclass_interval > 0.5, pa.reclass_interval,
                       float(default))


def probe_interval(pa: PolicyArrays, default):
    """①② Effective probe cadence (accesses between forced cache-path
    probes of a bypassing warp); 0 defers to the SimParams default."""
    return torch.where(pa.probe_interval > 0.5, pa.probe_interval,
                       float(default))


#: effectively-unbounded window count for the online labeling mode
_NO_WINDOW_CAP = 1 << 30


def reclass_max_windows(pa: PolicyArrays):
    """① How many sampling windows may update a warp's label: 1 for the
    stale (classify-once) mode, unbounded otherwise."""
    return torch.where(pa.label_sel[..., 1] > 0.5, 1, _NO_WINDOW_CAP).to(I32)


def pcal_tokens(pa: PolicyArrays, n_warps: int):
    """PCAL token assignment: a pseudo-random but fixed subset of warps,
    blind to warp type."""
    n_tokens = torch.clamp_min(
        torch.round(pa.pcal_frac * n_warps), 1).to(I32)
    dev = pa.pcal_frac.device
    return hash_index(torch.arange(n_warps, dtype=I32, device=dev), 11,
                      997) < torch.div(997 * n_tokens, n_warps,
                                       rounding_mode="floor")
