"""Plain PyTorch version of the MeDiC block-pool gather (a torch form of
``repro.kernels.medic_gather.ref``)."""
from __future__ import annotations

import torch


def medic_gather_ref(pool, block_tbl):
    """pool: [N, page, H, D]; block_tbl: [B, P] (<0 = hole -> zeros).
    Returns [B, P, page, H, D]."""
    tbl = torch.clamp_min(block_tbl, 0).long()
    out = pool[tbl]
    mask = (block_tbl >= 0)[..., None, None, None]
    return torch.where(mask, out, torch.zeros_like(out))
