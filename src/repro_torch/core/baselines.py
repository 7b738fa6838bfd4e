"""Policy presets: MeDiC, its three components, and the four comparison
mechanisms from the paper's evaluation (§5, Fig 7) — plus the labeling
ablation presets the phased scenario family compares."""
from __future__ import annotations

import dataclasses

from repro_torch.policy import Policy

BASELINE = Policy("Baseline")                                 # LRU, FR-FCFS
EAF = Policy("EAF", insertion="eaf")                              # [123]
PCAL = Policy("PCAL", bypass="pcal")                              # [79]
PC_BYP = Policy("PC-Byp", bypass="pcbyp")
WIP = Policy("WIP", insertion="medic")                            # ③ alone
WMS = Policy("WMS", scheduler="medic")                            # ④ alone
WBYP = Policy("WByp", bypass="medic")                             # ② alone
MEDIC = Policy("MeDiC", bypass="medic", insertion="medic",
               scheduler="medic")                                 # ②+③+④


def rand(p: float) -> Policy:
    return Policy(f"Rand({p:.2f})", bypass="rand", rand_p=p)


RAND_SWEEP = tuple(rand(p) for p in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8))

ALL_NAMED = (BASELINE, EAF, PCAL, PC_BYP, WIP, WMS, WBYP, MEDIC)


def with_labeling(pol: Policy, labeling: str, name: str = None,
                  reclass_interval: int = 0) -> Policy:
    """Labeling-mode ablation of a preset (① — online / stale / oracle),
    optionally with a non-default reclassification window."""
    return dataclasses.replace(
        pol, name=name or f"{pol.name}[{labeling}]", labeling=labeling,
        reclass_interval=reclass_interval)


# the phased-family labeling ladder: labels frozen at phase 0 (stale),
# the paper's periodic reclassification (online, at the default and at a
# halved sampling window), and ground-truth per-phase labels (oracle)
MEDIC_STALE = with_labeling(MEDIC, "stale", "MeDiC-stale")
MEDIC_FAST = with_labeling(MEDIC, "online", "MeDiC-fast",
                           reclass_interval=32)
MEDIC_ORACLE = with_labeling(MEDIC, "oracle", "MeDiC-oracle")
LABELING_LADDER = (BASELINE, MEDIC_STALE, MEDIC, MEDIC_FAST, MEDIC_ORACLE)
