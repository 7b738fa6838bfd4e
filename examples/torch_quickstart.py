"""Quickstart on the PyTorch port: the MeDiC policy core on one H100.

Runs one memory-intensive workload through the port's altitude-A
simulator under the baseline and full-MeDiC policies via the declarative
experiment API — a `Scenario` names what to simulate, an `Experiment`
crosses it with policies, and the plan compiler lowers the whole thing
to one `simulate_sweep` call (one launch of the event-loop kernel on the
card) — then prints the headline effects the paper predicts straight off
the labeled `ResultSet`: bypass volume, queue-delay relief, warp-type
conversion, and speedup.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the card by default and raises without one; ``--device cpu``
runs the plain PyTorch loop instead (about two minutes on a CPU).
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.core import baselines as BL
from repro_torch.core import warp_types as WT


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    exp = api.Experiment("quickstart",
                         scenarios=(api.Scenario.workload("BFS"),),
                         policies=(BL.BASELINE, BL.MEDIC),
                         device=args.device)
    print(exp.compile().describe())
    rs = exp.run()

    spec = exp.scenarios[0].trace_spec
    print(f"\nworkload: {spec.name} ({spec.n_warps} warps, "
          f"{spec.n_instr} memory instructions each), "
          f"wall {rs.wall_s:.3f} s")

    # the per-policy table, by label — no positional v[0]/v[1] slicing
    for row in rs.to_rows(metrics=("ipc", "miss_rate", "mean_qdelay",
                                   "bypasses")):
        types = np.bincount(
            np.asarray(rs.get(policy=row["policy"])["warp_type"]),
            minlength=WT.NUM_TYPES)
        print(f"\n[{row['policy']}]")
        print(f"  IPC proxy          : {row['ipc']:.4f}")
        print(f"  L2 miss rate       : {row['miss_rate']:.3f}")
        print(f"  mean L2 queue delay: {row['mean_qdelay']:.1f} cyc")
        print(f"  bypassed requests  : {int(row['bypasses'])}")
        print("  warp types         : " + ", ".join(
            f"{n}={c}" for n, c in zip(WT.TYPE_NAMES, types)))

    speedup = rs.speedup_over("Baseline")["BFS"]["MeDiC"]
    print(f"\nMeDiC speedup: {speedup:.3f}x")


if __name__ == "__main__":
    main()
