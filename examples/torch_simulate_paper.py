"""Reproduce the paper's headline table (Fig 7) over all 15 workloads on
the PyTorch port.

    PYTHONPATH=src python examples/torch_simulate_paper.py [--quick]
        [--seeds N] [--engine ENGINE] [--stress] [--device DEVICE]

``--seeds N`` averages each speedup over N trace seeds; the seeds ride
the policy sweep in one ``simulate_sweep`` call per workload (one launch
of the event-loop kernel on the card).

``--engine wavefront`` runs the Fig 7 sweep on the batched wavefront
engine (same orderings within the documented tolerance).

``--stress`` runs the STRESS_SPECS scheduler-stress matrix (1k–4k warps)
on the wavefront engine through ``repro_torch.api.registry.STRESS`` and
prints the per-scenario policy rankings.

Everything routes through ``repro_torch.api``; it runs on the card by
default and raises without one (``--device cpu`` runs the plain PyTorch
versions, which take hours at this scale).
"""
import argparse

import numpy as np


def run_stress(device):
    from repro_torch.api import registry

    exp = registry.STRESS.with_(device=device)
    names = [p.name for p in exp.policies]
    print(f"stress matrix (wavefront engine, policies: {', '.join(names)})")
    rs = exp.run()
    for sc in exp.scenarios:
        ipc = np.asarray(rs.get(scenario=sc.name)["ipc"], dtype=float)
        order = np.argsort(-ipc)
        ranking = " > ".join(f"{names[i]}({ipc[i]:.3f})" for i in order)
        print(f"  {sc.name:10s} [{sc.shape[1]:4d} warps, call wall "
              f"{rs.wall_of(sc.name):6.1f}s]  {ranking}")
    print(f"total wall: {rs.wall_s:.1f}s ({len(rs.call_walls())} sweep "
          "calls, one per trace-shape bucket of the compiled plan)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")

    def positive_int(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("need at least 1 seed")
        return n

    ap.add_argument("--seeds", type=positive_int, default=1, metavar="N",
                    help="trace seeds per workload (default 1)")
    ap.add_argument("--engine", choices=("event", "wavefront"),
                    default="event",
                    help="simulation engine (default: exact event loop)")
    ap.add_argument("--stress", action="store_true",
                    help="run the 1k-4k-warp stress matrix instead of "
                         "the paper table (implies the wavefront engine)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    if args.stress:
        run_stress(args.device)
        return

    from repro_torch.core.workloads import WORKLOAD_NAMES
    from repro_torch.paper_figures import fig7_performance

    wls = ("BFS", "SSSP", "BP", "CONS") if args.quick else WORKLOAD_NAMES
    rows, derived = fig7_performance(wls, seeds=tuple(range(args.seeds)),
                                     engine=args.engine, device=args.device)

    policies = []
    for r in rows:
        if r["policy"] not in policies:
            policies.append(r["policy"])
    print(f"engine: {args.engine}")
    print(f"{'workload':10s}" + "".join(f"{p:>12s}" for p in policies))
    for wl in wls:
        vals = {r["policy"]: r["speedup"] for r in rows
                if r["workload"] == wl}
        print(f"{wl:10s}" + "".join(f"{vals[p]:>12.3f}" for p in policies))
    print("\nharmonic-mean speedups (paper: WByp 1.336, MeDiC 1.415, "
          "MeDiC vs best prior 1.218):")
    for k, v in derived.items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
