"""Serve a model with batched requests under the MeDiC pool manager and
print the policy A/B against LRU, on the PyTorch port (the counterpart of
``examples/serve_medic.py``).

    PYTHONPATH=src python examples/torch_serve_medic.py [--device cpu]
        [--full]

It runs on the card by default (prefill through the flash-attention
kernel, every decode step through the paged decode kernel, offloads
through the pool-gather kernel) and raises without one; ``--device cpu``
runs the kernels' plain versions. The model is Qwen3-1.7B cut to 2 layers
of the reduced width, as in the reference's example, or at full width
with ``--full``; the pool metrics do not depend on the width.
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.serving.engine import EngineConfig, ServeEngine, run_ab
from repro_torch.serving.pool import PoolConfig
from repro_torch.serving.request import ServeWorkload, generate_requests


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="Qwen3-1.7B at full width (28 layers)")
    args = ap.parse_args()
    cfg = get_config("qwen3_1_7b")
    if not args.full:
        cfg = cfg.reduced(num_layers=2)
    wl = ServeWorkload(n_requests=24, chat_frac=0.6)
    pool = PoolConfig(budget_blocks=48, block_tokens=16)
    ecfg = EngineConfig(max_slots=4, max_len=448)
    out = run_ab(cfg, wl, pool, ecfg, device=args.device)

    print(f"{'':22s}{'LRU':>12s}{'MeDiC':>12s}")
    for key in ("throughput", "completed", "mean_ttft", "mean_qdelay",
                "bypassed_blocks", "stall_steps"):
        a, b = out["lru"][key], out["medic"][key]
        print(f"{key:22s}{a:>12.3f}{b:>12.3f}" if isinstance(a, float)
              else f"{key:22s}{a:>12d}{b:>12d}")
    gain = out["medic"]["throughput"] / max(out["lru"]["throughput"], 1e-9)
    print(f"\nMeDiC throughput gain under pool oversubscription: {gain:.2f}x")

    # per-sequence-type view (the paper's Fig 2 analogue at the pool)
    print("\nper-sequence pool hit ratios (MeDiC run):")
    eng = ServeEngine(cfg, ecfg, pool, device=args.device)
    eng.run(generate_requests(wl, seed=0), max_steps=800)
    ratios = eng.pool.snapshot()["seq_hit_ratio"]
    print("  " + " ".join(f"{r:.2f}" for r in ratios if np.isfinite(r)))


if __name__ == "__main__":
    main()
