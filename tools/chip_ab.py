"""Compare source trees of the port end to end on one NVIDIA card, in turns.

    python3 tools/chip_ab.py build/parent . . build/parent

Each tree is a checkout of this repository (for a parent commit, unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists).
For each tree in the order given, one process imports that tree's own
``chip_smoke.py`` and ``src/``, builds its kernels into its own
``build/``, and runs two of its measurements: the full-width Qwen3-1.7B
decode step (``_decode_profile``: host wall and device time per step)
and the RecurrentGemma-2B serve path (``phase_hybrid_serve``: prefill ms,
decode ms per step, the prefill timed per block). Each run prints one
JSON line; the card's name and power limit come first. Naming trees in
turns (parent, change, change, parent) puts both on the same card and
host, where host-bound times are comparable.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_tree(tree: str) -> dict:
    """The measurements of one tree, in this process."""
    path = str(Path(tree).resolve())
    sys.path[:0] = [path, path + "/src"]
    import torch
    import chip_smoke as CS
    from repro_torch.configs.base import get_config
    if not CS.__file__.startswith(path):
        raise RuntimeError(f"imported {CS.__file__}, not {tree}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    CS._build.build_all(sorted(set(CS.SOURCES.values())))
    build_s = time.perf_counter() - t0
    step = CS._decode_profile(get_config("qwen3_1_7b"), CS.DEV)
    hybrid = CS.phase_hybrid_serve()
    keep = ("wall_ms", "wall_ms_min", "device_ms", "device_busy_share",
            "kernels_per_step")
    return {"tree": tree, "build_s": build_s,
            "qwen_step": {k: step[k] for k in keep},
            "qwen_top_kernels": step["top_kernels"][:4],
            "hybrid": {k: hybrid[k] for k in (
                "prefill_ms", "decode_ms_per_step", "decode_tokens_per_s",
                "launches", "prefill_by_block")}}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_tree(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    rc = 0
    for tree in argv:
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True, cwd=ROOT)
        lines = out.stdout.strip().splitlines()
        if out.returncode or not lines:
            print(json.dumps({"tree": tree, "failed": out.returncode,
                              "stderr": out.stderr[-2000:]}), flush=True)
            rc = 1
        else:
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
