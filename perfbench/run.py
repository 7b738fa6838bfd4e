"""Run one cell of the benchmark on this machine's CUDA device(s).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints one JSON line (see ``perfbench.harness.cli``). Set-up time counts
from this file's first statement.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # the checkout's own cache directories, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from perfbench.harness import cli
    sys.exit(cli.main(sys.argv[1:], T_START))
