"""Split the timing-pass kernel's device time on one NVIDIA card.

    python3 tools/chip_tune_queue.py

Times ``wave_queue_cuda`` (``src/repro_torch/csrc/wave_queue.cu``) at N
8192 (HAMMER2K's wave) and 16,384 (HAMMER4K's), as
built and as source variants, each a rewrite of the source compiled at
once (one ``nvcc`` each) and bound in place of the wrapper's kernel:

  * ``stop_*`` (timing only): the kernel returns before a step, so the
    differences between them are the steps' costs (the fill of the pass's
    slots into shared memory, each thread's passes P0..P5 over its slots
    and the cluster scans S1..S5); the compiler drops what a returned
    variant no longer needs, so read them as a split, not exact costs;
  * ``unroll*`` (the same function): the per-slot loops unrolled.

Each exact variant is first held bitwise against the plain version. One
JSON line per variant and N, after the card's name and power limit:
``device_ms`` (torch.profiler) and ``queued_ms`` (CUDA events around
calls queued behind a sleep kernel, the host hidden).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.wavefront_scan import ops as WSCAN  # noqa: E402

LOOP = "for (int i = 0; i < kn; ++i) {"
FILL = "for (int l = tid; l < per; l += nt) {"


def _stop(marker: str) -> list:
    # every block of the cluster leaves at the same point, after a cluster
    # barrier, so no block reads the shared memory of one that has exited
    return [(marker, "    cl.sync();\n    return;\n" + marker)]


#: (name, exact, [(old, new)]): source rewrites of wave_queue.cu
VARIANTS = [
    ("stop_fill", False, _stop("    float x1[2 * QMAX];")),
    ("stop_S1", False, _stop("    // ---- P1:")),
    ("stop_P1", False, _stop("      block_scan<2 * QMAX>(x2, c2, sm, par, cl);")),
    ("stop_S2", False, _stop("      // ---- P2:")),
    ("stop_S3", False, _stop("      // ---- P3:")),
    ("stop_S4", False, _stop("      // ---- P4:")),
    ("stop_S5", False, _stop("      // ---- P5:")),
    ("unroll2", True, [(LOOP, '_Pragma("unroll 2") ' + LOOP)]),
    ("fill_unroll4", True, [(FILL, '_Pragma("unroll 4") ' + FILL)]),
]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_queue: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR.parent / "queue_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "wave_queue.cu").read_text()
    procs = {}
    for name, _, edits in VARIANTS:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: text not found")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all(["wave_queue"])
    waves = {}
    for n in (8192, 16384):
        slots, carry = CS.wave_case(np.random.default_rng(1), n, False)
        plain = WSCAN._ref.wave_queue_recovery_ref(*slots, carry,
                                                   exact=False, **CS.QKW)
        waves[n] = (lambda slots=slots, carry=carry: WSCAN.wave_queue_cuda(
            *slots, carry, exact=False, **CS.QKW), plain)
    built = WSCAN.WAVE_QUEUE

    def report(name, exact):
        for n, (run, plain) in waves.items():
            if exact:
                e = CS.max_abs_err(CS.flat(run()), CS.flat(plain))
                CS.check(e == 0.0, f"variant {name} N={n}: kernel != plain")
            print(json.dumps(dict(variant=name, exact=exact, n=n,
                                  device_ms=CS.device_ms(run, iters=50),
                                  queued_ms=CS.queued_ms(run, iters=50))),
                  flush=True)
    report("as_built", True)
    for name, exact, _ in VARIANTS:
        log, _ = procs[name].communicate()
        if procs[name].returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        kern = _build.Kernel("wave_queue", built.argtypes)
        fn, err = lib.wave_queue_launch, lib.wave_queue_error_string
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        kern._fn, kern._err = fn, err
        WSCAN.WAVE_QUEUE = kern
        print(json.dumps(dict(variant=name, ptxas=regs)), flush=True)
        report(name, exact)
    WSCAN.WAVE_QUEUE = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
