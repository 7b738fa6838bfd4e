"""Split the mLSTM kernels' device time on one NVIDIA card.

    python3 tools/chip_tune_mlstm.py

Times ``mlstm_cuda`` (``src/repro_torch/csrc/mlstm.cu``) at the xLSTM-125M
prefill's call (B 4, S 1024, H 4, Dk 192, Dv 384, bf16) as built and as
source variants of its state kernel, each a rewrite of the source compiled
at once (one ``nvcc`` each) and bound in place of the wrapper's kernel. A
variant leaves one step of a chunk out (timing only; its outputs are
wrong), so the difference to the source as built is that step's cost:

  * ``no_stage``   — the tiles are staged for the first chunk only (k
    and v at the chunk's start, q and the weights a chunk ahead);
  * ``no_den``     — no q.n and denominators;
  * ``no_out``     — no W.V and q.C products (the output);
  * ``no_update``  — no (k * sc)^T.V product (the state update);
  * ``no_norm``    — no normalizer update.

One JSON line per variant, after the card's name and power limit: the
device µs of each of the two kernels (torch.profiler) and ``queued_ms``
(CUDA events around calls queued behind a sleep kernel).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.mlstm import ops as MLSTM  # noqa: E402

KSTAGE = "    stage(ks, ldq, k + qk_base + c0p * qk_row, qk_row, lc, DK, L, DKP);"
VSTAGE = "    stage(vs, VS, v + v_base + c0p * v_row, v_row, lc, nv, L, DVB);"

#: (name, [(old, new)]): source rewrites of mlstm.cu
VARIANTS = [
    ("no_stage", [(KSTAGE, "    if (c == 0)\n" + KSTAGE),
                  (VSTAGE, "    if (c == 0)\n" + VSTAGE),
                  ("    if (c + 1 < sh.nc) {  // the next chunk's",
                   "    if (false) {  // the next chunk's")]),
    ("no_den", [("for (int d = part; d < DK; d += 4)",
                 "for (int d = part; d < 0; d += 4)")]),
    ("no_out", [("    for (int k0 = 0; k0 < L; k0 += 8) {\n"
                 "      uint32_t ah[4], al[4];\n"
                 "      frag_a<false>(ws",
                 "    for (int k0 = 0; k0 < 0; k0 += 8) {\n"
                 "      uint32_t ah[4], al[4];\n"
                 "      frag_a<false>(ws"),
                ("for (int k0 = 0; k0 < DKP; k0 += 8) {",
                 "for (int k0 = 0; k0 < 0; k0 += 8) {")]),
    ("no_update", [("      for (int k0 = 0; k0 < L; k0 += 8) {\n"
                    "        uint32_t bh_[4][2], bl_[4][2];",
                    "      for (int k0 = 0; k0 < 0; k0 += 8) {\n"
                    "        uint32_t bh_[4][2], bl_[4][2];")]),
    ("no_norm", [("    for (int d = tid; d < DK; d += NT) {\n      float acc = 0.f;",
                  "    for (int d = tid; d < 0; d += NT) {\n      float acc = 0.f;")]),
]


def measure(run) -> dict:
    split = CS.device_split(run, iters=10)
    us = {next((n for n in ("mlstm_chunk_kernel", "mlstm_state_kernel")
                if n in k), "other"): v for k, (_, v) in split.items()}
    return dict(us=us, queued_ms=CS.queued_ms(run, iters=20))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_mlstm: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR.parent / "mlstm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "mlstm.cu").read_text()
    procs = {}
    for name, edits in VARIANTS:
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
    _build.build_all(["mlstm"])
    gen = torch.Generator(device=CS.DEV).manual_seed(14)
    args, _ = CS._mlstm_inputs(gen, CS.DEV, 4, 1024, 4, 192, 384,
                               torch.bfloat16, False)
    run = lambda: MLSTM.mlstm_cuda(*args)  # noqa: E731
    print(json.dumps(dict(variant="as_built", **measure(run))), flush=True)
    built = MLSTM.MLSTM
    for name, _ in VARIANTS:
        log, _ = procs[name].communicate()
        if procs[name].returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        kern = _build.Kernel("mlstm", built.argtypes)
        fn, err = lib.mlstm_launch, lib.mlstm_error_string
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        kern._fn, kern._err = fn, err
        MLSTM.MLSTM = kern
        print(json.dumps(dict(variant=name, **measure(run))), flush=True)
    MLSTM.MLSTM = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
