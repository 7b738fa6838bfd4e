"""Sweep and split the RG-LRU kernel's device time on one NVIDIA card.

    python3 tools/chip_tune_rglru.py

Times ``rg_lru_cuda`` (``src/repro_torch/csrc/rg_lru.cu``) at the hybrid
prefill's call (B 2, S 3072, W 2560, float32). It writes copies of the
source into ``build/rglru_variants/``, compiles them all at once (one
``nvcc`` each, the port's flags) and binds each in turn in place of the
wrapper's kernel:

  * the tile sweep: the source with its tile constants (``kC`` channels a
    block, ``kT`` time steps a tile, ``kStages`` tiles in the ring)
    rewritten, over channels 16 and 32, steps 32, 64 and 128 and stages
    2, 3, 4 and 6, each in both copy instances (16-byte and 4-byte) and
    each held bitwise against the plain version first;
  * the split (timing only), at the built tiles: ``loads_only`` (the ring
    is filled, nothing is computed or stored), ``no_store`` (loads and
    steps, nothing stored) and ``no_loads`` (the steps and the stores run
    on whatever the ring holds).

One JSON line per variant and instance, after the card's name and power
limit: ``device_ms`` (torch.profiler), ``queued_ms`` (CUDA events around
calls queued behind a sleep kernel, the host hidden) and the share of the
byte bound (12 bytes an element at 3.35 TB/s) that ``device_ms`` reaches.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rg_lru import ops as RGLRU  # noqa: E402

SHAPE = (2, 3072, 2560)
OUT = _build.BUILD_DIR.parent / "rglru_variants"
#: the tile constants as the source states them
TILES = ("kC = 32;", "kT = 32;", "kStages = 4;")
COPY = ("        copy_async(da, pa, V == 4);\n"
        "        copy_async(db, pb, V == 4);\n")
STORE = "        __stcs(po, hv);\n"
STEPS = "    if (mine) {\n      const int n"

#: variant tag -> the tiles (channels, steps, stages) it is built with
GRID = {f"c{c}_t{t}_s{st}": (c, t, st)
        for c, t, st in itertools.product((16, 32), (32, 64, 128),
                                          (2, 3, 4, 6))
        if (c, t, st) != (RGLRU.CHANNELS, RGLRU.STEPS, RGLRU.STAGES)}
#: variant tag -> [(old, new)] source rewrites; "as_built" is the source
VARIANTS = {
    "as_built": [],
    **{tag: [(old, f"{old.split('=')[0]}= {v};")
             for old, v in zip(TILES, knobs)] for tag, knobs in GRID.items()},
    "loads_only": [(STEPS, STEPS.replace("mine", "false"))],
    "no_store": [(STORE, "")],
    "no_loads": [(COPY, "")],
}
#: the variants timed only: their results are not the recurrence
SPLIT = ("loads_only", "no_store", "no_loads")


def build() -> dict:
    """Compile every variant at once; returns ``{tag: ctypes.CDLL}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rg_lru.cu").read_text()
    procs = {}
    for tag, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {tag}: {old!r} not found")
            text = text.replace(old, new)
        (OUT / f"{tag}.cu").write_text(text)
        procs[tag] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{tag}.so"), str(OUT / f"{tag}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        if tag == "as_built":
            print(json.dumps(dict(variant=tag, ptxas=[
                ln.strip() for ln in log.splitlines() if "registers" in ln])),
                flush=True)
        libs[tag] = ctypes.CDLL(str(OUT / f"lib{tag}.so"))
    return libs


def bind(lib) -> _build.Kernel:
    kern = _build.Kernel("rg_lru", RGLRU.RG_LRU.argtypes)
    fn, err = lib.rg_lru_launch, lib.rg_lru_error_string
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._fn, kern._err = fn, err
    return kern


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_rglru: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    args = CS._rg_lru_case(gen, dev, *SHAPE, 0.9, 0.999)
    plain = RGLRU._ref.rg_lru_ref(*args)
    bound_ms = CS.nbytes(list(args) + [plain]) / CS.HBM_BYTES_PER_S * 1e3
    b, _, w = SHAPE
    built = RGLRU.RG_LRU
    for tag, lib in libs.items():
        RGLRU.RG_LRU = bind(lib)
        c, t, st = GRID.get(tag, (RGLRU.CHANNELS, RGLRU.STEPS,
                                  RGLRU.STAGES))
        for vec in (4, 1):
            plan = RGLRU.RgLruPlan(vec, c, t, st, 8 * st * t * c,
                                   -(-w // c) * b)
            run = (lambda plan=plan: RGLRU.rg_lru_cuda(*args, plan=plan))
            if tag not in SPLIT:
                CS.check(torch.equal(run(), plain),
                         f"{tag} {plan}: kernel != plain")
            d_ms = CS.device_ms(run, iters=50)
            print(json.dumps(dict(
                variant=tag, plan=plan._asdict(), device_ms=d_ms,
                queued_ms=CS.queued_ms(run, iters=50),
                byte_bound_share=bound_ms / d_ms)), flush=True)
    RGLRU.RG_LRU = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
