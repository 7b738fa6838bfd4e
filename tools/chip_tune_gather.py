"""Time variants of the pool-gather kernel on one NVIDIA card.

    python3 tools/chip_tune_gather.py

``src/repro_torch/csrc/medic_gather.cu`` moves 16-byte pages with a loop
of ``kWords`` 16-byte words a thread, ``kLoopThreads`` threads a block,
``kUnroll`` loads in flight. This script writes a copy of the source per
variant with those three constants rewritten into
``build/gather_variants/`` ("as_built" is the source as it stands),
compiles them all at once with the port's flags, binds each in turn in
place of the wrapper's kernel, holds it bitwise against the plain version
(the path's table, holes, an all-hole table) and times it where the
serving path calls it: 28 pages of bf16 [16, 8, 128], one pool and K and
V in one launch. One JSON line per variant (`ms` from CUDA events around
the wrapper, `device_ms` from torch.profiler), after the card's name and
power limit; ``torch.index_select`` on the same pool comes last.
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
from repro_torch.kernels.medic_gather import ops as GATHER  # noqa: E402

OUT = _build.BUILD_DIR.parent / "gather_variants"
#: the loop's constants as the source states them
CONSTS = ("kLoopThreads = 64;", "kWords = 8;", "kUnroll = 8;")
#: variant tag -> (threads, words, unroll); None is the source as built
ROUTES = {"as_built": None,
          **{f"loop_t{t}_w{w}_u{u}": (t, w, u)
             for t, w, u in ((256, 4, 1), (256, 4, 2), (256, 4, 4),
                             (128, 4, 4), (128, 8, 4), (128, 8, 8),
                             (256, 8, 8), (256, 2, 2), (128, 2, 2))}}


def build(tags=None) -> dict:
    """Compile the named variants (all by default) at once; returns
    ``{tag: ctypes.CDLL}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "medic_gather.cu").read_text()
    procs = {}
    for tag, knobs in ROUTES.items():
        if tags is not None and tag not in tags:
            continue
        text = src
        if knobs is not None:
            for old, v in zip(CONSTS, knobs):
                if old not in text:
                    raise RuntimeError(f"variant {tag}: {old!r} not found")
                text = text.replace(old, f"{old.split('=')[0]}= {v};")
        (OUT / f"{tag}.cu").write_text(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"lib{tag}.so"), str(OUT / f"{tag}.cu")]
        procs[tag] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = ctypes.CDLL(str(OUT / f"lib{tag}.so"))
    return libs


def bind(lib) -> _build.Kernel:
    kern = _build.Kernel("medic_gather", GATHER.MEDIC_GATHER.argtypes)
    fn, err = lib.medic_gather_launch, lib.medic_gather_error_string
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._fn, kern._err = fn, err
    return kern


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_gather: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    libs = build()
    dev = CS.DEV
    gen = torch.Generator(device=dev).manual_seed(0)
    n = CS.L_ * CS.B_ * CS.P_
    shape = (n, CS.PAGE, CS.HKV, CS.D_)
    pk = CS._randn(shape, torch.bfloat16, gen, dev)
    pv = CS._randn(shape, torch.bfloat16, gen, dev)
    tbl = CS.offload_table(2, 13, dev)
    holes = torch.randint(0, n, (CS.B_, CS.P_), generator=gen, device=dev)
    holes[torch.rand((CS.B_, CS.P_), generator=gen, device=dev) < 0.3] = -1
    tables = (tbl, holes.to(torch.int32),
              torch.full((3, 5), -1, dtype=torch.int32, device=dev))
    built = GATHER.MEDIC_GATHER
    for tag, lib in libs.items():
        GATHER.MEDIC_GATHER = bind(lib)
        for t in tables:
            outs = GATHER.medic_gather_pools_cuda((pk, pv), t)
            torch.cuda.synchronize()
            for o, p in zip(outs, (pk, pv)):
                CS.check(torch.equal(o, GATHER._ref.medic_gather_ref(p, t)),
                         f"gather route {tag}: kernel != plain")
        one = lambda: GATHER.medic_gather_cuda(pk, tbl)  # noqa: E731
        pair = lambda: GATHER.medic_gather_pools_cuda((pk, pv), tbl)  # noqa
        print(json.dumps(dict(
            route=tag, ms=CS.time_ms(one, iters=100),
            device_ms=CS.device_ms(one, iters=50),
            pools_ms=CS.time_ms(pair, iters=100),
            pools_device_ms=CS.device_ms(pair, iters=50))), flush=True)
    GATHER.MEDIC_GATHER = built
    idx = tbl.view(-1).long()
    lib_call = lambda: torch.index_select(pk, 0, idx)  # noqa: E731
    print(json.dumps(dict(route="index_select",
                          ms=CS.time_ms(lib_call, iters=100),
                          device_ms=CS.device_ms(lib_call, iters=50))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
