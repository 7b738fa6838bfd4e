"""Time instances of the bf16 flash-attention kernel on one NVIDIA card.

    python3 tools/chip_tune_flash.py

``src/repro_torch/csrc/flash_attention.cu`` picks one instance
``launch_tc_d<DP, BK, NW>`` per padded head dim DP (BK keys per tile, NW
warps). This script writes copies of the source with one of those lines
rewritten into ``build/flash_variants/``, compiles them all at once with
the port's nvcc flags, binds each in turn in place of the wrapper's
kernel, holds it against the plain version (the reference's bf16
tolerance) and times it where the serving paths call it: DP 256 at
RecurrentGemma-2B's local attention layer (B 2, S 3072, H 10 on one KV
head, window 2048), DP 128 at Qwen3-1.7B's longest prefill (S 432, H 16
on 8). One JSON line per variant (`ms` from CUDA events around the
wrapper, `device_ms` from torch.profiler), after the card's name and
power limit; the source's own instances run as "as_built".
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FLASH  # noqa: E402

OUT = _build.BUILD_DIR.parent / "flash_variants"
#: (DP, BK, NW) instances to try
VARIANTS = [(256, 32, 4), (256, 32, 8), (256, 64, 4), (256, 64, 8),
            (128, 32, 4), (128, 64, 4), (128, 64, 8), (128, 128, 4)]
INSTANCE = re.compile(r"launch_tc_d<(\d+), (\d+), (\d+)>\(sh")


def variant_source(src: str, dp: int, bk: int, nw: int) -> str:
    """``src`` with the instance for ``dp`` set to (bk, nw)."""
    def swap(m):
        if int(m.group(1)) != dp:
            return m.group(0)
        return f"launch_tc_d<{dp}, {bk}, {nw}>(sh"
    out, n = INSTANCE.subn(swap, src)
    if n != 3 or f"launch_tc_d<{dp}, {bk}, {nw}>(sh" not in out:
        raise RuntimeError("instance lines not found in flash_attention.cu")
    return out


def build(tags) -> dict:
    """Compile every variant at once; returns ``{tag: ctypes.CDLL}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for tag, (dp, bk, nw) in tags.items():
        cu = OUT / f"{tag}.cu"
        cu.write_text(variant_source(src, dp, bk, nw))
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
               str(OUT / f"lib{tag}.so"), str(cu)]
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
    kern = _build.Kernel("flash_attention", FLASH.FLASH_ATTENTION.argtypes)
    fn, err = lib.flash_attention_launch, lib.flash_attention_error_string
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._fn, kern._err = fn, err
    return kern


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    hyb = [CS._randn(shape, torch.bfloat16, gen, dev)
           for shape in ((2, 3072, 10, 256), (2, 3072, 1, 256),
                         (2, 3072, 1, 256))]
    qwen = [CS._randn(shape, torch.bfloat16, gen, dev)
            for shape in ((1, 432, 16, 128), (1, 432, 8, 128),
                          (1, 432, 8, 128))]
    return {256: (hyb, 2048), 128: (qwen, None)}


def measure(kernel, inputs, window) -> dict:
    FLASH.FLASH_ATTENTION = kernel
    run = lambda: FLASH.flash_attention_cuda(*inputs, window=window)
    out = run()
    torch.cuda.synchronize()
    plain = FLASH._ref.flash_attention_ref(*inputs, window=window)
    err = CS._close(out, plain, torch.bfloat16, "flash variant")
    return dict(max_abs_err=err, ms=CS.time_ms(run, iters=10),
                device_ms=CS.device_ms(run, iters=5))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_flash: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    tags = {f"dp{dp}_bk{bk}_nw{nw}": (dp, bk, nw)
            for dp, bk, nw in VARIANTS}
    libs = build(tags)
    built = FLASH.FLASH_ATTENTION
    data = cases(CS.DEV)
    for dp, (inputs, window) in data.items():
        shown = dict(dp=dp, variant="as_built",
                     **measure(built, inputs, window))
        print(json.dumps(shown), flush=True)
        for tag, (vdp, bk, nw) in tags.items():
            if vdp == dp:
                row = dict(dp=dp, bk=bk, nw=nw, variant=tag,
                           **measure(bind(libs[tag]), inputs, window))
                print(json.dumps(row), flush=True)
    FLASH.FLASH_ATTENTION = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
