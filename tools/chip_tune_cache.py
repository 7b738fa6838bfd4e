"""Split the cache-pass kernel's device time on one NVIDIA card.

    python3 tools/chip_tune_cache.py

Times ``wave_cache_cuda`` (``src/repro_torch/csrc/wave_cache.cu``) at the
paper's hierarchy (``SimParams()``) in both of its instances (state in
shared memory, the plan's choice there, and in global memory) over waves
of L = 0, 1, 4 and 16 lanes, at B 512 (HAMMER2K's wave) and 1024
(HAMMER4K's): L = 0 is the fixed cost (launch, the state's copy in and
out), and the slope over L the cost of a lane. Each case is first held
bitwise against the plain version. One JSON line per case (`ms` from
CUDA events around the wrapper, host included; `device_ms` from
torch.profiler; `events_device_ms` CUDA events around launches made
straight through the C entry point, where the card and not the host
sets the pace; `enqueue_us` the host clock per call over 200 calls),
after the card's name and power limit; then the wrapper's host time by
function (cProfile), the host cost of the tensor operations it uses, and
the device time of source variants (each a rewrite of the source: the
same function another way, or, for timing only, with a part left out).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core.engine import SimParams  # noqa: E402
from repro_torch.kernels.cache_pass import ops as CPASS  # noqa: E402


def enqueue_us(fn, iters: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune_cache: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    prm = SimParams()
    for b in (512, 1024):
        st, args, pa = CS.cache_case(np.random.default_rng(3), 4 * b, b, 16,
                                     prm, BL.MEDIC, addr_hi=4000)
        for lanes in (0, 1, 4, 16):
            wave = list(args)
            wave[3] = args[3][:lanes].contiguous()
            plain = CPASS._ref.wave_cache_pass_ref(st, *wave, prm, pa) \
                if lanes else None
            for resident in (True, False):
                run = lambda: CPASS.wave_cache_cuda(  # noqa: E731
                    st, *wave, prm, pa, resident=resident)
                if plain is not None:
                    e = CS.max_abs_err(CS.flat(run()), CS.flat(plain))
                    CS.check(e == 0.0, f"wave_cache B={b} L={lanes}: "
                                       f"kernel != plain")
                print(json.dumps(dict(
                    b=b, lanes=lanes, resident=resident,
                    ms=CS.time_ms(run, iters=50),
                    device_ms=CS.device_ms(run, iters=50),
                    events_device_ms=raw_launch_ms(st, wave, prm, pa,
                                                   resident),
                    enqueue_us=enqueue_us(run))), flush=True)
    host_profile(prm)
    view_costs()
    variants(prm)
    return 0


def raw_launch_ms(st, args, prm, pa, resident=None, iters: int = 50) -> float:
    """Device ms per launch from CUDA events around launches made straight
    through the C entry point with one call's arguments: the host then
    enqueues far faster than the kernel runs, so the events time the card
    (a check on torch.profiler's figure)."""
    import array
    (clf, tokens, t0, addr_lb, pc_b, owt_b, slot_ok) = args
    st1, clf1, recs = CPASS.wave_cache_cuda(st, *args, prm, pa,
                                            resident=resident)
    lay = CPASS._layout(prm, *addr_lb.shape)
    ins = (addr_lb, pc_b, owt_b, slot_ok, tokens, t0,
           *(getattr(pa, f) for f in CPASS._PA_FIELDS),
           *(getattr(st, f) for f in CPASS._STATE_FIELDS), *clf)
    outs = (*(getattr(st1, f) for f in CPASS._STATE_FIELDS), *clf1, *recs)
    ptrs = array.array("q", [t.data_ptr() for t in ins + outs])
    plan = CPASS.plan_wave_cache(prm, addr_lb.shape[1], resident=resident)
    stream = CPASS.stream_of(addr_lb)
    fn = CPASS.WAVE_CACHE._fn

    def run():
        for _ in range(iters):
            if fn(lay.dims, lay.consts, ptrs.buffer_info()[0],
                  int(plan.resident), plan.threads, plan.slots_per_thread,
                  plan.smem_bytes, stream):
                raise RuntimeError("wave_cache launch failed")
    return CS.time_ms(run, iters=1) / iters


def view_costs(reps: int = 2000) -> None:
    """Host µs per call of the tensor operations a wrapper builds its
    outputs with, on CUDA tensors."""
    buf = torch.empty(1 << 16, dtype=torch.int32, device=CS.DEV)
    six = buf[:6 * 512].view(6, 512)
    ops = {"empty": lambda: torch.empty(512, dtype=torch.int32,
                                        device=CS.DEV),
           "unbind6": lambda: six.unbind(0),
           "as_strided": lambda: buf.as_strided((512, 8), (8, 1), 16),
           "split_with_sizes15": lambda: buf[:15 * 512].split_with_sizes(
               [512] * 15),
           "select": lambda: six[3], "view": lambda: six.view(3, 1024),
           "data_ptr": lambda: buf.data_ptr(),
           "is_contiguous": lambda: buf.is_contiguous()}
    out = {}
    for name, fn in ops.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    print(json.dumps(dict(host_us_per_op=out)), flush=True)


#: source rewrites of wave_cache.cu: (name, exact, [(old, new)]); exact
#: variants compute the same function, the others are for timing only
VARIANTS = [
    ("warp_pc_atomics", True, [(
        """      if (hit[k]) atomicAdd(&pc_hits[pidx[k]], 1);
      if (use[k]) atomicAdd(&pc_acc[pidx[k]], 1);
      if (addr[k] >= 0 && ok[k]) atomicAdd(&pc_req[pidx[k]], 1);""",
        """      const unsigned peers = __match_any_sync(__activemask(), pidx[k]);
      const int nh = __popc(__ballot_sync(peers, hit[k]) & peers);
      const int nu = __popc(__ballot_sync(peers, use[k]) & peers);
      const int nv = __popc(__ballot_sync(peers, addr[k] >= 0 && ok[k]) & peers);
      if ((tid & 31) == __ffs(peers) - 1) {
        if (nh) atomicAdd(&pc_hits[pidx[k]], nh);
        if (nu) atomicAdd(&pc_acc[pidx[k]], nu);
        if (nv) atomicAdd(&pc_req[pidx[k]], nv);
      }""")]),
    ("bounds_1024", True, [("__global__ void __launch_bounds__(kThreads)",
                            "__global__ void __launch_bounds__(kMaxThreads)")]),
    ("no_records", False, [("      rec.", "      if (0) rec.")]),
]


def variants(prm) -> None:
    """Each variant's device time at B 512, L 16 (state in shared
    memory), beside the source as built, on the fuzz's waves with 64 PCs
    and with 12."""
    import ctypes
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR.parent / "cache_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "wave_cache.cu").read_text()
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
    waves, waves_args = {}, {}
    for pcs in (64, 12):  # the fuzz's PCs; HAMMER2K's ~12 per instruction
        st, args, pa = CS.cache_case(np.random.default_rng(3), 2048, 512, 16,
                                     prm, BL.MEDIC, addr_hi=4000)
        args = list(args)
        args[4] = torch.remainder(args[4], pcs).contiguous()
        plain = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
        waves[pcs] = (lambda st=st, args=args, pa=pa:
                      CPASS.wave_cache_cuda(st, *args, prm, pa), plain)
        waves_args[pcs] = (st, args, prm, pa)
    built = CPASS.WAVE_CACHE

    def report(name, exact):
        row = dict(variant=name, exact=exact)
        for pcs, (run, plain) in waves.items():
            if exact:
                e = CS.max_abs_err(CS.flat(run()), CS.flat(plain))
                CS.check(e == 0.0, f"variant {name}: kernel != plain")
            row[f"device_ms_pcs{pcs}"] = CS.device_ms(run, iters=50)
            row[f"events_device_ms_pcs{pcs}"] = raw_launch_ms(*waves_args[pcs])
        print(json.dumps(row), flush=True)
    report("as_built", True)
    for name, exact, _ in VARIANTS:
        log, _ = procs[name].communicate()
        if procs[name].returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        kern = _build.Kernel("wave_cache", built.argtypes)
        fn, err = lib.wave_cache_launch, lib.wave_cache_error_string
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        kern._fn, kern._err = fn, err
        CPASS.WAVE_CACHE = kern
        report(name, exact)
    CPASS.WAVE_CACHE = built


def host_profile(prm, calls: int = 300) -> None:
    """Where the wrapper's host time goes at B 512, L 16: cProfile's own
    time per call of the top functions (the profiler slows every Python
    call, so read shares, not times)."""
    import cProfile
    import pstats
    st, args, pa = CS.cache_case(np.random.default_rng(3), 2048, 512, 16,
                                 prm, BL.MEDIC, addr_hi=4000)
    CPASS.wave_cache_cuda(st, *args, prm, pa)
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        CPASS.wave_cache_cuda(st, *args, prm, pa)
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2], f"{k[0].split('/')[-1]}:{k[1]}:{k[2]}", v[1])
                   for k, v in stats.items()), reverse=True)[:15]
    total = sum(v[2] for v in stats.values())
    print(json.dumps(dict(host_profile_us_per_call=total / calls * 1e6,
                          top=[dict(fn=f, us=t / calls * 1e6, n=n // calls)
                               for t, f, n in rows])), flush=True)


if __name__ == "__main__":
    sys.exit(main())
