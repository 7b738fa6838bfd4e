"""Compare source trees of the port end to end on one NVIDIA card, in turns.

    python3 tools/chip_ab.py [--only qwen,hybrid,scale,kernels] \
        build/parent . . build/parent

Each tree is a checkout of this repository (for a parent commit, unpack
``git archive <commit>`` into a directory that ``.gitignore`` lists).
For each tree in the order given, one process imports that tree's own
``chip_smoke.py`` and ``src/``, builds its kernels into its own
``build/``, and runs the selected measurements (all by default):

  * ``qwen``    — the full-width Qwen3-1.7B decode step
    (``_decode_profile``: host wall and device time per step);
  * ``hybrid``  — the RecurrentGemma-2B serve path
    (``phase_hybrid_serve``: prefill ms, decode ms per step, the prefill
    timed per block);
  * ``scale``   — HAMMER2K × {Baseline, PCAL, WByp, MeDiC} through the
    wavefront engine, three runs: requests per second of each;
  * ``kernels`` — the pool gather, the cache pass, the timing pass (N
    8192 and 16,384), the mLSTM (the xLSTM-125M prefill's call) and the
    RG-LRU (the hybrid prefill's) at their paths' calls, split into device
    and host time: ``ms`` (CUDA events around the wrapper, host
    included), ``device_ms`` (every kernel the call launches,
    torch.profiler), ``kernel_ms`` (the named kernel alone),
    ``enqueue_us`` (host clock per call over a run of calls, no
    synchronize inside); beside them ``torch.index_select`` and the
    engine's offload read of K and V, and the gather's and
    ``index_select``'s ``ms`` in turns over seven rounds.

Each run prints one JSON line; the card's name and power limit come
first. Naming trees in turns (parent, change, change, parent) puts both
on the same card and host, where host-bound times are comparable.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MEASURES = ("qwen", "hybrid", "scale", "kernels")


def _profile(CS, fn, match: str, iters: int = 50) -> dict:
    """Device time per call of ``fn`` from torch.profiler, by this tool's
    own copy of ``chip_smoke.device_split`` (so every tree is measured the
    same way): all kernels, the kernels whose name holds ``match``, and
    kernels per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: (round(e.count / iters), CS._device_us(e) / e.count)
                for e in prof.key_averages() if CS._device_us(e) > 0}
        if seen and all(n for n, _ in seen.values()):
            return dict(
                device_ms=sum(n * us for n, us in seen.values()) / 1e3,
                kernel_ms=sum(n * us for k, (n, us) in seen.items()
                              if match in k) / 1e3,
                kernels_per_call=sum(n for n, _ in seen.values()))
    raise RuntimeError(f"torch.profiler saw no kernel of {match}")


def _enqueue_us(fn, iters: int = 200) -> float:
    """Host time per call with no synchronize inside the run."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def _split(CS, fn, match: str, iters: int = 100) -> dict:
    return dict(ms=CS.time_ms(fn, iters=iters),
                **_profile(CS, fn, match), enqueue_us=_enqueue_us(fn))


def measure_kernels(CS) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import baselines as BL
    from repro_torch.core.engine import SimParams
    GATHER, CPASS = CS.GATHER, CS.CPASS
    dev = CS.DEV
    gen = torch.Generator(device=dev).manual_seed(10)
    n = CS.L_ * CS.B_ * CS.P_
    shape = (n, CS.PAGE, CS.HKV, CS.D_)
    pk = CS._randn(shape, torch.bfloat16, gen, dev)
    pv = CS._randn(shape, torch.bfloat16, gen, dev)
    tbl = CS.offload_table(2, 13, dev)
    idx = tbl.view(-1).long()
    if hasattr(GATHER, "medic_gather_pools"):
        pair = lambda: GATHER.medic_gather_pools((pk, pv), tbl)  # noqa: E731
    else:
        pair = lambda: (GATHER.medic_gather(pk, tbl),  # noqa: E731
                        GATHER.medic_gather(pv, tbl))
    one = lambda: GATHER.medic_gather_cuda(pk, tbl)  # noqa: E731
    lib = lambda: torch.index_select(pk, 0, idx)  # noqa: E731
    gather = dict(one=_split(CS, one, "gather"),
                  index_select=_split(CS, lib, "index"),
                  k_and_v=_split(CS, pair, "gather"))
    # `ms` of the gather and of index_select in turns, seven rounds
    turns = {"one": [], "index_select": []}
    for _ in range(7):
        for key, fn in (("one", one), ("index_select", lib)):
            turns[key].append(CS.time_ms(fn, iters=100))
    gather["ms_in_turns"] = turns
    prm = SimParams()
    st, args, pa = CS.cache_case(np.random.default_rng(3), 2048, 512, 16,
                                 prm, BL.MEDIC, addr_hi=1 << 20)
    cache = _split(CS, lambda: CPASS.wave_cache_cuda(st, *args, prm, pa),
                   "wave_cache", iters=50)
    queue = {}
    for n in (8192, 16384):
        slots, carry = CS.wave_case(np.random.default_rng(1), n, False)
        queue[n] = _split(CS, lambda slots=slots, carry=carry:
                          CS.WSCAN.wave_queue_cuda(*slots, carry, exact=False,
                                                   **CS.QKW), "wave_queue")
    margs, _ = CS._mlstm_inputs(gen, dev, 4, 1024, 4, 192, 384,
                                torch.bfloat16, False)
    mlstm = _split(CS, lambda: CS.MLSTM.mlstm_cuda(*margs), "mlstm", iters=20)
    a = 0.9 + 0.099 * torch.rand((2, 3072, 2560), generator=gen, device=dev)
    x = 0.1 * torch.randn((2, 3072, 2560), generator=gen, device=dev)
    h0 = torch.randn((2, 2560), generator=gen, device=dev)
    rg_lru = _split(CS, lambda: CS.RGLRU.rg_lru_cuda(a, x, h0), "rg_lru",
                    iters=50)
    rg_lru["queued_ms"] = CS.queued_ms(lambda: CS.RGLRU.rg_lru_cuda(a, x, h0),
                                       iters=50)
    return dict(medic_gather=gather, wave_cache=cache, wave_queue=queue,
                mlstm=mlstm, rg_lru=rg_lru)


def measure_scale(CS, runs: int = 3) -> dict:
    """HAMMER2K × 4 policies: requests per second of each run."""
    import torch
    spec = CS.TG.STRESS_SPECS["HAMMER2K"]
    tr = CS.TG.generate(spec, 0)
    pols = (CS.BL.BASELINE, CS.BL.PCAL, CS.BL.WBYP, CS.BL.MEDIC)
    requests = int((tr["lines"] >= 0).sum()) * len(pols)
    rates = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CS.sweep(tr, pols, spec.n_warps)
        torch.cuda.synchronize()
        rates.append(requests / (time.perf_counter() - t0))
    return dict(requests=requests, requests_per_s=rates)


def run_tree(tree: str, only) -> dict:
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
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    if "kernels" in only:
        out["kernels"] = measure_kernels(CS)
    if "scale" in only:
        out["scale"] = measure_scale(CS)
    if "qwen" in only:
        step = CS._decode_profile(get_config("qwen3_1_7b"), CS.DEV)
        keep = ("wall_ms", "wall_ms_min", "device_ms", "device_busy_share",
                "kernels_per_step")
        out["qwen_step"] = {k: step[k] for k in keep}
        out["qwen_top_kernels"] = step["top_kernels"][:4]
    if "hybrid" in only:
        hybrid = CS.phase_hybrid_serve()
        out["hybrid"] = {k: hybrid[k] for k in (
            "prefill_ms", "decode_ms_per_step", "decode_tokens_per_s",
            "launches", "prefill_by_block")}
    return out


def main(argv) -> int:
    only = MEASURES
    if argv[:1] == ["--only"] and len(argv) > 1:
        only = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(only) <= set(MEASURES):
            print(f"--only takes {','.join(MEASURES)}", file=sys.stderr)
            return 2
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(run_tree(argv[1], only)), flush=True)
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
        out = subprocess.run([sys.executable, __file__, "--only",
                              ",".join(only), "--one", tree],
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
