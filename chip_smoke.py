"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them. Phases, one JSON line each on stdout:

  1. device   — the card's name and power limit;
  2. build    — both CUDA kernels compiled from ``src/repro_torch/csrc``;
  3. wave_queue — the timing-pass kernel against its plain PyTorch
     version on the card, bitwise, on fuzzed waves; ms per call;
  4. wave_cache — the cache-pass kernel against its plain version,
     bitwise on state, classifier rows and the nine records; ms per call;
  5. golden   — PHASED256 and PHASED_RECOVER256 through
     ``simulate_sweep(engine="wavefront", device="cuda")`` with the
     five-policy labeling ladder: IPC within 1e-6 of the goldens, one
     launch of each kernel per wave, and the same run with the plain
     versions on the card (integer and per-element outputs bitwise, float
     reductions within rtol 1e-6);
  6. main path — HAMMER2K × {Baseline, PCAL, WByp, MeDiC} (the paper's
     hierarchy, 2048 warps, waves of 512) with every launch count set to
     0 just before and read just after, then HAMMER4K × MeDiC;
  7. kernels  — one JSON object per kernel: launches in the main path,
     max error against the plain version, times and the bound.

Then the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core import tracegen as TG  # noqa: E402
from repro_torch.core.classifier import ClassifierState  # noqa: E402
from repro_torch.core.engine import (SimParams, init_state,  # noqa: E402
                                     simulate_sweep)
from repro_torch.core.engine import wavefront as WF  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cache_pass import ops as CPASS  # noqa: E402
from repro_torch.kernels.wavefront_scan import ops as WSCAN  # noqa: E402
from repro_torch.kernels.wavefront_scan.ref import QueueCarry  # noqa: E402
from repro_torch.policy import ops as POL, to_arrays  # noqa: E402

#: copies of tests/test_golden_phased.py:56-70 (wavefront engine, seed 0,
#: default SimParams, the labeling ladder, rounded to 6 decimals)
GOLDEN_PHASED256_IPC = {"Baseline": 0.088937, "MeDiC-stale": 0.101804,
                        "MeDiC": 0.110233, "MeDiC-fast": 0.115973,
                        "MeDiC-oracle": 0.111055}
GOLDEN_RECOVER256_IPC = {"Baseline": 0.089472, "MeDiC-stale": 0.083859,
                         "MeDiC": 0.12743, "MeDiC-fast": 0.143104,
                         "MeDiC-oracle": 0.153922}

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 non-tensor
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNELS = {
    "wave_queue": dict(
        route="cuda", source="src/repro_torch/csrc/wave_queue.cu",
        replaces="src/repro/kernels/wavefront_scan/kernel.py:164"),
    "wave_cache": dict(
        route="cuda", source="src/repro_torch/csrc/wave_cache.cu",
        replaces="src/repro/kernels/cache_pass/kernel.py:113"),
}

DEV = torch.device("cuda")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 20) -> float:
    """Mean ms per call on the card: CUDA events around ``iters`` calls
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> float:
    """Largest |a - b| over matching tensors (bool/int as float64);
    identical infinities count as 0."""
    err = 0.0
    for x, y in zip(a, b):
        x, y = x.double(), y.double()
        same = (x == y)
        d = torch.where(same, torch.zeros_like(x), (x - y).abs())
        if d.numel():
            err = max(err, float(d.max()))
    return err


def flat(out) -> list:
    """A kernel output tuple as a flat list of tensors."""
    items = []
    for x in out:
        if torch.is_tensor(x):
            items.append(x)
        elif isinstance(x, dict):
            items.extend(x[k] for k in sorted(x))
        else:
            items.extend(flat(x))
    return items


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# phase 3: wave_queue against its plain version
# ---------------------------------------------------------------------------

QKW = dict(banks=6, channels=8, l2_svc=4.0, l2_lat=20.0, occ_rowhit=5.0,
           occ_rowmiss=10.0)


def wave_case(rng, n, dyadic=True, empty=False, warm=True):
    """A fuzzed wave on the card (tests/test_kernels.py:183-221's
    generator, at the paper's 6 banks and 8 channels)."""
    banks, channels = QKW["banks"], QKW["channels"]
    step = 0.25 if dyadic else 0.7
    t_s = (np.cumsum(rng.integers(0, 4, n)) * step).astype(np.float32)
    valid = np.zeros(n, bool) if empty else rng.random(n) < 0.9
    byp = (rng.random(n) < 0.2) & valid
    hit = (rng.random(n) < 0.4) & valid & ~byp
    slots = (t_s, rng.integers(0, banks, n).astype(np.int32), valid & ~byp,
             rng.integers(0, channels, n).astype(np.int32),
             rng.integers(0, 6, n).astype(np.int32), valid & (byp | ~hit),
             byp, rng.random(n) < 0.5)

    def q(k, lo, hi, neg=False):
        v = (rng.uniform(lo, hi, k) * (4 if dyadic else 1)).astype(np.float32)
        if neg:
            v += np.where(rng.random(k) < 0.3 if warm else np.ones(k, bool),
                          -np.inf, 0.0).astype(np.float32)
        return v
    carry = QueueCarry(
        bank_free=q(banks, 0, 30), bank_ts=q(banks, 0, 20, True),
        hp_free=q(channels, 0, 40), hp_ts=q(channels, 0, 20, True),
        hp_sa=q(channels, 0, 20, True), lp_free=q(channels, 0, 40),
        lp_ts=q(channels, 0, 20, True), lp_sa=q(channels, 0, 20, True),
        cur_row=rng.integers(-1, 6, channels).astype(np.int32))
    to = [torch.tensor(x, device=DEV) for x in slots]
    return to, QueueCarry(*(torch.tensor(x, device=DEV) for x in carry))


def phase_wave_queue() -> dict:
    cases = []
    rng = np.random.default_rng(0)
    for n in (1, 17, 256, 600, 8192, 16384):
        for dyadic in (True, False):
            for exact in (False, True):
                cases.append((f"n{n}/{'dy' if dyadic else 'nd'}/"
                              f"{'exact' if exact else 'floor'}",
                              wave_case(rng, n, dyadic), exact))
    cases.append(("cold", wave_case(rng, 600, False, warm=False), False))
    cases.append(("empty", wave_case(rng, 600, False, empty=True), False))
    for k in range(4):
        cases.append((f"single{k}", wave_case(rng, 1, False), k % 2 == 1))
    err = 0.0
    for name, (slots, carry), exact in cases:
        kern = WSCAN.wave_queue_cuda(*slots, carry, exact=exact, **QKW)
        torch.cuda.synchronize()
        plain = WSCAN._ref.wave_queue_recovery_ref(*slots, carry,
                                                   exact=exact, **QKW)
        e = max_abs_err(flat(kern), flat(plain))
        check(e == 0.0, f"wave_queue {name}: kernel != plain (err {e})")
        err = max(err, e)
    # timing at the main path's wave: HAMMER2K, 512 warps x 16 lanes
    slots, carry = wave_case(np.random.default_rng(1), 8192, False)
    ms = time_ms(lambda: WSCAN.wave_queue_cuda(*slots, carry, exact=False,
                                               **QKW))
    plain_ms = time_ms(lambda: WSCAN._ref.wave_queue_recovery_ref(
        *slots, carry, exact=False, **QKW), iters=5)
    out = WSCAN.wave_queue_cuda(*slots, carry, exact=False, **QKW)
    bytes_moved = nbytes(list(slots) + list(carry) + flat(out))
    # ~40 float operations per slot (8 scans + floors and selects)
    ops = 40 * 8192
    return dict(cases=len(cases), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                n=8192, bytes=bytes_moved, ops=ops)


# ---------------------------------------------------------------------------
# phase 4: wave_cache against its plain version
# ---------------------------------------------------------------------------

def cache_case(rng, n_warps, b, lanes, prm, pol, addr_hi=60, empty=False):
    """A fuzzed wave over a warmed state on the card (tests/test_kernels.py
    :357-396's generator): non-(-1) tags unique within a set."""
    sets, ways = prm.sets, prm.ways
    pool = np.argsort(rng.random((sets, 4 * ways + addr_hi)),
                      axis=1)[:, :ways]

    def t(x, dtype=torch.int32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=DEV)
    st = init_state(n_warps, prm, DEV)
    st = st._replace(
        tags=t(np.where(rng.random((sets, ways)) < 0.25, -1, pool)),
        rrip=t(rng.integers(0, prm.rrip_max + 1, (sets, ways))),
        meta_type=t(rng.integers(0, 3, (sets, ways))),
        eaf=t(rng.integers(0, 2, prm.eaf_bits)),
        eaf_ctr=t(rng.integers(0, prm.eaf_capacity)),
        pc_hits=t(rng.integers(0, 50, prm.pc_entries)),
        pc_acc=t(rng.integers(50, 100, prm.pc_entries)),
        pc_req=t(rng.integers(0, 100, prm.pc_entries)))
    st = st._replace(clf=st.clf._replace(
        accesses=t(rng.integers(0, 64, n_warps)),
        hits=t(rng.integers(0, 32, n_warps)),
        sampled=t(rng.integers(0, 64, n_warps))))
    pa = to_arrays(pol, DEV)
    w_sel = t(rng.choice(n_warps, b, replace=False), torch.int64)
    addr = rng.integers(-1, addr_hi, (lanes, b))
    if empty:
        addr[:] = -1
    args = (ClassifierState(*(a[w_sel] for a in st.clf)),
            POL.pcal_tokens(pa, n_warps)[w_sel],
            t(np.sort(rng.uniform(0, 50, b)), torch.float32), t(addr),
            t(rng.integers(0, 64, b)), t(rng.integers(0, 3, b)),
            t(np.zeros(b, bool) if empty else rng.random(b) < 0.9,
              torch.bool))
    return st, args, pa


CACHE_GRIDS = [(1, 8, 16, 40), (2, 8, 16, 40), (4, 12, 5, 30),
               (8, 160, 16, 60), (512, 200, 16, 4000), (512, 512, 16, 4000),
               (512, 1024, 16, 4000)]
CACHE_POLICIES = (BL.BASELINE, BL.MEDIC, BL.PCAL, BL.WBYP)


def phase_wave_cache() -> dict:
    rng = np.random.default_rng(2)
    runs = [(g, pol, False) for g in CACHE_GRIDS for pol in CACHE_POLICIES]
    runs.append(((8, 6, 8, 60), BL.MEDIC, True))
    err = 0.0
    for (sets, b, lanes, hi), pol, empty in runs:
        prm = SimParams(sets=sets)
        st, args, pa = cache_case(rng, 2 * b, b, lanes, prm, pol, hi, empty)
        kern = CPASS.wave_cache_cuda(st, *args, prm, pa)
        torch.cuda.synchronize()
        plain = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
        e = max_abs_err(flat(kern), flat(plain))
        check(e == 0.0, f"wave_cache sets={sets} B={b} {pol.name}"
                        f"{' empty' if empty else ''}: kernel != plain "
                        f"(err {e})")
        err = max(err, e)
    # timing at the main path's wave: HAMMER2K, B = 512, 16 lanes
    prm = SimParams()
    st, args, pa = cache_case(np.random.default_rng(3), 2048, 512, 16, prm,
                              BL.MEDIC, addr_hi=1 << 20)
    ms = time_ms(lambda: CPASS.wave_cache_cuda(st, *args, prm, pa))
    plain_ms = time_ms(lambda: CPASS._ref.wave_cache_pass_ref(
        st, *args, prm, pa), iters=3)
    out = CPASS.wave_cache_cuda(st, *args, prm, pa)
    state_in = [getattr(st, f) for f in CPASS._STATE_FIELDS]
    bytes_moved = nbytes(state_in + flat(args) + list(pa) + flat(out))
    # ~60 integer/select operations per request and way-loop
    ops = 60 * 512 * 16
    return dict(cases=len(runs), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                b=512, lanes=16, bytes=bytes_moved, ops=ops)


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------

FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")


def reset_counts() -> None:
    WSCAN.WAVE_QUEUE.launches = 0
    CPASS.WAVE_CACHE.launches = 0
    WF.WAVES.waves = 0


def counts() -> dict:
    return {"wave_queue": WSCAN.WAVE_QUEUE.launches,
            "wave_cache": CPASS.WAVE_CACHE.launches,
            "waves": WF.WAVES.waves}


def sweep(tr, policies, n_warps, **kw):
    return simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"],
                          policies, n_warps=n_warps,
                          lanes=tr["lines"].shape[-1], prm=SimParams(),
                          engine="wavefront",
                          oracle_types=tr["oracle_wtype"], device="cuda",
                          **kw)


def phase_golden() -> dict:
    report = {}
    for name, golden in (("PHASED256", GOLDEN_PHASED256_IPC),
                         ("PHASED_RECOVER256", GOLDEN_RECOVER256_IPC)):
        spec = {**TG.PHASED_SPECS, **TG.PHASED_RECOVER_SPECS}[name]
        tr = TG.generate(spec, 0)
        reset_counts()
        t0 = time.perf_counter()
        out = sweep(tr, BL.LABELING_LADDER, spec.n_warps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        check(c["waves"] > 0 and c["wave_queue"] == c["waves"]
              and c["wave_cache"] == c["waves"],
              f"{name}: launches {c} != one per wave")
        ipc = {p.name: float(v) for p, v in zip(BL.LABELING_LADDER,
                                                out["ipc"].cpu())}
        for pol, want in golden.items():
            check(abs(ipc[pol] - want) <= 1e-6,
                  f"{name} {pol}: ipc {ipc[pol]!r} vs golden {want}")
        ref = sweep(tr, BL.LABELING_LADDER, spec.n_warps,
                    scan_backend="ref", cache_backend="ref")
        for k in out:
            a, b = out[k].cpu(), ref[k].cpu()
            if k in FLOAT_REDUCTIONS:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                           msg=f"{name} {k}")
            else:
                check(torch.equal(a, b), f"{name} {k}: kernels != plain")
        report[name] = dict(ipc=ipc, launches=c, wall_s=wall)
    return report


def phase_scale() -> dict:
    """HAMMER2K × 4 policies (the counted main-path run), then HAMMER4K ×
    MeDiC."""
    report = {}
    for name, pols in (("HAMMER2K", (BL.BASELINE, BL.PCAL, BL.WBYP,
                                     BL.MEDIC)),
                       ("HAMMER4K", (BL.MEDIC,))):
        spec = TG.STRESS_SPECS[name]
        tr = TG.generate(spec, 0)
        requests = int((tr["lines"] >= 0).sum()) * len(pols)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = sweep(tr, pols, spec.n_warps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts()
        check(c["wave_queue"] == c["waves"] and c["wave_cache"] == c["waves"]
              and c["waves"] > 0, f"{name}: launches {c}")
        for k, v in out.items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{name} {k} finite")
        ipc = {p.name: float(v) for p, v in zip(pols, out["ipc"].cpu())}
        check(all(v > 0 for v in ipc.values()), f"{name} ipc {ipc}")
        report[name] = dict(ipc=ipc, launches=c, wall_s=wall,
                            requests=requests, requests_per_s=requests / wall,
                            wave_size=WF.default_wave_size(spec.n_warps))
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all(list(KERNELS))
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in built.items()})

    results = {}
    for phase, fn in (("wave_queue", phase_wave_queue),
                      ("wave_cache", phase_wave_cache),
                      ("golden", phase_golden), ("scale", phase_scale)):
        t0 = time.perf_counter()
        results[phase] = fn()
        emit(phase, seconds=time.perf_counter() - t0, **results[phase])
    wq, wc, scale = results["wave_queue"], results["wave_cache"], \
        results["scale"]
    main_path = scale["HAMMER2K"]["launches"]

    rows = []
    for kname, meas in (("wave_queue", wq), ("wave_cache", wc)):
        t_bytes = meas["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = meas["ops"] / F32_OPS_PER_S * 1e3
        rows.append(dict(
            name=kname, **KERNELS[kname], launches=main_path[kname],
            max_abs_err=meas["max_abs_err"], ms=meas["ms"],
            plain_ms=meas["plain_ms"], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None))
        check(main_path[kname] > 0, f"{kname} never launched on the main "
                                    "path")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
