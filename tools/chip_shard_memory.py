"""Device memory of the sharded-warp path's placement, on NVIDIA cards.

    python3 tools/chip_shard_memory.py

HAMMER16K's trace (seed 0: 64 instructions × 16,384 warps × 16 lanes,
int32, 67 MB on the host) is cut into 4 warp blocks as the wavefront
engine cuts it (``sharding.split_leading`` on the warp-major view). On
one card, each block is moved to ``cuda:0`` two ways: as the strided
view it is (``.to``) and made contiguous on the host first (what
``split_leading`` does); each move's peak device memory is printed
beside the block's bytes. With two or more cards, HAMMER16K × MeDiC runs
through ``simulate_sweep`` with its warps over 4 distinct cards (or as
many as there are, a power of two), and each card's allocated and peak
memory is printed after the shards are placed and after the run. One
JSON line, after the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core import tracegen as TG  # noqa: E402
from repro_torch.core.engine import SimParams, simulate_sweep  # noqa: E402
from repro_torch.core.engine import wavefront as WF  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import make_local_mesh  # noqa: E402

GB = 1e9


def _sync_reset(cards) -> None:
    for i in cards:
        torch.cuda.synchronize(i)
        torch.cuda.reset_peak_memory_stats(i)


def _read(cards) -> dict:
    for i in cards:
        torch.cuda.synchronize(i)
    return {f"cuda:{i}": dict(
        allocated_gb=torch.cuda.memory_allocated(i) / GB,
        peak_gb=torch.cuda.max_memory_allocated(i) / GB) for i in cards}


def one_card(lines) -> dict:
    """Each warp block moved to cuda:0 strided, then contiguous first."""
    x = torch.as_tensor(lines).transpose(0, 1)          # [W, I, L] view
    out = {}
    for how, move in (("strided", lambda b: b.to("cuda:0")),
                      ("contiguous_first",
                       lambda b: b.contiguous().to("cuda:0"))):
        peaks = []
        for blk in x.tensor_split(4):
            _sync_reset([0])
            y = move(blk)
            peaks.append(torch.cuda.max_memory_allocated(0) / GB)
            del y
        out[how] = dict(block_gb=blk.numel() * blk.element_size() / GB,
                        peak_gb=peaks)
    return out


def distinct_cards(spec, tr) -> dict:
    """HAMMER16K over distinct cards: memory after placement and after."""
    n = torch.cuda.device_count()
    k = 1 << (min(n, 4).bit_length() - 1)
    cards = list(range(k))
    seen = {}
    make = WF.make_shards

    def probe(*a):
        shards = make(*a)
        seen["after_placement"] = _read(cards)
        return shards
    WF.make_shards = probe
    try:
        _sync_reset(cards)
        simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"],
                       (BL.MEDIC,), n_warps=spec.n_warps,
                       lanes=tr["lines"].shape[-1], prm=SimParams(),
                       engine="wavefront", oracle_types=tr["oracle_wtype"],
                       mesh=make_local_mesh(1, k), warp_axes="model")
        seen["after_run"] = _read(cards)
    finally:
        WF.make_shards = make
    seen["shard_trace_gb"] = (spec.n_warps * spec.n_instr
                              * (spec.lines_per_instr + 2) * 4 / k / GB)
    return seen


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build_all(["wave_queue", "wave_cache"])
    spec = TG.SHARD_STRESS_SPECS["HAMMER16K"]
    tr = TG.generate(spec, 0)
    out = {"one_card": one_card(tr["lines"])}
    if torch.cuda.device_count() > 1:
        out["distinct_cards"] = distinct_cards(spec, tr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
