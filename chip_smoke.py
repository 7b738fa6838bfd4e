"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them. Phases, one JSON line each on stdout (with its seconds):

  1. device   — the card's name and power limit;
  2. build    — all nine CUDA kernels compiled from ``src/repro_torch/csrc``
     (one ``nvcc`` each, all at once);
  3. wave_queue — the timing-pass kernel against its plain PyTorch
     version on the card, bitwise, on fuzzed waves of 1 to 262,144 slots
     (one cluster pass and several); ms and device ms per call at N 8192
     (HAMMER2K's wave), 16,384 (HAMMER4K's) and 262,144 (WIDE64K's);
  4. wave_cache — the cache-pass kernel against its plain version,
     bitwise on state, classifier rows and the nine records, in both of
     its instances (state in shared memory or in global memory) on every
     case, sparse waves over many sets and the widest waves (B 8193 and
     16,384) included; ms and device ms per call of each instance at the
     path's wave and at B 16,384;
  5. golden   — PHASED256 and PHASED_RECOVER256 through
     ``simulate_sweep(engine="wavefront", device="cuda")`` with the
     five-policy labeling ladder: IPC within 1e-6 of the goldens, one
     launch of each kernel per wave, and the MeDiC rung rerun with the
     plain versions on the card (integer and per-element outputs bitwise,
     float reductions within rtol 1e-6);
  6. scale    — the wavefront main path: HAMMER2K × {Baseline, PCAL, WByp,
     MeDiC} (the paper's hierarchy, 2048 warps, waves of 512) with every
     launch count set to 0 just before and read just after, then
     HAMMER4K × MeDiC and WIDE64K × MeDiC (65,536 warps, waves of 16,384
     slots; its trace cut as ``WIDE_INSTR`` says), each with one launch of
     each kernel per wave;
  7. event    — the event engine's loop kernel against its eager plain
     loop on the card, bitwise on the whole final state, ready times,
     pointers, ratio snapshots and every public output: W {1, 2, 48, 64} ×
     I {1, 8} × L {1, 16} (without the combinations over 1024 request
     steps, ``EVENT_CUT``), the 11 fig7 policies plus the stale and oracle
     rungs with a per-instruction gap, in all four instances (state and
     rows each in shared or global memory); a seed stack, an EAF that
     resets every 8 evictions, and two hierarchies whose rows or state
     take global memory by the plan. ms and device ms on fig7's buckets
     (44 and 165 blocks at paper scale), the plain loop's ms on the quick
     bucket cut to 1 instruction, and the dependent-chain bound;
  8. fig7     — ``repro_torch.paper_figures.fig7_performance`` on the quick
     workloads through ``repro_torch.api`` on the card: the fig7 goldens
     within 1e-6, the paper's ordering, one event-loop launch per bucket
     (counted from 0); then ``registry.PAPER_FIG7`` (one bucket of 165
     simulations): its wall and harmonic-mean speedups;
  8b. tracegen — the CUDA sampler against the numpy sampler, bitwise on
     lines, pcs and oracle labels (``TRACEGEN_CASES``: a paper workload
     at two seeds, PHASED256, PHASE2K's legacy flip, HAMMER16K); ms,
     device ms and the input copy's ms at HAMMER16K's and BFS's shapes
     beside the numpy sampler's ms; ``registry.PAPER_FIG7`` through
     ``Experiment.run``: one launch a scenario, every cell on the card;
  9. wave1    — BP at paper scale × {Baseline, MeDiC}: the wavefront engine
     with waves of one warp equals the event engine within rtol = atol =
     1e-5;
 10. api      — ``registry.STRESS`` through ``repro_torch.api`` (wavefront,
     both kernels once a wave, counted from 0): requests/s per call and
     MeDiC's rank per scenario; then the PHASED256 / PHASED_RECOVER256
     goldens through ``Experiment.run``;
 10b. sharded — sharded sweeps through ``repro_torch.api`` (the reference's
     ``Experiment(mesh=, mesh_axes=)``), each bitwise against the same run
     without a mesh: a mesh of every card (one card: size 1, every axis
     resolves to None); the quick fig7 workloads × seeds 0, 1 × 4
     policies on a (2, 2) mesh of cuda:0 (one event-loop launch a policy
     and seed block); PHASED256 × Baseline, MeDiC on a (2, 4) mesh (policy
     blocks, warps in 4 shards); HAMMER16K × MeDiC (16,384 warps) with
     its warps in 4 shards, both wavefront kernels once a wave; each
     run's wall and peak memory; with several cards, HAMMER16K over
     distinct cards, where cuda:0 must peak below half the unsharded run
     and every other card below 1.25 × its shard of the trace (the trace
     is spread, not copied whole to the first card);
 11. medic_gather, decode_attention, flash_attention — each serving-path
     kernel against its plain version on the card at the path's shapes
     (the gather bitwise, one pool and several in one launch, both of its
     routes, holes and all-hole tables; the attention kernels within the
     reference's TOL, 4e-2 in bf16 and 3e-5 in float32, at D 128 and, for
     the hybrid, D 256 with G 10 and a window of 2048; decode also at
     lengths on its split edges, flash in bf16 at S off its tile, windows
     under a key tile and groups of 1 to 16; both at every serve run's
     shapes, flash also without a mask over keys of their own length, as
     Whisper's encoder and the cross-attention give it; those two long-row
     grids draw q and v at ``AMP`` so that their outputs are of order 1
     beside TOL's atol, and report each case's max |plain|), with ms per call
     (CUDA events around the wrapper), the kernels' own device time per
     call (torch.profiler),
     the decode kernel's split (n_split), the plain version's ms, one
     PyTorch library call's ms and device ms, bytes and flops;
 12. serving  — the serving main path: ``run_ab`` on Qwen3-1.7B at full
     width (28 layers, random weights from a seed) with every count set
     to 0 just before and read just after; both policies' integers equal
     the reference's pinned ones, and each kernel's launches equal what
     the run did (28 per prefill, 28 per decode step, 1 per offload, K and
     V together). Then
     MeDiC for a few steps with the kernels and with their plain versions
     (backend="ref") in float32 at full width: snapshots equal, committed
     K/V caches within 2e-2; and the same pair on a ring that is not a
     whole number of pool blocks (max_len 100, blocks of 16, read in pages
     of 4; 2 layers): snapshots equal, K/V within 2e-2, one gather launch
     per offload;
 12b. serving_sim — the open-loop serving simulator (host numpy, as in
     the reference): ``registry.PAPER_SERVING`` whole through
     ``repro_torch.api`` (4 scenarios × 4 policies, two buckets; run in a
     child process started after the build, beside phases 3–12, since it
     leaves the card idle for minutes) equal to
     the reference's goldens (integers exactly, floats within 1e-12),
     SERVE_POISSON2K at 2048 in flight with 4096 done in <= 1200 steps
     under every policy, MeDiC's p99 no worse than Baseline's on
     SERVE_BURSTY64, each bucket's wall and seconds a step; the two pool
     backends equal on the cut SERVE_BURSTY64 under the 4 policies; and
     the simulator on the serving A/B's request lists equal to the
     full-width engines of phase 12 (every pool counter, the pinned
     aggregates, every request's stamps; a request the engine never
     admitted keeps enqueue_step 0 there, -1 in the simulator);
 13. serving_profile — where the time goes: a full-width decode step
     (host wall, device time per kernel from torch.profiler, kernels per
     step) and a 500-step MeDiC run split by engine method;
 14. rg_lru, mlstm — the hybrid and ssm paths' kernels against their
     plain versions on fuzz grids and at the paths' shapes (rg_lru
     bitwise, in both copy instances, with its plan and its share of the
     byte bound; mlstm within 5e-4 / 5e-3, the reference's own, on the
     outputs and the final state, at S 1, 63, 64, 65 and 1024, Dk 192 and
     256, bf16 and float32), with ms, device ms and queued ms per call
     (mlstm also by kernel, and against the CPU-tested model of its
     product precision) and the plain version's ms (no single PyTorch call
     computes either);
 15. hybrid_serve, ssm_serve — the hybrid and ssm main paths at full
     width: ``build_model(cfg).init_params`` (random weights from seed 0)
     -> ``prefill`` -> 32 greedy ``decode`` steps, RecurrentGemma-2B on 2
     prompts of 3072 tokens (ring of 2048 = the local window) and
     xLSTM-125M on 4 prompts of 1024, bf16 through the kernels with every
     count set to 0 just before and read just after; then both reruns in
     float32, teacher-forced with the bf16 run's tokens, through the
     kernels and through their plain versions: logits within the
     family's SERVE_F32_TOL, greedy tokens equal wherever the top-two gap
     is wider;
 15b. dense_serve, moe_serve — the same for the other dense configs and
     the MoE family, random weights from seed 0, each run's depth cut
     recorded: H2O-Danube-1.8B whole (2 prompts of 4608 into its window
     of 4096, the ring; 32 steps), Granite-3-8B whole (2 x 512, 16
     steps) and Qwen1.5-110B at full width with 4 of its 80 layers (2 x
     512, 16 steps); OLMoE-1B-7B whole (2 x 1024, 32 steps) and
     Grok-1-314B at full width with 2 of its 64 layers (2 x 512, 16
     steps). Flash launches = layers and decode launches = layers x steps
     in every run. The MoE runs also compare the two float32 runs'
     routing (root flips, each with a probability gap under FLIP_GAP, and
     the flips downstream of them) and measure the floor of a plain run
     whose router logits are float64;
 15c. encdec_serve, vlm_serve — the same for the cross-attention
     families, random weights from seed 0 with the VLM's gates and the
     ungated MLP's biases drawn non-zero (``liven``) and the stubbed
     frontends' embeddings from a seed (``memory_inputs``): Whisper-tiny
     whole (4 x 224, frames [4, 1500, 384], a ring of 256, 32 steps;
     flash 12 = 4 encoder + 4 self + 4 cross, decode 256 = 8 x 32) and
     Llama-3.2-Vision-11B whole (2 x 512, image tokens [2, 6400, 4096],
     a ring of 528, 16 steps; flash 40, decode 640); the float32 reruns
     also hold ``enc_out`` and the cross caches within the tolerance and
     ``len`` / ``kv_pos`` equal;
 15d. train  — the training path (no kernel: the Hopper kernels have no
     backward, so training runs the plain versions under autograd, and
     every launch count must stay 0), one line a part: a. Qwen3-1.7B
     whole (28 x 2048, vocab 151,936, tied) in bf16 with remat and 2
     microbatches, seed-0 weights, ``SyntheticLM`` batches of 8 x 256,
     4 AdamW steps: finite losses and grad norms, ms a step (CUDA events,
     steps 2-4), tokens/s, peak memory and 6·N·tokens over the step as a
     share of the bf16 peak; b. full width at 2 layers in float32, batch
     2 x 128: the same first ``make_train_step`` on the card and on the
     CPU from the same weights, loss / ce / zloss within rtol 1e-5, the
     grad norm within 1e-4 and every gradient leaf (read from the first
     moment) within 1e-4 of its max |g|; c. every arch ``reduced()`` in
     float32 (gates and biases drawn non-zero, Whisper's frames and the
     VLM's image embeddings from a seed), the same; d.
     ``examples/torch_train_100m.py``'s loop: 300 steps of the ~100M
     config, 2 microbatches, a checkpoint every 50, a failure at step
     100: exactly one restart and the last 20 steps' mean loss at least
     0.5 under the first 20's, with the wall, the seconds a step and the
     straggler events; e. the tiny config (Qwen3 at 2 layers, 4 x 32), 12
     steps with a checkpoint every 4: a failure at step 6 ends at the
     uninterrupted run's loss within rel 1e-6 (deterministic algorithms
     on for this part only; ``CUBLAS_WORKSPACE_CONFIG`` is set before
     CUDA starts);
 15e. dryrun — the dry run (``repro_torch.launch.dryrun``): a. production
     cells on the meta meshes of 256 and 512 entries, in a child process
     started after the build (host only): every arch's decode_32k and
     long_500k on both meshes, Whisper-tiny's train_4k and Qwen3-1.7B's
     prefill_32k; the skips equal ``shape_applicable``'s, every other
     cell is ok, with its per-device GB, ``fits_80gb``, dominant term and
     roofline fraction; b. two cells of Qwen3-1.7B at full width on a
     (1, 1) mesh, each reported on meta and run on the card: train at 4 x
     256, one microbatch, bf16 (no kernel): the dot FLOPs counted on the
     card (``hlo_analysis.OpCounter``) equal the report's, the argument
     bytes on the card equal the report's, the card's peak over the step
     (``max_memory_allocated``, the bytes resident besides the step's
     arguments taken off) within ``DRYRUN_MEM_BAND`` of the report's
     argument + temp bytes, and the step's time (CUDA events) no less
     than the roofline's max(compute, memory); decode in float32 at 32,768
     positions with the batch cut to 4 over ``init_cache(filled=True)``
     (its K/V drawn from a seed) through the paged decode kernel, 28
     launches (as many as the report counted on meta), its logits against
     the plain version at the dense serve tolerance, and the bytes of its
     inputs on the card equal to the report's argument bytes;
 16. kernels  — one JSON object per kernel: launches on its paths, max
     error against the plain version, ms and device ms, the bound and the
     library call's ms and device ms; every Pallas kernel of the
     reference has its row, and so has the port-side event loop (with its
     dependent-chain bound).

Then the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Any failed check raises.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

# cuBLAS reads this when CUDA starts; the train phase's restart check runs
# with deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import paper_figures as PF  # noqa: E402
from repro_torch.api import registry as REG  # noqa: E402
from repro_torch.checkpoint.checkpointing import (  # noqa: E402
    CheckpointManager)
from repro_torch.configs.base import (ARCH_IDS, SHAPES,  # noqa: E402
                                      OptimizerConfig, ShapeConfig,
                                      get_config, shape_applicable)
from repro_torch.core import baselines as BL  # noqa: E402
from repro_torch.core import tracegen as TG  # noqa: E402
from repro_torch.core import workloads as WL  # noqa: E402
from repro_torch.core.classifier import ClassifierState  # noqa: E402
from repro_torch.core.engine import (SimParams, init_state,  # noqa: E402
                                     simulate_sweep)
from repro_torch.core.engine import event as EV  # noqa: E402
from repro_torch.core.engine import wavefront as WF  # noqa: E402
from repro_torch.core.tracegen.sampler import _sample_cells  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cache_pass import ops as CPASS  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DEC  # noqa: E402
from repro_torch.kernels.event_loop import ops as EVL  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FLASH  # noqa: E402
from repro_torch.kernels.medic_gather import ops as GATHER  # noqa: E402
from repro_torch.kernels.mlstm import ops as MLSTM  # noqa: E402
from repro_torch.kernels.rg_lru import ops as RGLRU  # noqa: E402
from repro_torch.kernels.tracegen import ops as KTG  # noqa: E402
from repro_torch.kernels.wavefront_scan import ops as WSCAN  # noqa: E402
from repro_torch.kernels.wavefront_scan.ref import QueueCarry  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import make_local_mesh  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.optimizer import (init_opt_state,  # noqa: E402
                                         make_train_step)
from repro_torch.policy import (ops as POL, stack_policies,  # noqa: E402
                                to_arrays)
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FailureInjector, run_fault_tolerant)
from repro_torch.serving import engine as ENG  # noqa: E402
from repro_torch.serving import sim as SIM  # noqa: E402
from repro_torch.serving.pool import POOL_POLICIES, PoolConfig  # noqa: E402
from repro_torch.serving.request import (ServeWorkload,  # noqa: E402
                                         generate_requests)

#: copies of tests/test_golden_phased.py:56-70 (wavefront engine, seed 0,
#: default SimParams, the labeling ladder, rounded to 6 decimals)
GOLDEN_PHASED256_IPC = {"Baseline": 0.088937, "MeDiC-stale": 0.101804,
                        "MeDiC": 0.110233, "MeDiC-fast": 0.115973,
                        "MeDiC-oracle": 0.111055}
GOLDEN_RECOVER256_IPC = {"Baseline": 0.089472, "MeDiC-stale": 0.083859,
                         "MeDiC": 0.12743, "MeDiC-fast": 0.143104,
                         "MeDiC-oracle": 0.153922}

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 non-tensor,
#: TF32 and bf16 dense tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12

#: the reference's examples/serve_medic.py A/B as the JAX package gives it
#: (pinned in tests/test_torch_serving_engine.py and checked against the
#: JAX package by tests/test_torch_serving_ab.py); width-independent
PINNED_AB = {
    "lru": dict(steps=2000, completed=8, tokens_out=627, stall_steps=7367,
                fetches=1940, bypassed_blocks=0),
    "medic": dict(steps=2000, completed=23, tokens_out=1438,
                  stall_steps=4050, fetches=1719, bypassed_blocks=1037),
}
SERVE_WL = ServeWorkload(n_requests=24, chat_frac=0.6)
SERVE_POOL = PoolConfig(budget_blocks=48, block_tokens=16)
SERVE_ECFG = ENG.EngineConfig(max_slots=4, max_len=448)

KERNELS = {
    "wave_queue": dict(
        route="cuda", source="src/repro_torch/csrc/wave_queue.cu",
        replaces="src/repro/kernels/wavefront_scan/kernel.py:164"),
    "wave_cache": dict(
        route="cuda", source="src/repro_torch/csrc/wave_cache.cu",
        replaces="src/repro/kernels/cache_pass/kernel.py:113"),
    "medic_gather": dict(
        route="cuda", source="src/repro_torch/csrc/medic_gather.cu",
        replaces="src/repro/kernels/medic_gather/kernel.py:33"),
    "paged_decode_attention": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/kernel.py:75"),
    "flash_attention": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:88"),
    "rg_lru": dict(
        route="cuda", source="src/repro_torch/csrc/rg_lru.cu",
        replaces="src/repro/kernels/rg_lru/kernel.py:41"),
    "mlstm": dict(
        route="cuda", source="src/repro_torch/csrc/mlstm.cu",
        replaces="src/repro/kernels/mlstm/kernel.py:79"),
}
#: kernels of the port with no Pallas counterpart: the reference runs the
#: event engine's loop as a lax.scan
PORT_KERNELS = {
    "event_loop": dict(
        route="cuda", source="src/repro_torch/csrc/event_loop.cu",
        replaces="src/repro/core/engine/event.py:146", pallas=None),
    "tracegen": dict(
        route="cuda", source="src/repro_torch/csrc/tracegen.cu",
        replaces="src/repro/core/tracegen/sampler.py:33", pallas=None),
}
#: the C source of each kernel (its Kernel object's name)
SOURCES = {"wave_queue": "wave_queue", "wave_cache": "wave_cache",
           "medic_gather": "medic_gather",
           "paged_decode_attention": "decode_attention",
           "flash_attention": "flash_attention", "rg_lru": "rg_lru",
           "mlstm": "mlstm", "event_loop": "event_loop",
           "tracegen": "tracegen"}
#: Pallas kernels of the reference that the port has not ported yet
TO_PORT: list = []
#: each kernel's wrapper object, whose ``launches`` counts its launches
LAUNCHERS = {"wave_queue": WSCAN.WAVE_QUEUE, "wave_cache": CPASS.WAVE_CACHE,
             "medic_gather": GATHER.MEDIC_GATHER,
             "paged_decode_attention": DEC.DECODE_ATTENTION,
             "flash_attention": FLASH.FLASH_ATTENTION,
             "rg_lru": RGLRU.RG_LRU, "mlstm": MLSTM.MLSTM,
             "event_loop": EVL.EVENT_LOOP, "tracegen": KTG.TRACEGEN}


def reset_launches(names=None) -> None:
    """Set the launch counts of ``names`` (every kernel by default) to 0."""
    for n in names or LAUNCHERS:
        LAUNCHERS[n].launches = 0


def launches_of(names=None) -> dict:
    """The launch counts of ``names`` (every kernel by default)."""
    return {n: LAUNCHERS[n].launches for n in names or LAUNCHERS}

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


def turns_ms(fns, rounds: int = 7, iters: int = 100) -> list:
    """``time_ms`` of each of ``fns`` in turns, ``rounds`` times over, so
    that host-bound calls share the host's moments: per function, its
    median and the rounds (ms per call)."""
    got = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(got, fns):
            t.append(time_ms(fn, iters=iters))
    return [(float(np.median(t)), t) for t in got]


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


#: fuzzed wave sizes: tiny, one warp of slots, one block, blocks of the
#: cluster with a ragged last one, HAMMER2K's 8192 and HAMMER4K's 16,384
#: slots, one pass and two (65,536 slots a pass), and WIDE64K's 262,144
#: (four passes)
WQ_SIZES = (1, 17, 256, 600, 1025, 8192, 16384, 40000, 65537, 262144)


def _wave_queue_timing(n: int) -> dict:
    """ms (CUDA events around the wrapper) and device ms of one wave of
    ``n`` slots, the bytes it moves and the plan it runs."""
    slots, carry = wave_case(np.random.default_rng(1), n, False)
    run = lambda: WSCAN.wave_queue_cuda(*slots, carry,  # noqa: E731
                                        exact=False, **QKW)
    out = run()
    plan = WSCAN.plan_wave_queue(n)
    return dict(ms=time_ms(run), device_ms=device_ms(run),
                bytes=nbytes(list(slots) + list(carry) + flat(out)),
                plan=plan._asdict())


def phase_wave_queue() -> dict:
    cases = []
    rng = np.random.default_rng(0)
    for n in WQ_SIZES:
        for dyadic in (True, False):
            for exact in (False, True):
                cases.append((f"n{n}/{'dy' if dyadic else 'nd'}/"
                              f"{'exact' if exact else 'floor'}",
                              wave_case(rng, n, dyadic), exact))
    cases.append(("cold", wave_case(rng, 600, False, warm=False), False))
    cases.append(("empty", wave_case(rng, 600, False, empty=True), False))
    cases.append(("cold-wide", wave_case(rng, 40000, False, warm=False),
                  False))
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
    # timing at the main path's wave (HAMMER2K, 512 warps x 16 lanes), at
    # HAMMER4K's and at WIDE64K's
    main = _wave_queue_timing(8192)
    slots, carry = wave_case(np.random.default_rng(1), 8192, False)
    plain_ms = time_ms(lambda: WSCAN._ref.wave_queue_recovery_ref(
        *slots, carry, exact=False, **QKW), iters=5)
    # ~40 float operations per slot (8 scans + floors and selects)
    return dict(cases=len(cases), max_abs_err=err, ms=main["ms"],
                device_ms=main["device_ms"], plain_ms=plain_ms, n=8192,
                plan=main["plan"], bytes=main["bytes"], ops=40 * 8192,
                n16384=_wave_queue_timing(16384),
                n262144=_wave_queue_timing(262144))


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
#: (sets, B, lanes, addr_hi, ways) beyond the grid: sparse waves, few
#: requests over many sets, where every set the wave does not touch must
#: still reach the outputs (1024 sets keep the state in shared memory,
#: 131 KB; 8192 do not fit and take the global-state instance by the
#: plan); the widest waves, 3, 8 and 16 slots a thread (B 16,384 is
#: WIDE64K's wave); way counts other than the paper's 8, in rows of
#: 16-byte words (4, 12) and not (6)
CACHE_EXTRA = [(1024, 4, 3, 4000, 8), (8192, 8, 2, 4000, 8),
               (1024, 3000, 4, 4000, 8), (512, 8192, 3, 4000, 8),
               (512, 8193, 2, 4000, 8), (512, 16384, 3, 4000, 8),
               (16, 40, 8, 60, 6), (8, 64, 8, 60, 12), (32, 100, 6, 80, 4)]


def _wave_cache_both(st, args, prm, pa, what) -> float:
    """The planned instance and the global-state one against the plain
    version, bitwise; returns the error (0)."""
    plain = CPASS._ref.wave_cache_pass_ref(st, *args, prm, pa)
    err = 0.0
    for resident in (None, False):
        kern = CPASS.wave_cache_cuda(st, *args, prm, pa, resident=resident)
        torch.cuda.synchronize()
        e = max_abs_err(flat(kern), flat(plain))
        inst = "planned" if resident is None else "global"
        check(e == 0.0, f"wave_cache {what} ({inst}): kernel != plain "
                        f"(err {e})")
        err = max(err, e)
    return err


def phase_wave_cache() -> dict:
    rng = np.random.default_rng(2)
    runs = [(g + (8,), pol, False) for g in CACHE_GRIDS
            for pol in CACHE_POLICIES]
    runs.append(((8, 6, 8, 60, 8), BL.MEDIC, True))
    runs += [(g, BL.MEDIC, False) for g in CACHE_EXTRA]
    err = 0.0
    resident = 0
    for (sets, b, lanes, hi, ways), pol, empty in runs:
        prm = SimParams(sets=sets, ways=ways)
        resident += CPASS.plan_wave_cache(prm, b).resident
        st, args, pa = cache_case(rng, 2 * b, b, lanes, prm, pol, hi, empty)
        err = max(err, _wave_cache_both(
            st, args, prm, pa, f"sets={sets} ways={ways} B={b} L={lanes} "
                               f"{pol.name}{' empty' if empty else ''}"))
    # timing at the main path's wave: HAMMER2K, B = 512, 16 lanes
    prm = SimParams()
    plan = CPASS.plan_wave_cache(prm, 512)
    st, args, pa = cache_case(np.random.default_rng(3), 2048, 512, 16, prm,
                              BL.MEDIC, addr_hi=1 << 20)
    run = lambda: CPASS.wave_cache_cuda(st, *args, prm, pa)  # noqa: E731
    glob = lambda: CPASS.wave_cache_cuda(st, *args, prm, pa,  # noqa: E731
                                         resident=False)
    ms, dev_ms = time_ms(run), device_ms(run)
    plain_ms = time_ms(lambda: CPASS._ref.wave_cache_pass_ref(
        st, *args, prm, pa), iters=3)
    out = run()
    state_in = [getattr(st, f) for f in CPASS._STATE_FIELDS]
    bytes_moved = nbytes(state_in + flat(args) + list(pa) + flat(out))
    # ~60 integer/select operations per request and way-loop
    ops = 60 * 512 * 16
    # and at WIDE64K's wave: B = 16,384, 16 lanes
    st, args, pa = cache_case(np.random.default_rng(4), 32768, 16384, 16,
                              prm, BL.MEDIC, addr_hi=1 << 20)
    wide = lambda: CPASS.wave_cache_cuda(st, *args, prm, pa)  # noqa: E731
    wide_g = lambda: CPASS.wave_cache_cuda(st, *args, prm, pa,  # noqa: E731
                                           resident=False)
    b16384 = dict(ms=time_ms(wide, iters=5),
                  device_ms=device_ms(wide, iters=5),
                  global_ms=time_ms(wide_g, iters=5),
                  global_device_ms=device_ms(wide_g, iters=5),
                  plan=CPASS.plan_wave_cache(prm, 16384)._asdict())
    return dict(cases=2 * len(runs), resident_cases=resident,
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                resident=plan.resident, smem_bytes=plan.smem_bytes,
                global_ms=time_ms(glob), global_device_ms=device_ms(glob),
                b=512, lanes=16, bytes=bytes_moved, ops=ops, b16384=b16384)


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------

FLOAT_REDUCTIONS = ("ipc", "ipc_makespan", "qdelay_sum", "stall_cycles",
                    "energy", "perf_per_energy", "mean_qdelay", "miss_rate")


ENGINE_KERNELS = ("wave_queue", "wave_cache")


def reset_counts() -> None:
    reset_launches(ENGINE_KERNELS)
    WF.WAVES.waves = 0


def counts() -> dict:
    return dict(launches_of(ENGINE_KERNELS), waves=WF.WAVES.waves)


def sweep(tr, policies, n_warps, **kw):
    return simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"],
                          policies, n_warps=n_warps,
                          lanes=tr["lines"].shape[-1], prm=SimParams(),
                          engine="wavefront",
                          oracle_types=tr["oracle_wtype"], device="cuda",
                          **kw)


#: the labeling rung whose run is repeated with the kernels' plain versions
#: (the reruns of all five rungs took 200 of the script's 260 s)
PLAIN_RUNG = BL.MEDIC


def phase_golden() -> dict:
    report = {}
    rung = BL.LABELING_LADDER.index(PLAIN_RUNG)
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
        ref = sweep(tr, (PLAIN_RUNG,), spec.n_warps, scan_backend="ref",
                    cache_backend="ref")
        for k in out:
            a, b = out[k][rung].cpu(), ref[k][0].cpu()
            if k in FLOAT_REDUCTIONS:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0,
                                           msg=f"{name} {k}")
            else:
                check(torch.equal(a, b), f"{name} {k}: kernels != plain")
        report[name] = dict(ipc=ipc, launches=c, wall_s=wall,
                            plain_rung=PLAIN_RUNG.name)
    return report


#: WIDE64K (65,536 warps, the default wave of 16,384 slots): the spec
#: lowers to an address space past int32 at 65,536 warps (tracegen's
#: make_layout raises, the reference's too, at any instruction count), so
#: the run's trace is the spec lowered at 32,768 warps for seeds 0 and 1,
#: side by side on the warp axis (each half's lines are private to its
#: warps; the halves share one address space); instructions cut from 64
#: to WIDE_INSTR to keep the script's time
WIDE_INSTR = 8


def wide64k_trace():
    spec = dataclasses.replace(TG.SHARD_STRESS_SPECS["WIDE64K"],
                               n_warps=32768, n_instr=WIDE_INSTR)
    halves = [TG.generate(spec, seed) for seed in (0, 1)]
    tr = {k: np.concatenate([h[k] for h in halves], axis=1)
          for k in ("lines", "pcs", "oracle_wtype")}
    tr["compute_gap"] = halves[0]["compute_gap"]
    return tr


def phase_scale() -> dict:
    """HAMMER2K × 4 policies (the counted main-path run), then HAMMER4K ×
    MeDiC and WIDE64K × MeDiC (the widest wave: 16,384 slots)."""
    report = {}
    runs = (("HAMMER2K", (BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC)),
            ("HAMMER4K", (BL.MEDIC,)), ("WIDE64K", (BL.MEDIC,)))
    for name, pols in runs:
        if name == "WIDE64K":
            tr, n_warps = wide64k_trace(), 65536
            cut = dict(n_instr=[64, WIDE_INSTR],
                       trace="two 32768-warp halves (seeds 0, 1) of the "
                             "spec: at 65536 warps it overflows int32")
        else:
            spec = TG.STRESS_SPECS[name]
            tr, n_warps, cut = TG.generate(spec, 0), spec.n_warps, None
        requests = int((tr["lines"] >= 0).sum()) * len(pols)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = sweep(tr, pols, n_warps)
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
                            wave_size=WF.default_wave_size(n_warps))
        if cut:
            report[name]["cut"] = cut
    return report


# ---------------------------------------------------------------------------
# phases 7-10: the event engine's kernel, the fig7 goldens, wave_size=1 and
# the declarative API
# ---------------------------------------------------------------------------

#: copies of tests/test_golden_fig7.py:30-46 (event engine, seed 0, default
#: SimParams, QUICK_WORKLOADS, rounded to 4 decimals)
GOLDEN_FIG7_DERIVED = {
    "hmean_speedup[Baseline]": 1.0, "hmean_speedup[EAF]": 1.015,
    "hmean_speedup[PCAL]": 1.0655, "hmean_speedup[PC-Byp]": 1.0957,
    "hmean_speedup[WIP]": 1.0195, "hmean_speedup[WMS]": 1.0123,
    "hmean_speedup[WByp]": 1.3149, "hmean_speedup[MeDiC]": 1.3943,
    "hmean_speedup[Rand(ideal)]": 1.0234, "medic_vs_best_prior": 1.2725}
GOLDEN_FIG7_BFS = {
    "Baseline": 1.0, "EAF": 1.0129, "PCAL": 1.2845, "PC-Byp": 1.2578,
    "WIP": 1.0194, "WMS": 1.0108, "WByp": 1.5176, "MeDiC": 1.4974}

#: the event phase's policies: the fig7 sweep plus the stale and oracle
#: labeling rungs
EVENT_POLICIES = tuple(REG.FIG7_SWEEP_POLICIES) + (BL.MEDIC_STALE,
                                                   BL.MEDIC_ORACLE)
#: (W, I, L) cases of the event phase: every warp count, instruction count
#: and lane count of the grid W {1, 2, 48, 64} x I {1, 8} x L {1, 16}; the
#: two combinations over 1024 request steps (48 x 8 x 16, 64 x 8 x 16) are
#: cut, since the plain loop on the card costs ~5 ms a request step
EVENT_GRID = [(w, i, l) for w in (1, 2, 48, 64) for i in (1, 8)
              for l in (1, 16) if w * i * l <= 1024]
EVENT_CUT = [(w, i, l) for w in (1, 2, 48, 64) for i in (1, 8)
             for l in (1, 16) if w * i * l > 1024]
#: hierarchies past the paper's whose state or rows do not fit in shared
#: memory: 4096 x 4 sets with 7680 EAF bits leaves no room for 64 warps'
#: rows; with 8192 EAF bits the state itself does not fit
BIG_ROWS = SimParams(sets=4096, ways=4, eaf_bits=7680)
BIG_STATE = SimParams(sets=4096, ways=4, eaf_bits=8192)
#: shared-memory latency of the card in cycles (the order that
#: microbenchmarks of Hopper's shared memory report): the unit of the
#: event loop's dependent-chain bound
SMEM_LATENCY_CYCLES = 30
#: dependent shared-memory accesses a request step cannot avoid: the set's
#: row is read, then written, and the next request's read of it must
#: follow that write (the bank queue's read-modify-write runs beside it)
CHAIN_ACCESSES = 2
#: integer and float operations of one request step, counted from the
#: kernel's code (hashes, decisions, queue and DRAM timing, observe,
#: counters): ~100
EVENT_OPS_PER_REQUEST = 100


def event_case(w, i, l, seeds=(0,), spec_name="BFS", gap_per_instr=True):
    """A trace of ``w`` warps, ``i`` instructions and ``l`` lanes from a
    paper workload's mix, as numpy (seed-stacked when several seeds), with
    a per-instruction gap when ``gap_per_instr``."""
    spec = dataclasses.replace(
        TG.TraceSpec.from_workload(WL.WORKLOADS[spec_name]), n_warps=w,
        n_instr=i, lines_per_instr=l)
    tr = {k: v[0] for k, v in TG.generate_batch([spec], seeds).items()}
    if gap_per_instr:   # f32[S, I]: a schedule of intensities
        tr["compute_gap"] = (tr["compute_gap"][:, None] * np.linspace(
            0.5, 1.5, i, dtype=np.float32)[None, :]).astype(np.float32)
    return tr


def event_bucket(tr, policies, n_warps):
    """The event loop's inputs (``event.Bucket``) on the card."""
    as_t = lambda x, dt: torch.as_tensor(np.asarray(x)).to(DEV, dt)  # noqa
    return EV.bucket(as_t(tr["lines"], torch.int32),
                     as_t(tr["pcs"], torch.int32),
                     as_t(tr["compute_gap"], torch.float32),
                     as_t(tr["oracle_wtype"], torch.int32),
                     stack_policies(policies, DEV), n_warps)


def _event_both(tr, policies, w, l, prm, what, instances) -> int:
    """The kernel in each of ``instances`` ((state, rows) overrides, None
    for the plan's) against the plain loop on the card, bitwise on the
    whole final state, ready times, pointers and ratio snapshots; then the
    public outputs of ``simulate_core`` on the card against the plain
    loop's, finalized. Returns the plain loop's request steps."""
    b = event_bucket(tr, policies, w)
    plain = EV.event_loop(b, n_warps=w, lanes=l, prm=prm)
    for state, rows in instances:
        kern = EVL.event_loop_cuda(b, n_warps=w, lanes=l, prm=prm,
                                   state=state, rows=rows)
        torch.cuda.synchronize()
        e = max_abs_err(flat(kern), flat(plain))
        inst = EVL.plan_event_loop(prm, w, state, rows)
        check(e == 0.0 and all(torch.equal(x, y) for x, y in
                               zip(flat(kern), flat(plain))),
              f"event_loop {what} {inst}: kernel != plain (err {e})")
    gap = torch.as_tensor(tr["compute_gap"]).to(DEV)
    ko = EV.simulate_core(b.lines, b.pcs, gap, b.oracle,
                          stack_policies(policies, DEV), n_warps=w, lanes=l,
                          prm=prm, backend="cuda")
    st, ready, _, ratio_t = plain
    po = EV.finalize_bucket(st, ready, ratio_t, gap, n_instr=b.lines.shape[1],
                            n_warps=w, prm=prm)
    for k in po:
        check(torch.equal(ko[k], po[k]), f"event {what} {k}: kernel != plain")
    return b.lines.shape[1] * w * l


def _event_timing(workloads, n_instr=None) -> dict:
    """The kernel's ms and device ms on one bucket of the fig7 sweep
    (``workloads`` × FIG7_SWEEP_POLICIES, seed 0, paper scale), with the
    bytes it moves and its dependent-chain bound."""
    parts = [TG.generate(TG.TraceSpec.from_workload(WL.WORKLOADS[n]), 0)
             for n in workloads]
    tr = {k: np.stack([p[k] for p in parts])
          for k in ("lines", "pcs", "compute_gap", "oracle_wtype")}
    if n_instr:
        for k in ("lines", "pcs", "oracle_wtype"):
            tr[k] = tr[k][:, :n_instr]
    s, i, w, l = tr["lines"].shape
    b = event_bucket(tr, REG.FIG7_SWEEP_POLICIES, w)
    prm = SimParams()
    run = lambda: EVL.event_loop_cuda(b, n_warps=w, lanes=l,  # noqa: E731
                                      prm=prm)
    out = run()
    n = b.seed_of.shape[0]
    steps = i * w * l
    return dict(blocks=n, steps_per_block=steps, ms=time_ms(run, iters=5),
                device_ms=device_ms(run, iters=5),
                bytes=nbytes([b.lines, b.pcs, b.gap, b.oracle, b.tokens,
                              *b.pa] + flat(out)),
                ops=EVENT_OPS_PER_REQUEST * steps * n,
                plan=EVL.plan_event_loop(prm, w)._asdict(), bucket=b,
                shape=(i, w, l))


def sm_clock_hz() -> float:
    """The card's highest SM clock, from ``nvidia-smi``."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def chain_bound_ms(steps_per_block: int) -> float:
    """The event loop's dependent-chain bound: every block runs its
    request steps one after another and all blocks of a bucket run at once
    (at most three of 67 KB share an SM, 396 slots on 132 SMs), so the
    least time is one block's chain of CHAIN_ACCESSES shared-memory
    latencies a request step."""
    return (CHAIN_ACCESSES * SMEM_LATENCY_CYCLES * steps_per_block
            / sm_clock_hz() * 1e3)


def phase_event() -> dict:
    """The event-loop kernel against the eager plain loop on the card,
    bitwise; its time on the fig7 buckets."""
    steps, cases = 0, 0
    prm = SimParams()
    both = [(None, None), (False, False), (True, False), (False, True)]
    for w, i, l in EVENT_GRID:
        tr = event_case(w, i, l)
        steps += _event_both(tr, EVENT_POLICIES, w, l, prm,
                             f"W{w} I{i} L{l}", both)
        cases += 1
    # a seed stack (scalar gap per seed), an EAF that resets every 8
    # evictions, and the two hierarchies whose rows / state live in global
    # memory by the plan
    extra = [("seeds", event_case(48, 1, 16, seeds=(0, 1, 2),
                                  gap_per_instr=False),
              (BL.BASELINE, BL.MEDIC, BL.PCAL, BL.EAF), 48, 16, prm),
             ("eaf8", event_case(16, 2, 16, spec_name="CONS"),
              (BL.BASELINE, BL.EAF, BL.MEDIC), 16, 16,
              SimParams(eaf_capacity=8)),
             ("big_rows", event_case(64, 1, 8), (BL.BASELINE, BL.MEDIC),
              64, 8, BIG_ROWS),
             ("big_state", event_case(32, 1, 8), (BL.BASELINE, BL.MEDIC),
              32, 8, BIG_STATE)]
    for what, tr, pols, w, l, p in extra:
        inst = [(None, None)] if p.sets > 512 else both
        steps += _event_both(tr, pols, w, l, p, what, inst)
        cases += 1
    plans = {k: EVL.plan_event_loop(p, w)._asdict()
             for k, p, w in (("big_rows", BIG_ROWS, 64),
                             ("big_state", BIG_STATE, 32))}
    check(not plans["big_rows"]["rows"] and plans["big_rows"]["state"]
          and not plans["big_state"]["state"], f"event plans {plans}")
    # the kernel on fig7's buckets: the quick sweep's (4 workloads x 11
    # policies = 44 blocks) and the full sweep's (15 x 11 = 165)
    quick = _event_timing(REG.QUICK_WORKLOADS)
    full = _event_timing(WL.WORKLOAD_NAMES)
    # the plain loop on the quick bucket cut to 1 instruction (768 request
    # steps): at paper scale (49,152) it would take minutes
    cut = _event_timing(REG.QUICK_WORKLOADS, n_instr=1)
    b = cut.pop("bucket")
    t0 = time.perf_counter()
    EV.event_loop(b, n_warps=48, lanes=16, prm=prm)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    quick.pop("bucket"), full.pop("bucket")
    return dict(cases=cases, request_steps=steps, max_abs_err=0.0,
                grid=EVENT_GRID, cut=dict(cases=EVENT_CUT,
                                          why="plain loop ~5 ms a step"),
                plans=plans, ms=quick["ms"], device_ms=quick["device_ms"],
                bytes=quick["bytes"], ops=quick["ops"],
                chain_bound_ms=chain_bound_ms(quick["steps_per_block"]),
                plain_ms=plain_ms, plain_shape=dict(I=1, W=48, L=16,
                                                    blocks=cut["blocks"]),
                plain_ms_per_step=plain_ms / cut["steps_per_block"],
                quick=quick, full=dict(
                    full, chain_bound_ms=chain_bound_ms(
                        full["steps_per_block"])))


#: (spec, seeds) the CUDA sampler is held against the numpy sampler on in
#: chip_smoke: a paper workload at two seeds, scheduled phases with churn,
#: the legacy flip, the benchmark's 16,384 warps
TRACEGEN_CASES = (("BFS", (0, 2**31 + 11)), ("PHASED256", (0, 5)),
                  ("PHASE2K", (3,)), ("HAMMER16K", (2**31 + 99,)))


def tracegen_spec(name: str) -> TG.TraceSpec:
    if name in WL.WORKLOADS:
        return TG.TraceSpec.from_workload(WL.WORKLOADS[name])
    return {**TG.STRESS_SPECS, **TG.SHARD_STRESS_SPECS, **TG.PHASED_SPECS,
            **TG.PHASED_RECOVER_SPECS}[name]


def _tracegen_timing(spec: TG.TraceSpec) -> dict:
    """One seed of ``spec`` through the CUDA sampler: ``ms`` (CUDA events
    around the wrapper, host lowering included), ``device_ms`` (the
    kernel alone, on inputs already on the card) and ``copy_ms`` (its
    inputs to the card), ``plain_ms`` (the numpy sampler), and the bytes
    it must move: every output written once, every input read once."""
    ins, _ = KTG._ref.cell_inputs(spec, (1,))
    blob, offsets = KTG._pack(ins[1:])
    buf = torch.from_numpy(blob).to(DEV)
    t0 = time.perf_counter()
    _sample_cells(spec, (1,))
    plain_ms = (time.perf_counter() - t0) * 1e3
    cells = spec.n_instr * spec.n_warps * spec.lines_per_instr
    out_bytes = 4 * cells + 8 * cells // spec.lines_per_instr
    return dict(
        ms=time_ms(lambda: KTG.sample_cells(spec, (1,), DEV)),
        device_ms=device_ms(lambda: KTG._draw(ins.dims, buf, offsets)),
        copy_ms=device_ms(
            lambda: torch.from_numpy(blob).to(DEV, non_blocking=True)),
        plain_ms=plain_ms, cells=cells, bytes=out_bytes + blob.nbytes,
        ops=0)


def phase_tracegen() -> dict:
    """The CUDA sampler against the numpy sampler on the card, bitwise
    (``TRACEGEN_CASES``); its time at HAMMER16K's and a fig7 workload's
    shapes; PAPER_FIG7 through ``Experiment.run``: one launch a scenario,
    every cell drawn on the card."""
    for name, seeds in TRACEGEN_CASES:
        spec = tracegen_spec(name)
        host = _sample_cells(spec, seeds)
        got = KTG.sample_cells(spec, seeds, DEV)
        for k in KTG.DEVICE_KEYS:
            check(torch.equal(got[k].cpu(), torch.from_numpy(host[k])),
                  f"tracegen {name}: {k} differs from the numpy sampler")
    hammer = _tracegen_timing(tracegen_spec("HAMMER16K"))
    fig7 = _tracegen_timing(tracegen_spec("BFS"))
    reset_launches(("tracegen",))
    before = dict(TG.CELLS)
    exp = REG.paper_fig7(seeds=(11,)).with_(device=DEV)
    exp.run()
    launches = KTG.TRACEGEN.launches
    cells = len(exp.scenarios) * fig7["cells"]
    check(launches == len(exp.scenarios),
          f"tracegen: {launches} launches for {len(exp.scenarios)} "
          "scenarios")
    check(TG.CELLS["device"] - before["device"] == cells
          and TG.CELLS["host"] == before["host"],
          f"tracegen: PAPER_FIG7 sampled {TG.CELLS} (from {before})")
    return dict(max_abs_err=0.0, cases=len(TRACEGEN_CASES),
                launches=launches, **hammer, fig7=fig7)


def phase_fig7() -> dict:
    """fig7_performance on the quick workloads through repro_torch.api on
    the card: the goldens within 1e-6, the paper's ordering, one
    event-loop launch per bucket; then the full PAPER_FIG7 experiment."""
    PF._CACHE.clear()
    PF._OFF_SWEEP_CACHE.clear()
    torch.cuda.synchronize()
    reset_launches(("event_loop",))
    t0 = time.perf_counter()
    rows, derived = PF.fig7_performance(REG.QUICK_WORKLOADS, device=DEV)
    wall = time.perf_counter() - t0
    launches = EVL.EVENT_LOOP.launches
    check(launches == len(REG.QUICK_WORKLOADS),
          f"fig7: {launches} event_loop launches for "
          f"{len(REG.QUICK_WORKLOADS)} buckets")
    check(set(derived) == set(GOLDEN_FIG7_DERIVED), f"fig7 keys {derived}")
    for k, want in GOLDEN_FIG7_DERIVED.items():
        check(abs(derived[k] - want) <= 1e-6,
              f"fig7 {k}: {derived[k]!r} vs golden {want}")
    bfs = {r["policy"]: r["speedup"] for r in rows
           if r["workload"] == "BFS" and r["policy"] in GOLDEN_FIG7_BFS}
    for k, want in GOLDEN_FIG7_BFS.items():
        check(abs(bfs[k] - want) <= 1e-6,
              f"fig7 BFS {k}: {bfs[k]!r} vs golden {want}")
    h = {k.split("[")[1].rstrip("]"): v for k, v in derived.items()
         if k.startswith("hmean_speedup[")}
    check(h["MeDiC"] > h["WByp"] > h["PC-Byp"] > h["Baseline"]
          and h["MeDiC"] > h["PCAL"] and h["MeDiC"] > h["EAF"]
          and derived["medic_vs_best_prior"] > 1.1, f"fig7 ordering {h}")
    # the full sweep: 15 workloads x 11 policies in one bucket
    exp = REG.PAPER_FIG7.with_(device=DEV)
    reset_launches(("event_loop",))
    t0 = time.perf_counter()
    rs = exp.run()
    full_wall = time.perf_counter() - t0
    full_launches = EVL.EVENT_LOOP.launches
    check(full_launches == 1 and exp.compile().n_calls == 1,
          f"PAPER_FIG7: {full_launches} launches")
    sp = rs.speedup_over("Baseline")
    for wl in REG.QUICK_WORKLOADS:     # the same simulations as above
        for r in rows:
            if r["workload"] == wl and r["policy"] in sp[wl]:
                check(round(sp[wl][r["policy"]], 4) == r["speedup"],
                      f"PAPER_FIG7 {wl} {r['policy']} != fig7 quick")
    hmean = {p: float(len(sp) / sum(1.0 / sp[wl][p] for wl in sp))
             for p in rs.policies}
    hmean["Rand(ideal)"] = float(len(sp) / sum(
        1.0 / max(sp[wl][f"Rand({q:.2f})"] for q in (0.25, 0.5, 0.75))
        for wl in sp))
    return dict(derived=derived, bfs=bfs, wall_s=wall, launches=launches,
                paper_fig7=dict(wall_s=full_wall, launches=full_launches,
                                hmean_speedup={k: round(v, 4)
                                               for k, v in hmean.items()},
                                medic_vs_best_prior=round(
                                    hmean["MeDiC"] / max(
                                        hmean["PCAL"], hmean["EAF"],
                                        hmean["PC-Byp"]), 4)))


def phase_wave1() -> dict:
    """BP at paper scale under Baseline and MeDiC: the wavefront engine
    with waves of one warp equals the event engine on the card, at the
    reference's tolerance (rtol = atol = 1e-5)."""
    tr = WL.generate(WL.WORKLOADS["BP"], 0)
    pols = (BL.BASELINE, BL.MEDIC)
    _, w, l = tr["lines"].shape
    kw = dict(n_warps=w, lanes=l, prm=SimParams(), device=DEV)
    t0 = time.perf_counter()
    ev = simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"], pols,
                        engine="event", **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wf = simulate_sweep(tr["lines"], tr["pcs"], tr["compute_gap"], pols,
                        engine="wavefront", wave_size=1, **kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst = 0.0
    for k in ev:
        a, b = ev[k].double().cpu(), wf[k].double().cpu()
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5,
                                   msg=f"wave1 {k}")
        worst = max(worst, float((a - b).abs().max()))
    return dict(event_s=t1 - t0, wavefront_s=t2 - t1, max_abs_err=worst,
                ipc={p.name: float(v) for p, v in zip(pols, ev["ipc"].cpu())})


def phase_api() -> dict:
    """registry.STRESS through repro_torch.api on the card (wavefront,
    both kernels once a wave), then the phased goldens through
    Experiment.run."""
    exp = REG.STRESS.with_(device=DEV)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rs = exp.run()
    wall = time.perf_counter() - t0
    c = counts()
    check(c["waves"] > 0 and c["wave_queue"] == c["waves"]
          and c["wave_cache"] == c["waves"], f"STRESS launches {c}")
    names = list(rs.policies)
    scen = {}
    for sc in exp.scenarios:
        m = rs.get(scenario=sc.name)
        ipc = np.asarray(m["ipc"], dtype=float)
        check(bool(np.isfinite(ipc).all() and (ipc > 0).all()),
              f"STRESS {sc.name} ipc {ipc}")
        tr = sc.materialize()
        requests = int((tr["lines"] >= 0).sum()) * len(names)
        order = [names[i] for i in np.argsort(-ipc)]
        scen[sc.name] = dict(
            ipc=dict(zip(names, ipc.tolist())),
            medic_rank=order.index("MeDiC") + 1, call_wall_s=rs.wall_of(
                sc.name), requests=requests)
    for call in exp.compile().calls:     # requests/s of each call
        names_c = [s.name for s in call.scenarios]
        req = sum(scen[n]["requests"] for n in names_c)
        for n in names_c:
            scen[n]["call_requests_per_s"] = req / scen[n]["call_wall_s"]
    phased = {}
    for exp_p, golden in (
            (REG.phased(("PHASED256",)), GOLDEN_PHASED256_IPC),
            (REG.recover(("PHASED_RECOVER256",)), GOLDEN_RECOVER256_IPC)):
        reset_counts()
        rp = exp_p.with_(device=DEV).run()
        cp = counts()
        check(cp["waves"] > 0 and cp["wave_queue"] == cp["waves"]
              and cp["wave_cache"] == cp["waves"],
              f"{exp_p.name} launches {cp}")
        name = exp_p.scenarios[0].name
        ipc = {p: rp.value("ipc", scenario=name, policy=p) for p in golden}
        for p, want in golden.items():
            check(abs(ipc[p] - want) <= 1e-6,
                  f"{name} {p} through the API: {ipc[p]!r} vs {want}")
        phased[name] = dict(ipc=ipc, wall_s=rp.wall_s, launches=cp)
    return dict(stress=dict(wall_s=wall, launches=c, n_calls=len(
        rs.call_walls()), scenarios=scen), phased=phased)


# ---------------------------------------------------------------------------
# phase 10b: sharded sweeps on meshes of the card
# ---------------------------------------------------------------------------

#: the sharded phase's fig7 policies (one per mechanism family)
SHARD_POLICIES = (BL.BASELINE, BL.PCAL, BL.WBYP, BL.MEDIC)


def _rs_bitwise(a, b, what: str) -> None:
    """Two ResultSets equal bit for bit (NaN equal to NaN)."""
    check(a.scenarios == b.scenarios and a.policies == b.policies,
          f"{what}: labels differ")
    for sc in a.scenarios:
        for seed in a.seeds(sc):
            x, y = a.get(sc, seed=seed), b.get(sc, seed=seed)
            check(set(x) == set(y), f"{what}: metric names differ")
            for k in x:
                check(np.array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                     equal_nan=True),
                      f"{what} {sc} seed {seed} {k}: sharded != unsharded")


def _sharded_run(exp, mesh, axes, what: str) -> dict:
    """``exp`` without a mesh, then on ``mesh`` with ``axes`` (counts set
    to 0 just before each run and read just after): bitwise equal; each
    run's wall (trace generation included), its calls' wall and its peak
    device memory on cuda:0 (``peak_gb``) and on each card the mesh
    names."""
    out = {}
    runs = {}
    cards = sorted({d.index or 0 for d in mesh.devices.flat} | {0})
    for key, e in (("unsharded", exp),
                   ("sharded", exp.with_(mesh=mesh, mesh_axes=axes))):
        for i in cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
        reset_counts()
        reset_launches(("event_loop",))
        t0 = time.perf_counter()
        runs[key] = e.run()
        for i in cards:
            torch.cuda.synchronize(i)
        out[f"{key}_wall_s"] = time.perf_counter() - t0
        # the simulate_sweep calls alone (trace generation left out)
        out[f"{key}_call_s"] = runs[key].wall_s
        out[f"{key}_peak_gb"] = torch.cuda.max_memory_allocated(0) / 1e9
        out[f"{key}_peak_gb_by_card"] = {
            f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 1e9
            for i in cards}
        out[f"{key}_launches"] = dict(counts(),
                                      event_loop=EVL.EVENT_LOOP.launches)
    _rs_bitwise(runs["unsharded"], runs["sharded"], what)
    call = exp.with_(mesh=mesh, mesh_axes=axes).compile().calls[0]
    out["resolved"] = dict(policy=call.policy_axes, seed=call.seed_axes,
                           warp=call.warp_axes)
    out["mesh"] = repr(mesh)
    return out


def phase_sharded() -> dict:
    """Sharded sweeps through ``repro_torch.api`` on meshes of the card,
    each bitwise against the same run without a mesh: a mesh of every
    card (one card: size 1, every axis resolves to None); the quick fig7
    workloads × 2 seeds × 4 policies on a (2, 2) mesh of cuda:0 (policy
    and seed blocks: one event-loop launch a block); PHASED256 × 2
    policies on a (2, 4) mesh (policy blocks and warp shards); HAMMER16K
    × MeDiC with its warps in 4 shards (both wavefront kernels once a
    wave); and, with several cards, HAMMER16K over distinct cards."""
    n_cards = torch.cuda.device_count()
    fig7 = REG.paper_fig7(REG.QUICK_WORKLOADS, seeds=(0, 1),
                          name="sharded_fig7").with_(
        policies=SHARD_POLICIES, device=DEV)
    every = make_local_mesh(1, n_cards)
    r_every = _sharded_run(fig7, every, None, "fig7 on every card")
    if n_cards == 1:
        check(r_every["resolved"] == dict(policy=None, seed=None,
                                          warp=None),
              f"a size-1 mesh resolved {r_every['resolved']}")
    one_card = functools.partial(make_local_mesh, device="cuda:0")
    r_fig7 = _sharded_run(fig7, one_card(2, 2), ("data", "model", None),
                          "fig7 on (2, 2)")
    check(r_fig7["resolved"] == dict(policy="data", seed="model",
                                     warp=None)
          and r_fig7["sharded_launches"]["event_loop"] == 4
          and r_fig7["unsharded_launches"]["event_loop"] == 1,
          f"fig7 on (2, 2): {r_fig7}")
    phased = REG.phased(("PHASED256",), name="sharded_phased").with_(
        policies=(BL.BASELINE, BL.MEDIC), device=DEV)
    r_phased = _sharded_run(phased, one_card(2, 4), ("data", None, "model"),
                            "PHASED256 on (2, 4)")
    hammer = REG.stress_shard(("HAMMER16K",), policies=(BL.MEDIC,),
                              name="sharded_hammer16k").with_(device=DEV)
    r_hammer = _sharded_run(hammer, one_card(1, 4), (None, None, "model"),
                            "HAMMER16K on (1, 4)")
    for what, r, warp in (("PHASED256", r_phased, "model"),
                          ("HAMMER16K", r_hammer, "model")):
        for key in ("unsharded", "sharded"):
            c = r[f"{key}_launches"]
            check(c["waves"] > 0 and c["wave_queue"] == c["waves"]
                  and c["wave_cache"] == c["waves"],
                  f"{what} {key}: launches {c} != one per wave")
        check(r["resolved"]["warp"] == warp
              and r["sharded_launches"]["waves"]
              == r["unsharded_launches"]["waves"],
              f"{what}: {r['resolved']}, waves {r}")
    report = dict(every_card=r_every, fig7=r_fig7, phased=r_phased,
                  hammer16k=r_hammer, card=card_line())
    if n_cards > 1:
        k = 1 << (n_cards.bit_length() - 1)
        r = _sharded_run(hammer, make_local_mesh(1, k),
                         (None, None, "model"), "HAMMER16K on cards")
        c = r["sharded_launches"]
        check(c["wave_queue"] == c["waves"] == c["wave_cache"]
              and r["resolved"]["warp"] == "model", f"HAMMER16K cards {r}")
        # the trace is spread: cuda:0 holds its shard, not the whole, and
        # every other card little more than its shard of the trace (lines,
        # pcs and oracle labels, i32)
        spec = TG.SHARD_STRESS_SPECS["HAMMER16K"]
        shard_gb = (spec.n_warps * spec.n_instr * (spec.lines_per_instr + 2)
                    * 4 / k / 1e9)
        r["shard_trace_gb"] = shard_gb
        check(r["sharded_peak_gb"] < 0.5 * r["unsharded_peak_gb"],
              f"HAMMER16K over {k} cards: cuda:0 peaks at "
              f"{r['sharded_peak_gb']} GB against {r['unsharded_peak_gb']} "
              f"GB unsharded")
        for card, gb in r["sharded_peak_gb_by_card"].items():
            check(card == "cuda:0" or gb < 1.25 * shard_gb,
                  f"HAMMER16K over {k} cards: {card} peaks at {gb} GB, "
                  f"its shard of the trace is {shard_gb} GB")
        report["hammer16k_cards"] = r
    # launches of the sharded runs alone (the unsharded ones are their
    # reference)
    report["launches"] = {
        k: sum(r["sharded_launches"][k] for r in
               (r_every, r_fig7, r_phased, r_hammer,
                *([report["hammer16k_cards"]] if n_cards > 1 else [])))
        for k in ("wave_queue", "wave_cache", "event_loop")}
    return report


# ---------------------------------------------------------------------------
# phase 11: the serving path's kernels against their plain versions
# ---------------------------------------------------------------------------

#: the reference's kernel tolerance (tests/test_kernels.py:16)
TOL = {torch.bfloat16: 4e-2, torch.float32: 3e-5}
#: the long-row checks (``decode_edges``, ``flash_cross``) draw q and v at
#: this scale. From N(0, 1) a row over Skv keys gives outputs of size
#: ~sqrt(e / Skv) (0.02 at 6400 keys), under TOL's atol. At AMP the scores
#: have std 3, a row's weight sits on its largest few keys and its running
#: max moves by whole units from tile to tile, and the outputs have an rms
#: near 1 (0.7 at 6400 keys, 3 at one key).
AMP = 3.0
#: the least rms of a plain output (a decode row) those checks accept: an
#: output far under TOL's atol would pass whatever the kernel wrote
MIN_RMS = 0.25
# The phases' ``max_abs_err`` / ``max_abs_err_f32`` are over the grids
# drawn from N(0, 1). The grids drawn at AMP report each case's max |err|
# beside the plain output's max |x| and ``tol_share``: at outputs near 10
# a float32 error of 4e-5 is within TOL (atol + rtol |plain|), not over it.

#: the serving path's shapes: 28 layers x 4 slots x 28 blocks of 16
#: positions, Hkv 8, G 2, D 128
L_, B_, P_, PAGE, HKV, G_, D_ = 28, 4, 28, 16, 8, 2, 128


def _randn(shape, dtype, gen, dev, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)


def _close(out, plain, dtype, what) -> float:
    """Max |out - plain| after checking it against the tolerance."""
    a, b = out.float(), plain.float()
    ok = torch.allclose(a, b, atol=TOL[dtype], rtol=TOL[dtype])
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(ok and bool(torch.isfinite(a).all()),
          f"{what}: kernel vs plain max err {err} beyond {TOL[dtype]}")
    return err


def _tol_share(out, plain, dtype) -> float:
    """The largest |out - plain| / (atol + rtol |plain|) at TOL: at most 1
    where ``_close`` passes."""
    a, b = out.float(), plain.float()
    return float(((a - b).abs() / (TOL[dtype] * (1 + b.abs()))).max())


def _sdpa(q, k, v, **kw):
    """One PyTorch library call: q [B, Sq, H, D], k/v [B, Sk, Hkv, D]
    (strided views, no copies) -> [B, H, Sq, D]."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)


def device_split(fn, iters: int = 20, tries: int = 10) -> dict:
    """Per call of ``fn`` on the card, from torch.profiler over ``iters``
    calls after three warm-ups: ``{kernel name: (launches a call, device
    µs a launch)}``. The profiler can miss launches of a run (in a long
    process, now and then all of a few runs in a row), so each kernel's
    time is its mean over the launches seen, and its count a call the
    nearest whole number; a run that saw none of some kernel's launches is
    repeated after a pause, and after ``tries`` raises."""
    from torch.profiler import ProfilerActivity, profile
    for t in range(tries):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        if t:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: (round(e.count / iters), _device_us(e) / e.count)
                for e in prof.key_averages() if _device_us(e) > 0}
        if seen and all(n for n, _ in seen.values()):
            return seen
    raise RuntimeError(f"torch.profiler saw no kernel of {iters} calls, "
                       f"or too few of one, in {tries} runs (last: {seen})")


def queued_ms(fn, iters: int = 20) -> float:
    """The card's time per call of ``fn`` in ms from CUDA events around
    ``iters`` calls queued behind a ~30 ms sleep kernel, so that the host
    has enqueued them all before the first runs: device time with the
    gaps between launches, host time hidden."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """The card's own time per call of ``fn`` in ms: the summed duration
    of every kernel it launches (``device_split``), host time between
    launches excluded. Where torch.profiler stays blind to a call's
    kernels, ``queued_ms`` (said on stderr)."""
    try:
        split = device_split(fn, iters)
    except RuntimeError as e:
        print(f"device_ms: {e}; timing by queued_ms", file=sys.stderr,
              flush=True)
        return queued_ms(fn, iters)
    return sum(n * us for n, us in split.values()) / 1e3


def offload_table(slot: int, idx: int, dev) -> torch.Tensor:
    """The engine's offload read: block idx of one slot in every layer."""
    return ((torch.arange(L_, dtype=torch.int32) * B_ + slot) * P_
            + idx).view(L_, 1).to(dev)


def phase_medic_gather(dev=DEV) -> dict:
    gen = torch.Generator(device=dev).manual_seed(10)
    n = L_ * B_ * P_
    cases = 0

    def same(pools, tbl, what):
        nonlocal cases
        outs = GATHER.medic_gather_pools_cuda(pools, tbl)
        one = GATHER.medic_gather_cuda(pools[0], tbl)
        torch.cuda.synchronize()
        plain = [GATHER._ref.medic_gather_ref(p, tbl) for p in pools]
        check(torch.equal(one, plain[0]), f"medic_gather {what}: kernel != "
              "plain")
        check(len(outs) == len(pools)
              and all(torch.equal(o, q) for o, q in zip(outs, plain)),
              f"medic_gather pools {what}: kernel != plain")
        cases += 1
    for dtype in (torch.bfloat16, torch.float32):
        pools = [_randn((n, PAGE, HKV, D_), dtype, gen, dev)
                 for _ in range(3)]
        holes = torch.randint(0, n, (B_, P_), generator=gen, device=dev)
        holes[torch.rand((B_, P_), generator=gen, device=dev) < 0.3] = -1
        tables = [offload_table(3, 27, dev), offload_table(0, 0, dev),
                  holes.to(torch.int32),
                  torch.full((3, 5), -1, dtype=torch.int32, device=dev),
                  torch.tensor([[n - 1]], dtype=torch.int32, device=dev)]
        for tbl in tables:
            for k in (1, 2, 3):
                same(pools[:k], tbl, f"{dtype} {tuple(tbl.shape)} x{k}")
    # pages of 60 bytes, and a pool off 16 bytes, take the byte route
    small = [_randn((9, 3, 1, 5), torch.float32, gen, dev) for _ in range(2)]
    tbl = torch.tensor([[8, -1, 0], [4, 4, -1]], dtype=torch.int32,
                       device=dev)
    same(small, tbl, "byte route (60-byte pages)")
    flat_pool = _randn((9 * 16 + 1,), torch.float32, gen, dev)
    odd = flat_pool[1:].view(9, 4, 2, 2)          # 4 bytes past 16
    same([odd], tbl, "byte route (unaligned pool)")
    # timing at the path's call: one block of one slot in all 28 layers;
    # the engine reads K and V with one launch
    pk = _randn((n, PAGE, HKV, D_), torch.bfloat16, gen, dev)
    pv = _randn((n, PAGE, HKV, D_), torch.bfloat16, gen, dev)
    tbl = offload_table(2, 13, dev)
    idx = tbl.view(-1).long()
    run = lambda: GATHER.medic_gather_cuda(pk, tbl)  # noqa: E731
    pair = lambda: GATHER.medic_gather_pools_cuda((pk, pv), tbl)  # noqa
    lib = lambda: torch.index_select(pk, 0, idx)  # noqa: E731
    check(torch.equal(lib().view(L_, 1, PAGE, HKV, D_), run()),
          "medic_gather library call")
    # host-bound: the kernel, index_select and the pools form in turns
    (ms, ms_rounds), (library_ms, library_rounds), (pools_ms, _) = \
        turns_ms((run, lib, pair))
    dev_ms = device_ms(run, iters=50)
    plain_ms = time_ms(lambda: GATHER._ref.medic_gather_ref(pk, tbl))
    library_device_ms = device_ms(lib, iters=50)
    page_bytes = PAGE * HKV * D_ * pk.element_size()
    return dict(cases=cases, max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms,
                ms_rounds=ms_rounds, library_ms_rounds=library_rounds,
                pools_ms=pools_ms,
                pools_device_ms=device_ms(pair, iters=50),
                shape=[n, PAGE, HKV, D_],
                bytes=2 * L_ * page_bytes + nbytes([tbl]), ops=0)


def phase_decode_attention(dev=DEV) -> dict:
    gen = torch.Generator(device=dev).manual_seed(11)
    n, w = B_ * P_, P_ * PAGE
    ident = torch.arange(n, dtype=torch.int32, device=dev).view(B_, P_)
    perm = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32).view(B_, P_)
    holes = perm.clone()
    holes[torch.rand((B_, P_), generator=gen, device=dev) < 0.25] = -1
    holes[1] = -1                                  # an all-hole row
    tables = {"path": ident, "perm": perm, "holes": holes}
    plan = DEC.device_plan(dev, B_, HKV, PAGE, P_)
    sp = plan.split_len           # lengths on the split boundaries, too
    lens_sets = [[0, 1, 15, 16], [17, 447, 448, 100], [w] * B_,
                 [33, 250, 31, 239], [1, sp - 1, sp, sp + 1],
                 [w, 0, 2 * sp, w - 1]]
    err = {}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn((B_, HKV, G_, D_), dtype, gen, dev)
        kp = _randn((n, PAGE, HKV, D_), dtype, gen, dev)
        vp = _randn((n, PAGE, HKV, D_), dtype, gen, dev)
        e = 0.0
        for tname, tbl in tables.items():
            for lens in lens_sets:
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                out = DEC.paged_decode_attention_cuda(q, kp, vp, tbl, ln)
                torch.cuda.synchronize()
                plain = DEC._ref.paged_decode_attention_ref(q, kp, vp, tbl,
                                                            ln)
                e = max(e, _close(out, plain, dtype,
                                  f"decode {dtype} {tname} {lens}"))
                cases += 1
        err[str(dtype)] = e
    # timing at the path's call: the ring of 4 slots as pages, mixed lengths
    lens = [96, 208, 337, 448]
    q = _randn((B_, HKV, G_, D_), torch.bfloat16, gen, dev)
    kp = _randn((n, PAGE, HKV, D_), torch.bfloat16, gen, dev)
    vp = _randn((n, PAGE, HKV, D_), torch.bfloat16, gen, dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda: DEC.paged_decode_attention_cuda(q, kp, vp, ident, ln)
    ms = time_ms(run, iters=100)
    dev_ms = device_ms(run)
    plain_ms = time_ms(lambda: DEC._ref.paged_decode_attention_ref(
        q, kp, vp, ident, ln))
    # the library: masked SDPA over the dense ring [B, W, Hkv, D]
    qs = q.reshape(B_, 1, HKV * G_, D_)
    kd, vd = kp.view(B_, w, HKV, D_), vp.view(B_, w, HKV, D_)
    mask = (torch.arange(w, device=dev)[None] < ln[:, None])[:, None, None]
    lib = _sdpa(qs, kd, vd, attn_mask=mask)
    _close(lib.reshape(B_, HKV, G_, D_),
           DEC.paged_decode_attention_cuda(q, kp, vp, ident, ln),
           torch.bfloat16, "decode library call")
    library_ms = time_ms(lambda: _sdpa(qs, kd, vd, attn_mask=mask),
                         iters=100)
    library_device_ms = device_ms(lambda: _sdpa(qs, kd, vd, attn_mask=mask))
    row = HKV * D_ * 2                                  # one bf16 position
    bytes_moved = (nbytes([q, ident, ln]) + 2 * row * sum(lens)
                   + nbytes([q]))
    ops = 4 * sum(lens) * HKV * G_ * D_
    serve = []
    for shape in DECODE_SERVE:
        for dtype in (torch.bfloat16, torch.float32):
            e = decode_edges(gen, dev, *shape, dtype)
            cases += e.pop("cases")
            serve.append(dict(shape=[*shape, str(dtype)], **e))
    hybrid = _decode_attention_hybrid(gen, dev)
    return dict(cases=cases + hybrid.pop("cases"),
                max_abs_err=max(err["torch.bfloat16"],
                                hybrid["max_abs_err"]),
                max_abs_err_f32=max(err["torch.float32"],
                                    hybrid.pop("max_abs_err_f32")),
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                n_split=plan.n_split, split_len=plan.split_len,
                lengths=lens, bytes=bytes_moved,
                ops=ops, hybrid=hybrid, serve=serve)


#: the dense, moe, encdec and vlm serve runs' decode, the ring read as one
#: page (B, Hkv, G, D, page, pages): Danube (G 4, D 80, its window's ring
#: of 4096, and as pages of 16), Granite and the VLM's self-attention (G
#: 4), Grok-1 (G 6), Qwen1.5 (G 8) at the ring of 528, OLMoE (G 1) at
#: 1056; Whisper's ring of 256 and its cross-attention over 1500 frames
#: (G 1, D 64), the VLM's over 6400 image tokens (G 4), each memory one
#: page a sequence
DECODE_SERVE = [(2, 8, 4, 80, 4096, 1), (2, 8, 4, 80, 16, 256),
                (2, 8, 4, 128, 528, 1), (2, 8, 6, 128, 528, 1),
                (2, 8, 8, 128, 528, 1), (2, 16, 1, 128, 1056, 1),
                (4, 6, 1, 64, 256, 1), (4, 6, 1, 64, 1500, 1),
                (2, 8, 4, 128, 6400, 1)]


def decode_edges(gen, dev, b, hkv, g, d, page, p, dtype) -> dict:
    """The split-KV kernel at lengths on its own splits' edges (1,
    split - 1, split, split + 1, the full table), 0 beside a full row, and
    holes among many short splits, q and v drawn at ``AMP``, against the
    plain version; rows with nothing live give zeros. Returns the max
    |err| and the cases, beside the plain output's max |x|, its live rows'
    least rms and ``tol_share``."""
    plan = DEC.device_plan(dev, b, hkv, page, p)
    cap, sp = page * p, plan.split_len
    n = b * p
    q = _randn((b, hkv, g, d), dtype, gen, dev, AMP)
    kp = _randn((n, page, hkv, d), dtype, gen, dev)
    vp = _randn((n, page, hkv, d), dtype, gen, dev, AMP)
    tbl = torch.randperm(n, generator=gen, device=dev).to(
        torch.int32).view(b, p)
    if p > 1:
        tbl[0, 1::5] = -1
    edges = [1, sp - 1, sp, sp + 1, 2 * sp, cap - 1, cap, 0]
    err, cases, top, least, share = 0.0, 0, 0.0, float("inf"), 0.0
    for i in range(0, len(edges), b):
        lens = [min(max(x, 0), cap) for x in (edges[i:i + b] + [cap] * b)[:b]]
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = DEC.paged_decode_attention_cuda(q, kp, vp, tbl, ln)
        torch.cuda.synchronize()
        plain = DEC._ref.paged_decode_attention_ref(q, kp, vp, tbl, ln)
        what = (f"decode B={b} Hkv={hkv} G={g} D={d} page={page}x{p} {plan} "
                f"{lens} {dtype}")
        err = max(err, _close(out, plain, dtype, what))
        top = max(top, float(plain.float().abs().max()))
        share = max(share, _tol_share(out, plain, dtype))
        for row, length in enumerate(lens):
            check(length > 0 or torch.count_nonzero(out[row]) == 0,
                  f"decode G={g} D={d}: a row with nothing live is not 0")
            if length:
                rms = float(plain[row].float().square().mean().sqrt())
                check(rms >= MIN_RMS, f"{what}: row {row}'s plain output "
                      f"rms {rms} under {MIN_RMS}")
                least = min(least, rms)
        cases += 1
    return dict(max_abs_err=err, cases=cases, max_abs_plain=top,
                min_rms_plain=least, tol_share=share)


#: the hybrid path's decode: B 2, one KV head, G 10, D 256, a ring of 2048
HB, HG, HD, HW = 2, 10, 256, 2048


def _decode_attention_hybrid(gen, dev) -> dict:
    """The decode kernel at RecurrentGemma-2B's local attention: the ring
    as one page (as the model reads it) and as pages of 16 (permuted, with
    holes), against the plain version; then its ms at a full ring beside
    the plain version's and masked SDPA's."""
    e = {"torch.bfloat16": 0.0, "torch.float32": 0.0}
    cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        q = _randn((HB, 1, HG, HD), dtype, gen, dev)
        for page in (HW, 16):
            p = HW // page
            kp = _randn((HB * p, page, 1, HD), dtype, gen, dev)
            vp = _randn((HB * p, page, 1, HD), dtype, gen, dev)
            tbl = torch.randperm(HB * p, generator=gen, device=dev).to(
                torch.int32).view(HB, p)
            if page == 16:             # holes among many short splits
                tbl[0, 3] = -1
                tbl[1, ::7] = -1
            # 1, split - 1, split, split + 1 (splits of 16), the full ring,
            # and 0 next to a full row
            for lens in ([HW, HW], [1, 1500], [2047, 17], [15, 16],
                         [0, HW]):
                ln = torch.tensor(lens, dtype=torch.int32, device=dev)
                out = DEC.paged_decode_attention_cuda(q, kp, vp, tbl, ln)
                torch.cuda.synchronize()
                plain = DEC._ref.paged_decode_attention_ref(q, kp, vp, tbl,
                                                            ln)
                e[str(dtype)] = max(e[str(dtype)], _close(
                    out, plain, dtype, f"decode D=256 G=10 {dtype} page "
                    f"{page} {lens}"))
                cases += 1
    q = _randn((HB, 1, HG, HD), torch.bfloat16, gen, dev)
    kp = _randn((HB, HW, 1, HD), torch.bfloat16, gen, dev)
    vp = _randn((HB, HW, 1, HD), torch.bfloat16, gen, dev)
    tbl = torch.arange(HB, dtype=torch.int32, device=dev).view(HB, 1)
    ln = torch.full((HB,), HW, dtype=torch.int32, device=dev)
    run = lambda: DEC.paged_decode_attention_cuda(q, kp, vp, tbl, ln)
    ms = time_ms(run, iters=50)
    dev_ms = device_ms(run)
    plan = DEC.device_plan(dev, HB, 1, HW, 1)
    plain_ms = time_ms(lambda: DEC._ref.paged_decode_attention_ref(
        q, kp, vp, tbl, ln))
    qs = q.reshape(HB, 1, HG, HD)
    lib = _sdpa(qs, kp.view(HB, HW, 1, HD), vp.view(HB, HW, 1, HD))
    _close(lib.reshape(HB, 1, HG, HD),
           DEC.paged_decode_attention_cuda(q, kp, vp, tbl, ln),
           torch.bfloat16, "decode D=256 library call")
    lib = lambda: _sdpa(qs, kp.view(HB, HW, 1, HD),  # noqa: E731
                        vp.view(HB, HW, 1, HD))
    library_ms, library_device_ms = time_ms(lib, iters=50), device_ms(lib)
    return dict(cases=cases, max_abs_err=e["torch.bfloat16"],
                max_abs_err_f32=e["torch.float32"], ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms,
                n_split=plan.n_split, split_len=plan.split_len,
                shape=[HB, 1, HG, HD, HW],
                bytes=nbytes([q, kp, vp, tbl, ln, q]),
                ops=4 * HB * HW * HG * HD)


FLASH_CASES = [  # (S, H, Hkv, D, causal, window, dtype)
    (16, 16, 8, 128, True, None, torch.bfloat16),
    (96, 16, 8, 128, True, None, torch.bfloat16),
    (432, 16, 8, 128, True, None, torch.bfloat16),
    (1024, 16, 8, 128, True, None, torch.bfloat16),
    (96, 16, 8, 128, True, None, torch.float32),
    (300, 16, 8, 128, True, 64, torch.bfloat16),
    (37, 4, 1, 64, True, 8, torch.float32),
    (50, 6, 3, 32, False, None, torch.bfloat16),
    (1, 16, 8, 128, True, None, torch.bfloat16),
    # the hybrid's local attention: MQA, G 10, D 256, window 2048
    (3072, 10, 1, 256, True, 2048, torch.bfloat16),
    (300, 10, 1, 256, True, 64, torch.float32),
    (37, 10, 1, 256, True, 16, torch.bfloat16),
    (1, 10, 1, 256, True, 2048, torch.float32),
    (77, 4, 2, 200, False, None, torch.float32),
    # the bf16 tensor-core kernel: S off its tile of 64 rows, windows
    # shorter than a key tile, groups of 1, 2, 10 and 16 folded into rows
    (100, 10, 1, 256, True, 16, torch.bfloat16),
    (333, 10, 1, 256, True, 100, torch.bfloat16),
    (130, 2, 1, 128, True, None, torch.bfloat16),
    (77, 16, 1, 64, True, None, torch.bfloat16),
    (200, 16, 1, 256, True, 40, torch.bfloat16),
    (70, 1, 1, 32, True, 8, torch.bfloat16),
    (65, 16, 8, 128, False, None, torch.bfloat16),
    (77, 4, 2, 200, True, 50, torch.bfloat16),
    # the dense and moe serve runs' prefills: Danube (D 80, G 4, window
    # 4096 at S 4608), Granite (G 4), Grok-1 (G 6), Qwen1.5 (G 8), OLMoE
    # (G 1), and D 80 and G 6 off the tile
    (4608, 32, 8, 80, True, 4096, torch.bfloat16),
    (512, 32, 8, 128, True, None, torch.bfloat16),
    (512, 48, 8, 128, True, None, torch.bfloat16),
    (512, 64, 8, 128, True, None, torch.bfloat16),
    (1024, 16, 16, 128, True, None, torch.bfloat16),
    (333, 32, 8, 80, True, 100, torch.bfloat16),
    (77, 8, 2, 80, False, None, torch.bfloat16),
    (100, 8, 2, 80, True, 64, torch.float32),
    (130, 12, 2, 128, True, 40, torch.bfloat16),
    # Whisper's decoder self-attention: G 1 at D 64 (the VLM's self-
    # attention is Granite's shape above)
    (224, 6, 6, 64, True, None, torch.bfloat16),
]

#: non-causal flash with its own key length Skv (B, S, Skv, H, Hkv, D,
#: dtype): Whisper's encoder (S = Skv = 1500, off both key tiles) and
#: cross-attention (S 224 over 1500 frames), G 1 at D 64; the VLM's cross-
#: attention (S 512 over 6400 image tokens), G 4 at D 128; and S, Skv off
#: every tile with G 2
FLASH_CROSS = [(b, s, skv, h, hkv, d, dtype)
               for b, s, skv, h, hkv, d in ((4, 1500, 1500, 6, 6, 64),
                                            (4, 224, 1500, 6, 6, 64),
                                            (2, 512, 6400, 32, 8, 128),
                                            (1, 37, 100, 4, 2, 64))
               for dtype in (torch.bfloat16, torch.float32)]


def phase_flash_attention(dev=DEV) -> dict:
    gen = torch.Generator(device=dev).manual_seed(12)
    err = {"torch.bfloat16": 0.0, "torch.float32": 0.0}
    for s, h, hkv, d, causal, window, dtype in FLASH_CASES:
        q = _randn((1, s, h, d), dtype, gen, dev)
        k = _randn((1, s, hkv, d), dtype, gen, dev)
        v = _randn((1, s, hkv, d), dtype, gen, dev)
        out = FLASH.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        plain = FLASH._ref.flash_attention_ref(q, k, v, causal=causal,
                                               window=window)
        e = _close(out, plain, dtype, f"flash S={s} H={h}/{hkv} D={d} "
                   f"causal={causal} window={window} {dtype}")
        err[str(dtype)] = max(err[str(dtype)], e)
    cross = [dict(case=[*case[:-1], str(case[-1])],
                  **flash_cross(gen, dev, *case)) for case in FLASH_CROSS]
    # timing at the path's longest prefill: S = 432, H 16 / Hkv 8, D 128
    s = 432
    q = _randn((1, s, HKV * G_, D_), torch.bfloat16, gen, dev)
    k = _randn((1, s, HKV, D_), torch.bfloat16, gen, dev)
    v = _randn((1, s, HKV, D_), torch.bfloat16, gen, dev)
    ms = time_ms(lambda: FLASH.flash_attention_cuda(q, k, v), iters=50)
    dev_ms = device_ms(lambda: FLASH.flash_attention_cuda(q, k, v))
    plain_ms = time_ms(lambda: FLASH._ref.flash_attention_ref(q, k, v))
    lib = _sdpa(q, k, v, is_causal=True).transpose(1, 2)
    _close(lib, FLASH.flash_attention_cuda(q, k, v), torch.bfloat16,
           "flash library call")
    library_ms = time_ms(lambda: _sdpa(q, k, v, is_causal=True), iters=50)
    library_device_ms = device_ms(lambda: _sdpa(q, k, v, is_causal=True))
    ops = 4 * (s * (s + 1) // 2) * HKV * G_ * D_
    return dict(cases=len(FLASH_CASES) + len(FLASH_CROSS),
                max_abs_err=err["torch.bfloat16"],
                max_abs_err_f32=err["torch.float32"], ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_device_ms, s=s,
                bytes=nbytes([q, k, v]) + nbytes([q]),
                ops=ops, hybrid=_flash_attention_hybrid(gen, dev),
                cross=cross)


def flash_cross(gen, dev, b, s, skv, h, hkv, d, dtype) -> dict:
    """The flash kernel without a mask over keys of their own length Skv
    (``causal=False``), q and v drawn at ``AMP``, against the plain
    version: max |err| beside the plain output's max |x|, its rms and
    ``tol_share``."""
    q = _randn((b, s, h, d), dtype, gen, dev, AMP)
    k = _randn((b, skv, hkv, d), dtype, gen, dev)
    v = _randn((b, skv, hkv, d), dtype, gen, dev, AMP)
    out = FLASH.flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    plain = FLASH._ref.flash_attention_ref(q, k, v, causal=False)
    what = f"flash B={b} S={s} Skv={skv} H={h}/{hkv} D={d} non-causal {dtype}"
    rms = float(plain.float().square().mean().sqrt())
    check(rms >= MIN_RMS, f"{what}: plain output rms {rms} under {MIN_RMS}")
    return dict(max_abs_err=_close(out, plain, dtype, what),
                max_abs_plain=float(plain.float().abs().max()),
                rms_plain=rms, tol_share=_tol_share(out, plain, dtype))


def _flash_attention_hybrid(gen, dev, s: int = 3072, window: int = 2048
                            ) -> dict:
    """The flash kernel at one RecurrentGemma-2B prefill layer (B 2,
    S 3072, H 10 on one KV head, D 256, window 2048): ms beside the plain
    version's and SDPA's with the same window as a boolean mask."""
    q = _randn((HB, s, HG, HD), torch.bfloat16, gen, dev)
    k = _randn((HB, s, 1, HD), torch.bfloat16, gen, dev)
    v = _randn((HB, s, 1, HD), torch.bfloat16, gen, dev)
    run = lambda: FLASH.flash_attention_cuda(q, k, v, window=window)
    ms = time_ms(run, iters=10)
    dev_ms = device_ms(run, iters=5)
    plain_ms = time_ms(lambda: FLASH._ref.flash_attention_ref(
        q, k, v, window=window), iters=3)
    pos = torch.arange(s, device=dev)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    lib = _sdpa(q, k, v, attn_mask=mask).transpose(1, 2)
    _close(lib, run(), torch.bfloat16, "flash D=256 library call")
    library_ms = time_ms(lambda: _sdpa(q, k, v, attn_mask=mask), iters=10)
    library_device_ms = device_ms(lambda: _sdpa(q, k, v, attn_mask=mask),
                                  iters=5)
    # live (query, key) pairs under the causal window
    pairs = sum(min(i + 1, window) for i in range(s))
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_device_ms,
                shape=[HB, s, HG, 1, HD], window=window,
                bytes=nbytes([q, k, v, q]), ops=4 * HB * HG * pairs * HD)


# ---------------------------------------------------------------------------
# phase 12: the serving path
# ---------------------------------------------------------------------------

SERVING_KERNELS = ("medic_gather", "paged_decode_attention",
                   "flash_attention")


def reset_serving_counts() -> None:
    reset_launches(SERVING_KERNELS)
    ENG.COUNTS.reset()


def _snaps_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape or not np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


#: what each engine of the A/B did, by policy: its requests (with their
#: lifecycle stamps) and copies of its pool's counters, kept by
#: ``phase_serving`` for ``phase_serving_sim``'s closed-loop check
AB_ENGINES: dict = {}
POOL_COUNTERS = ("fetches", "bypassed_blocks", "hits", "accesses",
                 "seq_type", "evictions_by_type")


class _KeptEngine(ENG.ServeEngine):
    """``ServeEngine`` that, after a run, keeps its requests and copies of
    its pool's counters in ``AB_ENGINES`` under its pool policy."""

    def run(self, requests, max_steps: int = 2000):
        snap = super().run(requests, max_steps=max_steps)
        AB_ENGINES[self.pool.cfg.policy] = dict(
            requests=requests, snapshot=snap,
            pool={k: np.copy(getattr(self.pool, k)) for k in POOL_COUNTERS})
        return snap


def phase_serving(cfg=None, dev=DEV, rerun_steps: int = 96) -> dict:
    """``run_ab`` at full width through the kernels (its engines keep
    their requests and pool counters in ``AB_ENGINES``), then MeDiC for
    ``rerun_steps`` steps with the kernels and with their plain versions
    (float32, so the comparison sees the kernels and not bf16 rounding
    compounding over 28 layers)."""
    cfg = cfg or get_config("qwen3_1_7b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_serving_counts()
    AB_ENGINES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(ENG, "ServeEngine", _KeptEngine):
        out = ENG.run_ab(cfg, SERVE_WL, SERVE_POOL, SERVE_ECFG, seed=0,
                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(AB_ENGINES) == sorted(PINNED_AB), "serving: the A/B's "
          f"engines kept {sorted(AB_ENGINES)}")
    launches = launches_of(SERVING_KERNELS)
    eng = dataclasses.asdict(ENG.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    ab = {p: {k: out[p][k] for k in PINNED_AB[p]} for p in PINNED_AB}
    for p, want in PINNED_AB.items():
        check(ab[p] == want, f"serving {p}: {ab[p]} != pinned {want}")
    layers = cfg.num_layers
    check(launches["flash_attention"] == layers * eng["admissions"] > 0,
          f"flash launches {launches} vs {eng}")
    check(launches["paged_decode_attention"] == layers * eng["decode_steps"]
          > 0, f"decode launches {launches} vs {eng}")
    check(launches["medic_gather"] == eng["offloads"] > 0,
          f"gather launches {launches} vs {eng}")
    tokens = sum(out[p]["tokens_out"] for p in out)

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = ENG.init_params(cfg32, 0, dev)
    pool = dataclasses.replace(SERVE_POOL, policy="medic")
    runs = {}
    t1 = time.perf_counter()
    for backend in ("cuda", "ref"):
        e = ENG.ServeEngine(cfg32, SERVE_ECFG, pool, device=dev,
                            backend=backend, params=params)
        snap = e.run(generate_requests(SERVE_WL, seed=0),
                     max_steps=rerun_steps)
        runs[backend] = (snap, e._kv_leaves(), e.cache)
        del e
    torch.cuda.synchronize()
    (sk, kvk, ck), (sr, kvr, cr) = runs["cuda"], runs["ref"]
    check(_snaps_equal(sk, sr), "serving rerun: kernels' snapshot != "
          "plain versions'")
    check(torch.equal(ck["len"], cr["len"])
          and torch.equal(ck["kv_pos"], cr["kv_pos"]),
          "serving rerun: len / kv_pos differ")
    kv_err = 0.0
    for n in ("k", "v"):
        check(torch.allclose(kvk[n], kvr[n], atol=2e-2, rtol=2e-2),
              f"serving rerun: committed {n} beyond 2e-2")
        kv_err = max(kv_err, float((kvk[n] - kvr[n]).abs().max()))
    rerun_s = time.perf_counter() - t1
    del runs, kvk, kvr, ck, cr
    ragged = _ragged_ring(cfg32, dev)
    return dict(wall_s=wall, decode_steps=eng["decode_steps"],
                decode_steps_per_s=eng["decode_steps"] / wall,
                tokens_out=tokens, tokens_per_s=tokens / wall,
                peak_gb=peak / 1e9, engine_counts=eng, launches=launches,
                ab=ab, rerun=dict(steps=sk["steps"], dtype="float32",
                                  max_abs_err_kv=kv_err,
                                  tokens_out=sk["tokens_out"],
                                  seconds=rerun_s),
                ragged=ragged)


#: a ring that is not a whole number of pool blocks (max_len 100, blocks
#: of 16): the engine reads it in pages of gcd(100, 16) = 4, and its last
#: block is 4 tokens; chat requests wrap it and the budget offloads every
#: block index (tests/test_torch_serving_engine.py holds the same run
#: against the reference on the CPU)
RAGGED_ECFG = ENG.EngineConfig(max_slots=2, max_len=100)
RAGGED_POOL = PoolConfig(budget_blocks=8, block_tokens=16,
                         sampling_interval=8, policy="medic")
RAGGED_WL = ServeWorkload(n_requests=4, chat_frac=1.0)
#: committed K/V of the float32 runs, kernels against plain: 5.30e-6 on
#: the H100 (2 layers, the K/V of layer 1 carry layer 0's attention)
RAGGED_KV_TOL = 1e-4


def _ragged_ring(cfg32, dev, layers: int = 2) -> dict:
    """The engine at max_len 100 with Qwen3's full width cut to
    ``layers`` layers in float32, through the kernels and through their
    plain versions: snapshots, ``len`` and ``kv_pos`` equal, committed K/V
    within RAGGED_KV_TOL, one gather launch per offload and one decode
    launch per layer a step."""
    cfg = dataclasses.replace(cfg32, num_layers=layers)
    params = ENG.init_params(cfg, 0, dev)
    runs = {}
    for backend in ("cuda", "ref"):
        reset_serving_counts()
        e = ENG.ServeEngine(cfg, RAGGED_ECFG, RAGGED_POOL, device=dev,
                            backend=backend, params=params)
        snap = e.run(generate_requests(RAGGED_WL, seed=0), max_steps=400)
        runs[backend] = (snap, e._kv_leaves(),
                         launches_of(SERVING_KERNELS),
                         dataclasses.asdict(ENG.COUNTS), e.page, e.cache)
        del e
    (sk, kvk, lk, ek, page, ck), (sr, kvr, _, _, _, cr) = (runs["cuda"],
                                                          runs["ref"])
    check(page == 4 and _snaps_equal(sk, sr), "ragged ring: kernels' "
          "snapshot != plain versions'")
    check(torch.equal(ck["len"], cr["len"])
          and torch.equal(ck["kv_pos"], cr["kv_pos"]),
          "ragged ring: len / kv_pos differ")
    check(lk["medic_gather"] == ek["offloads"] > 0
          and lk["paged_decode_attention"] == layers * ek["decode_steps"]
          > 0, f"ragged ring launches {lk} vs {ek}")
    err = max(float((kvk[n] - kvr[n]).abs().max()) for n in ("k", "v"))
    check(err <= RAGGED_KV_TOL, f"ragged ring: committed K/V differ by "
          f"{err}")
    return dict(page=page, steps=sk["steps"], completed=sk["completed"],
                fetches=sk["fetches"], launches=lk, engine_counts=ek,
                max_abs_err_kv=err)


# ---------------------------------------------------------------------------
# phase 12b: the open-loop serving simulator (host numpy) through the API,
# and held against the card's engine
# ---------------------------------------------------------------------------

#: registry.PAPER_SERVING as the reference gives it (repro.api on the CPU,
#: seed 0): per (scenario, policy) the integers SERVING_INTS, then the
#: floats SERVING_FLOATS (shortest round-trip reprs)
SERVING_INTS = ("completed", "steps", "tokens_out", "stall_steps",
                "fetches", "bypassed_blocks", "max_concurrency")
SERVING_FLOATS = ("p99_latency", "mean_latency", "hit_ratio", "goodput")
GOLDEN_SERVING = {
    ("SERVE_POISSON64", "Baseline"): (
        192, 614, 6322, 26361, 36950, 0, 64,
        367.8787659112108, 233.8816197820389,
        0.3852171704343409, 10.296416938110749),
    ("SERVE_POISSON64", "MeDiC"): (
        192, 463, 6322, 14914, 21180, 11376, 64,
        224.82904388624996, 114.17849478203895,
        0.5930827202583887, 13.654427645788337),
    ("SERVE_POISSON64", "MeDiC-stale"): (
        192, 611, 6322, 26003, 36365, 170, 64,
        363.0083522514977, 231.37641144870557,
        0.40944402132520946, 10.346972176759412),
    ("SERVE_POISSON64", "MeDiC-oracle"): (
        192, 512, 6322, 8015, 26493, 26881, 60,
        269.24009963850335, 74.16807811537227,
        0.2934059521493873, 12.34765625),
    ("SERVE_BURSTY64", "Baseline"): (
        192, 596, 6059, 25872, 37847, 0, 64,
        365.6402591936936, 233.52072315091291,
        0.3692640910693598, 10.166107382550335),
    ("SERVE_BURSTY64", "MeDiC"): (
        192, 513, 6059, 14835, 23623, 13881, 64,
        274.4618875494464, 127.35926481757961,
        0.5485492735716416, 11.810916179337232),
    ("SERVE_BURSTY64", "MeDiC-stale"): (
        192, 596, 6059, 26066, 38135, 480, 64,
        373.3619720935782, 236.32280648424626,
        0.382437718756434, 10.166107382550335),
    ("SERVE_BURSTY64", "MeDiC-oracle"): (
        192, 496, 6059, 7864, 26276, 26752, 64,
        276.4809213671334, 75.31238981757961,
        0.2676076367902727, 12.215725806451612),
    ("SERVE_DIURNAL64", "Baseline"): (
        192, 603, 6062, 26546, 36910, 0, 64,
        449.78257150094936, 257.10252327044947,
        0.3382957393483709, 10.0530679933665),
    ("SERVE_DIURNAL64", "MeDiC"): (
        192, 477, 6062, 14952, 21520, 12208, 64,
        298.2325715009494, 142.41502327044947,
        0.6556418413173652, 12.70859538784067),
    ("SERVE_DIURNAL64", "MeDiC-stale"): (
        192, 600, 6062, 26396, 36591, 546, 64,
        449.33257150094937, 255.9931482704495,
        0.3473684210526316, 10.103333333333333),
    ("SERVE_DIURNAL64", "MeDiC-oracle"): (
        192, 527, 6062, 7728, 25150, 25585, 64,
        271.5245166783219, 72.33689827044947,
        0.31320520768753873, 11.502846299810246),
    ("SERVE_POISSON2K", "Baseline"): (
        4096, 281, 292920, 91053, 18264, 0, 2048,
        182.39142191420174, 118.8737693089482,
        0.9940874026152928, 1042.4199288256227),
    ("SERVE_POISSON2K", "MeDiC"): (
        4096, 281, 292920, 91043, 18264, 0, 2048,
        182.66038228098057, 118.8698630589482,
        0.9940874026152928, 1042.4199288256227),
    ("SERVE_POISSON2K", "MeDiC-stale"): (
        4096, 281, 292920, 91043, 18264, 0, 2048,
        182.66038228098057, 118.8698630589482,
        0.9940874026152928, 1042.4199288256227),
    ("SERVE_POISSON2K", "MeDiC-oracle"): (
        4096, 762, 292920, 371419, 1264091, 1264885, 2048,
        611.1997367022464, 193.4138083714482,
        0.36126580809838726, 384.40944881889766),
}
#: the reference's cut of SERVE_BURSTY64 for its fast == ref check
#: (tests/test_serving_sim.py)
SERVE_CUT = dict(n_requests=96, max_steps=1500)
#: steps of the A/B's engine runs (ServeEngine.run's default)
AB_STEPS = 2000


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _runs_equal(a: dict, b: dict) -> bool:
    return all(_snaps_equal(a[k], b[k])
               for k in ("request_arrays", "pool", "metrics"))


def _closed_loop(policy: str) -> dict:
    """The simulator on the A/B's request list under ``policy``, both pool
    backends, against what the card's engine did in ``phase_serving``:
    a closed-loop spec with SERVE_ECFG's slots and SERVE_POOL's pool."""
    eng = AB_ENGINES[policy]
    reqs = eng["requests"]
    spec = SIM.ServingSpec(
        "SERVE_AB", process="closed", n_requests=len(reqs),
        max_slots=SERVE_ECFG.max_slots, max_len=SERVE_ECFG.max_len,
        block_tokens=SERVE_POOL.block_tokens,
        budget_blocks=SERVE_POOL.budget_blocks,
        sampling_interval=SERVE_POOL.sampling_interval,
        fetch_latency=SERVE_POOL.fetch_latency,
        fetch_occupancy=SERVE_POOL.fetch_occupancy, max_steps=AB_STEPS)
    outs = {b: SIM.simulate_serving(SIM.from_requests(reqs), spec,
                                    policy=POOL_POLICIES[policy],
                                    pool_backend=b) for b in ("fast", "ref")}
    check(_runs_equal(outs["fast"], outs["ref"]),
          f"closed loop {policy}: fast != ref")
    out = outs["fast"]
    for k in POOL_COUNTERS:
        check(np.array_equal(out["pool"][k], eng["pool"][k]),
              f"closed loop {policy}: pool {k} {out['pool'][k]} != the "
              f"card engine's {eng['pool'][k]}")
    m = out["metrics"]
    agg = {k: m[k] for k in PINNED_AB[policy]}
    check(agg == PINNED_AB[policy] == {k: eng["snapshot"][k]
                                       for k in PINNED_AB[policy]},
          f"closed loop {policy}: {agg} vs pinned {PINNED_AB[policy]}")
    ra = out["request_arrays"]
    for k in ("first_token_step", "finish_step", "generated",
              "stall_steps"):
        check(ra[k].tolist() == [getattr(r, k) for r in reqs],
              f"closed loop {policy}: {k} differs from the card engine's")
    # enqueue_step: equal on every admitted request; one never admitted
    # is -1 here and keeps the Request default 0 in the engine
    got = ra["enqueue_step"]
    want = np.asarray([r.enqueue_step for r in reqs])
    admitted = got >= 0
    check(np.array_equal(got[admitted], want[admitted])
          and bool((want[~admitted] == 0).all())
          and bool((got[~admitted] == -1).all()),
          f"closed loop {policy}: enqueue_step {got} vs {want}")
    return dict(requests=len(reqs), admitted=int(admitted.sum()),
                never_admitted=int((~admitted).sum()), **agg)


def _paper_serving(device: str, out) -> None:
    """In a child process: registry.PAPER_SERVING through repro_torch.api
    on ``device``. Puts on ``out`` every scenario's and policy's metrics,
    each bucket's shape and wall, the plan, the whole wall and whether a
    kernel launched (or the error, with its traceback)."""
    sys.stdout = sys.stderr     # the parent's stdout carries the JSON lines
    try:
        exp = REG.PAPER_SERVING.with_(device=torch.device(device))
        plan = exp.compile()
        before = launches_of()
        t0 = time.perf_counter()
        rs = plan.execute()
        wall = time.perf_counter() - t0
        pols = list(rs.policies)
        out.put(dict(
            wall_s=wall, plan=plan.describe(), policies=pols,
            launched=launches_of() != before,
            got={(sc.name, p): {k: rs.value(k, scenario=sc.name, policy=p,
                                            seed=0)
                                for k in SERVING_INTS + SERVING_FLOATS}
                 for sc in exp.scenarios for p in pols},
            calls=[dict(slots=c.shape[1], requests=c.shape[2],
                        scenarios=[s.name for s in c.scenarios], wall_s=w)
                   for c, w in zip(plan.calls, rs.call_walls())]))
    except BaseException:
        import traceback
        out.put(dict(error=traceback.format_exc()))
        raise


def start_child(target, *args) -> tuple:
    """Start ``target(*args, out)`` in a spawned child process; returns
    (the process, its queue ``out``) for ``_child_result``."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=target, args=(*args, out), daemon=True)
    proc.start()
    return proc, out


def start_paper_serving(dev) -> tuple:
    """``_paper_serving`` in a child process, for ``phase_serving_sim``."""
    return start_child(_paper_serving, str(dev))


def phase_serving_sim(child=None) -> dict:
    """(a) registry.PAPER_SERVING through repro_torch.api (the simulator
    runs on the host whatever the device) in the child process ``child``
    (``start_paper_serving``; started here if None): the reference's
    goldens, the 2048-slot pin and the bursty gate; (b) the two pool
    backends equal on the cut SERVE_BURSTY64 under the 4 policies; (c) the
    simulator on the A/B's requests equal to the full-width engines of
    ``phase_serving``."""
    card = card_line()
    exp = REG.PAPER_SERVING.with_(device=DEV)
    t0 = time.perf_counter()
    paper = _child_result(child or start_paper_serving(DEV), "PAPER_SERVING")
    waited = time.perf_counter() - t0
    wall = paper["wall_s"]
    check(not paper["launched"],
          "PAPER_SERVING launched a kernel: the simulator is host numpy")
    pols = paper["policies"]
    got = {}
    for (sc, p), v in paper["got"].items():
        want = GOLDEN_SERVING[(sc, p)]
        ints = tuple(int(v[k]) for k in SERVING_INTS)
        check(ints == want[:len(SERVING_INTS)] and all(
            float(v[k]) == v[k] for k in SERVING_INTS),
            f"PAPER_SERVING {sc} {p}: {ints} != {want}")
        for k, w in zip(SERVING_FLOATS, want[len(SERVING_INTS):]):
            check(abs(v[k] - w) <= 1e-12,
                  f"PAPER_SERVING {sc} {p} {k}: {v[k]!r} vs {w!r}")
        got[f"{sc}/{p}"] = v
    check(sorted(paper["got"]) == sorted(
        (sc.name, p) for sc in exp.scenarios for p in pols),
        f"PAPER_SERVING ran {sorted(paper['got'])}")
    for p in pols:
        m = got[f"SERVE_POISSON2K/{p}"]
        check(m["max_concurrency"] >= 2048 and m["completed"] == 4096
              and m["steps"] <= 1200, f"SERVE_POISSON2K {p}: {m}")
    p99 = {p: got[f"SERVE_BURSTY64/{p}"]["p99_latency"] for p in pols}
    check(p99["MeDiC"] <= p99["Baseline"],
          f"bursty gate: MeDiC p99 {p99['MeDiC']} > Baseline's "
          f"{p99['Baseline']}")
    buckets = []
    for call in paper["calls"]:
        steps = int(sum(got[f"{s}/{p}"]["steps"]
                        for s in call["scenarios"] for p in pols))
        buckets.append(dict(call, steps=steps,
                            s_per_step=call["wall_s"] / steps))

    cut = dataclasses.replace(SIM.SERVING_SPECS["SERVE_BURSTY64"],
                              **SERVE_CUT)
    reqs = SIM.generate_serving(cut, 0)
    t1 = time.perf_counter()
    for pol in exp.policies:
        fast = SIM.simulate_serving(reqs, cut, policy=pol,
                                    pool_backend="fast")
        ref = SIM.simulate_serving(reqs, cut, policy=pol, pool_backend="ref")
        check(_runs_equal(fast, ref), f"fast != ref on the cut "
              f"SERVE_BURSTY64 under {pol.name}")
    fast_ref_s = time.perf_counter() - t1

    check(sorted(AB_ENGINES) == sorted(PINNED_AB),
          "serving_sim needs the serving phase's A/B engines")
    closed = {p: _closed_loop(p) for p in PINNED_AB}
    return dict(card=card, wall_s=wall, waited_s=waited, plan=paper["plan"],
                buckets=buckets, p99_bursty=p99,
                poisson2k={p: {k: int(got[f"SERVE_POISSON2K/{p}"][k])
                               for k in ("max_concurrency", "completed",
                                         "steps")} for p in pols},
                fast_eq_ref=dict(cut=SERVE_CUT, policies=pols,
                                 seconds=fast_ref_s),
                closed_loop=closed)


# ---------------------------------------------------------------------------
# phase 13: where a full-width decode step and the serving run spend time
# ---------------------------------------------------------------------------

def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", 0.0)
                 or getattr(e, "self_cuda_time_total", 0.0) or 0.0)


def _decode_profile(cfg, dev, steps: int = 5) -> dict:
    """One full-width model's decode step (4 slots at lengths 96, 208, 337,
    447 in rings of 448, pages of 16): host wall per step (synchronized),
    and from torch.profiler the device time per step by kernel."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import build_model
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    w = SERVE_ECFG.max_len
    cache = model.init_cache(B_, ShapeConfig("serve", w, B_, "decode"))
    lens = [96, 208, 337, 447]
    kv = cache["stack"]["scan"]["0_layer"]
    gen = torch.Generator(device=dev).manual_seed(1)
    for n in ("k", "v"):
        kv[n].copy_(torch.randn(kv[n].shape, generator=gen, device=dev))
    cache["len"] = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.arange(w, dtype=torch.int32, device=dev)[None]
    cache["kv_pos"] = torch.where(pos < cache["len"][:, None], pos,
                                  -1).to(torch.int32)
    toks = torch.zeros((B_, 1), dtype=torch.int32, device=dev)

    def step():
        nonlocal cache
        cache["len"] = torch.tensor(lens, dtype=torch.int32, device=dev)
        _, cache = model.decode(toks, cache, page=SERVE_POOL.block_tokens)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in kern) / steps
    top = sorted(kern, key=_device_us, reverse=True)[:8]
    wall_ms = float(np.median(walls))
    return dict(wall_ms=wall_ms, wall_ms_min=min(walls),
                device_ms=device_us / 1e3,
                device_busy_share=device_us / 1e3 / wall_ms,
                kernels_per_step=sum(e.count for e in kern) / steps,
                top_kernels=[dict(name=e.key[:80], count=e.count // steps,
                                  us=_device_us(e) / steps) for e in top],
                weight_bytes=sum(p.numel() * p.element_size()
                                 for p in model.parameters()))


def _engine_breakdown(cfg, dev, max_steps: int) -> dict:
    """Host wall of a MeDiC engine run split by what it did: each engine
    method is timed with a synchronize on both sides (so the split is
    exact and the run a little slower than unprofiled); times are
    exclusive (an offload inside an admission counts as offload)."""
    params = ENG.init_params(cfg, 0, dev)
    eng = ENG.ServeEngine(cfg, SERVE_ECFG,
                          dataclasses.replace(SERVE_POOL, policy="medic"),
                          device=dev, params=params)
    spent = {"_admit": 0.0, "_decode_step": 0.0, "_offload": 0.0,
             "_restore": 0.0}
    calls = dict.fromkeys(spent, 0)
    nested = []

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nested.append(0.0)
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            spent[name] += dt - nested.pop()
            if nested:
                nested[-1] += dt
            calls[name] += 1
            return out
        return run
    for name in spent:
        setattr(eng, name, timed(name, getattr(eng, name)))
    eng.pool.on_evict = eng._offload
    t0 = time.perf_counter()
    eng.run(generate_requests(SERVE_WL, seed=0), max_steps=max_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(steps=max_steps, wall_s=wall, seconds=spent, calls=calls,
                host_rest_s=wall - sum(spent.values()))


def phase_serving_profile(cfg=None, dev=DEV, engine_steps: int = 500) -> dict:
    cfg = cfg or get_config("qwen3_1_7b")
    return dict(decode_step=_decode_profile(cfg, dev),
                engine=_engine_breakdown(cfg, dev, engine_steps))


# ---------------------------------------------------------------------------
# phase 14: the hybrid and ssm paths' kernels against their plain versions
# ---------------------------------------------------------------------------

#: (B, S, W, a_lo, a_hi): odd S and W, one step, a ~ 1, W % 4 == 0 off a
#: block's 32 channels (36, 100), S off the tile (33, 1000) at the path's
#: W, the path's shape; each in both copy instances where W % 4 == 0
RG_LRU_CASES = [(1, 1, 1, 0.8, 0.999), (2, 33, 65, 0.8, 0.999),
                (3, 48, 384, 0.8, 0.999), (2, 64, 256, 0.8, 0.999),
                (1, 1000, 7, 0.8, 0.999), (2, 40, 24, 0.9999, 1.0),
                (2, 77, 36, 0.8, 0.999), (3, 129, 100, 0.8, 0.999),
                (1, 33, 2560, 0.9, 0.999), (1, 1000, 2560, 0.9, 0.999),
                (2, 3072, 2560, 0.9, 0.999)]


def _rg_lru_case(gen, dev, b, s, w, lo, hi, offset=0):
    """a, b [b, s, w] and h0 [b, w]; with ``offset`` floats, a and b are
    views that start ``offset`` floats into a larger buffer (so off 16
    bytes, and taken by the 4-byte copy instance)."""
    def view(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, device=dev)
        buf[offset:] = t.view(-1)
        return buf[offset:].view(t.shape)
    a = lo + (hi - lo) * torch.rand((b, s, w), generator=gen, device=dev)
    x = 0.1 * torch.randn((b, s, w), generator=gen, device=dev)
    h0 = torch.randn((b, w), generator=gen, device=dev)
    return view(a), view(x), h0


def phase_rg_lru(dev=DEV) -> dict:
    gen = torch.Generator(device=dev).manual_seed(13)
    runs = {"16-byte": 0, "4-byte": 0}
    cases = [c + (0,) for c in RG_LRU_CASES] + [(2, 65, 2560, 0.9, 0.999, 1),
                                                (1, 100, 36, 0.8, 0.999, 3)]
    for b, s, w, lo, hi, offset in cases:
        args = _rg_lru_case(gen, dev, b, s, w, lo, hi, offset)
        plain = RGLRU._ref.rg_lru_ref(*args)
        plan = RGLRU.plan_rg_lru(b, s, w, RGLRU.aligned16(*args[:2]))
        check(offset == 0 or plan.vec == 1,
              f"rg_lru offset view B={b} S={s} W={w}: not the 4-byte copies")
        for vec in sorted({plan.vec, 1}, reverse=True):
            p = RGLRU.plan_rg_lru(b, s, w, plan.vec == 4, vec=vec)
            out = RGLRU.rg_lru_cuda(*args, plan=p)
            torch.cuda.synchronize()
            check(torch.equal(out, plain), f"rg_lru B={b} S={s} W={w} "
                  f"offset {offset}, {4 * vec}-byte copies: kernel != plain")
            runs[f"{4 * vec}-byte"] += 1
    # timing at the hybrid prefill's call: one rec layer, B 2, S 3072, W 2560
    args = _rg_lru_case(gen, dev, 2, 3072, 2560, 0.9, 0.999)
    plan = RGLRU.plan_rg_lru(2, 3072, 2560, RGLRU.aligned16(*args[:2]))
    ms = time_ms(lambda: RGLRU.rg_lru_cuda(*args), iters=50)
    dev_ms = device_ms(lambda: RGLRU.rg_lru_cuda(*args))
    # the card's clock with the host hidden, beside the profiler's
    q_ms = queued_ms(lambda: RGLRU.rg_lru_cuda(*args), iters=50)
    plain_ms = time_ms(lambda: RGLRU._ref.rg_lru_ref(*args), iters=2)
    out = RGLRU.rg_lru_cuda(*args)
    moved = nbytes(list(args) + [out])
    return dict(cases=len(cases), runs=runs, max_abs_err=0.0, ms=ms,
                device_ms=dev_ms, queued_ms=q_ms, plain_ms=plain_ms,
                library_ms=None, shape=[2, 3072, 2560], plan=plan._asdict(),
                byte_bound_share=moved / HBM_BYTES_PER_S * 1e3 / dev_ms,
                bytes=moved, ops=2 * out.numel())


#: (B, S, H, Dk, Dv, dtype, state): S = 1, S < chunk, whole and ragged
#: chunks (63, 64, 65), Dk at the kernel's limit and off its tile of 16,
#: a nonzero state, bf16 and float32 at the path's Dk 192 / Dv 384 and at
#: Dk 256, the path's shape
MLSTM_CASES = [
    (2, 1, 2, 16, 24, torch.float32, True),
    (1, 1, 2, 192, 384, torch.bfloat16, True),
    (2, 63, 2, 192, 384, torch.float32, True),
    (1, 64, 2, 256, 384, torch.bfloat16, True),
    (2, 65, 2, 256, 96, torch.bfloat16, True),
    (1, 65, 3, 100, 40, torch.float32, False),
    (1, 1024, 2, 192, 384, torch.float32, True),
    (1, 1024, 1, 256, 384, torch.bfloat16, True),
    (2, 5, 2, 16, 24, torch.float32, True),
    (1, 64, 4, 16, 32, torch.float32, False),
    (2, 70, 2, 32, 100, torch.bfloat16, True),
    (2, 200, 1, 64, 64, torch.float32, True),
    (1, 130, 2, 256, 96, torch.float32, True),
    (1, 300, 4, 192, 384, torch.bfloat16, True),
    (4, 1024, 4, 192, 384, torch.bfloat16, False),
]


def _mlstm_inputs(gen, dev, b, s, h, dk, dv, dtype, with_state):
    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q, k, v = rn(b, s, h, dk).to(dtype), rn(b, s, h, dk).to(dtype), \
        rn(b, s, h, dv).to(dtype)
    li = rn(b, s, h)
    lf = torch.nn.functional.logsigmoid(rn(b, s, h) + 2.0)
    state = None
    if with_state:
        state = (rn(b, h, dk, dv), rn(b, h, dk).abs(), rn(b, h))
    return (q, k, v, li, lf), state


def phase_mlstm(dev=DEV) -> dict:
    gen = torch.Generator(device=dev).manual_seed(14)
    err = 0.0
    for b, s, h, dk, dv, dtype, with_state in MLSTM_CASES:
        args, state = _mlstm_inputs(gen, dev, b, s, h, dk, dv, dtype,
                                    with_state)
        out, st = MLSTM.mlstm_cuda(*args, state)
        torch.cuda.synchronize()
        p_out, p_st = MLSTM._ref.mlstm_chunkwise_ref(*args, state)
        for name, a, ref in zip(("h", "C", "n", "m"), (out,) + st,
                                (p_out,) + p_st):
            ok = torch.allclose(a, ref, atol=5e-4, rtol=5e-3)
            e = float((a - ref).abs().max())
            check(ok and bool(torch.isfinite(a).all()),
                  f"mlstm B={b} S={s} H={h} Dk={dk} Dv={dv} {dtype} "
                  f"state={with_state}: {name} max err {e} beyond 5e-4 / "
                  f"5e-3")
            err = max(err, e)
    # timing at the ssm prefill's call: one mLSTM layer of xLSTM-125M
    b, s, h, dk, dv = 4, 1024, 4, 192, 384
    args, _ = _mlstm_inputs(gen, dev, b, s, h, dk, dv, torch.bfloat16, False)
    ms = time_ms(lambda: MLSTM.mlstm_cuda(*args), iters=20)
    dev_ms = device_ms(lambda: MLSTM.mlstm_cuda(*args), iters=10)
    q_ms = queued_ms(lambda: MLSTM.mlstm_cuda(*args), iters=20)
    # device µs of each of its two kernels (chunk terms, state
    # recurrence); None where torch.profiler stays blind to them, as it
    # can late in a long process (said on stderr)
    try:
        split = {next((n for n in ("mlstm_chunk_kernel",
                                   "mlstm_state_kernel") if n in k), k): us
                 for k, (_, us) in device_split(
                     lambda: MLSTM.mlstm_cuda(*args), iters=10).items()}
    except RuntimeError as e:
        print(f"mlstm kernels_us: {e}", file=sys.stderr, flush=True)
        split = None
    plain_ms = time_ms(lambda: MLSTM._ref.mlstm_chunkwise_ref(*args),
                       iters=5)
    out, st = MLSTM.mlstm_cuda(*args)
    # the kernel against the CPU-tested model of its product precision
    m_out, m_st = MLSTM._ref.mlstm_chunkwise_tc_model(*args)
    model_err = max(float((a - b).abs().max())
                    for a, b in zip((out,) + st, (m_out,) + m_st))
    state_in = MLSTM._ref.empty_state(b, h, dk, dv, dev)
    # the chunkwise form's products per chunk and (batch, head): q.k and
    # w.v inside the chunk, q.C and the C update across chunks
    chunk = MLSTM._ref.CHUNK
    per_chunk = 2 * chunk * (chunk * dk + chunk * dv + 2 * dk * dv)
    ops = per_chunk * (s // chunk) * b * h
    moved = nbytes(list(args) + list(state_in) + [out] + list(st))
    return dict(cases=len(MLSTM_CASES), max_abs_err=err, ms=ms,
                device_ms=dev_ms, queued_ms=q_ms, kernels_us=split,
                plain_ms=plain_ms, library_ms=None, shape=[b, s, h, dk, dv],
                bytes=moved,
                ops=ops, model_err=model_err,
                # beside the float32 yardstick: the tensor-core rate of the
                # route (TF32) and the bytes alone
                bound_tf32_ms=ops / TF32_OPS_PER_S * 1e3,
                bound_bytes_ms=moved / HBM_BYTES_PER_S * 1e3)


# ---------------------------------------------------------------------------
# phase 15: the hybrid and ssm serve paths at full width
# ---------------------------------------------------------------------------

RECURRENT_KERNELS = ("rg_lru", "mlstm", "flash_attention",
                     "paged_decode_attention")

#: float32 logits of the kernels' run against the plain versions' run
#: (atol = rtol), per family. Both runs compute the same float32 function
#: and differ only in the order of their sums; a wrong kernel moves logits
#: (|logit| up to ~5 here) by O(1).
#: - hybrid: the attention kernels and rg_lru stay within ~1e-6 of their
#:   plain versions, ~2e-5 in the logits after 26 layers; 1e-3.
#: - ssm: the mLSTM divides by a normalizer that can nearly cancel, and the
#:   sLSTM's 1024-step recurrence amplifies what differs, so reordering
#:   alone moves xLSTM's logits by ~1e-3. The phase measures that floor on
#:   the card with a second plain run whose mLSTM takes chunks of 32 (as
#:   exact a form as the chunks of 64): ``plain_floor``; 1e-2.
#: - dense: as the hybrid, the attention kernels alone; ~2e-5 in the
#:   logits of Danube, Granite and Qwen1.5 (4 layers) on the H100; 1e-3.
#: - encdec, vlm: as dense, the attention kernels alone, now also over
#:   memories (Whisper's encoder of 1500 frames, bidirectional; cross-
#:   attention to 1500 frames and to 6400 image tokens) in prefill and
#:   decode; ``enc_out`` and the cross caches ``xk`` / ``xv`` are held at
#:   the same tolerance, ``len`` and ``kv_pos`` exactly; 1e-3.
#: - moe: the router takes each token's top k experts, and where the k-th
#:   and (k+1)-th probabilities sit within rounding of each other the two
#:   runs can choose differently (a flip); a flip moves that token's
#:   output by a whole expert's share, and the experts' positions of every
#:   later token. The phase counts the flips (``_flips``) and measures the
#:   floor with a second plain run whose router logits are computed in
#:   float64 (as exact a form as float32's): ``plain_floor``. On the H100
#:   OLMoE's whole run has 3 root flips (gaps under 1e-6) and logits
#:   within 1.83e-4 of the plain run, at a floor of 1.84e-4; Grok (2
#:   layers) none, 2e-5 at a floor of 1.1e-5; 1e-3.
#: ``tol_share`` is the largest |a - b| / (atol + rtol |b|) seen.
SERVE_F32_TOL = {"hybrid": 1e-3, "ssm": 1e-2, "dense": 1e-3, "moe": 1e-3,
                 "encdec": 1e-3, "vlm": 1e-3}
SERVE_STEPS = 32
#: a flip's probability gap (between the experts the two runs swapped, in
#: the plain run) must be under this: a routing near-tie, not a fault
FLIP_GAP = 1e-5


def _generate(model, prompts, seq_len, steps, forced=None, extra=None):
    """prefill + ``steps`` greedy decode steps (the tokens of ``forced``
    instead of the argmax when given; ``extra``: the prefill batch's other
    inputs, ``memory_inputs``). Returns (logits [steps+1] of [B, V]
    float32, tokens [B, steps], prefill s, decode s, the final cache)."""
    from repro_torch.configs.base import ShapeConfig
    b = prompts.shape[0]
    cache = model.init_cache(b, ShapeConfig("serve", seq_len, b, "decode"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts, **(extra or {})},
                                  cache)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, toks = [logits], []
    for i in range(steps):
        tok = (forced[:, i:i + 1] if forced is not None
               else outs[-1].argmax(-1, keepdim=True).to(torch.int32))
        toks.append(tok)
        logits, cache = model.decode(tok, cache)
        outs.append(logits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (outs, torch.cat([prompts[:, :0]] + toks, 1), t1 - t0, t2 - t1,
            cache)


#: the cross-attention families' memories: (batch key, length field)
MEMORY = {"encdec": ("frames", "encoder_seq_len"),
          "vlm": ("image_embeds", "num_image_tokens")}


def memory_inputs(cfg, batch: int, dev, seed: int = 2) -> dict:
    """The stubbed frontend's output that ``cfg``'s prefill takes besides
    its tokens, drawn from ``seed`` in float32 and cast to ``cfg.dtype``:
    Whisper's frame embeddings [B, Se, D] or the VLM's patch embeddings
    [B, Ti, D] (the same draws at every dtype); {} for other families."""
    if cfg.family not in MEMORY:
        return {}
    key, field = MEMORY[cfg.family]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, getattr(cfg, field), cfg.d_model), generator=gen,
                    device=dev)
    return {key: x.to(getattr(torch, cfg.dtype))}


#: parameters that start at zero and would hide a path: the VLM's cross
#: gates (tanh(0) = 0 zeroes every cross layer) and the ungated MLP's
#: biases; ``liven`` draws them, |tanh(gate)| in GATE_TANH, biases
#: N(0, BIAS_STD^2)
GATE_TANH = (0.3, 0.9)
BIAS_STD = 0.1


def liven(state: dict, seed: int = 3) -> dict:
    """Draw every gate and ungated-MLP bias of ``state`` (a model's
    parameters, changed in place) from ``seed``: gates with |tanh| in
    ``GATE_TANH`` and either sign, biases N(0, ``BIAS_STD``^2). The same
    seed gives the same values at every dtype. Returns what was drawn."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    drawn = {"gates": 0, "biases": 0}
    for name in sorted(state):
        t = state[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gate_attn", "gate_mlp"):
            lo, hi = GATE_TANH
            th = lo + (hi - lo) * torch.rand(t.shape, generator=gen)
            sign = torch.where(torch.rand(t.shape, generator=gen) < 0.5,
                               -1.0, 1.0)
            t.copy_(torch.atanh(th) * sign)
            drawn["gates"] += 1
        elif leaf in ("b_up", "b_down"):
            t.copy_(BIAS_STD * torch.randn(t.shape, generator=gen))
            drawn["biases"] += 1
    return dict(drawn, gate_tanh=list(GATE_TANH), bias_std=BIAS_STD,
                seed=seed)


def _prefill_by_block(model, prompts, seq_len, extra=None) -> dict:
    """Where one more bf16 prefill spends its time: seconds per block
    class (the encoder's layers too), each layer timed between
    synchronizes (so the total is a little above the unprofiled
    prefill's), and the total."""
    spent, start = {}, {}

    def before(mod, args):
        torch.cuda.synchronize()
        start[id(mod)] = time.perf_counter()

    def after(mod, args, out):
        torch.cuda.synchronize()
        name = type(mod).__name__
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - start[
            id(mod)]
    layers = list(model.layers) + list(getattr(model, "encoder", []))
    hooks = [h for layer in layers
             for h in (layer.register_forward_pre_hook(before),
                       layer.register_forward_hook(after))]
    try:
        _, _, total, _, _ = _generate(model, prompts, seq_len, 0,
                                      extra=extra)
    finally:
        for h in hooks:
            h.remove()
    return dict(total_s=total, seconds=spent)


def _compare(cfg, ko, po, tol) -> dict:
    """Logits of two float32 runs, step by step: within ``tol`` (atol =
    rtol), and the same greedy token wherever the top-two gap exceeds
    ``tol``."""
    err, share, scale, decided, agree = 0.0, 0.0, 0.0, 0, 0
    for i, (a, b) in enumerate(zip(ko, po)):
        check(torch.allclose(a, b, atol=tol, rtol=tol),
              f"{cfg.name} float32 step {i}: kernels vs plain max err "
              f"{float((a - b).abs().max())} beyond {tol}")
        err = max(err, float((a - b).abs().max()))
        share = max(share, float(((a - b).abs() / (tol + tol * b.abs())
                                  ).max()))
        scale = max(scale, float(b.abs().max()))
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        same = a.argmax(-1) == b.argmax(-1)
        check(bool(same[clear].all()), f"{cfg.name} float32 step {i}: "
              "greedy tokens differ where the top-two gap is clear")
        decided += int(clear.sum())
        agree += int((same & clear).sum())
    return dict(max_abs_err_logits=err, tol=tol, tol_share=share,
                max_abs_logit=scale, greedy_decided=decided,
                greedy_agree=agree)


def _compare_caches(cfg, kc, pc, tol) -> dict:
    """The final caches of two float32 runs: ``len`` and ``kv_pos`` equal,
    every cross cache (``xk`` / ``xv``, all cross layers) and Whisper's
    ``enc_out`` within ``tol`` (atol = rtol). Returns the max |err| of
    each. (The self rings are not held: a MoE routing flip moves a
    token's K/V by a whole expert's share.)"""
    check(torch.equal(kc["len"], pc["len"])
          and torch.equal(kc["kv_pos"], pc["kv_pos"]),
          f"{cfg.name} float32: len / kv_pos differ")
    pairs = {"enc_out": (kc.get("enc_out"), pc.get("enc_out"))}
    for sec in ("scan", "tail"):
        for key, leaves in kc["stack"][sec].items():
            for n, a in leaves.items():
                if n in ("xk", "xv"):
                    pairs[f"{key}.{n}"] = (a, pc["stack"][sec][key][n])
    err = {}
    for what, (a, b) in pairs.items():
        if a is None:
            continue
        check(torch.allclose(a, b, atol=tol, rtol=tol),
              f"{cfg.name} float32 {what}: kernels vs plain max err "
              f"{float((a - b).abs().max())} beyond {tol}")
        err[what] = float((a - b).abs().max())
    return err


class _Routing:
    """While active, records every MoE call's router probabilities and
    chosen experts (``calls``: one (probs [T, E], eidx [T, k]) a layer a
    forward, in call order)."""

    def __init__(self):
        self.calls = []
        self._top_k = MOE.top_k

    def _record(self, probs, k):
        vals, idx = self._top_k(probs, k)
        self.calls.append((probs, idx))
        return vals, idx

    def __enter__(self):
        self._patch = mock.patch.object(MOE, "top_k", self._record)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def _router_f64(xf, router):
    """The router's logits computed in float64, rounded to float32."""
    return (xf.double() @ router.double()).float()


def _kept(idx, n_experts: int, cap: int):
    """Which experts each token reaches after the capacity cut, bool [T,
    E]: the dispatch's positions in call order (a token's experts are
    distinct, so its own earlier choices never offset it)."""
    onehot = torch.nn.functional.one_hot(idx, n_experts)           # [T,k,E]
    assign = onehot.sum(1)
    pos = ((assign.cumsum(0) - assign)[:, None, :] * onehot).sum(-1)
    return (onehot * (pos < cap)[..., None]).sum(1) > 0


def _flips(cfg, layers: int, kern: list, plain: list) -> dict:
    """Routing of the kernels' run against the plain run, call by call.
    A flip is a token whose set of experts differs. A token is perturbed
    from its first flip, or its first capacity cut that differs (a flip
    before it moves its experts' positions), to the end of the forward.
    A flip of a token not yet perturbed is a root flip (its inputs differ
    by rounding and by what attention brings from perturbed tokens); its
    probability gap is the largest between an expert only one run chose
    and one only the other chose, in the plain run's probabilities, and
    every root flip's must be under FLIP_GAP. Flips of perturbed tokens
    are downstream. Also: each run's dropped assignments, and the largest
    probability difference between the runs over unperturbed tokens (the
    rounding that a flip has to beat)."""
    e = cfg.num_experts
    roots, gaps, drops = [], [], [0, 0]
    downstream = order_only = cut_differs = 0
    noise = 0.0
    perturbed = None
    for i, ((pk, ik), (pp, ip)) in enumerate(zip(kern, plain)):
        if i % layers == 0:                        # a new forward
            perturbed = torch.zeros(ik.shape[0], dtype=torch.bool,
                                    device=ik.device)
        sk, sp = ik.sort(-1).values, ip.sort(-1).values
        differ = (sk != sp).any(-1)
        order_only += int(((ik != ip).any(-1) & ~differ).sum())
        cap = MOE.capacity(cfg, ik.shape[0])
        kk, kp = _kept(ik, e, cap), _kept(ip, e, cap)
        cut = (kk != kp).any(-1) & ~differ
        cut_differs += int(cut.sum())
        calm = ~(perturbed | differ | cut)
        if bool(calm.any()):
            noise = max(noise, float((pk[calm] - pp[calm]).abs().max()))
        for row in torch.nonzero(differ).flatten().tolist():
            if perturbed[row]:
                downstream += 1
                continue
            a = set(sk[row].tolist()) - set(sp[row].tolist())
            b = set(sp[row].tolist()) - set(sk[row].tolist())
            gaps.append(max(abs(float(pp[row, x]) - float(pp[row, y]))
                            for x in a for y in b))
            roots.append(dict(call=i, layer=i % layers, token=row,
                              gap=gaps[-1]))
        perturbed |= differ | cut
        for j, kept in enumerate((kk, kp)):
            drops[j] += ik.numel() - int(kept.sum())
    check(all(g < FLIP_GAP for g in gaps), f"{cfg.name}: a routing flip "
          f"with a probability gap of {max(gaps, default=0.0)} >= "
          f"{FLIP_GAP}")
    return dict(calls=len(kern), root_flips=len(roots),
                downstream_flips=downstream, order_only=order_only,
                cut_differs=cut_differs, max_root_gap=max(gaps, default=0.0),
                roots=roots[:16], max_prob_diff_unperturbed=noise,
                dropped_assignments=dict(kernels=drops[0], plain=drops[1]))


def _serve(cfg, dev, batch: int, prompt: int, seq_len: int, tol: float,
           steps: int = SERVE_STEPS, floor=None, routing: bool = False
           ) -> dict:
    """One family's main path at ``cfg``'s width: the counted bf16 run
    through the kernels, then the float32 reruns (kernels, plain
    versions), teacher-forced with its tokens; with ``floor`` (a name and
    a context manager's factory), one more plain run under that context,
    as exact a form as the plain run's; with ``routing``, the MoE routing
    of the two float32 runs compared (``_flips``)."""
    from repro_torch.models.model import build_model
    gc.collect()        # what earlier phases left unreachable
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen, device=dev, dtype=torch.int32)
    model = build_model(cfg, dev)
    livened = liven(model.init_params(
        torch.Generator(device=dev).manual_seed(0)))
    extra = memory_inputs(cfg, batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(RECURRENT_KERNELS)
    outs, toks, pre_s, dec_s, _ = _generate(model, prompts, seq_len, steps,
                                            extra=extra)
    launches = launches_of(RECURRENT_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"{cfg.name}: non-finite logits")
    check(tuple(outs[0].shape) == (batch, cfg.padded_vocab),
          f"{cfg.name}: logits {tuple(outs[0].shape)}")
    n_params = sum(p.numel() for p in model.parameters())
    by_block = _prefill_by_block(model, prompts, seq_len, extra)
    del model, outs, extra
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kern = build_model(cfg32, dev, backend="cuda")
    state = kern.init_params(torch.Generator(device=dev).manual_seed(0))
    liven(state)
    plain = build_model(cfg32, dev, backend="ref")
    plain.load_params(state)
    extra = memory_inputs(cfg32, batch, dev)
    t0 = time.perf_counter()
    with _Routing() as rk:
        ko, _, _, _, kcache = _generate(kern, prompts, seq_len, steps,
                                        forced=toks, extra=extra)
    with _Routing() as rp:
        po, _, _, _, pcache = _generate(plain, prompts, seq_len, steps,
                                        forced=toks, extra=extra)
    flips = _flips(cfg, cfg.num_layers, rk.calls, rp.calls) if routing \
        else None
    del rk, rp
    floor_err = None
    if floor is not None:
        with floor[1]():
            fo, _, _, _, _ = _generate(plain, prompts, seq_len, steps,
                                       forced=toks, extra=extra)
        floor_err = max(float((a - b).abs().max()) for a, b in zip(fo, po))
        del fo
    rerun = _compare(cfg, ko, po, tol)
    rerun["max_abs_err_caches"] = _compare_caches(cfg, kcache, pcache, tol)
    rerun["seconds"] = time.perf_counter() - t0
    if floor is not None:
        rerun["plain_floor"] = dict(form=floor[0],
                                    max_abs_err_logits=floor_err)
    if flips is not None:
        rerun["routing"] = flips
    del kern, plain, state, ko, po, kcache, pcache, extra
    torch.cuda.empty_cache()
    tokens = batch * steps
    return dict(params=n_params, batch=batch, prompt=prompt,
                seq_len=seq_len, steps=steps, prefill_ms=pre_s * 1e3,
                prefill_tokens_per_s=batch * prompt / pre_s,
                decode_ms_per_step=dec_s * 1e3 / steps,
                decode_tokens_per_s=tokens / dec_s, peak_gb=peak / 1e9,
                held_gb=held / 1e9, launches=launches,
                prefill_by_block=by_block,
                livened=livened if any(livened[k] for k in
                                       ("gates", "biases")) else None,
                f32_rerun=rerun)


def phase_hybrid_serve(cfg=None, dev=DEV, steps: int = SERVE_STEPS) -> dict:
    """RecurrentGemma-2B: 2 prompts of 3072 tokens, a ring of 2048 (the
    local window) that prefill writes past its wrap, 32 decode steps."""
    cfg = cfg or get_config("recurrentgemma_2b")
    out = _serve(cfg, dev, batch=2, prompt=3072, seq_len=4096,
                 tol=SERVE_F32_TOL["hybrid"], steps=steps)
    kinds = _layer_kinds(cfg)
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    want = {"rg_lru": n_rec, "flash_attention": n_attn,
            "paged_decode_attention": n_attn * steps, "mlstm": 0}
    check(out["launches"] == want and n_rec > 0 and n_attn > 0,
          f"hybrid launches {out['launches']} != {want}")
    return out


def phase_ssm_serve(cfg=None, dev=DEV, steps: int = SERVE_STEPS) -> dict:
    """xLSTM-125M: 4 prompts of 1024 tokens, 32 decode steps."""
    cfg = cfg or get_config("xlstm_125m")
    chunked = functools.partial(MLSTM._ref.mlstm_chunkwise_ref, chunk=32)
    out = _serve(cfg, dev, batch=4, prompt=1024, seq_len=1024 + steps,
                 tol=SERVE_F32_TOL["ssm"], steps=steps,
                 floor=("mlstm chunks of 32", lambda: mock.patch.object(
                     MLSTM._ref, "mlstm_chunkwise_ref", chunked)))
    n_mlstm = _layer_kinds(cfg).count("mlstm")
    want = {"rg_lru": 0, "flash_attention": 0, "paged_decode_attention": 0,
            "mlstm": n_mlstm}
    check(out["launches"] == want and n_mlstm > 0,
          f"ssm launches {out['launches']} != {want}")
    return out


#: the dense family's runs: (arch, layers kept or None for all, prompts,
#: prompt tokens, ring (seq_len), decode steps). Danube's prompts of 4608
#: pass its window of 4096, which is its ring, so the window binds in
#: prefill and decode; Qwen1.5-110B (~220 GB in bf16) keeps 4 of its 80
#: layers at full width.
DENSE_RUNS = (("h2o_danube_1_8b", None, 2, 4608, 4608 + 32, 32),
              ("granite_3_8b", None, 2, 512, 512 + 16, 16),
              ("qwen1_5_110b", 4, 2, 512, 512 + 16, 16))
#: the moe family's runs, as DENSE_RUNS: OLMoE-1B-7B whole; Grok-1-314B
#: (~9.7 GB a layer in bf16) at full width with 2 of its 64 layers, which
#: covers its logit softcap and its 8 experts of width 32768
MOE_RUNS = (("olmoe_1b_7b", None, 2, 1024, 1024 + 32, 32),
            ("grok_1_314b", 2, 2, 512, 512 + 16, 16))


#: the encdec and vlm families' runs, as DENSE_RUNS: Whisper-tiny whole
#: (4 decoder and 4 encoder layers; 4 x 224 into a ring of 256, frames
#: [4, 1500, 384]); Llama-3.2-Vision-11B whole (32 self and 8 cross
#: layers, ~20 GB in bf16; 2 x 512, image tokens [2, 6400, 4096])
ENCDEC_RUNS = (("whisper_tiny", None, 4, 224, 256, 32),)
VLM_RUNS = (("llama_3_2_vision_11b", None, 2, 512, 512 + 16, 16),)

#: attention calls of one layer of each kind (a Whisper decoder layer
#: attends to itself and to the encoder's output)
ATTENTION_CALLS = {"layer": 1, "moe_layer": 1, "attn": 1, "self": 1,
                   "cross": 1, "dec": 2}


def attention_launches(cfg, steps: int) -> dict:
    """The attention kernels' launches of one prefill and ``steps`` decode
    steps: flash once an attention call of a layer and once an encoder
    layer, decode once an attention call of a layer a step."""
    calls = sum(ATTENTION_CALLS.get(k, 0) for k in _layer_kinds(cfg))
    return {"flash_attention": calls + cfg.num_encoder_layers,
            "paged_decode_attention": calls * steps}


def _family_serve(family: str, runs, dev, **kw) -> dict:
    """Each run of ``runs`` through ``_serve`` (its depth cut recorded),
    with the attention launches ``attention_launches`` says (flash =
    layers and decode = layers x steps for dense and moe); the launches
    summed over the runs."""
    out, total = {}, {}
    for arch, layers, batch, prompt, seq_len, steps in runs:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(
            full, num_layers=layers)
        res = _serve(cfg, dev, batch=batch, prompt=prompt, seq_len=seq_len,
                     tol=SERVE_F32_TOL[family], steps=steps, **kw)
        want = {"rg_lru": 0, **attention_launches(cfg, steps), "mlstm": 0}
        check(res["launches"] == want,
              f"{arch} launches {res['launches']} != {want}")
        res["layers"] = dict(run=cfg.num_layers, config=full.num_layers)
        out[arch] = res
        for k, n in res["launches"].items():
            total[k] = total.get(k, 0) + n
    return dict(runs=out, launches=total)


def phase_dense_serve(dev=DEV, runs=DENSE_RUNS) -> dict:
    """H2O-Danube-1.8B, Granite-3-8B and Qwen1.5-110B (4 layers) at full
    width through the kernels, each rerun in float32."""
    return _family_serve("dense", runs, dev)


def phase_moe_serve(dev=DEV, runs=MOE_RUNS) -> dict:
    """OLMoE-1B-7B and Grok-1-314B (2 layers) at full width through the
    kernels, each rerun in float32 with its routing flips counted and the
    floor of a plain run whose router logits are float64."""
    return _family_serve(
        "moe", runs, dev, routing=True,
        floor=("router logits in float64", lambda: mock.patch.object(
            MOE, "_router_logits", _router_f64)))


def phase_encdec_serve(dev=DEV, runs=ENCDEC_RUNS) -> dict:
    """Whisper-tiny whole through the kernels (the encoder's bidirectional
    flash, the decoder's causal flash and cross flash over 1500 frames,
    decode over the ring and over the frames as one page), rerun in
    float32; biases drawn non-zero (``liven``)."""
    return _family_serve("encdec", runs, dev)


def phase_vlm_serve(dev=DEV, runs=VLM_RUNS) -> dict:
    """Llama-3.2-Vision-11B whole through the kernels (cross flash and
    decode over 6400 image tokens), rerun in float32; the cross gates
    drawn with |tanh| in GATE_TANH (``liven``)."""
    return _family_serve("vlm", runs, dev)


# ---------------------------------------------------------------------------
# training (no kernel: the plain versions under autograd)
# ---------------------------------------------------------------------------

#: part a: Qwen3-1.7B whole (28 x 2048, vocab 151,936, tied), bf16, remat
TRAIN_FULL = dict(seq_len=256, global_batch=8, n_chains=2, steps=4,
                  microbatches=2, lr=3e-4, warmup_steps=2)
#: part b: full width, 2 layers, float32, one batch of 2 x 128
TRAIN_CPU_CUT = dict(layers=2, batch=2, seq_len=128)
#: part c: every arch reduced, float32, one batch of 2 x 40 (past
#: Danube's reduced window of 32 and the hybrid's local window of 16)
TRAIN_ARCH = dict(batch=2, seq_len=40)
#: card against CPU: loss, ce and zloss within rtol LOSS_RTOL, the grad
#: norm within GNORM_RTOL, and each gradient leaf within LEAF_TOL of that
#: leaf's max |g| (float32 both; the two sum in other orders)
LOSS_RTOL, GNORM_RTOL, LEAF_TOL = 1e-5, 1e-4, 1e-4
#: part d: the example's loop
TRAIN_LOOP = dict(steps=300, fail_at=100, checkpoint_every=50,
                  microbatches=2, window=20, drop=0.5)
#: part e: the tiny config's restart equality
TRAIN_RESTART = dict(seq_len=32, global_batch=4, steps=12,
                     checkpoint_every=4, fail_at=6, rel=1e-6)


def _cpu_weights(cfg, seed=0, live=False) -> dict:
    """Seed-``seed`` weights of ``cfg`` drawn on the CPU (so every device
    starts from the same ones), the gates and ungated biases drawn
    non-zero with ``live``."""
    state = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(seed))
    if live:
        liven(state)
    return state


def _train_setup(cfg, dev, ocfg, state):
    """A model of ``cfg`` on ``dev`` with the weights ``state``, its params
    dict, optimizer state and train step."""
    model = build_model(cfg, dev)
    params = {k: v.to(dev) for k, v in state.items()}
    model.load_params(params)
    return (model, params, init_opt_state(params, ocfg),
            make_train_step(model, ocfg))


def _card_vs_cpu(cfg, ocfg, batch, live=False) -> dict:
    """The same first ``make_train_step`` on the card and on the CPU, from
    the same weights and batch: the metrics, and every gradient leaf as
    the first moment holds it (m = (1 - b1) · clip · g after one step)."""
    state = _cpu_weights(cfg, live=live)
    out = []
    for dev in (DEV, torch.device("cpu")):
        _, params, opt, step = _train_setup(cfg, dev, ocfg, state)
        reset_launches()
        t0 = time.perf_counter()
        _, opt, met = step(params, opt, {k: v.to(dev)
                                         for k, v in batch.items()})
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    {k: float(v) for k, v in met.items()},
                    {k: v.cpu() for k, v in opt["m"].items()},
                    launches_of()))
        del params, opt
    (card_s, card, cm, launches), (cpu_s, cpu, pm, _) = out
    for k in ("loss", "ce", "zloss", "aux_loss"):
        check(abs(card[k] - cpu[k]) <= LOSS_RTOL * abs(cpu[k]) + 1e-7,
              f"{cfg.name}: {k} card {card[k]} cpu {cpu[k]}")
    check(abs(card["grad_norm"] - cpu["grad_norm"])
          <= GNORM_RTOL * cpu["grad_norm"],
          f"{cfg.name}: grad norm card {card['grad_norm']} cpu "
          f"{cpu['grad_norm']}")
    worst, worst_leaf = 0.0, None
    for k, ref in pm.items():
        scale = float(ref.abs().max())
        share = float((cm[k] - ref).abs().max()) / max(scale, 1e-30)
        if share > worst:
            worst, worst_leaf = share, k
    check(worst <= LEAF_TOL, f"{cfg.name}: gradient leaf {worst_leaf} "
          f"off by {worst} of its max |g|")
    check(sum(launches.values()) == 0,
          f"{cfg.name}: train step launched kernels {launches}")
    return dict(card_s=card_s, cpu_s=cpu_s,
                loss=(card["loss"], cpu["loss"]),
                grad_norm=(card["grad_norm"], cpu["grad_norm"]),
                leaf_err_share=worst, worst_leaf=worst_leaf,
                aux_loss=card["aux_loss"], launches=launches)


def _train_full(dev) -> dict:
    """Part a: Qwen3-1.7B whole, bf16, remat, 2 microbatches, 4 steps."""
    p = TRAIN_FULL
    cfg = get_config("qwen3_1_7b")
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.tie_embeddings,
          "qwen3_1_7b is not the bf16 remat tied config")
    ocfg = OptimizerConfig(lr=p["lr"], warmup_steps=p["warmup_steps"],
                           total_steps=p["steps"])
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=p["seq_len"],
                                global_batch=p["global_batch"],
                                n_chains=p["n_chains"]))
    model = build_model(cfg, dev)
    params = {k: v.detach() for k, v in model.init_params(
        torch.Generator(dev).manual_seed(0)).items()}
    opt = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg, microbatches=p["microbatches"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ms, hist = [], []
    for i in range(p["steps"]):
        batch = ds.get_batch(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, met = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        hist.append({k: float(v) for k, v in met.items()})
    launches = launches_of()
    check(sum(launches.values()) == 0,
          f"full-width train steps launched kernels {launches}")
    for i, m in enumerate(hist):
        check(all(np.isfinite(v) for v in m.values()),
              f"step {i}: metrics not finite {m}")
    tokens = p["seq_len"] * p["global_batch"]
    step_ms = float(np.mean(ms[1:]))
    n = cfg.num_params
    n_embed = cfg.padded_vocab * cfg.d_model
    flops = 6 * n * tokens
    return dict(
        arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, dtype=cfg.dtype, remat=cfg.remat,
        microbatches=p["microbatches"], seq_len=p["seq_len"],
        global_batch=p["global_batch"], params=n, step_ms=ms,
        ms_a_step=step_ms, steps_timed="2-4 (CUDA events around each)",
        tokens_per_s=tokens / step_ms * 1e3,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        model_flops_a_step=flops, bf16_peak_flops=BF16_OPS_PER_S,
        bf16_peak="H100 SXM dense bf16, 989 TFLOP/s (NVIDIA data sheet)",
        mfu=flops / (step_ms / 1e3) / BF16_OPS_PER_S,
        mfu_no_embed=6 * (n - n_embed) * tokens / (step_ms / 1e3)
        / BF16_OPS_PER_S,
        losses=[m["loss"] for m in hist],
        grad_norms=[m["grad_norm"] for m in hist], launches=launches)


def _train_cut(dev) -> dict:
    """Part b: full width, 2 layers, float32, card against CPU."""
    p = TRAIN_CPU_CUT
    cfg = dataclasses.replace(get_config("qwen3_1_7b"),
                              num_layers=p["layers"], dtype="float32")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=4)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=p["seq_len"],
                                   global_batch=p["batch"])).get_batch(0)
    tokens = torch.from_numpy(batch["tokens"])
    res = _card_vs_cpu(cfg, ocfg, {"tokens": tokens})
    return dict(res, arch=cfg.name, layers=cfg.num_layers,
                d_model=cfg.d_model, vocab=cfg.vocab_size, dtype=cfg.dtype,
                batch=p["batch"], seq_len=p["seq_len"])


def _train_archs(dev) -> dict:
    """Part c: every arch reduced, float32, one step on card and CPU."""
    from repro_torch.configs.base import ARCH_IDS
    p = TRAIN_ARCH
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced(dtype="float32")
        batch = {"tokens": torch.from_numpy(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=p["seq_len"],
            global_batch=p["batch"], seed=1)).get_batch(0)["tokens"]),
                 **{k: v.cpu() for k, v in memory_inputs(
                     cfg, p["batch"], torch.device("cpu")).items()}}
        out[arch] = _card_vs_cpu(cfg, ocfg, batch, live=True)
        if cfg.family == "moe":
            check(out[arch]["aux_loss"] > 0, f"{arch}: no aux loss")
    return out


def _example_module():
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / \
        "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_loop(dev, ckpt_root) -> dict:
    """Part d: ``examples/torch_train_100m.py``'s loop (the ~100M config)
    on the card, a failure injected at step 100, checkpoints every 50."""
    p = TRAIN_LOOP
    ex = _example_module()
    reset_launches()
    out = ex.train(p["steps"], device=dev,
                   ckpt_dir=Path(ckpt_root) / "train100m",
                   fail_at=p["fail_at"], microbatches=p["microbatches"],
                   checkpoint_every=p["checkpoint_every"],
                   log=lambda *a: None)
    res, losses = out["result"], out["losses"]
    launches = launches_of()
    check(res.restarts == 1, f"train loop restarted {res.restarts} times, "
          "1 failure was injected")
    check(res.final_step == p["steps"] and len(losses) == p["steps"],
          f"train loop ended at {res.final_step} after {len(losses)} steps")
    check(all(np.isfinite(losses)), "train loop loss not finite")
    w = p["window"]
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    check(last <= first - p["drop"],
          f"loss fell from {first} to {last}, less than {p['drop']}")
    check(sum(launches.values()) == 0,
          f"train loop launched kernels {launches}")
    return dict(params=out["cfg"].num_params, steps=p["steps"],
                restarts=res.restarts, wall_s=out["wall_s"],
                s_a_step=out["wall_s"] / len(losses),
                tokens_per_step=out["tokens_per_step"],
                first_mean_loss=first, last_mean_loss=last,
                straggler_events=res.straggler_events,
                launches=launches)


def _train_restart(dev, ckpt_root) -> dict:
    """Part e: the tiny config, 12 steps with a checkpoint every 4: a run
    with a failure at step 6 and an uninterrupted run end at the same
    loss (rel 1e-6), with deterministic algorithms on for this part only
    (CUDA's embedding backward and scatters add with atomics; cuBLAS
    needs ``CUBLAS_WORKSPACE_CONFIG``, which this script sets before CUDA
    starts)."""
    p = TRAIN_RESTART
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                seq_len=p["seq_len"],
                                global_batch=p["global_batch"], n_chains=1))
    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        state = _cpu_weights(cfg)
        for name, fail in (("failed", (p["fail_at"],)), ("clean", ())):
            _, params, opt, step = _train_setup(cfg, dev, ocfg, state)
            ck = CheckpointManager(str(Path(ckpt_root) / f"restart_{name}"),
                                   keep=3, async_save=False)
            runs[name] = run_fault_tolerant(
                step, params, opt, ds.iterator(), ckpt=ck,
                total_steps=p["steps"],
                checkpoint_every=p["checkpoint_every"],
                injector=FailureInjector(fail_at=fail))
    finally:
        torch.use_deterministic_algorithms(False)
    r1, r2 = runs["failed"], runs["clean"]
    check(r1.restarts == 1 and r2.restarts == 0,
          f"restarts {r1.restarts}, {r2.restarts}: want 1, 0")
    l1 = r1.metrics_history[-1]["loss"]
    l2 = r2.metrics_history[-1]["loss"]
    check(abs(l1 - l2) <= p["rel"] * abs(l2),
          f"restart loss {l1} against uninterrupted {l2}")
    return dict(restarts=[r1.restarts, r2.restarts], final_loss=[l1, l2],
                rel_diff=abs(l1 - l2) / abs(l2))


def phase_train(dev=DEV) -> dict:
    """The training path on the card through the plain versions (the
    Hopper kernels have no backward, and no kernel may launch): a.
    Qwen3-1.7B whole in bf16 with remat and 2 microbatches, 4 steps, the
    step's time, tokens/s, peak memory and model-FLOPs share of the bf16
    peak; b. full width at 2 layers in float32, one step on the card and
    on the CPU; c. every arch reduced, the same; d. the example's
    300-step loop with an injected failure, checkpoints and straggler
    detection; e. restart equality on the tiny config. One line each;
    returns each part's seconds."""
    import tempfile
    seconds = {}
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as root:
        for part, fn in (("a", lambda: _train_full(dev)),
                         ("b", lambda: _train_cut(dev)),
                         ("c", lambda: _train_archs(dev)),
                         ("d", lambda: _train_loop(dev, root)),
                         ("e", lambda: _train_restart(dev, root))):
            t0 = time.perf_counter()
            res = fn()
            seconds[part] = time.perf_counter() - t0
            emit(f"train.{part}", seconds=seconds[part], **res)
            gc.collect()
            torch.cuda.empty_cache()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 was switched on: float32 products would be TF32")
    return dict(parts=seconds)


# ---------------------------------------------------------------------------
# the dry run: production cells on meta meshes, two cells on the card
# ---------------------------------------------------------------------------

#: part a, in a child process: (arch, shape, multi_pod)
DRYRUN_CELLS = ([(a, s, mp) for a in ARCH_IDS
                 for s in ("decode_32k", "long_500k") for mp in (False, True)]
                + [("whisper_tiny", "train_4k", False),
                   ("qwen3_1_7b", "prefill_32k", False)])
#: part b: Qwen3-1.7B's train step at 4 x 256 and a decode token at 32,768
#: positions with the batch cut from 128 to 4, each on a (1, 1) mesh
DRYRUN_TRAIN = ShapeConfig("train_card", 256, 4, "train")
DRYRUN_DECODE = ShapeConfig("decode_32k", 32768, 4, "decode")
#: the card's peak over the train step against the report's argument +
#: temp bytes: within this share of the report
DRYRUN_MEM_BAND = 0.10


def _dryrun_cells(out) -> None:
    """In a child process: every cell of ``DRYRUN_CELLS`` through
    ``dryrun.run_cell`` on the meta meshes; puts each cell's summary on
    ``out`` (or the error, with its traceback)."""
    sys.stdout = sys.stderr     # the parent's stdout carries the JSON lines
    try:
        cells = []
        for arch, shape, mp in DRYRUN_CELLS:
            r = DR.run_cell(arch, shape, mp)
            row = dict(arch=arch, shape=shape, mesh=r["mesh"],
                       status=r["status"])
            if r["status"] == "ok":
                m, ro = r["memory"], r["roofline"]
                row.update(trace_s=r["trace_s"], n_devices=r["n_devices"],
                           per_device_gb=m["per_device_live_bytes"] / 1e9,
                           fits_80gb=m["fits_80gb"],
                           dominant=ro["dominant"],
                           roofline_fraction=ro["roofline_fraction"])
            else:
                row["reason"] = r["reason"]
            cells.append(row)
        out.put(dict(cells=cells))
    except BaseException:
        import traceback
        out.put(dict(error=traceback.format_exc()))
        raise


def start_dryrun_cells() -> tuple:
    """``_dryrun_cells`` in a child process, for ``phase_dryrun``."""
    return start_child(_dryrun_cells)


def _child_result(child, what: str) -> dict:
    """Wait for a child's result; fails if it raised or died."""
    proc, out = child
    while True:
        try:
            res = out.get(timeout=5)
            break
        except queue.Empty:
            check(proc.is_alive() or not out.empty(),
                  f"{what}'s process ended ({proc.exitcode}) with no result")
    proc.join(60)
    check("error" not in res, f"{what} failed:\n{res.get('error')}")
    return res


def _meta_report(cfg, shape) -> dict:
    """The dry run's report of ``cfg`` at ``shape`` on a (1, 1) mesh of
    meta devices."""
    return DR.run_cell(cfg.name, shape.name, False, cfg=cfg, shape=shape,
                       mesh=make_local_mesh(1, 1, device="meta"))


def _tree_bytes(*trees) -> int:
    return sum(HA.nbytes(t) for tree in trees for t in DR.leaves(tree))


def _dryrun_train(dev) -> dict:
    """Part b, train: the report's figures against the card's step."""
    cfg, shape = get_config("qwen3_1_7b"), DRYRUN_TRAIN
    rep = _meta_report(cfg, shape)
    model = build_model(cfg, dev)
    params = {k: v.detach() for k, v in model.init_params(
        torch.Generator(dev).manual_seed(0)).items()}
    opt = init_opt_state(params, DR._opt_cfg(cfg))
    gen = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (
        shape.global_batch, shape.seq_len), generator=gen, device=dev,
        dtype=torch.int32)}
    step = DR.cell_step(model, shape)
    args_b = _tree_bytes(params, opt, batch)
    check(args_b == rep["memory"]["argument_bytes"],
          f"train: {args_b} argument bytes on the card, the report has "
          f"{rep['memory']['argument_bytes']}")
    reset_launches()
    out = step(params, opt, batch)            # cuBLAS and allocator warm-up
    del out
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with HA.OpCounter("cuda") as counter:
        out = step(params, opt, batch)
    torch.cuda.synchronize()
    card_temp = torch.cuda.max_memory_allocated() - base
    loss = float(out[2]["loss"])
    del out
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        del out
    launches = launches_of()
    check(sum(launches.values()) == 0, f"train cell launched {launches}")
    check(np.isfinite(loss), f"train cell loss {loss}")
    dot = counter.summary.dot_flops
    want = rep["hlo"]["dot_flops_per_dev"]
    check(dot == want, f"train: {dot} dot FLOPs on the card, the report "
          f"has {want}")
    rep_live = rep["memory"]["per_device_live_bytes"]
    card_live = args_b + card_temp
    share = abs(card_live - rep_live) / rep_live
    check(share <= DRYRUN_MEM_BAND,
          f"train: card peak {card_live} against the report's {rep_live} "
          f"({share:.3f} off, band {DRYRUN_MEM_BAND})")
    ro = rep["roofline"]
    bound_ms = max(ro["compute_s"], ro["memory_s"]) * 1e3
    check(min(ms) >= bound_ms, f"train step {min(ms)} ms under the "
          f"roofline's {bound_ms} ms")
    return dict(arch=cfg.name, seq_len=shape.seq_len,
                batch=shape.global_batch, dtype=cfg.dtype,
                argument_bytes=args_b, report_temp_bytes=rep["memory"][
                    "temp_bytes"], card_temp_bytes=card_temp,
                report_live_bytes=rep_live, card_live_bytes=card_live,
                live_share_off=share, dot_flops=dot,
                card_ops=counter.summary.n_ops, meta_ops=rep["hlo"]["n_ops"],
                card_mem_bytes=counter.summary.mem_bytes,
                report_mem_bytes=rep["hlo"]["mem_bytes_per_dev"],
                step_ms=ms, roofline=ro, bound_ms=bound_ms,
                trace_s=rep["trace_s"], loss=loss)


def _dryrun_decode(dev) -> dict:
    """Part b, decode: one token over the filled cache through the paged
    decode kernel, against the plain version, in float32."""
    cfg = dataclasses.replace(get_config("qwen3_1_7b"), dtype="float32")
    shape = DRYRUN_DECODE
    rep = _meta_report(cfg, shape)
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(dev).manual_seed(0))
    params = dict(model.named_parameters())
    gen = torch.Generator(dev).manual_seed(2)
    cache = model.init_cache(shape.global_batch, shape, filled=True)
    for leaf in DR.leaves(cache["stack"]):
        leaf.normal_(generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (
        shape.global_batch, 1), generator=gen, device=dev,
        dtype=torch.int32)}
    args_b = _tree_bytes(params, batch, cache)
    check(args_b == rep["memory"]["argument_bytes"],
          f"decode: {args_b} input bytes on the card, the report has "
          f"{rep['memory']['argument_bytes']}")
    step = DR.cell_step(model, shape)
    torch.cuda.synchronize()
    reset_launches()
    logits, _ = step(params, batch, cache)
    torch.cuda.synchronize()
    launches = launches_of()
    want = rep["hlo"]["kernels"].get("paged_decode_attention", 0)
    check(launches["paged_decode_attention"] == want == cfg.num_layers
          and sum(launches.values()) == want,
          f"decode: launches {launches}, the report counted {want}")
    # the token's K/V land in the same ring slot in every run, before any
    # layer reads the ring: each run sees its own, as from a fresh cache
    ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, batch, cache)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    model.backend = "ref"
    try:
        plain, _ = step(params, batch, cache)
    finally:
        model.backend = "auto"
    tol = SERVE_F32_TOL["dense"]
    a, b = logits.float(), plain.float()
    share = float(((a - b).abs() / (tol * (1 + b.abs()))).max())
    check(bool(torch.isfinite(a).all()) and share <= 1.0,
          f"decode: logits {share} of the tolerance off the plain version")
    return dict(arch=cfg.name, positions=shape.seq_len,
                batch=shape.global_batch, dtype=cfg.dtype,
                argument_bytes=args_b, cache_bytes=_tree_bytes(cache),
                launches=launches, max_abs_err=float((a - b).abs().max()),
                tol_share=share, step_ms=ms, roofline=rep["roofline"],
                trace_s=rep["trace_s"], max_memory_allocated_gb=(
                    torch.cuda.max_memory_allocated() / 1e9))


def phase_dryrun(child=None, dev=DEV) -> dict:
    """a. the production cells of ``DRYRUN_CELLS`` from the child process
    ``child`` (``start_dryrun_cells``; started here if None): skips as
    ``shape_applicable`` says, the others ok; b. the two card cells.
    Returns the cells, both card parts and the decode part's launches."""
    if child is None:
        child = start_dryrun_cells()
    out = {}
    for part, fn in (("train", _dryrun_train), ("decode", _dryrun_decode)):
        t0 = time.perf_counter()
        out[part] = fn(dev)
        emit(f"dryrun.{part}", seconds=time.perf_counter() - t0, **out[part])
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cells = _child_result(child, "the dry run's cells")["cells"]
    for c in cells:
        ok, reason = shape_applicable(get_config(c["arch"]),
                                      SHAPES[c["shape"]])
        check(c["status"] == ("ok" if ok else "skipped")
              and c.get("reason", "") == reason,
              f"dry run {c['arch']} {c['shape']} {c['mesh']}: {c['status']}"
              f" {c.get('reason', '')}")
    emit("dryrun.cells", wait_s=time.perf_counter() - t0, cells=cells)
    return dict(train=out["train"], decode=out["decode"], cells=len(cells),
                skipped=sum(c["status"] == "skipped" for c in cells),
                launches=out["decode"]["launches"])


def _layer_kinds(cfg) -> list:
    """Block kind of each of ``cfg``'s layers, in execution order."""
    from repro_torch.models.model import _stackdef
    from repro_torch.models.stack import layer_kinds
    return layer_kinds(_stackdef(cfg))


def bound(meas: dict, ops_per_s: float) -> dict:
    """The least time for the work: bytes over HBM bandwidth or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes = meas["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = meas["ops"] / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def run_phases(paper, dry) -> dict:
    """Every phase after the build, in order, one JSON line each; returns
    their results. ``paper`` is PAPER_SERVING's child process
    (``start_paper_serving``), which ``phase_serving_sim`` reads, and
    ``dry`` the dry run's (``start_dryrun_cells``), which
    ``phase_dryrun`` reads."""
    results = {}
    for phase, fn in (("wave_queue", phase_wave_queue),
                      ("wave_cache", phase_wave_cache),
                      ("golden", phase_golden), ("scale", phase_scale),
                      ("event", phase_event), ("fig7", phase_fig7),
                      ("tracegen", phase_tracegen),
                      ("wave1", phase_wave1), ("api", phase_api),
                      ("sharded", phase_sharded),
                      ("medic_gather", phase_medic_gather),
                      ("decode_attention", phase_decode_attention),
                      ("flash_attention", phase_flash_attention),
                      ("serving", phase_serving),
                      ("serving_sim", lambda: phase_serving_sim(paper)),
                      ("serving_profile", phase_serving_profile),
                      ("rg_lru", phase_rg_lru), ("mlstm", phase_mlstm),
                      ("hybrid_serve", phase_hybrid_serve),
                      ("ssm_serve", phase_ssm_serve),
                      ("dense_serve", phase_dense_serve),
                      ("moe_serve", phase_moe_serve),
                      ("encdec_serve", phase_encdec_serve),
                      ("vlm_serve", phase_vlm_serve),
                      ("train", phase_train),
                      ("dryrun", lambda: phase_dryrun(dry))):
        t0 = time.perf_counter()
        results[phase] = fn()
        emit(phase, seconds=time.perf_counter() - t0, **results[phase])
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    # float32 products in full float32 (the plain versions and the reruns)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, torch_name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = _build.build_all(sorted(set(SOURCES.values())))
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
                for k, v in built.items()})

    # the card sits idle through PAPER_SERVING (host numpy, minutes) and
    # the dry run's meta cells (host only): each runs in a child process
    # beside the phases before its own
    children = (start_paper_serving(DEV), start_dryrun_cells())
    try:
        results = run_phases(*children)
    finally:
        for proc, _ in children:
            if proc.is_alive():
                proc.terminate()
            proc.join()

    # launches of each kernel on its main paths: the wavefront kernels in
    # HAMMER2K x 4 policies, the serving kernels in the full-width A/B, the
    # attention kernels also in the hybrid, dense, moe, encdec and vlm runs,
    # rg_lru in the hybrid run, mlstm in the ssm run, decode in the dry
    # run's card cell (each run counted from 0)
    paths = {"HAMMER2K": results["scale"]["HAMMER2K"]["launches"],
             "STRESS": results["api"]["stress"]["launches"],
             "fig7_quick": {"event_loop": results["fig7"]["launches"]},
             "paper_fig7": {"event_loop":
                            results["fig7"]["paper_fig7"]["launches"]},
             "sharded": results["sharded"]["launches"],
             "serving": results["serving"]["launches"],
             "hybrid_serve": results["hybrid_serve"]["launches"],
             "ssm_serve": results["ssm_serve"]["launches"],
             "dense_serve": results["dense_serve"]["launches"],
             "moe_serve": results["moe_serve"]["launches"],
             "encdec_serve": results["encdec_serve"]["launches"],
             "vlm_serve": results["vlm_serve"]["launches"],
             "dryrun": results["dryrun"]["launches"]}
    measured = {"wave_queue": (results["wave_queue"], F32_OPS_PER_S),
                "wave_cache": (results["wave_cache"], F32_OPS_PER_S),
                "medic_gather": (results["medic_gather"], BF16_OPS_PER_S),
                "paged_decode_attention": (results["decode_attention"],
                                           BF16_OPS_PER_S),
                "flash_attention": (results["flash_attention"],
                                    BF16_OPS_PER_S),
                "rg_lru": (results["rg_lru"], F32_OPS_PER_S),
                "mlstm": (results["mlstm"], F32_OPS_PER_S)}
    rows = []
    for kname, (meas, peak) in measured.items():
        by_path = {p: c[kname] for p, c in paths.items() if c.get(kname)}
        launches = sum(by_path.values())
        check(launches > 0, f"{kname} never launched on its main path")
        row = dict(
            name=kname, **KERNELS[kname], launches=launches,
            max_abs_err=meas["max_abs_err"], ms=meas["ms"],
            device_ms=meas["device_ms"], plain_ms=meas["plain_ms"],
            **bound(meas, peak), library_ms=meas.get("library_ms"),
            library_device_ms=meas.get("library_device_ms"),
            launches_by_path=by_path)
        for extra in ("n_split", "pools_ms", "pools_device_ms", "resident",
                      "global_ms", "global_device_ms", "ms_rounds",
                      "library_ms_rounds", "queued_ms", "bound_tf32_ms",
                      "bound_bytes_ms", "n16384", "n262144", "b16384"):
            if extra in meas:
                row[extra] = meas[extra]
        if "hybrid" in meas:   # the attention kernels at the hybrid's shape
            h = meas["hybrid"]
            row["hybrid"] = dict(ms=h["ms"], device_ms=h["device_ms"],
                                 plain_ms=h["plain_ms"],
                                 library_ms=h["library_ms"],
                                 library_device_ms=h["library_device_ms"],
                                 **bound(h, BF16_OPS_PER_S))
            if "n_split" in h:
                row["hybrid"]["n_split"] = h["n_split"]
        rows.append(row)
    # the port-side event loop: its bound is the dependent chain of its
    # request steps (chain_bound_ms), far above the byte and operation
    # bounds; no single PyTorch call computes the loop
    ev = results["event"]
    by_path = {p: c["event_loop"] for p, c in paths.items()
               if c.get("event_loop")}
    check(sum(by_path.values()) > 0, "event_loop never launched on fig7")
    rows.append(dict(
        name="event_loop", **PORT_KERNELS["event_loop"],
        launches=sum(by_path.values()), max_abs_err=ev["max_abs_err"],
        ms=ev["ms"], device_ms=ev["device_ms"], plain_ms=ev["plain_ms"],
        **bound(ev, F32_OPS_PER_S), library_ms=None,
        library_device_ms=None, launches_by_path=by_path,
        chain_bound_ms=ev["chain_bound_ms"],
        chain=dict(accesses_a_step=CHAIN_ACCESSES,
                   smem_latency_cycles=SMEM_LATENCY_CYCLES,
                   steps_a_block=ev["quick"]["steps_per_block"],
                   sm_clock_hz=sm_clock_hz()),
        blocks=ev["quick"]["blocks"], plain_shape=ev["plain_shape"],
        full=dict(blocks=ev["full"]["blocks"], ms=ev["full"]["ms"],
                  device_ms=ev["full"]["device_ms"],
                  chain_bound_ms=ev["full"]["chain_bound_ms"],
                  **bound(ev["full"], F32_OPS_PER_S))))
    # the port-side sampler: bound by its bytes (integer work); no PyTorch
    # call computes the draws
    tg = results["tracegen"]
    rows.append(dict(
        name="tracegen", **PORT_KERNELS["tracegen"], launches=tg["launches"],
        max_abs_err=tg["max_abs_err"], ms=tg["ms"],
        device_ms=tg["device_ms"], plain_ms=tg["plain_ms"],
        **bound(tg, F32_OPS_PER_S), library_ms=None,
        library_device_ms=None,
        launches_by_path={"paper_fig7": tg["launches"]},
        copy_ms=tg["copy_ms"], cells=tg["cells"], fig7=tg["fig7"]))
    check(set(KERNELS) | set(PORT_KERNELS) == {r["name"] for r in rows}
          and not TO_PORT, "a Pallas kernel of the reference has no row")
    print(json.dumps({"kernels": rows, "to_port": TO_PORT}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
