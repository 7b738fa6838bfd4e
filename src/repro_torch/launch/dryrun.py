"""Multi-pod dry run (the port of ``repro.launch.dryrun``): every (arch ×
shape × mesh) cell, its per-device memory, FLOPs, traffic and collectives,
and a roofline on the H100.

The reference lowers and compiles each cell's step with XLA on 512
virtual host devices and reads the compiled program. The port has no
compiler to ask; it runs the step once, at the global shape, on the
``meta`` device (shapes and dtypes, no data), under ``sharding_ctx`` of
a production mesh of meta devices (``make_production_mesh(device=
"meta")``), and counts the dispatched operations (``hlo_analysis``):

  * the step is the reference's: ``make_train_step`` with ``_opt_cfg``'s
    moments (train), ``prefill`` over the filled cache, or one ``decode``
    token over ``init_cache(filled=True)``. The model's kernels take their
    card route (``kernels._build.meta_launch``), so the stream is the
    card's: in training the plain versions (no kernel has a backward), in
    serving the flash, paged-decode, RG-LRU and mLSTM kernels. Under the
    context the MoE's grouped dispatch sees the mesh's batch groups, and
    every ``shard_act`` resolves its spec, as in the reference.

What is exact, per device: ``memory.argument_bytes`` (each parameter,
optimizer-state, batch and cache leaf's shard under its spec from the
logical-axis trees, over the leaves the step reads, as XLA drops the
others), ``status`` and the skip reasons, ``n_devices`` and
``model_flops_global``. The kernels' route differs from the reference's
program in one count: its attention below 1024 positions is
``attention_full``, every (query, key) pair, where the flash kernel
counts only the pairs its mask leaves; a model built with
``backend="ref"`` runs the plain versions and counts the reference's.

What is an even split of the global count: ``dot_flops_per_dev`` and
``mem_bytes_per_dev`` (÷ ``n_devices``), and ``temp_bytes`` (the step's
peak of live temporaries ÷ the batch's shards; ``temp_bytes_min`` ÷
``n_devices``). On a mesh whose model axis is 1 the FLOPs and traffic
equal XLA's partitioned counts; with a model axis of more than 1 they are
a lower bound, since XLA replicates work that a head or width count does
not divide. Activations split over the model axis too (``seq_sp``,
``heads``, ``mlp``, ``vocab``), so there ``temp_bytes`` is an upper
bound and ``temp_bytes_min`` a lower one; ``fits_80gb`` reads the upper.

Collectives come from the parameter plan: the all-gather of each
``data``-sharded parameter in the forward pass (again in the backward
pass under remat), the reduce-scatter of its gradient, and the gradient
all-reduce over the batch axes that do not shard it (the ``pod``
all-reduce on the multi-pod mesh), each with its group size. The
collectives XLA's partitioner adds between activations (tensor-parallel
all-reduces, the MoE's exchanges) are not modeled.

Of the reference's record the port drops ``lower_s`` and ``compile_s``
(one ``trace_s`` instead), ``output_bytes`` and ``alias_bytes`` (XLA's
buffer assignment), ``cost_analysis_raw``, ``mem_bytes_upper_per_dev``,
``loop_ratio``, ``n_while`` and ``trip_counts`` (see ``hlo_analysis``),
and adds ``temp_bytes_min``, ``n_ops`` and ``kernels`` (launches by
kernel).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      OptimizerConfig, ShapeConfig,
                                      get_config, shape_applicable)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.hlo_analysis import nbytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import init_opt_state, make_train_step
from repro_torch.sharding import (Logical, Mesh, build_rules, norm_axes,
                                  sharding_ctx, sharding_for, tree_map,
                                  tree_shardings)

HW = {  # NVIDIA H100 SXM5 80GB, from NVIDIA's datasheet
    "peak_flops_bf16": 989e12,     # dense bf16 on the tensor cores
    "hbm_bw": 3.35e12,             # HBM3
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,            # NVLink 4, each direction, within a node
    "net_bw": 50e9,                # InfiniBand NDR, 400 Gb/s a card
    "node_cards": 8,               # cards an NVLink node holds (HGX H100)
}

BATCH_AXES = ("pod", "data")


def _opt_cfg(cfg: ModelConfig) -> OptimizerConfig:
    # bf16 moments for >20B-param models: the optimizer-state lever that
    # fits grok-1-314b / qwen1.5-110b training on a 256-card pod
    big = cfg.num_params > 20e9
    return OptimizerConfig(moment_dtype="bfloat16" if big else "float32")


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


@dataclasses.dataclass
class Cell:
    """One cell's step and its arguments: ``fn(*args)`` runs it; ``logical``
    holds the arguments' logical-axis trees, in the same order."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    rules: Dict[str, Any]
    fn: Any
    args: tuple
    logical: tuple


def cell_step(model, shape: ShapeConfig):
    """The step of a ``shape.kind`` cell: ``train(params, opt_state,
    batch)``, ``prefill(params, batch, cache)`` or ``decode(params,
    batch, cache)`` (the batch holds the one new token). The serving steps
    read the model's own parameters, which ``params`` must be."""
    if shape.kind == "train":
        return make_train_step(model, _opt_cfg(model.cfg))
    if shape.kind == "prefill":
        return lambda params, batch, cache: model.prefill(batch, cache)
    return lambda params, batch, cache: model.decode(batch["tokens"], cache)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Cell:
    """The cell's step on meta tensors at the global shape."""
    model = build_model(cfg, "meta")
    params = {k: p.detach() for k, p in model.named_parameters()}
    plog = model.logical_params()
    batch = model.input_specs(shape)
    blog = model.batch_logical(shape)
    if shape.kind == "train":
        ocfg = _opt_cfg(cfg)
        opt = init_opt_state(params, ocfg)
        olog = {"m": plog, "v": plog, "count": Logical()}
        if "err" in opt:
            olog["err"] = plog
        args, logical = (params, opt, batch), (plog, olog, blog)
    else:
        cache = model.cache_specs(shape)
        clog = model.cache_logical(shape.global_batch, shape)
        args, logical = (params, batch, cache), (plog, blog, clog)
    return Cell(cfg, shape, mesh, build_rules(mesh), cell_step(model, shape),
                args, logical)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs per step (global), per the brief."""
    n = cfg.num_active_params
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def leaves(tree):
    """The leaves of a nested dict, in its order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def arg_leaves(cell: Cell) -> list:
    """Every argument leaf, in one fixed order."""
    return [t for tree in cell.args for t in leaves(tree)]


def argument_bytes(cell: Cell, read) -> int:
    """Bytes of the shards on one device of the argument leaves whose
    index in ``arg_leaves`` is in ``read`` (``OpCounter.read``: the
    leaves the step read)."""
    index = {id(t): i for i, t in enumerate(arg_leaves(cell))}

    def shard(lg, t):
        if index[id(t)] not in read:
            return 0
        return sharding_for(lg.axes, t.shape, cell.mesh,
                            cell.rules).shard_bytes(t.shape, t.dtype)
    return sum(sum(leaves(tree_map(shard, lg, tree)))
               for lg, tree in zip(cell.logical, cell.args))


def _axes_of(spec) -> list:
    return [a for entry in spec for a in (norm_axes(entry) or ())]


def _size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def link_bw(mesh: Mesh, axes) -> float:
    """The link a group over mesh ``axes`` runs on: NVLink when its
    members lie in one node (``node_cards`` consecutive cards, the mesh
    laid out row-major), the network otherwise."""
    names = list(mesh.axis_names)
    span = 0
    for a in axes:
        stride = math.prod(mesh.shape[b] for b in names[names.index(a) + 1:])
        span += (mesh.shape[a] - 1) * stride
    return HW["nvlink_bw"] if span < HW["node_cards"] else HW["net_bw"]


def param_collectives(cell: Cell, summ) -> float:
    """Add the parameter plan's collectives (per device) to ``summ``;
    returns their time on the links, in seconds."""
    mesh = cell.mesh
    train = cell.shape.kind == "train"
    gathers = 2 if train and cell.cfg.remat else 1
    batch_axes = [a for a in BATCH_AXES
                  if a in mesh.shape and mesh.shape[a] > 1]
    shards = tree_shardings(cell.logical[0], cell.args[0], mesh, cell.rules)
    seconds = 0.0

    def add(kind, axes, vol, times=1):
        nonlocal seconds
        for _ in range(times):
            summ.add_collective(kind, _size(mesh, axes), vol)
            seconds += vol / link_bw(mesh, axes)

    for name, t in cell.args[0].items():
        axes = _axes_of(shards[name].spec)
        data = [a for a in axes if a in BATCH_AXES]
        other = _size(mesh, [a for a in axes if a not in BATCH_AXES])
        full = nbytes(t) / other            # one device's share, gathered
        if data:
            add("all-gather", data, full, gathers)
            if train:
                add("reduce-scatter", data, full)
        rest = [a for a in batch_axes if a not in data]
        if train and rest:
            add("all-reduce", rest, full / _size(mesh, data))
    return seconds


def roofline_terms(dot_flops: float, mem_bytes: float, coll_s: float,
                   mf_global: float, n_dev: int) -> dict:
    """Per-device compute, memory and collective times on the H100, the
    dominant one, and the model-FLOPs share of the peak that the bound
    allows."""
    compute_s = dot_flops / HW["peak_flops_bf16"]
    memory_s = mem_bytes / HW["hbm_bw"]
    dom = max((compute_s, "compute"), (memory_s, "memory"),
              (coll_s, "collective"))[1]
    bound = max(compute_s, memory_s, coll_s)
    mfu_bound = (mf_global / n_dev / HW["peak_flops_bf16"]) / bound \
        if bound else 0.0
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dom,
            "roofline_fraction": mfu_bound}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh: Optional[Mesh] = None) -> dict:
    """One cell's report. ``cfg``, ``shape`` and ``mesh`` default to the
    arch's config, ``SHAPES[shape_name]`` and the production mesh of meta
    devices."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    tag = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh)}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {**tag, "status": "skipped", "reason": reason}
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh)
    with sharding_ctx(mesh, cell.rules), \
            hlo_analysis.OpCounter("meta", arg_leaves(cell)) as counter:
        cell.fn(*cell.args)
    trace_s = time.time() - t0
    return report(cell, counter, trace_s, tag)


def report(cell: Cell, counter, trace_s: float, tag: dict) -> dict:
    """A cell's JSON record from the ``OpCounter`` of its step."""
    mesh, n_dev = cell.mesh, cell.mesh.size
    summ = counter.summary
    coll_s = param_collectives(cell, summ)
    arg_b = argument_bytes(cell, counter.read)
    tokens = cell.args[1 if cell.shape.kind != "train" else 2]["tokens"]
    spec = tree_shardings({"t": Logical("batch", None)}, {"t": tokens},
                          mesh, cell.rules)["t"]
    temp_b = summ.peak_bytes // spec.num_shards(0)
    live = arg_b + temp_b
    mf = model_flops(cell.cfg, cell.shape)
    dot_dev = summ.dot_flops / n_dev
    mem_dev = summ.mem_bytes / n_dev
    return {
        **tag,
        "status": "ok",
        "n_devices": n_dev,
        "trace_s": round(trace_s, 1),
        "memory": {
            "argument_bytes": arg_b,
            "temp_bytes": temp_b,
            "temp_bytes_min": summ.peak_bytes // n_dev,
            "per_device_live_bytes": live,
            "fits_80gb": bool(live < HW["hbm_bytes"]),
        },
        "hlo": {
            "dot_flops_per_dev": dot_dev,
            "mem_bytes_per_dev": mem_dev,
            "coll_bytes_per_dev": summ.coll_total,
            "coll_by_kind": summ.coll_bytes,
            "coll_by_group": {f"{k}@{g}": v for (k, g), v in
                              summ.coll_by_group.items()},
            "cross_pod_bytes": summ.cross_pod_bytes(),
            "n_ops": summ.n_ops,
            "kernels": summ.kernels,
        },
        "model_flops_global": mf,
        "useful_ratio": mf / summ.dot_flops if summ.dot_flops else None,
        "roofline": roofline_terms(dot_dev, mem_dev, coll_s, mf, n_dev),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[cached ] {tag}")
                    continue
                try:
                    res = run_cell(arch, shape_name, mp)
                except Exception as e:  # noqa: BLE001 - one JSON per cell
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                if status == "ok":
                    r, m = res["roofline"], res["memory"]
                    extra = (f"trace={res['trace_s']}s "
                             f"mem/dev={m['per_device_live_bytes']/1e9:.2f}GB "
                             f"fits80={m['fits_80gb']} "
                             f"dom={r['dominant']} "
                             f"frac={r['roofline_fraction']:.3f}")
                elif status == "error":
                    extra = res["error"][:120]
                else:
                    extra = res["reason"][:60]
                print(f"[{status:7s}] {tag} {extra}", flush=True)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
