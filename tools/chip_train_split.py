"""Where a train step of ``examples/torch_train_100m.py`` spends its time,
on one NVIDIA card.

    python3 tools/chip_train_split.py [--steps 20] [--tiny] [--device DEV]

Builds the example's model (the ~100M Qwen3-family config, or ``--tiny``'s)
from seed-0 weights, its AdamW and data, and runs warm steps split into the
pieces of ``make_train_step``'s step and ``run_fault_tolerant``'s loop:

  * ``get_batch`` (host numpy), ``batch_to`` (the copy to the card);
  * per microbatch the loss with its backward (``functional_call`` of
    ``_LossAndGrads``), and the float32 accumulation;
  * ``adamw_update`` over every leaf;
  * the loop's reads of the metrics (``float`` of each 0-d tensor);

each timed on the host clock between synchronizes (``wall``), and the
loss-and-backward and the update also without a synchronize inside
(``enqueue``: the host's time to queue the work). Then the whole step
(``make_train_step``), the loop (``run_fault_tolerant`` with no failure and
a checkpoint every ``--steps`` steps), one checkpoint save (its snapshot
and its write), and one step under ``torch.profiler``: the kernels
launched and their summed device time, against the step's wall.

Prints the card's name and power limit, then one JSON line of medians
(milliseconds).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.checkpointing import CheckpointManager  # noqa: E402,E501
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.optim import optimizer as OPT  # noqa: E402
from repro_torch.runtime.fault_tolerance import run_fault_tolerant  # noqa: E402,E501


def _example():
    path = ROOT / "examples" / "torch_train_100m.py"
    spec = importlib.util.spec_from_file_location("torch_train_100m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _med(xs):
    return statistics.median(xs) * 1e3


def split(args) -> dict:
    ex = _example()
    dev = torch.device(args.device)
    cfg, seq, batch = ex.config(args.tiny)
    from repro_torch.models.model import build_model
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(dev).manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    ocfg = OPT.OptimizerConfig(lr=3e-3, warmup_steps=20,
                               total_steps=10 * args.steps)
    opt = OPT.init_opt_state(params, ocfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=batch, n_chains=2))
    mbs = args.microbatches
    lg = OPT._LossAndGrads(model)

    def grads_of(p, part):
        leaves = {f"model.{k}": v.detach().requires_grad_(True)
                  for k, v in p.items()}
        with torch.enable_grad():
            total, metrics, grads = torch.func.functional_call(
                lg, leaves, (part, tuple(leaves.values())))
        return total, metrics, dict(zip(p, grads))

    names = ("get_batch", "batch_to", "loss_and_backward", "accumulate",
             "adamw_update", "metric_reads", "step_total")
    wall = {n: [] for n in names}
    enq = {"loss_and_backward": [], "adamw_update": []}

    def one(step_i, p, o, sync_inside):
        t_step = time.perf_counter()
        marks = {}

        def lap(name, t0):
            if sync_inside:
                _sync(dev)
            marks[name] = marks.get(name, 0.0) + time.perf_counter() - t0

        t0 = time.perf_counter()
        b = ds.get_batch(step_i)
        lap("get_batch", t0)
        t0 = time.perf_counter()
        b = OPT.batch_to(b, dev)
        lap("batch_to", t0)
        n = b["tokens"].shape[0]
        acc = {k: torch.zeros_like(v, dtype=torch.float32)
               for k, v in p.items()}
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(mbs):
            part = {k: v.split(n // mbs)[i] for k, v in b.items()}
            t0 = time.perf_counter()
            l_mb, metrics, g_mb = grads_of(p, part)
            lap("loss_and_backward", t0)
            t0 = time.perf_counter()
            for keys in OPT._groups(list(p), p):
                torch._foreach_add_([acc[k] for k in keys],
                                    torch._foreach_div(
                                        [g_mb[k].to(torch.float32)
                                         for k in keys], mbs))
            loss = loss + l_mb / mbs
            del g_mb
            lap("accumulate", t0)
        t0 = time.perf_counter()
        p, o, om = OPT.adamw_update(acc, o, p, ocfg)
        lap("adamw_update", t0)
        _sync(dev)
        t0 = time.perf_counter()
        metrics = dict(metrics, **om, loss=loss)
        _ = {k: float(v) for k, v in metrics.items() if v.ndim == 0}
        marks["metric_reads"] = time.perf_counter() - t0
        marks["step_total"] = time.perf_counter() - t_step
        return p, o, marks

    p, o = params, opt
    for i in range(3):                      # warm up
        p, o, _ = one(i, p, o, True)
    for i in range(args.steps):
        p, o, m = one(3 + i, p, o, True)
        for k, v in m.items():
            wall[k].append(v)
    for i in range(args.steps):
        p, o, m = one(3 + args.steps + i, p, o, False)
        for k in enq:
            enq[k].append(m[k])
    out = {"wall_ms": {k: _med(v) for k, v in wall.items()},
           "enqueue_ms": {k: _med(v) for k, v in enq.items()}}

    # the whole step as make_train_step gives it
    step = OPT.make_train_step(model, ocfg, microbatches=mbs)
    ts = []
    for i in range(args.steps + 2):
        b = ds.get_batch(i)
        _sync(dev)
        t0 = time.perf_counter()
        p, o, met = step(p, o, b)
        float(met["loss"])
        ts.append(time.perf_counter() - t0)
    out["make_train_step_ms"] = _med(ts[2:])

    # the loop: run_fault_tolerant, one checkpoint (step 0) and the last
    with tempfile.TemporaryDirectory(prefix="split_") as d:
        ck = CheckpointManager(d, keep=2)
        t0 = time.perf_counter()
        res = run_fault_tolerant(step, p, o, ds.iterator(), ckpt=ck,
                                 total_steps=args.steps,
                                 checkpoint_every=10 * args.steps)
        loop_s = time.perf_counter() - t0
        out["loop_ms_a_step"] = loop_s / res.steps_run * 1e3
        ck2 = CheckpointManager(d + "/x", keep=2)
        _sync(dev)
        t0 = time.perf_counter()
        ck2.save(1, {"params": p, "opt": o}, {"data": {"step": 1}})
        snap = time.perf_counter() - t0
        ck2.wait()
        out["checkpoint_ms"] = {"snapshot": snap * 1e3,
                                "snapshot_and_write":
                                    (time.perf_counter() - t0) * 1e3}

    # one step under the profiler: kernels and their device time
    try:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        b = ds.get_batch(0)
        _sync(dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            p, o, met = step(p, o, b)
            float(met["loss"])
            prof_wall = time.perf_counter() - t0
        kernels, dev_us = 0, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA or (
                    getattr(e, "self_device_time_total", 0) > 0
                    and e.cpu_time_total == 0):
                kernels += e.count
                dev_us += e.self_device_time_total
        out["profiled_step"] = {"wall_ms": prof_wall * 1e3,
                                "kernels": kernels,
                                "device_ms": dev_us / 1e3}
    except Exception as e:  # noqa: BLE001 — the profiler is optional here
        out["profiled_step"] = {"error": repr(e)}
    out.update(params=cfg.num_params, tokens_per_step=seq * batch,
               microbatches=mbs, steps=args.steps, device=str(dev))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            sys.exit("no CUDA card")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(json.dumps(split(args)))


if __name__ == "__main__":
    main()
