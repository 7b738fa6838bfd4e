"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler detection and re-placement (port of
``repro.runtime.fault_tolerance``).

  * restart: any exception inside the step loop triggers a restore from
    the latest checkpoint (params, optimizer state, data-iterator state)
    and a bounded number of resumes (``max_restarts``), as the reference
    retries; ``LoopResult.restarts`` counts them, so a caller that
    injects failures can hold the count to what it injected and no real
    error is retried into a pass unseen;
  * straggler detection: a median/deviation filter over per-step wall
    times; sustained outliers fire the mitigation hook (recorded and
    pluggable);
  * re-placement: checkpoints hold whole arrays (see checkpointing), and
    ``reshard_tree`` puts a tree's leaves onto the devices asked for.

A step's wall time ends when its loss is ready: the loss's device is
synchronized (the counterpart of ``jax.block_until_ready``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import CheckpointManager


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises at the configured global steps (once each)."""
    fail_at: tuple = ()
    fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


class StragglerDetector:
    def __init__(self, window: int = 20, threshold: float = 3.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.events: List[Dict] = []

    def observe(self, step: int, dt: float,
                mitigate: Optional[Callable[[int], None]] = None):
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= self.window // 2 + 1:
            med = float(np.median(hist[:-1]))
            mad = float(np.median(np.abs(np.asarray(hist[:-1]) - med))) + 1e-9
            if dt > med + self.threshold * 6.0 * mad and dt > 1.5 * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                if mitigate is not None:
                    mitigate(step)


def reshard_tree(tree, devices):
    """``tree`` (nested dicts / lists of tensors or numpy arrays) with
    every leaf on ``devices``: one device for all leaves, or a tree of
    the same structure naming each leaf's device."""
    if isinstance(tree, Mapping):
        return {k: reshard_tree(v, devices[k] if isinstance(devices, Mapping)
                                else devices) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            reshard_tree(v, devices[i] if isinstance(devices, (list, tuple))
                         else devices) for i, v in enumerate(tree))
    t = tree if torch.is_tensor(tree) else torch.from_numpy(np.asarray(tree))
    return t.to(devices)


def placement(tree):
    """``tree`` with each tensor leaf replaced by its device (other
    leaves by the CPU): a restore template that holds no tensor."""
    if isinstance(tree, Mapping):
        return {k: placement(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(placement(v) for v in tree)
    return tree.device if torch.is_tensor(tree) else torch.device("cpu")


def sync(x) -> None:
    """Wait for ``x``'s device to finish its queued work (a CUDA
    tensor's device; nothing on the CPU)."""
    if torch.is_tensor(x) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class LoopResult:
    steps_run: int
    restarts: int
    final_step: int
    metrics_history: List[Dict]
    straggler_events: List[Dict]


def run_fault_tolerant(step_fn, params, opt_state, data_iter, *,
                       ckpt: CheckpointManager, total_steps: int,
                       checkpoint_every: int = 10,
                       injector: Optional[FailureInjector] = None,
                       max_restarts: int = 8,
                       on_metrics: Optional[Callable] = None) -> LoopResult:
    """Run ``total_steps`` of step_fn with checkpoint/restart semantics.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics).
    Restored leaves go back to the devices of ``params`` / ``opt_state``
    as given."""
    # where each restored leaf goes: the device of the leaf given (the
    # tensors themselves are not kept alive for it)
    template = placement({"params": params, "opt": opt_state})
    restarts = 0
    history: List[Dict] = []
    straggler = StragglerDetector()

    restored = ckpt.restore_latest(template)
    if restored is not None:
        start, tree, extra = restored
        params, opt_state = tree["params"], tree["opt"]
        data_iter.load_state_dict(extra["data"])
        step = start
    else:
        step = 0
        ckpt.save(0, {"params": params, "opt": opt_state},
                  {"data": data_iter.state_dict()}, block=True)

    while step < total_steps:
        try:
            batch = next(data_iter)
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            sync(metrics["loss"])
            dt = time.perf_counter() - t0
            straggler.observe(step, dt)
            metrics = {k: float(v) for k, v in metrics.items()
                       if np.ndim(v) == 0}
            metrics["step"] = step
            history.append(metrics)
            if on_metrics is not None:
                on_metrics(step, metrics)
            step += 1
            if step % checkpoint_every == 0 or step == total_steps:
                ckpt.save(step, {"params": params, "opt": opt_state},
                          {"data": data_iter.state_dict()})
        except Exception as e:  # noqa: BLE001 — restart on any step failure
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()
            restored = ckpt.restore_latest(template)
            if restored is None:
                raise RuntimeError("no checkpoint to restart from") from e
            step, tree, extra = restored
            params, opt_state = tree["params"], tree["opt"]
            data_iter.load_state_dict(extra["data"])

    ckpt.wait()
    return LoopResult(steps_run=len(history), restarts=restarts,
                      final_step=step, metrics_history=history,
                      straggler_events=straggler.events)
