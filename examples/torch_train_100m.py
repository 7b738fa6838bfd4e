"""End-to-end training on the PyTorch port: a ~100M-parameter
qwen3-family model for a few hundred steps with the whole substrate —
the synthetic data pipeline, AdamW with its cosine schedule, gradient
accumulation, async checkpoints, an injected failure with its restart,
and straggler detection (the counterpart of ``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch_train_100m.py [--steps 300]
        [--tiny] [--device cpu] [--ckpt DIR]

It runs on the card by default and raises without one; ``--device cpu``
trains on the CPU. Training runs the plain PyTorch versions under
autograd (the Hopper kernels serve inference only). Checkpoints go to a
new directory under ``build/`` unless ``--ckpt`` names one; a directory
that already holds checkpoints is resumed from its latest.
"""
import argparse
import dataclasses
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import init_opt_state, make_train_step
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 run_fault_tolerant)

BUILD = Path(__file__).resolve().parents[1] / "build"


def config(tiny: bool):
    """(model config, sequence length, global batch)."""
    if tiny:
        return get_config("qwen3_1_7b").reduced(num_layers=2), 64, 8
    # ~100M params: 12 x 512 qwen3-family (qk-norm, GQA, tied embed)
    cfg = dataclasses.replace(
        get_config("qwen3_1_7b"), num_layers=12, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32000, remat=False)
    return cfg, 256, 8


def train(steps: int = 300, *, tiny: bool = False, device=None,
          ckpt_dir=None, fail_at=None, microbatches: int = 2,
          checkpoint_every: int = 50, log_every: int = 20, log=print):
    """The example's loop: seed-0 weights, ``steps`` steps with a failure
    injected at ``fail_at`` (default ``steps // 3``). Returns a dict with
    the ``LoopResult`` (``result``), the per-step losses and the wall."""
    cfg, seq, batch = config(tiny)
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(dev).manual_seed(0))
    log(f"model: {cfg.name}-derived, {cfg.num_params / 1e6:.1f}M params, "
        f"on {dev}")
    params = {k: p.detach() for k, p in model.named_parameters()}
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=steps)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg, microbatches=microbatches)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                global_batch=batch, n_chains=2))
    if ckpt_dir is None:
        BUILD.mkdir(exist_ok=True)
        ckpt_dir = tempfile.mkdtemp(prefix="torch_train100m_", dir=BUILD)
    ck = CheckpointManager(str(ckpt_dir), keep=2)
    fail_at = steps // 3 if fail_at is None else fail_at
    t0 = time.perf_counter()
    res = run_fault_tolerant(
        step, params, opt, ds.iterator(), ckpt=ck, total_steps=steps,
        checkpoint_every=checkpoint_every,
        injector=FailureInjector(fail_at=(fail_at,)),
        on_metrics=lambda s, m: log(
            f"step {s:4d} loss {m['loss']:.4f} lr {m['lr']:.2e} "
            f"gnorm {m['grad_norm']:.2f}") if s % log_every == 0 else None)
    wall = time.perf_counter() - t0
    return {"result": res, "losses": [m["loss"] for m in
                                      res.metrics_history],
            "wall_s": wall, "ckpt_dir": str(ckpt_dir), "cfg": cfg,
            "tokens_per_step": seq * batch}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny config for quick runs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a new one under "
                    "build/)")
    args = ap.parse_args()
    out = train(args.steps, tiny=args.tiny, device=args.device,
                ckpt_dir=args.ckpt)
    res, losses = out["result"], out["losses"]
    print(f"\nrestarts={res.restarts} straggler_events="
          f"{len(res.straggler_events)} wall={out['wall_s']:.1f}s")
    if losses:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"nothing to run: {out['ckpt_dir']} is at step "
              f"{res.final_step}")


if __name__ == "__main__":
    main()
