"""The port's training runtime: the synthetic data pipeline bitwise
against the reference's, checkpoints (bf16 bitwise round trip, retention
with no ``.tmp`` left, async save, restore onto a given device, a
directory the reference's ``CheckpointManager`` wrote read raw, bitwise),
the fault-tolerant loop (restart-resume equality within rel 1e-6, as
``tests/test_checkpoint_and_runtime.py`` holds it; an exact restart
count), the straggler detector, and the reference's end-to-end criterion:
40 tiny steps lower the loss by more than 0.5."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import CheckpointManager as JCkpt
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import SyntheticLM as JSynth

from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs.base import OptimizerConfig, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.optim.optimizer import init_opt_state, make_train_step
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 InjectedFailure,
                                                 StragglerDetector,
                                                 reshard_tree,
                                                 run_fault_tolerant)


@pytest.fixture(scope="module")
def small_setup():
    """The reference test's setup: Qwen3 reduced to 2 layers (bf16), lr
    1e-2, seq 32 x batch 4, one chain."""
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
    model = build_model(cfg, "cpu")
    params = {k: v.detach() for k, v in model.init_params(
        torch.Generator().manual_seed(0)).items()}
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=5, total_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4, n_chains=1))
    return cfg, model, params, ocfg, opt, step, ds


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, seq_len=16, global_batch=4),
    dict(vocab_size=512, seq_len=33, global_batch=6, seed=7, n_chains=2,
         markov_noise=0.3),
    dict(vocab_size=151936, seq_len=8, global_batch=4, seed=123456)])
def test_synthetic_lm_batches_are_the_references_bitwise(kw):
    for pi, pc in ((0, 1), (1, 2)):
        ours = SyntheticLM(DataConfig(**kw), process_index=pi,
                           process_count=pc)
        ref = JSynth(JData(**kw), process_index=pi, process_count=pc)
        for step in (0, 1, 17, 1000):
            a, b = ours.get_batch(step)["tokens"], ref.get_batch(step)[
                "tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(DataConfig(**kw)) == dataclasses.asdict(
        JData(**kw))


def test_data_pipeline_determinism_and_resume():
    ds = SyntheticLM(DataConfig(vocab_size=128, seq_len=16, global_batch=4))
    it = ds.iterator()
    batches = [next(it) for _ in range(5)]
    state = it.state_dict()
    it2 = ds.iterator()
    it2.load_state_dict(state)
    np.testing.assert_array_equal(next(it2)["tokens"],
                                  ds.get_batch(5)["tokens"])
    np.testing.assert_array_equal(batches[2]["tokens"],
                                  ds.get_batch(2)["tokens"])
    with pytest.raises(ValueError, match="split"):
        SyntheticLM(DataConfig(vocab_size=8, seq_len=4, global_batch=3),
                    process_count=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path, small_setup):
    _, _, params, _, opt, _, _ = small_setup
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    ck.save(3, {"params": params, "opt": opt}, {"data": {"step": 3}})
    out = ck.restore_latest({"params": params, "opt": opt})
    assert out is not None
    step, tree, extra = out
    assert step == 3 and extra["data"]["step"] == 3
    assert params["embed"].dtype == torch.bfloat16
    for k, a in params.items():
        b = tree["params"][k]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), k
    assert tree["opt"]["count"].shape == () and int(tree["opt"]["count"]) == 0
    with open(tmp_path / "step_3" / "manifest.json") as f:
        man = json.load(f)
    assert man["dtypes"]["params/embed"] == "bfloat16"
    assert man["dtypes"]["opt/count"] == "int32"


def test_checkpoint_retention_and_atomicity(tmp_path, small_setup):
    _, _, params, _, opt, _, _ = small_setup
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, {"params": params, "opt": opt})
    assert ck.all_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_save_snapshots_at_save(tmp_path):
    """The snapshot is taken at ``save()``: changing the tensor afterwards
    does not reach the checkpoint."""
    ck = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    t = torch.arange(6, dtype=torch.float32)
    ck.save(7, {"w": t})
    t.add_(100)
    ck.wait()
    assert ck.latest_step() == 7
    tree, _ = ck.restore(7, {"w": t})
    assert torch.equal(tree["w"], torch.arange(6, dtype=torch.float32))


def test_restore_onto_a_device(tmp_path, small_setup):
    """``device=`` places every leaf (the counterpart of the reference's
    shardings); without it, each leaf goes where the template's does, a
    ``torch.device`` leaf naming the place itself."""
    _, _, params, _, _, _, _ = small_setup
    ck = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    ck.save(1, {"params": params, "n": np.int64(5)})
    step, tree, _ = ck.restore_latest(
        {"params": params, "n": 0}, device=torch.device("meta"))
    assert all(t.device.type == "meta" for t in tree["params"].values())
    assert tree["n"].device.type == "meta"
    tmpl = {"params": {k: torch.device("cpu") for k in params},
            "n": torch.device("meta")}
    tree, _ = ck.restore(1, tmpl)
    assert tree["params"]["embed"].device.type == "cpu"
    assert tree["n"].device.type == "meta"
    moved = reshard_tree({"a": tree["params"]["embed"], "b": [np.ones(2)]},
                         "meta")
    assert moved["a"].device.type == moved["b"][0].device.type == "meta"


def test_reads_a_reference_checkpoint_bitwise(tmp_path):
    """A directory the reference's ``CheckpointManager`` wrote (bf16,
    float32 and int32 leaves, nested) reads raw in the port, bitwise, and
    into a port template of the same structure."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": jnp.asarray(rng.standard_normal((3, 4)),
                                        jnp.bfloat16),
                       "b": jnp.asarray(rng.standard_normal(4),
                                        jnp.float32)},
            "opt": {"count": jnp.int32(7)}}
    JCkpt(str(tmp_path), async_save=False).save(2, tree, {"data": {"step":
                                                                     2}})
    ck = CheckpointManager(str(tmp_path))
    flat, man = ck.read(2)
    assert man["extra"] == {"data": {"step": 2}}
    w = flat["params/w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy().view(np.uint16),
        np.asarray(tree["params"]["w"]).view(np.uint16))
    np.testing.assert_array_equal(flat["params/b"].numpy(),
                                  np.asarray(tree["params"]["b"]))
    assert flat["opt/count"].dtype == torch.int32
    assert flat["opt/count"].shape == () and int(flat["opt/count"]) == 7
    step, back, extra = ck.restore_latest(
        {"params": {"w": 0, "b": 0}, "opt": {"count": 0}})
    assert step == 2 and torch.equal(back["params"]["w"], w)


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------

def test_restart_resume_equal_to_uninterrupted(tmp_path, small_setup):
    """A run with an injected failure must produce the same final loss as
    an uninterrupted run, with exactly the one restart it injected."""
    _, _, params, ocfg, opt, step, ds = small_setup
    ck1 = CheckpointManager(str(tmp_path / "a"), keep=3, async_save=False)
    r1 = run_fault_tolerant(step, params, opt, ds.iterator(), ckpt=ck1,
                            total_steps=12, checkpoint_every=4,
                            injector=FailureInjector(fail_at=(6,)))
    ck2 = CheckpointManager(str(tmp_path / "b"), keep=3, async_save=False)
    r2 = run_fault_tolerant(step, params, opt, ds.iterator(), ckpt=ck2,
                            total_steps=12, checkpoint_every=4)
    assert r1.restarts == 1 and r2.restarts == 0
    assert r1.final_step == r2.final_step == 12
    assert [m["step"] for m in r1.metrics_history] == \
        list(range(6)) + list(range(4, 12))
    l1 = r1.metrics_history[-1]["loss"]
    l2 = r2.metrics_history[-1]["loss"]
    assert l1 == pytest.approx(l2, rel=1e-6)


def test_restarts_are_bounded_and_a_real_error_surfaces(tmp_path,
                                                         small_setup):
    _, _, params, _, opt, step, ds = small_setup

    def broken(p, o, b):
        raise InjectedFailure("always")
    ck = CheckpointManager(str(tmp_path), keep=1, async_save=False)
    with pytest.raises(InjectedFailure):
        run_fault_tolerant(broken, params, opt, ds.iterator(), ckpt=ck,
                           total_steps=3, max_restarts=2)


def test_straggler_detector_flags_outliers():
    det = StragglerDetector(window=10, threshold=3.0)
    hits = []
    for i in range(30):
        dt = 1.0 if i != 25 else 8.0
        det.observe(i, dt, mitigate=lambda s: hits.append(s))
    assert any(e["step"] == 25 for e in det.events)
    assert hits == [25]


def test_e2e_training_reduces_loss():
    """The reference's ``tests/test_system.py`` criterion on the port: the
    tiny Qwen3 (2 layers, bf16) for 40 steps at lr 1e-2, seq 64 x batch
    8, one chain; the loss must drop by more than 0.5."""
    cfg = get_config("qwen3_1_7b").reduced(num_layers=2)
    model = build_model(cfg, "cpu")
    params = {k: v.detach() for k, v in model.init_params(
        torch.Generator().manual_seed(0)).items()}
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(model, ocfg)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                global_batch=8, n_chains=1))
    it = ds.iterator()
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
