"""The port's ``ServeEngine`` against the JAX reference on the CPU.

Both engines run the same weights (the reference's, carried across by
``params_from_numpy``) on the same requests under a budget tight enough
that evictions, offloads, restores and bypasses all happen. The pool
snapshot and the engine's metrics must be equal bitwise; the committed K/V
cache within 2e-2 in bfloat16 (one layer: its K/V depend on nothing that
XLA's fusions round differently) and within 1e-5 in float32 (three
layers). The metrics do not depend on the model's width, which is what
lets ``chip_smoke.py`` check the full-width run on the card against
integers pinned from the reference: the same run at another width of the
port gives the same snapshot.

The reference's ``_select_cache`` (serving/engine.py:272-278) finds the
batch axis by shape and picks the layer axis when ``num_layers ==
max_slots``; these tests use 1 or 3 layers with 2 slots (ROADMAP C).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro.serving.pool import PoolConfig as JPoolConfig
from repro.serving.request import ServeWorkload as JWorkload
from repro.serving.request import generate_requests as j_generate

from repro_torch.configs.base import get_config
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import engine as ENG
from repro_torch.serving.engine import EngineConfig, ServeEngine, run_ab
from repro_torch.serving.pool import PoolConfig
from repro_torch.serving.request import ServeWorkload, generate_requests

WL = dict(n_requests=6, chat_frac=0.5, rag_prompt=(64, 160), decode=(8, 24),
          arrival_rate=1.0)
POOL = dict(budget_blocks=12, block_tokens=16, sampling_interval=8)
ECFG = dict(max_slots=2, max_len=448)
MAX_STEPS = 300
SEED = 3
#: (layers, dtype) of the compared runs -> tolerance of the K/V cache
DEPTHS = {(1, "bfloat16"): 2e-2, (3, "float32"): 1e-5}

#: the reference's examples/serve_medic.py A/B (qwen3_1_7b.reduced(
#: num_layers=2), 24 requests, budget 48 blocks of 16, 4 slots of 448,
#: seed 0), as the JAX package gives it (test_torch_serving_ab.py)
PINNED_AB = {
    "lru": dict(steps=2000, completed=8, tokens_out=627, stall_steps=7367,
                fetches=1940, bypassed_blocks=0),
    "medic": dict(steps=2000, completed=23, tokens_out=1438,
                  stall_steps=4050, fetches=1719, bypassed_blocks=1037),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small eager ops run faster on one thread (and share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snap_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert type(x) is type(y), k
            assert x == y or (x != x and y != y), (k, x, y)


@pytest.fixture(scope="module")
def reference_runs():
    """The JAX engine's run under each policy and depth, with its
    weights."""
    out = {}
    for (layers, dtype), policy in [(d, p) for d in DEPTHS
                                    for p in ("lru", "medic")]:
        cfg = j_get_config("qwen3_1_7b").reduced(num_layers=layers,
                                                 dtype=dtype)
        eng = JServeEngine(cfg, JEngineConfig(**ECFG),
                           JPoolConfig(**POOL, policy=policy))
        snap = eng.run(j_generate(JWorkload(**WL), seed=SEED),
                       max_steps=MAX_STEPS)
        kv = eng._kv_leaves()
        out[layers, dtype, policy] = dict(
            snap=snap, params=jax.tree.map(np.asarray, eng.params),
            k=np.asarray(kv["k"], np.float32),
            v=np.asarray(kv["v"], np.float32),
            len=np.asarray(eng.cache["len"]),
            kv_pos=np.asarray(eng.cache["kv_pos"]))
    return out


def _port_run(policy, cfg, params=None):
    ENG.COUNTS.reset()
    eng = ServeEngine(cfg, EngineConfig(**ECFG),
                      PoolConfig(**POOL, policy=policy), device="cpu",
                      params=params)
    snap = eng.run(generate_requests(ServeWorkload(**WL), seed=SEED),
                   max_steps=MAX_STEPS)
    return eng, snap, dataclasses.replace(ENG.COUNTS)


@pytest.mark.parametrize("policy", ["lru", "medic"])
@pytest.mark.parametrize("layers,dtype", sorted(DEPTHS))
def test_engine_matches_reference(reference_runs, layers, dtype, policy):
    ref = reference_runs[layers, dtype, policy]
    tol = DEPTHS[layers, dtype]
    cfg = get_config("qwen3_1_7b").reduced(num_layers=layers, dtype=dtype)
    eng, snap, counts = _port_run(
        policy, cfg, params_from_numpy(ref["params"], cfg, "cpu"))
    _snap_equal(ref["snap"], snap)
    # the data path was exercised
    assert counts.offloads > 0 and counts.restores > 0
    assert counts.admissions >= 3 and counts.decode_steps > 0
    assert snap["completed"] >= 3 and snap["fetches"] > 0
    assert (snap["bypassed_blocks"] > 0) == (policy == "medic")
    # the committed cache
    kv = eng._kv_leaves()
    for n in ("k", "v"):
        np.testing.assert_allclose(kv[n].float().numpy(), ref[n], atol=tol,
                                   rtol=tol, err_msg=n)
        # offloaded blocks are zero in both
        np.testing.assert_array_equal(kv[n].float().numpy() == 0,
                                      ref[n] == 0)
    np.testing.assert_array_equal(eng.cache["len"].numpy(), ref["len"])
    np.testing.assert_array_equal(eng.lens, ref["len"])
    np.testing.assert_array_equal(eng.cache["kv_pos"].numpy(),
                                  ref["kv_pos"])


@pytest.mark.parametrize("policy", ["lru", "medic"])
@pytest.mark.parametrize("width", [
    dict(num_layers=1, dtype="float32"),
    dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
         head_dim=16, d_ff=48, vocab_size=300),
])
def test_engine_metrics_do_not_depend_on_width(reference_runs, policy,
                                               width):
    """Another width (and weights from the port's own generator) gives the
    reference's snapshot: the anchor of chip_smoke.py's full-width run."""
    cfg = get_config("qwen3_1_7b").reduced(**width)
    _, snap, _ = _port_run(policy, cfg)
    for depth in DEPTHS:
        _snap_equal(reference_runs[depth + (policy,)]["snap"], snap)


def test_run_ab_reproduces_the_pinned_reference_integers():
    """The port's run_ab at the example's settings gives the integers the
    JAX package gives (pinned in test_torch_serving_ab.py)."""
    out = run_ab(get_config("qwen3_1_7b").reduced(num_layers=2),
                 ServeWorkload(n_requests=24, chat_frac=0.6),
                 PoolConfig(budget_blocks=48, block_tokens=16),
                 EngineConfig(max_slots=4, max_len=448), seed=0,
                 device="cpu")
    for policy, want in PINNED_AB.items():
        assert {k: out[policy][k] for k in want} == want, policy


def test_engine_counts_follow_the_run():
    cfg = get_config("qwen3_1_7b").reduced(num_layers=1, dtype="float32")
    eng, snap, counts = _port_run("medic", cfg)
    assert counts.admissions == 6      # every request got a slot
    assert counts.decode_steps <= snap["steps"]
    assert snap["tokens_out"] >= counts.decode_steps
    assert counts.offloads >= snap["bypassed_blocks"] > 0


def test_engine_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3_1_7b").reduced(num_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, EngineConfig(**ECFG), PoolConfig(**POOL))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ab(cfg, ServeWorkload(n_requests=1), PoolConfig(**POOL),
               EngineConfig(**ECFG))


def test_engine_cuda_backend_does_not_fall_back_on_the_cpu():
    cfg = get_config("qwen3_1_7b").reduced(num_layers=1, dtype="float32")
    eng = ServeEngine(cfg, EngineConfig(**ECFG), PoolConfig(**POOL),
                      device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        eng.run(generate_requests(ServeWorkload(**WL), seed=SEED),
                max_steps=5)


#: a ring that is not a whole number of pool blocks: 100 slots, blocks of
#: 16 (the last one 4 tokens long); chat requests of 64-96 prompt tokens
#: and 32-96 decode tokens wrap it, and a budget of 8 blocks offloads and
#: restores every block index, the short one included
RAGGED = dict(ecfg=dict(max_slots=2, max_len=100),
              pool=dict(budget_blocks=8, block_tokens=16,
                        sampling_interval=8, policy="medic"),
              wl=dict(n_requests=4, chat_frac=1.0), max_steps=400)
STAMPS = ("rid", "slot", "enqueue_step", "first_token_step", "finish_step",
          "generated", "stall_steps")


def test_engine_runs_a_ring_that_is_not_whole_blocks():
    """The reference runs a max_len that is not a multiple of
    block_tokens, its offloads cut short at the ring's end; the port reads
    the ring in pages of gcd(max_len, block_tokens) = 4 and matches it:
    every pool integer, every request's stamps, the K/V ring (bf16, one
    layer), len and kv_pos."""
    jcfg = j_get_config("qwen3_1_7b").reduced(num_layers=1)
    jreqs = j_generate(JWorkload(**RAGGED["wl"]), seed=0)
    jeng = JServeEngine(jcfg, JEngineConfig(**RAGGED["ecfg"]),
                        JPoolConfig(**RAGGED["pool"]))
    jsnap = jeng.run(jreqs, max_steps=RAGGED["max_steps"])
    cfg = get_config("qwen3_1_7b").reduced(num_layers=1)
    ENG.COUNTS.reset()
    eng = ServeEngine(cfg, EngineConfig(**RAGGED["ecfg"]),
                      PoolConfig(**RAGGED["pool"]), device="cpu",
                      params=params_from_numpy(
                          jax.tree.map(np.asarray, jeng.params), cfg, "cpu"))
    short, offload = [], eng._offload

    def counted(key):          # offloads of a real slot's short last block
        if key[1] == 6 and key[0] < 2:
            short.append(key)
        offload(key)
    eng._offload = eng.pool.on_evict = counted
    reqs = generate_requests(ServeWorkload(**RAGGED["wl"]), seed=0)
    snap = eng.run(reqs, max_steps=RAGGED["max_steps"])
    assert eng.page == 4
    _snap_equal(jsnap, snap)
    assert snap["completed"] == 3 and snap["bypassed_blocks"] > 0
    assert short and ENG.COUNTS.restores > 0
    assert int(eng.lens.max()) > 100                # the rings wrapped
    for a, b in zip(sorted(jreqs, key=lambda r: r.rid),
                    sorted(reqs, key=lambda r: r.rid)):
        assert [getattr(a, f) for f in STAMPS] == \
            [getattr(b, f) for f in STAMPS], a.rid
    kv, jkv = eng._kv_leaves(), jeng._kv_leaves()
    for n in ("k", "v"):
        ref = np.asarray(jkv[n], np.float32)
        np.testing.assert_allclose(kv[n].float().numpy(), ref, atol=2e-2,
                                   rtol=2e-2, err_msg=n)
        np.testing.assert_array_equal(kv[n].float().numpy() == 0, ref == 0)
    np.testing.assert_array_equal(eng.cache["len"].numpy(),
                                  jeng.cache["len"])
    np.testing.assert_array_equal(eng.cache["kv_pos"].numpy(),
                                  jeng.cache["kv_pos"])


def test_engine_refuses_what_it_does_not_run():
    cfg = get_config("qwen3_1_7b").reduced(num_layers=1)
    swa = get_config("h2o_danube_1_8b").reduced(num_layers=1)   # window 32
    with pytest.raises(ValueError, match="max_len"):
        ServeEngine(swa, EngineConfig(**ECFG), PoolConfig(**POOL),
                    device="cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(dataclasses.replace(cfg, family="moe"),
                    EngineConfig(**ECFG), PoolConfig(**POOL), device="cpu")
