"""Pins the reference's serving A/B: ``examples/serve_medic.py``'s run of
the JAX ``run_ab`` (``qwen3_1_7b.reduced(num_layers=2)``, 24 requests with
60 % chat, a budget of 48 blocks of 16 tokens, 4 slots of 448, seed 0).

These integers do not depend on the model's width or weights, so the
port's full-width run on the card (``chip_smoke.py``'s serving phase) is
held to them; ``test_torch_serving_engine.py`` holds the port's own run at
this size to them on the CPU.
"""
from repro.configs.base import get_config
from repro.serving.engine import EngineConfig, run_ab
from repro.serving.pool import PoolConfig
from repro.serving.request import ServeWorkload

from test_torch_serving_engine import PINNED_AB


def test_reference_ab_gives_the_pinned_integers():
    out = run_ab(get_config("qwen3_1_7b").reduced(num_layers=2),
                 ServeWorkload(n_requests=24, chat_frac=0.6),
                 PoolConfig(budget_blocks=48, block_tokens=16),
                 EngineConfig(max_slots=4, max_len=448), seed=0)
    for policy, want in PINNED_AB.items():
        assert {k: out[policy][k] for k in want} == want, policy
