"""Grok-1 314B — MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    num_experts=8,
    num_experts_per_tok=2,
    logit_softcap=30.0,
    rope_theta=10000.0,
)
