"""RecurrentGemma-2B — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,        # MQA for the local-attention layers
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    lru_width=2560,
    conv1d_width=4,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    act="gelu",
    rope_theta=10000.0,
)
