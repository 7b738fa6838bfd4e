"""xLSTM-125M — alternating sLSTM + mLSTM blocks. [arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                   # blocks carry their own projections
    vocab_size=50304,
    head_dim=192,
    act="gelu",
    block_pattern=("mlstm", "slstm"),
)
