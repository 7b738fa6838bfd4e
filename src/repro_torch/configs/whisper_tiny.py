"""Whisper-tiny — encoder-decoder audio backbone; conv frontend STUBBED
(the caller gives precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,             # decoder layers
    num_encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    encoder_seq_len=1500,     # precomputed mel-frame embeddings (stub)
    act="gelu",
)
