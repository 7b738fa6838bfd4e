"""Llama-3.2-Vision-11B backbone — text decoder with cross-attention image
layers every 5th layer; vision tower STUBBED (the caller gives precomputed
patch embeddings). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    cross_attn_every=5,       # layers 4, 9, ... get cross-attention
    num_image_tokens=6400,    # 4 tiles x ~1600 patch embeddings (stub)
    rope_theta=500000.0,
)
