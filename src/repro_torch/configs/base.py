"""Model and shape configuration, in torch's port (of ``repro.configs.base``).

``ModelConfig`` keeps every field of the reference, so a config built
here describes the same architecture as the reference's, field for field,
and ``reduced`` cuts it to the same small size. ``get_config`` returns
each of the reference's ten archs. The shapes registry (``SHAPES``:
train_4k / prefill_32k / decode_32k / long_500k) and ``shape_applicable``
are the reference's, skip reasons word for word. ``OptimizerConfig``,
``TrainConfig``, ``MeshConfig`` and ``MedicConfig`` are the reference's,
field for field.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.

    ``family`` selects the block structure:
      dense   -- decoder-only transformer (GQA, optional SWA/qk-norm/bias)
      moe     -- dense skeleton with MoE FFN (top-k, capacity dispatch)
      hybrid  -- RecurrentGemma-style: RG-LRU blocks + local attention (1:2)
      ssm     -- xLSTM: alternating mLSTM / sLSTM blocks
      encdec  -- Whisper-style encoder-decoder (audio frontend stubbed)
      vlm     -- Llama-3.2-Vision-style: self-attn stack + interleaved
                 cross-attention to (stubbed) image patch embeddings
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # SWA width; None = full attention
    rope_theta: float = 10000.0
    logit_softcap: Optional[float] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # hybrid (RG-LRU)
    lru_width: int = 0
    conv1d_width: int = 4
    local_window: int = 2048
    block_pattern: Tuple[str, ...] = ()    # e.g. ("rec", "rec", "attn")

    # encoder-decoder
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0               # precomputed frame embeddings

    # vlm
    cross_attn_every: int = 0              # cross-attn layer every Nth layer
    num_image_tokens: int = 0

    # numerics / misc
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    remat: bool = True

    # MeDiC serving integration
    kv_block_size: int = 256               # paged-KV block granularity

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding rows, padded to a multiple of 256 as in the
        reference (so the port's tables have the reference's shape)."""
        return _round_up(self.vocab_size, 256)

    @property
    def num_params(self) -> int:
        """Analytic parameter count (the model's parameters, counted on
        the meta device; used for the roofline)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    @property
    def num_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts with bounded state?"""
        if self.family in ("hybrid", "ssm"):
            return True
        return self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's sizes)."""
        small = dict(
            num_layers=min(self.num_layers, 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            lru_width=64 if self.lru_width else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.num_experts_per_tok else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2),
            encoder_seq_len=16 if self.encoder_seq_len else 0,
            num_image_tokens=16 if self.num_image_tokens else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            sliding_window=32 if self.sliding_window else None,
            local_window=16 if self.family == "hybrid" else self.local_window,
            kv_block_size=8,
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("pure full-attention arch: 500k-token decode state is "
                       "unbounded; skipped per brief (see DESIGN.md §5)")
    return True, ""


# ---------------------------------------------------------------------------
# Train / serve / mesh configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" saves 4 bytes/param
    grad_compression: str = "none"    # "none" | "int8"


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    microbatches: int = 1             # gradient accumulation
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class MedicConfig:
    """MeDiC policy parameters (Fig 3 thresholds + sampling)."""
    mostly_hit_threshold: float = 0.7
    mostly_miss_threshold: float = 0.2
    sampling_interval: int = 1024       # accesses between re-classification
    enable_bypass: bool = True          # WByp
    enable_insertion: bool = True       # WIP
    enable_scheduler: bool = True       # WMS


ARCH_IDS = (
    "grok_1_314b",
    "olmoe_1b_7b",
    "recurrentgemma_2b",
    "h2o_danube_1_8b",
    "qwen1_5_110b",
    "qwen3_1_7b",
    "granite_3_8b",
    "whisper_tiny",
    "llama_3_2_vision_11b",
    "xlstm_125m",
)


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
