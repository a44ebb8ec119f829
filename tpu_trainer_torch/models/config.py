"""Model configuration (port of ``tpu_trainer/models/config.py``).

Same fields, defaults, validation and presets as the JAX package, so one
set of keyword arguments builds both configs in the parity tests. Dtypes
stay strings; ``compute_dtype`` / ``params_dtype`` map them to torch
dtypes. The training forward reads the dropout, flash-attention, fused
loss, fused-projection, remat and MoE fields (both routers); the
trainer reads the pipeline fields under a stage axis
(``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_of(name: str) -> torch.dtype:
    """Map a dtype name ('float32' | 'bfloat16' | 'float16') to a torch dtype."""
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """GPT configuration (defaults = GPT-2 124M / "small").

    LLaMA-style — RMSNorm, RoPE, SwiGLU, no biases, pre-norm, tied
    embeddings — with GPT-2's vocabulary.
    """

    # Model architecture
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    # Grouped-query attention: K/V heads; None = num_heads.
    num_kv_heads: Optional[int] = None
    intermediate_size: Optional[int] = None  # defaults to 4 * hidden_size
    max_seq_len: int = 1024

    # Regularization
    dropout: float = 0.1
    attention_dropout: float = 0.1

    # Initialization: normal(std=initializer_range) kernels and embedding.
    initializer_range: float = 0.02

    activation: str = "silu"
    rope_theta: float = 10000.0

    # Mixture-of-Experts (0 = dense; models/moe.py). moe_dispatch is the
    # capacity router's: "auto" is "gather" (no expert axis is ported).
    num_experts: int = 0
    moe_top_k: int = 1
    expert_capacity_factor: float = 1.25
    moe_dispatch: str = "auto"
    moe_impl: str = "capacity"
    moe_aux_weight: float = 0.01
    router_z_weight: float = 0.0

    # Training-path switches. Read by GPT's training forward; the pipeline
    # fields by the trainer and GPT.pipeline_step under a stage axis
    # (parallel/pipeline.py).
    use_flash_attention: bool = False
    gradient_checkpointing: bool = False
    remat_policy: str = "full"
    remat_lm_head: bool = False
    fused_loss: bool = True
    loss_chunk_size: int = 0
    fused_loss_pallas: bool = True
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 2
    fast_dropout: bool = True
    scan_unroll: bool = True

    # q/k/v and gate/up run as one matmul over concatenated kernels; the
    # parameters stay separate (checkpoint layout unchanged).
    fused_projections: bool = True

    # --- Paged decode (the serving engine's cache layout) ---------------
    # Set by ServingEngine via dataclasses.replace; block 0 of the pool
    # is the reserved null block that masked writes land in.
    decode_paged: bool = False
    paged_block_size: int = 16
    paged_num_blocks: int = 0
    paged_max_blocks: int = 0
    # Pools as blockwise-absmax int8 + f32 scales (utils/quant.py).
    paged_kv_int8: bool = False
    # Decode attention over the pool. Every value calls
    # ops.flash.flash_decode: the CUDA kernel on a CUDA tensor, its plain
    # twin on a CPU tensor. "reference" (the plain version) is therefore
    # CPU-only, and the engine refuses it on CUDA.
    paged_attention: str = "auto"
    # Chunked-prefill history width of THIS dispatch, in blocks (0 = the
    # offset-0 whole-prompt path). Set per dispatch, never a user knob.
    paged_hist_blocks: int = 0
    # Tensor-parallel decode: not ported yet (> 1 raises).
    paged_tp: int = 1
    paged_tp_devices: Optional[Tuple[int, ...]] = None

    decode_ragged: bool = False
    decode_window: int = 0

    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            object.__setattr__(self, "intermediate_size", 4 * self.hidden_size)
        if self.hidden_size % self.num_heads != 0:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_heads ({self.num_heads})")
        if (self.num_kv_heads is not None
                and self.num_heads % self.num_kv_heads != 0):
            raise ValueError(
                f"num_heads ({self.num_heads}) must be divisible by "
                f"num_kv_heads ({self.num_kv_heads})")
        if self.num_experts > 0 and not (
                1 <= self.moe_top_k <= self.num_experts):
            raise ValueError(
                f"moe_top_k ({self.moe_top_k}) must be in "
                f"[1, num_experts={self.num_experts}]")
        if self.moe_dispatch not in ("auto", "gather", "einsum"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r}; "
                f"choose auto, gather, or einsum")
        if self.moe_impl not in ("capacity", "dropless"):
            raise ValueError(
                f"unknown moe_impl {self.moe_impl!r}; "
                f"choose capacity or dropless")
        if self.pipeline_schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(
                f"unknown pipeline_schedule {self.pipeline_schedule!r}; "
                f"choose gpipe, 1f1b, or interleaved")
        if (self.pipeline_schedule == "interleaved"
                and self.pipeline_virtual_stages < 2):
            raise ValueError(
                f"pipeline_schedule='interleaved' needs "
                f"pipeline_virtual_stages >= 2 "
                f"(got {self.pipeline_virtual_stages}); v=1 is plain 1f1b")
        if self.paged_attention not in ("auto", "reference", "kernel"):
            raise ValueError(
                f"unknown paged_attention {self.paged_attention!r}; "
                f"choose auto, reference, or kernel")
        if self.decode_paged:
            if self.decode_ragged:
                raise ValueError(
                    "decode_paged and decode_ragged are mutually exclusive")
            if self.paged_num_blocks < 2 or self.paged_max_blocks < 1:
                raise ValueError(
                    "decode_paged needs paged_num_blocks >= 2 (block 0 is "
                    "the reserved null block) and paged_max_blocks >= 1")
            if not 0 <= self.paged_hist_blocks <= self.paged_max_blocks:
                raise ValueError(
                    f"paged_hist_blocks ({self.paged_hist_blocks}) must be "
                    f"in [0, paged_max_blocks={self.paged_max_blocks}]")
        if self.paged_tp_devices is not None and not isinstance(
                self.paged_tp_devices, tuple):
            object.__setattr__(
                self, "paged_tp_devices",
                tuple(int(d) for d in self.paged_tp_devices))
        if self.paged_tp != 1:
            from tpu_trainer_torch.serving.sharding import validate_tp

            validate_tp(self.num_heads, self.kv_heads, self.paged_tp)
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; "
                f"choose from ['dots', 'full']")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        """Resolved K/V head count (num_kv_heads, defaulting to num_heads)."""
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)

    def num_parameters(self) -> int:
        """Exact parameter count: tied embedding V*H; per layer q/o 2*H^2,
        k/v 2*H*kv, SwiGLU 3*H*I (MoE: E*3*H*I + H*E), two norms 2*H;
        final norm H."""
        h, i = self.hidden_size, self.intermediate_size
        kv = self.kv_heads * self.head_dim
        if self.num_experts > 0:
            ffn = self.num_experts * 3 * h * i + h * self.num_experts
        else:
            ffn = 3 * h * i
        per_layer = 2 * h * h + 2 * h * kv + ffn + 2 * h
        return self.vocab_size * h + self.num_layers * per_layer + h

    def num_active_parameters(self) -> int:
        """Parameters one token flows through (MoE: only the top-k
        experts' FFNs); the N of the 6N flops-per-token estimate."""
        if self.num_experts <= 0:
            return self.num_parameters()
        h, i = self.hidden_size, self.intermediate_size
        inactive = (self.num_experts - self.moe_top_k) * 3 * h * i
        return self.num_parameters() - self.num_layers * inactive

    @property
    def compute_dtype(self) -> torch.dtype:
        return dtype_of(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return dtype_of(self.param_dtype)

    # --- Size presets -----------------------------------------------------

    @classmethod
    def gpt2_small(cls, **overrides) -> "GPTConfig":
        """GPT-2 124M-class configuration."""
        return cls(vocab_size=50257, hidden_size=768, num_layers=12,
                   num_heads=12, **overrides)

    @classmethod
    def gpt2_medium(cls, **overrides) -> "GPTConfig":
        """GPT-2 355M-class configuration."""
        return cls(vocab_size=50257, hidden_size=1024, num_layers=24,
                   num_heads=16, **overrides)

    @classmethod
    def gpt2_large(cls, **overrides) -> "GPTConfig":
        """GPT-2 774M-class configuration."""
        return cls(vocab_size=50257, hidden_size=1280, num_layers=36,
                   num_heads=20, **overrides)

    @classmethod
    def gpt2_xl(cls, **overrides) -> "GPTConfig":
        """GPT-2 1.5B-class configuration."""
        return cls(vocab_size=50257, hidden_size=1600, num_layers=48,
                   num_heads=25, **overrides)

    @classmethod
    def preset(cls, name: str, **overrides) -> "GPTConfig":
        presets = {
            "small": cls.gpt2_small,
            "medium": cls.gpt2_medium,
            "large": cls.gpt2_large,
            "xl": cls.gpt2_xl,
        }
        if name not in presets:
            raise ValueError(
                f"unknown model size {name!r}; choose from {sorted(presets)}")
        return presets[name](**overrides)
