"""Training-rate accounting (port of ``flops_per_token`` and ``mfu`` from
``tpu_trainer/utils/logging.py``), with peaks keyed on CUDA device names.
"""

from __future__ import annotations

from typing import Optional

from tpu_trainer_torch.models.config import GPTConfig

# Peak dense bf16 tensor-core FLOP/s by CUDA device name (substring,
# case-insensitive), from NVIDIA's H100 data sheet (dense, no sparsity):
# H100 SXM 989 TFLOP/s, H100 PCIe 756 TFLOP/s. Checked in order.
_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),        # "NVIDIA H100 80GB HBM3" (SXM)
)


def peak_flops_for_name(device_name: str) -> float:
    """Peak dense bf16 FLOP/s for a CUDA device name; raises for a card
    without a known peak (an MFU against a guessed peak is no number)."""
    name = (device_name or "").lower()
    for key, flops in _PEAK_FLOPS:
        if key in name:
            return flops
    raise ValueError(f"no peak FLOP/s known for device {device_name!r}")


def flops_per_token(config: GPTConfig, seq_len: Optional[int] = None
                    ) -> float:
    """Training FLOPs per token: 6*N (N active parameters, fwd + bwd) plus
    12*L*S*H for the attention score/value products (full S^2, not halved
    for causality)."""
    s = seq_len if seq_len else config.max_seq_len
    attn = 12 * config.num_layers * s * config.hidden_size
    return 6.0 * config.num_active_parameters() + attn


def mfu(tokens_per_sec: float, config: GPTConfig, *, peak_flops: float,
        n_devices: int = 1, seq_len: Optional[int] = None) -> float:
    """Model FLOPs utilization: achieved model FLOP/s over peak FLOP/s."""
    return (tokens_per_sec * flops_per_token(config, seq_len)
            / (n_devices * peak_flops))
