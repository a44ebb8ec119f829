"""PyTorch/CUDA port of ``tpu_trainer`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. Module
names mirror ``tpu_trainer/`` so every file has an obvious counterpart.
The port imports ``torch``, ``numpy`` and the standard library only —
never JAX, Flax, or anything under ``tpu_trainer``.

- ``models``   — ``GPTConfig``, the GPT (training forward, paged decode,
  KV-cached generation, dropless MoE), weight loading.
- ``ops``      — the hand-written Hopper kernels (flash attention forward
  and backwards, flash-decode, head + cross-entropy, grouped matmuls)
  behind wrappers that take their plain PyTorch versions on the CPU.
- ``training`` — the trainer (remat, narrow and offloaded Adam moments,
  DDP / ZeRO-2 / ZeRO-3 / HYBRID_SHARD across processes) and the
  ``train_ddp`` / ``train_fsdp`` CLI.
- ``parallel`` — the process mesh, the ZeRO rule and the collectives.
- ``data``, ``utils``, ``obs``, ``tools`` — text and packed data,
  checkpoints, faults, telemetry, metrics, the run analyzer.
- ``serving``, ``eval`` — the paged serving engine and ``infer.py``.

The top level exports the JAX package's API: ``GPTConfig``, ``GPT``,
``count_parameters``, ``generate`` / ``generate_kv`` and
``generate_bucketed`` (the port's ``generate``: eager PyTorch has no
recompiles to bucket against) and ``__version__``. They load on first
use, so importing a torch-free module such as ``tools.analyze`` does not
import torch.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
without a GPU and without ``device="cpu"`` they raise.
"""

__version__ = "0.2.0"  # keep in sync with pyproject.toml

_EXPORTS = {
    "GPTConfig": ("tpu_trainer_torch.models.config", "GPTConfig"),
    "GPT": ("tpu_trainer_torch.models.gpt", "GPT"),
    "count_parameters": ("tpu_trainer_torch.models.gpt", "count_parameters"),
    "generate": ("tpu_trainer_torch.models.gpt", "generate"),
    "generate_bucketed": ("tpu_trainer_torch.models.gpt", "generate"),
    "generate_kv": ("tpu_trainer_torch.models.gpt", "generate_kv"),
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module, attr = _EXPORTS[name]
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value
