"""PyTorch/CUDA port of ``tpu_trainer`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. Module
names mirror ``tpu_trainer/`` so every file has an obvious counterpart.
The port imports ``torch``, ``numpy`` and the standard library only —
never JAX, Flax, or anything under ``tpu_trainer``.

Ported so far (the serving slice):

- ``models``  — ``GPTConfig`` and the GPT in paged-decode mode, plus
  weight loading (``models/weights.py``).
- ``ops``     — RoPE, ``repeat_kv``, and the paged flash-decode kernel
  (``ops/flash.py`` wrapping ``csrc/flash_decode.cu``).
- ``serving`` — the continuous-batching ``ServingEngine`` over a paged
  KV pool, its scheduler, sampling and tracing.

Entry points run on CUDA unless the caller passes ``device="cpu"``;
without a GPU and without ``device="cpu"`` they raise.
"""
