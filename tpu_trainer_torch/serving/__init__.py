"""Serving: continuous batching over a paged KV cache.

- ``paged_cache`` — refcounted block pool, host mirrors, prefix COW index.
- ``scheduler``   — iteration-level scheduling: admission, chunked
  prefill, decode growth, recompute-preemption, retirement.
- ``sampling``    — per-request temperature / top-k / top-p sampling,
  deterministic per (request seed, token index).
- ``tracing``     — per-request span timelines and the serve-loop ledger.
- ``engine``      — ``ServingEngine`` and the
  ``python -m tpu_trainer_torch.serving.engine`` trace-replay CLI.
"""
