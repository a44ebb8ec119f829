"""Serving: continuous batching over a paged KV cache.

- ``paged_cache`` — refcounted block pool, host mirrors, prefix COW index.
- ``scheduler``   — iteration-level scheduling: admission, chunked
  prefill, decode growth, recompute-preemption, retirement.
- ``sampling``    — per-request temperature / top-k / top-p sampling,
  deterministic per (request seed, token index).
- ``tracing``     — per-request span timelines and the serve-loop ledger.
- ``spec``        — speculative decoding: n-gram and draft-model proposers,
  one verify forward of the draft window, the acceptance rule.
- ``kv_store``    — the digest-addressed tiered KV block store and the
  migration-vs-recompute pricer.
- ``remote``      — wire frames and the ``KVB1`` KV-block codec.
- ``engine``      — ``ServingEngine`` (block I/O, roles and request
  extraction for migration) and the
  ``python -m tpu_trainer_torch.serving.engine`` trace-replay CLI.
"""
