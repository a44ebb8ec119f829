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
- ``sharding``    — the tensor-parallel replica's layout: parameters and
  KV pools as per-device shards, the exact gather.
- ``engine``      — ``ServingEngine`` (block I/O, roles and request
  extraction for migration, the metrics registry, ``export_requests``)
  and the ``python -m tpu_trainer_torch.serving.engine`` trace-replay
  CLI.
- ``frontend``    — ``ServingFrontend``, the request tier above N engine
  replicas: prefix-affinity routing (rendezvous over chained block
  digests), bounded queues with reject-at-submit, failover with
  token-identical resume, capacity-driven grow/shrink, cancel and
  deadlines, and prefill -> decode roles with KV migration.
- ``remote`` / ``worker`` — cross-process replicas: the wire frames, the
  ``KVB1`` KV-block codec and the RPC; ``worker`` runs one engine per OS
  process (``python -m tpu_trainer_torch.serving.worker``), ``remote``
  the drop-in ``RemoteReplica`` and the ``WorkerSupervisor`` (exit-code
  and heartbeat death detection, fencing, real ``SIGKILL`` drills) that
  plugs into ``ServingFrontend`` as its ``replica_factory``.

The package exports the JAX package's serving names. They load on first
use, so importing ``kv_store`` or ``paged_cache`` does not build the rest.
"""

_EXPORTS = {
    "ServingEngine": "engine",
    "poisson_trace": "engine",
    "LocalReplica": "frontend",
    "ServingFrontend": "frontend",
    "SubmitResult": "frontend",
    "RemoteReplica": "remote",
    "ReplicaDied": "remote",
    "WorkerSupervisor": "remote",
    "BlockPool": "paged_cache",
    "PagedKVCache": "paged_cache",
    "Request": "scheduler",
    "SamplingParams": "scheduler",
    "Scheduler": "scheduler",
    "AdaptiveK": "spec",
    "DraftModelProposer": "spec",
    "NGramProposer": "spec",
    "SpecDecoder": "spec",
    "draft_from_target": "spec",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
