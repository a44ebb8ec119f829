"""Live metrics plane (a copy of the JAX package's ``obs``: it imports
neither JAX nor the accelerator).

``obs.metrics`` is the dependency-free registry core (Counter / Gauge /
Histogram with Prometheus text exposition); ``obs.http`` is the
stdlib-only scrape surface (``/metrics`` + ``/healthz`` + ``/statusz``
on a daemon thread). Everything is host-side Python: a run with no
registry installed pays a no-op attribute call per instrumentation
site, and output streams are bit-identical with metrics on or off.
"""

from tpu_trainer_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    NULL_REGISTRY,
    MetricsRegistry,
    NullRegistry,
)
