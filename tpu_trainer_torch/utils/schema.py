"""The version of the JSONL record schema (``MetricLogger``, the flight
recorder, heartbeats): the JAX package's ``SCHEMA_VERSION``, so either
package's analyzer reads either package's runs. Its own module, so the
analyzer imports neither torch nor the model."""

SCHEMA_VERSION = 1
