"""Data parallelism across processes (port of ``tpu_trainer/parallel``):
the mesh and rendezvous (``mesh.py``), the per-leaf ZeRO rule
(``sharding.py``) and the explicit collectives the trainer calls
(``collectives.py``)."""
