"""OpenWebText dataset (port of ``tpu_trainer/data/openwebtext.py``).

The OpenWebText behaviours (gzip transparency and the ``.gz`` <-> plain
path fallback) live in the shared text engine (``text.open_text`` /
``text.resolve_path``). The JAX factory forwards every argument, unchanged,
to the engine's factory, so here the factory is the engine's: the same
keyword arguments and batches.
"""

from tpu_trainer_torch.data.text import (  # noqa: F401
    create_text_dataloader as create_openwebtext_dataloader)
