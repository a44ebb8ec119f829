"""TinyStories dataset (port of ``tpu_trainer/data/tinystories.py``).

TinyStories is a plain-text file of one story per line, read by the shared
text engine (``data/text.py``) in map-style or streaming mode. The JAX
factory forwards every argument, unchanged, to the engine's factory, so
here the factory is the engine's: the same keyword arguments and batches.
"""

from tpu_trainer_torch.data.text import (  # noqa: F401
    create_text_dataloader as create_tinystories_dataloader)
