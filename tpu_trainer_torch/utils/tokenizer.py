"""Tokenizer access with an offline fallback (port of
``tpu_trainer/utils/tokenizer.py``).

``get_tokenizer("byte")`` is the deterministic byte-level tokenizer (ids
0-255 are raw bytes; eos 50256, a GPT-2-sized vocab of 50257), so data
loading, training and inference run with no download. Any other name
loads HF ``GPT2TokenizerFast`` when it is cached locally; a miss falls
back to the byte tokenizer with a warning, or raises under the training
policy ``on_fallback="error"``.
"""

from __future__ import annotations

import warnings
from typing import List


class ByteTokenizer:
    """UTF-8 byte tokenizer (id = byte value; eos = 50256)."""

    vocab_size = 50257
    eos_token_id = 50256

    name = "byte"

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode(
            "utf-8", errors="replace")


class _HFWrapper:
    def __init__(self, tok):
        self._tok = tok
        self.vocab_size = tok.vocab_size
        self.eos_token_id = tok.eos_token_id
        self.name = getattr(tok, "name_or_path", "hf")

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids) -> str:
        return self._tok.decode(list(int(i) for i in ids))


def get_tokenizer(name: str = "gpt2", on_fallback: str = "warn"):
    """``"byte"`` -> ``ByteTokenizer``; else ``GPT2TokenizerFast`` when it
    is cached locally (it is never fetched), with the byte fallback
    otherwise.

    ``on_fallback="error"`` is the training policy: a run that silently
    tokenized bytes instead of GPT-2 BPE would write a checkpoint no GPT-2
    tokenizer can read, so training asks for ``--tokenizer byte``
    explicitly.
    """
    if name in ("byte", "byte-fallback"):
        return ByteTokenizer()
    try:
        from transformers import GPT2TokenizerFast

        return _HFWrapper(
            GPT2TokenizerFast.from_pretrained(name, local_files_only=True))
    except Exception as e:
        if on_fallback == "error":
            raise RuntimeError(
                f"could not load HF tokenizer {name!r} ({type(e).__name__}: "
                f"{e}). Training with the byte-level fallback must be "
                f"explicit: pass --tokenizer byte (ids will not match a "
                f"GPT-2-tokenized checkpoint).") from e
        warnings.warn(
            f"falling back to byte-level tokenizer: could not load HF "
            f"tokenizer {name!r} ({type(e).__name__}: {e}). Token ids will "
            f"NOT match a GPT-2-tokenized checkpoint.", stacklevel=2)
        return ByteTokenizer()
