"""Native (C) host code, built on demand and loaded with ``ctypes`` (port
of ``tpu_trainer/native``).

``fast_text.c`` does the byte-tokenize + shard pipeline that the text
loaders (``data/text.py``) use with the byte tokenizer. At first use it
is compiled with the system C compiler (``cc -O3 -shared -fPIC``) into
``tpu_trainer_torch/_build/libfast_text-<hash>.so``, where ``<hash>``
covers the source, through a process-unique temporary file and an atomic
rename. Without a compiler, the loaders fall back to the Python path with
a warning; the Python path stays the reference for the semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fast_text.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    """Where the library for the current source lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libfast_text-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
            return True
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
    return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, building it if necessary; None if it cannot
    be built or loaded (one warning)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    out = _library_path()
    if not out.exists() and not _build(out):
        warnings.warn("could not build the native fast_text library; using "
                      "the Python tokenizer path", stacklevel=2)
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        warnings.warn(f"native fast_text unavailable ({e}); using Python",
                      stacklevel=2)
        return None
    lib.fast_byte_tokenize.restype = ctypes.c_long
    lib.fast_byte_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int32,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.fast_count_lines.restype = ctypes.c_long
    lib.fast_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_long]
    _lib = lib
    return _lib


def byte_tokenize(data: bytes, eos_id: int, shard_id: int = 0,
                  num_shards: int = 1,
                  max_tokens: Optional[int] = None) -> Optional[np.ndarray]:
    """One-pass strip/tokenize/shard of a text buffer -> int32 ids: per
    kept line, its stripped UTF-8 bytes then ``eos_id`` (the Python loop
    of ``data/text.py`` with the byte tokenizer). None when the library
    is unavailable or the buffer holds bytes whose Python text semantics
    differ from the byte loop (non-ASCII, ``\\r``, exotic whitespace): the
    caller's Python path then decides."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    bound = n + lib.fast_count_lines(data, n) + 1
    if max_tokens is not None:
        bound = min(bound, int(max_tokens))
    out = np.empty(max(bound, 1), dtype=np.int32)
    budget = -1 if max_tokens is None else int(max_tokens)
    written = lib.fast_byte_tokenize(
        data, n, eos_id, shard_id, num_shards, budget,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if written < 0:
        return None
    return out[:written].copy()
