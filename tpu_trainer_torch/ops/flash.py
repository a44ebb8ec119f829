"""Paged flash-decode (port of ``tpu_trainer/ops/flash.py`` decode path).

``flash_decode`` is single-query attention over a paged KV pool. On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/flash_decode.cu``, which replaces the Pallas TPU kernel
``tpu_trainer/ops/flash.py::_decode_kernel``; on a CPU tensor it runs
``paged_attention_reference``, the plain PyTorch version with the same
operands and result. There is no other fallback: a CUDA call either
launches the kernel or raises.

The kernel is memory-bound: its least time on the card is the K/V bytes
it must read (positions below each row's length) over the card's memory
rate, 3.35 TB/s on an H100 SXM (NVIDIA data sheet, 700 W).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpu_trainer_torch.ops import _build

_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_THREADS, _MAX_PER_THREAD = 128, 16       # csrc/flash_decode.cu constants
_SMEM_LIMIT = 48 * 1024


def _auto_splits(max_blocks: int) -> int:
    """Largest divisor of the table width <= 4 (the split-KV parallelism
    knob; mb must split evenly so every split walks the same count)."""
    for ns in (4, 3, 2):
        if max_blocks % ns == 0:
            return ns
    return 1


def _check(q, pool_k, pool_v, tables, lengths, k_scale, v_scale):
    if q.dim() != 3 or pool_k.dim() != 4:
        raise ValueError(
            f"q must be [b, h, d] and pools [nblk, bsz, kvh, d]; got "
            f"{tuple(q.shape)}, {tuple(pool_k.shape)}")
    b, h, d = q.shape
    nblk, bsz, kvh, dk = pool_k.shape
    if pool_v.shape != pool_k.shape or dk != d or h % kvh != 0:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, pool_k "
            f"{tuple(pool_k.shape)}, pool_v {tuple(pool_v.shape)}")
    if not q.is_floating_point():
        raise ValueError(f"q dtype {q.dtype} is not floating point")
    if pool_k.dtype not in _KV_CODES or pool_v.dtype != pool_k.dtype:
        raise ValueError(
            f"pool dtypes {pool_k.dtype}/{pool_v.dtype} (float32 | "
            f"bfloat16 | int8)")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if tables.dim() != 2 or tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / lengths {tuple(lengths.shape)} "
            f"do not match batch {b}")
    if pool_k.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need k_scale/v_scale")
        nbq = k_scale.shape[-1]
        if (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                or tuple(k_scale.shape) != (nblk, bsz, kvh, nbq)
                or v_scale.shape != k_scale.shape or d % nbq != 0):
            raise ValueError(
                f"scales must be f32 [nblk, bsz, kvh, d // qb]; got "
                f"{tuple(k_scale.shape)} {k_scale.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are only for int8 pools")


def flash_decode(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    n_splits: int = 0,
) -> torch.Tensor:
    """Single-query attention over a paged KV cache (flash-decoding).

    - ``q``: ``[batch, heads, head_dim]`` — one query token per row.
    - ``pool_k/pool_v``: ``[num_blocks, block_size, kv_heads, head_dim]``
      (f32 or bf16; or int8 with ``k_scale``/``v_scale``
      ``[num_blocks, block_size, kv_heads, head_dim // quant_block_len]``).
    - ``tables``: int32 ``[batch, max_blocks]`` block ids in position order.
    - ``lengths``: int32 ``[batch]`` valid tokens per row including the
      current one (>= 1 for live rows; a length-0 row yields NaN).

    Returns f32 ``[batch, heads, head_dim]``. GQA: query head ``ih`` reads
    kv head ``ih // (heads // kv_heads)``. ``flash_decode.launches``
    counts kernel launches (CUDA calls only).
    """
    _check(q, pool_k, pool_v, tables, lengths, k_scale, v_scale)
    mb = tables.shape[1]
    if not n_splits:
        n_splits = _auto_splits(mb)
    if mb % n_splits != 0:
        raise ValueError(f"max_blocks {mb} % n_splits {n_splits} != 0")
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, tables, lengths,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, pool_k, pool_v, tables, lengths, k_scale, v_scale,
                   n_splits)


flash_decode.launches = 0


def _launch(q, pool_k, pool_v, tables, lengths, k_scale, v_scale, n_splits):
    b, h, d = q.shape
    nblk, bsz, kvh, _ = pool_k.shape
    mb = tables.shape[1]
    group = h // kvh
    int8 = pool_k.dtype == torch.int8
    nbq = k_scale.shape[-1] if int8 else 1
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} unsupported by the kernel {_KERNEL_HEAD_DIMS}")
    if group * d > _THREADS * _MAX_PER_THREAD:
        raise ValueError(f"GQA group {group} x head_dim {d} > "
                         f"{_THREADS * _MAX_PER_THREAD}")
    smem = 4 * (group * d + 2 * bsz * d + group * bsz + 3 * group)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"block_size {bsz} needs {smem} B of shared memory "
                         f"> {_SMEM_LIMIT}")
    operands = [pool_k, pool_v, tables, lengths] + (
        [k_scale, v_scale] if int8 else [])
    for t in operands:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_decode operands must be contiguous")

    qf = (q.float() * (1.0 / math.sqrt(d))).contiguous()
    m_part = torch.empty((b, h, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((b, h, n_splits, d), dtype=torch.float32,
                           device=q.device)
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)

    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_launch(
            ptr(qf), ptr(pool_k), ptr(pool_v),
            ptr(k_scale if int8 else None), ptr(v_scale if int8 else None),
            ptr(tables), ptr(lengths), ptr(m_part), ptr(l_part),
            ptr(acc_part), ptr(out),
            b, h, kvh, d, nblk, bsz, mb, n_splits, nbq,
            _KV_CODES[pool_k.dtype], ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode kernel launch failed: {msg} ({err})")
    flash_decode.launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


def paged_attention_reference(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain ``flash_decode``: gather the whole table view, mask past each
    row's length, f32 softmax. Same operands/result contract."""
    b, h, d = q.shape
    nblk, bsz, kvh, _ = pool_k.shape
    group = h // kvh
    mb = tables.shape[1]
    if pool_k.dtype == torch.int8:
        nbq = k_scale.shape[-1]
        blkq = d // nbq

        def deq(p, s):
            return (p.float().reshape(nblk, bsz, kvh, nbq, blkq)
                    * s[..., None]).reshape(nblk, bsz, kvh, d)

        pool_k = deq(pool_k, k_scale)
        pool_v = deq(pool_v, v_scale)
    tl = tables.long()
    k = pool_k[tl].reshape(b, mb * bsz, kvh, d).float()
    v = pool_v[tl].reshape(b, mb * bsz, kvh, d).float()
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k)
    s = s * (1.0 / math.sqrt(d))
    pos = torch.arange(mb * bsz, device=q.device)[None, None]
    s = torch.where(pos < lengths.long()[:, None, None], s,
                    torch.full_like(s, float("-inf")))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", w, v)
