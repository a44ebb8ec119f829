"""Flash attention (port of ``tpu_trainer/ops/flash.py``).

Two kinds of kernel, each with its plain PyTorch version in this module:

- ``flash_attention``: causal training attention with fused RoPE,
  counter-based attention dropout and packed-sequence segment ids, BSHD in
  and out, differentiable. On a CUDA tensor the forward launches
  ``flash_forward`` and the backward either the fused ``flash_backward``
  or the split pair ``flash_backward_dkv`` + ``flash_backward_dq``
  (``backward_impl``: segment ids and long sequences take the split pair),
  the hand-written Hopper kernels of ``csrc/flash_attn.cu`` that replace
  the Pallas TPU kernels ``tpu_trainer/ops/flash.py::_fwd_kernel``,
  ``::_bwd_fused_kernel``, ``::_bwd_dkv_kernel`` and ``::_bwd_dq_kernel``;
  on a CPU tensor it runs ``flash_attention_reference``, dense attention
  with the same mask, RoPE fold, scale and dropout, differentiated by
  autograd.
- ``flash_decode``: single-query attention over a paged KV pool. On a
  CUDA tensor it launches ``csrc/flash_decode.cu``, which replaces
  ``tpu_trainer/ops/flash.py::_decode_kernel``; on a CPU tensor it runs
  ``paged_attention_reference``.

There is no other fallback: a CUDA call either launches its kernel or
raises. Each wrapper counts its launches in ``<wrapper>.launches``.

The decode kernel is memory-bound: its least time on the card is the K/V
bytes it must read (positions below each row's length) over the card's
memory rate, 3.35 TB/s on an H100 SXM (NVIDIA data sheet, 700 W). The
training kernels are bound by operations (see ``csrc/flash_attn.cu``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpu_trainer_torch.ops import _build
from tpu_trainer_torch.ops.attention import repeat_kv
from tpu_trainer_torch.ops.dropout import mul32, threshold_u32
from tpu_trainer_torch.ops.rope import rotate_half

_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


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
    counts kernel launches (CUDA calls only). The kernel takes head_dim
    16, 32, 64 or 128, any block size and group, and pools that start
    16-byte aligned.
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
    int8 = pool_k.dtype == torch.int8
    nbq = k_scale.shape[-1] if int8 else 1
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} unsupported by the kernel {_KERNEL_HEAD_DIMS}")
    operands = [pool_k, pool_v, tables, lengths] + (
        [k_scale, v_scale] if int8 else [])
    for t in operands:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash_decode operands must be contiguous")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("flash_decode pools must start 16-byte aligned (the "
                         "kernel loads 16 bytes at a time)")

    # The kernel scales q by 1/sqrt(d) in f32 as it loads it.
    qf = q.float().contiguous()
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


# --------------------------------------------------------------------------
# training attention: flash forward / fused and split backward
# --------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TRAIN_HEAD_DIMS = (64, 128)
_GOLDEN = 0x9E3779B9
_U32 = 0xFFFFFFFF
# Unsegmented calls up to this length take the fused backward, longer ones
# the split pair. chip_smoke.py's train-split phase times both at b*s =
# 8192 tokens (12 heads of 64, bf16) on an H100: the fused kernel is faster
# at every s it measured, up to 8192 (PERF.md); longer sequences are not
# measured.
_FUSED_BWD_MAX_SEQ = 8192
_BACKWARDS = (None, "fused", "split")
# q rows a ring stage of the bf16/fp16 backwards (csrc/flash_attn.cu
# kBwdBQ, kRowPad): the dq accumulator and the lse/delta rows are padded to
# a multiple.
_BWD_Q_TILE = 64


def _padded(s: int) -> int:
    return -(-s // _BWD_Q_TILE) * _BWD_Q_TILE


def backward_impl(seq: int, segmented: bool, backward=None) -> str:
    """``"fused"`` or ``"split"``: the backward a call takes. Segment ids
    always take the split pair (``"fused"`` with them raises, as in the
    JAX package); otherwise ``backward`` when given, else fused up to
    ``_FUSED_BWD_MAX_SEQ`` and split beyond."""
    if backward not in _BACKWARDS:
        raise ValueError(f"backward must be 'fused', 'split' or None; got "
                         f"{backward!r}")
    if segmented:
        if backward == "fused":
            raise NotImplementedError(
                "segment_ids require the split backward (the fused kernel "
                "has no segment masking)")
        return "split"
    return backward or ("fused" if seq <= _FUSED_BWD_MAX_SEQ else "split")


def _keep_mask(seed: int, salt, q_start: int, k_start: int, bq: int,
               bk: int, seq: int, rate: float) -> torch.Tensor:
    """Boolean keep mask of one ``[bq, bk]`` score block (port of the JAX
    ``_keep_mask``): the multiply-xorshift hash of the global position
    ``row * seq + col`` XOR ``seed + salt * golden``, uint32 throughout.

    ``salt`` is an int or an int64 tensor of salts (one per (batch,
    head)); the result has shape ``salt.shape + (bq, bk)``.
    """
    salt = torch.as_tensor(salt, dtype=torch.int64)
    dev = salt.device
    rows = (q_start + torch.arange(bq, dtype=torch.int64, device=dev)) & _U32
    cols = (k_start + torch.arange(bk, dtype=torch.int64, device=dev)) & _U32
    x = (mul32(rows, seq)[:, None] + cols[None, :]) & _U32
    key = (int(seed) + mul32(salt & _U32, _GOLDEN)) & _U32
    x = x ^ key[..., None, None]
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    return x >= threshold_u32(rate)


def keep_mask_full(seed: int, batch: int, heads: int, seq: int, rate: float,
                   device=None) -> torch.Tensor:
    """``[batch, heads, seq, seq]`` keep mask of a whole attention call:
    salt ``batch * heads + head`` per (batch, head), as the kernels use."""
    salts = torch.arange(batch * heads, dtype=torch.int64,
                         device=device).reshape(batch, heads)
    return _keep_mask(seed, salts, 0, 0, seq, seq, seq, rate)


def _rope_fold(q, k, rope, scale: float):
    """The kernels' q/k residuals: q rotated (f32) and scaled by
    ``1/sqrt(d)`` then cast; k rotated then cast (k unchanged without
    RoPE)."""
    q32 = q.float()
    if rope is None:
        return (q32 * scale).to(q.dtype), k
    cos, sin = (t.float()[None, :, None, :] for t in rope)
    k32 = k.float()
    qr = (q32 * cos + rotate_half(q32) * sin) * scale
    kr = k32 * cos + rotate_half(k32) * sin
    return qr.to(q.dtype), kr.to(k.dtype)


def _reference_parts(q, k, v, *, causal, dropout_rate, seed, rope,
                     segment_ids):
    """``(o, lse [b, h, s] f32, qs, ks)`` of the plain version."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qs, ks = _rope_fold(q, k, rope, scale)
    kx, vx = repeat_kv(ks, v, h)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kx.float())
    allowed = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        allowed = torch.tril(allowed)
    allowed = allowed[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(q.device)
        allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
    sc = sc.masked_fill(~allowed, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True).detach()
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        keep = keep_mask_full(seed, b, h, s, dropout_rate, device=q.device)
        p = torch.where(keep, p, torch.zeros_like(p))
        l_div = l * (1.0 - dropout_rate)
    else:
        l_div = l
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vx.float())
    o = (acc / l_div).transpose(1, 2).to(q.dtype)
    lse = (m + torch.log(l))[..., 0]
    return o, lse, qs, ks


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    rope: Optional[tuple] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain ``flash_attention``: dense scores from the same q/k fold
    (RoPE in f32, ``1/sqrt(d)`` folded into q, cast to the input dtype),
    f32 softmax normalised over the undropped weights, the same keep mask,
    ``p`` cast to v's dtype for the PV product, ``o = acc / (l * (1 -
    rate))``. Differentiable by autograd."""
    _check_train(q, k, v, dropout_rate, seed, segment_ids)
    return _reference_parts(q, k, v, causal=causal, dropout_rate=dropout_rate,
                            seed=seed, rope=rope, segment_ids=segment_ids)[0]


def _check_train(q, k, v, dropout_rate, seed, segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q, k, v must be [batch, seq, heads, head_dim] with k/v alike; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    if segment_ids is not None and tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"segment_ids must be [batch, seq] = {(b, s)}; got "
                         f"{tuple(segment_ids.shape)}")


def _train_operands(q, k, v, rope):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one "
                         f"of float32, bfloat16, float16")
    if q.shape[-1] not in _TRAIN_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} unsupported by the kernel "
                         f"{_TRAIN_HEAD_DIMS}")
    if q.shape[1] >= 2**16:
        raise ValueError("kernel positions are uint32: seq must be < 65536")
    for t in (k, v) + (tuple(rope) if rope is not None else ()):
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
    for t in (q, k, v) + (tuple(rope) if rope is not None else ()):
        if not t.is_contiguous():
            raise ValueError("flash_attention operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention operands must start 16-byte "
                             "aligned (the kernels load 16 bytes at a time)")
    if rope is not None:
        s, d = q.shape[1], q.shape[3]
        if any(t.dtype != torch.float32 or tuple(t.shape) != (s, d)
               for t in rope):
            raise ValueError(f"rope tables must be f32 [seq, head_dim] = "
                             f"{(s, d)}")


def _train_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    if lib.flash_attn_fwd.argtypes is None:
        P, I, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_uint32)
        tail = [I] * 7 + [F, U, U, F, I, P]
        for fn, n_ptrs in (("flash_attn_fwd", 10), ("flash_attn_bwd", 14),
                           ("flash_attn_bwd_dkv", 12),
                           ("flash_attn_bwd_dq", 10)):
            getattr(lib, fn).argtypes = [P] * n_ptrs + tail
            getattr(lib, fn).restype = I
        lib.flash_attn_bwd_turns.argtypes = [I] * 4
        lib.flash_attn_bwd_turns.restype = ctypes.c_longlong
        lib.flash_attn_keep_mask.argtypes = [P, U, U, I, U, I, I, I, P]
        lib.flash_attn_keep_mask.restype = I
        lib.flash_attn_error_string.argtypes = [I]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _dropout_args(dropout_rate: float, seed: Optional[int]):
    on = dropout_rate > 0.0
    return (ctypes.c_uint32(int(seed) & _U32 if on else 0),
            ctypes.c_uint32(threshold_u32(dropout_rate) if on else 0),
            ctypes.c_float(1.0 - dropout_rate), int(on))


def _segments(segment_ids, q) -> Optional[torch.Tensor]:
    """The kernels' segment operand: int32 ``[b, s]`` contiguous on q's
    device (None without segments)."""
    if segment_ids is None:
        return None
    b, s = q.shape[:2]
    if tuple(segment_ids.shape) != (b, s) or segment_ids.device != q.device:
        raise ValueError(f"segment_ids must be [batch, seq] = {(b, s)} on "
                         f"{q.device}; got {tuple(segment_ids.shape)} on "
                         f"{segment_ids.device}")
    return segment_ids.to(torch.int32).contiguous()


def _backward_operands(qs, ks, v, o, lse, do, rope, what):
    """Checks shared by the backward wrappers; returns ``do`` contiguous
    and 16-byte aligned."""
    if qs.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors; got {qs.device}")
    _train_operands(qs, ks, v, rope)
    b, s, h, _ = qs.shape
    if ((o is not None and o.shape != qs.shape) or do.shape != qs.shape
            or do.dtype != qs.dtype):
        raise ValueError("o / do must match q's shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse must be f32 [b, h, s] = {(b, h, s)}")
    do = do.contiguous()
    if do.data_ptr() % 16:
        do = do.clone()
    for t in (o, lse):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")
    return do


def _common_args(q, k, causal, dropout_rate, seed):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, _DTYPE_CODES[q.dtype], int(causal),
            ctypes.c_float(1.0 / math.sqrt(d)),
            *_dropout_args(dropout_rate, seed))


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def flash_forward(q, k, v, *, causal: bool = True, dropout_rate: float = 0.0,
                  seed: Optional[int] = None, rope: Optional[tuple] = None,
                  segment_ids: Optional[torch.Tensor] = None):
    """The forward kernel on CUDA tensors: ``(o, lse [b, h, s] f32, qs,
    ks)`` where ``qs`` is q rotated and scaled by ``1/sqrt(d)`` and ``ks``
    the rotated k (k itself without RoPE), the backward's residuals.
    ``segment_ids [b, s]`` (any integer dtype) isolate packed documents."""
    _check_train(q, k, v, dropout_rate, seed, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA tensors; got {q.device}")
    _train_operands(q, k, v, rope)
    seg = _segments(segment_ids, q)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    qs = torch.empty_like(q)
    ks = torch.empty_like(k) if rope is not None else k
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    cos, sin = rope if rope is not None else (None, None)
    lib = _train_lib()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(cos), _ptr(sin), _ptr(o),
            _ptr(lse), _ptr(qs), _ptr(ks if rope is not None else None),
            _ptr(seg), *_common_args(q, k, causal, dropout_rate, seed),
            _stream(q.device))
    _raise_on(lib, err, "flash_forward")
    flash_forward.launches += 1
    return o, lse, qs, ks


flash_forward.launches = 0


def _group_sum(part, like):
    """f32 per-query-head dk/dv partials ``[b, s, h, d]`` summed over each
    kv head's group and rounded once to ``like``'s dtype."""
    b, s, h, d = part.shape
    kvh = like.shape[2]
    return part.view(b, s, kvh, h // kvh, d).sum(dim=3).to(like.dtype)


def _dkv_outputs(qs, ks, v):
    """``(dk, dv, direct)`` as the backward kernels write them: bf16/fp16
    without GQA in the compute type (``direct``), otherwise f32
    per-query-head partials ``[b, s, h, d]`` for ``_group_sum``."""
    if qs.dtype != torch.float32 and ks.shape[2] == qs.shape[2]:
        return torch.empty_like(ks), torch.empty_like(v), True
    f32 = dict(dtype=torch.float32, device=qs.device)
    return torch.empty(qs.shape, **f32), torch.empty(qs.shape, **f32), False


def flash_backward(qs, ks, v, o, lse, do, *, causal: bool = True,
                   dropout_rate: float = 0.0, seed: Optional[int] = None,
                   rope: Optional[tuple] = None):
    """The fused backward kernel on CUDA tensors: ``(dq, dk, dv)`` from the
    forward's residuals (``qs``, ``ks``, ``o``, ``lse``) and ``do``.

    dq is summed in f32 across the kernel's blocks, each q tile's parts in
    ascending key-tile order whatever the timing (the JAX kernel's one
    order of a resident dq block), and dk and dv are owned by one block
    each: all three are bitwise the same from run to run. bf16/fp16
    without GQA: the kernel writes dk/dv in the compute type; otherwise
    f32 per-query-head partials are group-summed here and rounded once
    (bitwise the same for a group of one)."""
    do = _backward_operands(qs, ks, v, o, lse, do, rope, "flash_backward")
    b, s, h, d = qs.shape
    f32 = dict(dtype=torch.float32, device=qs.device)
    s_pad = _padded(s)
    delta = torch.empty((2, b, h, s_pad), **f32)
    dq_acc = torch.empty((b, h, s_pad, d), **f32)
    dk, dv, direct = _dkv_outputs(qs, ks, v)
    dq = torch.empty_like(qs)
    cos, sin = rope if rope is not None else (None, None)
    lib = _train_lib()
    turns = torch.empty(
        (lib.flash_attn_bwd_turns(b, s, h, _DTYPE_CODES[qs.dtype]),),
        dtype=torch.int32, device=qs.device)
    with torch.cuda.device(qs.device):
        err = lib.flash_attn_bwd(
            _ptr(qs), _ptr(ks), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(cos), _ptr(sin), _ptr(delta), _ptr(dq_acc), _ptr(turns),
            _ptr(dq), _ptr(dk), _ptr(dv),
            *_common_args(qs, ks, causal, dropout_rate, seed),
            _stream(qs.device))
    _raise_on(lib, err, "flash_backward")
    flash_backward.launches += 1
    if direct:
        return dq, dk, dv
    return dq, _group_sum(dk, ks), _group_sum(dv, v)


flash_backward.launches = 0


def flash_backward_dkv(qs, ks, v, o, lse, do, *, causal: bool = True,
                       dropout_rate: float = 0.0, seed: Optional[int] = None,
                       rope: Optional[tuple] = None,
                       segment_ids: Optional[torch.Tensor] = None):
    """The split backward's dk/dv kernel on CUDA tensors: ``(dk, dv,
    delta)``, ``delta [b, h, s_pad] = rowsum(do * o)`` f32 (``s_pad`` = s
    rounded up to 64, rows past s unused) for ``flash_backward_dq``. dk/dv
    are owned by one block each (bitwise the same from run to run);
    bf16/fp16 without GQA: written by the kernel in the compute type;
    otherwise group-summed here from f32 per-query-head partials and
    rounded once."""
    do = _backward_operands(qs, ks, v, o, lse, do, rope,
                            "flash_backward_dkv")
    seg = _segments(segment_ids, qs)
    b, s, h, _ = qs.shape
    f32 = dict(dtype=torch.float32, device=qs.device)
    s_pad = _padded(s)
    # delta_pad and lse_pad [b, h, s_pad], then the ids [b, s_pad] (int32).
    scratch = torch.empty((2 * b * h * s_pad + b * s_pad,), **f32)
    dk, dv, direct = _dkv_outputs(qs, ks, v)
    cos, sin = rope if rope is not None else (None, None)
    lib = _train_lib()
    with torch.cuda.device(qs.device):
        err = lib.flash_attn_bwd_dkv(
            _ptr(qs), _ptr(ks), _ptr(v), _ptr(o), _ptr(do), _ptr(lse),
            _ptr(cos), _ptr(sin), _ptr(seg), _ptr(scratch), _ptr(dk),
            _ptr(dv), *_common_args(qs, ks, causal, dropout_rate, seed),
            _stream(qs.device))
    _raise_on(lib, err, "flash_backward_dkv")
    flash_backward_dkv.launches += 1
    delta = scratch[:b * h * s_pad].view(b, h, s_pad)
    if direct:
        return dk, dv, delta
    return _group_sum(dk, ks), _group_sum(dv, v), delta


flash_backward_dkv.launches = 0


def flash_backward_dq(qs, ks, v, do, lse, delta, *, causal: bool = True,
                      dropout_rate: float = 0.0, seed: Optional[int] = None,
                      rope: Optional[tuple] = None,
                      segment_ids: Optional[torch.Tensor] = None):
    """The split backward's dq kernel on CUDA tensors: dq in q's dtype,
    written once by the block that owns its q tile (deterministic).
    ``delta`` is ``flash_backward_dkv``'s, ``[b, h, s_pad]``."""
    do = _backward_operands(qs, ks, v, None, lse, do, rope,
                            "flash_backward_dq")
    b, s, h, _ = qs.shape
    want = (b, h, _padded(s))
    if (delta.dtype != torch.float32 or tuple(delta.shape) != want
            or not delta.is_contiguous()):
        raise ValueError(f"delta must be contiguous f32 [b, h, s_pad] = "
                         f"{want}")
    seg = _segments(segment_ids, qs)
    dq = torch.empty_like(qs)
    cos, sin = rope if rope is not None else (None, None)
    lib = _train_lib()
    with torch.cuda.device(qs.device):
        err = lib.flash_attn_bwd_dq(
            _ptr(qs), _ptr(ks), _ptr(v), _ptr(do), _ptr(lse), _ptr(delta),
            _ptr(cos), _ptr(sin), _ptr(seg), _ptr(dq),
            *_common_args(qs, ks, causal, dropout_rate, seed),
            _stream(qs.device))
    _raise_on(lib, err, "flash_backward_dq")
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_split(qs, ks, v, o, lse, do, **kw):
    """``(dq, dk, dv)`` through the split pair: ``flash_backward_dkv``,
    then ``flash_backward_dq`` on its delta. Keywords as theirs."""
    dk, dv, delta = flash_backward_dkv(qs, ks, v, o, lse, do, **kw)
    return flash_backward_dq(qs, ks, v, do, lse, delta, **kw), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Kernel forward (saving o, lse and the rotated q/k), kernel
    backward: fused, or the split pair."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, seg, causal, dropout_rate, seed,
                impl):
        rope = (cos, sin) if cos is not None else None
        o, lse, qs, ks = flash_forward(q, k, v, causal=causal,
                                       dropout_rate=dropout_rate, seed=seed,
                                       rope=rope, segment_ids=seg)
        ctx.save_for_backward(qs, ks, v, o, lse, cos, sin, seg)
        ctx.opts = (causal, dropout_rate, seed, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        qs, ks, v, o, lse, cos, sin, seg = ctx.saved_tensors
        causal, dropout_rate, seed, impl = ctx.opts
        kw = dict(causal=causal, dropout_rate=dropout_rate, seed=seed,
                  rope=(cos, sin) if cos is not None else None)
        if impl == "fused":
            dq, dk, dv = flash_backward(qs, ks, v, o, lse, do, **kw)
        else:
            dq, dk, dv = flash_backward_split(qs, ks, v, o, lse, do,
                                              segment_ids=seg, **kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    dropout_rate: float = 0.0,
    seed: Optional[int] = None,
    rope: Optional[tuple] = None,
    segment_ids: Optional[torch.Tensor] = None,
    backward: Optional[str] = None,
) -> torch.Tensor:
    """Causal flash attention for training; BSHD in, BSHD out.

    - ``q [b, s, h, d]``, ``k``/``v`` ``[b, s, kvh, d]`` (GQA: query head
      ``i`` reads kv head ``i // (h // kvh)``).
    - ``dropout_rate > 0`` drops attention weights with the counter-based
      mask of ``seed`` (a uint32), bitwise the JAX interpret-mode mask.
    - ``rope=(cos, sin)`` (f32 ``[s, d]``) rotates q/k inside the kernel.
    - ``segment_ids [b, s]`` isolate packed documents (0 = padding):
      position i attends j only within one segment id.
    - ``backward``: ``"fused"``, ``"split"`` or None (``backward_impl``);
      ``"fused"`` with segment ids raises.

    CPU tensors run ``flash_attention_reference``; CUDA tensors the
    kernels (head_dim 64 or 128, f32 / bf16 / fp16), or raise.
    """
    _check_train(q, k, v, dropout_rate, seed, segment_ids)
    impl = backward_impl(q.shape[1], segment_ids is not None, backward)
    if q.device.type == "cpu":
        return _reference_parts(q, k, v, causal=causal,
                                dropout_rate=dropout_rate, seed=seed,
                                rope=rope, segment_ids=segment_ids)[0]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    cos, sin = rope if rope is not None else (None, None)
    return _FlashAttention.apply(q, k, v, cos, sin,
                                 _segments(segment_ids, q), causal,
                                 dropout_rate, seed, impl)


def keep_mask_cuda(seed: int, salt: int, seq: int, rate: float, *,
                   block_q: int, block_k: int, k_major: bool = False,
                   device="cuda") -> torch.Tensor:
    """``[seq, seq]`` bool keep mask of stream (seed, salt) dumped by a CUDA
    kernel through the same ``__device__`` hash the flash kernels use,
    generated tile by tile in q-major or k-major order (the counterpart of
    the JAX package's ``validate.py`` mask dump)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"keep_mask_cuda runs on CUDA; got {dev}")
    out = torch.empty((seq, seq), dtype=torch.uint8, device=dev)
    lib = _train_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attn_keep_mask(
            _ptr(out), ctypes.c_uint32(int(seed) & _U32),
            ctypes.c_uint32(int(salt) & _U32), seq,
            ctypes.c_uint32(threshold_u32(rate)), block_q, block_k,
            int(k_major), ctypes.c_void_p(stream))
    _raise_on(lib, err, "keep_mask_cuda")
    keep_mask_cuda.launches += 1
    return out.bool()


keep_mask_cuda.launches = 0
