"""Blockwise-absmax int8 quantization (port of ``tpu_trainer/utils/quant.py``).

Two consumers with the same numerics:

- the paged KV cache (``quantize_kv_int8`` / ``dequantize_kv_int8``): signed
  absmax per block of ``quant_block_len(d)`` along head_dim;
- the optimizer state (``quantize_blockwise_int8`` into a ``QuantPack``):
  the on-device narrow Adam moments (``training/optimizer.py``,
  ``optimizer_state_dtype="int8"``) and the host-offloaded moments
  (``training/trainer.py``, ``offload_dtype="int8"``). Signed moments
  quantize directly; Adam's nonnegative second moment quantizes in
  sqrt-space (``nonneg``), clamped at 0 before the sqrt.

``scale = max|y| / 127`` (f32), ``q = round(y / max(scale, 1e-30))``.
``torch.round`` rounds half to even like ``jnp.round``, so the int8 payload
and the scales match the JAX package bit for bit.

**A rank's slice of a leaf** (ZeRO-2/3 at world > 1, whose shard may cut a
leaf's last dim, or a tensor axis, whose Megatron slice of a
column-parallel kernel is of its last dim): the blocks stay the whole
leaf's (``BlockCut``, over the group that cuts that dim). Rank
``r`` holds elements ``[lo, hi)`` of the last dim ``d``; its pack holds
every block of ``quant_block_len(d)`` those elements touch, the elements
outside ``[lo, hi)`` padded with zeros (which move no absmax). A block that
two ranks share (``straddles``) takes its absmax as the max over the group
(an all-gather of the ranks' block maxima, before any rank scales). So
``q`` and ``scale`` of the elements a rank holds are exactly those of the
pack one process would hold; ``cut_boxes`` and ``cut_from_global`` map a
slice to and from that pack's arrays (the checkpoint keeps the one-process
pack, restorable at any world size).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

QUANT_BLOCK = 256  # target block length along the last dim


@dataclasses.dataclass(frozen=True)
class BlockCut:
    """Elements ``[lo, hi)`` of a last dim of ``d``, quantized in the
    blocks of the whole dim; ``group`` (a ``parallel.collectives``
    ``Collectives``, or None at one process) holds the ranks that share
    the cut blocks."""

    lo: int
    hi: int
    d: int
    group: Optional[object] = dataclasses.field(default=None, compare=False)

    @property
    def block(self) -> int:
        return quant_block_len(self.d)

    @property
    def first(self) -> int:
        """The first global block the slice touches."""
        return self.lo // self.block

    @property
    def end(self) -> int:
        """One past the last global block the slice touches."""
        return -(-self.hi // self.block)

    @property
    def pad_lo(self) -> int:
        return self.lo - self.first * self.block

    @property
    def pad_hi(self) -> int:
        return self.end * self.block - self.hi

    @property
    def straddles(self) -> bool:
        """Does a block of the slice belong to another rank too? (With
        equal slices, it is a property of the leaf: every rank has one.)"""
        return bool(self.pad_lo or self.pad_hi)


@dataclasses.dataclass
class QuantPack:
    """A blockwise-int8 tensor: ``q`` int8 ``[..., nb, B]`` and ``scale``
    f32 ``[..., nb]``; with ``cut`` the blocks a rank's slice touches
    (``BlockCut``). A type of its own, so a parameter that happens to be
    named ``q`` or ``scale`` is never taken for a pack."""

    q: torch.Tensor
    scale: torch.Tensor
    cut: Optional[BlockCut] = None

    def tensors(self):
        return (self.q, self.scale)


def quant_block_len(d: int) -> int:
    """Largest of {256, 128, 64, 32} dividing ``d`` (else ``d`` itself)."""
    for b in (QUANT_BLOCK, 128, 64, 32):
        if d % b == 0:
            return b
    return d


def _sqrt(y: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 sqrt, as XLA and CUDA's ``sqrtf`` give
    it. torch's vectorized f32 sqrt on the CPU is not (about one value in
    200 an ulp off, which moves an int8 code), so the CPU takes it in f64:
    rounding the f64 root to f32 is exact."""
    if y.device.type == "cpu":
        return torch.sqrt(y.double()).float()
    return torch.sqrt(y)


def _shared_block_max(amax: torch.Tensor, cut: BlockCut) -> torch.Tensor:
    """The group's max of each block the slice touches: every rank's block
    maxima placed at their global blocks (zeros elsewhere), all-gathered,
    maxed; absmax is never below 0, so the zeros move nothing."""
    nb = cut.d // cut.block
    buf = amax.new_zeros(amax.shape[:-1] + (nb,))
    buf[..., cut.first:cut.end] = amax
    every = cut.group.all_gather_leaf(buf[None], 0, kind="quant_absmax")
    return every.amax(dim=0)[..., cut.first:cut.end]


def quantize_blockwise_int8(x: torch.Tensor, *, nonneg: bool,
                            cut: Optional[BlockCut] = None) -> QuantPack:
    """Blockwise absmax int8 along the last dim of ``x``; ``nonneg``
    quantizes ``sqrt(max(x, 0))`` instead. With ``cut``, ``x`` is a rank's
    slice of the last dim and the blocks are the whole dim's (module
    docstring); a straddling cut runs one collective over ``cut.group``,
    so every rank of it must quantize the leaf at the same point."""
    d = x.shape[-1]
    blk = quant_block_len(d) if cut is None else cut.block
    y = x.float()
    if nonneg:
        y = _sqrt(torch.clamp(y, min=0.0))
    if cut is not None and cut.straddles:
        y = F.pad(y, (cut.pad_lo, cut.pad_hi))
    y = y.reshape(x.shape[:-1] + (y.shape[-1] // blk, blk))
    amax = y.abs().amax(dim=-1)
    if (cut is not None and cut.straddles and cut.group is not None
            and cut.group.world > 1):
        amax = _shared_block_max(amax, cut)
    scale = amax / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(y / safe[..., None]).to(torch.int8)
    return QuantPack(q=q, scale=scale, cut=cut)


def pack_shape(pack: QuantPack) -> tuple:
    """The shape of the (sliced) leaf a pack holds."""
    n = (pack.q.shape[-2] * pack.q.shape[-1] if pack.cut is None
         else pack.cut.hi - pack.cut.lo)
    return tuple(pack.q.shape[:-2]) + (n,)


def dequantize_blockwise_int8(pack: QuantPack, shape, dtype, *,
                              nonneg: bool) -> torch.Tensor:
    """Inverse of ``quantize_blockwise_int8``: f32 product (squared when
    ``nonneg``), the padding of a cut dropped, reshaped to ``shape`` and
    cast to ``dtype``."""
    y = pack.q.float() * pack.scale[..., None]
    if nonneg:
        y = y * y
    cut = pack.cut
    if cut is not None and cut.straddles:
        y = y.reshape(y.shape[:-2] + (-1,)).narrow(-1, cut.pad_lo,
                                                   cut.hi - cut.lo)
    return y.reshape(shape).to(dtype)


def cut_global_shapes(pack: QuantPack, lead_shape=None) -> tuple:
    """``(q shape, scale shape)`` of the one-process pack a cut pack is a
    slice of; ``lead_shape`` is the whole leaf's leading dims (default:
    the pack's own, when no other axis slices them)."""
    cut = pack.cut
    nb = cut.d // cut.block
    lead = tuple(pack.q.shape[:-2] if lead_shape is None else lead_shape)
    return lead + (nb, cut.block), lead + (nb,)


def cut_boxes(q, scale, cut: BlockCut, lead=None):
    """Where a rank's cut pack (host arrays ``q [..., n, B]``, ``scale
    [..., n]``) lies in the one-process pack: ``(q boxes, scale boxes)``,
    each a list of ``(starts, array)`` whose boxes of all ranks tile the
    global arrays once. ``q``: the elements the rank holds (a partial
    block at either end, the whole blocks between); ``scale``: the blocks
    that start inside ``[lo, hi)`` (a shared block's scale, the same on
    every rank, is written by the rank that holds its start). ``lead``:
    the starts of the rank's slice of the leading dims (default zeros:
    they are whole)."""
    B = cut.block
    lead = tuple(lead) if lead is not None else (0,) * (q.ndim - 2)
    boxes = []
    i, n = 0, q.shape[-2]
    while i < n:
        g = cut.first + i
        a = max(cut.lo, g * B) - g * B
        b = min(cut.hi, (g + 1) * B) - g * B
        if a == 0 and b == B:                 # a run of whole blocks
            j = i
            while (j < n and cut.lo <= (cut.first + j) * B
                   and (cut.first + j + 1) * B <= cut.hi):
                j += 1
            boxes.append((lead + (g, 0), q[..., i:j, :]))
            i = j
        else:
            boxes.append((lead + (g, a), q[..., i:i + 1, a:b]))
            i += 1
    s0 = -(-cut.lo // B)
    s1 = -(-cut.hi // B)
    sboxes = ([(lead + (s0,), scale[..., s0 - cut.first:s1 - cut.first])]
              if s1 > s0 else [])
    return boxes, sboxes


def cut_from_global(q_all, scale_all, cut: BlockCut):
    """A rank's cut pack arrays from the one-process pack's (numpy or
    torch): its blocks, the elements outside ``[lo, hi)`` zeroed as
    ``quantize_blockwise_int8`` pads them."""
    q = q_all[..., cut.first:cut.end, :].copy()
    if cut.pad_lo:
        q[..., 0, :cut.pad_lo] = 0
    if cut.pad_hi:
        q[..., -1, cut.block - cut.pad_hi:] = 0
    return q, scale_all[..., cut.first:cut.end].copy()


def quantize_kv_int8(x: torch.Tensor):
    """``x [..., d]`` -> ``(q int8 [..., d], scale f32 [..., d // blk])``."""
    pack = quantize_blockwise_int8(x, nonneg=False)
    return pack.q.reshape(x.shape), pack.scale


def dequantize_kv_int8(q: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv_int8``: f32 product, cast to ``dtype``."""
    d = q.shape[-1]
    nb = scale.shape[-1]
    pack = QuantPack(q=q.reshape(q.shape[:-1] + (nb, d // nb)), scale=scale)
    return dequantize_blockwise_int8(pack, q.shape, dtype, nonneg=False)
