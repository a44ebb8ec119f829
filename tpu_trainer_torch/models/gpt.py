"""GPT in paged-decode mode (port of ``tpu_trainer/models/gpt.py``).

The serving path of the JAX model: ``GPT.__call__(decode=True)`` over the
paged KV cache (``_paged_decode_attention``), with the rolled layer stack
as a Python loop over stacked ``[num_layers, ...]`` parameters.

Parameter names and layouts are the Flax ones with ``/`` written ``.``
(``embed_tokens.embedding``, ``layers.attention.q_proj.kernel`` ...):
Dense kernels are ``[in, out]`` and every ``layers.*`` leaf carries the
leading ``num_layers`` axis ``nn.scan`` gives it, so a Flax param tree
maps onto this module name for name (``models/weights.py``).

Numerics follow the JAX module: RMSNorm in f32 with the output cast to
the compute dtype; projections as compute-dtype matmuls (q/k/v and
gate/up fused into one matmul over concatenated kernels); RoPE in f32;
prefill scores in the compute dtype masked with ``finfo.min`` and an f32
softmax cast back before the PV product; decode attention through
``ops.flash.flash_decode`` (f32 result cast back); the tied head in the
compute dtype, logits returned as f32.

The block pools are updated in place (the JAX module returns new pools);
that keeps one copy of the cache on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.ops import flash as flash_lib
from tpu_trainer_torch.ops.attention import repeat_kv
from tpu_trainer_torch.ops.rope import apply_rotary_pos_emb, rope_tables
from tpu_trainer_torch.utils.quant import (
    dequantize_kv_int8,
    quant_block_len,
    quantize_kv_int8,
)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * weight`` in f32, cast to ``dtype``.
    ``stack`` adds the leading layer axis to the weight."""

    def __init__(self, dim: int, *, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32,
                 stack: Optional[int] = None, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        shape = (dim,) if stack is None else (stack, dim)
        self.weight = _param(shape, torch.float32, device)

    def forward(self, x: torch.Tensor, layer: Optional[int] = None):
        w = self.weight if layer is None else self.weight[layer]
        x32 = x.float()
        rms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + self.eps)
        return (x32 * rms * w).to(self.dtype)


class Dense(nn.Module):
    """A no-bias Flax ``Dense``: kernel ``[stack, in, out]``, output in the
    compute dtype."""

    def __init__(self, in_features: int, out_features: int, *, stack: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((stack, in_features, out_features), param_dtype,
                             device)

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel[layer].to(self.dtype)


def _fused_projection(x: torch.Tensor, denses: List[Dense], layer: int,
                      dtype: torch.dtype) -> List[torch.Tensor]:
    """Several no-bias projections of ``x`` as ONE matmul over the
    concatenated kernels; returns the per-projection outputs."""
    w = torch.cat([m.kernel[layer] for m in denses], dim=1).to(dtype)
    out = x.to(dtype) @ w
    return list(torch.split(out, [m.kernel.shape[-1] for m in denses],
                            dim=-1))


@dataclasses.dataclass
class PagedStep:
    """Per-forward paged-cache addressing shared by every layer: RoPE rows,
    the pool scatter targets, and the lengths/offsets/tables of the pass."""

    cos: torch.Tensor        # [b, s, d] f32
    sin: torch.Tensor        # [b, s, d] f32
    blk_ids: torch.Tensor    # [b*s] int64 pool block per fed position
    offs: torch.Tensor       # [b*s] int64 slot inside the block
    tables: torch.Tensor     # [b, mb] int32
    lengths: torch.Tensor    # [b] int32
    offsets: torch.Tensor    # [b] int32
    hist_blocks: int


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention, paged-decode branch only."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        kv = cfg.kv_heads * cfg.head_dim
        dense = dict(stack=cfg.num_layers, dtype=cfg.compute_dtype,
                     param_dtype=cfg.params_dtype, device=device)
        self.q_proj = Dense(cfg.hidden_size, cfg.hidden_size, **dense)
        self.k_proj = Dense(cfg.hidden_size, kv, **dense)
        self.v_proj = Dense(cfg.hidden_size, kv, **dense)
        self.o_proj = Dense(cfg.hidden_size, cfg.hidden_size, **dense)

    def forward(self, x: torch.Tensor, layer: int, cache: Dict[str, torch.Tensor],
                step: PagedStep) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        if cfg.fused_projections:
            q, k, v = _fused_projection(
                x, [self.q_proj, self.k_proj, self.v_proj], layer,
                cfg.compute_dtype)
        else:
            q = self.q_proj(x, layer)
            k = self.k_proj(x, layer)
            v = self.v_proj(x, layer)
        q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.kv_heads, cfg.head_dim)
        out = self._paged_attention(q, k, v, layer, cache, step)
        return self.o_proj(out.reshape(b, s, cfg.hidden_size), layer)

    def _paged_attention(self, q, k, v, layer, cache, step: PagedStep):
        """Scatter this call's k/v into the layer's pools, then attend.

        Prefill (``s > 1``): the chunk's queries attend its in-flight k/v
        (ragged causal in local coordinates, pad queries keep their own
        position so their rows stay finite) plus, with ``hist_blocks``,
        the first ``hist_blocks`` pooled blocks masked below
        ``offsets[r]`` — history keys first, in ascending global position.
        Decode (``s == 1``): the new token attends ``lengths + 1`` pooled
        positions through ``flash_decode``.
        """
        cfg = self.config
        b, s, h, d = q.shape
        kvh = k.shape[2]
        bsz = cfg.paged_block_size
        int8 = cfg.paged_kv_int8
        pool_k, pool_v = cache["pool_k"][layer], cache["pool_v"][layer]
        q, k = apply_rotary_pos_emb(q, k, step.cos, step.sin)

        if int8:
            k_q, k_s = quantize_kv_int8(k)
            v_q, v_s = quantize_kv_int8(v)
            scale_k, scale_v = cache["scale_k"][layer], cache["scale_v"][layer]
            idx = (step.blk_ids, step.offs)
            pool_k[idx] = k_q.reshape(b * s, kvh, d)
            pool_v[idx] = v_q.reshape(b * s, kvh, d)
            scale_k[idx] = k_s.reshape(b * s, kvh, -1)
            scale_v[idx] = v_s.reshape(b * s, kvh, -1)
        else:
            idx = (step.blk_ids, step.offs)
            pool_k[idx] = k.to(pool_k.dtype).reshape(b * s, kvh, d)
            pool_v[idx] = v.to(pool_v.dtype).reshape(b * s, kvh, d)
            scale_k = scale_v = None

        if s == 1:
            # flash_decode runs the plain version on CPU tensors, so
            # paged_attention="reference" needs no path of its own (the
            # engine refuses it on CUDA).
            out = flash_lib.flash_decode(
                q[:, 0], pool_k, pool_v, step.tables, step.lengths + 1,
                k_scale=scale_k, v_scale=scale_v)
            return out.to(q.dtype)[:, None]

        kf, vf = k, v
        if int8:
            # Attend the quantization the pool holds, as a later decode
            # step will read it.
            kf = dequantize_kv_int8(k_q, k_s, q.dtype)
            vf = dequantize_kv_int8(v_q, v_s, q.dtype)
        kf, vf = repeat_kv(kf, vf, h)
        scale = 1.0 / (d ** 0.5)
        neg = torch.finfo(q.dtype).min
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
        pos = torch.arange(s, device=q.device)
        q_pos, k_pos = pos[:, None], pos[None, :]
        chunk_len = (step.lengths - step.offsets).long()[:, None, None]
        allowed = (k_pos <= q_pos)[None] & (
            (k_pos[None] < chunk_len) | (k_pos == q_pos)[None])
        scores = scores.masked_fill(~allowed[:, None], neg)
        v_cat = vf
        hb = step.hist_blocks
        if hb > 0:
            # The post-scatter pool: positions this chunk wrote are
            # >= offsets and masked out here.
            htab = step.tables[:, :hb].long()
            hk = pool_k[htab].reshape(b, hb * bsz, kvh, d)
            hv = pool_v[htab].reshape(b, hb * bsz, kvh, d)
            if int8:
                hk = dequantize_kv_int8(
                    hk, scale_k[htab].reshape(b, hb * bsz, kvh, -1), q.dtype)
                hv = dequantize_kv_int8(
                    hv, scale_v[htab].reshape(b, hb * bsz, kvh, -1), q.dtype)
            else:
                hk, hv = hk.to(q.dtype), hv.to(q.dtype)
            hk, hv = repeat_kv(hk, hv, h)
            h_scores = torch.einsum("bqhd,bkhd->bhqk", q, hk) * scale
            h_pos = torch.arange(hb * bsz, device=q.device)
            h_allowed = h_pos[None] < step.offsets.long()[:, None]
            h_scores = h_scores.masked_fill(~h_allowed[:, None, None], neg)
            scores = torch.cat([h_scores, scores], dim=-1)
            v_cat = torch.cat([hv, vf], dim=1)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v_cat)


class MLP(nn.Module):
    """SwiGLU feed-forward: ``down(act(gate(x)) * up(x))``."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dense = dict(stack=cfg.num_layers, dtype=cfg.compute_dtype,
                     param_dtype=cfg.params_dtype, device=device)
        self.gate_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **dense)
        self.up_proj = Dense(cfg.hidden_size, cfg.intermediate_size, **dense)
        self.down_proj = Dense(cfg.intermediate_size, cfg.hidden_size, **dense)

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        cfg = self.config
        if cfg.fused_projections:
            gate, up = _fused_projection(
                x, [self.gate_proj, self.up_proj], layer, cfg.compute_dtype)
        else:
            gate, up = self.gate_proj(x, layer), self.up_proj(x, layer)
        if cfg.activation == "silu":
            act = F.silu(gate)
        else:  # flax nn.gelu is the tanh approximation
            act = F.gelu(gate, approximate="tanh")
        return self.down_proj(act * up, layer)


class TransformerBlock(nn.Module):
    """Pre-norm block; holds every layer's parameters stacked."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = config
        norm = dict(dtype=cfg.compute_dtype, stack=cfg.num_layers,
                    device=device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, **norm)
        self.attention = CausalSelfAttention(cfg, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, **norm)
        self.mlp = MLP(cfg, device=device)

    def forward(self, x, layer: int, cache, step: PagedStep):
        x = x + self.attention(self.input_layernorm(x, layer), layer, cache,
                               step)
        return x + self.mlp(self.post_attention_layernorm(x, layer), layer)


class Embed(nn.Module):
    """Tied embedding: lookup and ``attend`` (the LM head) in the compute
    dtype."""

    def __init__(self, num: int, features: int, *, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((num, features), param_dtype, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids].to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.embedding.to(self.dtype).T


class GPT(nn.Module):
    """GPT for causal LM, paged-decode forward. Parameters are allocated
    uninitialized (``device="meta"`` allocates nothing): load them from
    ``models.weights.init_params`` / ``from_jax_params``."""

    def __init__(self, config: GPTConfig, *, device=None):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError("MoE is not ported yet")
        self.config = cfg = config
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.compute_dtype,
                                  param_dtype=cfg.params_dtype, device=device)
        self.layers = TransformerBlock(cfg, device=device)
        self.norm = RMSNorm(cfg.hidden_size, dtype=cfg.compute_dtype,
                            device=device)

    def forward(self, input_ids: torch.Tensor, cache: Dict[str, torch.Tensor],
                *, hist_blocks: int = 0,
                logits_at: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One paged pass over ``input_ids [b, s]`` (``s == 1``: decode).

        ``cache`` is ``init_paged_cache``'s dict; its ``tables`` /
        ``lengths`` / ``offsets`` carry the caller's scheduling state for
        this pass (same contract as the JAX cache variables) and its pools
        are written in place. ``hist_blocks`` is the chunked-prefill
        history width in blocks. Returns f32 logits ``[b, s, vocab]``, or
        ``[b, 1, vocab]`` at position ``logits_at[r]`` of each row when
        given (the final norm and head then run on those rows only).
        """
        cfg = self.config
        if not cfg.decode_paged:
            raise ValueError("GPT.forward needs config.decode_paged=True")
        x = self.embed_tokens(input_ids)
        step = paged_step(cfg, cache, input_ids.shape[1], hist_blocks)
        for layer in range(cfg.num_layers):
            x = self.layers(x, layer, cache, step)
        if logits_at is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, logits_at.long()][:, None]
        x = self.norm(x)
        return self.embed_tokens.attend(x).float()


def paged_step(cfg: GPTConfig, cache, s: int, hist_blocks: int) -> PagedStep:
    """RoPE rows and scatter targets of a pass feeding ``s`` tokens per row.

    Positions are ``lengths[r]`` (decode) or ``offsets[r] + i`` (a chunk),
    RoPE-clamped to the table length ``mb * bsz - 1``; prefill padding
    (position >= the row's length) scatters into the null block 0.
    """
    if not 0 <= hist_blocks <= cfg.paged_max_blocks:
        raise ValueError(f"hist_blocks {hist_blocks} outside "
                         f"[0, {cfg.paged_max_blocks}]")
    tables, lengths, offsets = (cache["tables"], cache["lengths"],
                                cache["offsets"])
    device = tables.device
    bsz, mb = cfg.paged_block_size, cfg.paged_max_blocks
    cos, sin = rope_tables(mb * bsz, cfg.head_dim, cfg.rope_theta,
                           device=device)
    len64 = lengths.long()
    if s == 1:
        pos = len64[:, None]
        valid = torch.ones_like(pos, dtype=torch.bool)
    else:
        pos = offsets.long()[:, None] + torch.arange(s, device=device)[None]
        valid = pos < len64[:, None]
    rope_pos = torch.clamp(pos, max=mb * bsz - 1)
    blk = torch.gather(tables.long(), 1, torch.clamp(pos // bsz, max=mb - 1))
    zero = torch.zeros_like(blk)
    return PagedStep(
        cos=cos[rope_pos], sin=sin[rope_pos],
        blk_ids=torch.where(valid, blk, zero).reshape(-1),
        offs=torch.where(valid, pos % bsz, zero).reshape(-1),
        tables=tables, lengths=lengths, offsets=offsets,
        hist_blocks=hist_blocks,
    )


def init_paged_cache(config: GPTConfig, batch_size: int, *,
                     device) -> Dict[str, torch.Tensor]:
    """Zero-initialized paged cache: per-layer pools ``[L, nblk, bsz, kvh,
    d]`` (compute dtype, or int8 plus f32 scales ``[..., d // qb]``), and
    the ``tables [b, mb]`` / ``lengths [b]`` / ``offsets [b]`` int32
    scheduling state the caller overwrites before every pass."""
    cfg = config
    if not cfg.decode_paged:
        raise ValueError("init_paged_cache needs config.decode_paged=True")
    d = cfg.head_dim
    shape = (cfg.num_layers, cfg.paged_num_blocks, cfg.paged_block_size,
             cfg.kv_heads, d)
    kv_dtype = torch.int8 if cfg.paged_kv_int8 else cfg.compute_dtype
    cache = {
        "pool_k": torch.zeros(shape, dtype=kv_dtype, device=device),
        "pool_v": torch.zeros(shape, dtype=kv_dtype, device=device),
        "tables": torch.zeros((batch_size, cfg.paged_max_blocks),
                              dtype=torch.int32, device=device),
        "lengths": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
        "offsets": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
    }
    if cfg.paged_kv_int8:
        sshape = shape[:-1] + (d // quant_block_len(d),)
        cache["scale_k"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        cache["scale_v"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
    return cache

