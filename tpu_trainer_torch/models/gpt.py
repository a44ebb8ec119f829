"""GPT (port of ``tpu_trainer/models/gpt.py``): training, paged decode,
and KV-cached generation over a contiguous cache.

Two branches of ``GPT.forward``, chosen by ``config.decode_paged``, and
``GPT.decode``:

- **Training / evaluation** (``GPT.__call__`` without ``decode``):
  ``forward(input_ids, labels=None, *, train=False, segment_ids=None,
  generator=None) -> (logits, loss)``. The layer stack runs as the JAX
  package's unrolled path (``scan_unroll``): each stacked ``[num_layers,
  ...]`` parameter is unbound once per forward, so autograd stacks each
  layer's gradient with one write instead of a zeroed full-size buffer per
  layer (the role of the JAX ``_unstack_layers``). Attention goes through
  ``ops.flash.flash_attention`` (the CUDA kernels on a CUDA tensor)
  when ``use_flash_attention``, else ``reference_attention``; residual
  dropout is ``ops.dropout.hash_dropout`` (``fast_dropout``). Every
  dropout seed is drawn from ``generator``. The loss is the fused head +
  shifted CE (``ops.loss``) when ``fused_loss``. With ``num_experts > 0``
  each layer's FFN is the MoE of ``models/moe.py`` (the capacity or the
  dropless router, by ``moe_impl``) and the loss adds the layers' mean
  router auxiliary.
  ``gradient_checkpointing`` recomputes each block in the backward
  (``_remat_block``): ``remat_policy="full"`` keeps only the block input,
  ``"dots"`` also keeps every matmul output (JAX ``dots_saveable``); the
  flash and grouped-matmul kernels are recomputed under both. Without
  ``fused_loss``, ``remat_lm_head`` recomputes the head matmul and the
  cross entropy in the backward. Decode and no-grad passes never remat.
- **Paged decode** (``decode=True`` with ``decode_paged``):
  ``forward(input_ids, cache, *, hist_blocks=0, logits_at=None)`` over the
  paged KV cache (``_paged_decode_attention``), decode attention through
  ``ops.flash.flash_decode``. A MoE layer routes all ``max_batch x
  width`` rows of the pass, idle slots' zero ids included, as the JAX
  engine's does (its auxiliary is dropped). Under ``paged_tp > 1`` the
  cache holds one pool set a shard (``serving/sharding.py``): each shard's
  kv-head slice is written to its pools (a replicated pool takes every
  head), decode runs ``ops.flash.paged_attention_sharded``, and prefill
  runs the local attention per query-head slice on the slice's shard,
  the slices concatenated in shard order, as the JAX ``attend`` closure
  under ``shard_map``.
- **Contiguous KV cache** (``GPT.decode(input_ids, cache)``, the JAX
  ``_decode_attention``): ``init_cache``'s ``[L, b, len, kvh, d]`` buffers
  and running length; a call appends its tokens and attends every cached
  position up to its own, with ragged left padding. The JAX package
  computes this attention with ``jnp.einsum`` outside any Pallas kernel,
  and so does the port (plain PyTorch ops). ``generate_kv`` (prefill +
  one token a step), ``generate`` (the windowed full forward, at the exact
  shapes: the JAX package's ``generate_bucketed`` pads to power-of-two
  widths only to bound XLA recompiles, which eager PyTorch does not
  have) drive it; temperature 0 is the exact argmax, and
  a sampled token draws from a ``torch.Generator`` seeded by (seed + row,
  token index), as the serving engine's requests do.

Parameter names and layouts are the Flax ones with ``/`` written ``.``
(``embed_tokens.embedding``, ``layers.attention.q_proj.kernel`` ...):
Dense kernels are ``[in, out]`` and every ``layers.*`` leaf carries the
leading ``num_layers`` axis ``nn.scan`` gives it, so a Flax param tree
maps onto this module name for name (``models/weights.py``).

Numerics follow the JAX module: RMSNorm in f32 with the output cast to
the compute dtype; projections as compute-dtype matmuls (q/k/v and
gate/up fused into one matmul over concatenated kernels); RoPE in f32;
paged prefill scores in the compute dtype masked with ``finfo.min`` and
an f32 softmax cast back before the PV product; decode attention through
``ops.flash.flash_decode`` (f32 result cast back); the tied head in the
compute dtype, logits returned as f32.

The block pools are updated in place (the JAX module returns new pools);
that keeps one copy of the cache on the device.

At world > 1 a trainer sets three attributes (``training/trainer.py``):
``zero3`` (ZeRO-3: the parameters are this rank's shards, gathered by a
``parallel.collectives.ZeroGather``; the embedding and final norm once a
forward, a block's inside the block. The training forward runs inside
``collectives.regather_saved``: autograd keeps no gathered weight, nor
its cast to the compute dtype (``_matmuls`` makes it through
``collectives.derive``), and the backward gathers it again; under the
remat checkpoint the block's rerun gathers again instead) and
``data_shard`` (this rank's data shard and their count: residual dropout
hashes the global batch's linear index, so a shard's mask is the
one-process mask's rows, and the attention-dropout seed folds in the
shard, ``ops.attention.fold_seed``) and, for MoE, ``moe_group`` (the
routing ``Collectives``, the ranks that hold distinct tokens: each MoE
layer routes the global micro-batch, ``models/moe.py``; ``eval/infer.py``
sets it too).

**Tensor and sequence parallelism** (``parallel/context.current_mesh``,
which the trainer and ``eval/infer.py`` enter around a pass). Under a
``tensor`` axis the parameters are the rank's Megatron slices
(``parallel/sharding.py``): the embedding's ``[V, H/ts]`` hidden slice is
looked up and gathered (``collectives.gather_from_tensor``); each block's
normed input enters the column-parallel q/k/v and gate/up matmuls through
``copy_to_tensor``; attention runs the flash kernel on the rank's
``num_heads / ts`` heads (``kv_heads / ts`` K/V heads); the row-parallel
o/down products are summed by ``reduce_from_tensor``; the loss is the
vocab-sharded head (``ops/loss._tp_loss``), the logits the row-parallel
head summed. ``fused_projections`` is not used there (the JAX rule: the
fusion would concatenate the sharded axis). Residual activations are
replicated over ``tensor``, so every tensor rank draws the same residual
dropout; the attention-dropout seed folds the JAX
``attention_shard_coord`` (data shard, then tensor rank).

Under a ``sequence`` axis the rank runs its ``[b, s/sp]`` slice of the
sequence: RoPE at global positions (its chunk offset), attention through
the ring (``ops/ring.py``, each chunk through the flash kernel with
``return_lse``), residual dropout hashing the global positions of its
slice (so its masks are the one-process masks' columns), and the loss
over its tokens with the labels shifted globally (``labels`` then carries
one more column, the next rank's first token; the last global position
is masked) as its share of the global mean. ``segment_ids`` raise there.

Under an ``expert`` axis (and for MoE under ``tensor``) the MoE block's
stacked expert leaves are the rank's ``[L, E / ep, H, I / tp]`` slices
and ``models/moe.py`` runs the rank's local experts, summing the layer's
output over the expert and tensor ranks; everything else of the forward
is replicated over ``expert``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.moe import moe_ffn
from tpu_trainer_torch.ops import flash as flash_lib
from tpu_trainer_torch.ops.attention import (
    fold_seed,
    reference_attention,
    repeat_kv,
)
from tpu_trainer_torch.ops import ring as ring_lib
from tpu_trainer_torch.ops.dropout import hash_dropout
from tpu_trainer_torch.ops.loss import (
    fused_shifted_cross_entropy,
    segment_target_mask,
    shard_shift,
)
from tpu_trainer_torch.ops.rope import apply_rotary_pos_emb, rope_tables
from tpu_trainer_torch.parallel import collectives as coll_lib
from tpu_trainer_torch.parallel import context as ctx_lib
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.utils import telemetry
from tpu_trainer_torch.utils.quant import (
    dequantize_kv_int8,
    quant_block_len,
    quantize_kv_int8,
)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


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
        return _rms_norm(x, w, self.eps, self.dtype)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
              dtype: torch.dtype) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * w).to(dtype)


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
        if cfg.paged_tp > 1:
            return self._paged_attention_tp(q, k, v, layer, cache, step)
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
        hist = ()
        if step.hist_blocks > 0:
            hist = _history(
                {"pool_k": pool_k, "pool_v": pool_v, "scale_k": scale_k,
                 "scale_v": scale_v}, step, slice(0, kvh), h, q.dtype)
        return _prefill_attend(q, kf, vf, step.lengths, step.offsets, *hist)

    def _paged_attention_tp(self, q, k, v, layer, cache, step: PagedStep):
        """``_paged_attention`` over a tensor-parallel replica's shards
        (``cache["shards"]``, one pool set each, ``serving/sharding.py``).
        Shard ``i`` owns query heads ``i*h/tp ..`` and, with kv-sharded
        pools, kv heads ``i*kvh/tp ..``; a replicated pool (``tp %
        kvh == 0``) holds every kv head and its slice reads one."""
        cfg = self.config
        b, s, h, d = q.shape
        kvh = k.shape[2]
        shards = cache["shards"]
        tp = len(shards)
        hl = h // tp
        kv_shard = kvh % tp == 0
        kvl = kvh // tp if kv_shard else kvh
        q, k = apply_rotary_pos_emb(q, k, step.cos, step.sin)
        if cfg.paged_kv_int8:
            k_q, k_s = quantize_kv_int8(k)
            v_q, v_s = quantize_kv_int8(v)
            rows = {"pool_k": k_q, "pool_v": v_q, "scale_k": k_s,
                    "scale_v": v_s}
        else:
            rows = {"pool_k": k, "pool_v": v}
        for i, sh in enumerate(shards):
            lo = i * kvl if kv_shard else 0
            dev = sh["pool_k"].device
            idx = (step.blk_ids.to(dev), step.offs.to(dev))
            for key, x in rows.items():
                pool = sh[key][layer]
                pool[idx] = x[:, :, lo:lo + kvl].to(
                    device=dev, dtype=pool.dtype).reshape(b * s, kvl, -1)

        def kv_window(i):
            # The shard's kv heads, as indices into its own pools.
            return (slice(0, kvl) if kv_shard
                    else slice(i // (tp // kvh), i // (tp // kvh) + 1))

        if s == 1:
            pools = {key: [sh[key][layer] for sh in shards]
                     for key in shards[0]}
            out = flash_lib.paged_attention_sharded(
                q[:, 0], pools["pool_k"], pools["pool_v"], step.tables,
                step.lengths + 1, kv_heads=kvh,
                k_scales=pools.get("scale_k"), v_scales=pools.get("scale_v"))
            return out.to(q.dtype)[:, None]

        kf, vf = k, v
        if cfg.paged_kv_int8:
            kf = dequantize_kv_int8(k_q, k_s, q.dtype)
            vf = dequantize_kv_int8(v_q, v_s, q.dtype)
        # Repeat to the query heads, then cut by head (the JAX order).
        kf, vf = repeat_kv(kf, vf, h)
        outs = []
        for i, sh in enumerate(shards):
            dev = sh["pool_k"].device
            heads = slice(i * hl, (i + 1) * hl)
            hist = ()
            if step.hist_blocks > 0:
                hist = _history({key: sh[key][layer] for key in sh}, step,
                                kv_window(i), hl, q.dtype)
            out = _prefill_attend(
                *(x[:, :, heads].to(dev) for x in (q, kf, vf)),
                step.lengths.to(dev), step.offsets.to(dev), *hist)
            outs.append(out.to(q.device))
        return torch.cat(outs, dim=2)


def _history(pools, step: PagedStep, window: slice, heads: int, dtype):
    """The first ``hist_blocks`` pooled blocks of each row's table, kv
    heads ``window`` of ``pools`` (``pool_k`` / ``pool_v``, int8 with
    ``scale_k`` / ``scale_v``), dequantized or cast to ``dtype`` and
    repeated to ``heads`` query heads: ``(hk, hv)`` ``[b, hb*bsz, heads,
    d]`` on the pools' device. The post-scatter pool: positions the pass
    wrote are >= offsets and masked out by the caller."""
    pool_k, pool_v = pools["pool_k"], pools["pool_v"]
    _, bsz, _, d = pool_k.shape
    hb = step.hist_blocks
    b = step.tables.shape[0]
    htab = step.tables[:, :hb].long().to(pool_k.device)
    n = window.stop - window.start

    def rows(pool):
        return pool[htab][:, :, :, window].reshape(b, hb * bsz, n, -1)

    hk, hv = rows(pool_k), rows(pool_v)
    if pools.get("scale_k") is not None:
        hk = dequantize_kv_int8(hk, rows(pools["scale_k"]), dtype)
        hv = dequantize_kv_int8(hv, rows(pools["scale_v"]), dtype)
    else:
        hk, hv = hk.to(dtype), hv.to(dtype)
    return repeat_kv(hk, hv, heads)


def _prefill_attend(q, kf, vf, lengths, offsets, hk=None, hv=None):
    """A prefill chunk's attention (the JAX ``attend`` closure): ``q``
    ``[b, s, h, d]`` against its in-flight ``kf`` / ``vf`` (repeated to the
    query heads; ragged causal in local coordinates, a pad query keeps its
    own position so its row stays finite) and, given, the pooled history
    ``hk`` / ``hv`` masked below ``offsets`` — history keys first, in
    ascending global position. Heads are independent, so a slice of the
    heads is the same arithmetic on fewer of them."""
    b, s, _, d = q.shape
    scale = 1.0 / (d ** 0.5)
    neg = torch.finfo(q.dtype).min
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
    pos = torch.arange(s, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    chunk_len = (lengths - offsets).long()[:, None, None]
    allowed = (k_pos <= q_pos)[None] & (
        (k_pos[None] < chunk_len) | (k_pos == q_pos)[None])
    scores = scores.masked_fill(~allowed[:, None], neg)
    v_cat = vf
    if hk is not None:
        h_scores = torch.einsum("bqhd,bkhd->bhqk", q, hk) * scale
        h_pos = torch.arange(hk.shape[1], device=q.device)
        h_allowed = h_pos[None] < offsets.long()[:, None]
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


class MoEMLP(nn.Module):
    """The MoE FFN's stacked parameters under their Flax names (both
    routers share them): ``router.kernel [L, H, E]`` (f32),
    ``experts_gate`` / ``experts_up`` ``[L, E, H, I]`` and ``experts_down
    [L, E, I, H]``; the computation is ``models.moe.moe_ffn``."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        L, E = cfg.num_layers, cfg.num_experts
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.router = Dense(H, E, stack=L, dtype=torch.float32,
                            param_dtype=torch.float32, device=device)
        self.experts_gate = _param((L, E, H, I), cfg.params_dtype, device)
        self.experts_up = _param((L, E, H, I), cfg.params_dtype, device)
        self.experts_down = _param((L, E, I, H), cfg.params_dtype, device)

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        """Layer ``layer``'s FFN of ``x [b, s, H]`` (the paged path: the
        auxiliary is dropped, as in the JAX decode)."""
        return moe_ffn(x, self.router.kernel[layer], self.experts_gate[layer],
                       self.experts_up[layer], self.experts_down[layer],
                       self.config)[0]


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
        self.moe = cfg.num_experts > 0
        if self.moe:
            self.moe_mlp = MoEMLP(cfg, device=device)
        else:
            self.mlp = MLP(cfg, device=device)

    def forward(self, x, layer: int, cache, step: PagedStep):
        x = x + self.attention(self.input_layernorm(x, layer), layer, cache,
                               step)
        ffn = self.moe_mlp if self.moe else self.mlp
        return x + ffn(self.post_attention_layernorm(x, layer), layer)


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
    """GPT for causal LM. Parameters are allocated uninitialized
    (``device="meta"`` allocates nothing): load them from
    ``models.weights.init_params`` / ``from_jax_params``."""

    def __init__(self, config: GPTConfig, *, device=None):
        super().__init__()
        self.config = cfg = config
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.compute_dtype,
                                  param_dtype=cfg.params_dtype, device=device)
        self.layers = TransformerBlock(cfg, device=device)
        self.norm = RMSNorm(cfg.hidden_size, dtype=cfg.compute_dtype,
                            device=device)
        # Set by a trainer at world > 1 (module docstring).
        self.zero3 = None
        self.data_shard = (0, 1)
        self.moe_group = None
        # The global indices of the layers this rank holds (a stage's).
        self.stage_layers = list(range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, *args, **kwargs):
        """``config.decode_paged``: ``_paged_forward(input_ids, cache, *,
        hist_blocks=0, logits_at=None) -> logits``; otherwise
        ``_train_forward(input_ids, labels=None, *, train=False,
        segment_ids=None, generator=None) -> (logits, loss)``."""
        if self.config.decode_paged:
            return self._paged_forward(input_ids, *args, **kwargs)
        if self.zero3 is not None and torch.is_grad_enabled():
            with coll_lib.regather_saved():
                return self._train_forward(input_ids, *args, **kwargs)
        return self._train_forward(input_ids, *args, **kwargs)

    # -- training / evaluation ---------------------------------------------

    def _train_forward(self, input_ids: torch.Tensor,
                       labels: Optional[torch.Tensor] = None, *,
                       train: bool = False,
                       segment_ids: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """Full-sequence forward over ``input_ids [b, s]``.

        ``train`` turns dropout on; every dropout seed is drawn from
        ``generator`` (a CPU ``torch.Generator``). ``segment_ids [b, s]``
        (0 = padding, documents 1..K) isolate packed documents in attention
        and mask loss targets that cross a boundary.

        Returns ``(logits [b, s, vocab] f32, loss | None)``. With ``labels``
        and ``fused_loss`` the loss never needs the logits, and ``logits``
        is None (the JAX graph drops them as dead code; eager PyTorch would
        compute them).
        """
        cfg = self.config
        b, s = input_ids.shape
        cd = cfg.compute_dtype
        mesh = ctx_lib.current_mesh()
        if mesh is not None and mesh.pp > 1:
            if segment_ids is not None:
                raise NotImplementedError(
                    "segment_ids are not supported under pipeline "
                    "parallelism")
            raise ValueError("under a stage axis a rank holds its stage's "
                             "layers: run GPT.pipeline_step (the trainer "
                             "does)")
        step = self._train_step_of(s, train, generator, segment_ids,
                                   input_ids.device)
        tp, seq = step.tensor, step.seq
        emb = self._leaf("embed_tokens.embedding")
        x = coll_lib.gather_from_tensor(emb[input_ids].to(cd), tp)
        capturing = telemetry.capturing()
        if capturing:
            telemetry.record("embed_out", telemetry.site_stats(x))
            step.telem = []
        block = self._block_fn()
        moe_aux = 0.0
        for p in self._unstacked_layers():
            x, aux = block(x, p, step)
            if aux is not None:
                moe_aux = moe_aux + aux
        if step.telem:
            telemetry.record("layers", telemetry.stack_layers(step.telem))
        x = _rms_norm(x, self._leaf("norm.weight"), self.norm.eps,
                      self.norm.dtype)
        if capturing:
            telemetry.record("final_norm", telemetry.site_stats(x))

        def attend(h):
            return _tied_logits(h, emb, tp, cd)

        if telemetry.capturing(deep=True):
            # The full f32 logits, nan-scan only: without this site a NaN
            # entering in the head product is indistinguishable from one
            # entering in the loss (the fused loss never forms them).
            with torch.no_grad():
                telemetry.record("logits",
                                 telemetry.site_stats(attend(x).float()))

        remat_head = (labels is not None and not cfg.fused_loss
                      and cfg.remat_lm_head)
        logits = None
        if labels is None or not (cfg.fused_loss or remat_head):
            logits = attend(x).float()
        loss = None
        seq_shard = None if seq is None else (seq[0] * s, s * seq[1])
        if labels is not None:
            if cfg.fused_loss:
                loss = fused_shifted_cross_entropy(
                    emb, x, labels,
                    chunk_size=cfg.loss_chunk_size,
                    allow_pallas=cfg.fused_loss_pallas,
                    segment_ids=segment_ids, tensor=tp, seq_shard=seq_shard)
            elif remat_head:
                # Nothing of the [b, s, vocab] softmax survives the
                # forward; the backward recomputes the head matmul.
                def head_loss(xf):
                    return _shifted_loss(attend(xf).float(), labels,
                                         segment_ids, seq_shard)

                loss = (checkpoint(head_loss, x, use_reentrant=False)
                        if torch.is_grad_enabled() else head_loss(x))
            else:
                loss = _shifted_loss(logits, labels, segment_ids, seq_shard)
            if cfg.num_experts > 0:
                # The layers' pre-weighted router auxiliaries, meaned
                # (under sequence each rank's is its 1 / sp share, as its
                # loss is).
                sp = 1 if seq is None else seq[1]
                loss = loss + moe_aux / (cfg.num_layers * sp)
        return logits, loss

    def _train_step_of(self, s: int, train: bool, generator, segment_ids,
                       device) -> "_TrainStep":
        """What every layer of a training forward over ``s`` local
        positions shares: the active mesh's tensor group and sequence
        ring, the RoPE rows (global positions under sequence), the data
        shard and the attention-shard fold."""
        cfg = self.config
        dropout_on = train and (cfg.dropout > 0.0
                                or cfg.attention_dropout > 0.0)
        if dropout_on and generator is None:
            raise ValueError("train=True with dropout needs a generator")
        mesh = ctx_lib.current_mesh()
        tp = _tensor_group(mesh)
        seq = None
        if mesh is not None and mesh.sp > 1:
            if segment_ids is not None:
                raise NotImplementedError(
                    "segment_ids are not supported under sequence "
                    "parallelism")
            seq = (mesh.sp_rank, mesh.sp, mesh.permute)
        if seq is None:
            rope = rope_tables(s, cfg.head_dim, cfg.rope_theta,
                               device=device)
        else:
            # Global positions: this rank's chunk of the sequence.
            cos, sin = rope_tables(s * seq[1], cfg.head_dim, cfg.rope_theta,
                                   device=device)
            rope = (cos[seq[0] * s:(seq[0] + 1) * s],
                    sin[seq[0] * s:(seq[0] + 1) * s])
        return _TrainStep(train=train, generator=generator, rope=rope,
                          segment_ids=segment_ids, shard=self.data_shard,
                          tensor=tp, seq=seq,
                          attn_coord=_attention_coord(mesh, self.data_shard,
                                                      cfg))

    def _block_fn(self):
        """One layer of the training forward: under remat (and grad) the
        checkpointed block, else the plain one."""
        remat = torch.is_grad_enabled()
        return (self._remat_block
                if self.config.gradient_checkpointing and remat
                else self._train_block)

    # -- the pipeline (parallel/pipeline.py) --------------------------------

    def pipeline_step(self, input_ids: torch.Tensor, labels: torch.Tensor,
                      leaves, *, train: bool, generator=None,
                      loss_scale: float = 1.0, backward: bool = True,
                      micro: Optional[int] = None, segment_ids=None):
        """This stage rank's part of one pipelined step over its rows
        ``input_ids [b, s]`` (``labels``: the same, or under sequence the
        ``s + 1`` label columns), on the active mesh's stage group and
        schedule. Returns ``(loss, grads, stats)``: the step's loss, the
        same on every stage rank, the f32 gradients of ``leaves`` summed
        over the microbatches (seeded with ``loss_scale``; None entries
        where a leaf got none), or None without ``backward`` (a forward
        of ``micro`` microbatches, default the schedule's, through
        ``pipeline.forward_schedule`` under no_grad: evaluation and the
        nan scan), and the executor's ``parallel/pipeline.Stats``."""
        from tpu_trainer_torch.parallel import pipeline as pp

        if segment_ids is not None:
            raise NotImplementedError(
                "segment_ids are not supported under pipeline parallelism")
        mesh = ctx_lib.current_mesh()
        sched = mesh.schedule
        if not backward:
            sched = pp.forward_schedule(sched, micro)
        hooks = _StageHooks(self, mesh, sched, input_ids, labels, leaves,
                            train=train, generator=generator,
                            loss_scale=loss_scale)
        head, aux, grads, stats = pp.execute(sched, mesh.stage, mesh.pp_rank,
                                             hooks, backward=backward)
        if backward:
            grads = [a if b is None else b.float() if a is None
                     else a.add_(b.float())
                     for a, b in zip(grads, hooks.finish())]
        last = mesh.pp_rank == sched.stages - 1
        dev = input_ids.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        parts = torch.stack([
            head.float() if last and head is not None else zero,
            aux.float() if aux is not None else zero])
        h, a = mesh.stage.all_reduce_sum(parts, kind="pp_allreduce")
        loss = h + a * hooks.aux_weight if hooks.aux_weight else h
        return loss, grads, stats

    def _leaf(self, name: str) -> torch.Tensor:
        """A parameter outside the layer stack, gathered under ZeRO-3."""
        module, attr = name.rsplit(".", 1)
        t = getattr(self.get_submodule(module), attr)
        return t if self.zero3 is None else self.zero3.leaf(name, t)

    def _unstacked_layers(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer views of the stacked ``layers.*`` parameters, one
        ``unbind`` per parameter (its backward is a single stack). Under
        ZeRO-3 the views are of this rank's shards (``_gather_layer``
        gathers a layer's inside its block); a leaf sharded along the
        layer dim (only where the layer count is its largest divisible
        dim) is gathered whole here instead."""
        named = list(self.layers.named_parameters())
        z = self.zero3
        if z is not None:
            named = [(n, p if z.per_layer(f"layers.{n}")
                      else z.leaf(f"layers.{n}", p)) for n, p in named]
        views = [p.unbind(0) for _, p in named]
        return [{n: v[i] for (n, _), v in zip(named, views)}
                for i in range(len(views[0]))]

    def _gather_layer(self, p: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """One layer's full parameters from its shard views (ZeRO-3; the
        views themselves otherwise)."""
        z = self.zero3
        if z is None:
            return p
        return {n: z.layer(f"layers.{n}", t) for n, t in p.items()}

    def _qkv(self, x, p, tp=None):
        """q ``[b, s, heads, d]``, k and v ``[b, s, kv_heads, d]`` of one
        layer: the input norm and the projections in the compute dtype
        (under the tensor group ``tp``, this rank's heads: the
        column-parallel slices)."""
        cfg = self.config
        b, s, _ = x.shape
        ts = 1 if tp is None else tp.world
        h = _rms_norm(x, p["input_layernorm.weight"],
                      self.layers.input_layernorm.eps, cfg.compute_dtype)
        h = coll_lib.copy_to_tensor(h, tp)
        q, k, v = _matmuls(h, [p["attention.q_proj.kernel"],
                               p["attention.k_proj.kernel"],
                               p["attention.v_proj.kernel"]],
                           cfg.compute_dtype,
                           cfg.fused_projections and ts == 1)
        return (q.reshape(b, s, cfg.num_heads // ts, cfg.head_dim),
                k.reshape(b, s, cfg.kv_heads // ts, cfg.head_dim),
                v.reshape(b, s, cfg.kv_heads // ts, cfg.head_dim))

    def _train_block(self, x, p, step: "_TrainStep"):
        cfg = self.config
        cd = cfg.compute_dtype
        b, s, _ = x.shape
        p = self._gather_layer(p)
        q, k, v = self._qkv(x, p, step.tensor)
        attn_drop = step.train and cfg.attention_dropout > 0.0
        rate = cfg.attention_dropout if attn_drop else 0.0
        if step.seq is not None:
            # The ring over the sequence group: RoPE at the slice's global
            # positions first, then every chunk through the flash kernel.
            idx, sp, permute = step.seq
            q, k = apply_rotary_pos_emb(q, k, *step.rope)
            out = ring_lib.ring_attention_local(
                [q], [k], [v], [idx], sp, permute, dropout_rate=rate,
                seed=step.attention_seed() if attn_drop else None)[0]
        elif cfg.use_flash_attention:
            out = flash_lib.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                dropout_rate=rate,
                seed=step.attention_seed() if attn_drop else None,
                rope=step.rope, segment_ids=step.segment_ids)
        else:
            q, k = apply_rotary_pos_emb(q, k, *step.rope)
            gen = step.generator
            if attn_drop and step.attn_coord is not None:
                # Masks differ across shards (the flash path's seed
                # fold): a generator seeded from the folded seed.
                gen = torch.Generator(device=gen.device).manual_seed(
                    step.attention_seed())
            out = reference_attention(
                q, k, v, dropout_rate=cfg.attention_dropout,
                deterministic=not step.train, generator=gen,
                segment_ids=step.segment_ids)
        out = _matmuls(out.reshape(b, s, out.shape[2] * out.shape[3]),
                       [p["attention.o_proj.kernel"]], cd, False)[0]
        out = coll_lib.reduce_from_tensor(out, step.tensor)
        attn_out = self._residual_dropout(out, step)
        return self._ffn_block(x + attn_out, p, step, attn_out=attn_out)

    def _remat_block(self, x, p, step: "_TrainStep"):
        """``_train_block`` under ``torch.utils.checkpoint``: the backward
        reruns the block. Every dropout draw of the block comes from a
        generator restored to the state the block started from, so the
        rerun draws the forward's seeds and masks; the step's generator
        then continues from where the forward's draws left it, exactly as
        without remat. Telemetry stats are recorded by the first run only:
        the rerun gets no stats list."""
        gen = step.generator
        end = {}
        runs = []

        def run(x_in):
            inner = dataclasses.replace(step, telem=None) if runs else step
            runs.append(1)
            if gen is not None:
                g = torch.Generator(device=gen.device)
                g.set_state(start)
                inner = dataclasses.replace(inner, generator=g)
            out = self._train_block(x_in, p, inner)
            if gen is not None:
                end["state"] = inner.generator.get_state()
            return out

        start = None if gen is None else gen.get_state()
        ctx = (_dots_saveable_contexts if self.config.remat_policy == "dots"
               else noop_context_fn)
        out = checkpoint(run, x, use_reentrant=False, context_fn=ctx,
                         preserve_rng_state=False)
        if gen is not None:
            gen.set_state(end["state"])
        return out

    def _ffn_block(self, x, p, step: "_TrainStep", attn_out=None):
        """``(x + dropout(FFN(norm(x))), router aux or None)`` of one
        layer (dense or MoE). With a telemetry list on ``step``, appends
        the layer's attention (``attn_out``), FFN and block output stats
        and, for MoE, its router stats."""
        cfg = self.config
        cd = cfg.compute_dtype
        eps = self.layers.input_layernorm.eps
        h = _rms_norm(x, p["post_attention_layernorm.weight"], eps, cd)
        aux = None
        router = {} if step.telem is not None else None
        if cfg.num_experts > 0:
            out, aux = moe_ffn(
                h, p["moe_mlp.router.kernel"], p["moe_mlp.experts_gate"],
                p["moe_mlp.experts_up"], p["moe_mlp.experts_down"], cfg,
                router_stats=router, group=self.moe_group,
                tokens=step.moe_tokens)
        else:
            tp = step.tensor
            gate, up = _matmuls(coll_lib.copy_to_tensor(h, tp),
                                [p["mlp.gate_proj.kernel"],
                                 p["mlp.up_proj.kernel"]], cd,
                                cfg.fused_projections and tp is None)
            act = (F.silu(gate) if cfg.activation == "silu"
                   else F.gelu(gate, approximate="tanh"))
            out = coll_lib.reduce_from_tensor(
                _matmuls(act * up, [p["mlp.down_proj.kernel"]], cd,
                         False)[0], tp)
        ffn_out = self._residual_dropout(out, step)
        x = x + ffn_out
        if step.telem is not None:
            stats = {}
            for site, t in (("attn", attn_out), ("ffn", ffn_out),
                            ("block", x)):
                stats[f"{site}_rms"] = telemetry.rms(t)
                stats[f"{site}_absmax"] = telemetry.absmax(t)
            stats.update({f"router_{k}": v for k, v in router.items()})
            step.telem.append(stats)
        return x, aux

    def _residual_dropout(self, x, step: "_TrainStep"):
        """Residual-stream dropout: the counter-based hash mask with
        ``fast_dropout``, a Bernoulli mask otherwise."""
        rate = self.config.dropout
        if not step.train or rate <= 0.0:
            return x
        rows = x.shape[0]
        # This rank's rows of the global batch (a pipeline's microbatch:
        # its share of the global microbatch): [row0, row0 + rows) of
        # ``total``.
        if step.rows is not None:
            row0, total_rows = step.rows
        else:
            coord, shards = step.shard
            row0, total_rows = coord * rows, shards * rows
        # Under sequence: this rank's columns of the global [b, S, H].
        j, sp = (0, 1) if step.seq is None else step.seq[:2]
        sl = x.shape[1]
        if self.config.fast_dropout:
            seed = step.seed()
            if rows == 0:
                return x
            per_row = x.numel() // rows
            # The hash runs over the global batch's linear index: data
            # shard r's rows are the world-1 mask's rows [r*b, (r+1)*b)
            # (and a sequence rank's columns [j*sl, (j+1)*sl) of them).
            return hash_dropout(x, rate, seed,
                                offset=row0 * per_row * sp,
                                total=total_rows * per_row * sp,
                                seq_slice=(j * sl, sl * sp) if sp > 1
                                else None)
        gen = step.generator
        keep = (torch.rand((total_rows, sl * sp) + tuple(x.shape[2:]),
                           generator=gen, device=gen.device)
                >= rate)[row0:row0 + rows,
                         j * sl:(j + 1) * sl].to(x.device)
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    # -- contiguous KV cache ------------------------------------------------

    @torch.no_grad()
    def decode(self, input_ids: torch.Tensor,
               cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One KV-cached pass over ``input_ids [b, s]`` (prefill: the
        prompt; decode: ``s == 1``): appends the tokens' k/v at
        ``cache["idx"]`` (in place), advances it, and returns f32 logits
        ``[b, s, vocab]``. Each query attends the cached positions up to
        its own; with ``cache["pad"]`` (ragged batches, left padding) a
        row's positions below its pad are excluded and its RoPE positions
        start at its first real token."""
        cfg = self.config
        b, s = input_ids.shape
        idx = int(cache["idx"])
        max_len = cache["k"].shape[2]
        if idx + s > max_len:
            raise ValueError(f"cache holds {max_len} positions; {idx} used "
                             f"+ {s} new")
        dev = input_ids.device
        cos, sin = rope_tables(max_len, cfg.head_dim, cfg.rope_theta,
                               device=dev)
        q_pos = idx + torch.arange(s, device=dev)[:, None]
        k_pos = torch.arange(max_len, device=dev)[None, :]
        pad = cache.get("pad")
        if pad is None:
            rope = (cos[idx:idx + s], sin[idx:idx + s])
            allowed = (k_pos <= q_pos)[None, None]
        else:
            pad = pad.long()
            lpos = torch.clamp(q_pos.T - pad[:, None], min=0)   # [b, s]
            rope = (cos[lpos], sin[lpos])
            # Pad-region queries keep their own position, so their
            # (never read) softmax rows stay finite.
            allowed = ((k_pos <= q_pos)[None]
                       & ((k_pos[None] >= pad[:, None, None])
                          | (k_pos == q_pos)[None]))[:, None]
        tp = _tensor_group(ctx_lib.current_mesh())
        step = _TrainStep(train=False, generator=None, rope=rope,
                          segment_ids=None, tensor=tp)
        emb = self.embed_tokens.embedding
        x = coll_lib.gather_from_tensor(
            emb[input_ids].to(cfg.compute_dtype), tp)
        for layer, p in enumerate(self._unstacked_layers()):
            x, _ = self._kv_block(x, p, layer, cache, step, allowed, idx)
        cache["idx"] = idx + s
        h = coll_lib.slice_to_tensor(self.norm(x), tp)
        return coll_lib.reduce_from_tensor(
            h.to(cfg.compute_dtype) @ emb.to(cfg.compute_dtype).T,
            tp).float()

    def _kv_block(self, x, p, layer: int, cache, step: "_TrainStep",
                  allowed: torch.Tensor, idx: int):
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = self._qkv(x, p, step.tensor)
        q, k = apply_rotary_pos_emb(q, k, *step.rope)
        ck, cv = cache["k"][layer], cache["v"][layer]
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        k_all, v_all = repeat_kv(ck.to(q.dtype), cv.to(q.dtype),
                                 q.shape[2])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all) * (
            1.0 / cfg.head_dim ** 0.5)
        scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v_all)
        out = _matmuls(out.reshape(b, s, q.shape[2] * q.shape[3]),
                       [p["attention.o_proj.kernel"]], cfg.compute_dtype,
                       False)[0]
        out = coll_lib.reduce_from_tensor(out, step.tensor)
        return self._ffn_block(x + out, p, step)

    # -- paged decode ---------------------------------------------------------

    def _paged_forward(self, input_ids: torch.Tensor,
                       cache: Dict[str, torch.Tensor], *,
                       hist_blocks: int = 0,
                       logits_at: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
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
        x = self.embed_tokens(input_ids)
        step = paged_step(cfg, cache, input_ids.shape[1], hist_blocks)
        for layer in range(cfg.num_layers):
            x = self.layers(x, layer, cache, step)
        if logits_at is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, logits_at.long()][:, None]
        x = self.norm(x)
        return self.embed_tokens.attend(x).float()


@dataclasses.dataclass
class _TrainStep:
    """What every layer of one training forward shares."""

    train: bool
    generator: Optional[torch.Generator]
    rope: tuple                       # (cos, sin) f32 [s, head_dim]
    segment_ids: Optional[torch.Tensor]
    # Per-layer telemetry stats of a captured forward, else None.
    telem: Optional[list] = None
    # This rank's data shard (coordinate, count); (0, 1) at one process.
    shard: tuple = (0, 1)
    # The tensor group's Collectives, None without a tensor axis.
    tensor: Optional[object] = None
    # (sequence rank, sequence size, ring permute), None without the axis.
    seq: Optional[tuple] = None
    # The JAX attention_shard_coord when some axis shards the attention
    # operands, else None (no fold).
    attn_coord: Optional[int] = None
    # A pipeline microbatch: this rank's rows [row0, row0 + rows) of the
    # global microbatch's ``total`` (residual dropout), else None (the
    # data shard's block).
    rows: Optional[tuple] = None
    # The routing group's token count of a microbatch whose ranks' shares
    # differ in size (models/moe.route), else None.
    moe_tokens: Optional[int] = None

    def __post_init__(self):
        if self.attn_coord is None and self.shard[1] > 1:
            self.attn_coord = self.shard[0]

    def seed(self) -> int:
        """A fresh uint32 dropout seed from the generator."""
        return int(torch.randint(0, 2**32, (1,), generator=self.generator,
                                 dtype=torch.int64).item())

    def attention_seed(self) -> int:
        """A fresh attention-dropout seed, folded with the attention shard
        coordinate when some axis shards the operands (the JAX
        ``attention_shard_coord`` fold: data shard, then tensor rank):
        masks decorrelate across shards, and one process draws the plain
        seed."""
        seed = self.seed()
        return (seed if self.attn_coord is None
                else fold_seed(seed, self.attn_coord))


class _StageHooks:
    """The model's side of ``parallel/pipeline.execute`` for one stage rank
    (``GPT.pipeline_step``): the strided microbatches of the rank's rows,
    the embedding on global stage 0, each chunk's layers with their global
    indices, and the head (GPipe: the fused loss on the reassembled batch,
    last stage; 1F1B: this rank's vocabulary slice of a microbatch's head
    over the stage group).

    Under a tensor axis the blocks run as ``_train_forward``'s (the step's
    tensor group), stage 0's lookup is gathered over the tensor group,
    GPipe's head is the vocab-sharded ``_tp_loss``, and the 1F1B head
    cuts the tensor all-to-all's vocabulary slice (made once a step,
    ``_tensor_vocab``) again over the stage group: its statistics and the
    f32 cotangent of its input are summed over the tensor x stage ranks.

    Dropout: one seed a step is drawn from ``generator``, and each block's
    generator is seeded by ``fold_seed(fold_seed(seed, global layer),
    microbatch)``, so every schedule draws the same masks for a (layer,
    microbatch); a block's rows are its share of the global microbatch
    (``_TrainStep.rows``)."""

    def __init__(self, model: "GPT", mesh, sched, input_ids, labels, leaves,
                 *, train: bool, generator, loss_scale: float):
        from tpu_trainer_torch.parallel import pipeline as pp

        cfg = model.config
        self.model, self.mesh, self.sched = model, mesh, sched
        self.leaves = list(leaves)
        self.loss_scale = loss_scale
        self.device = input_ids.device
        b, s = input_ids.shape
        self.s = s
        M = sched.micro
        coord, shards = model.data_shard
        if (b * shards) % M:
            raise ValueError(f"global batch {b * shards} rows not divisible "
                             f"by pipeline_microbatches {M}")
        self.rows = pp.micro_rows(b, coord * b, M)
        # Each microbatch's share before this data shard, and the global
        # microbatch's rows.
        self.row0 = [sum(len(pp.micro_rows(b, d * b, M)[m])
                         for d in range(coord)) for m in range(M)]
        self.total_rows = b * shards // M
        uneven = b % M != 0
        self.idx = [torch.tensor(r, dtype=torch.long, device=self.device)
                    for r in self.rows]
        self.ids = [input_ids[i] for i in self.idx]
        self.labels = [labels[i] for i in self.idx]
        self.step = model._train_step_of(s, train, generator, None,
                                         self.device)
        sp = 1 if self.step.seq is None else self.step.seq[1]
        self.moe_tokens = ([self.total_rows * s * sp] * M if uneven
                           else [None] * M)
        self.layers = model.stage_layers
        self.chunk = len(self.layers) // sched.virtual
        self.aux_weight = (1.0 / (M * cfg.num_layers * sp)
                           if cfg.num_experts > 0 else None)
        dropout_on = train and (cfg.dropout > 0.0
                                or cfg.attention_dropout > 0.0)
        self.seed = self.step.seed() if dropout_on else None
        self.block = model._block_fn()
        # The targets of the rank's whole batch (its rows' global shift):
        # a microbatch's 1F1B head loss is its share of the batch mean.
        self.denom = float(b * (s * sp - 1))
        # Under tensor, the 1F1B head's tensor vocabulary slice: made on
        # the first head, its gradient summed over the step's heads and
        # taken back through the all-to-all once (``finish``).
        self._tv = None
        self._tv_leaf = None
        self._tv_grad = None

    def act(self, m: int):
        return ((len(self.rows[m]), self.s, self.model.config.hidden_size),
                self.model.config.compute_dtype)

    def _scope(self):
        model = self.model
        if model.zero3 is not None and torch.is_grad_enabled():
            return coll_lib.regather_saved()
        return contextlib.nullcontext()

    def forward(self, c: int, m: int, x):
        model = self.model
        cfg = model.config
        with self._scope():
            if x is None:
                emb = model._leaf("embed_tokens.embedding")
                x = coll_lib.gather_from_tensor(
                    emb[self.ids[m]].to(cfg.compute_dtype), self.step.tensor)
                if telemetry.capturing() and self.rows[m]:
                    telemetry.record_rows("embed_out",
                                          telemetry.site_stats(x),
                                          len(self.rows[m]))
            views = model._unstacked_layers()
            aux = None
            lo = c * self.chunk
            for li in range(lo, lo + self.chunk):
                gl = self.layers[li]
                gen = None
                if self.seed is not None:
                    gen = torch.Generator().manual_seed(
                        fold_seed(fold_seed(self.seed, gl), m))
                step = dataclasses.replace(
                    self.step, generator=gen,
                    rows=(self.row0[m], self.total_rows),
                    moe_tokens=self.moe_tokens[m],
                    telem=([] if telemetry.capturing() and self.rows[m]
                           else None))
                x, a = self.block(x, views[li], step)
                if step.telem:
                    telemetry.record_rows(f"layer_{gl}", step.telem[0],
                                          len(self.rows[m]))
                if a is not None:
                    aux = a if aux is None else aux + a
        return x, aux

    def head_batch(self, ys):
        """The step's loss (CE) on the last stage: the microbatches' outputs
        put back in row order, the final norm and the fused loss."""
        model = self.model
        cfg = model.config
        x = torch.cat(ys, dim=0)
        order = torch.cat(self.idx)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        x = x[inv]
        labels = torch.cat(self.labels, dim=0)[inv]
        with self._scope():
            emb = model._leaf("embed_tokens.embedding")
            x = _rms_norm(x, model._leaf("norm.weight"), model.norm.eps,
                          model.norm.dtype)
            tp, cd = self.step.tensor, cfg.compute_dtype
            if telemetry.capturing():
                telemetry.record("final_norm", telemetry.site_stats(x))
                if telemetry.capturing(deep=True):
                    with torch.no_grad():
                        telemetry.record("logits", telemetry.site_stats(
                            _tied_logits(x, emb, tp, cd).float()))
            seq = self.step.seq
            seq_shard = (None if seq is None
                         else (seq[0] * self.s, self.s * seq[1]))
            if cfg.fused_loss:
                return fused_shifted_cross_entropy(
                    emb, x, labels, chunk_size=cfg.loss_chunk_size,
                    allow_pallas=cfg.fused_loss_pallas, tensor=tp,
                    seq_shard=seq_shard)
            logits = _tied_logits(x, emb, tp, cd).float()
            return _shifted_loss(logits, labels, None, seq_shard)

    def _tensor_vocab(self):
        """Under tensor, the leaf standing for this rank's ``[ceil(V /
        ts), H]`` vocabulary slice of the tied embedding in the compute
        dtype (``_tp_loss``'s tiled all-to-all, run on the step's first
        head)."""
        if self._tv is None:
            emb = self.model._leaf("embed_tokens.embedding")
            ts = self.step.tensor.world
            vt = -(-emb.shape[0] // ts)
            e_pad = F.pad(emb.to(self.model.config.compute_dtype),
                          (0, 0, 0, vt * ts - emb.shape[0]))
            self._tv = coll_lib.tensor_all_to_all(e_pad, self.step.tensor)
            self._tv_leaf = self._tv.detach().requires_grad_(True)
        return self._tv_leaf

    def head_micro(self, y, m: int, last: bool):
        """This rank's vocabulary slice of microbatch ``m``'s head (the JAX
        ``head_vjp``) on the broadcast last-stage output ``y``: rows ``[r
        vs, (r + 1) vs)`` of the tied embedding, the loss the microbatch's
        share of the batch mean; under tensor, slice ``r`` of the tensor
        all-to-all's vocabulary slice, the statistics over the tensor x
        stage ranks. The slice's cotangent of the normed input stays f32
        until its sum over the stage (tensor x stage) group, then rounds
        once to the compute dtype, as one process's head rounds it; the
        last stage (``last``) takes it through the final norm. Returns
        ``(loss, dy on the last stage else None, gradients of the
        leaves)``."""
        from tpu_trainer_torch.ops.loss import (
            _shift, vocab_cut, vocab_sharded_shifted_cross_entropy)

        model = self.model
        cfg = model.config
        S, r = self.sched.stages, self.mesh.pp_rank
        tp = self.step.tensor
        y = y.detach().requires_grad_(last)
        with self._scope():
            V = model.config.vocab_size
            if tp is None:
                emb = model._leaf("embed_tokens.embedding")
                vs = -(-V // S)
                e_slice = F.pad(emb, (0, 0, 0, vs * S - V))[
                    r * vs:(r + 1) * vs]
                group, cut = self.mesh.stage, vocab_cut(V, S, r)
            else:
                tv = self._tensor_vocab()
                vt = tv.shape[0]
                vs = -(-vt // S)
                e_slice = F.pad(tv, (0, 0, 0, vs * S - vt))[
                    r * vs:(r + 1) * vs]
                lo, n = vocab_cut(vt, S, r)
                off = tp.rank * vt + lo
                group = self.mesh.tensor_stage
                cut = (off, max(0, min(n, V - off)))
            xn = _rms_norm(y, model._leaf("norm.weight"), model.norm.eps,
                           model.norm.dtype)
            x32 = xn.detach().float().requires_grad_(True)
            seq = self.step.seq
            if seq is None:
                shifted, mask = _shift(self.labels[m], self.s, y.device)
            else:
                shifted, mask, _ = shard_shift(
                    self.labels[m], self.s, (seq[0] * self.s,
                                             self.s * seq[1]), y.device)
            loss = vocab_sharded_shifted_cross_entropy(
                e_slice, x32, shifted, vocab=V, coll=group,
                chunk_size=cfg.loss_chunk_size, mask=mask,
                denom=self.denom, prefix="pp",
                compute_dtype=cfg.compute_dtype, cut=cut)
        wrt = [x32] + ([] if tp is None else [self._tv_leaf]) + self.leaves
        gs = list(torch.autograd.grad(loss * self.loss_scale, wrt,
                                      allow_unused=True))
        dxn = group.all_reduce_sum(gs.pop(0).contiguous(),
                                   kind="pp_allreduce")
        if tp is not None:
            # Summed over the step's microbatches in f32, rounded once.
            g = gs.pop(0).float()
            self._tv_grad = (g if self._tv_grad is None
                             else self._tv_grad.add_(g))
        grads, dy = gs, None
        if last:
            g2 = torch.autograd.grad(xn, [y] + self.leaves,
                                     dxn.to(xn.dtype), allow_unused=True)
            dy = g2[0]
            grads = [b if a is None else a if b is None else a + b
                     for a, b in zip(grads, g2[1:])]
        return loss.detach(), dy, grads

    def finish(self) -> list:
        """The leaves' gradients still owed after the schedule ran (the
        1F1B head's tensor vocabulary slice, taken back through the
        all-to-all once), None entries where none is owed."""
        if self._tv_grad is None:
            return [None] * len(self.leaves)
        return list(torch.autograd.grad(self._tv, self.leaves,
                                        self._tv_grad.to(self._tv.dtype),
                                        allow_unused=True))


def _tied_logits(h, emb, tp, cd):
    """The tied head's logits ``h @ emb.T`` in the compute dtype ``cd``;
    under the tensor group ``tp`` the row-parallel product of the rank's
    hidden slices, summed over the group."""
    h = coll_lib.slice_to_tensor(h, tp)
    return coll_lib.reduce_from_tensor(
        h.to(cd) @ coll_lib.derive(lambda e: e.to(cd), [emb]).T, tp)


def _tensor_group(mesh):
    """The active mesh's tensor ``Collectives``, None at tensor size 1."""
    if mesh is None or mesh.tp <= 1:
        return None
    return mesh.tensor


def _attention_coord(mesh, data_shard: tuple, cfg: GPTConfig):
    """The JAX ``attention_shard_coord`` of this rank (None when no axis
    shards the attention operands): the data shard when there are several
    (the port's batch always divides: a rank holds its rows), then the
    tensor rank when the heads shard."""
    coord, shards = data_shard
    if mesh is None:
        return coord if shards > 1 else None
    b_spec, h_spec = mesh_lib.attention_shard_spec(
        mesh.sizes, shards, cfg.num_heads, cfg.kv_heads)
    if b_spec is None and h_spec is None:
        return None
    return mesh_lib.attention_shard_coord(mesh.sizes, mesh.coords, b_spec,
                                          h_spec)


def _matmuls(x: torch.Tensor, kernels: List[torch.Tensor], dtype,
             fused: bool) -> List[torch.Tensor]:
    """No-bias projections of ``x`` in the compute dtype; ``fused`` runs
    them as one matmul over the concatenated kernels."""
    x = x.to(dtype)
    if fused and len(kernels) > 1:
        out = x @ coll_lib.derive(
            lambda *ws: torch.cat(ws, dim=1).to(dtype), kernels)
        return list(torch.split(out, [w.shape[-1] for w in kernels], dim=-1))
    return [x @ coll_lib.derive(lambda w: w.to(dtype), [w]) for w in kernels]


_SAVED_DOTS = frozenset((torch.ops.aten.mm.default,
                         torch.ops.aten.bmm.default,
                         torch.ops.aten.addmm.default,
                         torch.ops.aten.baddbmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX ``dots_saveable``: keep every matmul output, recompute the
    rest. The CUDA kernels launch through ``ctypes``, outside the
    dispatcher, so they are recomputed."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Integer-label softmax cross entropy in f32 (the JAX package's
    ``optax_softmax_cross_entropy``)."""
    logits = logits.float()
    label_logits = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def _masked_shifted_mean(ce: torch.Tensor, segment_ids) -> torch.Tensor:
    """Mean of per-position shifted CE ``[b, s-1]``, dropping targets that
    cross a packed-document boundary (a plain mean without segments)."""
    if segment_ids is None:
        return ce.mean()
    m = segment_target_mask(segment_ids)[:, :-1]
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def _shifted_loss(logits: torch.Tensor, labels: torch.Tensor, segment_ids,
                  seq_shard) -> torch.Tensor:
    """The next-token CE mean of f32 ``logits [b, s, V]``; with
    ``seq_shard=(offset, global_len)`` (a sequence slice: ``labels [b, s +
    1]``) this slice's share of the global mean, the last global position
    masked."""
    if seq_shard is None:
        return _masked_shifted_mean(
            softmax_cross_entropy(logits[:, :-1], labels[:, 1:]),
            segment_ids)
    shifted, mask, denom = shard_shift(labels, logits.shape[1], seq_shard,
                                        logits.device)
    return (softmax_cross_entropy(logits, shifted) * mask).sum() / denom


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
                     device, mesh=None) -> Dict[str, object]:
    """Zero-initialized paged cache: per-layer pools ``[L, nblk, bsz, kvh,
    d]`` (compute dtype, or int8 plus f32 scales ``[..., d // qb]``), and
    the ``tables [b, mb]`` / ``lengths [b]`` / ``offsets [b]`` int32
    scheduling state the caller overwrites before every pass.

    Under ``paged_tp > 1`` the pools are per-shard instead,
    ``cache["shards"][i]`` on ``mesh.devices[i]``
    (``serving/sharding.shard_cache``: kvh/tp kv heads a shard, or all
    of them when they replicate); the scheduling state stays on
    ``device``."""
    from tpu_trainer_torch.serving import sharding

    cfg = config
    if not cfg.decode_paged:
        raise ValueError("init_paged_cache needs config.decode_paged=True")
    d = cfg.head_dim
    shape = (cfg.num_layers, cfg.paged_num_blocks, cfg.paged_block_size,
             cfg.kv_heads, d)
    kv_dtype = torch.int8 if cfg.paged_kv_int8 else cfg.compute_dtype
    pools = {"pool_k": (shape, kv_dtype), "pool_v": (shape, kv_dtype)}
    if cfg.paged_kv_int8:
        sshape = shape[:-1] + (d // quant_block_len(d),)
        pools["scale_k"] = pools["scale_v"] = (sshape, torch.float32)
    cache: Dict[str, object] = {
        "tables": torch.zeros((batch_size, cfg.paged_max_blocks),
                              dtype=torch.int32, device=device),
        "lengths": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
        "offsets": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
    }
    if cfg.paged_tp > 1:
        if mesh is None or mesh.tp != cfg.paged_tp:
            raise ValueError(f"paged_tp={cfg.paged_tp} needs its mesh")
        cache["shards"] = sharding.shard_cache(pools, mesh, cfg.kv_heads)
    else:
        for key, (shp, dtype) in pools.items():
            cache[key] = torch.zeros(shp, dtype=dtype, device=device)
    return cache


def count_parameters(params) -> int:
    """Total parameter count (the JAX ``count_parameters``): the elements
    of every tensor or array of a name -> tensor mapping (a state dict,
    ``TrainState.params``) or of a module's parameters."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return sum(int(np.prod(tuple(v.shape))) for v in params.values())


# -- generation ----------------------------------------------------------------

def init_cache(config: GPTConfig, batch_size: int, *, device,
               max_len: Optional[int] = None) -> Dict[str, object]:
    """A zeroed contiguous KV cache for ``GPT.decode``: ``k`` / ``v``
    ``[num_layers, batch, max_len, kv_heads, head_dim]`` in the compute
    dtype (``max_len`` defaults to ``config.max_seq_len``; under a tensor
    axis ``kv_heads / ts``, the rank's heads), ``idx`` 0."""
    n = config.max_seq_len if max_len is None else int(max_len)
    # Under a tensor axis a rank caches its own K/V heads.
    kvh = config.kv_heads // ctx_lib.tensor_size()
    shape = (config.num_layers, batch_size, n, kvh, config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.compute_dtype,
                             device=device),
            "v": torch.zeros(shape, dtype=config.compute_dtype,
                             device=device),
            "idx": 0}


def _sample(logits: torch.Tensor, temperature: float, top_k: int,
            seed: int, step: int) -> torch.Tensor:
    """Next token per row of ``logits [b, vocab]``: the exact argmax at
    temperature 0; else a top-k filtered, temperature-scaled draw from a
    generator seeded by (``seed`` + row, ``step``), the serving engine's
    rule for a request of that seed (``serving/sampling.py``)."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    from tpu_trainer_torch.serving.sampling import request_key, sample_tokens

    b = logits.shape[0]
    return sample_tokens(
        logits, np.full(b, temperature, np.float32),
        np.full(b, max(int(top_k), 0)), np.ones(b, np.float32),
        [request_key(seed + r) for r in range(b)], [step] * b,
        k_cap=max(int(top_k), 1))


def _check_model(model: "GPT") -> None:
    if model.config.decode_paged:
        raise ValueError("generation takes a GPT without decode_paged")


@torch.no_grad()
def generate_kv(model: "GPT", input_ids: torch.Tensor, *,
                max_new_tokens: int = 100, temperature: float = 1.0,
                top_k: int = 50, seed: int = 0,
                prompt_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KV-cached sampling: one prefill pass over the prompt, then one
    single-token pass a generated token. Returns ``[b, prompt +
    max_new_tokens]`` ids. The cache holds ``prompt + max_new_tokens``
    rounded up to 128 (at most ``max_seq_len``, which must fit).

    Ragged batches: ``prompt_lens [b]`` are the true lengths of
    right-padded rows. Rows are re-packed left-padded so every row shares
    one cache frontier; output rows come back right-padded (row r holds
    ``prompt_lens[r] + max_new_tokens`` real tokens, zeros beyond)."""
    _check_model(model)
    cfg = model.config
    b, width = input_ids.shape
    total = width + max_new_tokens
    if total > cfg.max_seq_len:
        raise ValueError(
            f"prompt ({width}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"the cache size (max_seq_len={cfg.max_seq_len}); use generate()")
    if max_new_tokens == 0:
        return input_ids
    dev = input_ids.device
    cache = init_cache(cfg, b, device=dev,
                       max_len=min(-(-total // 128) * 128, cfg.max_seq_len))
    pad = None
    if prompt_lens is not None:
        lens = torch.as_tensor(prompt_lens, device=dev).long()
        if (lens.shape != (b,) or bool((lens <= 0).any())
                or bool((lens > width).any())):
            raise ValueError(f"prompt_lens must be [batch]={b} values in "
                             f"[1, {width}]; got {lens.tolist()}")
        pad = width - lens
        cols = torch.arange(width, device=dev)[None]
        src = torch.clamp(cols - pad[:, None], 0, width - 1)
        input_ids = torch.where(cols >= pad[:, None],
                                torch.gather(input_ids, 1, src),
                                torch.zeros_like(input_ids))
        cache["pad"] = pad
    buf = torch.zeros((b, total), dtype=input_ids.dtype, device=dev)
    buf[:, :width] = input_ids
    logits = model.decode(input_ids, cache)
    buf[:, width] = _sample(logits[:, -1], temperature, top_k, seed, 0)
    for i in range(width + 1, total):
        logits = model.decode(buf[:, i - 1:i], cache)
        buf[:, i] = _sample(logits[:, -1], temperature, top_k, seed,
                            i - width)
    if pad is not None:
        cols = torch.arange(total, device=dev)[None]
        src = torch.clamp(cols + pad[:, None], 0, total - 1)
        buf = torch.where(cols < (total - pad)[:, None],
                          torch.gather(buf, 1, src), torch.zeros_like(buf))
    return buf


@torch.no_grad()
def generate(model: "GPT", input_ids: torch.Tensor, *,
             max_new_tokens: int = 100, temperature: float = 1.0,
             top_k: int = 50, seed: int = 0) -> torch.Tensor:
    """Windowed full-forward sampling without a cache (the reference
    semantics): each step re-runs the forward over the last
    ``min(total, max_seq_len)`` positions."""
    _check_model(model)
    cfg = model.config
    b, width = input_ids.shape
    total = width + max_new_tokens
    window = min(total, cfg.max_seq_len)
    buf = torch.zeros((b, total), dtype=input_ids.dtype,
                      device=input_ids.device)
    buf[:, :width] = input_ids
    for i in range(width, total):
        start = min(max(i - window, 0), total - window)
        logits, _ = model(buf[:, start:start + window])
        buf[:, i] = _sample(logits[:, i - 1 - start], temperature, top_k,
                            seed, i - width)
    return buf

