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
  (``moe_impl="dropless"``) each layer's FFN is the dropless MoE of
  ``models/moe.py`` and the loss adds the layers' mean router auxiliary.
  ``gradient_checkpointing`` recomputes each block in the backward
  (``_remat_block``): ``remat_policy="full"`` keeps only the block input,
  ``"dots"`` also keeps every matmul output (JAX ``dots_saveable``); the
  flash and grouped-matmul kernels are recomputed under both. Without
  ``fused_loss``, ``remat_lm_head`` recomputes the head matmul and the
  cross entropy in the backward. Decode and no-grad passes never remat.
- **Paged decode** (``decode=True`` with ``decode_paged``):
  ``forward(input_ids, cache, *, hist_blocks=0, logits_at=None)`` over the
  paged KV cache (``_paged_decode_attention``), decode attention through
  ``ops.flash.flash_decode``. MoE decode is not ported: a paged MoE
  config raises.
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
"""

from __future__ import annotations

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
from tpu_trainer_torch.models.moe import check_moe, dropless_moe
from tpu_trainer_torch.ops import flash as flash_lib
from tpu_trainer_torch.ops.attention import reference_attention, repeat_kv
from tpu_trainer_torch.ops.dropout import hash_dropout
from tpu_trainer_torch.ops.loss import (
    fused_shifted_cross_entropy,
    segment_target_mask,
)
from tpu_trainer_torch.ops.rope import apply_rotary_pos_emb, rope_tables
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


class MoEMLP(nn.Module):
    """The dropless MoE FFN's stacked parameters under their Flax names:
    ``router.kernel [L, H, E]`` (f32), ``experts_gate`` / ``experts_up``
    ``[L, E, H, I]`` and ``experts_down [L, E, I, H]``; the computation is
    ``models.moe.dropless_moe``."""

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        cfg = config
        L, E = cfg.num_layers, cfg.num_experts
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.router = Dense(H, E, stack=L, dtype=torch.float32,
                            param_dtype=torch.float32, device=device)
        self.experts_gate = _param((L, E, H, I), cfg.params_dtype, device)
        self.experts_up = _param((L, E, H, I), cfg.params_dtype, device)
        self.experts_down = _param((L, E, I, H), cfg.params_dtype, device)


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
        if cfg.num_experts > 0:
            self.moe_mlp = MoEMLP(cfg, device=device)
        else:
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
    """GPT for causal LM. Parameters are allocated uninitialized
    (``device="meta"`` allocates nothing): load them from
    ``models.weights.init_params`` / ``from_jax_params``."""

    def __init__(self, config: GPTConfig, *, device=None):
        super().__init__()
        check_moe(config)
        if config.num_experts > 0 and config.decode_paged:
            raise NotImplementedError(
                "MoE decode is not ported: the paged engine serves dense "
                "models only (ROADMAP Queue 1)")
        self.config = cfg = config
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.compute_dtype,
                                  param_dtype=cfg.params_dtype, device=device)
        self.layers = TransformerBlock(cfg, device=device)
        self.norm = RMSNorm(cfg.hidden_size, dtype=cfg.compute_dtype,
                            device=device)

    def forward(self, input_ids: torch.Tensor, *args, **kwargs):
        """``config.decode_paged``: ``_paged_forward(input_ids, cache, *,
        hist_blocks=0, logits_at=None) -> logits``; otherwise
        ``_train_forward(input_ids, labels=None, *, train=False,
        segment_ids=None, generator=None) -> (logits, loss)``."""
        if self.config.decode_paged:
            return self._paged_forward(input_ids, *args, **kwargs)
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
        dropout_on = train and (cfg.dropout > 0.0
                                or cfg.attention_dropout > 0.0)
        if dropout_on and generator is None:
            raise ValueError("train=True with dropout needs a generator")
        b, s = input_ids.shape
        x = self.embed_tokens(input_ids)
        capturing = telemetry.capturing()
        if capturing:
            telemetry.record("embed_out", telemetry.site_stats(x))
        rope = rope_tables(s, cfg.head_dim, cfg.rope_theta, device=x.device)
        step = _TrainStep(train=train, generator=generator, rope=rope,
                          segment_ids=segment_ids,
                          telem=[] if capturing else None)
        remat = torch.is_grad_enabled()
        block = (self._remat_block if cfg.gradient_checkpointing and remat
                 else self._train_block)
        moe_aux = 0.0
        for p in self._unstacked_layers():
            x, aux = block(x, p, step)
            if aux is not None:
                moe_aux = moe_aux + aux
        if step.telem:
            telemetry.record("layers", telemetry.stack_layers(step.telem))
        x = self.norm(x)
        if capturing:
            telemetry.record("final_norm", telemetry.site_stats(x))
        if telemetry.capturing(deep=True):
            # The full f32 logits, nan-scan only: without this site a NaN
            # entering in the head product is indistinguishable from one
            # entering in the loss (the fused loss never forms them).
            with torch.no_grad():
                telemetry.record("logits", telemetry.site_stats(
                    self.embed_tokens.attend(x).float()))

        remat_head = (labels is not None and not cfg.fused_loss
                      and cfg.remat_lm_head)
        logits = None
        if labels is None or not (cfg.fused_loss or remat_head):
            logits = self.embed_tokens.attend(x).float()
        loss = None
        if labels is not None:
            if cfg.fused_loss:
                loss = fused_shifted_cross_entropy(
                    self.embed_tokens.embedding, x, labels,
                    chunk_size=cfg.loss_chunk_size,
                    allow_pallas=cfg.fused_loss_pallas,
                    segment_ids=segment_ids)
            elif remat_head:
                # Nothing of the [b, s, vocab] softmax survives the
                # forward; the backward recomputes the head matmul.
                def head_loss(xf):
                    lg = self.embed_tokens.attend(xf).float()
                    return _masked_shifted_mean(
                        softmax_cross_entropy(lg[:, :-1], labels[:, 1:]),
                        segment_ids)

                loss = (checkpoint(head_loss, x, use_reentrant=False)
                        if remat else head_loss(x))
            else:
                loss = _masked_shifted_mean(
                    softmax_cross_entropy(logits[:, :-1], labels[:, 1:]),
                    segment_ids)
            if cfg.num_experts > 0:
                # The layers' pre-weighted router auxiliaries, meaned.
                loss = loss + moe_aux / cfg.num_layers
        return logits, loss

    def _unstacked_layers(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer views of the stacked ``layers.*`` parameters, one
        ``unbind`` per parameter (its backward is a single stack)."""
        named = list(self.layers.named_parameters())
        views = [p.unbind(0) for _, p in named]
        return [{n: v[i] for (n, _), v in zip(named, views)}
                for i in range(self.config.num_layers)]

    def _qkv(self, x, p):
        """q ``[b, s, heads, d]``, k and v ``[b, s, kv_heads, d]`` of one
        layer: the input norm and the projections in the compute dtype."""
        cfg = self.config
        b, s, _ = x.shape
        h = _rms_norm(x, p["input_layernorm.weight"],
                      self.layers.input_layernorm.eps, cfg.compute_dtype)
        q, k, v = _matmuls(h, [p["attention.q_proj.kernel"],
                               p["attention.k_proj.kernel"],
                               p["attention.v_proj.kernel"]],
                           cfg.compute_dtype, cfg.fused_projections)
        return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
                k.reshape(b, s, cfg.kv_heads, cfg.head_dim),
                v.reshape(b, s, cfg.kv_heads, cfg.head_dim))

    def _train_block(self, x, p, step: "_TrainStep"):
        cfg = self.config
        cd = cfg.compute_dtype
        b, s, _ = x.shape
        q, k, v = self._qkv(x, p)
        attn_drop = step.train and cfg.attention_dropout > 0.0
        if cfg.use_flash_attention:
            out = flash_lib.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                dropout_rate=cfg.attention_dropout if attn_drop else 0.0,
                seed=step.seed() if attn_drop else None, rope=step.rope,
                segment_ids=step.segment_ids)
        else:
            q, k = apply_rotary_pos_emb(q, k, *step.rope)
            out = reference_attention(
                q, k, v, dropout_rate=cfg.attention_dropout,
                deterministic=not step.train, generator=step.generator,
                segment_ids=step.segment_ids)
        out = _matmuls(out.reshape(b, s, cfg.hidden_size),
                       [p["attention.o_proj.kernel"]], cd, False)[0]
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
            out, aux = dropless_moe(
                h, p["moe_mlp.router.kernel"], p["moe_mlp.experts_gate"],
                p["moe_mlp.experts_up"], p["moe_mlp.experts_down"], cfg,
                router_stats=router)
        else:
            gate, up = _matmuls(h, [p["mlp.gate_proj.kernel"],
                                    p["mlp.up_proj.kernel"]], cd,
                                cfg.fused_projections)
            act = (F.silu(gate) if cfg.activation == "silu"
                   else F.gelu(gate, approximate="tanh"))
            out = _matmuls(act * up, [p["mlp.down_proj.kernel"]], cd,
                           False)[0]
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
        if self.config.fast_dropout:
            return hash_dropout(x, rate, step.seed())
        gen = step.generator
        keep = (torch.rand(x.shape, generator=gen, device=gen.device)
                >= rate).to(x.device)
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
        step = _TrainStep(train=False, generator=None, rope=rope,
                          segment_ids=None)
        x = self.embed_tokens(input_ids)
        for layer, p in enumerate(self._unstacked_layers()):
            x, _ = self._kv_block(x, p, layer, cache, step, allowed, idx)
        cache["idx"] = idx + s
        return self.embed_tokens.attend(self.norm(x)).float()

    def _kv_block(self, x, p, layer: int, cache, step: "_TrainStep",
                  allowed: torch.Tensor, idx: int):
        cfg = self.config
        b, s, _ = x.shape
        q, k, v = self._qkv(x, p)
        q, k = apply_rotary_pos_emb(q, k, *step.rope)
        ck, cv = cache["k"][layer], cache["v"][layer]
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        k_all, v_all = repeat_kv(ck.to(q.dtype), cv.to(q.dtype),
                                 cfg.num_heads)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_all) * (
            1.0 / cfg.head_dim ** 0.5)
        scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v_all)
        out = _matmuls(out.reshape(b, s, cfg.hidden_size),
                       [p["attention.o_proj.kernel"]], cfg.compute_dtype,
                       False)[0]
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

    def seed(self) -> int:
        """A fresh uint32 dropout seed from the generator."""
        return int(torch.randint(0, 2**32, (1,), generator=self.generator,
                                 dtype=torch.int64).item())


def _matmuls(x: torch.Tensor, kernels: List[torch.Tensor], dtype,
             fused: bool) -> List[torch.Tensor]:
    """No-bias projections of ``x`` in the compute dtype; ``fused`` runs
    them as one matmul over the concatenated kernels."""
    x = x.to(dtype)
    if fused and len(kernels) > 1:
        out = x @ torch.cat(kernels, dim=1).to(dtype)
        return list(torch.split(out, [w.shape[-1] for w in kernels], dim=-1))
    return [x @ w.to(dtype) for w in kernels]


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


# -- generation ----------------------------------------------------------------

def init_cache(config: GPTConfig, batch_size: int, *, device,
               max_len: Optional[int] = None) -> Dict[str, object]:
    """A zeroed contiguous KV cache for ``GPT.decode``: ``k`` / ``v``
    ``[num_layers, batch, max_len, kv_heads, head_dim]`` in the compute
    dtype (``max_len`` defaults to ``config.max_seq_len``), ``idx`` 0."""
    n = config.max_seq_len if max_len is None else int(max_len)
    shape = (config.num_layers, batch_size, n, config.kv_heads,
             config.head_dim)
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

