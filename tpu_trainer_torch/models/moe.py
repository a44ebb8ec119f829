"""Mixture-of-Experts feed-forward (port of ``tpu_trainer/models/moe.py``).

A top-k routed expert SwiGLU that replaces the dense MLP of every layer
when ``num_experts > 0``; ``moe_ffn`` runs the router that
``GPTConfig.moe_impl`` names. Shared by both routers (``route``):

- f32 logits ``[T, E]`` from an f32 ``[H, E]`` kernel, softmax, ``top_k``;
  the gate is the router probability at k = 1 (Switch) and the chosen
  probabilities renormalised to sum 1 at k > 1 (GShard);
- auxiliaries, returned pre-weighted as one scalar: ``moe_aux_weight * E *
  sum_e f_e * p_e`` (load balance over first-choice fractions) plus
  ``router_z_weight * mean(logsumexp(logits)^2)`` (z-loss).

**capacity** (``capacity_moe``, the JAX default; Switch Transformer,
arXiv:2101.03961): every expert takes at most ``C = ceil(k * T / E *
expert_capacity_factor)`` token-choices (``C = T`` when ``T <= 2 E``, the
decode regime), queued in choice-major order (every first choice before
any second choice, so second choices drop first); the rest are dropped
and contribute zero. ``moe_dispatch`` moves the rows: ``"gather"``
through two autograd functions whose
backwards are gathers through the inverse slot map, as the JAX custom
VJPs are (a fixed order of every sum, so the backward is deterministic;
no scatter-add), ``"einsum"`` through the one-hot ``[T, k, E, C]`` slot
tensor's dispatch and combine products. The expert products are batched
matmuls ``[E, C, H] @ [E, H, I]``.

**dropless** (``dropless_moe``; MegaBlocks, arXiv:2211.15841): the ``T *
k`` token-choice rows permuted into expert order by one stable argsort,
group sizes from a count of the routing, the three SwiGLU projections as
grouped matmuls (``ops/grouped_matmul.gmm``: the CUDA kernels on a CUDA
tensor), the inverse permutation and the gated combine. No token drops.

**Across ranks** (``group``, the routing group: the trainer's ranks that
hold distinct tokens, varying data, fsdp and sequence): the JAX layer
routes the global micro-batch, whose tokens run in the order ``t = row *
S + col`` over the global rows. Each layer all-gathers every rank's
choice counts (one small collective): ``[k, E]`` a rank, or ``[b, k, E]``
(a count per local row) under a sequence axis, whose ranks hold
interleaved pieces of each row. The capacity comes from the global ``T``;
a token-choice's queue position starts after the earlier choices of
every rank and, in its own choice, the tokens before it in global order
(``rank_offsets``); ``f`` is the global first-choice fraction (``p``
stays the rank's own mean, so the ranks' mean aux is the global aux; a
sequence rank's aux counts ``1 / sp`` of it, as its loss does, in
``models/gpt.py``). Under a pipeline the ranks' shares of a microbatch
may differ in size (``parallel/pipeline.micro_rows``): the caller then
passes ``tokens``, the global micro-batch's count, which the fraction and
the capacity take in place of ``W T``, and ``p`` (and the z-loss mean)
become the rank's sums times ``W / tokens``, so the ranks' mean is still
the global one. The expert weights are cast through
``parallel.collectives.derive``, so ZeRO-3 regathers them in the backward
instead of keeping them.

**Expert and tensor axes** (``parallel/context.current_mesh``): a rank
holds the weights of its local experts ``[x E / ep, (x + 1) E / ep)`` and
of them its tensor slice of the FFN dim (``parallel/sharding.py``). The
router, the gates, the positions and the aux are computed on every such
rank alike; the rank computes its local experts' slots (capacity) or rows
(dropless: ``gmm`` / ``tgmm`` over the local experts' groups, the other
rows left zero) and its share of their output, and ``expert_sum`` adds
the shares over the expert and tensor ranks (``expert_tensor``). The
tokens and the gates enter the local experts through ``copy_to_tensor``
(identity forward, the gradient summed over the same ranks), and the
aux does not, so the router and every replicated leaf get the
one-process gradient on every expert and tensor rank. Without those axes
both collectives are the identity and the layer is the one-process layer.
``moe_dispatch="auto"`` is ``"einsum"`` when the expert axis is above 1
and ``"gather"`` otherwise, the JAX rule; both give the same result.

With ``router_stats`` (a telemetry step) a layer reports its router
health under the JAX names: ``load``, ``entropy``, ``drop_frac``,
``max_group_frac`` and ``dropless`` (1 for the dropless router). At world
> 1 they are the global micro-batch's: the load, drop and group fractions
from the all-gathered counts (no second collective), the entropy from the
ranks' mean probability, which the trainer averages with the step's other
stats (``mean_prob``, ``utils/telemetry.combine_ranks``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.ops.grouped_matmul import gmm
from tpu_trainer_torch.parallel import collectives as coll_lib
from tpu_trainer_torch.parallel import context as ctx_lib


def route(xt: torch.Tensor, router_kernel: torch.Tensor, cfg: GPTConfig,
          stats: Optional[dict] = None, group=None, chunks: int = 1,
          tokens: Optional[int] = None):
    """Router of ``xt [T, H]``: ``(gates [T, k] f32, gate_idx [T, k]
    int64, aux scalar f32, counts [W * chunks, k, E] int64)``, ``counts``
    the token count of each (choice, expert) of every chunk of every rank
    of ``group`` (``W`` ranks, 1 without it) in rank order; a rank's
    tokens are ``chunks`` equal chunks in order (its rows under a sequence
    axis, else one). ``stats`` (a dict) receives the first-choice
    ``load`` and the routing ``entropy``. ``tokens``: the routing group's
    token count when the ranks' counts differ (module docstring)."""
    E, k = cfg.num_experts, cfg.moe_top_k
    T = xt.shape[0]
    world = 1 if group is None else group.world
    logits = xt.float() @ router_kernel.float()                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top_k as jax.lax.top_k: of equal probabilities the lower expert id
    # first (a stable descending sort; torch.topk leaves ties unordered).
    gate_vals, gate_idx = (t[:, :k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gates = gate_vals if k == 1 else (
        gate_vals / gate_vals.sum(dim=-1, keepdim=True))
    counts = F.one_hot(gate_idx, E).reshape(chunks, T // chunks, k, E).sum(
        dim=1)                                                   # [c, k, E]
    if group is not None:
        counts = group.all_gather_leaf(counts, 0, kind="moe_counts")
    if tokens is None:
        frac = counts[:, 0].sum(dim=0).float() / float(world * T)
        mean_prob = probs.mean(dim=0)
    else:
        frac = counts[:, 0].sum(dim=0).float() / float(tokens)
        mean_prob = probs.sum(dim=0) * (world / float(tokens))
    aux = cfg.moe_aux_weight * E * torch.sum(frac * mean_prob)
    if stats is not None:
        with torch.no_grad():
            mp = mean_prob.detach()
            stats["load"] = frac
            stats["entropy"] = -torch.sum(mp * torch.log(mp + 1e-9))
            if world > 1:
                # The global entropy needs the global mean probability:
                # the trainer's one telemetry collective averages this
                # (utils/telemetry.combine_ranks).
                stats["mean_prob"] = mp
    if cfg.router_z_weight > 0.0:
        z = torch.logsumexp(logits, dim=-1)
        zz = (torch.mean(z * z) if tokens is None
              else torch.sum(z * z) * (world / float(tokens)))
        aux = aux + cfg.router_z_weight * zz
    return gates, gate_idx, aux, counts


def _activation(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    # flax nn.gelu is the tanh approximation.
    return F.silu(x) if cfg.activation == "silu" else F.gelu(
        x, approximate="tanh")


def _cast(w: torch.Tensor, dtype) -> torch.Tensor:
    """An expert weight in the compute dtype, made through ``derive``."""
    return coll_lib.derive(lambda t: t.to(dtype), [w])


def dispatch_mode(cfg: GPTConfig, expert_size: Optional[int] = None
                  ) -> str:
    """The capacity router's row movement: ``"gather"`` or ``"einsum"``
    as asked; ``"auto"`` is ``"einsum"`` when the expert axis (the active
    mesh's, or ``expert_size``) is above 1 and ``"gather"`` otherwise (the
    JAX rule)."""
    if cfg.moe_dispatch != "auto":
        return cfg.moe_dispatch
    if expert_size is None:
        mesh = ctx_lib.current_mesh()
        expert_size = 1 if mesh is None else mesh.ep
    return "einsum" if expert_size > 1 else "gather"


def describe(cfg: GPTConfig, expert_size: int = 1) -> str:
    """The router of a MoE config in words (the CLI's startup line), at
    expert axis size ``expert_size``."""
    head = f"{cfg.num_experts} experts, top-{cfg.moe_top_k}, "
    if expert_size > 1:
        head += (f"{cfg.num_experts // expert_size} a rank over "
                 f"{expert_size} expert ranks, ")
    if cfg.moe_impl == "dropless":
        return head + "dropless router (grouped matmuls)"
    return head + (f"capacity router, {dispatch_mode(cfg, expert_size)} "
                   f"dispatch, capacity factor {cfg.expert_capacity_factor}")


def _expert_layout(w_gate: torch.Tensor, cfg: GPTConfig):
    """``(first local expert, the group that sums the layer's output or
    None, sequence size)`` under the active mesh (``(0, None, 1)`` without
    one). The group is the expert x tensor ranks when the tensor axis
    split the FFN dim, else the expert ranks (the experts replicate over
    tensor when its size does not divide the dim)."""
    mesh = ctx_lib.current_mesh()
    if mesh is None:
        return 0, None, 1
    split = w_gate.shape[-1] < cfg.intermediate_size
    return (mesh.ep_rank * w_gate.shape[0],
            mesh.expert_tensor if split else mesh.expert, mesh.sp)


def expert_sum(out: torch.Tensor, group) -> torch.Tensor:
    """A layer's output: every expert and tensor rank's share of it
    (their local experts', their FFN slice's) summed over ``group`` in
    rank order; the gradient passes unchanged."""
    return coll_lib.reduce_from_tensor(out, group, kind="moe_allreduce")


def _to_experts(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` unchanged into the local experts; its gradient summed over
    the expert and tensor ranks (each computed its experts' part)."""
    return coll_lib.copy_to_tensor(t, group, kind="moe_allreduce")


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor,
            w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            cfg: GPTConfig, router_stats: Optional[dict] = None, group=None,
            tokens: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's MoE FFN by ``cfg.moe_impl``: ``capacity_moe`` or
    ``dropless_moe`` (``tokens``: ``route``'s)."""
    fn = dropless_moe if cfg.moe_impl == "dropless" else capacity_moe
    kw = {} if tokens is None else {"tokens": tokens}
    return fn(x, router_kernel, w_gate, w_up, w_down, cfg,
              router_stats=router_stats, group=group, **kw)


# -- the dropless router ------------------------------------------------------

def dispatch(gate_idx: torch.Tensor, num_experts: int, first: int = 0):
    """``(counts [E] int32, perm [T*k], inv_perm [T*k])`` of the flat
    expert ids: a stable argsort puts the token-choice rows in expert order
    (a pure function of the routing), starting at expert ``first`` (then
    ``first + 1``, ... modulo E: a rank's local experts first), ``counts``
    are the group sizes by expert id and ``inv_perm`` puts the rows back.
    Device ops only."""
    flat = gate_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    order = flat if first == 0 else (flat - first) % num_experts
    perm = torch.argsort(order, stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.numel(), device=perm.device)
    return counts, perm, inv_perm


def dropless_moe(x: torch.Tensor, router_kernel: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, cfg: GPTConfig,
                 router_stats: Optional[dict] = None, group=None,
                 tokens: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless MoE FFN of one layer on ``x [b, s, H]`` (compute
    dtype): ``(out [b, s, H], aux)``, before the residual dropout.
    ``w_gate``/``w_up`` ``[E, H, I]`` and ``w_down`` ``[E, I, H]`` are cast
    to the compute dtype; the router kernel ``[H, E]`` stays f32.
    ``router_stats`` (a dict) receives the layer's router telemetry, the
    JAX ``_dropless_ffn``'s ``router`` record."""
    b, s, H = x.shape
    k = cfg.moe_top_k
    dtype = cfg.compute_dtype
    world = 1 if group is None else group.world
    xt = x.reshape(b * s, H)
    gates, gate_idx, aux, every = route(xt, router_kernel, cfg,
                                        stats=router_stats, group=group,
                                        tokens=tokens)
    first, ranks, _ = _expert_layout(w_gate, cfg)
    local = w_gate.shape[0]
    counts, perm, inv_perm = dispatch(gate_idx, cfg.num_experts, first)
    if router_stats is not None:
        with torch.no_grad():
            # The true post-routing load (what each expert computed);
            # nothing is dropped. At world > 1 the global micro-batch's,
            # from every rank's choice counts.
            load = (counts.float() / float(k * b * s)
                    if world == 1 else
                    every.sum(dim=(0, 1)).float()
                    / float(k * b * s * world))
            router_stats.update(
                load=load, drop_frac=torch.zeros((), device=load.device),
                max_group_frac=torch.max(load),
                dropless=torch.ones((), device=load.device))
    # The local experts' rows come first; gmm leaves the rows past their
    # groups zero, so the other experts' choices add nothing here.
    mine = counts[first:first + local]
    grouped_in = _to_experts(xt.to(dtype), ranks)[perm // k]      # [T*k, H]
    mid = (_activation(cfg, gmm(grouped_in, _cast(w_gate, dtype), mine))
           * gmm(grouped_in, _cast(w_up, dtype), mine))
    grouped_out = gmm(mid, _cast(w_down, dtype), mine)            # [T*k, H]
    rows = grouped_out[inv_perm].reshape(b * s, k, H)
    out = torch.sum(rows * _to_experts(gates, ranks)[..., None].to(dtype),
                    dim=1)
    return expert_sum(out, ranks).reshape(b, s, H), aux


# -- the capacity router ------------------------------------------------------

def capacity(cfg: GPTConfig, tokens: int) -> int:
    """Slots an expert for ``tokens`` routed rows (the global count across
    ranks): every token at ``tokens <= 2 E`` (single-token decode, where
    the statistical rule would zero out any colliding token), else
    ``max(1, ceil(k * T / E * expert_capacity_factor))``."""
    E = cfg.num_experts
    if tokens <= 2 * E:
        return tokens
    return max(1, math.ceil(cfg.moe_top_k * tokens / E
                            * cfg.expert_capacity_factor))


def rank_offsets(counts: torch.Tensor, rank: int, rows: int = 1,
                 sp: int = 1) -> torch.Tensor:
    """``[rows, k, E]``: for each of rank ``rank``'s chunks, the
    token-choices of every chunk before it in global token order, each
    choice and expert (zeros on rank 0's first chunk and at one process).
    ``counts [W * rows, k, E]`` are every rank's chunk counts (``route``);
    the ``W`` ranks are ``W / sp`` data shards times ``sp`` sequence
    ranks, and a chunk is a row of a rank under sequence (``rows`` a
    rank), so global order runs over data shard, then row, then sequence
    rank."""
    k, E = counts.shape[1:]
    dp = counts.shape[0] // (rows * sp)
    chunks = counts.reshape(dp, sp, rows, k, E).transpose(1, 2).reshape(
        -1, k, E)
    before = torch.cumsum(chunks, dim=0) - chunks
    d, j = divmod(rank, sp)
    at = (d * rows + torch.arange(rows, device=counts.device)) * sp + j
    return before[at]


def capacity_positions(gate_idx: torch.Tensor, counts: torch.Tensor,
                       rank: int, slots: int, rows: int = 1, sp: int = 1):
    """``(pos [T, k] int64, keep [T, k] bool)``: each token-choice's place
    in its expert's queue over the global micro-batch, in choice-major
    order (the JAX exclusive cumsum over the ``[k*T, E]`` one-hot), and
    whether it is below the capacity ``slots``. ``counts [W * rows, k,
    E]`` are every rank's chunk counts (``route``); this rank's ``rows``
    chunks follow the chunks before them in global order
    (``rank_offsets``). Integer sums, so exact at any ``T``."""
    T, k = gate_idx.shape
    E = counts.shape[-1]
    onehot = F.one_hot(gate_idx, E)                              # [T, k, E]
    per_chunk = onehot.reshape(rows, T // rows, k, E)
    # Earlier tokens of the same chunk, same choice.
    before = (torch.cumsum(per_chunk, dim=1) - per_chunk).reshape(T, k, E)
    total = counts.sum(dim=0)                                    # [k, E]
    chunk_off = rank_offsets(counts, rank, rows, sp).expand(rows, k, E)
    offset = ((torch.cumsum(total, dim=0) - total)[None]  # earlier choices
              + chunk_off).repeat_interleave(T // rows, dim=0)
    pos = ((before + offset) * onehot).sum(dim=-1)
    return pos, pos < slots


class _DispatchRows(torch.autograd.Function):
    """Token rows into expert slots, ``x [T, H] -> [S, H]`` through
    ``slot_token`` (trash slots read the zero pad row ``T``); the backward
    is ``k`` gathers of the slot gradients through ``flat_ids`` (dropped
    choices read the zero pad row ``S``), summed in choice order."""

    @staticmethod
    def forward(ctx, x, slot_token, flat_ids):
        ctx.save_for_backward(flat_ids)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[slot_token]

    @staticmethod
    def backward(ctx, d_ein):
        (flat_ids,) = ctx.saved_tensors
        d_pad = torch.cat([d_ein, d_ein.new_zeros(1, d_ein.shape[1])])
        dx = d_pad[flat_ids[:, 0]]
        for j in range(1, flat_ids.shape[1]):
            dx = dx + d_pad[flat_ids[:, j]]
        return dx, None, None


class _CombineRows(torch.autograd.Function):
    """``out[t] = sum_j gates[t, j] * eo[flat_ids[t, j]]`` (``eo [S, H]``
    the expert outputs, ``gates [T, k]`` f32). The backward scales the
    output gradient by each choice's gate, stacks the choices
    (choice-major, row ``j*T + t``, a zero row last) and gathers the slot
    gradients through ``slot_tc`` (slot -> ``j*T + t``, trash -> ``k*T``);
    the gate gradient is an f32 row dot with the gathered outputs."""

    @staticmethod
    def forward(ctx, eo, gates, flat_ids, slot_tc):
        ctx.save_for_backward(eo, gates, flat_ids, slot_tc)
        eo_pad = torch.cat([eo, eo.new_zeros(1, eo.shape[1])])
        out = None
        for j in range(flat_ids.shape[1]):
            part = eo_pad[flat_ids[:, j]] * gates[:, j:j + 1].to(eo.dtype)
            out = part if out is None else out + part
        return out

    @staticmethod
    def backward(ctx, dout):
        eo, gates, flat_ids, slot_tc = ctx.saved_tensors
        k = flat_ids.shape[1]
        H = eo.shape[1]
        scaled = torch.cat(
            [dout * gates[:, j:j + 1].to(dout.dtype) for j in range(k)]
            + [dout.new_zeros(1, H)])
        d_eo = scaled[slot_tc]
        eo_pad = torch.cat([eo, eo.new_zeros(1, H)])
        d_gates = torch.stack(
            [(eo_pad[flat_ids[:, j]] * dout).float().sum(dim=-1)
             for j in range(k)], dim=1).to(gates.dtype)
        return d_eo, d_gates, None, None


def capacity_moe(x: torch.Tensor, router_kernel: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, cfg: GPTConfig,
                 router_stats: Optional[dict] = None, group=None,
                 tokens: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity MoE FFN of one layer on ``x [b, s, H]`` (compute
    dtype): ``(out [b, s, H], aux)``, before the residual dropout (the
    JAX ``MoEMLP.__call__`` with ``moe_impl="capacity"``). ``group`` (a
    ``Collectives`` over the routing ranks) routes the global
    micro-batch; ``router_stats`` receives the JAX ``router`` record.
    Under the expert and tensor axes the weights are the rank's local
    experts' slices (module docstring)."""
    b, s, H = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = b * s
    dtype = cfg.compute_dtype
    world, rank = (1, 0) if group is None else (group.world, group.rank)
    first, ranks, sp = _expert_layout(w_gate, cfg)
    local = w_gate.shape[0]
    rows = b if sp > 1 else 1
    xt = x.reshape(T, H)
    gates, gate_idx, aux, counts = route(xt, router_kernel, cfg,
                                         stats=router_stats, group=group,
                                         chunks=rows, tokens=tokens)
    C = capacity(cfg, world * T if tokens is None else tokens)
    pos, keep = capacity_positions(gate_idx, counts, rank, C, rows, sp)
    if router_stats is not None:
        with torch.no_grad():
            if world == 1:
                kept = (F.one_hot(gate_idx, E) * keep[..., None]).sum(
                    dim=(0, 1)).float()
                drop = 1.0 - keep.float().mean()
            else:
                # The global kept counts: expert e's choices hold queue
                # positions 0 .. total_e - 1, so it keeps min(total_e, C).
                kept = torch.clamp(counts.sum(dim=(0, 1)), max=C).float()
                drop = 1.0 - kept.sum() / float(world * T * k)
            router_stats.update(
                drop_frac=drop,
                max_group_frac=kept.max() / torch.clamp(kept.sum(), min=1.0),
                dropless=torch.zeros((), device=kept.device))

    xin = _to_experts(xt.to(dtype), ranks)
    gin = _to_experts(gates, ranks)
    einsum = dispatch_mode(cfg) == "einsum"
    if einsum:
        # slot[t, j, e, c] = 1 where choice j of token t holds slot c of
        # local expert e.
        keep_e = F.one_hot(gate_idx, E).float() * keep[..., None]
        slot = (keep_e[..., None] * F.one_hot(
            torch.where(keep, pos, 0), C).float()[:, :, None, :])
        if local < E:
            slot = slot[:, :, first:first + local]
        expert_in = torch.einsum("tec,th->ech", slot.sum(dim=1).to(dtype),
                                 xin)
    else:
        mine = keep & (gate_idx >= first) & (gate_idx < first + local)
        flat_ids = torch.where(mine, (gate_idx - first) * C + pos,
                               local * C)                        # [T, k]
        tc = (torch.arange(T, device=x.device)[:, None]
              + T * torch.arange(k, device=x.device)[None, :])
        slot_tc = torch.full((local * C + 1,), k * T, dtype=torch.int64,
                             device=x.device)
        slot_tc[flat_ids.reshape(-1)] = tc.reshape(-1)
        slot_tc = slot_tc[:local * C]
        slot_token = torch.where(slot_tc == k * T, T, slot_tc % max(T, 1))
        expert_in = _DispatchRows.apply(xin, slot_token,
                                        flat_ids).reshape(local, C, H)

    mid = (_activation(cfg, torch.bmm(expert_in, _cast(w_gate, dtype)))
           * torch.bmm(expert_in, _cast(w_up, dtype)))
    expert_out = torch.bmm(mid, _cast(w_down, dtype))         # [local, C, H]

    if einsum:
        combine = (slot * gin[:, :, None, None]).sum(dim=1)   # [T, local, C]
        out = torch.einsum("tec,ech->th", combine.to(dtype), expert_out)
    else:
        out = _CombineRows.apply(expert_out.reshape(local * C, H), gin,
                                 flat_ids, slot_tc)
    return expert_sum(out, ranks).reshape(b, s, H), aux
