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
and contribute zero. ``moe_dispatch`` moves the rows: ``"gather"`` (and
``"auto"``: no expert axis is ported) through two autograd functions whose
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

**Across ranks** (``group``, the trainer's data-parallel ``Collectives``):
the JAX layer routes the global micro-batch, whose rows are the ranks'
rows in rank order. Each layer all-gathers every rank's ``[k, E]`` choice
counts (one small collective); the capacity comes from the global ``T``,
a rank's queue positions start after the earlier choices of every rank
and the earlier ranks' same choice, and ``f`` is the global first-choice
fraction (``p`` stays the rank's own mean, so the ranks' mean aux is the
global aux). The expert weights are cast through
``parallel.collectives.derive``, so ZeRO-3 regathers them in the
backward instead of keeping them.

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


def route(xt: torch.Tensor, router_kernel: torch.Tensor, cfg: GPTConfig,
          stats: Optional[dict] = None, group=None):
    """Router of ``xt [T, H]``: ``(gates [T, k] f32, gate_idx [T, k]
    int64, aux scalar f32, counts [W, k, E] int64)``, ``counts`` every
    rank's token count of each (choice, expert) in rank order (``W = 1``
    without ``group``). ``stats`` (a dict) receives the first-choice
    ``load`` and the routing ``entropy``."""
    E, k = cfg.num_experts, cfg.moe_top_k
    T = xt.shape[0]
    logits = xt.float() @ router_kernel.float()                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top_k as jax.lax.top_k: of equal probabilities the lower expert id
    # first (a stable descending sort; torch.topk leaves ties unordered).
    gate_vals, gate_idx = (t[:, :k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gates = gate_vals if k == 1 else (
        gate_vals / gate_vals.sum(dim=-1, keepdim=True))
    counts = F.one_hot(gate_idx, E).sum(dim=0)[None]             # [1, k, E]
    if group is not None:
        counts = group.all_gather_leaf(counts, 0, kind="moe_counts")
    frac = counts[:, 0].sum(dim=0).float() / float(counts.shape[0] * T)
    mean_prob = probs.mean(dim=0)
    aux = cfg.moe_aux_weight * E * torch.sum(frac * mean_prob)
    if stats is not None:
        with torch.no_grad():
            mp = mean_prob.detach()
            stats["load"] = frac
            stats["entropy"] = -torch.sum(mp * torch.log(mp + 1e-9))
            if counts.shape[0] > 1:
                # The global entropy needs the global mean probability:
                # the trainer's one telemetry collective averages this
                # (utils/telemetry.combine_ranks).
                stats["mean_prob"] = mp
    if cfg.router_z_weight > 0.0:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + cfg.router_z_weight * torch.mean(z * z)
    return gates, gate_idx, aux, counts


def _activation(cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    # flax nn.gelu is the tanh approximation.
    return F.silu(x) if cfg.activation == "silu" else F.gelu(
        x, approximate="tanh")


def _cast(w: torch.Tensor, dtype) -> torch.Tensor:
    """An expert weight in the compute dtype, made through ``derive``."""
    return coll_lib.derive(lambda t: t.to(dtype), [w])


def dispatch_mode(cfg: GPTConfig) -> str:
    """The capacity router's row movement: ``"einsum"`` only when asked
    for; ``"auto"`` is ``"gather"`` (the JAX rule without an expert
    axis)."""
    return "einsum" if cfg.moe_dispatch == "einsum" else "gather"


def describe(cfg: GPTConfig) -> str:
    """The router of a MoE config in words (the CLI's startup line)."""
    head = f"{cfg.num_experts} experts, top-{cfg.moe_top_k}, "
    if cfg.moe_impl == "dropless":
        return head + "dropless router (grouped matmuls)"
    return head + (f"capacity router, {dispatch_mode(cfg)} dispatch, "
                   f"capacity factor {cfg.expert_capacity_factor}")


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor,
            w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            cfg: GPTConfig, router_stats: Optional[dict] = None, group=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's MoE FFN by ``cfg.moe_impl``: ``capacity_moe`` or
    ``dropless_moe``."""
    fn = dropless_moe if cfg.moe_impl == "dropless" else capacity_moe
    return fn(x, router_kernel, w_gate, w_up, w_down, cfg,
              router_stats=router_stats, group=group)


# -- the dropless router ------------------------------------------------------

def dispatch(gate_idx: torch.Tensor, num_experts: int):
    """``(counts [E] int32, perm [T*k], inv_perm [T*k])`` of the flat
    expert ids: a stable argsort puts the token-choice rows in expert order
    (a pure function of the routing), ``counts`` are the group sizes and
    ``inv_perm`` puts them back. Device ops only."""
    flat = gate_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    perm = torch.argsort(flat, stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.numel(), device=perm.device)
    return counts, perm, inv_perm


def dropless_moe(x: torch.Tensor, router_kernel: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, cfg: GPTConfig,
                 router_stats: Optional[dict] = None, group=None
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
    xt = x.reshape(b * s, H)
    gates, gate_idx, aux, every = route(xt, router_kernel, cfg,
                                        stats=router_stats, group=group)
    counts, perm, inv_perm = dispatch(gate_idx, cfg.num_experts)
    if router_stats is not None:
        with torch.no_grad():
            # The true post-routing load (what each expert computed);
            # nothing is dropped. At world > 1 the global micro-batch's,
            # from every rank's choice counts.
            load = (counts.float() / float(k * b * s)
                    if every.shape[0] == 1 else
                    every.sum(dim=(0, 1)).float()
                    / float(k * b * s * every.shape[0]))
            router_stats.update(
                load=load, drop_frac=torch.zeros((), device=load.device),
                max_group_frac=torch.max(load),
                dropless=torch.ones((), device=load.device))
    grouped_in = xt.to(dtype)[perm // k]                          # [T*k, H]
    mid = (_activation(cfg, gmm(grouped_in, _cast(w_gate, dtype), counts))
           * gmm(grouped_in, _cast(w_up, dtype), counts))
    grouped_out = gmm(mid, _cast(w_down, dtype), counts)          # [T*k, H]
    rows = grouped_out[inv_perm].reshape(b * s, k, H)
    out = torch.sum(rows * gates[..., None].to(dtype), dim=1)
    return out.reshape(b, s, H), aux


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


def rank_offsets(counts: torch.Tensor, rank: int) -> torch.Tensor:
    """``[k, E]``: the token-choices of the ranks before ``rank``, each
    choice and expert (zeros on rank 0 and at one process)."""
    return counts[:rank].sum(dim=0)


def capacity_positions(gate_idx: torch.Tensor, counts: torch.Tensor,
                       rank: int, slots: int):
    """``(pos [T, k] int64, keep [T, k] bool)``: each token-choice's place
    in its expert's queue over the global micro-batch, in choice-major
    order (the JAX exclusive cumsum over the ``[k*T, E]`` one-hot), and
    whether it is below the capacity ``slots``. ``counts [W, k, E]`` are
    every rank's choice counts (``route``); this rank's rows follow the
    earlier ranks'. Integer sums, so exact at any ``T``."""
    E = counts.shape[-1]
    onehot = F.one_hot(gate_idx, E)                              # [T, k, E]
    before = torch.cumsum(onehot, dim=0) - onehot   # earlier tokens, same j
    total = counts.sum(dim=0)                                    # [k, E]
    offset = (torch.cumsum(total, dim=0) - total   # earlier choices, all ranks
              + rank_offsets(counts, rank))
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
                 router_stats: Optional[dict] = None, group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity MoE FFN of one layer on ``x [b, s, H]`` (compute
    dtype): ``(out [b, s, H], aux)``, before the residual dropout (the
    JAX ``MoEMLP.__call__`` with ``moe_impl="capacity"``). ``group`` (a
    ``Collectives`` over the data-parallel ranks) routes the global
    micro-batch; ``router_stats`` receives the JAX ``router`` record."""
    b, s, H = x.shape
    E, k = cfg.num_experts, cfg.moe_top_k
    T = b * s
    dtype = cfg.compute_dtype
    xt = x.reshape(T, H)
    gates, gate_idx, aux, counts = route(xt, router_kernel, cfg,
                                         stats=router_stats, group=group)
    world, rank = counts.shape[0], (0 if group is None else group.rank)
    C = capacity(cfg, world * T)
    pos, keep = capacity_positions(gate_idx, counts, rank, C)
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

    einsum = dispatch_mode(cfg) == "einsum"
    if einsum:
        # slot[t, j, e, c] = 1 where choice j of token t holds slot c of
        # expert e.
        keep_e = F.one_hot(gate_idx, E).float() * keep[..., None]
        slot = (keep_e[..., None] * F.one_hot(
            torch.where(keep, pos, 0), C).float()[:, :, None, :])
        expert_in = torch.einsum("tec,th->ech", slot.sum(dim=1).to(dtype),
                                 xt.to(dtype))
    else:
        flat_ids = torch.where(keep, gate_idx * C + pos, E * C)  # [T, k]
        tc = (torch.arange(T, device=x.device)[:, None]
              + T * torch.arange(k, device=x.device)[None, :])
        slot_tc = torch.full((E * C + 1,), k * T, dtype=torch.int64,
                             device=x.device)
        slot_tc[flat_ids.reshape(-1)] = tc.reshape(-1)
        slot_tc = slot_tc[:E * C]
        slot_token = torch.where(slot_tc == k * T, T, slot_tc % T)
        expert_in = _DispatchRows.apply(xt.to(dtype), slot_token,
                                        flat_ids).reshape(E, C, H)

    mid = (_activation(cfg, torch.bmm(expert_in, _cast(w_gate, dtype)))
           * torch.bmm(expert_in, _cast(w_up, dtype)))
    expert_out = torch.bmm(mid, _cast(w_down, dtype))             # [E, C, H]

    if einsum:
        combine = (slot * gates[:, :, None, None]).sum(dim=1)     # [T, E, C]
        out = torch.einsum("tec,ech->th", combine.to(dtype), expert_out)
    else:
        out = _CombineRows.apply(expert_out.reshape(E * C, H), gates,
                                 flat_ids, slot_tc)
    return out.reshape(b, s, H), aux
