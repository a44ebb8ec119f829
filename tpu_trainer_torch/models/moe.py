"""Dropless Mixture-of-Experts feed-forward (port of the
``moe_impl="dropless"`` path of ``tpu_trainer/models/moe.py``).

A top-k routed expert SwiGLU that replaces the dense MLP of every layer
when ``num_experts > 0`` (MegaBlocks-style token-dropless routing,
arXiv:2211.15841):

- router: f32 logits ``[T, E]`` from an f32 ``[H, E]`` kernel, softmax,
  ``top_k``; the gate is the router probability at k = 1 (Switch) and the
  chosen probabilities renormalised to sum 1 at k > 1 (GShard);
- auxiliaries, returned pre-weighted as one scalar: ``moe_aux_weight * E *
  sum_e f_e * p_e`` (load balance over first-choice fractions) plus
  ``router_z_weight * mean(logsumexp(logits)^2)`` (z-loss);
- the ``T * k`` token-choice rows permuted into expert order by one stable
  argsort, group sizes from a count of the routing, the three SwiGLU
  projections as grouped matmuls (``ops/grouped_matmul.gmm``: the CUDA
  kernels on a CUDA tensor, no host synchronisation), the inverse
  permutation and the gated combine. No token is dropped.

With ``router_stats`` (a telemetry step) the layer also reports its
router health: the true per-expert load fractions, the entropy of the mean
routing distribution, ``drop_frac`` (0: nothing is dropped),
``max_group_frac`` and ``dropless`` = 1.

The capacity router (``moe_impl="capacity"``, the JAX default) is not
ported (``ROADMAP.md`` Queue 1: "the capacity router, on one device");
``check_moe`` raises for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.ops.grouped_matmul import gmm


def check_moe(cfg: GPTConfig) -> None:
    """Raise for the MoE options that later slices port."""
    if cfg.num_experts > 0 and cfg.moe_impl != "dropless":
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r}: only the dropless MoE is ported; "
            f"the capacity router (gather/einsum dispatch) is ROADMAP Queue "
            f"1: the capacity router, on one device")


def route(xt: torch.Tensor, router_kernel: torch.Tensor, cfg: GPTConfig,
          stats: Optional[dict] = None):
    """Router of ``xt [T, H]``: ``(gates [T, k] f32, gate_idx [T, k] int64,
    aux scalar f32)``; ``stats`` (a dict) receives the routing entropy."""
    E, k = cfg.num_experts, cfg.moe_top_k
    logits = xt.float() @ router_kernel.float()                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top_k as jax.lax.top_k: of equal probabilities the lower expert id
    # first (a stable descending sort; torch.topk leaves ties unordered).
    gate_vals, gate_idx = (t[:, :k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gates = gate_vals if k == 1 else (
        gate_vals / gate_vals.sum(dim=-1, keepdim=True))
    frac = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = cfg.moe_aux_weight * E * torch.sum(frac * mean_prob)
    if stats is not None:
        with torch.no_grad():
            mp = mean_prob.detach()
            stats["entropy"] = -torch.sum(mp * torch.log(mp + 1e-9))
    if cfg.router_z_weight > 0.0:
        z = torch.logsumexp(logits, dim=-1)
        aux = aux + cfg.router_z_weight * torch.mean(z * z)
    return gates, gate_idx, aux


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
                 router_stats: Optional[dict] = None
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
    gates, gate_idx, aux = route(xt, router_kernel, cfg, stats=router_stats)
    counts, perm, inv_perm = dispatch(gate_idx, cfg.num_experts)
    if router_stats is not None:
        with torch.no_grad():
            # The true post-routing load (what each expert computed);
            # nothing is dropped.
            load = counts.float() / float(k * b * s)
            router_stats.update(
                load=load, drop_frac=torch.zeros((), device=load.device),
                max_group_frac=torch.max(load),
                dropless=torch.ones((), device=load.device))
    grouped_in = xt.to(dtype)[perm // k]                          # [T*k, H]
    gate = gmm(grouped_in, w_gate.to(dtype), counts)
    act = (F.silu(gate) if cfg.activation == "silu"
           else F.gelu(gate, approximate="tanh"))
    mid = act * gmm(grouped_in, w_up.to(dtype), counts)
    grouped_out = gmm(mid, w_down.to(dtype), counts)              # [T*k, H]
    rows = grouped_out[inv_perm].reshape(b * s, k, H)
    out = torch.sum(rows * gates[..., None].to(dtype), dim=1)
    return out.reshape(b, s, H), aux
