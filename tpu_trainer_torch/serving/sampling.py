"""Batched per-request sampling (port of ``tpu_trainer/serving/sampling.py``).

``filter_logits`` is the deterministic filtering pipeline — top-k at a
shared ``k_cap``, temperature scale, nucleus top-p — and matches the JAX
function within float tolerance with identical ``-inf`` masks.

``sample_tokens`` draws each sampled row from its own ``torch.Generator``
seeded by (request key, token index): the stream of a request depends
only on its seed and position, never on which other requests share the
batch or how scheduling interleaved them — what makes
recompute-preemption resume exactly. ``temperature == 0`` rows take the
exact argmax. JAX's threefry draws cannot be reproduced here, so sampled
streams differ from the JAX package's (they agree in distribution);
greedy ones agree.

Speculative decoding (``serving/spec.py``) makes up to three draws at one
token index: the accept uniform and the residual draw take their own
salted seeds (``draw_seed(key, step, salt)``, salts 1 and 2, where JAX
folds the same salts into the step's key), and the bonus draw is the
unsalted one, exactly the draw ``sample_tokens`` makes there.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective 64-bit mix."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def request_key(seed: int) -> int:
    """The per-request key the engine stores host-side (63-bit int)."""
    return _mix64(int(seed) & _MASK64) >> 1


def draw_seed(key: int, step: int, salt: int = 0) -> int:
    """Generator seed of the draw at token index ``step`` of a request;
    a nonzero ``salt`` names another draw at the same index."""
    seed = _mix64(int(key) ^ _mix64(int(step) & _MASK64)) >> 1
    if salt:
        seed = _mix64(seed ^ _mix64(int(salt) & _MASK64)) >> 1
    return seed


def _generator(key: int, step: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        draw_seed(key, step, salt))


def gumbel_noise(key: int, step: int, vocab: int, device, *,
                 salt: int = 0) -> torch.Tensor:
    """``[vocab]`` Gumbel noise of one draw: ``argmax(logits + noise)``
    is a categorical draw from ``softmax(logits)``."""
    u = torch.rand(vocab, generator=_generator(key, step, salt, device),
                   device=device)
    return -torch.log(-torch.log(u))


def uniform(key: int, step: int, device, *, salt: int) -> torch.Tensor:
    """One U[0, 1) draw (a ``[1]`` tensor) of a salted seed."""
    return torch.rand(1, generator=_generator(key, step, salt, device),
                      device=device)


def filter_logits(
    logits: torch.Tensor,    # [b, vocab] f32
    temps: torch.Tensor,     # [b] f32; 0 = greedy (rows pass through)
    top_ks: torch.Tensor,    # [b] int; 0 = no top-k filter
    top_ps: torch.Tensor,    # [b] f32; 1 = no nucleus filter
    *,
    k_cap: int,
) -> torch.Tensor:
    """Temperature-scaled logits with top-k then top-p applied per row.

    One ``topk(logits, k_cap)`` serves all rows, each masking at its own
    kth value. Nucleus filtering keeps the smallest set of tokens whose
    cumulative (temperature-scaled) probability reaches ``top_p`` —
    boundary ties kept, the top token always survives; rows with
    ``top_p == 1`` skip the nucleus mask.
    """
    b, vocab = logits.shape
    k_cap = max(1, min(k_cap, vocab))
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    vals = torch.topk(logits, k_cap, dim=-1).values          # [b, k_cap] desc
    k = torch.clamp(top_ks.long(), 0, k_cap)
    kth = torch.gather(vals, 1, torch.clamp(k - 1, min=0)[:, None])
    filtered = torch.where((k > 0)[:, None] & (logits < kth), neg_inf, logits)
    scaled = filtered / torch.where(temps > 0, temps,
                                    torch.ones_like(temps))[:, None]
    p_lim = torch.clamp(top_ps, 0.0, 1.0)
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values    # [b, vocab]
    csum = torch.cumsum(sp, dim=-1)
    keep_n = torch.clamp(((csum - sp) < p_lim[:, None]).sum(dim=-1), min=1)
    cutoff = torch.gather(sp, 1, (keep_n - 1)[:, None])
    return torch.where((p_lim < 1.0)[:, None] & (probs < cutoff), neg_inf,
                       scaled)


def sample_tokens(
    logits: torch.Tensor,    # [b, vocab] f32
    temps: np.ndarray,       # [b] f32; 0 = greedy
    top_ks: np.ndarray,      # [b] int; 0 = no top-k filter
    top_ps: np.ndarray,      # [b] f32; 1 = no nucleus filter
    keys: Sequence[int],     # [b] per-request keys (request_key)
    steps: Sequence[int],    # [b] token index within each request
    *,
    k_cap: int,
) -> torch.Tensor:
    """One token id per row (int64 ``[b]`` on ``logits.device``).

    Sampled rows draw Gumbel noise from a generator seeded by
    ``draw_seed(key, step)`` on the logits' device and take
    ``argmax(filtered + noise)``: a categorical draw from the filtered
    distribution that no other row can perturb.
    """
    tokens = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(np.asarray(temps) > 0)
    if rows.size == 0:
        return tokens
    dev = logits.device
    scaled = filter_logits(
        logits, torch.as_tensor(temps, dtype=torch.float32, device=dev),
        torch.as_tensor(top_ks, dtype=torch.int64, device=dev),
        torch.as_tensor(top_ps, dtype=torch.float32, device=dev),
        k_cap=k_cap)
    vocab = logits.shape[1]
    for r in rows:
        tokens[r] = torch.argmax(
            scaled[r] + gumbel_noise(keys[r], steps[r], vocab, dev))
    return tokens
