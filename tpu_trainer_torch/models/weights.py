"""Weights for the port's GPT: Flax-named state dicts.

The port's parameter names are the Flax paths with ``/`` written ``.``
(``layers/attention/q_proj/kernel`` -> ``layers.attention.q_proj.kernel``)
and keep their layouts (Dense ``[in, out]``, scanned layers stacked
``[num_layers, ...]``), so a Flax param tree carries across by name and a
name-based rule such as the optimizer's decay mask ("norm" in the path
means no decay) reads the same in both packages.

- ``load_params_npz`` reads the ``a/b/c``-key npz that the JAX package's
  ``save_params_npz`` writes (``tpu_trainer/serving/remote.py``).
- ``from_jax_params`` maps a nested-dict Flax tree of numpy arrays onto
  a state dict for ``GPT``; ``to_jax_params`` is its inverse.
- ``init_params`` draws a fresh state dict the way Flax initializes the
  model: normal(std=initializer_range) kernels and embedding, ones for
  the norm weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.utils.device import resolve_device


def load_params_npz(path: str) -> dict:
    """Nested dict of numpy arrays from an ``a/b/c``-key npz."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            cur = out
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = z[key]
    return out


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(_flatten(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def param_specs(config: GPTConfig) -> Dict[str, tuple]:
    """Name -> (shape, dtype) of every parameter of ``GPT(config)`` (norm
    weights are f32 whatever the param dtype, as in Flax)."""
    model = GPT(config, device="meta")
    return {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}


def from_jax_params(tree, config: GPTConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``GPT(config)`` from a Flax param tree (nested
    dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` or
    ``load_params_npz``). Raises on a missing, extra or misshaped leaf."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    want = param_specs(config)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    bad = sorted(n for n in set(want) & set(flat)
                 if tuple(flat[n].shape) != want[n][0])
    if missing or extra or bad:
        raise ValueError(
            f"param tree does not match GPT({config.hidden_size=}, "
            f"{config.num_layers=}): missing {missing}, extra {extra}, "
            f"misshaped {[(n, flat[n].shape, want[n][0]) for n in bad]}")
    return {
        n: torch.from_numpy(np.asarray(flat[n], np.float32)).to(
            device=dev, dtype=dtype)
        for n, (_, dtype) in want.items()
    }


def to_jax_params(state: Dict[str, torch.Tensor]) -> dict:
    """The nested-dict Flax tree (f32 numpy arrays) of a ``GPT`` state dict
    or named-parameter dict: the inverse of ``from_jax_params``."""
    tree: dict = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        cur = tree
        for key in path:
            cur = cur.setdefault(key, {})
        cur[leaf] = t.detach().float().cpu().numpy()
    return tree


def init_params(config: GPTConfig, seed: int = 0, device=None
                ) -> Dict[str, torch.Tensor]:
    """A fresh state dict drawn like Flax's init, from ``seed`` (a torch
    generator on the target device; the draws differ from JAX's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for name, (shape, dtype) in sorted(param_specs(config).items()):
        if name.endswith(".weight"):       # RMSNorm scales
            t = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * config.initializer_range
        out[name] = t.to(dtype)
    return out
