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
- ``from_jax_opt_state`` maps the JAX optimizer state (numpy leaves) onto
  the port's ``AdamWState``: f32 and bf16 moments and int8 ``QuantPack``s
  keep their storage form.
- ``init_params`` draws a fresh state dict the way Flax initializes the
  model: normal(std=initializer_range) kernels and embedding, ones for
  the norm weights.
- ``build_model`` puts a state dict into an inference ``GPT``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.training.optimizer import AdamWState
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.quant import QuantPack


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


def _rank_slices(config: GPTConfig, tensor: tuple, expert: tuple,
                 stage: tuple = (0, 1)):
    """``name -> fn(global leaf) -> this rank's slice`` for tensor rank
    ``tensor[0]`` of ``tensor[1]``, expert rank ``expert[0]`` of
    ``expert[1]`` and stage rank ``stage[0]`` of ``stage[1]`` (its layers
    under ``config``'s schedule; ``parallel/sharding.leaf_specs``)."""
    from tpu_trainer_torch.parallel.pipeline import virtual_stages
    from tpu_trainer_torch.parallel.sharding import leaf_specs, local_slice

    specs = leaf_specs({n: s for n, (s, _) in param_specs(config).items()},
                       "replicated", 1, tensor[1], expert[1], stage[1],
                       virtual_stages(config))
    return {n: (lambda a, sp=sp: local_slice(a, sp, tensor[0], expert[0],
                                             stage[0]))
            for n, sp in specs.items()}


def from_jax_params(tree, config: GPTConfig, device=None, *,
                    tensor: tuple = (0, 1), expert: tuple = (0, 1),
                    stage: tuple = (0, 1)) -> Dict[str, torch.Tensor]:
    """State dict for ``GPT(config)`` from a Flax param tree (nested
    dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)`` or
    ``load_params_npz``). Raises on a missing, extra or misshaped leaf.
    ``tensor=(rank, size)`` / ``expert=(rank, size)`` / ``stage=(rank,
    size)``: a rank's slices of the leaves those axes split (its Megatron
    slice, its experts, its stage's layers by global index: a block, or
    its chunks under the interleaved schedule)."""
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
    cut = _rank_slices(config, tensor, expert, stage)
    return {
        n: torch.from_numpy(np.array(cut[n](np.asarray(flat[n])),
                                     np.float32)).to(device=dev, dtype=dtype)
        for n, (_, dtype) in want.items()
    }


def _tensor(arr, device) -> torch.Tensor:
    """numpy (bf16 as ``ml_dtypes.bfloat16``) -> a tensor of that dtype."""
    arr = np.array(arr)              # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _adam_state(node):
    """The ``(count, mu, nu)`` record inside an optax chain's state."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _adam_state(child)
            if found is not None:
                return found
    return None


def from_jax_opt_state(opt_state, config: GPTConfig,
                       device=None) -> AdamWState:
    """The port's ``AdamWState`` from a JAX optimizer state whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, state.opt_state)``, the
    on-device narrow state or the offload storage form alike). Each
    moment keeps its form: an array (f32, bf16) or, where a parameter's
    path holds a ``q`` / ``scale`` mapping, an int8 ``QuantPack`` (found
    by position, so a parameter named ``q`` is never taken for a pack)."""
    dev = resolve_device(device)
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam (count, mu, nu) state in opt_state")
    names = param_specs(config)

    def leaf(tree, name):
        node = tree
        for key in name.split("."):
            node = node[key]
        if hasattr(node, "keys"):
            return QuantPack(q=_tensor(node["q"], dev),
                             scale=_tensor(node["scale"], dev))
        return _tensor(node, dev)

    return AdamWState(int(np.asarray(adam.count)),
                      {n: leaf(adam.mu, n) for n in names},
                      {n: leaf(adam.nu, n) for n in names})


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


def meta_model(config: GPTConfig, params):
    """``(GPT(config) on "meta", its named parameters)``, after checking
    that ``params`` names exactly those parameters (a missing or extra
    name raises)."""
    model = GPT(config, device="meta")
    specs = dict(model.named_parameters())
    missing = set(specs) - set(params)
    if missing:
        raise ValueError(f"missing parameters {sorted(missing)}")
    extra = sorted(set(params) - set(specs))
    if extra:
        raise ValueError(f"unexpected parameter {extra[0]!r}")
    return model, specs


def build_model(config: GPTConfig, params, device, *,
                tensor: tuple = (0, 1)) -> GPT:
    """``GPT(config)`` for inference on ``device`` holding ``params`` (a
    state dict of tensors or arrays, moved and cast to each parameter's
    device and dtype; a missing or extra name raises). ``tensor=(rank,
    size)``: the model holds tensor rank ``rank``'s Megatron slices
    (``parallel/sharding.leaf_specs``; a MoE layer's experts too) and runs
    under a mesh context whose tensor group has ``size`` ranks."""
    model, specs = meta_model(config, params)
    cut = _rank_slices(config, tensor, (0, 1))
    for name, value in params.items():
        t = cut[name](torch.as_tensor(value))
        t = t.to(device=device, dtype=specs[name].dtype).contiguous()
        module, attr = name.rsplit(".", 1)
        model.get_submodule(module)._parameters[attr] = torch.nn.Parameter(
            t, requires_grad=False)
    return model.eval()


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
