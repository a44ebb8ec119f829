"""Per-block remat (``gradient_checkpointing``) in the port's GPT.

- With ``remat_policy`` "full" and "dots", dropout on (the hash masks of
  the flash path and the Bernoulli masks of the plain path), packed
  segments, ``remat_lm_head`` without the fused loss, and dropless MoE:
  the loss, every gradient and the dropout generator's state after the
  step are bitwise equal to the step without remat. A recompute that drew
  fresh seeds (the naive wrapper) is caught by the same comparison.
- "dots" keeps the matmul outputs: its backward runs exactly the no-remat
  step's matmuls, while "full" reruns the forward's.
- Dropout off, the port's remat loss and gradients match the JAX remat
  model's (``GPT.apply`` + ``jax.grad``) within ``test_torch_train.py``'s
  bounds: loss atol=rtol=2e-5, gradients atol=rtol=1e-4.
"""

import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.weights import (
    from_jax_params,
    init_params,
    to_jax_params,
)
from tpu_trainer_torch.training.config import TrainingConfig as TTrain
from tpu_trainer_torch.training.trainer import Trainer as TTrainer

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16, dtype="float32", param_dtype="float32",
            initializer_range=0.2)
DROP = dict(dropout=0.1, attention_dropout=0.1)
PATHS = {
    "hash_flash": dict(DROP, use_flash_attention=True),
    "bernoulli_plain": dict(DROP, fast_dropout=False),
    "remat_lm_head": dict(DROP, fused_loss=False, remat_lm_head=True),
    "packed_gqa": dict(DROP, use_flash_attention=True, num_heads=4,
                       num_kv_heads=2),
    "moe_dropless": dict(DROP, num_experts=4, moe_top_k=2,
                         moe_impl="dropless"),
}
SEGMENTS = np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 0]]), 4, axis=1)


def _model(kw, **remat):
    cfg = TConfig(**{**BASE, **kw, **remat})
    model = TGPT(cfg, device="meta")
    model.load_state_dict(
        {n: torch.nn.Parameter(t)
         for n, t in init_params(cfg, 0, device="cpu").items()},
        strict=True, assign=True)
    return model


def _step(model, segmented):
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 128, (2, 16))).long()
    seg = torch.from_numpy(SEGMENTS).long() if segmented else None
    gen = torch.Generator().manual_seed(7)
    _, loss = model(ids, ids, train=True, segment_ids=seg, generator=gen)
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            gen.get_state())


def _equal(a, b) -> bool:
    return (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and all(torch.equal(a[1][n], b[1][n]) for n in a[1]))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_remat_step_is_bitwise_the_plain_step(path, policy):
    segmented = path == "packed_gqa"
    want = _step(_model(PATHS[path]), segmented)
    got = _step(_model(PATHS[path], gradient_checkpointing=True,
                       remat_policy=policy), segmented)
    assert torch.isfinite(got[0])
    assert _equal(got, want)


def test_fresh_seed_recompute_is_rejected(monkeypatch):
    """The planted fault: a checkpoint around the block that lets the
    recompute draw new dropout seeds. The backward then runs against masks
    the forward never used, and the comparison above must see it."""
    def naive(self, x, p, step):
        return checkpoint(lambda x_in: self._train_block(x_in, p, step), x,
                          use_reentrant=False)

    kw = PATHS["hash_flash"]
    want = _step(_model(kw), False)
    monkeypatch.setattr(TGPT, "_remat_block", naive)
    got = _step(_model(kw, gradient_checkpointing=True), False)
    assert torch.equal(got[0], want[0])        # the forward is unchanged
    assert not _equal(got, want)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_matmuls(**remat):
    model = _model(dict(use_flash_attention=True), **remat)
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 128, (2, 16))).long()
    _, loss = model(ids, ids)
    with _CountMatmuls() as count:
        loss.backward()
    return count.n


def test_dots_policy_keeps_matmul_outputs():
    plain = _backward_matmuls()
    assert _backward_matmuls(gradient_checkpointing=True,
                             remat_policy="dots") == plain
    # "full" reruns the forward's matmuls in the backward.
    assert _backward_matmuls(gradient_checkpointing=True) > plain


def test_no_grad_forward_does_not_remat():
    model = _model(PATHS["hash_flash"], gradient_checkpointing=True)
    ids = torch.arange(16).reshape(1, 16)
    with torch.no_grad():
        logits, loss = model(ids, ids)
    assert logits is None and not loss.requires_grad


def test_trainer_steps_with_remat_are_bitwise():
    """Two accumulated ``Trainer`` steps with dropout: params, moments and
    the generator equal the run without remat."""
    def run(remat):
        cfg = TConfig(**{**BASE, **PATHS["hash_flash"],
                         "gradient_checkpointing": remat})
        tr = TTrainer(cfg, TTrain(batch_size=2, max_seq_len=16,
                                  gradient_accumulation_steps=2,
                                  mixed_precision="fp32", warmup_steps=1,
                                  learning_rate=1e-3, max_steps=4),
                      device="cpu")
        state = tr.init_state(0)
        for batch in DummyDataLoader(4, 16, 128, 2):
            state, _ = tr.train_step(state, batch)
        return state.state_dict()

    a, b = run(False), run(True)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.models.gpt import GPT
    return types.SimpleNamespace(jax=jax, jnp=jnp, GPTConfig=GPTConfig,
                                 GPT=GPT)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", [
    dict(remat_policy="full", use_flash_attention=True),
    dict(remat_policy="dots", use_flash_attention=True),
    dict(remat_policy="full", fused_loss=False, remat_lm_head=True),
], ids=["full", "dots", "remat_lm_head"])
def test_remat_loss_and_grads_match_jax(jx, case):
    jax, jnp = jx.jax, jx.jnp
    kw = {**BASE, "dropout": 0.0, "attention_dropout": 0.0,
          "gradient_checkpointing": True, **case}
    jcfg = jx.GPTConfig(**kw)
    params = jx.GPT(jcfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int32)

    def jloss(p):
        return jx.GPT(jcfg).apply({"params": p}, jnp.asarray(ids),
                                  labels=jnp.asarray(ids))[1]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    tcfg = TConfig(**kw)
    model = TGPT(tcfg, device="meta")
    model.load_state_dict(
        {n: torch.nn.Parameter(t) for n, t in from_jax_params(
            jax.tree.map(np.asarray, params), tcfg, device="cpu").items()},
        strict=True, assign=True)
    tids = torch.from_numpy(ids).long()
    logits, loss = model(tids, tids)
    assert logits is None
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    want = _flat(want_grads)
    got = _flat(to_jax_params({n: p.grad
                               for n, p in model.named_parameters()}))
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **GTOL)
