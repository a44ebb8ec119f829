"""Optimizer-state host offload in the port's ``Trainer`` against the JAX
``Trainer`` (``tests/test_offload.py``'s contracts).

- ``_offload_store`` / ``_offload_load``: from the same f32 moments (the
  JAX trainer's after two steps), the port's storage forms equal the JAX
  ``Trainer._offload_store``'s bitwise (bf16 casts of every float leaf
  with ndim >= 1; int8 packs of every float leaf with ndim >= 2, ``nu`` in
  sqrt-space), with and without a partial-offload budget, and so do the
  loaded f32 moments.
- ``select_resident_moments`` keeps the same leaves and counts the same
  bytes as the JAX function, at the tiny and the GPT-2 small shapes (the
  port's on meta tensors, the JAX one on ``eval_shape`` structs).
- f32 offload is a bitwise no-op on three steps (with and without a
  budget); bf16 and int8 offload track the f32 loss curve within
  ``test_offload.py``'s rtol 0.05 over 12 steps.
- ``cpu_offload`` with a narrow ``optimizer_state_dtype`` raises, as the
  JAX trainer does.
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import from_jax_opt_state
from tpu_trainer_torch.training.config import TrainingConfig as TTrain
from tpu_trainer_torch.training.optimizer import AdamWState
from tpu_trainer_torch.training.trainer import (
    ParallelConfig,
    Trainer,
    moment_key,
    select_resident_moments,
)
from tpu_trainer_torch.utils.quant import QuantPack

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=32, dropout=0.0, attention_dropout=0.0,
            use_flash_attention=False, dtype="float32")
TRAIN = dict(batch_size=1, max_seq_len=32, gradient_accumulation_steps=1,
             mixed_precision="fp32", warmup_steps=2, max_steps=12)
# Budgets in whole bytes (the trainer takes GB = bytes / 2**30).
BUDGET = 40_000


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training import trainer as jtrainer
    from tpu_trainer.training.config import TrainingConfig
    return types.SimpleNamespace(jax=jax, jnp=jnp, GPTConfig=GPTConfig,
                                 MeshConfig=MeshConfig, make_mesh=make_mesh,
                                 trainer=jtrainer,
                                 TrainingConfig=TrainingConfig)


def _jax_trainer(jx):
    mesh = jx.make_mesh(jx.MeshConfig(data=1, fsdp=1),
                        devices=jx.jax.devices()[:1])
    return jx.trainer.Trainer(
        jx.GPTConfig(**TINY), jx.TrainingConfig(**TRAIN),
        jx.trainer.ParallelConfig(jx.MeshConfig(data=1, fsdp=1),
                                  "replicated"), mesh=mesh)


def _port(dtype="float32", budget_bytes=0, offload=True, **train):
    return Trainer(TConfig(**TINY), TTrain(**{**TRAIN, **train}),
                   ParallelConfig(cpu_offload=offload, offload_dtype=dtype,
                                  offload_budget_gb=budget_bytes / 2**30),
                   device="cpu")


def _same(a, b) -> bool:
    if isinstance(a, QuantPack):
        return (isinstance(b, QuantPack) and torch.equal(a.q, b.q)
                and torch.equal(a.scale, b.scale))
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("budget", [0, BUDGET])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_offload_store_and_load_match_jax(jx, dtype, budget):
    jt = _jax_trainer(jx)
    state = jt.init_state(0)
    for batch in DummyDataLoader(1, 32, 128, 2):
        state, _ = jt.train_step(state, batch)
    if dtype == "int8":
        jt._offload_quant = True
    else:
        jt._offload_cast = jx.jnp.dtype(dtype)
    tt = _port(dtype, budget)
    if budget:
        shapes = jx.jax.eval_shape(lambda s: s, state.opt_state)
        jt._offload_keep, used = jx.trainer.select_resident_moments(
            shapes, budget)
        assert used == tt.offload_resident_bytes > 0
        assert {k[2:] for k in jt._offload_keep} == set(tt._offload_keep)
    to_np = lambda t: jx.jax.tree.map(np.asarray, t)   # noqa: E731
    f32 = from_jax_opt_state(to_np(state.opt_state), tt.model_config,
                             device="cpu")
    stored = jt._offload_store(state.opt_state)
    want = from_jax_opt_state(to_np(stored), tt.model_config, device="cpu")
    got = tt._offload_store(f32)
    kept = 0
    for m in ("mu", "nu"):
        for n, x in getattr(got, m).items():
            assert _same(x, getattr(want, m)[n]), (m, n)
            kept += moment_key(m, n) in tt._offload_keep
            if moment_key(m, n) in tt._offload_keep:
                assert x.dtype == torch.float32
    assert kept == len(tt._offload_keep)
    back = tt._offload_load(got)
    jback = from_jax_opt_state(to_np(jt._offload_load(stored)),
                               tt.model_config, device="cpu")
    for m in ("mu", "nu"):
        for n, x in getattr(back, m).items():
            assert x.dtype == torch.float32
            assert torch.equal(x, getattr(jback, m)[n]), (m, n)


@pytest.mark.parametrize("budget_frac", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_select_resident_moments_matches_jax(jx, preset, budget_frac):
    jax, jnp = jx.jax, jx.jnp
    from tpu_trainer.models.gpt import GPT
    from tpu_trainer.training.optimizer import make_optimizer

    kw = TINY if preset == "tiny" else {}
    jcfg = (jx.GPTConfig(**kw) if kw else jx.GPTConfig.preset("small"))
    tcfg = TConfig(**kw) if kw else TConfig.preset("small")
    p_shapes = jax.eval_shape(
        lambda rng: GPT(jcfg).init(rng, jnp.zeros((1, 8), jnp.int32))
        ["params"], jax.random.PRNGKey(0))
    opt_shapes = jax.eval_shape(
        make_optimizer(jx.TrainingConfig()).init, p_shapes)
    tt = Trainer(tcfg, TTrain(), device="cpu")
    moments = tt._moment_shapes()
    assert all(t.device.type == "meta" for t in moments.values())
    total = sum(t.numel() * 4 for t in moments.values())
    budget = int(total * budget_frac)
    jkeep, jused = jx.trainer.select_resident_moments(opt_shapes, budget)
    keep, used = select_resident_moments(moments, budget)
    assert used == jused
    assert keep == {k[2:] for k in jkeep}
    assert (len(keep) > 0) == (budget_frac > 0)


def _run(trainer, steps=3):
    state = trainer.init_state(0)
    losses = []
    for batch in DummyDataLoader(1, 32, 128, steps):
        state, m = trainer.train_step(state, batch)
        losses.append(m["loss"])
    return state, losses


@pytest.mark.parametrize("budget", [0, BUDGET])
def test_f32_offload_is_a_bitwise_noop(budget):
    base, _ = _run(_port(offload=False))
    off_trainer = _port("float32", budget)
    off, _ = _run(off_trainer)
    a, b = base.state_dict(), off.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    # What streamed each way: every f32 moment outside the budget.
    want = sum(4 * p.numel() for n, p in off.params.items()
               for m in ("mu", "nu")
               if moment_key(m, n) not in off_trainer._offload_keep)
    assert off_trainer.offload_stream_bytes == want


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_narrow_offload_tracks_f32(dtype):
    _, exact = _run(_port(offload=False), 12)
    trainer = _port(dtype)
    state, narrow = _run(trainer, 12)
    np.testing.assert_allclose(narrow, exact, rtol=0.05)
    assert narrow[-1] < narrow[0]
    forms = {type(x).__name__ if isinstance(x, QuantPack) else str(x.dtype)
             for tree in (state.opt_state.mu, state.opt_state.nu)
             for x in tree.values()}
    # int8 packs the ndim >= 2 leaves and keeps the norm gains f32
    # (stacked norm gains are [L, H]: 2-D, so they pack too); bf16 casts
    # every leaf.
    want = ({"QuantPack", "torch.float32"} if dtype == "int8"
            else {"torch.bfloat16"})
    assert forms == want
    assert isinstance(state.opt_state, AdamWState)


def test_cpu_offload_with_narrow_state_raises():
    with pytest.raises(ValueError, match="optimizer_state_dtype=float32"):
        _port("int8", optimizer_state_dtype="bfloat16")
    with pytest.raises(ValueError, match="offload_dtype"):
        _port("int16")
