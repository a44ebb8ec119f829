"""Narrow Adam moments (``optimizer_state_dtype``) and their int8 packs,
against the JAX package (``tests/test_optimizer_q.py``'s contracts).

- ``quantize_blockwise_int8`` / ``dequantize_blockwise_int8``: ``q``,
  ``scale`` and the dequantized values bitwise equal to the JAX functions
  at last dims 256, 128, 96 and 50 (block 256, 128, 32, and one block a
  row), signed and ``nonneg``.
- Narrow Adam (bf16, int8) from the same JAX state (``from_jax_opt_state``)
  over 5 steps of the same gradients (clip off) on a tiny GPT whose
  embedding and MLP kernels are >= 64k elements: the stored moments of
  every small leaf (f32) and the bf16 moments are bitwise equal to the JAX
  ones; an int8 pack may sit one quantization step away where a value
  lands on a rounding boundary (|dq| <= 1, scales within 1e-6 relative).
  The parameters after each step (lr 1e-3) agree to atol 1e-9 + rtol
  1e-6: the updates differ by the f32 rounding of the bias-corrected
  quotient (an ulp of values of order one, 1e-10 after the LR), which
  moves a sum with the parameter by at most an ulp of the parameter.
- Packs are told apart by type: parameters named ``q`` and ``scale``
  are ordinary leaves. An unknown dtype raises the JAX ``ValueError``.
- A tiny ``Trainer`` with int8 moments tracks the f32 loss curve within
  the JAX test's bound (rtol = atol = 0.02 over 14 steps).
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import (
    _flatten,
    from_jax_opt_state,
    from_jax_params,
)
from tpu_trainer_torch.training.config import TrainingConfig as TTrain
from tpu_trainer_torch.training.optimizer import make_optimizer, q_eligible
from tpu_trainer_torch.training.trainer import Trainer as TTrainer
from tpu_trainer_torch.utils.quant import (
    QuantPack,
    dequantize_blockwise_int8,
    quantize_blockwise_int8,
)

GPT_KW = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              intermediate_size=256, max_seq_len=16, dropout=0.0,
              attention_dropout=0.0, dtype="float32")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.models.gpt import GPT
    from tpu_trainer.training import optimizer
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.utils import quant
    return types.SimpleNamespace(jax=jax, jnp=jnp, GPTConfig=GPTConfig,
                                 GPT=GPT, optimizer=optimizer,
                                 TrainingConfig=TrainingConfig, quant=quant)


@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("d", [256, 128, 96, 50])
def test_blockwise_int8_matches_jax(jx, d, nonneg):
    rs = np.random.RandomState(d)
    # 320 rows: torch's vectorized CPU loops, not only their tails.
    x = (rs.standard_normal((64, 5, d)) * 10.0 ** rs.uniform(
        -6, 1, (64, 5, 1))).astype(np.float32)
    x[0, 0] = 0.0                                  # an all-zero block
    if nonneg:
        x = np.abs(x) ** 2
        x[1, 1, :3] = -1e-9                        # clamped at 0
    want = jx.quant.quantize_blockwise_int8(jx.jnp.asarray(x), nonneg=nonneg)
    got = quantize_blockwise_int8(torch.from_numpy(x), nonneg=nonneg)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(want["scale"]))
    back = dequantize_blockwise_int8(got, x.shape, torch.float32,
                                     nonneg=nonneg)
    jback = jx.quant.dequantize_blockwise_int8(want, x.shape,
                                               jx.jnp.float32, nonneg=nonneg)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def _pack_close(got: QuantPack, want: QuantPack, name):
    dq = (got.q.int() - want.q.int()).abs()
    assert int(dq.max()) <= 1, name
    torch.testing.assert_close(got.scale, want.scale, rtol=1e-6, atol=0,
                               msg=name)


@pytest.mark.parametrize("state_dtype", ["bfloat16", "int8"])
def test_narrow_adam_tracks_jax(jx, state_dtype):
    jax, jnp = jx.jax, jx.jnp
    jcfg = jx.GPTConfig(**GPT_KW)
    tcfg = TConfig(**GPT_KW)
    params = jx.GPT(jcfg).init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))["params"]
    # The clip stays off: XLA and torch sum the global norm in other
    # orders, so an active clip scales every gradient by a factor an ulp
    # apart (the trainer trajectory tests hold the clipped path).
    kw = dict(optimizer_state_dtype=state_dtype, grad_clip=1e30)
    jtx = jx.optimizer.make_optimizer(jx.TrainingConfig(**kw))
    ttx = make_optimizer(TTrain(**kw))
    rs = np.random.RandomState(0)
    grads = [jax.tree.map(lambda p: (rs.standard_normal(p.shape) * 0.01)
                          .astype(np.float32), params) for _ in range(6)]
    # Start both from the JAX state after one step (nonzero moments).
    js = jtx.init(params)
    _, js = jtx.update(jax.tree.map(jnp.asarray, grads[0]), js, params)
    ts = from_jax_opt_state(jax.tree.map(np.asarray, js), tcfg,
                            device="cpu")
    # Copies: ``apply`` updates them in place.
    tparams = {n: t.clone() for n, t in from_jax_params(
        jax.tree.map(np.asarray, params), tcfg, device="cpu").items()}
    narrow = [n for n, t in tparams.items() if q_eligible(t.shape)]
    assert narrow and len(narrow) < len(tparams)
    jp = params
    for g in grads[1:]:
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        ts = ttx.apply({n: torch.from_numpy(v)
                        for n, v in _flatten(g).items()}, ts, tparams, 1e-3)
        jp = jax.tree.map(lambda p, u: p + 1e-3 * u, jp, ju)
        want_p = _flatten(jax.tree.map(np.asarray, jp))
        for n in want_p:
            np.testing.assert_allclose(tparams[n].numpy(), want_p[n],
                                       atol=1e-9, rtol=1e-6, err_msg=n)
    want = from_jax_opt_state(jax.tree.map(np.asarray, js), tcfg,
                              device="cpu")
    assert ts.count == want.count == 6
    for moments, wants in ((ts.mu, want.mu), (ts.nu, want.nu)):
        for n, m in moments.items():
            w = wants[n]
            if n not in narrow:
                assert m.dtype == torch.float32 and torch.equal(m, w), n
            elif state_dtype == "bfloat16":
                assert m.dtype == torch.bfloat16 and torch.equal(m, w), n
            else:
                assert isinstance(m, QuantPack) and isinstance(w, QuantPack)
                _pack_close(m, w, n)


def test_params_named_q_and_scale_are_not_packs(jx):
    jax, jnp = jx.jax, jx.jnp
    jparams = {"attn": {"q": np.random.RandomState(2).standard_normal(
        (16, 16)).astype(np.float32), "scale": np.ones(16, np.float32)},
        "out": np.random.RandomState(3).standard_normal(
            (16, 8)).astype(np.float32)}
    # No clip and no decay: scale_by_adam_quantized alone.
    tx = make_optimizer(TTrain(optimizer_state_dtype="int8",
                               weight_decay=0.0, grad_clip=1e30))
    jtx = jx.optimizer.scale_by_adam_quantized(0.9, 0.95, 1e-8, "int8")
    tparams = {n: torch.from_numpy(v.copy())
               for n, v in _flatten(jparams).items()}
    ts, js = tx.init(tparams), jtx.init(jax.tree.map(jnp.asarray, jparams))
    assert not any(isinstance(m, QuantPack) for m in ts.mu.values())
    jp = jparams
    for i in range(3):
        rs = np.random.RandomState(10 + i)
        g = jax.tree.map(lambda p: rs.standard_normal(p.shape).astype(
            np.float32), jparams)
        ts = tx.apply({n: torch.from_numpy(v)
                       for n, v in _flatten(g).items()}, ts, tparams, 1e-3)
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js)
        # scale_by_adam's direction is the ascent one.
        jp = jax.tree.map(lambda p, u: p - 1e-3 * u, jp, ju)
        for n, want in _flatten(jax.tree.map(np.asarray, jp)).items():
            np.testing.assert_allclose(tparams[n].numpy(), want, atol=1e-9,
                                       rtol=1e-6, err_msg=n)
    assert ts.count == 3
    # A large parameter named "q" gets a pack; the name plays no part.
    big = {"attn.q": torch.zeros(512, 256)}
    assert isinstance(tx.init(big).nu["attn.q"], QuantPack)


def test_bad_dtype_rejected():
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        make_optimizer(TTrain(optimizer_state_dtype="int16"))


def test_tiny_training_tracks_f32():
    cfg = TConfig(vocab_size=512, hidden_size=128, num_layers=2,
                  num_heads=4, intermediate_size=256, max_seq_len=64,
                  dropout=0.0, attention_dropout=0.0)
    batch = next(iter(DummyDataLoader(4, 64, 512, 1)))
    curves = {}
    for dt in ("float32", "int8", "bfloat16"):
        tr = TTrainer(cfg, TTrain(batch_size=4, max_seq_len=64,
                                  gradient_accumulation_steps=1,
                                  mixed_precision="fp32",
                                  optimizer_state_dtype=dt,
                                  learning_rate=1e-3, warmup_steps=1),
                      device="cpu")
        state = tr.init_state(0)
        curve = []
        for _ in range(14):
            state, m = tr.train_step(state, batch)
            curve.append(m["loss"])
        curves[dt] = np.array(curve)
    assert curves["float32"][-1] < curves["float32"][0]
    for dt in ("int8", "bfloat16"):
        np.testing.assert_allclose(curves[dt], curves["float32"], rtol=0.02,
                                   atol=0.02, err_msg=dt)
