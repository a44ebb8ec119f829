"""Port parity: the dropless MoE FFN and a dropless-MoE GPT.

- Routing (``gate_idx``, group sizes, the stable permutation and its
  inverse) bitwise against the JAX package's ops on the same router
  logits (``models/moe.py:193-206, 373-376``), including ties.
- ``dropless_moe`` against the JAX ``MoEMLP(moe_impl="dropless")``: output
  and aux within atol=rtol=1e-5 (f32 sums in another order), and their
  gradients within 1e-4.
- A tiny dropless-MoE ``GPT`` (vocab 128, hidden 32, 2 layers, 4 experts,
  top-2, z-loss on) on ``from_jax_params`` weights: loss within 2e-5 and
  every gradient within 1e-4 of ``jax.grad`` (the tolerances of
  ``test_torch_train.py``), and a 5-step ``Trainer(device="cpu")``
  trajectory against the JAX ``Trainer`` at accumulation 1 and 2 (loss,
  grad norm, lr rtol 1e-4; final parameters atol 1e-4).
- MFU's flops count the active parameters only, the decay mask names the
  MoE leaves as the JAX one does, the capacity router and MoE decode raise.
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.models import moe as tmoe
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.weights import (
    from_jax_params,
    init_params,
    to_jax_params,
)
from tpu_trainer_torch.ops import grouped_matmul as tgm

TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2,
            num_experts=4, moe_top_k=2, moe_impl="dropless",
            router_z_weight=1e-3, use_flash_attention=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models import moe
    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.models.gpt import GPT
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=moe,
                                 GPTConfig=GPTConfig, GPT=GPT)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


@pytest.mark.parametrize("E,k,ties", [(4, 2, False), (8, 2, True),
                                      (4, 1, False)])
def test_routing_bitwise(jx, E, k, ties):
    jax, jnp = jx.jax, jx.jnp
    rs = np.random.RandomState(E + k)
    T, H = 48, 16
    xt = rs.standard_normal((T, H)).astype(np.float32)
    w = (rs.standard_normal((H, E)) * 0.3).astype(np.float32)
    if ties:
        xt[10:30] = xt[10]                  # identical tokens route alike
        w[:, 3] = w[:, 2]                   # two experts tie everywhere
    cfg = TConfig(**{**BASE, "num_experts": E, "moe_top_k": k})
    # The JAX package's routing ops (models/moe.py).
    logits = jnp.asarray(xt) @ jnp.asarray(w)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    flat = gate_idx.astype(jnp.int32).reshape(-1)
    counts = jnp.bincount(flat, length=E)
    perm = jnp.argsort(flat)
    inv = jnp.argsort(perm)
    gates = gate_vals if k == 1 else gate_vals / jnp.sum(
        gate_vals, axis=-1, keepdims=True)

    tg, tidx, _ = tmoe.route(torch.from_numpy(xt), torch.from_numpy(w), cfg)
    tcounts, tperm, tinv = tmoe.dispatch(tidx, E)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv))
    np.testing.assert_allclose(tg.numpy(), np.asarray(gates), **TOL)
    assert tcounts.dtype == torch.int32


@pytest.mark.parametrize("k,z", [(2, 1e-3), (1, 0.0)])
def test_dropless_ffn_matches_jax_moe_mlp(jx, k, z):
    jax, jnp = jx.jax, jx.jnp
    kw = {**BASE, "moe_top_k": k, "router_z_weight": z}
    jcfg, tcfg = jx.GPTConfig(**kw), TConfig(**kw)
    x = np.random.RandomState(k).standard_normal((2, 16, 32)).astype(
        np.float32)
    module = jx.moe.MoEMLP(jcfg)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jfn(p, x_):
        return module.apply({"params": p}, x_, True)

    (want, want_aux), vjp = jax.vjp(jfn, params, jnp.asarray(x))
    rs = np.random.RandomState(7)
    dout = rs.standard_normal(x.shape).astype(np.float32)
    want_dp, want_dx = vjp((jnp.asarray(dout), jnp.asarray(1.0)))

    p = {n: torch.from_numpy(np.array(v)).requires_grad_(True)
         for n, v in _flat(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.dropless_moe(tx, p["router.kernel"], p["experts_gate"],
                                 p["experts_up"], p["experts_down"], tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)
    torch.autograd.backward([out, aux], [torch.from_numpy(dout),
                                         torch.tensor(1.0)])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **GTOL)
    for n, g in _flat(want_dp).items():
        np.testing.assert_allclose(p[n].grad.numpy(), g, err_msg=n, **GTOL)


def _jax_params(jx, jcfg):
    params = jx.GPT(jcfg).init(jx.jax.random.PRNGKey(0),
                               jx.jnp.zeros((1, 8), jx.jnp.int32))["params"]
    return params, jx.jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("segmented", [False, True])
def test_moe_gpt_loss_and_grads_match_jax(jx, segmented):
    jax, jnp = jx.jax, jx.jnp
    jcfg, tcfg = jx.GPTConfig(**BASE), TConfig(**BASE)
    params, tree = _jax_params(jx, jcfg)
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int32)
    seg = (np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 0]]), 4, axis=1)
           .astype(np.int32) if segmented else None)

    def jloss(p):
        return jx.GPT(jcfg).apply(
            {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
            segment_ids=None if seg is None else jnp.asarray(seg))[1]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    model = TGPT(tcfg, device="meta")
    state = from_jax_params(tree, tcfg, device="cpu")
    model.load_state_dict({n: torch.nn.Parameter(t) for n, t in state.items()},
                          strict=True, assign=True)
    assert "layers.moe_mlp.router.kernel" in state
    assert not any(n.startswith("layers.mlp.") for n in state)
    tids = torch.from_numpy(ids).long()
    _, loss = model(tids, tids,
                    segment_ids=None if seg is None else torch.from_numpy(seg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=2e-5,
                               rtol=2e-5)
    got = _flat(to_jax_params({n: p.grad for n, p in
                               model.named_parameters()}))
    want = _flat(want_grads)
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g, want[n], err_msg=n, **GTOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_moe_trainer_trajectory_matches_jax(jx, accum):
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.training.trainer import ParallelConfig, Trainer
    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.training.config import TrainingConfig as TTrain
    from tpu_trainer_torch.training.trainer import Trainer as TTrainer

    steps = 5
    tkw = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=accum,
               mixed_precision="fp32", learning_rate=3e-3, warmup_steps=2,
               max_steps=steps, seed=0)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1),
                     devices=jx.jax.devices()[:1])
    jtr = Trainer(jx.GPTConfig(**BASE), TrainingConfig(**tkw),
                  ParallelConfig(), mesh=mesh)
    jstate = jtr.init_state(0)
    ttr = TTrainer(TConfig(**BASE), TTrain(**tkw), device="cpu")
    tree = jx.jax.tree.map(np.asarray, jstate.params)
    tstate = ttr.init_state(params=from_jax_params(tree, ttr.model_config,
                                                   device="cpu"))
    before = (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches)
    rows = []
    for batch in DummyDataLoader(2 * accum, 16, 128, steps):
        jstate, jm = jtr.train_step(jstate, batch)
        tstate, tm = ttr.train_step(tstate, batch)
        rows.append(({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")},
                     tm))
    assert (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches) == before
    for j, t in rows:
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-7,
                                       err_msg=key)
    want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_jax_params(tstate.params))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)


def test_flops_count_active_parameters(jx):
    from tpu_trainer.utils.logging import flops_per_token as jflops
    from tpu_trainer_torch.utils.logging import flops_per_token

    for kw in (BASE, dict(BASE, moe_top_k=1),
               dict(num_experts=8, moe_top_k=2, moe_impl="dropless")):
        t, j = TConfig(**kw), jx.GPTConfig(**kw)
        assert flops_per_token(t, 1024) == jflops(j, 1024)
        assert t.num_active_parameters() == j.num_active_parameters()
        assert t.num_active_parameters() < t.num_parameters()
    small = TConfig.gpt2_small(num_experts=8, moe_top_k=2, moe_impl="dropless")
    h, i, L = 768, 3072, 12
    assert (small.num_parameters() - small.num_active_parameters()
            == L * 6 * 3 * h * i)
    assert flops_per_token(small, 1024) == (
        6.0 * small.num_active_parameters() + 12 * L * 1024 * h)


def test_decay_mask_and_init_of_moe_leaves(jx):
    from tpu_trainer.training.optimizer import decay_mask as jmask
    from tpu_trainer_torch.models.weights import param_specs
    from tpu_trainer_torch.training.optimizer import decay_mask

    params, _ = _jax_params(jx, jx.GPTConfig(**BASE))
    want = _flat(jx.jax.tree.map(np.asarray, jmask(params)))
    assert decay_mask(want) == {n: bool(v) for n, v in want.items()}
    specs = param_specs(TConfig(**BASE))
    flat = _flat(jx.jax.tree.map(np.asarray, params))
    assert {n: s for n, (s, _) in specs.items()} == {
        n: v.shape for n, v in flat.items()}
    assert specs["layers.moe_mlp.router.kernel"] == ((2, 32, 4),
                                                     torch.float32)
    assert specs["layers.moe_mlp.experts_down"][0] == (2, 4, 128, 32)
    init = init_params(TConfig(**BASE, ), seed=0, device="cpu")
    assert 0.1 < float(init["layers.moe_mlp.experts_gate"].std()) < 0.3


def test_capacity_router_and_moe_decode_raise():
    with pytest.raises(NotImplementedError, match="Queue 1"):
        TGPT(TConfig(**{**BASE, "moe_impl": "capacity"}), device="meta")
    from tpu_trainer_torch.serving.engine import ServingEngine

    cfg = TConfig(**BASE)
    with pytest.raises(NotImplementedError, match="MoE decode"):
        ServingEngine(init_params(cfg, device="cpu"), cfg, max_batch=2,
                      block_size=4, num_blocks=9, device="cpu")


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_moe_training_step_goes_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.training.config import TrainingConfig as TTrain
    from tpu_trainer_torch.training.trainer import Trainer as TTrainer

    cfg = TConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                  max_seq_len=256, num_experts=4, moe_top_k=2,
                  moe_impl="dropless", router_z_weight=1e-3,
                  use_flash_attention=True)
    tr = TTrainer(cfg, TTrain(batch_size=2, max_seq_len=256,
                              gradient_accumulation_steps=1,
                              mixed_precision="bf16", warmup_steps=1),
                  device="cuda")
    state = tr.init_state(0)
    before = (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches)
    for batch in DummyDataLoader(2, 256, 512, 2):
        state, m = tr.train_step(state, batch)
        assert np.isfinite(m["loss"])
    assert (tgm.gmm_cuda.launches - before[0],
            tgm.tgmm_cuda.launches - before[1]) == (24, 12)
