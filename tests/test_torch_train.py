"""Port parity: the training forward, gradients and the Trainer.

Weights cross frameworks the way a deployment carries them: the JAX
params go through ``save_params_npz`` -> the port's ``load_params_npz``
-> ``from_jax_params``. Tiny geometry (vocab 128, hidden 32, 2 layers,
seq 16), f32, dropout off; batches from the same ``DummyDataLoader`` seed
on both sides.

Tolerances, and why:
- Logits and loss atol=rtol=2e-5 (the paged-forward tests' bound: f32
  through two layers and a 128-wide head, matmul/softmax reduction orders
  differ by a few ulp).
- Gradients atol=rtol=1e-4: the same f32 differences, carried through
  the backward's longer reduction chains (sums over 2*16 tokens and the
  vocab).
- The 10-step trajectory: loss, grad_norm and lr rtol=1e-4 and final
  params atol=1e-4. Adam divides by sqrt(v): an element whose gradient is
  near zero gets an O(1) update from O(ulp) differences, so the params
  drift by up to ~lr * (steps) * that, never by the gradient's own size.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.weights import (
    from_jax_params,
    load_params_npz,
    to_jax_params,
)
from tpu_trainer_torch.training.config import TrainingConfig as TTrain
from tpu_trainer_torch.training.optimizer import decay_mask, make_optimizer
from tpu_trainer_torch.training.trainer import Trainer as TTrainer
from tpu_trainer_torch.training.trainer import _split_packed
from tpu_trainer_torch.utils.guards import check_finite
from tpu_trainer_torch.utils.logging import (
    flops_per_token,
    mfu,
    peak_flops_for_name,
)

TOL = dict(atol=2e-5, rtol=2e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2)
CONFIGS = {
    "mha_flash": {"use_flash_attention": True},
    "gqa_flash": {"num_heads": 4, "num_kv_heads": 2,
                  "use_flash_attention": True},
    "reference_attention": {"num_heads": 4, "num_kv_heads": 2},
    "unfused_loss_and_projections": {"fused_loss": False,
                                     "fused_projections": False},
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.models.gpt import GPT
    from tpu_trainer.serving.remote import save_params_npz
    return types.SimpleNamespace(jax=jax, jnp=jnp, GPTConfig=GPTConfig,
                                 GPT=GPT, save_params_npz=save_params_npz)


def _jax_params(jx, jcfg, tmp_path):
    params = jx.GPT(jcfg).init(jx.jax.random.PRNGKey(0),
                               jx.jnp.zeros((1, 8), jx.jnp.int32))["params"]
    path = str(tmp_path / "params.npz")
    jx.save_params_npz(path, jx.jax.tree.map(np.asarray, params))
    return params, path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _port_model(tcfg, path):
    model = TGPT(tcfg, device="meta")
    state = from_jax_params(load_params_npz(path), tcfg, device="cpu")
    model.load_state_dict({n: torch.nn.Parameter(t) for n, t in state.items()},
                          strict=True, assign=True)
    return model


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_loss_and_grads_match_jax(jx, name, segmented, tmp_path):
    jax, jnp = jx.jax, jx.jnp
    kw = {**BASE, **CONFIGS[name]}
    jcfg, tcfg = jx.GPTConfig(**kw), TConfig(**kw)
    params, path = _jax_params(jx, jcfg, tmp_path)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 128, (2, 16)).astype(np.int32)
    seg = (np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 0]]), 4, axis=1)
           .astype(np.int32) if segmented else None)
    jseg = jnp.asarray(seg) if segmented else None

    def jloss(p):
        return jx.GPT(jcfg).apply({"params": p}, jnp.asarray(ids),
                                  labels=jnp.asarray(ids),
                                  segment_ids=jseg)[1]

    want_logits, _ = jx.GPT(jcfg).apply({"params": params}, jnp.asarray(ids),
                                        segment_ids=jseg)
    want_loss, want_grads = jax.value_and_grad(jloss)(params)

    model = _port_model(tcfg, path)
    tids = torch.from_numpy(ids).long()
    tseg = torch.from_numpy(seg) if segmented else None
    with torch.no_grad():
        logits, none_loss = model(tids, segment_ids=tseg)
    assert none_loss is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    got_logits, loss = model(tids, tids, segment_ids=tseg)
    assert (got_logits is None) == tcfg.fused_loss
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    got = to_jax_params({n: p.grad for n, p in model.named_parameters()})
    want = _flat(want_grads)
    assert set(_flat(got)) == set(want)
    for n, g in _flat(got).items():
        np.testing.assert_allclose(g, want[n], err_msg=n, **GTOL)


def _jax_trainer(jx, mcfg_kw, tcfg_kw):
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.training.trainer import ParallelConfig, Trainer

    mesh = make_mesh(MeshConfig(data=1, fsdp=1),
                     devices=jx.jax.devices()[:1])
    return Trainer(jx.GPTConfig(**mcfg_kw), TrainingConfig(**tcfg_kw),
                   ParallelConfig(), mesh=mesh)


@pytest.mark.parametrize("accum", [1, 2])
def test_ten_step_trajectory_matches_jax_trainer(jx, accum):
    mkw = {**BASE, "use_flash_attention": True}
    tkw = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=accum,
               mixed_precision="fp32", learning_rate=3e-3, warmup_steps=3,
               max_steps=10, seed=0)
    jtr = _jax_trainer(jx, mkw, tkw)
    jstate = jtr.init_state(0)
    ttr = TTrainer(TConfig(**mkw), TTrain(**tkw), device="cpu")
    tree = jx.jax.tree.map(np.asarray, jstate.params)
    tstate = ttr.init_state(params=from_jax_params(tree, ttr.model_config,
                                                   device="cpu"))
    loader = DummyDataLoader(batch_size=2 * accum, seq_len=16,
                             vocab_size=128, num_batches=10)
    rows = []
    for batch in loader:
        jstate, jm = jtr.train_step(jstate, batch)
        tstate, tm = ttr.train_step(tstate, batch)
        rows.append(({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")},
                     tm))
    assert tstate.step == 10 and int(jstate.step) == 10
    for j, t in rows:
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-7,
                                       err_msg=key)
    assert rows[-1][1]["loss"] < rows[0][1]["loss"]
    want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_jax_params(tstate.params))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)


def test_decay_mask_names_match_jax(jx, tmp_path):
    from tpu_trainer.training.optimizer import decay_mask as jmask

    params, _ = _jax_params(jx, jx.GPTConfig(**BASE), tmp_path)
    want = _flat(jx.jax.tree.map(np.asarray, jmask(params)))
    got = decay_mask(want)
    assert got == {n: bool(v) for n, v in want.items()}
    assert not got["norm.weight"] and got["embed_tokens.embedding"]
    assert not got["layers.input_layernorm.weight"]


def test_lr_schedule_matches_jax(jx):
    from tpu_trainer.training.config import TrainingConfig

    kw = dict(learning_rate=6e-4, warmup_steps=5, max_steps=20)
    j, t = TrainingConfig(**kw), TTrain(**kw)
    for step in (0, 1, 4, 5, 6, 12, 20, 25):
        np.testing.assert_allclose(t.lr_at(step), float(j.lr_at(step)),
                                   rtol=1e-6, atol=1e-12)


def test_training_config_fields_are_jax_fields(jx):
    """Every field the port's config has is the JAX config's, with its
    default; fields no code of the port reads are not there to set."""
    from tpu_trainer.training.config import TrainingConfig

    jdef = {f.name: f.default for f in dataclasses.fields(TrainingConfig)}
    tdef = {f.name: f.default for f in dataclasses.fields(TTrain)}
    assert tdef == {n: jdef[n] for n in tdef}
    with pytest.raises(TypeError):
        TTrain(carry_cast_params=False)


def test_dummy_loader_batches_match_jax(jx):
    from tpu_trainer.data.dummy import DummyDataLoader as JLoader

    for a, b in zip(JLoader(4, 16, 128, 3, process_index=1, process_count=2),
                    DummyDataLoader(4, 16, 128, 3, process_index=1,
                                    process_count=2)):
        np.testing.assert_array_equal(a, b)


def test_flops_per_token_matches_jax(jx):
    from tpu_trainer.utils.logging import flops_per_token as jflops

    for kw in (dict(BASE), dict(BASE, num_heads=4, num_kv_heads=2), {}):
        assert flops_per_token(TConfig(**kw), 512) == jflops(
            jx.GPTConfig(**kw), 512)


def test_fp16_overflow_skips_update_and_halves_scale():
    tkw = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=1,
               mixed_precision="fp16", learning_rate=1e-2, warmup_steps=2,
               max_steps=10)
    tr = TTrainer(TConfig(**BASE), TTrain(**tkw), device="cpu")
    state = tr.init_state(0)
    batches = list(DummyDataLoader(2, 16, 128, 3))
    state, m0 = tr.train_step(state, batches[0])
    assert m0["loss_scale"] == 2.0**15 and np.isfinite(m0["grad_norm"])
    before = {n: p.detach().clone() for n, p in state.params.items()}
    mu = {n: t.clone() for n, t in state.opt_state.mu.items()}
    count = state.opt_state.count
    state.loss_scale = 3e38            # loss * scale overflows f32
    state, m1 = tr.train_step(state, batches[1])
    assert not np.isfinite(m1["grad_norm"])
    assert m1["loss_scale"] == 3e38 and state.loss_scale == 1.5e38
    assert state.step == 2 and state.good_steps == 0
    assert state.opt_state.count == count
    for n, p in state.params.items():
        assert torch.equal(p.detach(), before[n]), n
        assert torch.equal(state.opt_state.mu[n], mu[n]), n
    # The schedule advanced through the skipped step.
    state.loss_scale = 1024.0
    state, m2 = tr.train_step(state, batches[2])
    assert m2["lr"] == tr.training_config.lr_at(2)
    assert np.isfinite(m2["grad_norm"]) and state.opt_state.count == count + 1


def test_put_batch_and_packing():
    tr = TTrainer(TConfig(**BASE), TTrain(batch_size=2, max_seq_len=16,
                                          gradient_accumulation_steps=2),
                  device="cpu")
    batch = next(iter(DummyDataLoader(4, 16, 128, 1)))
    placed = tr.put_batch(batch)
    assert placed.shape == (2, 2, 16) and placed.dtype == torch.int64
    np.testing.assert_array_equal(placed.reshape(4, 16).numpy(), batch)
    packed = np.stack([batch, np.ones_like(batch)], axis=-1)
    tok, seg = _split_packed(tr.put_batch(packed)[0])
    assert tok.shape == seg.shape == (2, 16)
    with pytest.raises(ValueError, match="outside"):
        tr.put_batch(batch + 128)
    with pytest.raises(ValueError, match="divisible"):
        tr.put_batch(batch[:3])


@pytest.mark.parametrize("flash,fast", [(True, True), (False, False)])
def test_dropout_draws_from_the_state_generator(flash, fast):
    """Same seed, same losses; another seed, other masks: the hash masks
    (flash attention + fast_dropout) and the Bernoulli ones (reference
    attention, fast_dropout off) alike."""
    kw = dict(BASE, dropout=0.1, attention_dropout=0.1,
              use_flash_attention=flash, fast_dropout=fast)
    tkw = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=1,
               mixed_precision="fp32", warmup_steps=1)
    batch = next(iter(DummyDataLoader(2, 16, 128, 1)))
    losses = []
    for seed in (0, 0, 1):
        tr = TTrainer(TConfig(**kw), TTrain(**tkw, seed=seed), device="cpu")
        params = TTrainer(TConfig(**kw), TTrain(**tkw),
                          device="cpu").init_state(0).params
        state = tr.init_state(seed, params=params)
        losses.append(tr.train_step(state, batch)[1]["loss"])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    model = TGPT(TConfig(**kw), device="meta")
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros((1, 4), dtype=torch.long), train=True)


def test_packed_batch_step_uses_segment_ids():
    """A packed [rows, seq, 2] batch trains with its segment ids: the
    step's loss is the model's segmented loss on the same weights."""
    tkw = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=1,
               mixed_precision="fp32", warmup_steps=1)
    tr = TTrainer(TConfig(**BASE), TTrain(**tkw), device="cpu")
    state = tr.init_state(0)
    tokens = next(iter(DummyDataLoader(2, 16, 128, 1)))
    seg = np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 0]]), 4, axis=1)
    packed = np.stack([tokens, seg.astype(tokens.dtype)], axis=-1)
    t, s_ = torch.from_numpy(tokens).long(), torch.from_numpy(seg).long()
    with torch.no_grad():
        want = tr.model(t, t, segment_ids=s_)[1].item()
        plain = tr.model(t, t)[1].item()
    _, m = tr.train_step(state, packed)
    assert m["loss"] == pytest.approx(want, rel=1e-6)
    assert m["loss"] != pytest.approx(plain, rel=1e-3)


@pytest.mark.parametrize("kw,err", [
    ({"optimizer_state_dtype": "int16"}, ValueError),
    ({"cpu_offload": True, "optimizer_state_dtype": "int8"}, ValueError),
])
def test_unported_options_raise(kw, err):
    """Options the trainer refuses: an unknown moment storage, host
    offload over narrow moments (remat and narrow moments themselves
    train: tests/test_torch_remat.py, test_torch_optimizer_q.py)."""
    from tpu_trainer_torch.training.trainer import ParallelConfig

    train = {k: v for k, v in kw.items() if k == "optimizer_state_dtype"}
    par = {k: v for k, v in kw.items() if k == "cpu_offload"}
    with pytest.raises(err):
        TTrainer(TConfig(**BASE), TTrain(**train), ParallelConfig(**par),
                 device="cpu")


def test_capacity_moe_trains():
    """The capacity router (the default ``moe_impl``): a Trainer builds
    and takes a step (its parity: tests/test_torch_moe_capacity.py)."""
    tr = TTrainer(TConfig(**{**BASE, "num_experts": 2}),
                  TTrain(batch_size=2, max_seq_len=16,
                         gradient_accumulation_steps=1,
                         mixed_precision="fp32", warmup_steps=1),
                  device="cpu")
    assert tr.model_config.moe_impl == "capacity"
    state = tr.init_state(0)
    state, m = tr.train_step(state, next(iter(DummyDataLoader(2, 16, 128,
                                                              1))))
    assert np.isfinite(m["loss"]) and state.step == 1


def test_dropless_moe_trains():
    """The dropless router: a Trainer builds, holds the stacked MoE leaves
    and takes steps on the CPU."""
    kw = {**BASE, "num_experts": 2, "moe_impl": "dropless", "moe_top_k": 1}
    tr = TTrainer(TConfig(**kw), TTrain(batch_size=2, max_seq_len=16,
                                        gradient_accumulation_steps=1,
                                        mixed_precision="fp32",
                                        warmup_steps=1), device="cpu")
    state = tr.init_state(0)
    assert state.params["layers.moe_mlp.experts_up"].shape == (2, 2, 32, 128)
    losses = [tr.train_step(state, b)[1]["loss"]
              for b in DummyDataLoader(2, 16, 128, 2)]
    assert all(np.isfinite(losses)) and state.step == 2


def test_unported_optimizer_state_dtype_raises():
    """Only an unknown moment storage raises now, with the JAX message
    naming the three choices (bf16 and int8 build)."""
    with pytest.raises(ValueError, match="float32, bfloat16, or int8"):
        make_optimizer(TTrain(optimizer_state_dtype="float16"))
    assert make_optimizer(TTrain(optimizer_state_dtype="bfloat16")
                          ).state_dtype == "bfloat16"


def test_guards_and_rates():
    check_finite(3, 1.25)
    with pytest.raises(FloatingPointError, match="step 4"):
        check_finite(4, float("nan"))
    assert peak_flops_for_name("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops_for_name("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(ValueError):
        peak_flops_for_name("cpu")
    cfg = TConfig.gpt2_small()
    tok_s = 1e5
    assert mfu(tok_s, cfg, peak_flops=989e12, seq_len=1024) == pytest.approx(
        tok_s * flops_per_token(cfg, 1024) / 989e12)


def test_to_jax_params_round_trip(jx, tmp_path):
    cfg = TConfig(**BASE)
    params, path = _jax_params(jx, jx.GPTConfig(**BASE), tmp_path)
    state = from_jax_params(load_params_npz(path), cfg, device="cpu")
    back = _flat(to_jax_params(state))
    want = _flat(jx.jax.tree.map(np.asarray, params))
    assert set(back) == set(want)
    for n in want:
        np.testing.assert_array_equal(back[n], want[n])
    again = from_jax_params(to_jax_params(state), cfg, device="cpu")
    assert all(torch.equal(again[n], state[n]) for n in state)


def test_engine_params_stay_frozen(tmp_path):
    """Parameters are trainable by default; the serving engine freezes
    its copy and runs under inference mode."""
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving.engine import ServingEngine

    model = TGPT(TConfig(**BASE), device="meta")
    assert all(p.requires_grad for p in model.parameters())
    eng = ServingEngine(init_params(TConfig(**BASE), device="cpu"),
                        TConfig(**BASE), max_batch=2, block_size=4,
                        num_blocks=9, device="cpu")
    assert not any(p.requires_grad for p in eng.model.parameters())


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_bf16_training_step_goes_through_the_kernels(cuda_device):
    from tpu_trainer_torch.ops import flash, head_ce

    cfg = TConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
                  max_seq_len=1024, use_flash_attention=True)
    tkw = dict(batch_size=2, max_seq_len=1024, gradient_accumulation_steps=1,
               mixed_precision="bf16", warmup_steps=1)
    tr = TTrainer(cfg, TTrain(**tkw), device=cuda_device)
    state = tr.init_state(0)
    counts = (flash.flash_forward.launches, flash.flash_backward.launches,
              head_ce.head_ce_forward.launches)
    for batch in DummyDataLoader(2, 1024, 512, 2):
        state, m = tr.train_step(state, batch)
        assert np.isfinite(m["loss"])
    assert (flash.flash_forward.launches - counts[0],
            flash.flash_backward.launches - counts[1],
            head_ce.head_ce_forward.launches - counts[2]) == (4, 4, 2)
    assert dataclasses.asdict(cfg)["use_flash_attention"]
