"""Port parity: the capacity MoE router (``moe_impl="capacity"``, the JAX
default) in training, generation and the paged engine.

The same numpy-seeded inputs and weights go through the JAX ``MoEMLP`` /
``GPT`` / ``Trainer`` / ``ServingEngine`` and the port's counterparts;
tiny geometry, f32, dropout off.

- Queue positions and keep masks **bitwise** against the JAX package's ops
  (``tpu_trainer/models/moe.py:239-257``: the capacity rule, the
  choice-major exclusive cumsum over the one-hot, ``pos < C``) on the same
  router logits: top-1 and top-2, capacity factor 1e-9 (``C = 1``: drops
  forced) and 1.25, the ``T <= 2E`` decode regime and tied probabilities.
- ``capacity_moe`` against ``MoEMLP`` (gather and einsum dispatch, top-1
  and top-2): output and aux within atol=rtol=1e-5, gradients of every
  weight and of the input within 1e-4 of ``jax.vjp`` (the port's gather
  backwards are its own autograd functions, the JAX custom VJPs' gathers).
- A capacity ``GPT``'s loss and gradients against ``jax.grad`` (the
  tolerances of ``test_torch_moe.py``; gather, einsum, and packed rows
  with segment ids), remat (full and dots) bitwise the plain step, the
  weights' round trip through
  ``from_jax_params`` / ``to_jax_params`` bitwise; a 3-step ``Trainer``
  trajectory at accumulation 2 against the JAX ``Trainer`` (loss, grad
  norm, lr rtol 1e-4; final parameters atol 1e-4); the telemetry router
  record against the JAX ``router`` record.
- Generation: ``generate_kv`` greedy tokens equal the JAX ``generate_kv``
  (a prefill of ``b x width > 2E`` rows, so capacity drops apply, then
  full-capacity decode steps). The paged engine on a MoE model, both
  routers: greedy streams equal the JAX engine's on prompts whose prefill
  chunks route far more than ``2E`` rows (idle slots' zero ids included).
- The CLI and ``infer.py`` on a MoE checkpoint the port's CLI trained.
"""

import math
import os
import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.models import moe as tmoe
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.gpt import generate_kv
from tpu_trainer_torch.models.weights import from_jax_params, to_jax_params

TOL = dict(atol=1e-5, rtol=1e-5)
GTOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2,
            num_experts=4, moe_top_k=2, moe_impl="capacity",
            expert_capacity_factor=1.0, router_z_weight=1e-3,
            use_flash_attention=True)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models import moe
    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.models.gpt import GPT
    from tpu_trainer.utils import telemetry
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=moe, tel=telemetry,
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


def _jax_positions(jx, gate_idx, E, k, cf):
    """The JAX capacity rule and queue positions, op for op
    (``tpu_trainer/models/moe.py:239-257``)."""
    jax, jnp = jx.jax, jx.jnp
    T = gate_idx.shape[0]
    C = T if T <= 2 * E else max(1, math.ceil(k * T / E * cf))
    assign_k = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    assign_flat = assign_k.transpose(1, 0, 2).reshape(k * T, E)
    pos_flat = jnp.cumsum(assign_flat, axis=0) - assign_flat
    pos_k = pos_flat.reshape(k, T, E).transpose(1, 0, 2)
    keep_k = (pos_k < C).astype(jnp.float32) * assign_k
    pos_idx = jnp.sum(pos_k * assign_k, axis=-1).astype(jnp.int32)
    kept = jnp.sum(keep_k, axis=-1) > 0
    return C, np.asarray(pos_idx), np.asarray(kept)


@pytest.mark.parametrize("k,cf,T,ties", [
    (1, 1e-9, 48, False), (2, 1e-9, 48, False), (1, 1.25, 48, False),
    (2, 1.25, 48, False), (2, 1.25, 8, False), (2, 1.0, 48, True),
    (1, 1.25, 5000, False)])
def test_positions_and_keep_bitwise(jx, k, cf, T, ties):
    jax, jnp = jx.jax, jx.jnp
    E, H = 4, 16
    rs = np.random.RandomState(T + k)
    xt = rs.standard_normal((T, H)).astype(np.float32)
    w = (rs.standard_normal((H, E)) * 0.3).astype(np.float32)
    if ties:
        xt[10:30] = xt[10]                  # identical tokens queue in order
        w[:, 3] = w[:, 2]                   # two experts tie everywhere
    cfg = TConfig(**{**BASE, "num_experts": E, "moe_top_k": k,
                     "expert_capacity_factor": cf})
    probs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(w), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    C, want_pos, want_keep = _jax_positions(jx, gate_idx, E, k, cf)

    _, tidx, _, counts = tmoe.route(torch.from_numpy(xt),
                                    torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(gate_idx))
    assert tmoe.capacity(cfg, T) == C
    pos, keep = tmoe.capacity_positions(tidx, counts, 0, C)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if T <= 2 * E:
        assert keep.all()
    elif cf < 1e-6:
        assert (~keep).any()


def _layer_params(jx, jcfg, x):
    module = jx.moe.MoEMLP(jcfg)
    return module, module.init(jx.jax.random.PRNGKey(0),
                               jx.jnp.asarray(x))["params"]


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("k,cf", [(1, 1.0), (2, 1.0), (2, 0.5)])
def test_capacity_layer_matches_jax_moe_mlp(jx, dispatch, k, cf):
    jax, jnp = jx.jax, jx.jnp
    kw = {**BASE, "moe_top_k": k, "moe_dispatch": dispatch,
          "expert_capacity_factor": cf}
    jcfg, tcfg = jx.GPTConfig(**kw), TConfig(**kw)
    x = np.random.RandomState(k).standard_normal((2, 16, 32)).astype(
        np.float32)
    module, params = _layer_params(jx, jcfg, x)

    def jfn(p, x_):
        return module.apply({"params": p}, x_, True)

    (want, want_aux), vjp = jax.vjp(jfn, params, jnp.asarray(x))
    dout = np.random.RandomState(7).standard_normal(x.shape).astype(
        np.float32)
    want_dp, want_dx = vjp((jnp.asarray(dout), jnp.asarray(1.0)))

    p = {n: torch.from_numpy(np.array(v)).requires_grad_(True)
         for n, v in _flat(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.capacity_moe(tx, p["router.kernel"], p["experts_gate"],
                                 p["experts_up"], p["experts_down"], tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), **TOL)
    torch.autograd.backward([out, aux], [torch.from_numpy(dout),
                                         torch.tensor(1.0)])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), **GTOL)
    for n, g in _flat(want_dp).items():
        np.testing.assert_allclose(p[n].grad.numpy(), g, err_msg=n, **GTOL)
    # Some token-choice was dropped: those rows are zero at k = 1.
    if k == 1:
        assert (np.abs(np.asarray(want)).reshape(32, 32).sum(-1) == 0).any()


def test_gather_backward_is_deterministic_and_dispatches_agree():
    """Two gather backwards on the same inputs are bitwise equal (a fixed
    order of every sum); gather and einsum agree, the output within 1e-5
    and the gradients within 1e-4 (sums of another order)."""
    cfg = TConfig(**BASE)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 32, generator=g)
    w = [torch.randn(32, 4, generator=g) * 0.3,
         torch.randn(4, 32, 128, generator=g) * 0.2,
         torch.randn(4, 32, 128, generator=g) * 0.2,
         torch.randn(4, 128, 32, generator=g) * 0.2]

    def grads(dispatch):
        xx = x.clone().requires_grad_(True)
        ws = [t.clone().requires_grad_(True) for t in w]
        out, aux = tmoe.capacity_moe(
            xx, *ws, TConfig(**{**BASE, "moe_dispatch": dispatch}))
        (out.square().sum() + aux).backward()
        return [out.detach(), xx.grad] + [t.grad for t in ws]

    a, b, e = grads("gather"), grads("gather"), grads("einsum")
    for i, (u, v, f) in enumerate(zip(a, b, e)):
        assert torch.equal(u, v)
        np.testing.assert_allclose(u.numpy(), f.numpy(),
                                   **(TOL if i == 0 else GTOL))
    assert tmoe.dispatch_mode(cfg) == "gather"      # "auto" is gather


def _jax_params(jx, jcfg):
    params = jx.GPT(jcfg).init(jx.jax.random.PRNGKey(0),
                               jx.jnp.zeros((1, 8), jx.jnp.int32))["params"]
    return params, jx.jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dispatch,segmented", [
    ("gather", False), ("einsum", False), ("gather", True)])
def test_capacity_gpt_loss_and_grads_match_jax(jx, dispatch, segmented):
    jax, jnp = jx.jax, jx.jnp
    kw = {**BASE, "moe_dispatch": dispatch}
    jcfg, tcfg = jx.GPTConfig(**kw), TConfig(**kw)
    params, tree = _jax_params(jx, jcfg)
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int32)
    seg = (np.repeat(np.array([[1, 1, 2, 2], [1, 2, 3, 0]]), 4, axis=1)
           .astype(np.int32) if segmented else None)

    def jloss(p):
        return jx.GPT(jcfg).apply(
            {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
            segment_ids=None if seg is None else jnp.asarray(seg))[1]

    want_loss, want_grads = jax.value_and_grad(jloss)(params)
    state = from_jax_params(tree, tcfg, device="cpu")
    back = _flat(to_jax_params(state))
    for n, v in _flat(tree).items():
        assert np.array_equal(back[n], v), n      # the leaves round-trip
    model = TGPT(tcfg, device="meta")
    model.load_state_dict({n: torch.nn.Parameter(t) for n, t in state.items()},
                          strict=True, assign=True)
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


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_capacity_remat_is_bitwise_the_plain_step(policy):
    """Under remat the block's rerun routes the same tokens to the same
    slots: loss and every gradient bitwise the plain step's (dropout on,
    the rerun restores the generator)."""
    from tpu_trainer_torch.models.weights import init_params

    kw = {**BASE, "dropout": 0.1, "attention_dropout": 0.1}
    ids = torch.from_numpy(np.random.RandomState(2).randint(0, 128, (2, 16)))
    out = []
    for remat in (False, True):
        cfg = TConfig(**kw, gradient_checkpointing=remat, remat_policy=policy)
        model = TGPT(cfg, device="meta")
        model.load_state_dict({n: torch.nn.Parameter(t) for n, t in
                               init_params(cfg, seed=0, device="cpu").items()},
                              assign=True)
        _, loss = model(ids, ids, train=True,
                        generator=torch.Generator().manual_seed(3))
        loss.backward()
        out.append([loss.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_capacity_trainer_trajectory_matches_jax(jx):
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.training.trainer import ParallelConfig, Trainer
    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.training.config import TrainingConfig as TTrain
    from tpu_trainer_torch.training.trainer import Trainer as TTrainer

    steps, accum = 3, 2
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
    for batch in DummyDataLoader(2 * accum, 16, 128, steps):
        jstate, jm = jtr.train_step(jstate, batch)
        tstate, tm = ttr.train_step(tstate, batch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[key], float(jm[key]), rtol=1e-4,
                                       atol=1e-7, err_msg=key)
    want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_jax_params(tstate.params))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_capacity_router_record_matches_jax(jx, cf):
    """The telemetry ``router`` record: first-choice load, entropy,
    drop_frac, max_group_frac and ``dropless`` = 0."""
    kw = {**BASE, "expert_capacity_factor": cf}
    x = np.random.default_rng(0).normal(size=(2, 16, 32)).astype(np.float32)
    module, params = _layer_params(jx, jx.GPTConfig(**kw), x)
    with jx.tel.capture() as cap:
        module.apply({"params": params}, jx.jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in cap.stats["router"].items()}
    p = {n: torch.from_numpy(v) for n, v in _flat(params).items()}
    got = {}
    tmoe.capacity_moe(torch.from_numpy(x), p["router.kernel"],
                      p["experts_gate"], p["experts_up"], p["experts_down"],
                      TConfig(**kw), router_stats=got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(got["dropless"]) == 0.0
    assert (float(got["drop_frac"]) > 0.0) == (cf < 1.0)


# -- generation and the paged engine ------------------------------------------

GEN = dict(BASE, vocab_size=300, max_seq_len=64, expert_capacity_factor=0.5)


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
def test_generate_kv_greedy_matches_jax(jx, impl):
    from tpu_trainer.models.gpt import generate_kv as jgenerate_kv

    kw = {**GEN, "moe_impl": impl}
    jcfg = jx.GPTConfig(**kw)
    params, tree = _jax_params(jx, jcfg)
    model = TGPT(TConfig(**kw), device="meta")
    model.load_state_dict(from_jax_params(tree, model.config, device="cpu"),
                          strict=True, assign=True)
    model.requires_grad_(False)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 300, (3, 9))).long()
    ids[1, 4:] = 0
    lens = np.array([9, 4, 6])
    want = jgenerate_kv(params, jx.jax.random.PRNGKey(0),
                        jx.jnp.asarray(ids.numpy(), jx.jnp.int32),
                        config=jcfg, max_new_tokens=12, temperature=0.0,
                        prompt_lens=jx.jnp.asarray(lens, jx.jnp.int32))
    got = generate_kv(model, ids, max_new_tokens=12, temperature=0.0,
                      prompt_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


ENGINE = dict(BASE, max_seq_len=64, initializer_range=0.5)


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
def test_moe_engine_streams_match_jax(jx, impl, tmp_path):
    """Greedy streams of the port's paged engine equal the JAX engine's on
    a MoE model: 8 requests of 4-24 prompt tokens through 4 slots, prefill
    chunks of 4 x 8..32 rows (idle slots' zero ids included, as both
    engines pad), so the capacity router drops at prefill."""
    from tpu_trainer.serving.engine import ServingEngine as JEngine
    from tpu_trainer.serving.engine import poisson_trace as j_trace
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer_torch.models.weights import load_params_npz
    from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
    from tpu_trainer_torch.serving.engine import poisson_trace as t_trace

    kw = {**ENGINE, "moe_impl": impl}
    jcfg = jx.GPTConfig(**kw)
    params, _ = _jax_params(jx, jcfg)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jx.jax.tree.map(np.asarray, params))
    sd = from_jax_params(load_params_npz(path), TConfig(**kw), device="cpu")
    trace = dict(vocab_size=128, rate=1.0, seed=3, prompt_len_range=(4, 24),
                 max_new_range=(4, 12), temperature=0.0)
    eng = dict(max_batch=4, block_size=4)
    jdone = JEngine(params, jcfg, **eng).run(j_trace(8, **trace),
                                             time_mode="steps")
    tengine = TEngine(sd, TConfig(**kw), device="cpu", **eng)
    tdone = tengine.run(t_trace(8, **trace), time_mode="steps")
    want = {r.rid: list(r.generated) for r in jdone}
    assert {r.rid: list(r.generated) for r in tdone} == want
    assert len(want) == 8 and tengine.stats["prefill_iters"] > 0


# -- the CLI and infer.py -----------------------------------------------------

MOE_YAML = """
model:
  name: "gpt2-small"
  vocab_size: 50257
  hidden_size: 16
  num_layers: 2
  num_heads: 2
  intermediate_size: 32
  max_seq_len: 64
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: true
  num_experts: 4
  moe_top_k: 2
  expert_capacity_factor: {cf}
  moe_impl: "{impl}"
training:
  batch_size: 2
  gradient_accumulation_steps: 1
  learning_rate: 1e-3
  max_steps: 2
  warmup_steps: 1
distributed:
  mixed_precision: "fp32"
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Checkpoints the port's CLI trained (2 steps each), by router:
    capacity at factor 0.5 (drops) and at 8.0 (none), and dropless."""
    from tests.test_torch_cli import _corpus
    from tpu_trainer_torch.training import cli

    tmp = tmp_path_factory.mktemp("moe_cli")
    corpus = _corpus(tmp / "c.txt")
    out = {}
    for name, impl, cf in (("capacity", "capacity", 0.5),
                           ("roomy", "capacity", 8.0),
                           ("dropless", "dropless", 1.25)):
        yaml = tmp / f"{name}.yaml"
        yaml.write_text(MOE_YAML.format(cf=cf, impl=impl))
        ck = tmp / f"ck_{name}"
        assert cli.run_training([
            "--device", "cpu", "--config", str(yaml), "--dataset",
            "tinystories", "--data_path", corpus, "--tokenizer", "byte",
            "--log_interval", "1", "--telemetry_interval", "1",
            "--metrics_jsonl", str(tmp / f"{name}.jsonl"),
            "--checkpoint_dir", str(ck)]) == 0
        out[name] = str(ck)
    return out


def _infer(args):
    from tpu_trainer_torch.eval import infer

    result = {}
    assert infer.main(["--device", "cpu", "--tokenizer", "byte",
                       "--temperature", "0", "--max_new_tokens", "6"] + args,
                      result=result) == 0
    return result


def test_cli_trains_moe_yaml_and_names_the_router(trained, capsys):
    from tpu_trainer_torch.utils import checkpoint as ckpt

    for name, want in (("capacity", "capacity router, gather dispatch, "
                                    "capacity factor 0.5"),
                       ("dropless", "dropless router")):
        path = ckpt.latest_checkpoint(trained[name])
        assert path.endswith("step_00000002")
        meta = ckpt.load_meta(path)
        assert meta["model_config"]["moe_impl"] == name
        from tpu_trainer_torch.models.config import GPTConfig

        assert want in tmoe.describe(GPTConfig(**{
            k: v for k, v in meta["model_config"].items()
            if k in GPTConfig.__dataclass_fields__}))


def test_router_telemetry_and_analyzer_gate_by_router(jx, trained, tmp_path,
                                                     capsys):
    """A capacity run's telemetry steps carry the router record under the
    JAX names, with drops at capacity factor 0.5 and ``dropless`` 0; the
    analyzer (the port's, as the JAX one) skips the drop gate for it, and
    fails a dropless run that reports a drop."""
    import json

    from tpu_trainer.tools import analyze as janalyze
    from tpu_trainer_torch.tools import analyze

    def recs(name):
        path = os.path.join(os.path.dirname(trained[name]), f"{name}.jsonl")
        with open(path) as f:
            return path, [r for r in map(json.loads, f)
                          if r.get("kind") == "train"]

    cap, rows = recs("capacity")
    for r in rows:
        for key in ("load", "entropy", "drop_frac", "max_group_frac",
                    "dropless"):
            assert any(n.startswith(f"telemetry/router/{key}/L01")
                       for n in r), key
        assert r["telemetry/router/dropless/L00"] == 0.0
    assert max(r["telemetry/router/drop_frac/L00"] for r in rows) > 0.0
    drop, rows = recs("dropless")
    assert all(r["telemetry/router/drop_frac/L00"] == 0.0 for r in rows)
    rows[-1]["telemetry/router/drop_frac/L00"] = 0.25   # a dropless bug
    bad = tmp_path / "bad.jsonl"
    with open(drop) as f, open(bad, "w") as g:
        for line in f:
            r = json.loads(line)
            g.write(json.dumps(rows[-1] if r.get("kind") == "train"
                               and r["step"] == rows[-1]["step"] else r)
                    + "\n")
    for new, rc_want, verdict in ((cap, 0, "SKIP moe_drop_frac"),
                                  (str(bad), 1, "FAIL moe_drop_frac")):
        argv = [new, "--compare", new]
        rc = analyze.main(argv)
        out = capsys.readouterr().out
        assert (rc, out) == (janalyze.main(argv), capsys.readouterr().out)
        assert rc == rc_want and verdict in out, out


@pytest.mark.parametrize("name", ["capacity", "roomy", "dropless"])
def test_infer_generates_from_cli_moe_checkpoint(trained, name, tmp_path,
                                                 capsys):
    """KV path and ``--serve`` both decode a MoE checkpoint; they route
    different batches (the engine's slots and chunks), so their tokens are
    equal where nothing drops (dropless, and a capacity factor of 8)."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("Once upon a time\nhi\nthe cat sat\n")
    args = ["--checkpoint", trained[name], "--prompt_file", str(prompts)]
    kv = _infer(args)
    again = _infer(args)
    served = _infer(args + ["--serve"])
    assert kv["tokens"] == again["tokens"]
    assert [len(r) for r in kv["tokens"]] == [16 + 6, 2 + 6, 11 + 6]
    if name != "capacity":
        assert served["tokens"] == kv["tokens"]
    assert served["stats"]["decode_iters"] == 5
    capsys.readouterr()


def test_infer_mesh_data_moe_routes_every_rank_together(trained, tmp_path,
                                                        capsys):
    """``--mesh_data 2`` on a capacity checkpoint that drops: the ranks
    route their rows together, so the tokens are the one-process run's."""
    import subprocess
    import sys

    prompts = tmp_path / "p.txt"
    prompts.write_text("Once upon a time\nhi\nthe cat sat\nab\n")
    args = ["--checkpoint", trained["capacity"], "--prompt_file",
            str(prompts), "--max_new_tokens", "5", "--temperature", "0"]
    one = _infer(args)
    capsys.readouterr()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "tpu_trainer_torch.eval.infer",
         "--device", "cpu", "--tokenizer", "byte", "--mesh_data", "2"]
        + args,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 COORDINATOR_TIMEOUT_S="120"),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    from tpu_trainer_torch.utils.tokenizer import get_tokenizer

    tok = get_tokenizer("byte")
    assert proc.stdout.splitlines() == [tok.decode(r) for r in one["tokens"]]
