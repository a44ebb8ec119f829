"""The port's tensor parallelism (Megatron) and hybrid meshes on the CPU.

Held against the JAX package:
- placement: ``parallel.sharding.leaf_specs`` against the JAX
  ``params_specs`` / ``grads_specs`` for every leaf at tensor 2 and 4 and
  at tensor 2 x fsdp 2, under zero3, zero2 and replicated (the dense and
  the MoE tables);
- ``ops.loss._tp_loss``, loss and gradients, against the JAX ``_tp_loss``
  on a tensor mesh of the conftest's CPU devices, at ts 2 and 4 (V = 521
  does not divide: the padded last slice), f32 within 1e-5;
- the tensor-2 ``Trainer``'s losses against the JAX ``Trainer`` on a
  2-device ``data 1 x tensor 2`` mesh from the same parameters, within
  1e-5 (one JAX trainer compile in this file).

Held against the port's own world 1 (one process, one thread, the same
global batch), composed axes included: tensor 2; tensor 2 x fsdp 2
(FULL_SHARD); tensor 2 x sequence 2. Losses within 1e-5, the final
parameters within rtol 1e-4 / atol 1e-5 (``test_torch_distributed.py``'s
equal-global-batch bounds: the ranks' sums run in another order). Also:
the residual dropout masks under tensor (bitwise the one-process mask on
every tensor rank) and the attention seeds (distinct across head shards);
a tensor 2 x fsdp 2 checkpoint restored at world 1 with bitwise masters
and a consolidated export of the world-1 layout; ``train_ddp
--mesh_tensor 2`` resuming bitwise; ``infer --mesh_tensor 2`` greedy
tokens equal to one process's; and the refusals (indivisible heads,
segments under sequence, an indivisible sequence; ``fused_projections``
turned off, and MoE and int8 moments under tensor built).

Ranks run in two gloo spawns of ``tests/torch_dist_worker.py`` (world 2
and world 4), every job of a world in one spawn.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.models.weights import from_jax_params, load_params_npz
from tpu_trainer_torch.ops.dropout import hash_keep
from tpu_trainer_torch.ops.flash import keep_mask_full
from tpu_trainer_torch.ops.loss import _chunk_len, _chunked_ce
from tpu_trainer_torch.parallel.sharding import leaf_specs
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=16, dropout=0.0, attention_dropout=0.0,
             use_flash_attention=True, dtype="float32",
             param_dtype="float32")
TRAIN = dict(batch_size=4, max_seq_len=16, gradient_accumulation_steps=1,
             max_steps=100, warmup_steps=2, learning_rate=3e-3,
             mixed_precision="fp32", seed=0)
STEPS = 3


# -- placement ---------------------------------------------------------------

def _jax_specs(cfg_kw, sizes, strategy):
    import jax
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.comms_model import abstract_params
    from tpu_trainer.parallel.sharding import (grads_specs_from_sizes,
                                               params_specs_from_sizes)

    tree = abstract_params(JConfig(**cfg_kw))

    def flat(specs):
        return {"/".join(str(getattr(k, "key", k)) for k in path):
                tuple(spec)
                for path, spec in jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda x: x is None
                    or type(x).__name__ == "PartitionSpec")[0]}
    return (flat(params_specs_from_sizes(tree, sizes, strategy)),
            flat(grads_specs_from_sizes(tree, sizes, strategy)))


_PLACE_MODEL = dict(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=64)


@pytest.mark.parametrize("strategy", ["zero3", "zero2", "replicated"])
@pytest.mark.parametrize("fsdp,tensor,moe", [(1, 2, False), (1, 4, False),
                                             (2, 2, False), (2, 2, True)])
def test_placement_matches_jax(strategy, fsdp, tensor, moe):
    kw = dict(_PLACE_MODEL, **({"num_experts": 4} if moe else {}))
    want_p, want_g = _jax_specs(kw, {"data": 1, "fsdp": fsdp,
                                     "tensor": tensor}, strategy)
    model = GPT(GPTConfig(**kw), device="meta")
    specs = leaf_specs({n: tuple(p.shape)
                        for n, p in model.named_parameters()},
                       strategy, fsdp, tensor)
    assert {n.replace(".", "/") for n in specs} == set(want_p)
    for name, spec in specs.items():
        key = name.replace(".", "/")
        assert spec.partition(spec.param_dim) == want_p[key], key
        assert spec.partition(spec.state_dim) == want_g[key], key
    # Megatron: column-parallel q/gate, row-parallel o/down, the hidden
    # of the embedding; norms replicated.
    assert specs["layers.attention.q_proj.kernel"].tensor_dim == 2
    assert specs["layers.attention.o_proj.kernel"].tensor_dim == 1
    assert specs["embed_tokens.embedding"].tensor_dim == 1
    assert specs["norm.weight"].tensor_dim is None


# -- the vocab-sharded loss ----------------------------------------------------

def _loss_case(seed=29, b=2, s=64, h=64, v=521):
    rng = np.random.default_rng(seed)
    return dict(emb=(0.3 * rng.standard_normal((v, h))).astype(np.float32),
                x=rng.standard_normal((b, s, h)).astype(np.float32),
                labels=rng.integers(0, v, (b, s)).astype(np.int32),
                mask=(rng.random((b, s)) > 0.2).astype(np.float32))


def _jax_tp_loss(case, ts):
    import jax
    from tpu_trainer.ops.loss import _tp_loss
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(data=1, tensor=ts), devices=jax.devices()[:ts])
    f = jax.jit(jax.value_and_grad(
        lambda e, x: _tp_loss(e, x, case["labels"], case["mask"], mesh, 0),
        argnums=(0, 1)))
    loss, (de, dx) = f(case["emb"], case["x"])
    return float(loss), np.asarray(de), np.asarray(dx)


# -- the spawns -----------------------------------------------------------------

def _job(name, strategy, mesh, model=MODEL, steps=STEPS, batch_size=4,
         **extra):
    """A train job at the world-1 runs' global batch of 4 rows (each data
    shard ``batch_size`` of them)."""
    return {"name": name, "kind": "train", "strategy": strategy,
            "mesh": mesh, "model": model,
            "train": {**TRAIN, "batch_size": batch_size},
            "steps": steps, **extra}


TINY_YAML = """
model:
  vocab_size: 256
  hidden_size: 64
  num_layers: 2
  num_heads: 4
  max_seq_len: 16
  dropout: 0.1
  attention_dropout: 0.1
  use_flash_attention: true
training:
  batch_size: 2
  gradient_accumulation_steps: 1
  learning_rate: 3e-3
  warmup_steps: 1
distributed:
  mixed_precision: "fp32"
data:
  dataset: "dummy"
"""


def _cli_argv(tmp, tag, *extra):
    return ["--device", "cpu", "--config", str(tmp / "tiny.yaml"),
            "--max_steps", "4", "--save_interval", "2", "--keep_last_n", "0",
            "--log_interval", "1", "--eval_interval", "0",
            "--checkpoint_dir", str(tmp / tag),
            "--metrics_jsonl", str(tmp / f"{tag}.jsonl"), *extra]


def _infer_argv(tmp, *extra):
    return ["--checkpoint", str(tmp / "cli" / "step_00000004"), "--device",
            "cpu", "--prompt_file", str(tmp / "prompts.txt"),
            "--tokenizer", "byte", "--max_new_tokens", "5",
            "--temperature", "0", *extra]


_ERR_TRAIN = dict(TRAIN)
_ERRORS = {
    "heads": {"model": {**MODEL, "hidden_size": 48, "num_heads": 3},
              "mesh": {"data": 1, "tensor": 2}},
    "kv_heads": {"model": {**MODEL, "num_kv_heads": 1},
                 "mesh": {"data": 1, "tensor": 2}},
    "fused": {"model": {**MODEL, "fused_projections": True},
              "mesh": {"data": 1, "tensor": 2}},
    "moe": {"model": {**MODEL, "num_experts": 4},
            "mesh": {"data": 1, "tensor": 2}},
    "int8": {"model": MODEL, "mesh": {"data": 1, "tensor": 2},
             "train": {**TRAIN, "optimizer_state_dtype": "int8"}},
    "segments": {"model": MODEL, "mesh": {"data": 1, "sequence": 2},
                 "forward": True},
    "seq_len": {"model": MODEL, "mesh": {"data": 1, "sequence": 2},
                "train": {**TRAIN, "max_seq_len": 15}},
}


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """The JAX ``Trainer`` on a ``data 1 x tensor 2`` mesh of two CPU
    devices: its initial parameters (an npz every tensor-2 run starts
    from) and its losses over ``STEPS`` dummy batches."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer

    mesh_cfg = MeshConfig(data=1, tensor=2)
    jtr = JTrainer(JConfig(**MODEL), JTrain(**TRAIN), JPar(mesh_cfg),
                   mesh=make_mesh(mesh_cfg, devices=jax.devices()[:2]))
    jstate = jtr.init_state(0)
    path = str(tmp_path_factory.mktemp("tp_params") / "params.npz")
    save_params_npz(path, jax.tree.map(np.asarray, jstate.params))
    losses = []
    for batch in DummyDataLoader(jtr.global_batch_size, 16, 256,
                                 num_batches=STEPS, seed=11):
        jstate, m = jtr.train_step(jstate, batch)
        losses.append(float(m["loss"]))
    return path, losses


@pytest.fixture(scope="module")
def params_npz(jax_tp):
    return jax_tp[0]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, params_npz):
    tmp = tmp_path_factory.mktemp("tp_world2")
    np.savez(tmp / "loss.npz", **_loss_case())
    (tmp / "tiny.yaml").write_text(TINY_YAML)
    (tmp / "prompts.txt").write_text("hey you\nab\n")
    argv = _cli_argv(tmp, "cli", "--mesh_tensor", "2")
    jobs = [
        {"name": "loss", "kind": "tp_loss", "inputs": str(tmp / "loss.npz")},
        _job("tp2", "replicated", {"data": 1, "tensor": 2},
             params_npz=params_npz),
        # The per-leaf knobs on a tensor shard: remat ("dots"), bf16
        # moments, f32 host offload.
        _job("tp2_remat", "replicated", {"data": 1, "tensor": 2},
             model={**MODEL, "gradient_checkpointing": True,
                    "remat_policy": "dots"}),
        {**_job("tp2_bf16", "replicated", {"data": 1, "tensor": 2}),
         "train": {**TRAIN, "optimizer_state_dtype": "bfloat16"}},
        {**_job("tp2_offload", "replicated", {"data": 1, "tensor": 2}),
         "parallel": {"cpu_offload": True}},
        {"name": "drop", "kind": "mesh_dropout", "strategy": "replicated",
         "mesh": {"data": 1, "tensor": 2},
         "model": {**MODEL, "dropout": 0.1, "attention_dropout": 0.1},
         "train": TRAIN, "rows": 2, "seed": 5},
        {"name": "errors", "kind": "errors",
         "cases": {n: {"strategy": "replicated", "train": TRAIN, **c}
                   for n, c in _ERRORS.items()}},
        {"name": "cli", "kind": "cli",
         "runs": [{"argv": argv},
                  {"argv": argv,
                   "remove": str(tmp / "cli" / "step_00000004")}],
         "infer": [_infer_argv(tmp, "--mesh_tensor", "2")]},
    ]
    out = run_world(tmp, 2, jobs)
    out["tmp"] = tmp
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world4")
    np.savez(tmp / "loss.npz", **_loss_case())
    jobs = [
        {"name": "loss", "kind": "tp_loss", "inputs": str(tmp / "loss.npz")},
        _job("tp2_fsdp2", "FULL_SHARD", {"data": 1, "fsdp": 2, "tensor": 2},
             batch_size=2, save_at=[STEPS], save_dir=str(tmp / "ck")),
        _job("tp2_sp2", "replicated", {"data": 1, "sequence": 2,
                                       "tensor": 2}),
    ]
    out = run_world(tmp, 4, jobs)
    out["tmp"] = tmp
    return out


def _world1(steps=STEPS, params=None, **train):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**{**TRAIN, **train}),
                     device="cpu")
        state = tr.init_state(params=params)
        losses = []
        for batch in DummyDataLoader(tr.global_batch_size, 16,
                                     MODEL["vocab_size"], num_batches=steps,
                                     seed=11):
            state, m = tr.train_step(state, batch)
            losses.append(m["loss"])
        return np.array(losses), state.state_dict()
    finally:
        torch.set_num_threads(threads)


def _check_world1(out, ref):
    losses, sd = ref
    for rank in out:
        np.testing.assert_allclose(rank["losses"], losses, **TOL)
    got = assemble([r["records"] for r in out])
    for key, want in sd.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    return got


@pytest.mark.parametrize("ts", [2, 4])
def test_tp_loss_matches_jax(world2, world4, ts):
    case = _loss_case()
    ranks = (world2 if ts == 2 else world4)["loss"]
    jloss, jde, jdx = _jax_tp_loss(case, ts)
    de = np.concatenate([r["de"] for r in ranks], axis=1)
    b, s, _ = case["x"].shape
    emb = torch.from_numpy(case["emb"]).requires_grad_(True)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    oracle = _chunked_ce(emb, x, torch.from_numpy(case["labels"]),
                         torch.from_numpy(case["mask"]), _chunk_len(b, s, 0))
    ode, odx = torch.autograd.grad(oracle, (emb, x))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jloss, **TOL)
        np.testing.assert_allclose(r["loss"], oracle.item(), **TOL)
        np.testing.assert_allclose(r["dx"], jdx, **TOL)
        np.testing.assert_allclose(r["dx"], odx.numpy(), **TOL)
        # One all-to-all forward and one backward; the x gradient summed
        # once; only statistics otherwise.
        assert r["calls"]["tp_alltoall"] == 2
    np.testing.assert_allclose(de, jde, **TOL)
    np.testing.assert_allclose(de, ode.numpy(), **TOL)


def test_tensor2_matches_world1_and_jax(world2, jax_tp):
    path, jlosses = jax_tp
    params = from_jax_params(load_params_npz(path), GPTConfig(**MODEL),
                             device="cpu")
    got = _check_world1(world2["tp2"], _world1(params=params))
    for rank in world2["tp2"]:
        np.testing.assert_allclose(rank["losses"], jlosses, **TOL)
    # At rest a rank holds half of each sharded leaf.
    a, b = world2["tp2"]
    q = "params/layers/attention/q_proj/kernel"
    assert a["final"][q].shape[-1] * 2 == got[q].shape[-1]
    assert not np.array_equal(a["final"][q], b["final"][q])
    norm = "params/norm/weight"
    np.testing.assert_array_equal(a["final"][norm], b["final"][norm])
    assert a["collectives"]["tp_allreduce"] > 0


@pytest.mark.parametrize("name", ["tp2_fsdp2", "tp2_sp2"])
def test_composed_meshes_match_world1(world4, name):
    _check_world1(world4[name], _world1())
    if name == "tp2_sp2":
        assert world4[name][0]["collectives"]["ring_permute"] > 0


@pytest.mark.parametrize("name,train", [
    ("tp2_remat", {}), ("tp2_offload", {}),
    ("tp2_bf16", {"optimizer_state_dtype": "bfloat16"}),
])
def test_per_leaf_knobs_take_a_tensor_shard(world2, name, train):
    """Remat, host offload and bf16 moments on a tensor rank's slices:
    the one-process run with the same knob (remat and f32 offload do not
    change the step)."""
    _check_world1(world2[name], _world1(**train))


def test_tp_fsdp_checkpoint_restores_at_world1(world4, tmp_path):
    step_dir = ckpt.latest_checkpoint(str(world4["tmp"] / "ck"))
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    state, meta = ckpt.restore_checkpoint(step_dir, tr)
    want = assemble([r["records"] for r in world4["tp2_fsdp2"]])
    sd = state.state_dict()
    assert set(sd) - {"step", "opt_count", "loss_scale", "good_steps"} \
        == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key], arr, err_msg=key)
    params, _ = ckpt.restore_params(step_dir)
    out = ckpt.export_consolidated(str(tmp_path), params)
    one = _world1(steps=1)[1]
    with np.load(out) as z:
        layout = {k: z[k].shape for k in z.files}
    assert layout == {k[len("params/"):]: v.shape for k, v in one.items()
                      if k.startswith("params/")}


def test_tensor_residual_dropout_and_attention_seeds(world2):
    from tpu_trainer_torch.models.gpt import _TrainStep

    gen = torch.Generator().manual_seed(5)
    step = _TrainStep(train=True, generator=gen, rope=None, segment_ids=None)
    want = hash_keep((2, 16, MODEL["hidden_size"]), 0.1, step.seed())
    ranks = world2["drop"]
    for r in ranks:
        np.testing.assert_array_equal(r["residual_keep"], want.numpy())
    # The attention seed folds the tensor rank: the head shards' masks
    # differ, and every draw of a rank differs too.
    s0, s1 = (r["attention_seeds"] for r in ranks)
    assert len({*s0, *s1}) == 4
    m0 = keep_mask_full(s0[0], 1, 2, 16, 0.1)
    m1 = keep_mask_full(s1[0], 1, 2, 16, 0.1)
    assert not torch.equal(m0, m1)


@pytest.mark.parametrize("case,exc,match", [
    ("heads", "ValueError", "num_heads 3 not divisible by tensor axis"),
    ("kv_heads", "ValueError", "num_kv_heads 1 not divisible"),
    ("fused", "ok", False),
    # MoE and int8 moments under tensor run now (fused_projections off);
    # the case ids are kept from when they refused.
    pytest.param("moe", "ok", False,
                 id="moe-NotImplementedError-pipeline and expert "
                    "parallelism"),
    pytest.param("int8", "ok", False,
                 id="int8-NotImplementedError-int8 moments on a tensor "
                    "shard"),
    ("segments", "NotImplementedError", "sequence parallelism"),
    ("seq_len", "ValueError", "max_seq_len 15 not divisible by sequence"),
])
def test_refusals(world2, case, exc, match):
    for rank in world2["errors"]:
        kind, msg = rank[case]
        assert kind == exc
        if isinstance(match, str):
            assert match in msg, msg
        else:
            assert msg == match   # fused_projections turned off


def test_cli_tensor2_resume_is_bitwise(world2):
    tmp = world2["tmp"]
    recs = [r for r in map(json.loads, open(tmp / "cli.jsonl"))
            if r.get("kind") == "train"]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 2, 3]
    assert [r["loss"] for r in recs[2:4]] == [r["loss"] for r in recs[4:]]


def test_infer_tensor2_equals_one_process(world2):
    from tpu_trainer_torch.eval import infer

    tmp = world2["tmp"]
    one = {}
    assert infer.main(_infer_argv(tmp), result=one) == 0
    for rank in world2["cli"]:
        assert rank["infer"][0] == one["tokens"]
