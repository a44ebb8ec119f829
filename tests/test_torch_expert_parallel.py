"""The port's expert parallelism on the CPU: the ``expert`` mesh axis, MoE
under the ``tensor`` and ``sequence`` axes, and int8 moments and telemetry
steps on tensor and expert shards.

Held against the JAX package:
- placement: ``parallel.sharding.leaf_specs`` against the JAX
  ``params_specs_from_sizes`` / ``grads_specs_from_sizes`` for every leaf
  of a MoE model at expert 2 and 4, expert 2 x tensor 2 and expert 2 x
  fsdp 2, under zero3, zero2 and replicated; ``mesh_coords`` and
  ``host_feed_info`` against the JAX device layout at data 2 x expert 4;
- the layer: ``models.moe.moe_ffn`` at expert 2 (each rank its two
  experts) against the one-process layer and the JAX ``MoEMLP`` on the
  same numpy inputs, capacity (gather and einsum) and dropless, top-1
  and top-2, a capacity factor that drops tokens: routing, queue
  positions and keep masks bitwise, the output and the gradients within
  1e-5 of one process (the JAX layer: the output within 1e-5, the
  gradients within ``test_torch_moe_capacity.py``'s 1e-4);
- the ``data 2 x expert 2`` ``Trainer`` against the JAX ``Trainer`` on a
  ``MeshConfig(data=2, expert=2)`` of four CPU devices from the same
  parameters: losses within 1e-5 (one JAX trainer compile in this file).

Held against the port's own world 1 (one process, one thread, the same
global batch): data 1 x fsdp 2 x expert 2 under FULL_SHARD, expert 2 x
tensor 2, MoE under data 2 x tensor 2 and under data 2 x sequence 2 (the
capacity router dropping tokens, every layer call's queue positions and
keep mask bitwise one process's); losses within 1e-5, the final
parameters within rtol 1e-4 / atol 1e-5. int8 moments and a telemetry
step under tensor 2, expert 2 and expert 2 x tensor 2 (losses,
parameters, telemetry and router
stats as world 1's; the stitched int8 packs in one process's layout and
within a code step of its values), and a tensor slice's ``BlockCut`` pack
bitwise one process's. An expert-2 checkpoint restored at world 1 with
bitwise masters, its consolidated export read by the JAX
``load_params_npz``; ``train_ddp --mesh_expert 2`` resuming bitwise;
``infer --mesh_tensor 2`` on a MoE checkpoint giving one process's greedy
tokens; and the refusals (an expert axis on a dense model, in the
trainer and through ``train_ddp``, experts that the axis does not divide,
a stage axis that does not divide the layers); a planted fault (the MoE
layer's sum over the expert ranks dropped) fails the world-1 check.

Ranks run in two gloo spawns of ``tests/torch_dist_worker.py`` (world 2
and world 4), every job of a world in one spawn.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, record_moe, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models import moe as tmoe
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.models.weights import from_jax_params, load_params_npz
from tpu_trainer_torch.parallel import mesh as tmesh
from tpu_trainer_torch.parallel.sharding import leaf_specs
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt
from tpu_trainer_torch.utils import telemetry
from tpu_trainer_torch.utils.quant import quantize_blockwise_int8

TOL = dict(rtol=1e-5, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
MODEL = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
             intermediate_size=64, max_seq_len=16, dropout=0.0,
             attention_dropout=0.0, use_flash_attention=True,
             dtype="float32", param_dtype="float32", initializer_range=0.2,
             num_experts=4, moe_top_k=2, expert_capacity_factor=1.0,
             router_z_weight=1e-3)
# Capacity factor 0.5: every layer drops token-choices.
DROPS = {**MODEL, "expert_capacity_factor": 0.5}
# Leaves past int8's 65,536 elements: the embedding (its hidden dim the
# tensor slice, blocks of 32 that tensor 2's halves share) and the expert
# FFNs (their FFN dim the tensor slice, blocks of 256 likewise).
KNOBS = {**MODEL, "vocab_size": 2048, "intermediate_size": 256}
TRAIN = dict(batch_size=4, max_seq_len=16, gradient_accumulation_steps=1,
             max_steps=100, warmup_steps=2, learning_rate=3e-3,
             mixed_precision="fp32", seed=0)
STEPS = 3


# -- placement and the mesh layout ----------------------------------------------

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
                    num_heads=4, max_seq_len=64, num_experts=4)


@pytest.mark.parametrize("strategy", ["zero3", "zero2", "replicated"])
@pytest.mark.parametrize("fsdp,tensor,expert", [(1, 1, 2), (1, 1, 4),
                                                (1, 2, 2), (2, 1, 2)])
def test_placement_matches_jax(strategy, fsdp, tensor, expert):
    want_p, want_g = _jax_specs(_PLACE_MODEL, {
        "data": 1, "fsdp": fsdp, "tensor": tensor, "expert": expert},
        strategy)
    model = GPT(GPTConfig(**_PLACE_MODEL), device="meta")
    specs = leaf_specs({n: tuple(p.shape)
                        for n, p in model.named_parameters()},
                       strategy, fsdp, tensor, expert)
    assert {n.replace(".", "/") for n in specs} == set(want_p)
    for name, spec in specs.items():
        key = name.replace(".", "/")
        assert spec.partition(spec.param_dim) == want_p[key], key
        assert spec.partition(spec.state_dim) == want_g[key], key
    gate = specs["layers.moe_mlp.experts_gate"]
    assert gate.expert_dim == 1 and gate.tp_shape[1] == 4 // expert
    assert specs["layers.moe_mlp.router.kernel"].expert_dim is None


def test_mesh_layout_matches_jax():
    """Rank ``r`` sits where the JAX ``make_mesh`` puts device ``r`` at
    data 2 x expert 4, and loads the rows the JAX ``host_feed_info`` gives
    a host of that one device."""
    jax = pytest.importorskip("jax")
    from jax.sharding import NamedSharding
    from tpu_trainer.parallel import mesh as jmesh

    mesh_cfg = jmesh.MeshConfig(data=2, expert=4)
    mesh = jmesh.make_mesh(mesh_cfg, devices=jax.devices()[:8])
    sizes = mesh_cfg.resolve(8)
    for idx in np.ndindex(mesh.devices.shape):
        assert tmesh.mesh_coords(sizes, mesh.devices[idx].id) == idx
    sharding = NamedSharding(mesh, jmesh.batch_spec())
    for r in range(8):
        want = jmesh.host_feed_info(sharding, (1, 8, 16), 1,
                                    process_of_device=lambda d: d.id,
                                    process_index=r)
        assert tmesh.host_feed_info(sizes, 8, process_index=r) == want


# -- inputs ------------------------------------------------------------------------

_LAYER = dict(MODEL, intermediate_size=64)
LAYER_CASES = {
    "gather_k1": {**_LAYER, "moe_top_k": 1, "moe_dispatch": "gather"},
    "einsum_k2": {**_LAYER, "moe_dispatch": "einsum"},
    "gather_k2_drops": {**_LAYER, "moe_dispatch": "gather",
                        "expert_capacity_factor": 0.5},
    "auto_k1_drops": {**_LAYER, "moe_top_k": 1,
                      "expert_capacity_factor": 0.5},
    "dropless_k1": {**_LAYER, "moe_top_k": 1, "moe_impl": "dropless"},
    "dropless_k2": {**_LAYER, "moe_impl": "dropless"},
}


def _layer_inputs(seed=41, b=2, s=16, h=32, i=64, e=4):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return dict(x=f(b, s, h), router=f(h, e, scale=0.5),
                gate=f(e, h, i, scale=0.2), up=f(e, h, i, scale=0.2),
                down=f(e, i, h, scale=0.2), dout=f(b, s, h))


def _quant_leaf(seed=43):
    # Last dim 96: blocks of 32, so tensor 2's slices of 48 share one.
    rng = np.random.default_rng(seed)
    return {"leaf": rng.standard_normal((3, 96)).astype(np.float32)}


TINY_MOE_YAML = """
model:
  vocab_size: 256
  hidden_size: 64
  num_layers: 2
  num_heads: 4
  max_seq_len: 16
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: true
  num_experts: 4
  moe_top_k: 2
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
    return ["--device", "cpu", "--config", str(tmp / "moe.yaml"),
            "--max_steps", "4", "--save_interval", "2", "--keep_last_n", "0",
            "--log_interval", "1", "--eval_interval", "0",
            "--checkpoint_dir", str(tmp / tag),
            "--metrics_jsonl", str(tmp / f"{tag}.jsonl"), *extra]


def _infer_argv(tmp, *extra):
    return ["--checkpoint", str(tmp / "cli" / "step_00000004"), "--device",
            "cpu", "--prompt_file", str(tmp / "prompts.txt"),
            "--tokenizer", "byte", "--max_new_tokens", "5",
            "--temperature", "0", *extra]


def _job(name, strategy, mesh, model=MODEL, steps=STEPS, batch_size=4,
         **extra):
    """A train job at the world-1 runs' global batch of 4 rows (each data
    shard ``batch_size`` of them)."""
    return {"name": name, "kind": "train", "strategy": strategy,
            "mesh": mesh, "model": model,
            "train": {**TRAIN, "batch_size": batch_size,
                      **extra.pop("train", {})},
            "steps": steps, **extra}


_INT8 = {"optimizer_state_dtype": "int8"}
_ERRORS = {
    "dense": {"model": {**MODEL, "num_experts": 0},
              "mesh": {"data": 1, "expert": 2}},
    "indivisible": {"model": {**MODEL, "num_experts": 3},
                    "mesh": {"data": 1, "expert": 2}},
    "stage": {"model": {**MODEL, "num_layers": 3},
              "mesh": {"data": 1, "stage": 2}},
}


# -- the spawns and the references ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """The JAX ``Trainer`` on a ``data 2 x expert 2`` mesh of four CPU
    devices: its initial parameters (an npz) and its losses over
    ``STEPS`` dummy batches of a global batch of 4."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer

    mesh_cfg = MeshConfig(data=2, expert=2)
    jtr = JTrainer(JConfig(**MODEL), JTrain(**{**TRAIN, "batch_size": 2}),
                   JPar(mesh_cfg),
                   mesh=make_mesh(mesh_cfg, devices=jax.devices()[:4]))
    jstate = jtr.init_state(0)
    path = str(tmp_path_factory.mktemp("ep_params") / "params.npz")
    save_params_npz(path, jax.tree.map(np.asarray, jstate.params))
    losses = []
    for batch in DummyDataLoader(jtr.global_batch_size, 16,
                                 MODEL["vocab_size"], num_batches=STEPS,
                                 seed=11):
        jstate, m = jtr.train_step(jstate, batch)
        losses.append(float(m["loss"]))
    return path, losses


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_world2")
    np.savez(tmp / "layer.npz", **_layer_inputs())
    np.savez(tmp / "quant.npz", **_quant_leaf())
    (tmp / "moe.yaml").write_text(TINY_MOE_YAML)
    (tmp / "prompts.txt").write_text("hey you\nab\n")
    argv = _cli_argv(tmp, "cli", "--mesh_expert", "2")
    # A world-1 checkpoint (one step) the expert-2 ranks restore.
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    state = tr.init_state()
    state, _ = tr.train_step(state, next(iter(DummyDataLoader(
        tr.global_batch_size, 16, MODEL["vocab_size"], num_batches=1,
        seed=11))))
    ckpt.save_checkpoint(str(tmp / "w1ck"), state,
                         model_config=tr.model_config,
                         training_config=tr.training_config)
    jobs = [
        {"name": "layer", "kind": "moe_layer",
         "inputs": str(tmp / "layer.npz"), "cases": LAYER_CASES},
        {"name": "quant", "kind": "quant_cut",
         "inputs": str(tmp / "quant.npz")},
        _job("ep2", "replicated", {"data": 1, "expert": 2},
             save_at=[STEPS], save_dir=str(tmp / "ck"),
             restore=ckpt.latest_checkpoint(str(tmp / "w1ck"))),
        _job("ep2_knobs", "replicated", {"data": 1, "expert": 2},
             model=KNOBS, train=_INT8, telemetry_at=[1]),
        _job("tp2_knobs", "replicated", {"data": 1, "tensor": 2},
             model=KNOBS, train=_INT8, telemetry_at=[1]),
        {"name": "errors", "kind": "errors",
         "cases": {**{n: {"strategy": "replicated", "train": TRAIN, **c}
                      for n, c in _ERRORS.items()},
                   # The CLI on a dense yaml: the trainer's ValueError.
                   "cli_dense": {"argv": _cli_argv(
                       tmp, "dense", "--num_experts", "0",
                       "--mesh_expert", "2")}}},
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
def world4(tmp_path_factory, jax_ep):
    tmp = tmp_path_factory.mktemp("ep_world4")
    jobs = [
        _job("ep2_d2", "replicated", {"data": 2, "expert": 2},
             batch_size=2, params_npz=jax_ep[0]),
        _job("z3_ep2", "FULL_SHARD", {"data": 1, "fsdp": 2, "expert": 2},
             batch_size=2),
        _job("ep2_tp2", "replicated", {"data": 1, "tensor": 2, "expert": 2}),
        _job("ep2_tp2_knobs", "replicated",
             {"data": 1, "tensor": 2, "expert": 2}, model=KNOBS,
             train=_INT8, telemetry_at=[1]),
        _job("tp2_d2", "replicated", {"data": 2, "tensor": 2},
             batch_size=2),
        _job("sp2_d2", "replicated", {"data": 2, "sequence": 2},
             model=DROPS, batch_size=2, record_moe=True),
        # A planted fault: the MoE layer's sum over the expert ranks
        # dropped (each rank keeps its local experts' part).
        _job("ep2_d2_no_combine", "replicated", {"data": 2, "expert": 2},
             batch_size=2, params_npz=jax_ep[0], plant_moe="no_combine"),
    ]
    out = run_world(tmp, 4, jobs)
    out["tmp"] = tmp
    return out


_WORLD1 = {}


def _world1(model=MODEL, params_npz=None, record=False, telemetry_at=(),
            **train):
    """One process at one thread over the same global batch: losses, the
    final ``state_dict``, the telemetry records and (``record``) every
    MoE layer call's queue positions and keep mask; cached."""
    key = json.dumps([model, params_npz, record, list(telemetry_at), train],
                     sort_keys=True)
    if key in _WORLD1:
        return _WORLD1[key]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rec = {}
    restore = record_moe(rec) if record else None
    try:
        tr = Trainer(GPTConfig(**model), TrainingConfig(**{**TRAIN, **train}),
                     device="cpu")
        params = (None if params_npz is None else from_jax_params(
            load_params_npz(params_npz), tr.model_config, device="cpu"))
        state = tr.init_state(params=params)
        losses, tel = [], []
        for batch in DummyDataLoader(tr.global_batch_size, 16,
                                     model["vocab_size"], num_batches=STEPS,
                                     seed=11):
            state, m = tr.train_step(state, batch,
                                     telemetry=state.step in telemetry_at)
            losses.append(m["loss"])
            if "telemetry" in m:
                tel.append(telemetry.flatten_scalars(m["telemetry"]))
        out = _WORLD1[key] = (np.array(losses), state.state_dict(), tel, rec)
        return out
    finally:
        if restore is not None:
            restore()
        torch.set_num_threads(threads)


def _check_world1(ranks, ref):
    losses, sd = ref[:2]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, **TOL)
    got = assemble([r["records"] for r in ranks])
    for key, want in sd.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    return got


# -- the layer -------------------------------------------------------------------

def _jax_layer(case, d):
    """The JAX ``MoEMLP`` on the inputs: output, aux and the gradients of
    x, the router and the expert weights for the cotangent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.models.moe import MoEMLP

    module = MoEMLP(JConfig(**case))
    params = {"router": {"kernel": d["router"]}, "experts_gate": d["gate"],
              "experts_up": d["up"], "experts_down": d["down"]}
    (out, aux), vjp = jax.vjp(
        lambda p, x: module.apply({"params": p}, x, True), params,
        jnp.asarray(d["x"]))
    dp, dx = vjp((jnp.asarray(d["dout"]), jnp.asarray(1.0)))
    return (np.asarray(out), float(aux), np.asarray(dx),
            [np.asarray(g) for g in (dp["router"]["kernel"],
                                     dp["experts_gate"], dp["experts_up"],
                                     dp["experts_down"])])


def _one_layer(case, d):
    """The one-process layer: output, aux, grads, positions, keep."""
    cfg = GPTConfig(**case)
    ts = [torch.from_numpy(d[k]).requires_grad_(True)
          for k in ("x", "router", "gate", "up", "down")]
    rec = {}
    restore = record_moe(rec)
    try:
        out, aux = tmoe.moe_ffn(*ts, cfg)
        grads = torch.autograd.grad([out, aux], ts, [
            torch.from_numpy(d["dout"]), torch.tensor(1.0)])
    finally:
        restore()
    return (out.detach().numpy(), float(aux.detach()),
            [g.numpy() for g in grads], rec)


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_expert2_matches_one_process_and_jax(world2, case):
    cfg = LAYER_CASES[case]
    d = _layer_inputs()
    out1, aux1, grads1, rec = _one_layer(cfg, d)
    jout, jaux, jdx, jdw = _jax_layer(cfg, d)
    np.testing.assert_allclose(out1, jout, **TOL)
    ranks = world2["layer"]
    for x, r in enumerate(ranks):
        got = r[case]
        np.testing.assert_allclose(got["out"], out1, **TOL)
        np.testing.assert_allclose(got["out"], jout, **TOL)
        np.testing.assert_allclose(got["aux"], aux1, **TOL)
        np.testing.assert_allclose(got["aux"], jaux, **TOL)
        gx, grouter, *gw = got["grads"]
        np.testing.assert_allclose(gx, grads1[0], **TOL)
        np.testing.assert_allclose(gx, jdx, **GTOL)
        np.testing.assert_allclose(grouter, grads1[1], **TOL)
        np.testing.assert_allclose(grouter, jdw[0], **GTOL)
        # Each rank holds experts [2x, 2x + 2): their gradients.
        for g, full, jfull in zip(gw, grads1[2:], jdw[1:]):
            np.testing.assert_allclose(g, full[2 * x:2 * x + 2], **TOL)
            np.testing.assert_allclose(g, jfull[2 * x:2 * x + 2], **GTOL)
        if cfg.get("moe_impl") != "dropless":
            # The same routing, queue positions and keep mask bitwise.
            np.testing.assert_array_equal(got["pos"], rec["moe_pos"][0])
            np.testing.assert_array_equal(got["keep"], rec["moe_keep"][0])
            if cfg["expert_capacity_factor"] < 1.0:
                assert not got["keep"].all()


def test_auto_dispatch_is_einsum_under_an_expert_axis():
    cfg = GPTConfig(**MODEL)
    assert tmoe.dispatch_mode(cfg, 1) == "gather"
    assert tmoe.dispatch_mode(cfg, 2) == "einsum"
    assert "2 a rank over 2 expert ranks, capacity router, einsum" in (
        tmoe.describe(cfg, 2))


# -- trainers ---------------------------------------------------------------------

def test_data2_expert2_matches_jax_and_world1(world4, jax_ep):
    path, jlosses = jax_ep
    ranks = world4["ep2_d2"]
    got = _check_world1(ranks, _world1(params_npz=path))
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], jlosses, **TOL)
    # A rank holds E / 2 experts of every layer (its slices of the JAX
    # parameters are from_jax_params(expert=)'s); the router whole.
    tree = load_params_npz(path)
    for rank, r in enumerate(ranks):
        mine = from_jax_params(tree, GPTConfig(**MODEL), device="cpu",
                               expert=(rank % 2, 2))
        for name, t in mine.items():
            np.testing.assert_array_equal(
                r["init"]["params/" + name.replace(".", "/")], t.numpy(),
                err_msg=name)
    gate = "params/layers/moe_mlp/experts_gate"
    for r in ranks:
        assert r["final"][gate].shape[1] * 2 == got[gate].shape[1]
    a, b = ranks[0]["final"][gate], ranks[1]["final"][gate]
    assert not np.array_equal(a, b)
    router = "params/layers/moe_mlp/router/kernel"
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["final"][router],
                                      ranks[0]["final"][router])
    assert ranks[0]["collectives"]["moe_allreduce"] > 0
    assert ranks[0]["collectives"]["moe_counts"] > 0


@pytest.mark.parametrize("name,model", [
    ("z3_ep2", MODEL), ("ep2_tp2", MODEL), ("tp2_d2", MODEL),
    ("sp2_d2", DROPS)])
def test_composed_meshes_match_world1(world4, name, model):
    _check_world1(world4[name], _world1(model=model))


def test_planted_combine_dropped_fails_world1(world4, jax_ep):
    """The check that holds ``data 2 x expert 2`` to world 1 catches a MoE
    layer whose combine skips its sum over the expert ranks."""
    ref = _world1(params_npz=jax_ep[0])
    _check_world1(world4["ep2_d2"], ref)
    with pytest.raises(AssertionError):
        _check_world1(world4["ep2_d2_no_combine"], ref)


def test_sequence_positions_and_keep_bitwise(world4):
    """Under data 2 x sequence 2 a rank holds columns [8 j, 8 j + 8) of
    its two rows: every layer call's queue positions and keep mask are
    one process's, at the rank's tokens, in a run that drops tokens."""
    ranks = world4["sp2_d2"]
    rec = _world1(model=DROPS, record=True)[3]
    k = DROPS["moe_top_k"]
    calls = len(rec["moe_pos"])
    assert calls == STEPS * DROPS["num_layers"]
    for rank, r in enumerate(ranks):
        d, _, j = tmesh.mesh_coords((2, 1, 2, 1, 1, 1), rank)[:3]
        assert len(r["moe_pos"]) == calls
        for c in range(calls):
            want_pos = rec["moe_pos"][c].reshape(4, 16, k)[
                2 * d:2 * d + 2, 8 * j:8 * j + 8].reshape(-1, k)
            want_keep = rec["moe_keep"][c].reshape(4, 16, k)[
                2 * d:2 * d + 2, 8 * j:8 * j + 8].reshape(-1, k)
            np.testing.assert_array_equal(r["moe_pos"][c], want_pos)
            np.testing.assert_array_equal(r["moe_keep"][c], want_keep)
    assert not np.concatenate(rec["moe_keep"]).all()     # drop_frac > 0


@pytest.mark.parametrize("world,name", [("world2", "ep2_knobs"),
                                        ("world2", "tp2_knobs"),
                                        ("world4", "ep2_tp2_knobs")])
def test_int8_moments_and_telemetry_on_shards(request, world, name):
    """int8 moments and a telemetry step on expert 2, tensor 2 and expert
    2 x tensor 2 shards: the losses, the final parameters, every telemetry
    scalar (the router's stats among them) of world 1 with the same knobs;
    the stitched int8 packs in one process's layout and within a code step
    of its values."""
    ranks = request.getfixturevalue(world)[name]
    losses, sd, tel, _ = _world1(model=KNOBS, telemetry_at=(1,), **_INT8)
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], losses, **TOL)
    got = assemble([r["records"] for r in ranks])
    for key, want in sd.items():
        if key.startswith("params/"):
            # The moments' f32 values differ by ulps across layouts, so an
            # int8 code can land one step off (in sqrt-space a small nu's
            # code is coarse), moving that element's update by up to a
            # step's size, the learning rate: at most 0.1% of a leaf's
            # elements past the f32 bounds, each within the peak rate.
            close = np.isclose(got[key], want, rtol=1e-4, atol=1e-5)
            assert (~close).mean() <= 1e-3, key
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=TRAIN["learning_rate"],
                                       err_msg=key)
    want = tel[0]
    assert any("router" in key for key in want)
    for r in ranks:
        (mine,) = r["telemetry"]
        assert set(mine) == set(want)
        for key, v in want.items():
            np.testing.assert_allclose(mine[key], v, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    packs = [k for k in sd if k.endswith("/q")]
    assert packs
    for key in packs:
        base = key[:-len("/q")]
        assert got[key].shape == sd[key].shape, key
        assert got[f"{base}/scale"].shape == sd[f"{base}/scale"].shape
        np.testing.assert_allclose(got[f"{base}/scale"],
                                   sd[f"{base}/scale"], rtol=1e-3,
                                   atol=1e-8, err_msg=key)
        assert np.abs(got[key].astype(np.int32)
                      - sd[key].astype(np.int32)).max() <= 1, key


def test_tensor_cut_int8_pack_is_one_process_pack(world2):
    leaf = torch.from_numpy(_quant_leaf()["leaf"])
    for nonneg in (False, True):
        whole = quantize_blockwise_int8(leaf, nonneg=nonneg)
        q = np.zeros_like(whole.q.numpy())
        scale = np.zeros_like(whole.scale.numpy())
        for r in world2["quant"]:
            qb, sb = r[nonneg]
            for dst, boxes in ((q, qb), (scale, sb)):
                for starts, arr in boxes:
                    dst[tuple(slice(s, s + n) for s, n in
                              zip(starts, arr.shape))] = arr
        np.testing.assert_array_equal(q, whole.q.numpy())
        np.testing.assert_array_equal(scale, whole.scale.numpy())


# -- checkpoints, the CLI, infer, refusals --------------------------------------------

def test_expert2_checkpoint_restores_at_world1_and_exports(world2, tmp_path):
    ranks = world2["ep2"]
    _check_world1(ranks, _world1())
    step_dir = ckpt.latest_checkpoint(str(world2["tmp"] / "ck"))
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    state, _ = ckpt.restore_checkpoint(step_dir, tr)
    want = assemble([r["records"] for r in ranks])
    sd = state.state_dict()
    assert set(sd) - {"step", "opt_count", "loss_scale", "good_steps"} \
        == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key], arr, err_msg=key)
    params, _ = ckpt.restore_params(step_dir)
    out = ckpt.export_consolidated(str(tmp_path), params)
    pytest.importorskip("jax")
    from tpu_trainer.serving.remote import load_params_npz as jload

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, name)
            else:
                flat[name] = np.asarray(v)
    walk(jload(out), "")
    assert set(flat) == set(params)
    for name, v in params.items():
        np.testing.assert_array_equal(flat[name], v, err_msg=name)


def test_world1_checkpoint_restores_at_expert2(world2):
    """And back: a world-1 checkpoint restored at expert 2, each rank
    holding its experts' slices of its arrays, bitwise."""
    step_dir = ckpt.latest_checkpoint(str(world2["tmp"] / "w1ck"))
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    want = ckpt.restore_checkpoint(step_dir, tr)[0].state_dict()
    specs = leaf_specs({n: tuple(p.shape)
                        for n, p in tr.model.named_parameters()},
                       "replicated", 1, 1, 2)
    for x, r in enumerate(world2["ep2"]):
        got = r["restored"]
        assert set(got) == {k for k in want if "/" in k}
        for key, arr in got.items():
            name = key.split("/", 1)[1] if key.startswith("params/") \
                else key.split("/", 2)[2]
            sp = specs[name.replace("/", ".")]
            w = want[key]
            if sp.expert_dim is not None:
                n = w.shape[sp.expert_dim] // 2
                w = np.take(w, range(x * n, (x + 1) * n), axis=sp.expert_dim)
            np.testing.assert_array_equal(arr, w, err_msg=key)
        assert r["restored_scalars"]["step"] == 1


def test_cli_expert2_resume_is_bitwise(world2):
    tmp = world2["tmp"]
    recs = [r for r in map(json.loads, open(tmp / "cli.jsonl"))
            if r.get("kind") == "train"]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 2, 3]
    assert [r["loss"] for r in recs[2:4]] == [r["loss"] for r in recs[4:]]


def test_infer_tensor2_moe_equals_one_process(world2):
    from tpu_trainer_torch.eval import infer

    tmp = world2["tmp"]
    one = {}
    assert infer.main(_infer_argv(tmp), result=one) == 0
    for rank in world2["cli"]:
        assert rank["infer"][0] == one["tokens"]


@pytest.mark.parametrize("case,exc,match", [
    ("dense", "ValueError", "expert mesh axis > 1 requires a MoE model"),
    ("indivisible", "ValueError",
     "num_experts 3 not divisible by expert axis size 2"),
    ("stage", "ValueError",
     "num_layers 3 not divisible by stage axis size 2"),
    ("cli_dense", "ValueError", "expert mesh axis > 1 requires a MoE model"),
])
def test_refusals(world2, case, exc, match):
    for rank in world2["errors"]:
        kind, msg = rank[case]
        assert kind == exc
        assert match in msg, msg
