"""The port's pipeline parallelism on the CPU: the ``stage`` mesh axis with
the GPipe, 1F1B and interleaved schedules, composed with data, ZeRO,
sequence and expert.

Held against the JAX package:
- the schedule tables (``parallel/pipeline.py``): for S in {2, 4}, M in
  {2, 4, 8} and v in {1, 2}, every item's forward before its backward,
  every message consumed at the next tick, the in-flight count never
  above the window W of the JAX simulation (``min(M, 2S - 1)`` at v 1, 3
  at S 2, M 4), and a table built with W - 1 rejected;
- placement: ``parallel.sharding.leaf_specs`` against the JAX
  ``params_specs_from_sizes`` / ``grads_specs_from_sizes`` for every leaf
  at stage 2 and 4, fsdp 2 x stage 2 (zero2, zero3) and expert 2 x stage
  2 (a MoE model); ``mesh_coords`` and ``host_feed_info`` against the JAX
  device layout at data 2 x stage 4;
- the ``data 2 x stage 2`` ``Trainer`` against the JAX ``Trainer`` on a
  ``MeshConfig(data=2, stage=2)`` of four CPU devices from the same
  parameters, losses within 1e-5: GPipe on the dense model, and the
  interleaved schedule (M 2, v 2) on a MoE model whose capacity router
  drops tokens, at one row a data shard (a rank's share of a microbatch
  is one row or none). Two JAX trainer runs in this file.

Held against the port's own world 1 (one process, one thread, the same
global batch; a MoE model's accumulation micro-batches are the
pipeline's strided microbatches): 1F1B and interleaved at data 2 x stage
2, fsdp 2 x stage 2 under zero3 and zero2, stage 2 x sequence 2 for GPipe
and 1F1B, expert 2 x stage 2 with the capacity and the dropless router,
accumulation 2 with remat, fp16 loss scaling under 1F1B, GQA, stage 4,
and M 2 against M 4: losses within 1e-5, final parameters within rtol
1e-4 / atol 1e-5 (the router leaves among them). With dropout 0.1 the
three schedules give the same losses within 1e-6 and draw the same masks
per (global layer, microbatch); the fold keyed by the local layer index
(planted) makes them differ; under stage 2 x sequence 2 the two sequence
ranks' masks differ. int8 moments under fsdp 2 x stage 2 (losses, the
stitched packs in one process's layout and within a code step), a
telemetry step (the norms; no activation capture, as in JAX),
``eval_step`` and ``nan_scan`` equal world 1's. A stage-2 interleaved
checkpoint restored at world 1 with bitwise masters, its consolidated
export read by the JAX ``load_params_npz``, a world-1 checkpoint restored
at stage 2; ``train_ddp --mesh_stage 2 --pipeline_microbatches 2``
resuming bitwise; and the refusals with the JAX messages.

Ranks run in one world-4 gloo spawn of ``tests/torch_dist_worker.py``,
every job in it.
"""

import json

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT
from tpu_trainer_torch.parallel import mesh as tmesh
from tpu_trainer_torch.parallel import pipeline as tpp
from tpu_trainer_torch.parallel.sharding import leaf_specs
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt
from tpu_trainer_torch.utils import telemetry

TOL = dict(rtol=1e-5, atol=1e-5)
PTOL = dict(rtol=1e-4, atol=1e-5)
SEQ = 32
MODEL = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
             max_seq_len=SEQ, dropout=0.0, attention_dropout=0.0,
             use_flash_attention=True, dtype="float32",
             param_dtype="float32")
MOE = dict(MODEL, num_experts=4, moe_top_k=2, moe_aux_weight=0.5,
           router_z_weight=1e-3)
DROPS = dict(MOE, expert_capacity_factor=0.5)
# Leaves past int8's 65,536 elements: the embedding and the FFN kernels.
KNOBS = dict(MODEL, vocab_size=2048, intermediate_size=512)
DROPOUT = dict(MODEL, dropout=0.1)
TRAIN = dict(batch_size=4, max_seq_len=SEQ, gradient_accumulation_steps=1,
             max_steps=100, warmup_steps=2, learning_rate=3e-3,
             mixed_precision="fp32", seed=0)
STEPS = 3


def _sched(kind, **kw):
    return {"pipeline_schedule": kind, **kw}


IL = _sched("interleaved", pipeline_microbatches=2)
F1 = _sched("1f1b")


# -- the schedule tables ---------------------------------------------------------

_TABLES = [(S, M, v) for S in (2, 4) for M in (2, 4, 8) for v in (1, 2)
           if v == 1 or M % S == 0]


@pytest.mark.parametrize("S,M,v", _TABLES)
def test_schedule_table(S, M, v):
    kind = "1f1b" if v == 1 else "interleaved"
    sched = tpp.make_schedule(kind, S, M, v)
    got = tpp.check_schedule(sched)
    assert got["ticks"] == v * M + (v + 1) * S - 2
    assert got["in_flight"] == sched.window
    if v == 1:
        assert sched.window == min(M, 2 * S - 1)
    if (S, M, v) == (2, 4, 1):
        assert sched.window == 3
    # The JAX canonical sequence: rank s runs forward item k at tick s + k.
    for s in range(S):
        items = [tk.fwd for tk in sched.ticks[s] if tk.fwd is not None]
        for k, (c, m) in enumerate(items):
            assert sched.ticks[s][s + k].fwd == (c, m)
            assert (c, m) == ((k % (S * v)) // S,
                              (k // (S * v)) * S + k % S)
    narrow = tpp.make_schedule(kind, S, M, v, window_size=sched.window - 1)
    with pytest.raises(ValueError, match="in flight"):
        tpp.check_schedule(narrow)


@pytest.mark.parametrize("S,M", [(2, 2), (2, 8), (4, 4)])
def test_gpipe_table(S, M):
    sched = tpp.make_schedule("gpipe", S, M)
    assert tpp.check_schedule(sched)["in_flight"] == M
    heads = [s for s in range(S) if any(tk.head == -1
                                        for tk in sched.ticks[s])]
    assert heads == [S - 1]
    assert sched.bubble == pytest.approx((S - 1) / (M + S - 1))


def test_micro_rows_are_strided():
    # Global row j*M + m is in microbatch m; a data shard of 3 rows at
    # row 3 of M = 4: rows 3, 4, 5 go to microbatches 3, 0, 1.
    assert tpp.micro_rows(3, 3, 4) == [[1], [2], [], [0]]
    assert tpp.stage_layers(8, 2, 2, 1) == [2, 3, 6, 7]
    assert tpp.bubble_fraction("interleaved", 4, 8, 2) == pytest.approx(
        3 / 19)


# -- placement -------------------------------------------------------------------

def _jax_specs(cfg_kw, sizes, strategy):
    jax = pytest.importorskip("jax")
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


_PLACE = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
              max_seq_len=64)


@pytest.mark.parametrize("strategy,fsdp,expert,stage", [
    ("replicated", 1, 1, 2), ("replicated", 1, 1, 4), ("zero3", 2, 1, 2),
    ("zero2", 2, 1, 2), ("zero3", 1, 2, 2), ("replicated", 1, 2, 2)])
def test_placement_matches_jax(strategy, fsdp, expert, stage):
    cfg = dict(_PLACE, num_experts=4 if expert > 1 else 0)
    want_p, want_g = _jax_specs(cfg, {"data": 1, "fsdp": fsdp,
                                      "expert": expert, "stage": stage},
                                strategy)
    model = GPT(GPTConfig(**cfg), device="meta")
    specs = leaf_specs({n: tuple(p.shape)
                        for n, p in model.named_parameters()},
                       strategy, fsdp, 1, expert, stage)
    assert {n.replace(".", "/") for n in specs} == set(want_p)
    for name, spec in specs.items():
        key = name.replace(".", "/")
        assert spec.partition(spec.param_dim) == want_p[key], key
        assert spec.partition(spec.state_dim) == want_g[key], key
    assert specs["embed_tokens.embedding"].stage_dim is None
    assert specs["layers.input_layernorm.weight"].tp_shape[0] == 4 // stage


def test_mesh_layout_matches_jax():
    """Rank ``r`` sits where the JAX ``make_mesh`` puts device ``r`` at
    data 2 x stage 4 (stage innermost), and the ranks of a data shard
    load its rows, as the JAX ``host_feed_info`` gives them."""
    jax = pytest.importorskip("jax")
    from jax.sharding import NamedSharding
    from tpu_trainer.parallel import mesh as jmesh

    mesh_cfg = jmesh.MeshConfig(data=2, stage=4)
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


# -- the references ------------------------------------------------------------------

def _jax_losses(model_kw, batch_size, path):
    """The JAX ``Trainer`` on ``MeshConfig(data=2, stage=2)`` of four CPU
    devices: its initial parameters (an npz at ``path``), its losses over
    ``STEPS`` dummy batches and its ``eval_step`` on the first batch at
    the initial parameters."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer

    jkw = {k: v for k, v in model_kw.items() if k != "use_flash_attention"}
    mesh_cfg = MeshConfig(data=2, stage=2)
    jtr = JTrainer(JConfig(**jkw), JTrain(**{**TRAIN,
                                             "batch_size": batch_size}),
                   JPar(mesh_cfg),
                   mesh=make_mesh(mesh_cfg, devices=jax.devices()[:4]))
    jstate = jtr.init_state(0)
    save_params_npz(path, jax.tree.map(np.asarray, jstate.params))
    losses, ev = [], None
    for batch in DummyDataLoader(jtr.global_batch_size, SEQ,
                                 model_kw["vocab_size"], num_batches=STEPS,
                                 seed=11):
        if ev is None:
            ev = float(jtr.eval_step(jstate, batch))
        jstate, m = jtr.train_step(jstate, batch)
        losses.append(float(m["loss"]))
    return losses, ev


@pytest.fixture(scope="module")
def jax_pp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_jax")
    out = {}
    for tag, model, rows in (("gpipe", MODEL, 2),
                             ("moe_il", {**DROPS, **IL}, 1)):
        npz = str(tmp / f"{tag}.npz")
        losses, ev = _jax_losses(model, rows, npz)
        out[tag] = (npz, losses, ev)
    return out


def _strided(rows, micro):
    """The row order whose contiguous accumulation blocks are the
    pipeline's strided microbatches."""
    return sorted(range(rows), key=lambda i: (i % micro, i))


_WORLD1 = {}


def _world1(model=MODEL, permute=None, telemetry_at=(), evals=False,
            nan=False, **train):
    """One process at one thread over the same global batch: losses, the
    final ``state_dict``, the telemetry records, the eval loss of the
    first batch and the nan-scan report; ``permute`` reorders each
    batch's rows (cached)."""
    key = json.dumps([model, permute, list(telemetry_at), evals, nan,
                      train], sort_keys=True)
    if key in _WORLD1:
        return _WORLD1[key]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(GPTConfig(**model), TrainingConfig(**{**TRAIN, **train}),
                     device="cpu")
        state = tr.init_state()
        losses, tel, first = [], [], None
        for batch in DummyDataLoader(tr.global_batch_size, SEQ,
                                     model["vocab_size"], num_batches=STEPS,
                                     seed=11):
            first = batch if first is None else first
            if permute is not None:
                batch = batch[permute]
            state, m = tr.train_step(state, batch,
                                     telemetry=state.step in telemetry_at)
            losses.append(m["loss"])
            if "telemetry" in m:
                tel.append(telemetry.flatten_scalars(m["telemetry"]))
        ev = float(tr.eval_step(state, first)) if evals else None
        rep = tr.nan_scan(tr.init_state(), first) if nan else None
        out = _WORLD1[key] = dict(losses=np.array(losses),
                                  sd=state.state_dict(), tel=tel, eval=ev,
                                  nan=rep)
        return out
    finally:
        torch.set_num_threads(threads)


# fp16 compute: a summation order other than one process's flips an fp16
# rounding of a gradient now and then, and Adam turns the flip into up to
# a few percent of an element whose gradient is near zero (1F1B at stage
# 4 after 3 steps at lr 3e-3: 3 of 4096 embedding elements past atol
# 1e-5, one of 16384 up_proj elements 9.0e-05 off). fp16 parameters are
# held on each leaf's relative L2 instead (f32 runs: ~1e-6).
FP16_L2 = 1e-4


def _check_world1(ranks, ref, l2=None):
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], ref["losses"], **TOL)
    got = assemble([r["records"] for r in ranks])
    for key, want in ref["sd"].items():
        if not key.startswith("params/"):
            continue
        if l2 is None:
            np.testing.assert_allclose(got[key], want, **PTOL, err_msg=key)
        else:
            rel = (np.linalg.norm(got[key] - want)
                   / max(np.linalg.norm(want), 1e-30))
            assert rel <= l2, (key, rel)
    return got


# -- the spawn ---------------------------------------------------------------------

def _job(name, mesh, model=MODEL, strategy="replicated", batch_size=4,
         steps=STEPS, **extra):
    """A train job at the world-1 runs' global batch (each data shard
    ``batch_size`` rows)."""
    return {"name": name, "kind": "train", "strategy": strategy,
            "mesh": mesh, "model": model,
            "train": {**TRAIN, "batch_size": batch_size,
                      **extra.pop("train", {})},
            "steps": steps, **extra}


D2S2 = {"data": 2, "stage": 2}
S2 = {"data": 1, "stage": 2}
_INT8 = {"optimizer_state_dtype": "int8"}

TINY_YAML = """
model:
  vocab_size: 256
  hidden_size: 32
  num_layers: 4
  num_heads: 4
  max_seq_len: 16
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: true
  pipeline_schedule: interleaved
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
    return ["--device", "cpu", "--config", str(tmp / "pp.yaml"),
            "--max_steps", "4", "--save_interval", "2", "--keep_last_n", "0",
            "--log_interval", "1", "--eval_interval", "0",
            "--checkpoint_dir", str(tmp / tag),
            "--metrics_jsonl", str(tmp / f"{tag}.jsonl"), *extra]


_ERRORS = {
    "layers": {"model": {**MODEL, "num_layers": 3}, "mesh": D2S2},
    "layers_virtual": {"model": {**MODEL, "num_layers": 6,
                                 **_sched("interleaved")},
                       "mesh": D2S2},
    "micro_virtual": {"model": {**MODEL, **_sched(
        "interleaved", pipeline_microbatches=3)}, "mesh": D2S2,
        "train": {**TRAIN, "batch_size": 3}},
    "batch": {"model": {**MODEL, "pipeline_microbatches": 3},
              "mesh": D2S2},
    "packed": {"model": MODEL, "mesh": D2S2, "forward": True},
    "window": {"model": {**MODEL, **_sched("1f1b",
                                           pipeline_microbatches=4)},
               "mesh": D2S2, "window_delta": -1},
}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_pp):
    tmp = tmp_path_factory.mktemp("pp_world4")
    (tmp / "pp.yaml").write_text(TINY_YAML)
    # A world-1 checkpoint (one step) the stage-2 ranks restore.
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    state = tr.init_state()
    state, _ = tr.train_step(state, next(iter(DummyDataLoader(
        tr.global_batch_size, SEQ, MODEL["vocab_size"], num_batches=1,
        seed=11))))
    ckpt.save_checkpoint(str(tmp / "w1ck"), state,
                         model_config=tr.model_config,
                         training_config=tr.training_config)
    w1 = ckpt.latest_checkpoint(str(tmp / "w1ck"))
    argv = _cli_argv(tmp, "cli", "--mesh_data", "2", "--mesh_stage", "2",
                     "--pipeline_microbatches", "2")
    jobs = [
        _job("jax_gpipe", D2S2, batch_size=2,
             params_npz=jax_pp["gpipe"][0]),
        _job("jax_moe_il", D2S2, model={**DROPS, **IL}, batch_size=1,
             params_npz=jax_pp["moe_il"][0], eval="init"),
        _job("f1b", D2S2, model={**MODEL, **F1}, batch_size=2, eval=True),
        _job("il", D2S2, model={**MODEL, **IL}, batch_size=2,
             save_at=[STEPS], save_dir=str(tmp / "ck"), restore=w1),
        _job("z3", {"data": 1, "fsdp": 2, "stage": 2},
             model={**MODEL, **F1}, strategy="zero3", batch_size=2),
        _job("z2", {"data": 1, "fsdp": 2, "stage": 2}, strategy="zero2",
             batch_size=2),
        _job("sp_gpipe", {"data": 1, "sequence": 2, "stage": 2}),
        _job("sp_1f1b", {"data": 1, "sequence": 2, "stage": 2},
             model={**MODEL, **F1}),
        _job("ep_capacity", {"data": 1, "expert": 2, "stage": 2},
             model={**DROPS, **F1}),
        _job("ep_dropless", {"data": 1, "expert": 2, "stage": 2},
             model={**MOE, "moe_impl": "dropless"}),
        _job("remat", D2S2, model={**MODEL, "gradient_checkpointing": True},
             batch_size=2, train={"gradient_accumulation_steps": 2}),
        _job("fp16", {"data": 1, "stage": 4}, model={**MODEL, **F1},
             train={"mixed_precision": "fp16"}),
        _job("gqa", D2S2, model={**MODEL, "num_kv_heads": 2, **F1},
             batch_size=2),
        _job("s4", {"data": 1, "stage": 4},
             model={**MODEL, **_sched("1f1b", pipeline_microbatches=4)},
             telemetry_at=[1]),
        _job("m4", D2S2, model={**MODEL, "pipeline_microbatches": 4},
             batch_size=2),
        _job("knobs", {"data": 1, "fsdp": 2, "stage": 2}, model=KNOBS,
             strategy="zero2", batch_size=2, train=_INT8,
             telemetry_at=[1]),
        _job("drop_gpipe", D2S2, model=DROPOUT, batch_size=2, steps=2,
             record_dropout=True),
        _job("drop_1f1b", D2S2, model={**DROPOUT, **F1}, batch_size=2,
             steps=2, record_dropout=True),
        _job("drop_il", D2S2, model={**DROPOUT, **IL}, batch_size=2,
             steps=2, record_dropout=True),
        _job("drop_il_local", D2S2, model={**DROPOUT, **IL}, batch_size=2,
             steps=2, plant_local_fold=True),
        _job("drop_sp", {"data": 1, "sequence": 2, "stage": 2},
             model=DROPOUT, steps=1, record_dropout=True),
        {"name": "nan", "kind": "nan_scan", "strategy": "replicated",
         "mesh": D2S2, "model": MODEL, "train": {**TRAIN, "batch_size": 2}},
        {"name": "errors", "kind": "errors",
         "cases": {n: {"strategy": "replicated",
                       "train": {**TRAIN, "batch_size": 2}, **c}
                   for n, c in _ERRORS.items()}},
        {"name": "cli", "kind": "cli",
         "runs": [{"argv": argv},
                  {"argv": argv,
                   "remove": str(tmp / "cli" / "step_00000004")}]},
    ]
    out = run_world(tmp, 4, jobs, timeout=400.0)
    out["tmp"] = tmp
    return out


# -- against JAX -----------------------------------------------------------------------

def test_gpipe_data2_stage2_matches_jax(world4, jax_pp):
    for rank in world4["jax_gpipe"]:
        np.testing.assert_allclose(rank["losses"], jax_pp["gpipe"][1], **TOL)


def test_interleaved_moe_uneven_micro_matches_jax(world4, jax_pp):
    """Interleaved (M 2, v 2), the capacity router dropping tokens, one
    row a data shard: data shard 0 holds microbatch 0's row and none of
    microbatch 1's, shard 1 the other way round."""
    assert tpp.micro_rows(1, 0, 2) == [[0], []]
    assert tpp.micro_rows(1, 1, 2) == [[], [0]]
    for rank in world4["jax_moe_il"]:
        np.testing.assert_allclose(rank["losses"], jax_pp["moe_il"][1],
                                   **TOL)


def test_capacity_moe_eval_under_stage_matches_jax(world4, jax_pp):
    """``eval_step`` of the capacity-router model that drops tokens, at
    data 2 x stage 2, against the JAX ``Trainer``'s eval at the same mesh
    and parameters (the initial ones):
    both run the GPipe forward in ``pipeline_microbatches`` microbatches,
    so capacity and the aux are per microbatch (one microbatch of the
    whole batch gives another loss where tokens drop)."""
    want = jax_pp["moe_il"][2]
    for rank in world4["jax_moe_il"]:
        assert rank["eval"] == pytest.approx(want, rel=1e-5, abs=1e-5)


# -- against the port's world 1 -----------------------------------------------------------

_AGAINST_WORLD1 = {
    "f1b": {}, "il": {}, "z3": {}, "z2": {}, "sp_gpipe": {}, "sp_1f1b": {},
    "remat": {"gradient_accumulation_steps": 2},
    # fp16 rounds each microbatch's gradients: world 1 accumulates the
    # same four one-row microbatches (stage 4, M 4).
    "fp16": {"mixed_precision": "fp16", "batch_size": 1,
             "gradient_accumulation_steps": 4},
    "gqa": {"model": {**MODEL, "num_kv_heads": 2}},
    "s4": {}, "m4": {},
}


@pytest.mark.parametrize("tag", sorted(_AGAINST_WORLD1))
def test_matches_world1(world4, tag):
    kw = dict(_AGAINST_WORLD1[tag])
    model = kw.pop("model", MODEL)
    ref = _world1(model, **kw)
    _check_world1(world4[tag], ref, l2=FP16_L2 if tag == "fp16" else None)
    if tag == "fp16":
        # The loss scale rode the pipeline: the same scale, no step
        # skipped, on every rank.
        for rank in world4[tag]:
            assert rank["scalars"]["loss_scale"] == ref["sd"]["loss_scale"]


@pytest.mark.parametrize("tag", ["ep_capacity", "ep_dropless"])
def test_expert_stage_matches_world1(world4, tag):
    """expert 2 x stage 2 (M 2): world 1 accumulates the same two strided
    microbatches (capacity and the auxiliary per microbatch); the router
    leaves, moved by the auxiliary's gradient, within the bounds too."""
    model = {**DROPS} if tag == "ep_capacity" else {**MOE,
                                                     "moe_impl": "dropless"}
    ref = _world1(model, permute=_strided(4, 2), batch_size=2,
                  gradient_accumulation_steps=2)
    got = _check_world1(world4[tag], ref)
    assert "params/layers/moe_mlp/router/kernel" in got


def test_m2_and_m4_same_loss(world4):
    """GPipe at M 4 and 1F1B at M 2 (data 2 x stage 2, the same
    parameters and rows): the same losses."""
    for a, b in zip(world4["m4"], world4["f1b"]):
        np.testing.assert_allclose(a["losses"], b["losses"], **TOL)


def test_stage_ranks_hold_their_layers(world4):
    """Every rank holds its stage's layers only; the 1F1B window bounds
    what a rank held in flight, and the pipeline's sends were counted."""
    for job, v in (("f1b", 1), ("il", 2)):
        for r, rank in enumerate(world4[job]):
            s = r % 2
            q = rank["final"]["params/layers/attention/q_proj/kernel"]
            assert q.shape[0] == 2
            assert rank["pipeline"]["in_flight"] <= tpp.window(2, 2, v)
            assert rank["collectives"]["pp_send"] > 0
            assert tpp.stage_layers(4, 2, v, s) == (
                [2 * s, 2 * s + 1] if v == 1 else [s, s + 2])


# -- dropout ------------------------------------------------------------------------------

def _masks(rank):
    return sorted((c[0], c[1], c[2], c[4].tobytes()) for c in rank["dropout"])


def test_dropout_schedules_agree(world4):
    base = world4["drop_gpipe"]
    for tag in ("drop_1f1b", "drop_il"):
        for a, b in zip(base, world4[tag]):
            np.testing.assert_allclose(b["losses"], a["losses"], rtol=0,
                                       atol=1e-6)
    # The same masks per (global layer, microbatch): rank for rank, the
    # multiset of (seed, offsets, kept mask) over the run (interleaved
    # ranks hold other layers than GPipe's, so compare across the stage
    # group: the union of both stage ranks of a data shard).
    for d in range(2):
        want = _masks(base[2 * d]) + _masks(base[2 * d + 1])
        for tag in ("drop_1f1b", "drop_il"):
            ranks = world4[tag]
            got = _masks(ranks[2 * d]) + _masks(ranks[2 * d + 1])
            assert sorted(got) == sorted(want), tag


def test_dropout_local_fold_differs(world4):
    """Planted: the fold keyed by the rank's local layer index gives the
    interleaved ranks (which hold layers 0, 2 and 1, 3) other masks than
    GPipe's, and the losses move."""
    diff = max(abs(a - b) for a, b in zip(
        world4["drop_il_local"][0]["losses"],
        world4["drop_gpipe"][0]["losses"]))
    assert diff > 1e-4


def test_dropout_sequence_ranks_differ(world4):
    """stage 2 x sequence 2: the two sequence ranks of a stage draw the
    same seed for a block but hash their own columns, so their masks
    differ."""
    ranks = world4["drop_sp"]
    for s in range(2):
        a, b = ranks[s]["dropout"], ranks[2 + s]["dropout"]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x[0] == y[0] and x[3] != y[3]
            assert not np.array_equal(x[4], y[4])


# -- knobs ---------------------------------------------------------------------------------

def test_int8_moments_under_stage(world4):
    """fsdp 2 x stage 2 under zero2 with int8 moments: the losses equal
    world 1's, and the stitched packs (a stage's layers, of them an fsdp
    slice of the last dim: a ``BlockCut``) are one process's packs, codes
    within one step (the moments differ by ulps across layouts, and a
    code can land a step off, which moves that element's update: the
    parameters are not held here)."""
    ref = _world1(KNOBS, telemetry_at=(1,), **_INT8)
    for rank in world4["knobs"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], **TOL)
    got = assemble([r["records"] for r in world4["knobs"]])
    assert "opt_state/nu/layers/mlp/up_proj/kernel/q" in got
    for key, want in ref["sd"].items():
        if key.endswith("/q"):
            assert got[key].shape == want.shape, key
            diff = np.abs(got[key].astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, key
        elif key.endswith("/scale"):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("tag,model,kw", [
    ("knobs", KNOBS, _INT8),
    ("s4", {**MODEL, **_sched("1f1b", pipeline_microbatches=4)}, {})])
def test_telemetry_norms_under_stage(world4, tag, model, kw):
    ref = _world1(model, telemetry_at=(1,), **kw)["tel"][0]
    for rank in world4[tag]:
        tel = rank["telemetry"][0]
        assert not any("/act/" in k or "/router/" in k for k in tel)
        norms = {k: v for k, v in ref.items() if k.split("/")[1] in (
            "grad_norm", "param_norm", "update_ratio")}
        assert norms
        assert set(norms) <= set(tel)
        for k, v in norms.items():
            np.testing.assert_allclose(tel[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_eval_and_nan_scan_equal_world1(world4):
    ref = _world1({**MODEL, **F1}, evals=True, nan=True)
    for rank in world4["f1b"]:
        assert rank["eval"] == pytest.approx(ref["eval"], rel=1e-5)
    want = ref["nan"]
    for rank in world4["nan"]:
        assert rank["first_nan"] == want["first_nan"] is None
        assert set(rank["stats"]) == set(want["stats"])
        for k, v in want["stats"].items():
            np.testing.assert_allclose(rank["stats"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


# -- checkpoints and the CLI --------------------------------------------------------------

def test_interleaved_checkpoint_restores_at_world1(world4, tmp_path):
    ranks = world4["il"]
    step_dir = ckpt.latest_checkpoint(str(world4["tmp"] / "ck"))
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


def test_world1_checkpoint_restores_at_stage2(world4):
    """And back: a world-1 checkpoint restored at stage 2 under the
    interleaved layout, every rank holding its layers (0, 2 or 1, 3)."""
    step_dir = ckpt.latest_checkpoint(str(world4["tmp"] / "w1ck"))
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**TRAIN), device="cpu")
    want = ckpt.restore_checkpoint(step_dir, tr)[0].state_dict()
    got = assemble([r["restored_records"] for r in world4["il"]])
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
    for r, rank in enumerate(world4["il"]):
        q = rank["restored"]["params/layers/attention/q_proj/kernel"]
        full = want["params/layers/attention/q_proj/kernel"]
        np.testing.assert_array_equal(q, full[[r % 2, r % 2 + 2]])
        assert rank["restored_scalars"]["step"] == 1


def test_cli_stage2_resume_is_bitwise(world4):
    tmp = world4["tmp"]
    recs = [r for r in map(json.loads, open(tmp / "cli.jsonl"))
            if r.get("kind") == "train"]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 2, 3]
    assert [r["loss"] for r in recs[2:4]] == [r["loss"] for r in recs[4:]]


# -- refusals -------------------------------------------------------------------------------

@pytest.mark.parametrize("case,exc,match", [
    ("layers", "ValueError", "num_layers 3 not divisible by stage axis "
                             "size 2"),
    ("layers_virtual", "ValueError", "num_layers 6 not divisible by "
                                     "stages*virtual (2*2)"),
    ("micro_virtual", "ValueError", "interleaved schedule needs "
                                    "pipeline_microbatches (3) divisible "
                                    "by the stage count (2)"),
    ("batch", "ValueError", "global batch 4 rows (batch_size 2 x 2 data "
                            "shards) not divisible by "
                            "pipeline_microbatches 3"),
    ("packed", "NotImplementedError", "segment_ids are not supported "
                                      "under pipeline parallelism"),
    ("window", "ValueError", "microbatches of chunk 0 in flight, window 2"),
])
def test_refusals(world4, case, exc, match):
    for rank in world4["errors"]:
        kind, msg = rank[case]
        assert kind == exc, msg
        assert match in msg, msg
