"""The port's pipeline under the tensor axis on the CPU: ``tensor 2 x stage
2`` with the GPipe, 1F1B and interleaved schedules.

Held against the JAX package: the ``Trainer`` on ``MeshConfig(tensor=2,
stage=2)`` of four CPU devices from the same parameters (carried across
in the npz), losses within 1e-5, for GPipe and 1F1B (two JAX trainer
runs in this file); the interleaved schedule (M 2, v 2) from the same
parameters against GPipe's losses.

Held against the port's own world 1 (one process, one thread, the same
global batch): 1F1B's losses, final parameters (rtol 1e-4 / atol 1e-5),
``eval_step`` and ``nan_scan``; GQA (2 kv heads); a vocabulary of 125
rows, whose 1F1B head has a padding column inside the vocabulary (the
label that opens the second tensor slice counted once); a rank's leaves (a
layer leaf the tensor axis cuts at a quarter of its elements, the other
layer leaves and the tied embedding at a half, the final norm whole); a
checkpoint written at tensor 2 x stage 2 restored at world 1 bitwise, and
a world-1 checkpoint restored at tensor 2 x stage 2;
and ``train_fsdp --mesh auto`` at world 4 against the world-1 CLI run,
its ``mesh_plan`` and ``comms_model`` records read back from the JSONL
(the comms crosscheck noting only the gradient sums over the sequence
ranks and the stage group, which the model does not charge). With dropout 0.1 the three
schedules give the same losses within 1e-6 and draw the same residual
masks per (global layer, microbatch), the two ranks of a tensor pair
the same ones.

Ranks run in one world-4 gloo spawn of ``tests/torch_dist_worker.py``,
every job in it.
"""

import json

import numpy as np
import pytest

from tests.test_torch_pipeline import (
    MODEL,
    SEQ,
    STEPS,
    TOL,
    TRAIN,
    _check_world1,
    _job,
    _masks,
    _sched,
    _world1,
)
from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.training import cli
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt

T2S2 = {"data": 1, "tensor": 2, "stage": 2}
F1 = _sched("1f1b")
IL = _sched("interleaved", pipeline_microbatches=2)
DROPOUT = dict(MODEL, dropout=0.1)
# 125 rows: tensor slices of 63, each cut over 2 stages into 32 and 31
# rows and a padding row, so the 1F1B head has a padding column inside
# the vocabulary (global column 63 opens the second tensor slice; the
# seeded batches hold that label twice).
ODD_VOCAB = dict(MODEL, vocab_size=125)

AUTO_YAML = """
model:
  vocab_size: 128
  hidden_size: 32
  num_layers: 4
  num_heads: 4
  max_seq_len: 32
  dropout: 0.0
  attention_dropout: 0.0
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


def _jax_losses(model_kw, path):
    """The JAX ``Trainer`` on ``MeshConfig(tensor=2, stage=2)`` of four CPU
    devices: its initial parameters (an npz at ``path``) and its losses
    over ``STEPS`` dummy batches."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer

    jkw = {k: v for k, v in model_kw.items() if k != "use_flash_attention"}
    mesh_cfg = MeshConfig(tensor=2, stage=2)
    jtr = JTrainer(JConfig(**jkw), JTrain(**TRAIN), JPar(mesh_cfg),
                   mesh=make_mesh(mesh_cfg, devices=jax.devices()[:4]))
    jstate = jtr.init_state(0)
    save_params_npz(path, jax.tree.map(np.asarray, jstate.params))
    losses = []
    for batch in DummyDataLoader(jtr.global_batch_size, SEQ,
                                 model_kw["vocab_size"], num_batches=STEPS,
                                 seed=11):
        jstate, m = jtr.train_step(jstate, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def jax_tp_pp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_pp_jax")
    out = {}
    for tag, model in (("gpipe", MODEL), ("1f1b", {**MODEL, **F1})):
        npz = str(tmp / f"{tag}.npz")
        out[tag] = (npz, _jax_losses(model, npz))
    return out


def _cli_argv(tmp, tag, batch_size):
    return ["--device", "cpu", "--config", str(tmp / "auto.yaml"),
            "--max_steps", str(STEPS), "--batch_size", str(batch_size),
            "--save_interval", "0", "--keep_last_n", "0",
            "--log_interval", "1", "--eval_interval", "0",
            "--checkpoint_dir", str(tmp / tag),
            "--metrics_jsonl", str(tmp / f"{tag}.jsonl")]


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_tp_pp):
    tmp = tmp_path_factory.mktemp("tp_pp_world4")
    (tmp / "auto.yaml").write_text(AUTO_YAML)
    # A world-1 checkpoint (one step) the tensor 2 x stage 2 ranks restore.
    tr = Trainer(GPTConfig(**{**MODEL, **F1}), TrainingConfig(**TRAIN),
                 device="cpu")
    state = tr.init_state()
    state, _ = tr.train_step(state, next(iter(DummyDataLoader(
        tr.global_batch_size, SEQ, MODEL["vocab_size"], num_batches=1,
        seed=11))))
    ckpt.save_checkpoint(str(tmp / "w1ck"), state,
                         model_config=tr.model_config,
                         training_config=tr.training_config)
    jobs = [
        _job("jax_gpipe", T2S2, params_npz=jax_tp_pp["gpipe"][0]),
        _job("jax_1f1b", T2S2, model={**MODEL, **F1},
             params_npz=jax_tp_pp["1f1b"][0]),
        _job("il", T2S2, model={**MODEL, **IL},
             params_npz=jax_tp_pp["gpipe"][0]),
        _job("f1b", T2S2, model={**MODEL, **F1}, eval=True,
             save_at=[STEPS], save_dir=str(tmp / "ck"),
             restore=ckpt.latest_checkpoint(str(tmp / "w1ck"))),
        _job("gqa", T2S2, model={**MODEL, "num_kv_heads": 2, **F1}),
        _job("odd_vocab", T2S2, model={**ODD_VOCAB, **F1}),
        _job("drop_gpipe", T2S2, model=DROPOUT, steps=2,
             record_dropout=True),
        _job("drop_1f1b", T2S2, model={**DROPOUT, **F1}, steps=2,
             record_dropout=True),
        _job("drop_il", T2S2, model={**DROPOUT, **IL}, steps=2,
             record_dropout=True),
        {"name": "nan", "kind": "nan_scan", "strategy": "replicated",
         "mesh": T2S2, "model": {**MODEL, **F1}, "train": TRAIN},
        {"name": "cli", "kind": "cli",
         "runs": [{"argv": _cli_argv(tmp, "auto", 2) + ["--mesh", "auto"],
                   "mode": "fsdp"}]},
    ]
    out = run_world(tmp, 4, jobs, timeout=300.0)
    out["tmp"] = tmp
    return out


# -- against JAX ---------------------------------------------------------------

@pytest.mark.parametrize("tag", ["gpipe", "1f1b"])
def test_tensor2_stage2_matches_jax(world4, jax_tp_pp, tag):
    for rank in world4[f"jax_{tag}"]:
        np.testing.assert_allclose(rank["losses"], jax_tp_pp[tag][1], **TOL)


def test_interleaved_matches_gpipe(world4, jax_tp_pp):
    """Interleaved (M 2, v 2) from the JAX GPipe run's parameters: the
    GPipe losses."""
    for rank in world4["il"]:
        np.testing.assert_allclose(rank["losses"], jax_tp_pp["gpipe"][1],
                                   **TOL)


# -- against the port's world 1 --------------------------------------------------

@pytest.mark.parametrize("tag,model", [
    ("f1b", MODEL), ("gqa", {**MODEL, "num_kv_heads": 2}),
    ("odd_vocab", ODD_VOCAB)])
def test_matches_world1(world4, tag, model):
    _check_world1(world4[tag], _world1(model))


def test_rank_holds_its_slices(world4):
    """A rank's leaves: its stage's layers, of them its tensor slice."""
    want = _world1(MODEL)["sd"]
    for rank in world4["f1b"]:
        got = rank["final"]
        for key, arr in want.items():
            if not key.startswith("params/"):
                continue
            name = key[len("params/"):].replace("/", ".")
            cut_by_tensor = (name.endswith(("q_proj.kernel", "k_proj.kernel",
                                            "v_proj.kernel", "o_proj.kernel",
                                            "gate_proj.kernel",
                                            "up_proj.kernel",
                                            "down_proj.kernel"))
                             or name == "embed_tokens.embedding")
            share = ((2 if name.startswith("layers.") else 1)
                     * (2 if cut_by_tensor else 1))
            assert got[key].size * share == arr.size, key


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


def test_checkpoint_restores_at_world1(world4):
    """The tensor 2 x stage 2 checkpoint restored at world 1: every array
    the ranks' shards stitch to, bitwise."""
    step_dir = ckpt.latest_checkpoint(str(world4["tmp"] / "ck"))
    tr = Trainer(GPTConfig(**{**MODEL, **F1}), TrainingConfig(**TRAIN),
                 device="cpu")
    state, _ = ckpt.restore_checkpoint(step_dir, tr)
    want = assemble([r["records"] for r in world4["f1b"]])
    sd = state.state_dict()
    assert set(sd) - {"step", "opt_count", "loss_scale", "good_steps"} \
        == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(sd[key], arr, err_msg=key)


def test_world1_checkpoint_restores_at_tensor2_stage2(world4):
    """And back: a world-1 checkpoint restored at tensor 2 x stage 2, each
    rank holding its stage's layers' tensor slices, the stitched arrays
    bitwise the world-1 state."""
    step_dir = ckpt.latest_checkpoint(str(world4["tmp"] / "w1ck"))
    tr = Trainer(GPTConfig(**{**MODEL, **F1}), TrainingConfig(**TRAIN),
                 device="cpu")
    want = ckpt.restore_checkpoint(step_dir, tr)[0].state_dict()
    got = assemble([r["restored_records"] for r in world4["f1b"]])
    assert set(got) == set(want) - {"step", "opt_count", "loss_scale",
                                    "good_steps"}
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
    for r, rank in enumerate(world4["f1b"]):
        q = rank["restored"]["params/layers/attention/q_proj/kernel"]
        t, s = divmod(r, 2)
        full = want["params/layers/attention/q_proj/kernel"]
        cols = full.shape[-1] // 2
        np.testing.assert_array_equal(
            q, full[2 * s:2 * s + 2, :, t * cols:(t + 1) * cols])
        assert rank["restored_scalars"]["step"] == 1


# -- dropout ---------------------------------------------------------------------

def test_dropout_schedules_agree(world4):
    """The same losses and, over each tensor rank's stage pair, the same
    residual masks per (global layer, microbatch) in all three schedules;
    the two ranks of a tensor pair draw the same masks."""
    base = world4["drop_gpipe"]
    for tag in ("drop_1f1b", "drop_il"):
        for a, b in zip(base, world4[tag]):
            np.testing.assert_allclose(b["losses"], a["losses"], rtol=0,
                                       atol=1e-6)
    # Rank t * 2 + s: tensor rank t, stage rank s.
    for t in range(2):
        want = _masks(base[2 * t]) + _masks(base[2 * t + 1])
        assert want
        for tag in ("drop_1f1b", "drop_il"):
            ranks = world4[tag]
            got = _masks(ranks[2 * t]) + _masks(ranks[2 * t + 1])
            assert sorted(got) == sorted(want), tag
    for s in range(2):
        assert _masks(base[s]) == _masks(base[2 + s])


# -- --mesh auto -----------------------------------------------------------------

def _records(path, kind):
    return [r for r in map(json.loads, open(path)) if r.get("kind") == kind]


def test_mesh_auto_trains_and_logs_its_plan(world4, tmp_path):
    """``train_fsdp --mesh auto`` at world 4 (FULL_SHARD, batch 2 a
    device: a global batch of 8 rows held fixed): the losses of the
    world-1 run on the same global batch, a ``mesh_plan`` record with
    ``auto`` naming a four-way mesh, and a ``comms_model`` record on that
    mesh whose crosscheck counted calls on every axis it charged bytes to
    and notes the model's gap on that mesh and nothing else: the trainer
    sums the gradients over the sequence ranks, and the leaves outside the
    layer stack over the stage group, and the model (the JAX arithmetic)
    charges neither axis for those sums."""
    tmp = world4["tmp"]
    plan, = _records(tmp / "auto.jsonl", "mesh_plan")
    assert plan["auto"] is True and plan["devices"] == 4
    chosen = plan["chosen"]["mesh"]
    assert np.prod(list(chosen.values())) == 4
    assert plan["ranked"][0] == plan["chosen"]
    comms, = _records(tmp / "auto.jsonl", "comms_model")
    assert comms["mesh"] == chosen and comms["step"] == 0
    gaps = [ax for ax in ("sequence", "stage") if chosen[ax] > 1]
    assert len(comms["collective_mismatches"]) == len(gaps)
    for ax, note in zip(gaps, comms["collective_mismatches"]):
        assert note.startswith("counted ")
        assert f"of ['all_gather', 'reduce_scatter'] on axis '{ax}'" in note
    for axis, info in comms["per_axis"].items():
        if info["bytes"] > 0:
            assert comms["collective_counts"][axis]["calls"] > 0, axis
    (tmp_path / "auto.yaml").write_text(AUTO_YAML)
    dp = chosen["data"] * chosen["fsdp"]
    assert plan["chosen"]["batch_per_shard"] * dp == 8
    assert cli.run_training(_cli_argv(tmp_path, "one", 8)
                            + ["--no_comms_model"]) == 0
    want = [r["loss"] for r in _records(tmp_path / "one.jsonl", "train")]
    got = [r["loss"] for r in _records(tmp / "auto.jsonl", "train")]
    np.testing.assert_allclose(got, want, **TOL)
    assert not _records(tmp_path / "one.jsonl", "comms_model")
