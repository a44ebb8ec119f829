"""The port's training CLI (``tpu_trainer_torch/training/cli.py``).

- ``resolve_configs`` gives the JAX CLI's values on ``TINY_YAML`` and on
  every ``configs/*.yaml``; the YAML reader equals ``yaml.safe_load``.
- End to end against the JAX CLI: the same tiny yaml (``TINY_YAML``'s
  widths, vocab 50257 for the byte tokenizer), the same temporary corpus,
  the same initial weights (the port resumes from a step-0 checkpoint of
  the JAX trainer's ``init_state()`` params). Train loss, grad norm and lr
  agree at rtol = 1e-4, eval loss too (the bounds of
  ``tests/test_torch_train.py``). The JAX run is 8-way data parallel over
  the test harness's 8 CPU devices, so the port's micro-batch is 8x the
  yaml's: the same rows per step.
- Resume through the CLI is bitwise (dropout on); a NaN loss rolls back
  once; SIGTERM saves and exits 143; options of later ROADMAP items raise.
- ``mode="fsdp"`` (``train_fsdp``), as ``tests/test_cli.py`` pins the JAX
  one: the reference sharding spellings, activation checkpointing on by
  default, the offload flags from the command line and from YAML, an
  unknown YAML dtype rejected, every shipped config resolving to the JAX
  CLI's values; three tiny ``train_fsdp`` steps (remat on) whose losses
  are within rtol 1e-4 of the JAX ``train_fsdp``'s (8-way FSDP there, the
  same rows per step here), and a host-offloaded f32 run equal to it.
"""

import dataclasses
import glob
import json
import os
import shutil
import signal

import numpy as np
import pytest

from tpu_trainer_torch.training import cli
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_cli.py's TINY_YAML.
TINY_YAML = """
model:
  name: "gpt2-small"
  vocab_size: 128
  hidden_size: 32
  num_layers: 1
  num_heads: 2
  intermediate_size: 64
  max_seq_len: 32
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: false
training:
  batch_size: 2
  gradient_accumulation_steps: 2
  learning_rate: 1e-3
  max_steps: 3
  warmup_steps: 1
  log_interval: 10
  eval_interval: 100
  save_interval: 100
distributed:
  mixed_precision: "fp32"
data:
  dataset: "dummy"
"""

TEXT_YAML = TINY_YAML.replace("vocab_size: 128", "vocab_size: 50257")
# Dropout on and the flash dispatch, for the resume and rollback runs.
DROP_YAML = (TEXT_YAML.replace("dropout: 0.0", "dropout: 0.1")
             .replace("use_flash_attention: false",
                      "use_flash_attention: true"))


def _corpus(path, n=220, seed=11):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    with open(path, "w") as f:
        for _ in range(n):
            f.write("".join(rng.choice(letters, rng.integers(10, 60)))
                    + "\n")
    return str(path)


def _records(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


@pytest.fixture
def yaml_file(tmp_path):
    def make(text, name="t.yaml"):
        p = tmp_path / name
        p.write_text(text)
        return str(p)
    return make


# -- configs ---------------------------------------------------------------

CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS + ["TINY_YAML"],
                         ids=lambda p: os.path.basename(p))
def test_yaml_reader_equals_safe_load(path):
    yaml = pytest.importorskip("yaml")
    text = TINY_YAML if path == "TINY_YAML" else open(path).read()
    assert cli.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\n", "a: *x\n",
    "a: !!str 1\n", "a: |\n  x\n", "a: 0x10\n", "a: 017\n", "a: .inf\n",
    "a:\n\tb: 1\n", "a: 1\na: 2\n", "  a: 1\n", "---\na: 1\n",
])
def test_yaml_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        cli.parse_yaml(text)


@pytest.mark.parametrize("path", CONFIGS + ["TINY_YAML"],
                         ids=lambda p: os.path.basename(p))
def test_resolve_configs_matches_jax(path, yaml_file):
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.training import cli as jcli

    if path == "TINY_YAML":
        path = yaml_file(TINY_YAML)
    argv = ["--config", path, "--max_steps", "7", "--tokenizer", "byte"]
    jm, jt, _, jd = jcli.resolve_configs(
        jcli.build_parser("ddp").parse_args(argv), "ddp")
    tm, tt, _, td = cli.resolve_configs(cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jtd = dataclasses.asdict(jt)
    assert dataclasses.asdict(tt) == {k: jtd[k] for k in
                                      dataclasses.asdict(tt)}
    assert td == jd


# -- end to end against the JAX CLI ------------------------------------------

def test_cli_matches_jax_cli(tmp_path, yaml_file):
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax

    from tpu_trainer.training import cli as jcli
    from tpu_trainer.training.trainer import Trainer as JTrainer
    from tpu_trainer_torch.models.weights import from_jax_params

    yaml = yaml_file(TEXT_YAML)
    corpus = _corpus(tmp_path / "stories.txt")
    common = ["--config", yaml, "--dataset", "tinystories", "--data_path",
              corpus, "--tokenizer", "byte", "--max_steps", "4",
              "--eval_interval", "2", "--log_interval", "1",
              "--save_interval", "0", "--eval_split", "0.25"]
    jargv = common + ["--checkpoint_dir", str(tmp_path / "j"),
                      "--metrics_jsonl", str(tmp_path / "j.jsonl")]
    assert jcli.run_training(jargv, mode="ddp") == 0

    # The JAX trainer's initial params, as a port step-0 checkpoint.
    jm, jt, jp, _ = jcli.resolve_configs(
        jcli.build_parser("ddp").parse_args(jargv), "ddp")
    jparams = jax.tree.map(np.asarray, JTrainer(jm, jt, jp).init_state()
                           .params)
    dp = jax.device_count()
    targv = common + ["--batch_size", str(2 * dp), "--device", "cpu",
                      "--checkpoint_dir", str(tmp_path / "t"),
                      "--metrics_jsonl", str(tmp_path / "t.jsonl")]
    tm, tt, _, _ = cli.resolve_configs(
        cli.build_parser().parse_args(targv))
    trainer = Trainer(tm, tt, device="cpu")
    state = trainer.init_state(params=from_jax_params(jparams,
                                                      trainer.model_config,
                                                      device="cpu"))
    ckpt.save_checkpoint(tt.checkpoint_dir, state, model_config=tm,
                         training_config=tt)
    assert cli.run_training(targv) == 0

    for kind, keys in (("train", ("loss", "grad_norm", "lr")),
                       ("eval", ("eval_loss",))):
        want = _records(tmp_path / "j.jsonl", kind)
        got = _records(tmp_path / "t.jsonl", kind)
        assert [r["step"] for r in got] == [r["step"] for r in want]
        assert len(got) == (4 if kind == "train" else 2)
        for key in keys:
            np.testing.assert_allclose([r[key] for r in got],
                                       [r[key] for r in want], rtol=1e-4,
                                       err_msg=f"{kind} {key}")
        if kind == "eval":
            assert [r["eval_batches"] for r in got] == [
                r["eval_batches"] for r in want]


# -- resume, rollback, SIGTERM -------------------------------------------------

def _drop_argv(tmp_path, yaml_file, tag, *extra):
    return ["--config", yaml_file(DROP_YAML, "drop.yaml"), "--dataset",
            "tinystories", "--data_path",
            _corpus(tmp_path / "stories.txt", n=300), "--tokenizer", "byte",
            "--log_interval", "1", "--eval_interval", "4", "--device", "cpu",
            "--checkpoint_dir", str(tmp_path / tag),
            "--metrics_jsonl", str(tmp_path / f"{tag}.jsonl"), *extra]


def test_cli_resume_is_bitwise(tmp_path, yaml_file):
    """8 steps == 4 steps, a new run resuming from step 4, 4 steps: the
    step-8 state (params, moments, generator) and the losses of steps 5-8
    bitwise, with dropout on and both prefetchers running ahead."""
    argv = _drop_argv(tmp_path, yaml_file, "a", "--max_steps", "8",
                      "--save_interval", "4", "--keep_last_n", "0")
    assert cli.run_training(argv) == 0
    step8 = str(tmp_path / "a" / "step_00000008")
    shutil.copytree(step8, tmp_path / "copy")
    shutil.rmtree(step8)
    assert cli.run_training(argv) == 0
    with np.load(f"{step8}/state.npz") as a, np.load(
            tmp_path / "copy" / "state.npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    meta, want = ckpt.load_meta(step8), ckpt.load_meta(tmp_path / "copy")
    assert meta == want and meta["data_state"]["batch_index"] == 8
    train = _records(tmp_path / "a.jsonl", "train")
    assert [r["step"] for r in train] == list(range(8)) + [4, 5, 6, 7]
    assert [r["loss"] for r in train[4:8]] == [r["loss"] for r in train[8:]]
    assert train[0]["loss"] != train[1]["loss"]


def _patch_step(monkeypatch, action):
    """Wrap ``Trainer.train_step``: ``action(step_before, metrics)`` may
    change the metrics; returns the batches the steps consumed."""
    original = Trainer.train_step
    seen = []

    def step(self, state, batch, *args, **kwargs):
        before = state.step
        seen.append(np.asarray(batch).copy())
        state, metrics = original(self, state, batch, *args, **kwargs)
        return state, action(before, metrics) or metrics

    monkeypatch.setattr(Trainer, "train_step", step)
    return seen


def test_nan_loss_rolls_back_once(tmp_path, yaml_file, monkeypatch):
    """A NaN at step 5 restores step 4, skips the diverging batch, halves
    the LR (a new Trainer) and logs one rollback record."""
    fired = []

    def nan_at_5(step, metrics):
        if step == 5 and not fired:
            fired.append(step)
            return dict(metrics, loss=float("nan"))

    seen = _patch_step(monkeypatch, nan_at_5)
    argv = _drop_argv(tmp_path, yaml_file, "r", "--max_steps", "8",
                      "--save_interval", "2", "--guard_interval", "1",
                      "--prefetch", "0", "--device_prefetch_depth", "0")
    assert cli.run_training(argv) == 0
    recs = _records(tmp_path / "r.jsonl", "rollback")
    assert len(recs) == 1
    assert recs[0]["restored_step"] == 4 and recs[0]["step"] == 5
    assert recs[0]["lr_backoff"] == 0.5 and recs[0]["cause"] == \
        "FloatingPointError"
    # Steps 0-5 on batches 0-5, then steps 4-7 on batches 6-9: the
    # diverging batch 5 is not replayed.
    from tpu_trainer_torch.data.tinystories import (
        create_tinystories_dataloader)
    data = list(create_tinystories_dataloader(
        str(tmp_path / "stories.txt"), 4, 32, tokenizer_name="byte",
        eval_split=0.02, prefetch=0))
    assert len(seen) == 10
    for got, want in zip(seen, data):
        np.testing.assert_array_equal(got.reshape(want.shape), want)
    train = _records(tmp_path / "r.jsonl", "train")
    lr = {r["step"]: r["lr"] for r in train}
    tc = dataclasses.replace(cli.resolve_configs(
        cli.build_parser().parse_args(argv))[1], learning_rate=5e-4)
    for s in (4, 5, 6, 7):
        assert lr[s] == pytest.approx(tc.lr_at(s), rel=1e-6)
    assert ckpt.latest_checkpoint(str(tmp_path / "r")).endswith("00000008")


def test_persistent_nan_gives_up(tmp_path, yaml_file, monkeypatch):
    _patch_step(monkeypatch, lambda step, m: dict(m, loss=float("nan"))
                if step >= 3 else None)
    argv = _drop_argv(tmp_path, yaml_file, "g", "--max_steps", "8",
                      "--save_interval", "2", "--guard_interval", "1",
                      "--max_rollbacks", "1")
    with pytest.raises(FloatingPointError):
        cli.run_training(argv)
    assert len(_records(tmp_path / "g.jsonl", "rollback")) == 1


def test_sigterm_saves_and_exits_143(tmp_path, yaml_file, monkeypatch):
    def term_at_2(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    _patch_step(monkeypatch, term_at_2)
    argv = _drop_argv(tmp_path, yaml_file, "s", "--max_steps", "8",
                      "--save_interval", "0")
    handler = signal.getsignal(signal.SIGTERM)
    assert cli.run_training(argv) == 143
    assert signal.getsignal(signal.SIGTERM) == handler
    path = ckpt.latest_checkpoint(str(tmp_path / "s"))
    assert path.endswith("step_00000003")
    assert ckpt.load_meta(path)["data_state"]["batch_index"] == 3


# -- the mesh options -----------------------------------------------------------

# The pipeline runs: at one process a 2-way stage axis beside the
# default data=-1 is the JAX world-size error.
_STAGE = (SystemExit, "1 devices not divisible by fixed axes product 2")


@pytest.mark.parametrize("extra,item", [
    # The planner picks every axis: an explicit split beside it is the
    # JAX CLI's error.
    (["--mesh", "auto", "--mesh_tensor", "2"],
     (SystemExit, "--mesh auto and explicit --mesh_tensor are mutually "
                  "exclusive")),
    (["--mesh", "auto", "--mesh_data", "1"],
     (SystemExit, "--mesh auto and explicit --mesh_data are mutually "
                  "exclusive")),
    (["--mesh", "auto", "--mesh_stage", "2", "--mesh_fsdp", "2"],
     (SystemExit, "--mesh auto and explicit --mesh_fsdp/--mesh_stage are "
                  "mutually exclusive")),
    # Tensor and sequence parallelism run; at one process a 2-way axis
    # beside the default data=-1 is the JAX world-size error.
    (["--mesh_tensor", "2"],
     (SystemExit, "1 devices not divisible by fixed axes product 2")),
    # Data parallelism runs; at one process a 4-way mesh is the JAX
    # world-size error.
    (["--mesh_data", "4"], (SystemExit, "wants 4 devices but 1 are")),
    (["--multihost"], (RuntimeError, "--multihost needs a rendezvous")),
    (["--mesh_stage", "2", "--pipeline_microbatches", "2"], _STAGE),
    (["--mesh_fsdp", "2"],
     (SystemExit, "1 devices not divisible by fixed axes product 2")),
    (["--mesh_sequence", "2"],
     (SystemExit, "1 devices not divisible by fixed axes product 2")),
    # Expert parallelism runs: at one process a 2-way expert axis beside
    # the default data=-1 is the JAX world-size error (a dense model's
    # expert axis is the JAX trainer's ValueError at world 2,
    # tests/test_torch_expert_parallel.py).
    (["--mesh_expert", "2"],
     (SystemExit, "1 devices not divisible by fixed axes product 2")),
    (["--mesh_stage", "2"], _STAGE),
])
def test_later_item_options_raise(extra, item):
    exc, match = item
    with pytest.raises(exc, match=match):
        cli.run_training(["--device", "cpu", "--max_steps", "1"] + extra)


@pytest.mark.parametrize("axes,world", [
    ({"mesh_tensor": 3}, 3), ({"mesh_stage": 3}, 3),
    ({"mesh_sequence": 2, "mesh_data": 1}, 2)])
def test_infeasible_explicit_split_is_the_jax_error(yaml_file, axes, world):
    """An explicit split the model cannot take fails before the trainer
    is built, with the JAX CLI's message (its planner's
    ``feasibility_error``): 2 heads at tensor 3, 1 layer at stage 3, 15
    positions over 2 sequence ranks."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.parallel import planner as jplanner
    from tpu_trainer.training import cli as jcli

    argv = ["--config", yaml_file(TINY_YAML.replace("max_seq_len: 32",
                                                    "max_seq_len: 15"))]
    for k, v in axes.items():
        argv += [f"--{k}", str(v)]
    mc, tc, pc, opts = cli.resolve_configs(cli.build_parser().parse_args(
        argv))
    jm, jt, jp, _ = jcli.resolve_configs(jcli.build_parser("ddp").parse_args(
        argv), "ddp")
    sizes = dict(zip(("data", "fsdp", "sequence", "tensor", "expert",
                      "stage"), jp.mesh.resolve(world)))
    err = jplanner.feasibility_error(
        sizes, jm, n_devices=world,
        global_rows=jt.batch_size * sizes["data"] * sizes["fsdp"],
        max_seq_len=jt.max_seq_len)
    assert err
    with pytest.raises(SystemExit) as got:
        cli.plan_mesh(mc, tc, pc, opts, world, "cpu")
    assert str(got.value).startswith(
        f"mesh: infeasible split {tuple(sizes.values())} "
        f"(dataxfsdpxsequencextensorxexpertxstage): {err} — ")


def _kinds(path):
    return [r.get("kind") for r in map(json.loads, open(path))]


@pytest.mark.parametrize("extra,plan,comms", [
    (["--mesh", "auto"], True, True),
    (["--mesh", "auto", "--hbm_gb", "40"], True, True),
    (["--no_comms_model"], False, False),
])
def test_planner_options_run(tmp_path, yaml_file, extra, plan, comms):
    """``--mesh auto`` trains a step at one process on the one mesh there
    is and logs its ``mesh_plan`` record (``--hbm_gb`` its budget); the
    first step writes the ``comms_model`` record unless
    ``--no_comms_model``."""
    jsonl = tmp_path / "m.jsonl"
    assert cli.run_training(
        ["--device", "cpu", "--config", yaml_file(TINY_YAML),
         "--max_steps", "1", "--log_interval", "1",
         "--checkpoint_dir", str(tmp_path / "ck"),
         "--metrics_jsonl", str(jsonl)] + extra) == 0
    kinds = _kinds(jsonl)
    assert ("mesh_plan" in kinds) == plan
    assert ("comms_model" in kinds) == comms
    assert "train" in kinds
    if plan:
        rec, = [r for r in map(json.loads, open(jsonl))
                if r.get("kind") == "mesh_plan"]
        assert rec["auto"] is True and rec["devices"] == 1
        assert rec["chosen"]["mesh"] == dict.fromkeys(
            ("data", "fsdp", "sequence", "tensor", "expert", "stage"), 1)
        assert rec["hbm_budget_gb"] == (40.0 if "--hbm_gb" in extra
                                        else None)


def test_pipeline_microbatches_at_one_process(tmp_path, yaml_file):
    """At stage 1 the JAX trainer ignores ``pipeline_microbatches`` (it
    checks it only under a stage axis): the option is accepted and the
    run equals a run without it."""
    losses = []
    for tag, extra in (("plain", []), ("micro", ["--pipeline_microbatches",
                                                 "2"])):
        jsonl = tmp_path / f"{tag}.jsonl"
        assert cli.run_training(
            ["--device", "cpu", "--config", yaml_file(TINY_YAML),
             "--max_steps", "2", "--log_interval", "1",
             "--checkpoint_dir", str(tmp_path / tag),
             "--metrics_jsonl", str(jsonl)] + extra) == 0
        losses.append([r["loss"] for r in map(json.loads, open(jsonl))
                       if r.get("kind") == "train"])
    assert len(losses[0]) == 2 and losses[0] == losses[1]


def test_num_experts_trains_a_step(tmp_path, yaml_file, capsys):
    """``--num_experts 4`` on the tiny yaml: the capacity router (the
    default ``moe_impl``) takes one step, and the startup line names it."""
    assert cli.run_training(
        ["--device", "cpu", "--config", yaml_file(TINY_YAML),
         "--num_experts", "4", "--max_steps", "1",
         "--checkpoint_dir", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert ("MoE: 4 experts, top-1, capacity router, gather dispatch, "
            "capacity factor 1.25") in out
    assert ckpt.latest_checkpoint(str(tmp_path / "ck")).endswith(
        "step_00000001")


def test_standby_file_raises_naming_item_5(monkeypatch, tmp_path, yaml_file,
                                          capsys):
    """A standby (``TPU_TRAINER_STANDBY_FILE``, the elastic supervisor's
    warm spare) parks before the rendezvous until its activation file
    names its rank, then trains; before the elastic slice it raised."""
    path = tmp_path / "standby"
    path.write_text(json.dumps({"env": {"PROCESS_ID": "0",
                                        "NUM_PROCESSES": "1"}}))
    monkeypatch.setenv("TPU_TRAINER_STANDBY_FILE", str(path))
    # The promotion writes these into the environment: set them first so
    # that the monkeypatch removes them again (a later test's JAX CLI
    # would read them as a rendezvous).
    for key in ("PROCESS_ID", "NUM_PROCESSES"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    assert cli.run_training(["--config", yaml_file(TINY_YAML), "--device",
                             "cpu", "--max_steps", "1", "--checkpoint_dir",
                             str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "standby: parked before rendezvous" in out
    assert "standby: promoted to rank 0 (world 1)" in out


@pytest.mark.parametrize("extra", [
    ["--data_mixture", "dummy:1"],
    ["--inject_fault", "nan_loss@2"],
    ["--telemetry_interval", "5"],
    ["--spike_sigma", "3"],
    ["--flight_recorder_steps", "8"],
    ["--nan_scan"],
    ["--profile_dir", "prof"],
    ["--profile_start", "2", "--profile_steps", "1"],
    ["--metrics_port", "0"],
    ["--preempt_notice", "file:notice"],
    ["--preempt_notice_poll_s", "0.5", "--preempt_vote_interval", "1"],
    ["--preemption_grace_s", "5"],
])
def test_fault_tolerance_and_telemetry_options_are_supported(extra):
    """The fault-tolerance and telemetry options resolve and their run's
    mesh plans at one process (runs of them are in ``test_torch_faults.py``
    and its neighbours)."""
    args = cli.build_parser().parse_args(["--device", "cpu"] + extra)
    mc, tc, pc, opts = cli.resolve_configs(args)
    assert cli.plan_mesh(mc, tc, pc, opts, 1, "cpu") == (tc, pc, None)


def test_heartbeat_and_notice_env_are_supported(monkeypatch, tmp_path):
    monkeypatch.setenv("TPU_TRAINER_HEARTBEAT_DIR", str(tmp_path / "hb"))
    monkeypatch.setenv("TPU_TRAINER_PREEMPT_NOTICE", "file:notice")
    args = cli.build_parser().parse_args(["--device", "cpu"])
    mc, tc, pc, opts = cli.resolve_configs(args)
    assert cli.plan_mesh(mc, tc, pc, opts, 1, "cpu") == (tc, pc, None)


def test_train_fsdp_mode_and_missing_cuda_raise():
    import torch

    for extra, match in (
            (["--sharding", "HYBRID_SHARD"], "needs an explicit mesh split"),
            (["--mesh_fsdp", "2"], "wants 2 devices but 1 are")):
        with pytest.raises(SystemExit, match=match):
            cli.run_training(["--device", "cpu"] + extra, mode="fsdp")
    if not torch.cuda.is_available():
        from tpu_trainer_torch.training.train_ddp import main
        from tpu_trainer_torch.training.train_fsdp import main as fsdp_main

        for entry in (main, fsdp_main):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                entry(["--max_steps", "1", "--model_size", "small"])


# -- train_fsdp ------------------------------------------------------------------

def _fsdp(argv):
    return cli.resolve_configs(cli.build_parser("fsdp").parse_args(argv),
                               "fsdp")


@pytest.mark.parametrize("spelling", ["FULL_SHARD", "SHARD_GRAD_OP",
                                      "NO_SHARD", "zero3", "ddp"])
def test_fsdp_mode_reference_spellings(spelling, yaml_file):
    _, _, par, _ = _fsdp(["--config", yaml_file(TINY_YAML), "--sharding",
                          spelling])
    assert par.sharding_strategy == spelling
    _, _, par, _ = _fsdp(["--config", yaml_file(TINY_YAML)])
    assert par.sharding_strategy == "FULL_SHARD"
    _, _, par, _ = cli.resolve_configs(cli.build_parser().parse_args([]))
    assert par.sharding_strategy == "replicated"


def test_fsdp_activation_checkpointing_default_on(yaml_file):
    path = yaml_file(TINY_YAML)
    assert _fsdp(["--config", path])[0].gradient_checkpointing
    assert not _fsdp(["--config", path, "--no_activation_checkpointing"])[
        0].gradient_checkpointing
    assert not cli.resolve_configs(cli.build_parser().parse_args(
        ["--config", path]))[0].gradient_checkpointing
    # The yaml's own setting stands.
    off = yaml_file(TINY_YAML.replace(
        "  use_flash_attention: false",
        "  use_flash_attention: false\n  gradient_checkpointing: false"),
        "off.yaml")
    assert not _fsdp(["--config", off])[0].gradient_checkpointing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_offload_flags_reach_parallel_config(dtype, yaml_file):
    _, _, par, _ = _fsdp(["--config", yaml_file(TINY_YAML), "--cpu_offload",
                          "--offload_dtype", dtype, "--offload_budget_gb",
                          "0.25"])
    assert par.cpu_offload and par.offload_dtype == dtype
    assert par.offload_budget_gb == 0.25
    with pytest.raises(SystemExit):          # fsdp-only flags
        cli.build_parser().parse_args(["--cpu_offload"])


def test_offload_options_from_yaml(yaml_file):
    path = yaml_file(TINY_YAML + "fsdp:\n  cpu_offload: true\n"
                     "  offload_dtype: \"int8\"\n  offload_budget_gb: 0.5\n"
                     "  sharding_strategy: \"SHARD_GRAD_OP\"\n")
    _, _, par, _ = _fsdp(["--config", path])
    assert (par.cpu_offload, par.offload_dtype, par.offload_budget_gb,
            par.sharding_strategy) == (True, "int8", 0.5, "SHARD_GRAD_OP")
    _, _, par, _ = _fsdp(["--config", path, "--offload_dtype", "bfloat16"])
    assert par.offload_dtype == "bfloat16"


@pytest.mark.parametrize("key,value", [("offload_dtype", "int16"),
                                       ("sharding_strategy", "ZERO4")])
def test_fsdp_yaml_rejects_unknown(key, value, yaml_file):
    path = yaml_file(TINY_YAML + f"fsdp:\n  cpu_offload: true\n"
                     f"  {key}: \"{value}\"\n")
    with pytest.raises(SystemExit):
        _fsdp(["--config", path])


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_fsdp_resolve_configs_matches_jax(path):
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.training import cli as jcli

    argv = ["--config", path, "--cpu_offload", "--offload_dtype", "int8"]
    jm, jt, jp, _ = jcli.resolve_configs(
        jcli.build_parser("fsdp").parse_args(argv), "fsdp")
    tm, tt, tp, _ = _fsdp(argv)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    jtd = dataclasses.asdict(jt)
    assert dataclasses.asdict(tt) == {k: jtd[k]
                                      for k in dataclasses.asdict(tt)}
    for f in ("sharding_strategy", "cpu_offload", "offload_dtype",
              "offload_budget_gb"):
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("name,mode", [
    ("medium_model.yaml", "fsdp"), ("large_1b_single_chip.yaml", "ddp")])
def test_remat_and_narrow_state_configs_are_supported(name, mode):
    """The two configs of remat and narrow moments pass the mesh check at
    one process and build a trainer (meta parameters: nothing
    allocated)."""
    argv = ["--config", os.path.join(ROOT, "configs", name)]
    args = cli.build_parser(mode).parse_args(argv)
    model, train, par, data = cli.resolve_configs(args, mode)
    assert cli.plan_mesh(model, train, par, data, 1, "cpu")[2] is None
    assert model.gradient_checkpointing
    trainer = Trainer(model, train, par, device="cpu")
    assert trainer.optimizer.state_dtype == train.optimizer_state_dtype


def test_train_fsdp_matches_jax_cli(tmp_path, yaml_file):
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax

    from tpu_trainer.training import cli as jcli
    from tpu_trainer.training.trainer import Trainer as JTrainer
    from tpu_trainer_torch.models.weights import from_jax_params
    from tpu_trainer_torch.training import train_fsdp

    yaml = yaml_file(TEXT_YAML)
    corpus = _corpus(tmp_path / "stories.txt")
    common = ["--config", yaml, "--dataset", "tinystories", "--data_path",
              corpus, "--tokenizer", "byte", "--max_steps", "3",
              "--eval_interval", "0", "--log_interval", "1",
              "--save_interval", "0", "--eval_split", "0.25",
              "--sharding", "FULL_SHARD"]
    jargv = common + ["--checkpoint_dir", str(tmp_path / "j"),
                      "--metrics_jsonl", str(tmp_path / "j.jsonl")]
    assert jcli.run_training(jargv, mode="fsdp") == 0
    jm, jt, jp, _ = jcli.resolve_configs(
        jcli.build_parser("fsdp").parse_args(jargv), "fsdp")
    assert jm.gradient_checkpointing
    jparams = jax.tree.map(np.asarray, JTrainer(jm, jt, jp).init_state()
                           .params)
    dp = jax.device_count()
    runs = {}
    for tag, extra in (("t", []), ("o", ["--cpu_offload"])):
        targv = common + extra + [
            "--batch_size", str(2 * dp), "--device", "cpu",
            "--checkpoint_dir", str(tmp_path / tag),
            "--metrics_jsonl", str(tmp_path / f"{tag}.jsonl")]
        tm, tt, tp, _ = _fsdp(targv)
        trainer = Trainer(tm, tt, tp, device="cpu")
        state = trainer.init_state(params=from_jax_params(
            jparams, trainer.model_config, device="cpu"))
        ckpt.save_checkpoint(tt.checkpoint_dir, state, model_config=tm,
                             training_config=tt)
        assert train_fsdp.main(targv) == 0
        runs[tag] = _records(tmp_path / f"{tag}.jsonl", "train")
    want = _records(tmp_path / "j.jsonl", "train")
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([r[key] for r in runs["t"]],
                                   [r[key] for r in want], rtol=1e-4,
                                   err_msg=key)
        assert [r[key] for r in runs["o"]] == [r[key] for r in runs["t"]]
    assert [r["step"] for r in runs["t"]] == [0, 1, 2]
