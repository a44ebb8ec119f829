"""Fault injection through the port's training CLI, end to end
(``tpu_trainer_torch/utils/faults.py`` against ``tpu_trainer/utils/
faults.py``, and ``tests/test_faults.py``'s scenarios on the port).

- The spec parser, one-shot fires and module-level plan equal the JAX
  module's on the same specs.
- Killed runs (``kill``, ``kill_in_save``, and ``truncate_meta`` /
  ``corrupt_shard`` followed by a kill) resume to per-step losses and a
  final ``state.npz`` *bitwise* those of a straight run. Subprocesses are
  mandatory: ``faults.kill()`` is ``os._exit``.
- A ``nan_loss`` rolls back once and finishes; an exhausted rollback
  budget and a NaN before any checkpoint fail; a ``loss_spike`` rolls back
  before any NaN, with telemetry and goodput records in the same run.

Tiny geometry (``tests/test_faults.py``'s ``TINY_YAML``, f32), the CPU.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_trainer_torch.training import cli
from tpu_trainer_torch.utils import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
  learning_rate: 1e-3
  max_steps: 6
  warmup_steps: 1
  log_interval: 1
  eval_interval: 0
  save_interval: 2
distributed:
  mixed_precision: "fp32"
data:
  dataset: "dummy"
"""


@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("yaml") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def run_trainer(tiny_yaml, ckpt_dir, *extra, timeout=240):
    cmd = [sys.executable, "-m", "tpu_trainer_torch.training.train_ddp",
           "--device", "cpu", "--config", tiny_yaml,
           "--checkpoint_dir", str(ckpt_dir), *extra]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout)


def train_losses(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "train":
                out[rec["step"]] = rec["loss"]
    return out


@pytest.fixture(scope="module")
def straight(tiny_yaml, tmp_path_factory):
    """The uninterrupted run every faulted run is held to."""
    d = tmp_path_factory.mktemp("straight")
    r = run_trainer(tiny_yaml, d / "ck", "--no_auto_resume",
                    "--metrics_jsonl", str(d / "m.jsonl"))
    assert r.returncode == 0, r.stderr
    with np.load(d / "ck" / "step_00000006" / "state.npz") as z:
        final = {k: z[k] for k in z.files}
    return train_losses(d / "m.jsonl"), final


# -- the plan ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jfaults():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.utils import faults as jf
    return jf


@pytest.mark.parametrize("spec", [
    "nan_loss@3, kill@5", "kill_in_save@2", "truncate_meta@2,kill@3",
    "corrupt_shard@4,kill@5,sigterm@1", "loss_spike@0,loss_spike@7",
    "kill_host@2,hang_host@3,preempt_notice@4,return_host@5",
])
def test_parse_and_fires_equal_jax(jfaults, spec):
    a, b = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert a.pending() == b.pending()
    for kind, step in a.pending() + [("kill", 99), ("nan_loss", 0)]:
        assert a.fire(kind, step) == b.fire(kind, step)
        assert a.fire(kind, step) == b.fire(kind, step)   # one-shot
    assert a.pending() == b.pending() == []


@pytest.mark.parametrize("bad", ["explode@3", "nan_loss", "nan_loss@-1", "",
                                 "kill@x", "kill@3,,bogus@1"])
def test_parse_rejects_what_jax_rejects(jfaults, bad):
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(bad)


def test_constants_and_host_targets_equal_jax(jfaults, monkeypatch):
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 137
    assert faults.KINDS == jfaults.KINDS
    assert faults.HOST_TARGETED_KINDS == jfaults.HOST_TARGETED_KINDS
    for world in (1, 2, 4):
        assert faults.target_hosts(world) == jfaults.target_hosts(world)
    monkeypatch.setenv("TPU_TRAINER_FAULT_HOST", "0,2")
    assert faults.target_hosts(4) == jfaults.target_hosts(4) == (0, 2)
    assert not faults.targets_host(0, 1)      # inert at one process


def test_module_level_install_clear():
    with faults.plan("nan_loss@1"):
        assert faults.fire("nan_loss", 1)
        assert not faults.fire("nan_loss", 1)
    assert faults.active() is None
    assert not faults.fire("nan_loss", 1)


def test_file_faults(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(200)))
    faults.corrupt_file(str(p))
    data = p.read_bytes()
    assert len(data) == 200 and data[100] == 100 ^ 0xFF and data[0] == 0
    faults.truncate_file(str(p))
    assert p.stat().st_size == 0


# -- kills ---------------------------------------------------------------------

def _kill_case(spec, sync, resumes_at):
    """A case whose id names the latest checkpoint it may resume from;
    ``resumes_at`` is that step dir, None, or a tuple of the allowed
    ones (the first in the id)."""
    first = resumes_at[0] if isinstance(resumes_at, tuple) else resumes_at
    return pytest.param(spec, sync, resumes_at, id=f"{spec}-{sync}-{first}")


@pytest.mark.parametrize("spec,sync,resumes_at", [
    # With the async saver the kill races the writer thread: the commit
    # of the step before the kill may land before it or not
    # (tests/test_faults.py, "the kill races the writer thread").
    _kill_case("kill@3", False, ("step_00000002", None)),
    _kill_case("kill@5", False, ("step_00000004", "step_00000002")),
    _kill_case("kill@5", True, "step_00000004"),
    _kill_case("kill_in_save@2", False, None),
    _kill_case("kill_in_save@4", False, "step_00000002"),
    _kill_case("truncate_meta@2,kill@3", True, None),
    _kill_case("corrupt_shard@2,kill@3", True, None),
    _kill_case("corrupt_shard@4,kill@5", True, "step_00000002"),
])
def test_killed_run_resumes_bitwise(tiny_yaml, tmp_path, straight, spec,
                                    sync, resumes_at):
    want, final = straight
    ck = tmp_path / "ck"
    extra = ["--no_async_checkpointing"] if sync else []
    killed = run_trainer(tiny_yaml, ck, "--inject_fault", spec,
                         "--metrics_jsonl", str(tmp_path / "m1.jsonl"),
                         *extra)
    assert killed.returncode == faults.KILL_EXIT_CODE, killed.stderr
    kind, step = spec.split(",")[0].split("@")
    if kind == "kill_in_save":
        # The interrupted save left the state without meta.json.
        assert os.path.exists(ck / f"step_{int(step):08d}" / "state.npz")
        assert not os.path.exists(ck / f"step_{int(step):08d}" / "meta.json")
    if kind == "truncate_meta":
        assert os.path.getsize(ck / "step_00000002" / "meta.json") == 0

    resumed = run_trainer(tiny_yaml, ck,
                          "--metrics_jsonl", str(tmp_path / "m2.jsonl"))
    assert resumed.returncode == 0, resumed.stderr
    allowed = resumes_at if isinstance(resumes_at, tuple) else (resumes_at,)
    if "resumed from" not in resumed.stdout:
        assert None in allowed, resumed.stdout
    else:
        assert any(f"resumed from {ck / step}" in resumed.stdout
                   for step in allowed if step is not None), resumed.stdout
    if kind == "corrupt_shard":
        assert "quarantined" in resumed.stderr
        assert any(n.startswith(f"step_{int(step):08d}.corrupt")
                   for n in os.listdir(ck))
    got = train_losses(tmp_path / "m1.jsonl")
    got.update(train_losses(tmp_path / "m2.jsonl"))
    assert got == want           # float for float, every step
    with np.load(ck / "step_00000006" / "state.npz") as z:
        assert sorted(z.files) == sorted(final)
        for k in final:
            np.testing.assert_array_equal(z[k], final[k], err_msg=k)


# -- divergence ----------------------------------------------------------------

def _records(path, kind=None):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if kind is None or r.get("kind") == kind]


def test_nan_loss_rolls_back_and_completes(tiny_yaml, tmp_path):
    jsonl = tmp_path / "m.jsonl"
    rc = cli.run_training(["--device", "cpu", "--config", tiny_yaml,
                           "--checkpoint_dir", str(tmp_path / "ck"),
                           "--guard_interval", "1", "--inject_fault",
                           "nan_loss@3", "--flight_recorder_steps", "16",
                           "--metrics_jsonl", str(jsonl)])
    assert rc == 0
    assert faults.active() is None           # the plan is cleared
    rb = _records(jsonl, "rollback")
    assert len(rb) == 1 and rb[0]["restored_step"] == 2
    assert rb[0]["cause"] == "FloatingPointError"
    assert os.path.isdir(tmp_path / "ck" / "step_00000006")
    report = json.load(open(tmp_path / "ck" / "crash_report.json"))
    assert report["reason"] == "rollback:FloatingPointError"
    assert report["snapshot"]["torch_version"]
    assert [r["kind"] for r in report["records"]][-1] == "rollback"
    assert len(report["records"]) <= 16
    final = [r for r in _records(jsonl, "goodput") if r.get("final")]
    assert final and final[0]["checkpoint_restore_seconds"] > 0
    assert final[0].get("rollback_replay_seconds", 0) > 0


def test_rollback_budget_exhaustion_raises(tiny_yaml, tmp_path):
    with pytest.raises(FloatingPointError):
        cli.run_training(["--device", "cpu", "--config", tiny_yaml,
                          "--checkpoint_dir", str(tmp_path / "ck"),
                          "--guard_interval", "1", "--inject_fault",
                          "nan_loss@1", "--max_rollbacks", "0"])
    report = json.load(open(tmp_path / "ck" / "crash_report.json"))
    assert report["reason"] == "divergence"
    assert report["exception"]["type"] == "FloatingPointError"


def test_nan_before_any_checkpoint_fails(tiny_yaml, tmp_path, capsys):
    with pytest.raises(FloatingPointError):
        cli.run_training(["--device", "cpu", "--config", tiny_yaml,
                          "--checkpoint_dir", str(tmp_path / "ck"),
                          "--guard_interval", "1", "--save_interval", "100",
                          "--inject_fault", "nan_loss@0"])
    assert "no valid checkpoint" in capsys.readouterr().out


def test_loss_spike_rolls_back_before_divergence(tiny_yaml, tmp_path,
                                                  capsys):
    """``tests/test_telemetry.py``'s end-to-end run on the port: telemetry
    steps, goodput records, and an injected spike that rolls back before
    any NaN reaches the log."""
    jsonl = tmp_path / "m.jsonl"
    rc = cli.run_training([
        "--device", "cpu", "--config", tiny_yaml, "--checkpoint_dir",
        str(tmp_path / "ck"), "--metrics_jsonl", str(jsonl),
        "--max_steps", "28", "--save_interval", "5",
        "--telemetry_interval", "5", "--spike_sigma", "6",
        "--inject_fault", "loss_spike@22"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loss spike at step 22" in out and "rollback 1/" in out
    recs = _records(jsonl)
    train = [r for r in recs if r.get("kind") == "train"]
    assert all(math.isfinite(r["loss"]) for r in train)
    assert any(r["step"] == 22 and r["loss"] > 20 for r in train)
    assert max(r["step"] for r in train) == 27
    tel = [r for r in train if any(k.startswith("telemetry/") for k in r)]
    assert tel
    for key in ("telemetry/grad_norm/per_layer/L00",
                "telemetry/act/attn_rms/L00", "telemetry/act/ffn_absmax/L00",
                "telemetry/param_norm/embed_tokens",
                "telemetry/update_ratio/per_layer/L00"):
        assert key in tel[0], key
    goodput = [r for r in recs if r.get("kind") == "goodput"]
    for g in goodput:
        tracked = sum(v for k, v in g.items() if k.endswith("_frac")
                      and k not in ("productive_frac", "untracked_frac"))
        assert tracked <= 1.0 + 1e-6
    assert [g for g in goodput if g.get("final")][-1][
        "checkpoint_restore_seconds"] > 0
    # Eager PyTorch: no recompile and no cost-analysis records.
    assert not [r for r in recs if r.get("kind") in ("recompile",
                                                     "cost_analysis")]
