"""The port's run analyzer (``tpu_trainer_torch/tools/analyze.py``, a copy
that runs without JAX) against ``tpu_trainer/tools/analyze.py``: on the
same JSONL files, records written by either package, the report, the
rendered text, the ``--compare`` verdicts and the exit codes are equal.
"""

import json
import os
import subprocess
import sys

import pytest

from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.tools import analyze
from tpu_trainer_torch.training import cli
from tpu_trainer_torch.utils import telemetry as ttel
from tpu_trainer_torch.utils.logging import SCHEMA_VERSION, MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jan():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.tools import analyze as ja
    return ja


def _run_records(tok=1000.0, n=6, mfu=0.4, mem=10.0, loss=3.0,
                 version=SCHEMA_VERSION):
    recs = []
    for i in range(n):
        recs.append({
            "kind": "train", "schema_version": version, "step": i * 10,
            "loss": loss - 0.01 * i, "tokens_per_sec": tok,
            "elapsed_s": 5.0 + 2.0 * i, "mfu": mfu, "peak_mem_gb": mem})
    recs.append({
        "kind": "goodput", "schema_version": version, "final": True,
        "total_seconds": 100.0, "productive_frac": 0.9, "step_frac": 0.9,
        "data_wait_frac": 0.05, "untracked_frac": 0.05})
    return recs


def _extras():
    v = SCHEMA_VERSION
    return [
        {"kind": "recompile", "schema_version": v, "step": 30,
         "executables": 2, "new_executables": 1,
         "batch_abstract": "int32[2,16]", "storm": True},
        {"kind": "rollback", "schema_version": v, "step": 40,
         "cause": "FloatingPointError", "restored_step": 35},
        {"kind": "eval", "schema_version": v, "step": 50, "eval_loss": 2.5,
         "perplexity": 12.18, "eval_batches": 4},
        {"kind": "train", "schema_version": v, "step": 55, "loss": 2.9,
         "tokens_per_sec": 990.0, "elapsed_s": 17.0,
         "telemetry/router/drop_frac/L00": 0.0,
         "telemetry/router/dropless/L00": 1.0,
         "telemetry/grad_norm/per_layer/L00": 0.5},
        {"kind": "nan_scan", "schema_version": v, "step": 0,
         "first_nan": {"site": "attn", "layer": 5}, "sites": []},
    ]


def _write(path, records):
    with open(path, "w") as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")
    return str(path)


def _port_cli_jsonl(tmp_path):
    """A real port run: telemetry steps, goodput, a NaN rollback."""
    yaml = tmp_path / "t.yaml"
    yaml.write_text(TINY_YAML)
    jsonl = tmp_path / "port.jsonl"
    assert cli.run_training([
        "--device", "cpu", "--config", str(yaml), "--checkpoint_dir",
        str(tmp_path / "ck"), "--metrics_jsonl", str(jsonl),
        "--telemetry_interval", "2", "--inject_fault", "nan_loss@5",
        "--guard_interval", "1"]) == 0
    return str(jsonl)


def _logger_jsonl(path, logger_cls, ledger_cls, cfg):
    """The same calls into either package's MetricLogger and ledger."""
    t = [0.0]
    ledger = ledger_cls(clock=lambda: t[0])
    kw = dict(tokens_per_step=4096, log_interval=2, jsonl_path=str(path),
              stdout=False)
    logger = logger_cls(cfg, **kw)
    for step in range(8):
        with ledger.track("compile" if step == 0 else "step"):
            t[0] += 0.5
        ledger.add_tokens(4096)
        logger.log(step, {"loss": 4.0 - 0.1 * step, "lr": 1e-3,
                          "grad_norm": 1.0})
        if step == 3:
            logger.log_eval(step, 3.5, 2)
            logger.log_record({"kind": "rollback", "step": step,
                               "cause": "LossSpikeError",
                               "restored_step": 2})
    logger.log_record(ledger.record(step=8, final=True))
    logger.close()
    return str(path)


TINY_YAML = """
model:
  name: "gpt2-small"
  vocab_size: 128
  hidden_size: 32
  num_layers: 2
  num_heads: 2
  intermediate_size: 64
  max_seq_len: 32
  dropout: 0.0
  attention_dropout: 0.0
  use_flash_attention: false
training:
  batch_size: 2
  learning_rate: 1e-3
  max_steps: 8
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
def runs(tmp_path_factory, jan):
    """JSONL files from both packages and synthetic ones."""
    d = tmp_path_factory.mktemp("runs")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.utils import telemetry as jtel
    from tpu_trainer.utils.logging import MetricLogger as JLogger

    return {
        "synthetic": _write(d / "syn.jsonl", _run_records() + _extras()),
        "slow": _write(d / "slow.jsonl", _run_records(tok=850.0, mem=12.0)),
        "base": _write(d / "base.jsonl", _run_records()),
        "no_mfu": _write(d / "nomfu.jsonl", _run_records(mfu=None)),
        "port_cli": _port_cli_jsonl(d),
        "port_logger": _logger_jsonl(d / "pl.jsonl", MetricLogger,
                                     ttel.GoodputLedger,
                                     TConfig.gpt2_small()),
        "jax_logger": _logger_jsonl(d / "jl.jsonl", JLogger,
                                    jtel.GoodputLedger,
                                    JConfig.gpt2_small()),
    }


@pytest.mark.parametrize("name", ["synthetic", "port_cli", "port_logger",
                                  "jax_logger", "base"])
def test_report_and_render_equal_jax(jan, runs, name):
    a = analyze.summarize(analyze.load_records(runs[name]))
    b = jan.summarize(jan.load_records(runs[name]))
    assert json.dumps(a, sort_keys=True, default=str) == json.dumps(
        b, sort_keys=True, default=str)
    assert analyze.render(a) == jan.render(b)


@pytest.mark.parametrize("new,base", [
    ("base", "base"), ("slow", "base"), ("no_mfu", "base"),
    ("port_cli", "port_cli"), ("port_logger", "jax_logger"),
    ("jax_logger", "port_logger"), ("synthetic", "base"),
])
def test_compare_verdicts_and_exit_codes_equal_jax(jan, runs, new, base,
                                                   capsys):
    argv = [runs[new], "--compare", runs[base]]
    rc_a = analyze.main(argv)
    out_a = capsys.readouterr().out
    rc_b = jan.main(argv)
    out_b = capsys.readouterr().out
    assert (rc_a, out_a) == (rc_b, out_b)
    if new == base:
        assert rc_a == 0 and "FAIL" not in out_a
    rc_a = analyze.main(argv + ["--json"])
    a = json.loads(capsys.readouterr().out)
    rc_b = jan.main(argv + ["--json"])
    assert rc_a == rc_b and a == json.loads(capsys.readouterr().out)


def test_port_run_reports_goodput_and_rollback(runs, capsys):
    assert analyze.main([runs["port_cli"]]) == 0
    out = capsys.readouterr().out
    assert "goodput" in out and "rollback at step" in out


@pytest.mark.parametrize("mutate,rc", [("unversioned", 2), ("v999", 2),
                                       ("bad_json", 2), ("empty", 2)])
def test_schema_errors_exit_2_like_jax(jan, tmp_path, mutate, rc):
    recs = _run_records(version=999 if mutate == "v999" else SCHEMA_VERSION)
    if mutate == "unversioned":
        del recs[2]["schema_version"]
    path = _write(tmp_path / "r.jsonl", recs)
    if mutate == "bad_json":
        open(path, "w").write("{not json\n")
    if mutate == "empty":
        open(path, "w").close()
    assert analyze.main([path]) == jan.main([path]) == rc


def test_module_entrypoint_runs_without_jax(runs):
    """``python -m tpu_trainer_torch.tools.analyze`` with JAX and the JAX
    package unimportable: identical runs exit 0 with PASS, a 15% tok/s
    regression exits 1."""
    env = dict(os.environ, PYTHONPATH=REPO)
    block = ("import sys; sys.modules['jax'] = None; "
             "sys.modules['tpu_trainer'] = None; import runpy; "
             "runpy.run_module('tpu_trainer_torch.tools.analyze', "
             "run_name='__main__')")
    cmd = [sys.executable, "-c", block]
    ok = subprocess.run(cmd + [runs["base"], "--compare", runs["base"]],
                        capture_output=True, text=True, env=env, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "PASS tok_per_sec_p50" in ok.stdout
    bad = subprocess.run(cmd + [runs["slow"], "--compare", runs["base"]],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 1 and "FAIL tok_per_sec_p50" in bad.stdout
