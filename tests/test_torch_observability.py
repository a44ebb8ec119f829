"""The port's observability pieces (``tpu_trainer_torch/utils/profiling.py``,
``flight_recorder.py``, ``guards.py`` and the ``MetricLogger`` hooks),
as ``tests/test_observability.py`` and ``tests/test_analyze.py`` pin the
JAX ones:

- the profiling window opens on resume past its start, opens once a run,
  is closed by ``close()``, and marks each traced step; a real CPU trace
  is a Chrome trace under ``host_0/``;
- the flight recorder keeps the last N records and dumps them with the
  run snapshot (the JAX snapshot's keys); heartbeats tail-read past a torn
  line;
- every record the logger writes reaches its recorder and observer and
  carries ``schema_version``; a telemetry subtree forces a record.
"""

import json
import os

import pytest
import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.training import cli
from tpu_trainer_torch.utils import flight_recorder as flight_lib
from tpu_trainer_torch.utils import profiling
from tpu_trainer_torch.utils.guards import (
    DivergenceError,
    LossSpikeError,
    check_finite,
    check_hosts_in_sync,
)
from tpu_trainer_torch.utils.logging import SCHEMA_VERSION, MetricLogger

# -- guards --------------------------------------------------------------------


def test_guards():
    check_finite(5, 2.37)
    with pytest.raises(FloatingPointError, match="step 7"):
        check_finite(7, float("nan"))
    check_hosts_in_sync(3, 1.23)            # one process: nothing to compare
    assert issubclass(LossSpikeError, FloatingPointError)
    assert issubclass(DivergenceError, RuntimeError)


# -- profiling -----------------------------------------------------------------

@pytest.fixture
def fake_profiler(monkeypatch):
    calls = []

    class Mark:
        def __init__(self, label, step):
            self.label, self.step = label, step

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "_start_trace",
                        lambda d: calls.append(("start", d)))
    monkeypatch.setattr(profiling, "_stop_trace",
                        lambda prof, d: calls.append(("stop",)))
    monkeypatch.setattr(profiling, "_annotation", Mark)
    return calls, Mark


def test_window_disabled_without_dir(fake_profiler):
    calls, _ = fake_profiler
    wt = profiling.WindowedTrace(None, start=0, num_steps=2)
    for i in range(5):
        wt.step(i)
    wt.close()
    assert calls == []


def test_window_opens_on_resume_past_start(tmp_path, fake_profiler):
    calls, Mark = fake_profiler
    wt = profiling.WindowedTrace(str(tmp_path), start=5, num_steps=3)
    cms = [wt.step(i) for i in range(10, 16)]      # resumed at step 10
    assert [c[0] for c in calls] == ["start", "stop"]
    assert [isinstance(c, Mark) for c in cms] == [True] * 3 + [False] * 3
    assert [c.step for c in cms[:3]] == [10, 11, 12]


def test_window_opens_once_a_run(tmp_path, fake_profiler):
    calls, _ = fake_profiler
    wt = profiling.WindowedTrace(str(tmp_path), start=0, num_steps=2)
    for i in range(10):
        wt.step(i)
    wt.close()
    assert calls == [("start", str(tmp_path / "host_0")), ("stop",)]


def test_close_stops_an_open_window(tmp_path, fake_profiler):
    calls, _ = fake_profiler
    wt = profiling.WindowedTrace(str(tmp_path), start=0, num_steps=100)
    wt.step(0)
    wt.close()
    wt.close()
    assert [c[0] for c in calls] == ["start", "stop"]


def _trace_events(host_dir):
    (path,) = [p for p in os.listdir(host_dir) if p.endswith(".json")]
    with open(os.path.join(host_dir, path)) as f:
        return json.load(f)["traceEvents"]


def test_window_writes_a_chrome_trace_with_step_marks(tmp_path):
    wt = profiling.WindowedTrace(str(tmp_path), start=1, num_steps=2)
    x = torch.ones(16, 16)
    for i in range(4):
        with wt.step(i):
            x = x @ x / 16
    wt.close()
    names = {e.get("name") for e in _trace_events(tmp_path / "host_0")}
    assert {"train_step_1", "train_step_2"} <= names
    assert "train_step_0" not in names and "train_step_3" not in names


def test_trace_context_manager(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert _trace_events(tmp_path / "host_0")


# -- flight recorder, heartbeats ---------------------------------------------------


def test_ring_keeps_last_n_and_dumps(tmp_path):
    rec = flight_lib.FlightRecorder(capacity=3, snapshot={"k": 1})
    for i in range(5):
        rec.observe({"kind": "train", "step": i})
    assert len(rec) == 3
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = rec.dump(str(tmp_path), reason="crash", exc=e, step=4)
    report = json.load(open(path))
    assert os.path.basename(path) == "crash_report.json"
    assert report["schema_version"] == SCHEMA_VERSION
    assert [r["step"] for r in report["records"]] == [2, 3, 4]
    assert report["exception"]["type"] == "RuntimeError"
    assert "boom" in report["exception"]["traceback"]
    assert report["snapshot"] == {"k": 1} and report["step"] == 4
    rec.dump(str(tmp_path), reason="sigterm")
    assert json.load(open(path))["reason"] == "sigterm"   # last dump wins
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_env_snapshot_has_the_jax_keys():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.utils.flight_recorder import env_snapshot as jsnap

    want = set(jsnap()) - {"jax_version"}
    snap = flight_lib.env_snapshot(model_config=GPTConfig.gpt2_small())
    assert want <= set(snap)
    assert snap["torch_version"] == torch.__version__
    assert snap["model_config"]["hidden_size"] == 768
    assert snap["process_count"] == 1


def test_heartbeat_tail_read_past_a_torn_line(tmp_path):
    hb = flight_lib.HeartbeatWriter(str(tmp_path), host=0, start_step=3)
    assert flight_lib.read_heartbeat(str(tmp_path), 0) is None
    for step in range(3, 6):
        hb.beat(step)
    with open(hb.path, "a") as f:
        f.write('{"kind": "heartbeat", "step": 9')          # torn
    beat = flight_lib.read_heartbeat(str(tmp_path), 0)
    assert beat["step"] == 5 and beat["start_step"] == 3
    assert beat["schema_version"] == SCHEMA_VERSION
    hb.stop()
    hb.beat(6)
    assert flight_lib.read_heartbeat(str(tmp_path), 0)["step"] == 5


# -- the logger's hooks ------------------------------------------------------------


class _Seen:
    def __init__(self):
        self.records = []

    def observe(self, record):
        self.records.append(record)


def test_every_record_reaches_recorder_and_observer(tmp_path):
    path = str(tmp_path / "m.jsonl")
    rec, obs = _Seen(), _Seen()
    logger = MetricLogger(GPTConfig.gpt2_small(), tokens_per_step=100,
                          log_interval=2, jsonl_path=path, stdout=False,
                          recorder=rec, observer=obs)
    assert logger.log(0, {"loss": 1.0, "lr": 1e-4, "grad_norm": 0.5}) is None
    # A telemetry subtree forces a record off the interval.
    tel = logger.log(2, {"loss": 1.0, "lr": 1e-4, "grad_norm": 0.5,
                         "telemetry": {"grad_norm": {
                             "per_layer": torch.tensor([1.0, 2.0])}}})
    assert tel["telemetry/grad_norm/per_layer/L01"] == 2.0
    logger.log_eval(2, 2.0, 1)
    logger.log_record({"kind": "custom", "step": 2})
    logger.close()
    lines = [json.loads(line) for line in open(path)]
    assert [r["kind"] for r in lines] == ["train", "eval", "custom"]
    assert all(r["schema_version"] == SCHEMA_VERSION for r in lines)
    assert rec.records == obs.records == lines


def test_cli_profile_window_and_schema_on_every_record(tmp_path):
    yaml = tmp_path / "t.yaml"
    yaml.write_text(TINY_YAML)
    jsonl = tmp_path / "m.jsonl"
    assert cli.run_training([
        "--device", "cpu", "--config", str(yaml), "--checkpoint_dir",
        str(tmp_path / "ck"), "--metrics_jsonl", str(jsonl),
        "--profile_dir", str(tmp_path / "prof"), "--profile_start", "1",
        "--profile_steps", "2", "--telemetry_interval", "2",
        "--flight_recorder_steps", "4"]) == 0
    names = {e.get("name") for e in _trace_events(tmp_path / "prof" /
                                                   "host_0")}
    assert {"train_step_1", "train_step_2"} <= names
    lines = [json.loads(line) for line in open(jsonl)]
    assert {r["kind"] for r in lines} >= {"train", "goodput"}
    assert all(r["schema_version"] == SCHEMA_VERSION for r in lines)
    # No failure, so no crash report.
    assert not os.path.exists(tmp_path / "ck" / "crash_report.json")


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
  max_steps: 5
  warmup_steps: 1
  log_interval: 1
  eval_interval: 0
  save_interval: 0
distributed:
  mixed_precision: "fp32"
data:
  dataset: "dummy"
"""


def test_xla_only_hooks_are_disarmed():
    """Eager PyTorch never recompiles the step and has no compiler cost
    model: the watchdog records nothing, the cost analysis is None."""
    from tpu_trainer_torch.training.config import TrainingConfig
    from tpu_trainer_torch.training.trainer import RecompileWatchdog, Trainer

    cfg = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                    max_seq_len=8, dtype="float32")
    trainer = Trainer(cfg, TrainingConfig(
        batch_size=1, max_seq_len=8, gradient_accumulation_steps=1,
        mixed_precision="fp32"), device="cpu")
    state = trainer.init_state(0)
    batch = torch.zeros((1, 8), dtype=torch.int64).numpy()
    watchdog = RecompileWatchdog(trainer)
    for step in range(3):
        state, _ = trainer.train_step(state, batch)
        assert watchdog.observe(step, batch, expected=step == 0) is None
    assert trainer.executable_cache_size() is None
    assert trainer.step_cost_analysis(state, batch) is None
