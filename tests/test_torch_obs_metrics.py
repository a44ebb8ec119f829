"""The port's live metrics plane (``tpu_trainer_torch/obs`` and
``utils/telemetry.MetricsBridge`` against the JAX package's): the same
updates give the same exposition text, the bridge maps a record stream
onto the same series, and the training CLI's ``--metrics_port`` serves
``/metrics``, ``/healthz`` and ``/statusz`` on loopback while it runs.
Everything here is host-side and compared exactly.
"""

import json
import threading
import urllib.request

import pytest

from tpu_trainer_torch.obs.http import MetricsServer
from tpu_trainer_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from tpu_trainer_torch.training import cli
from tpu_trainer_torch.utils.telemetry import MetricsBridge


@pytest.fixture(scope="module")
def jobs():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.obs import metrics as jm
    from tpu_trainer.utils import telemetry as jtel
    return jm, jtel


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _series(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def _updates(reg):
    c = reg.counter("requests_total", "Requests served")
    g = reg.gauge("queue_depth", "Waiting requests")
    c.inc()
    c.inc(2)
    g.set(7)
    g.set(2.5)
    lab = reg.counter("errors_total", "Errors", labelnames=("msg",))
    lab.labels(msg='back\\slash "quote"\nnewline').inc()
    lab.labels(msg="a").inc(4)
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    dflt = reg.histogram("step_seconds", "Default buckets")
    for v in (1e-4, 0.003, 0.2, 7.0, 900.0):
        dflt.observe(v)
    reg.gauge("zzz", "").set(1)
    reg.gauge("aaa", "").set(-3)
    stats = {"n": 41}
    reg.counter("done_total", "").set_function(lambda: stats["n"])
    return reg


def test_exposition_equals_jax(jobs):
    jm, _ = jobs
    a = _updates(MetricsRegistry()).exposition()
    b = _updates(jm.MetricsRegistry()).exposition()
    assert a == b
    s = _series(a)
    assert s['lat_seconds_bucket{le="+Inf"}'] == 5 == s["lat_seconds_count"]
    assert s["done_total"] == 41 and s["queue_depth"] == 2.5


def test_snapshot_equals_jax(jobs):
    jm, _ = jobs
    a = _updates(MetricsRegistry()).snapshot()
    b = _updates(jm.MetricsRegistry()).snapshot()
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_invalid_names_raise_and_null_registry_is_inert():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("bad-name", "")
    with pytest.raises(ValueError):
        reg.counter("h", "", labelnames=("le",))
    with pytest.raises(ValueError):
        reg.counter("neg_total", "").inc(-1)
    m = NULL_REGISTRY.counter("x", "")
    m.inc()
    assert NULL_REGISTRY.exposition() == ""


_RECORDS = [
    {"kind": "train", "step": 10, "loss": 2.5, "lr": 1e-3,
     "tokens_seen": 1000, "tokens_per_sec": 500.0, "mfu": 0.3,
     "elapsed_s": 2.0, "grad_norm": 1.5, "peak_mem_gb": 3.25},
    {"kind": "train", "step": 20, "loss": 2.0, "lr": 9e-4,
     "tokens_seen": 2000, "tokens_per_sec": 510.0, "mfu": 0.31,
     "elapsed_s": 4.0, "effective_tokens_per_sec": 480.0},
    {"kind": "eval", "step": 20, "eval_loss": 2.2},
    {"kind": "goodput", "productive_frac": 0.9, "data_wait_frac": 0.1,
     "total_seconds": 4.0},
    {"kind": "rollback", "step": 21, "cause": "FloatingPointError"},
    {"kind": "recompile", "step": 22, "storm": False},
    {"kind": "nan_scan", "step": 0},
]


def test_bridge_maps_records_as_jax(jobs):
    jm, jtel = jobs
    a, b = MetricsBridge(MetricsRegistry()), jtel.MetricsBridge(
        jm.MetricsRegistry())
    for rec in _RECORDS:
        frozen = dict(rec)
        a.observe(rec)
        b.observe(rec)
        assert rec == frozen
    assert a.registry.exposition() == b.registry.exposition()
    assert a.statusz() == b.statusz()
    s = _series(a.registry.exposition())
    assert s["train_step"] == 20 and s["train_tokens_total"] == 2000
    assert s["train_step_seconds_sum"] == pytest.approx(0.2)


def test_http_plane_end_to_end():
    reg = MetricsRegistry()
    reg.gauge("up", "").set(1)
    ready = {"ok": False}
    srv = MetricsServer(reg, port=0, statusz_fn=lambda: {"hello": "world"})
    srv.health.add_probe("ready", lambda: ready["ok"])
    try:
        assert srv.url.startswith("http://127.0.0.1:")
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and "up 1" in body
        assert _get(srv.url + "/healthz")[0] == 503
        ready["ok"] = True
        assert _get(srv.url + "/healthz")[0] == 200
        assert json.loads(_get(srv.url + "/statusz")[1])["hello"] == "world"
    finally:
        srv.close()
    srv.close()                                       # idempotent


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
  save_interval: 0
distributed:
  mixed_precision: "fp32"
data:
  dataset: "dummy"
"""


def test_cli_serves_live_metrics(tmp_path, monkeypatch):
    """``--metrics_port 0``: a scrape after the first record finds the
    tokens/s gauge and the step; the server is closed at the end."""
    import tpu_trainer_torch.obs.http as http_mod

    servers, scraped = [], {}
    real = http_mod.MetricsServer

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(http_mod, "MetricsServer", Spy)
    original_log = cli.MetricLogger.log

    def log(self, step, metrics, *args, **kwargs):
        rec = original_log(self, step, metrics, *args, **kwargs)
        if rec is not None and "body" not in scraped:
            # Scrape from another thread, as a collector would.
            t = threading.Thread(target=lambda: scraped.update(
                zip(("code", "body"), _get(servers[0].url + "/metrics"))))
            t.start()
            t.join(10)
            scraped["health"] = _get(servers[0].url + "/healthz")[0]
        return rec

    monkeypatch.setattr(cli.MetricLogger, "log", log)
    yaml = tmp_path / "t.yaml"
    yaml.write_text(TINY_YAML)
    assert cli.run_training(["--device", "cpu", "--config", str(yaml),
                             "--checkpoint_dir", str(tmp_path / "ck"),
                             "--metrics_port", "0"]) == 0
    assert scraped["code"] == 200 and scraped["health"] == 200
    s = _series(scraped["body"])
    assert s["train_tokens_per_sec"] > 0 and s["train_step"] == 0
    with pytest.raises(OSError):
        urllib.request.urlopen(servers[0].url + "/metrics", timeout=2)
