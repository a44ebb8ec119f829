"""Preemption notices and grace on the port
(``tpu_trainer_torch/utils/preemption.py`` against
``tpu_trainer/utils/preemption.py``; the CLI's drain paths as
``tests/test_elastic.py::TestPreemptionGrace`` pins the JAX one).

- The file and metadata notice sources (a real local HTTP server) and
  ``build_notice_source`` answer as the JAX ones on the same inputs; the
  capacity helpers write the same grants; drain markers round-trip.
- A SIGTERM under ``--preemption_grace_s`` (the ``sigterm`` fault, through
  the real handler) and a notice file written before launch both drain at
  a step boundary, exit 143 with a complete checkpoint, and the resumed
  run ends bitwise the straight run (dropout on).
- A grace deadline that expires with the async writer mid-commit still
  exits 143 without waiting for the commit.

Tiny geometry, f32, the CPU.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from tpu_trainer_torch.training import cli
from tpu_trainer_torch.utils import checkpoint as ckpt
from tpu_trainer_torch.utils import flight_recorder as flight_lib
from tpu_trainer_torch.utils import preemption

TINY_YAML = """
model:
  name: "gpt2-small"
  vocab_size: 128
  hidden_size: 32
  num_layers: 1
  num_heads: 2
  intermediate_size: 64
  max_seq_len: 32
  dropout: 0.1
  attention_dropout: 0.1
  use_flash_attention: true
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
def jpre():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.utils import preemption as jp
    return jp


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _shape(rec):
    """A notice's comparable part (the receipt time is the wall clock)."""
    if rec is None:
        return None
    return (rec.source, rec.deadline_unix is None)


@pytest.mark.parametrize("body", [None, "", "not json",
                                  json.dumps({"deadline_s": 30.0}),
                                  json.dumps({"deadline_unix": 5e9})])
def test_file_source_equals_jax(jpre, tmp_path, body):
    path = tmp_path / "notice"
    results = []
    for mod in (preemption, jpre):
        if path.exists():
            path.unlink()
        clock = FakeClock()
        src = mod.FileNoticeSource(str(path), poll_interval_s=10.0,
                                   clock=clock)
        seq = [_shape(src.poll())]
        if body is not None:
            path.write_text(body)
        clock.t += 1.0               # inside the throttle: no look yet
        seq.append(_shape(src.poll()))
        clock.t += 10.0
        rec = src.poll()
        seq.append(_shape(rec))
        if path.exists():
            path.unlink()
        clock.t += 10.0
        seq.append(src.poll() is rec)   # sticky
        results.append(seq)
    assert results[0] == results[1]
    if body is not None:
        assert results[0][2] is not None


def test_file_deadline_matches(jpre, tmp_path):
    path = tmp_path / "notice"
    path.write_text(json.dumps({"deadline_unix": 1234.5}))
    a = preemption.FileNoticeSource(str(path)).poll()
    b = jpre.FileNoticeSource(str(path)).poll()
    assert a.deadline_unix == b.deadline_unix == 1234.5
    assert a.remaining_s(now=1230.0) == b.remaining_s(now=1230.0) == 4.5


class _MetadataHandler(BaseHTTPRequestHandler):
    body = b"FALSE"
    seen_headers = []

    def do_GET(self):
        type(self).seen_headers.append(dict(self.headers))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(type(self).body)

    def log_message(self, *a):
        pass


@pytest.fixture
def metadata_server():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _MetadataHandler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    _MetadataHandler.body = b"FALSE"
    _MetadataHandler.seen_headers = []
    yield f"http://127.0.0.1:{server.server_address[1]}/preempted"
    server.shutdown()
    server.server_close()


@pytest.mark.parametrize("answer,notice", [(b"FALSE", False),
                                           (b"TRUE", True), (b"1", True),
                                           (b"yes", True), (b"0", False)])
def test_metadata_source_equals_jax(jpre, metadata_server, answer, notice):
    _MetadataHandler.body = answer
    for mod in (preemption, jpre):
        src = mod.MetadataNoticeSource(metadata_server, poll_interval_s=1.0,
                                       clock=FakeClock())
        rec = src.poll()
        assert (rec is not None) == notice
        if notice:
            assert rec.source == f"http:{metadata_server}"
    assert all(h.get("Metadata-Flavor") == "Google"
               for h in _MetadataHandler.seen_headers)


def test_unreachable_metadata_is_not_a_notice():
    src = preemption.MetadataNoticeSource("http://127.0.0.1:9/x",
                                          poll_interval_s=1.0,
                                          clock=FakeClock())
    assert src.poll() is None


def test_build_notice_source_equals_jax(jpre, tmp_path):
    for spec in (None, "", f"file:{tmp_path}/n", "http://127.0.0.1:1/p",
                 "metadata"):
        a = preemption.build_notice_source(spec)
        b = jpre.build_notice_source(spec)
        assert type(a).__name__ == type(b).__name__
        assert getattr(a, "url", None) == getattr(b, "url", None)
        assert getattr(a, "path", None) == getattr(b, "path", None)
    assert preemption.GCE_METADATA_URL == jpre.GCE_METADATA_URL
    with pytest.raises(ValueError, match="notice"):
        preemption.build_notice_source("carrier-pigeon")


def test_capacity_helpers_equal_jax(jpre, tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    for op in (("read",), ("grant", 1), ("grant", 2), ("consume", 2),
               ("read",), ("consume", 5), ("grant", 1)):
        got = [{"read": lambda p, m: m.read_capacity(p),
                "grant": lambda p, m: m.grant_capacity(p, op[1]),
                "consume": lambda p, m: m.consume_capacity(p, op[1])}[op[0]](
                    p, m) for p, m in ((a, preemption), (b, jpre))]
        assert got[0] == got[1], op
    (tmp_path / "torn.json").write_text('{"hosts": ')
    assert preemption.read_capacity(str(tmp_path / "torn.json")) == 0


def test_drain_markers_round_trip(tmp_path):
    flight_lib.write_drain(str(tmp_path), 1, step=7, cause="file:x",
                           deadline_unix=1234.5)
    flight_lib.write_drain(str(tmp_path), 0, step=7, cause="metadata")
    drains = flight_lib.read_drains(str(tmp_path))
    assert [d["host"] for d in drains] == [0, 1]
    assert drains[1]["deadline_unix"] == 1234.5
    assert drains[0]["deadline_unix"] is None
    assert flight_lib.read_drains(str(tmp_path / "absent")) == []


# -- the CLI's drains ----------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_yaml(tmp_path_factory):
    p = tmp_path_factory.mktemp("yaml") / "tiny.yaml"
    p.write_text(TINY_YAML)
    return str(p)


def _run(tiny_yaml, ck, jsonl, *extra):
    return cli.run_training(["--device", "cpu", "--config", tiny_yaml,
                             "--checkpoint_dir", str(ck),
                             "--metrics_jsonl", str(jsonl), *extra])


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r.get("kind") == "train"}


def _state(path):
    with np.load(os.path.join(path, "state.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def straight(tiny_yaml, tmp_path_factory):
    d = tmp_path_factory.mktemp("straight")
    assert _run(tiny_yaml, d / "ck", d / "m.jsonl", "--no_auto_resume") == 0
    return _losses(d / "m.jsonl"), _state(d / "ck" / "step_00000006")


def _resume_matches(tiny_yaml, ck, tmp_path, straight):
    assert _run(tiny_yaml, ck, tmp_path / "m2.jsonl") == 0
    want, final = straight
    got = _losses(tmp_path / "m1.jsonl")
    got.update(_losses(tmp_path / "m2.jsonl"))
    assert got == want
    state = _state(ck / "step_00000006")
    assert sorted(state) == sorted(final)
    for k in final:
        np.testing.assert_array_equal(state[k], final[k], err_msg=k)


def test_sigterm_with_grace_resumes_bitwise(tiny_yaml, tmp_path, straight,
                                            capsys):
    ck = tmp_path / "ck"
    rc = _run(tiny_yaml, ck, tmp_path / "m1.jsonl", "--inject_fault",
              "sigterm@3", "--preemption_grace_s", "120",
              "--flight_recorder_steps", "8")
    assert rc == 143
    assert "SIGTERM received" in capsys.readouterr().out
    meta = ckpt.load_meta(ckpt.latest_checkpoint(str(ck)))
    assert meta["step"] == 4 and meta["data_state"]["batch_index"] == 4
    assert json.load(open(ck / "crash_report.json"))["reason"] == "sigterm"
    _resume_matches(tiny_yaml, ck, tmp_path, straight)


def test_notice_file_drains_at_first_boundary(tiny_yaml, tmp_path, straight,
                                              monkeypatch, capsys):
    """A notice file present at launch: the run drains after its first
    step, deregisters (drain marker beside its heartbeats) and exits 143;
    the resumed run ends bitwise."""
    hb = tmp_path / "hb"
    monkeypatch.setenv("TPU_TRAINER_HEARTBEAT_DIR", str(hb))
    notice = tmp_path / "notice"
    notice.write_text(json.dumps({"deadline_s": 60.0}))
    ck = tmp_path / "ck"
    rc = _run(tiny_yaml, ck, tmp_path / "m1.jsonl", "--preempt_notice",
              f"file:{notice}", "--preempt_vote_interval", "1",
              "--preemption_grace_s", "60")
    assert rc == 143
    out = capsys.readouterr().out
    assert "preemption notice received" in out and "proactive drain" in out
    assert ckpt.load_meta(ckpt.latest_checkpoint(str(ck)))["step"] == 1
    drains = flight_lib.read_drains(str(hb))
    assert [d["step"] for d in drains] == [1]
    assert drains[0]["cause"] == f"file:{notice}"
    beat = flight_lib.read_heartbeat(str(hb), 0)
    assert beat["step"] == 1 and beat["start_step"] == 0
    monkeypatch.delenv("TPU_TRAINER_HEARTBEAT_DIR")
    _resume_matches(tiny_yaml, ck, tmp_path, straight)


def test_grace_expiry_exits_with_commit_in_flight(tiny_yaml, tmp_path,
                                                  monkeypatch, capsys):
    """The writer thread is mid-commit when the grace runs out: the run
    exits 143 at once and leaves that checkpoint incomplete (no
    ``meta.json``) rather than outliving the deadline."""
    original = ckpt._commit
    release = threading.Event()

    def slow_commit(*args, **kwargs):
        release.wait(30)
        return original(*args, **kwargs)

    monkeypatch.setattr(ckpt, "_commit", slow_commit)
    ck = tmp_path / "ck"
    t0 = time.monotonic()
    try:
        rc = _run(tiny_yaml, ck, tmp_path / "m1.jsonl", "--inject_fault",
                  "sigterm@0", "--preemption_grace_s", "0.5",
                  "--save_interval", "1")
        elapsed = time.monotonic() - t0
        assert rc == 143 and elapsed < 20
        assert "commit in flight" in capsys.readouterr().out
        assert ckpt.list_checkpoints(str(ck)) == []
    finally:
        release.set()
