"""Weighted data mixtures on the port (``tpu_trainer_torch/data/mixture.py``
against ``tpu_trainer/data/mixture.py``, and the CLI's ``--data_mixture``).

- ``choose_source`` and ``source_counts`` give the JAX sequences exactly.
- The same sources mixed by either package yield the same batches, and a
  mixture resumed from its cursor continues bitwise.
- The CLI trains on a mixture of dummy and text sources, logs each
  record's ``data_source``, and a run resumed from a checkpoint ends
  bitwise the straight run.
"""

import json
import shutil

import numpy as np
import pytest

from tpu_trainer_torch.data.mixture import (
    MixtureDataLoader,
    choose_source,
    source_counts,
)
from tpu_trainer_torch.training import cli

SEQ, VOCAB = 32, 128
WEIGHTS = {"a": 3.0, "b": 1.0}


@pytest.fixture(scope="module")
def jmix():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer.data import mixture as jm
    from tpu_trainer.data import packing as jp
    return jm, jp


@pytest.mark.parametrize("seed,weights", [
    (5, {"a": 0.75, "b": 0.25}), (0, {"x": 1.0, "y": 1.0, "z": 2.0}),
    (123, {"only": 1.0}), (7, {"b": 0.1, "a": 0.9})])
def test_choice_sequence_equals_jax(jmix, seed, weights):
    jm, _ = jmix
    picks = [choose_source(seed, i, weights) for i in range(500)]
    assert picks == [jm.choose_source(seed, i, weights) for i in range(500)]
    assert source_counts(seed, weights, 500) == jm.source_counts(
        seed, weights, 500)


def _sources(packing):
    return {"a": packing.PackedDataLoader(
                lambda: packing.synthetic_documents(60, 20, VOCAB, seed=21),
                batch_size=2, seq_len=SEQ),
            "b": packing.PackedDataLoader(
                lambda: packing.synthetic_documents(60, 20, VOCAB, seed=22),
                batch_size=2, seq_len=SEQ)}


def test_mixed_batches_equal_jax(jmix):
    jm, jp = jmix
    import tpu_trainer_torch.data.packing as tp

    mine = MixtureDataLoader(_sources(tp), WEIGHTS, seed=9, num_batches=16)
    theirs = jm.MixtureDataLoader(_sources(jp), WEIGHTS, seed=9,
                                  num_batches=16)
    for a, b in zip(mine, theirs, strict=True):
        np.testing.assert_array_equal(a, b)
        assert mine.last_source == theirs.last_source
    assert mine.batches_by_source == theirs.batches_by_source
    assert mine.non_pad_frac == theirs.non_pad_frac
    assert json.dumps(mine.state_dict(), sort_keys=True) == json.dumps(
        theirs.state_dict(), sort_keys=True)


@pytest.mark.parametrize("cut", [0, 1, 7, 15])
def test_resume_is_bitwise(cut):
    import tpu_trainer_torch.data.packing as tp

    full = list(MixtureDataLoader(_sources(tp), WEIGHTS, seed=9,
                                  num_batches=16))
    mix = MixtureDataLoader(_sources(tp), WEIGHTS, seed=9, num_batches=16)
    it = iter(mix)
    for _ in range(cut):
        next(it)
    state = mix.state_dict()
    assert state["kind"] == "mixture" and state["batch_index"] == cut
    resumed = MixtureDataLoader(_sources(tp), WEIGHTS, seed=9,
                                num_batches=16)
    resumed.load_state_dict(json.loads(json.dumps(state)))
    rest = list(resumed)
    assert len(rest) == 16 - cut
    for a, b in zip(rest, full[cut:]):
        np.testing.assert_array_equal(a, b)


def test_changed_sources_or_kind_rejected():
    import tpu_trainer_torch.data.packing as tp

    mix = MixtureDataLoader(_sources(tp), WEIGHTS, seed=9)
    good = mix.state_dict()
    with pytest.raises(ValueError, match="kind"):
        mix.load_state_dict(dict(good, kind="packed"))
    with pytest.raises(ValueError, match="sources changed"):
        mix.load_state_dict(dict(good, sources={"a": good["sources"]["a"]}))
    with pytest.raises(ValueError, match="positive"):
        MixtureDataLoader(_sources(tp), {"a": 1.0, "b": -1.0})


def test_parse_mixture_spec_equals_jax(jmix):
    from tpu_trainer.training.cli import parse_mixture_spec as jparse

    spec = "dummy:1,tinystories:3:/data/ts.txt"
    assert cli.parse_mixture_spec(spec) == jparse(spec) == {
        "dummy": (1.0, None), "tinystories": (3.0, "/data/ts.txt")}
    for bad in ("dummy", "mystery:1", "dummy:heavy", "dummy:1,dummy:2"):
        with pytest.raises(SystemExit):
            cli.parse_mixture_spec(bad)


YAML = """
model:
  name: "gpt2-small"
  vocab_size: 50257
  hidden_size: 32
  num_layers: 1
  num_heads: 2
  intermediate_size: 64
  max_seq_len: 32
  dropout: 0.1
  attention_dropout: 0.0
  use_flash_attention: false
training:
  batch_size: 2
  learning_rate: 1e-3
  max_steps: 6
  warmup_steps: 1
  log_interval: 1
  eval_interval: 0
  save_interval: 3
distributed:
  mixed_precision: "fp32"
"""


def _corpus(path, n=300, seed=11):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz "))
    with open(path, "w") as f:
        for _ in range(n):
            f.write("".join(rng.choice(letters, rng.integers(10, 60))) + "\n")
    return str(path)


@pytest.mark.parametrize("pack", [False, True])
def test_cli_mixture_resumes_bitwise(tmp_path, pack):
    yaml = tmp_path / "t.yaml"
    yaml.write_text(YAML)
    corpus = _corpus(tmp_path / "stories.txt")

    def run(tag, *extra):
        argv = ["--device", "cpu", "--config", str(yaml), "--tokenizer",
                "byte", "--data_mixture",
                f"dummy:1,tinystories:2:{corpus}", "--checkpoint_dir",
                str(tmp_path / tag), "--metrics_jsonl",
                str(tmp_path / f"{tag}.jsonl"), *extra]
        if pack:
            argv.append("--pack_sequences")
        assert cli.run_training(argv) == 0
        with open(tmp_path / f"{tag}.jsonl") as f:
            return [r for r in map(json.loads, f) if r["kind"] == "train"]

    straight = run("a")
    sources = [r["data_source"] for r in straight]
    assert set(sources) == {"dummy", "tinystories"}
    assert sources == [choose_source(0, i, {"dummy": 1 / 3,
                                            "tinystories": 2 / 3})
                       for i in range(6)]
    # Drop step 6 and rerun: the run resumes from step 3 (both runs
    # append to one JSONL) and ends in the same state.
    step6 = tmp_path / "a" / "step_00000006"
    with np.load(step6 / "state.npz") as z:
        want = {k: z[k] for k in z.files}
    shutil.rmtree(step6)
    both = run("a")
    assert [r["step"] for r in both] == [0, 1, 2, 3, 4, 5, 3, 4, 5]
    assert [r["loss"] for r in both[6:]] == [r["loss"] for r in both[3:6]]
    assert [r["data_source"] for r in both[6:]] == sources[3:]
    with np.load(step6 / "state.npz") as z:
        for k in want:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
