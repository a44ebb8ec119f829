"""The port's ring attention and sequence parallelism (``ops/ring.py``,
``models/gpt.py`` under a ``sequence`` axis) on the CPU.

Most cases run every rank of the ring in this process through the
loopback permute (``ops.ring.loopback_permute``), in one autograd graph:
forward and q/k/v gradients, contiguous and zigzag, sp 2 and 4, GQA,
against the JAX ``ring_attention`` on a ``sequence`` mesh of the conftest's
CPU devices (its jnp chunk path: no kernel, nothing in the JAX package
changes) and against plain attention (``flash_attention_reference``), f32
within 1e-5. One world-2 gloo spawn (``tests/torch_dist_worker.py``) runs
the ring over a real process group (``collectives.SequencePermute``)
against the loopback, the sequence-2 ``Trainer`` against one process
(losses within 1e-5, the final parameters within rtol 1e-4 / atol 1e-5,
the equal-global-batch bounds of ``test_torch_distributed.py``), the
residual dropout masks (bitwise the one-process mask's columns) and the
``train_ddp --mesh_sequence 2`` resume (bitwise). One ``torchrun`` launch
of the CLI checks that both ranks exit 0 (the CLI leaves the process
group it joined).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.ops.dropout import hash_keep
from tpu_trainer_torch.ops.flash import flash_attention_reference
from tpu_trainer_torch.ops.ring import (
    forward_launches,
    ring_attention_loopback,
    use_zigzag,
)
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=16, dropout=0.0, attention_dropout=0.0,
             use_flash_attention=True, dtype="float32",
             param_dtype="float32")
TRAIN = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=2,
             max_steps=100, warmup_steps=2, learning_rate=3e-3,
             mixed_precision="fp32", seed=0)
STEPS = 3


def _qkv(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]


def _port(arrs, sp, zigzag, cot):
    """The loopback ring's output and q/k/v gradients for cotangent
    ``cot``."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    out = ring_attention_loopback(q, k, v, sp, zigzag=zigzag)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _plain(arrs, cot):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs)
    out = flash_attention_reference(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jring():
    jax = pytest.importorskip("jax")
    from tpu_trainer.ops.ring import ring_attention
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh

    def run(arrs, sp, zigzag, cot):
        mesh = make_mesh(MeshConfig(data=1, sequence=sp),
                         devices=jax.devices()[:sp])

        @jax.jit
        def fwd_bwd(q, k, v, cot):
            out, vjp = jax.vjp(
                lambda q, k, v: ring_attention(q, k, v, mesh, zigzag=zigzag),
                q, k, v)
            return out, vjp(cot)

        out, grads = fwd_bwd(*arrs, cot)
        return np.asarray(out), [np.asarray(g) for g in grads]
    return run


@pytest.mark.parametrize("sp,zigzag,kvh", [
    (2, False, 2), (2, True, 2), (4, False, 2), (4, True, 2),  # GQA
    (4, True, 4),                                              # MHA
])
def test_ring_matches_jax_ring_and_plain_attention(jring, sp, zigzag, kvh):
    arrs = _qkv(sp * 10 + kvh, 2, 32, 4, kvh, 16)
    cot = np.random.default_rng(7).standard_normal(
        (2, 32, 4, 16)).astype(np.float32)
    out, grads = _port(arrs, sp, zigzag, cot)
    jout, jgrads = jring(arrs, sp, zigzag, cot)
    pout, pgrads = _plain(arrs, cot)
    np.testing.assert_allclose(out, jout, **TOL)
    np.testing.assert_allclose(out, pout, **TOL)
    for name, g, jg, pg in zip("qkv", grads, jgrads, pgrads):
        np.testing.assert_allclose(g, jg, err_msg=name, **TOL)
        np.testing.assert_allclose(g, pg, err_msg=name, **TOL)


def test_sp1_is_plain_attention():
    arrs = _qkv(1, 1, 32, 2, 2, 8)
    cot = np.ones((1, 32, 2, 8), np.float32)
    out, grads = _port(arrs, 1, None, cot)
    pout, pgrads = _plain(arrs, cot)
    np.testing.assert_array_equal(out, pout)
    for g, pg in zip(grads, pgrads):
        np.testing.assert_array_equal(g, pg)


@pytest.mark.parametrize("zigzag", [False, True])
def test_causality_across_ring(zigzag):
    # Changing the last chunk's keys/values moves no earlier output.
    q, k, v = _qkv(3, 1, 32, 2, 2, 8)
    base = ring_attention_loopback(*map(torch.from_numpy, (q, k, v)), 4,
                                   zigzag=zigzag)
    k2, v2 = k.copy(), v.copy()
    k2[:, 24:] += 1.0
    v2[:, 24:] -= 2.0
    moved = ring_attention_loopback(*map(torch.from_numpy, (q, k2, v2)), 4,
                                    zigzag=zigzag)
    np.testing.assert_array_equal(base[:, :24].numpy(),
                                  moved[:, :24].numpy())
    assert not torch.equal(base[:, 24:], moved[:, 24:])


def test_indivisible_seq_and_odd_zigzag_raise():
    q, k, v = map(torch.from_numpy, _qkv(4, 1, 30, 2, 2, 8))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention_loopback(q, k, v, 4)
    # 30 / 2 = 15: odd local length. Zigzag refuses it when asked and is
    # off by default.
    with pytest.raises(ValueError, match="even local length"):
        ring_attention_loopback(q, k, v, 2, zigzag=True)
    assert not use_zigzag(15, 2) and use_zigzag(16, 2)
    assert not use_zigzag(16, 1)
    out = ring_attention_loopback(q, k, v, 2)
    np.testing.assert_allclose(out.numpy(),
                               flash_attention_reference(q, k, v).numpy(),
                               **TOL)
    assert forward_launches(4, True) == 7 and forward_launches(4, False) == 4


def test_dropout_is_deterministic_and_chunk_seeded():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 32, 2, 2, 8))
    a = ring_attention_loopback(q, k, v, 2, dropout_rate=0.3, seed=9)
    b = ring_attention_loopback(q, k, v, 2, dropout_rate=0.3, seed=9)
    c = ring_attention_loopback(q, k, v, 2, dropout_rate=0.3, seed=10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="requires a seed"):
        ring_attention_loopback(q, k, v, 2, dropout_rate=0.3)


# -- world 2 -------------------------------------------------------------------

def _world1(steps=STEPS, **train):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**{**TRAIN, **train}),
                     device="cpu")
        state = tr.init_state()
        losses = []
        for batch in DummyDataLoader(tr.global_batch_size, 16,
                                     MODEL["vocab_size"], num_batches=steps,
                                     seed=11):
            state, m = tr.train_step(state, batch)
            losses.append(m["loss"])
        return np.array(losses), state.state_dict()
    finally:
        torch.set_num_threads(threads)


TINY_YAML = """
model:
  vocab_size: 256
  hidden_size: 64
  num_layers: 2
  num_heads: 4
  max_seq_len: 16
  dropout: 0.1
  attention_dropout: 0.1
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


def _cli_argv(tmp, tag, *extra):
    return ["--device", "cpu", "--config", str(tmp / "tiny.yaml"),
            "--max_steps", "4", "--save_interval", "2", "--keep_last_n", "0",
            "--log_interval", "1", "--eval_interval", "0",
            "--checkpoint_dir", str(tmp / tag),
            "--metrics_jsonl", str(tmp / f"{tag}.jsonl"), *extra]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_world2")
    q, k, v = _qkv(21, 2, 32, 4, 2, 16)
    g = np.random.default_rng(22).standard_normal(q.shape).astype(
        np.float32)
    np.savez(tmp / "qkv.npz", q=q, k=k, v=v, g=g)
    (tmp / "tiny.yaml").write_text(TINY_YAML)
    argv = _cli_argv(tmp, "cli", "--mesh_sequence", "2")
    jobs = [
        {"name": "ring_zz", "kind": "ring", "inputs": str(tmp / "qkv.npz")},
        {"name": "ring_cont", "kind": "ring", "inputs": str(tmp / "qkv.npz"),
         "zigzag": False},
        {"name": "sp2", "kind": "train", "strategy": "replicated",
         "mesh": {"data": 1, "sequence": 2}, "model": MODEL,
         "train": {**TRAIN, "batch_size": 4}, "steps": STEPS},
        {"name": "drop", "kind": "mesh_dropout", "strategy": "replicated",
         "mesh": {"data": 1, "sequence": 2},
         "model": {**MODEL, "dropout": 0.1, "attention_dropout": 0.1},
         "train": TRAIN, "rows": 2, "seed": 5},
        {"name": "cli", "kind": "cli",
         "runs": [{"argv": argv},
                  {"argv": argv, "remove": str(tmp / "cli"
                                               / "step_00000004")}]},
    ]
    out = run_world(tmp, 2, jobs)
    out["tmp"] = tmp
    out["inputs"] = (q, k, v, g)
    return out


@pytest.mark.parametrize("name,zigzag", [("ring_zz", True),
                                         ("ring_cont", False)])
def test_process_group_ring_equals_loopback(world2, name, zigzag):
    q, k, v, g = world2["inputs"]
    want, wgrads = _port((q, k, v), 2, zigzag, g)
    ranks = world2[name]
    got = np.concatenate([r["out"] for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for i in range(3):
        gi = np.concatenate([r["grads"][i] for r in ranks], axis=1)
        np.testing.assert_allclose(gi, wgrads[i], rtol=1e-6, atol=1e-6)
    # At sp 2 the zigzag's even-stripe permute keeps every stripe where it
    # is (no message), its odd-stripe permute swaps: one message for each
    # of q, k, v and the output, plus the ring step; contiguous: the ring
    # step only. The backward repeats each.
    per_pass = 3 + 1 + 1 if zigzag else 1
    for r in ranks:
        assert r["calls"]["ring_permute"] == 2 * per_pass


def test_sequence2_matches_world1(world2):
    losses, sd = _world1(batch_size=4)
    out = world2["sp2"]
    for rank in out:
        np.testing.assert_allclose(rank["losses"], losses, **TOL)
    got = assemble([r["records"] for r in out])
    for key, want in sd.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    # Parameters replicate over sequence: both ranks hold them whole.
    a, b = out
    for key, arr in a["final"].items():
        np.testing.assert_array_equal(arr, b["final"][key], err_msg=key)
    assert [r["feed"] for r in out] == [(0, 1), (0, 1)]
    assert a["collectives"].get("ring_permute", 0) > 0


def test_sequence_residual_dropout_is_one_process_mask(world2):
    cfg = GPTConfig(**{**MODEL, "dropout": 0.1})
    from tpu_trainer_torch.models.gpt import _TrainStep

    gen = torch.Generator().manual_seed(5)
    step = _TrainStep(train=True, generator=gen, rope=None, segment_ids=None)
    want = (hash_keep((2, 16, cfg.hidden_size), 0.1, step.seed()))
    ranks = world2["drop"]
    got = np.concatenate([r["residual_keep"] for r in ranks], axis=1)
    np.testing.assert_array_equal(got, want.numpy())
    # Heads do not shard here and the batch does not either: both ranks
    # draw the plain attention seed, the same one.
    assert ranks[0]["attention_seeds"] == ranks[1]["attention_seeds"]


def test_cli_sequence2_resume_is_bitwise(world2):
    import json

    tmp = world2["tmp"]
    recs = [r for r in map(json.loads, open(tmp / "cli.jsonl"))
            if r.get("kind") == "train"]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 2, 3]
    assert [r["loss"] for r in recs[2:4]] == [r["loss"] for r in recs[4:]]


def test_torchrun_cli_ranks_exit_zero(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...train_ddp --mesh_sequence 2``:
    the CLI joins the process group itself, leaves it when it returns, and
    both ranks exit 0."""
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)
    env = dict(os.environ, OMP_NUM_THREADS="1", COORDINATOR_TIMEOUT_S="120")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "tpu_trainer_torch.training.train_ddp"]
        + _cli_argv(tmp_path, "run", "--mesh_sequence", "2",
                    "--max_steps", "2"),
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "sequence x tensor = 2 x 1" in proc.stdout
