"""The port's checkpoints (``tpu_trainer_torch/utils/checkpoint.py``),
mirroring ``tests/test_checkpoint.py``: bitwise roundtrip, identical
resumed training (dropout on), latest selection, torn-meta skip, GC,
quarantine and fall-back, incompatible models, the data cursor, the async
saver; and the consolidated export read by the JAX package.

Tiny f32 geometry on the CPU.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt

MODEL = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                  max_seq_len=16, dropout=0.1, attention_dropout=0.1,
                  use_flash_attention=True, dtype="float32")
TRAIN = TrainingConfig(batch_size=2, max_seq_len=16,
                       gradient_accumulation_steps=2, max_steps=100,
                       warmup_steps=5, learning_rate=3e-3,
                       mixed_precision="fp32", seed=0)


def make_trainer(model=MODEL, train=TRAIN):
    return Trainer(model, train, device="cpu")


def batches(n, seed=3):
    return list(DummyDataLoader(4, 16, 128, num_batches=n, seed=seed))


def assert_state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                                      err_msg=k)


def _save_steps(tmp_path, trainer, steps, **kw):
    state = trainer.init_state()
    paths = []
    for s in steps:
        state.step = s
        paths.append(ckpt.save_checkpoint(
            str(tmp_path), state, model_config=MODEL, training_config=TRAIN,
            **kw))
    return state, paths


def test_roundtrip_bitwise_with_generator(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state()
    for b in batches(3):
        state, _ = trainer.train_step(state, b)
    path = ckpt.save_checkpoint(str(tmp_path), state, model_config=MODEL,
                                training_config=TRAIN, tokens_seen=123)
    assert sorted(os.listdir(path)) == ["meta.json", "state.npz"]
    restored, meta = ckpt.restore_checkpoint(path, make_trainer())
    assert meta["step"] == 3 and meta["tokens_seen"] == 123
    assert_state_equal(state, restored)
    assert restored.step == 3 and restored.opt_state.count == 3
    assert torch.equal(state.generator.get_state(),
                       restored.generator.get_state())
    with np.load(os.path.join(path, "state.npz")) as z:
        assert z["params/layers/attention/q_proj/kernel"].dtype == np.float32
        assert "opt_state/mu/embed_tokens/embedding" in z.files
        assert z["generator"].dtype == np.uint8


def test_resume_identical_training_with_dropout(tmp_path):
    """6 straight steps == 3 steps + save + restore in a new trainer + 3
    steps, bit for bit (the dropout seeds come from the restored
    generator)."""
    data = batches(6)
    t1 = make_trainer()
    s1 = t1.init_state()
    straight = []
    for b in data:
        s1, m = t1.train_step(s1, b)
        straight.append(m["loss"])
    t2 = make_trainer()
    s2 = t2.init_state()
    for b in data[:3]:
        s2, _ = t2.train_step(s2, b)
    path = ckpt.save_checkpoint(str(tmp_path), s2, model_config=MODEL,
                                training_config=TRAIN)
    t3 = make_trainer()
    s3, _ = ckpt.restore_checkpoint(path, t3)
    resumed = []
    for b in data[3:]:
        s3, m = t3.train_step(s3, b)
        resumed.append(m["loss"])
    assert straight[3:] == resumed
    assert_state_equal(s1, s3)


def test_latest_checkpoint_selection(tmp_path):
    trainer = make_trainer()
    assert ckpt.latest_checkpoint(str(tmp_path)) is None
    _, (p1, p2) = _save_steps(tmp_path, trainer, [0, 7])
    assert ckpt.latest_checkpoint(str(tmp_path)) == p2 != p1
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path))] == [0, 7]


def test_truncated_meta_is_skipped(tmp_path):
    trainer = make_trainer()
    _, (p1, p2) = _save_steps(tmp_path, trainer, [1, 2])
    open(f"{p2}/meta.json", "w").close()          # a torn write
    assert ckpt.latest_checkpoint(str(tmp_path)) == p1
    with open(f"{p1}/meta.json", "w") as f:
        f.write('{"step": 1, "tok')
    assert ckpt.latest_checkpoint(str(tmp_path)) is None


def test_gc_keeps_newest_n_never_the_incomplete(tmp_path):
    trainer = make_trainer()
    inflight = tmp_path / "step_00000099"
    inflight.mkdir()
    (inflight / "state.npz").write_bytes(b"partial")
    _save_steps(tmp_path, trainer, [1, 2, 3], keep_last_n=2)
    names = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert names == ["step_00000002", "step_00000003", "step_00000099"]


def test_restore_latest_quarantines_and_falls_back(tmp_path):
    trainer = make_trainer()
    _, (p1, p2) = _save_steps(tmp_path, trainer, [1, 2])
    with open(os.path.join(p2, "state.npz"), "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 0xFF]))
    got_state, meta, path = ckpt.restore_latest(str(tmp_path), trainer)
    assert path == p1 and meta["step"] == 1 and got_state.step == 1
    names = os.listdir(tmp_path)
    assert "step_00000002" not in names
    assert any(n.startswith("step_00000002.corrupt") for n in names)
    assert ckpt.restore_latest(str(tmp_path / "nope"), trainer) is None


def test_incompatible_model_raises_naming_fields(tmp_path):
    trainer = make_trainer()
    _save_steps(tmp_path, trainer, [1])
    bigger = dataclasses.replace(MODEL, hidden_size=64, num_heads=8)
    with pytest.raises(ckpt.CheckpointIncompatibleError,
                       match="hidden_size.*num_heads"):
        ckpt.restore_latest(str(tmp_path), make_trainer(bigger))
    assert os.path.isdir(tmp_path / "step_00000001")      # untouched
    # Shape-free differences (dropout, dtype) restore.
    other = dataclasses.replace(MODEL, dropout=0.0, dtype="bfloat16")
    state, _, _ = ckpt.restore_latest(
        str(tmp_path), make_trainer(other, dataclasses.replace(
            TRAIN, mixed_precision="bf16")))
    assert state.step == 1


def test_data_state_and_configs_roundtrip_through_meta(tmp_path):
    trainer = make_trainer()
    sd = {"kind": "map", "epoch": 1, "batch_index": 5, "seed": 7}
    path = ckpt.save_checkpoint(str(tmp_path), trainer.init_state(),
                                model_config=MODEL, training_config=TRAIN,
                                data_state=sd)
    _, meta = ckpt.restore_checkpoint(path, trainer)
    assert meta["data_state"] == sd
    assert GPTConfig(**meta["model_config"]) == MODEL
    assert TrainingConfig(**meta["training_config"]) == TRAIN
    assert meta["loss_scale"] == 1.0 and meta["good_steps"] == 0


def test_async_saver_equals_sync_save(tmp_path):
    """The async saver's files equal the sync save's, and a later in-place
    step cannot reach the snapshot it writes."""
    trainer = make_trainer()
    state = trainer.init_state()
    data = batches(3)
    for b in data[:2]:
        state, _ = trainer.train_step(state, b)
    want = state.state_dict()
    saver = ckpt.AsyncSaver()
    path = saver.save(str(tmp_path / "a"), state, model_config=MODEL,
                      training_config=TRAIN, tokens_seen=7,
                      data_state={"kind": "map", "epoch": 0,
                                  "batch_index": 2, "seed": 0})
    state, _ = trainer.train_step(state, data[2])      # mutates in place
    assert saver.wait() == path and not saver.in_flight
    sync = make_trainer().init_state()
    sync.load_state_dict(want)
    spath = ckpt.save_checkpoint(str(tmp_path / "s"), sync,
                                 model_config=MODEL, training_config=TRAIN,
                                 tokens_seen=7,
                                 data_state={"kind": "map", "epoch": 0,
                                             "batch_index": 2, "seed": 0})
    with np.load(f"{path}/state.npz") as a, np.load(
            f"{spath}/state.npz") as s:
        assert a.files == s.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], s[k], err_msg=k)
    assert json.load(open(f"{path}/meta.json")) == json.load(
        open(f"{spath}/meta.json"))


def test_async_saver_surfaces_writer_error(tmp_path):
    trainer = make_trainer()
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ckpt.AsyncSaver()
    saver.save(str(blocker), trainer.init_state(), model_config=MODEL,
               training_config=TRAIN)
    with pytest.raises(OSError):
        saver.wait()


def test_restore_params_step_dir_and_consolidated(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state()
    path = ckpt.save_checkpoint(str(tmp_path), state, model_config=MODEL,
                                training_config=TRAIN)
    params, config = ckpt.restore_params(path)
    assert config == MODEL
    out = ckpt.export_consolidated(path, state.params)
    assert out == os.path.join(path, "params.npz")
    cparams, cconfig = ckpt.restore_params(out)
    assert cconfig == MODEL                      # from meta.json beside it
    loose = ckpt.export_consolidated(path, state.params,
                                     str(tmp_path / "loose.npz"))
    assert ckpt.restore_params(loose)[1] is None
    for n, p in state.params.items():
        np.testing.assert_array_equal(params[n], p.detach().numpy())
        np.testing.assert_array_equal(cparams[n], p.detach().numpy())


def test_consolidated_export_loads_in_jax(tmp_path):
    """The port's export, read by the JAX package's ``load_params_npz``,
    gives JAX logits within atol = rtol = 2e-5 of the port's."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.models.gpt import GPT as JGPT
    from tpu_trainer.serving.remote import load_params_npz

    cfg = dataclasses.replace(MODEL, dropout=0.0, attention_dropout=0.0,
                              initializer_range=0.2)
    trainer = make_trainer(cfg)
    state = trainer.init_state()
    for b in batches(2):
        state, _ = trainer.train_step(state, b)
    out = ckpt.export_consolidated(str(tmp_path), state.params)
    ids = np.random.default_rng(1).integers(0, 128, (2, 16)).astype(np.int32)
    want, _ = JGPT(JConfig(**dataclasses.asdict(cfg))).apply(
        {"params": load_params_npz(out)}, jnp.asarray(ids))
    with torch.no_grad():
        got, _ = trainer.model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# -- narrow and host-offloaded Adam moments ------------------------------------

# The embedding (512 x 128) and MLP kernels ([2, 128, 256]) reach the
# 64k-element minimum of the on-device narrow state.
NARROW = dataclasses.replace(MODEL, vocab_size=512, hidden_size=128,
                             intermediate_size=256)


def _storage_trainer(state_dtype="float32", offload=None, budget=0):
    from tpu_trainer_torch.training.trainer import ParallelConfig

    par = ParallelConfig(cpu_offload=offload is not None,
                         offload_dtype=offload or "float32",
                         offload_budget_gb=budget / 2**30)
    return Trainer(NARROW, dataclasses.replace(
        TRAIN, optimizer_state_dtype=state_dtype), par, device="cpu")


def _narrow_batches(n):
    return list(DummyDataLoader(4, 16, 512, num_batches=n, seed=5))


STORAGE = {
    "bf16": dict(state_dtype="bfloat16"),
    "int8": dict(state_dtype="int8"),
    "offload_f32": dict(offload="float32"),
    "offload_bf16": dict(offload="bfloat16"),
    "offload_int8_budget": dict(offload="int8", budget=600_000),
}


@pytest.mark.parametrize("case", sorted(STORAGE))
def test_narrow_and_offloaded_states_roundtrip_bitwise(case, tmp_path):
    """Save after two steps, restore into a fresh trainer: every array
    (moments in their storage form) equal, and the next step too."""
    kw = STORAGE[case]
    trainer = _storage_trainer(**kw)
    state = trainer.init_state()
    data = _narrow_batches(3)
    for b in data[:2]:
        state, _ = trainer.train_step(state, b)
    tc = trainer.training_config
    path = ckpt.save_checkpoint(str(tmp_path), state, model_config=NARROW,
                                training_config=tc)
    with np.load(os.path.join(path, "state.npz")) as z:
        files = set(z.files)
        dtypes = {z[k].dtype for k in z.files if k.startswith("opt_state/")}
    narrow_form = kw.get("state_dtype") or kw["offload"]
    if narrow_form == "int8":
        assert "opt_state/nu/embed_tokens/embedding/q" in files
        assert {np.dtype(np.int8), np.dtype(np.float32)} <= dtypes
    elif narrow_form == "bfloat16":
        assert np.dtype(np.uint16) in dtypes
    else:
        assert dtypes == {np.dtype(np.float32)}
    other = _storage_trainer(**kw)
    restored, _ = ckpt.restore_checkpoint(path, other)
    assert_state_equal(state, restored)
    state, m1 = trainer.train_step(state, data[2])
    restored, m2 = other.train_step(restored, data[2])
    assert m1 == m2
    assert_state_equal(state, restored)


def test_resume_under_other_optimizer_state_dtype_raises(tmp_path):
    trainer = _storage_trainer("bfloat16")
    path = ckpt.save_checkpoint(str(tmp_path), trainer.init_state(),
                                model_config=NARROW,
                                training_config=trainer.training_config)
    with pytest.raises(ckpt.CheckpointIncompatibleError,
                       match="optimizer_state_dtype"):
        ckpt.restore_checkpoint(path, _storage_trainer("int8"))
    assert os.path.isdir(path)


def test_resume_under_other_offload_storage_raises(tmp_path):
    trainer = _storage_trainer(offload="bfloat16")
    path = ckpt.save_checkpoint(str(tmp_path / "a"), trainer.init_state(),
                                model_config=NARROW,
                                training_config=trainer.training_config)
    for kw in (dict(offload="int8"), dict(offload="float32"), {}):
        with pytest.raises(ckpt.CheckpointIncompatibleError,
                           match="offload_dtype"):
            ckpt.restore_checkpoint(path, _storage_trainer(**kw))
    # f32 offload stores what the on-device state does: they interchange.
    off = _storage_trainer(offload="float32")
    state = off.init_state()
    state, _ = off.train_step(state, _narrow_batches(1)[0])
    path = ckpt.save_checkpoint(str(tmp_path / "b"), state,
                                model_config=NARROW,
                                training_config=off.training_config)
    restored, _ = ckpt.restore_checkpoint(path, _storage_trainer())
    assert_state_equal(state, restored)


def test_async_saver_copies_host_resident_moments(tmp_path):
    """The writer works from copies: the step after ``save()`` overwrites
    the host-resident moments in place, and the checkpoint still holds the
    saved step's."""
    trainer = _storage_trainer(offload="bfloat16")
    state = trainer.init_state()
    data = _narrow_batches(2)
    state, _ = trainer.train_step(state, data[0])
    want = state.state_dict()
    saver = ckpt.AsyncSaver()
    path = saver.save(str(tmp_path), state, model_config=NARROW,
                      training_config=trainer.training_config)
    state, _ = trainer.train_step(state, data[1])
    saver.wait()
    with np.load(os.path.join(path, "state.npz")) as z:
        for k in z.files:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    assert not np.array_equal(
        state.state_dict()["opt_state/mu/embed_tokens/embedding"],
        want["opt_state/mu/embed_tokens/embedding"])


# -- several processes: the two-phase commit ------------------------------------

def _trained(n=2):
    trainer = make_trainer()
    state = trainer.init_state()
    for b in batches(n):
        state, _ = trainer.train_step(state, b)
    return trainer, state


def _simulated_save(tmp_path, state, world, hosts=None, **kw):
    """A ``world``-rank two-phase save from one process, rank 0 last."""
    path = None
    for host in hosts if hosts is not None else range(world - 1, -1, -1):
        path = ckpt.save_checkpoint(
            str(tmp_path), state, model_config=MODEL, training_config=TRAIN,
            process_index=host, process_count=world, **kw)
    return path


def test_simulated_two_phase_commit_restores_bitwise(tmp_path):
    _, state = _trained()
    data = {"kind": "dummy", "epoch": 0, "batch_index": 2, "seed": 3,
            "global_batch_size": 4, "feed_world": 2}
    path = _simulated_save(tmp_path, state, 2, data_state=data)
    meta = ckpt.load_meta(path)
    assert meta["format"] == ckpt.HOST_SHARDS_FORMAT
    assert meta["shard_world"] == 2 and meta["data_state"] == data
    assert meta["opt_count"] == 2 and meta["step"] == 2
    assert sorted(os.listdir(path)) == ["commit", "meta.json", "shards"]
    assert sorted(os.listdir(os.path.join(path, "commit"))) == [
        "host00000.done", "host00001.done"]
    restored, _ = ckpt.restore_checkpoint(path, make_trainer())
    assert_state_equal(state, restored)
    # Each element is written once: a leaf the rule splits lies half in
    # each rank's file, a whole leaf (and the generator) in rank 0's.
    with open(os.path.join(path, "shards", "host00001.json")) as f:
        leaves = {e["key"]: e for e in json.load(f)["leaves"]}
    q = leaves["params/layers/attention/q_proj/kernel"]
    assert q["shards"][0]["start"] == [0, 0, 16]
    assert leaves["generator"]["shards"] == []


def test_kill_in_save_between_marker_and_meta_is_invisible(tmp_path,
                                                           monkeypatch):
    from tpu_trainer_torch.utils import faults

    trainer, state = _trained()
    good = _simulated_save(tmp_path, state, 2)
    state, _ = trainer.train_step(state, batches(1, seed=9)[0])

    class Killed(Exception):
        pass

    def die():
        raise Killed()

    monkeypatch.setattr(faults, "kill", die)
    faults.install("kill_in_save@3")
    try:
        with pytest.raises(Killed):
            _simulated_save(tmp_path, state, 2, hosts=[1])
    finally:
        faults.clear()
    torn = str(tmp_path / "step_00000003")
    assert os.path.exists(os.path.join(torn, "shards", "host00001.npz"))
    assert os.path.exists(os.path.join(torn, "commit", "host00001.done"))
    assert not os.path.exists(os.path.join(torn, "meta.json"))
    # Rank 0 never ran phase 2 either (a host that died before its turn):
    # still no meta, and no scan reports the step.
    assert ckpt.latest_checkpoint(str(tmp_path)) == good
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path))] == [2]
    restored, meta = ckpt.restore_latest(str(tmp_path), make_trainer())[:2]
    assert meta["step"] == 2


def test_two_phase_barrier_times_out_without_a_peer(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_TRAINER_CKPT_BARRIER_TIMEOUT_S", "0.2")
    _, state = _trained()
    snap = ckpt.host_shard_snapshot(state, host=0, world=2)
    with pytest.raises(TimeoutError, match="2 host DONE markers"):
        ckpt._commit_two_phase(str(tmp_path), snap, model_config=MODEL,
                               training_config=TRAIN, tokens_seen=0,
                               data_state=None, keep_last_n=0, host=0,
                               world=2)
    assert ckpt.list_checkpoints(str(tmp_path)) == []


def _slice(arr, key, world, rank):
    from tpu_trainer_torch.parallel.sharding import fsdp_dim

    d = fsdp_dim(arr.shape, world)
    if d is None or key == "generator":
        return arr
    k = arr.shape[d] // world
    return arr[(slice(None),) * d + (slice(rank * k, (rank + 1) * k),)]


def test_real_world2_commit_restores_at_worlds_1_2_4(tmp_path):
    """A ZeRO-3 run at world 2 saves through the two-phase commit; the
    directory restores bitwise at world 2 (each rank its own slices), at
    world 1 (the stitched global arrays) and at world 4 (every rank its
    quarter); a world-1 ``state.npz`` restores at world 2."""
    from tests.torch_dist_worker import assemble, run_world

    _, state1 = _trained()
    w1 = ckpt.save_checkpoint(str(tmp_path / "w1"), state1,
                              model_config=MODEL, training_config=TRAIN)
    model = {f.name: getattr(MODEL, f.name)
             for f in dataclasses.fields(MODEL)}
    train = dataclasses.asdict(TRAIN)

    def job(name, world, steps, restore, **extra):
        return {"name": name, "kind": "train", "strategy": "FULL_SHARD",
                "mesh": {"data": 1, "fsdp": world}, "model": model,
                "train": train, "steps": steps, "data_seed": 3,
                "restore": restore, **extra}

    w2 = str(tmp_path / "w2")
    step2 = os.path.join(w2, "step_00000002")
    out = run_world(tmp_path, 2, [
        job("save", 2, 2, w1, save_at=2, save_dir=w2),
        job("again", 2, 0, step2)])
    meta = ckpt.load_meta(step2)
    assert meta["format"] == ckpt.HOST_SHARDS_FORMAT
    assert meta["shard_world"] == 2
    assert meta["data_state"]["feed_world"] == 2
    saved = assemble([r["records"] for r in out["save"]])
    sd1 = state1.state_dict()
    for rank in range(2):
        # 1 -> 2: the world-1 arrays' slices.
        for key, arr in out["save"][rank]["restored"].items():
            assert np.array_equal(arr, _slice(sd1[key], key, 2, rank)), key
        # 2 -> 2: this rank's own slices and the generator.
        again = out["again"][rank]
        for key, arr in out["save"][rank]["final"].items():
            assert np.array_equal(again["restored"][key], arr), key
        assert again["restored_scalars"] == out["save"][rank]["scalars"]
        assert np.array_equal(again["restored_generator"],
                              saved["generator"])
    # 2 -> 1: the stitched arrays, bitwise.
    restored, _ = ckpt.restore_checkpoint(step2, make_trainer())
    sd = restored.state_dict()
    for key, arr in saved.items():
        assert np.array_equal(sd[key], arr), key
    assert restored.step == 2 and restored.opt_state.count == 2
    # 2 -> 4.
    four = run_world(tmp_path, 4, [job("four", 4, 0, step2)])["four"]
    for rank, res in enumerate(four):
        for key, arr in res["restored"].items():
            assert np.array_equal(arr, _slice(saved[key], key, 4, rank)), key


def test_corrupt_checkpoint_is_quarantined_once_at_world2(tmp_path):
    """A ZeRO-3 run at world 2 saves steps 1 and 2 and ``corrupt_shard``
    damages step 2's shards. Both ranks restarted with auto-resume agree:
    step 2 is quarantined once (rank 0 renames, the peers wait) and both
    restore step 1, each rank its own slices of it."""
    from tests.torch_dist_worker import run_world

    model = {f.name: getattr(MODEL, f.name)
             for f in dataclasses.fields(MODEL)}
    d = str(tmp_path / "ck")
    common = {"kind": "train", "strategy": "FULL_SHARD",
              "mesh": {"data": 1, "fsdp": 2}, "model": model,
              "train": dataclasses.asdict(TRAIN), "data_seed": 3}
    out = run_world(tmp_path, 2, [
        {**common, "name": "save", "steps": 2, "save_at": [1, 2],
         "save_dir": d, "faults": "corrupt_shard@2"},
        {**common, "name": "resume", "steps": 0, "restore_latest": d}])
    step1 = os.path.join(d, "step_00000001")
    assert sorted(os.listdir(d)) == ["step_00000001",
                                     "step_00000002.corrupt"]
    assert [r["latest"] for r in out["resume"]] == [
        {"path": step1, "step": 1}] * 2
    want, _ = ckpt.restore_checkpoint(step1, make_trainer())
    sd = want.state_dict()
    for rank, res in enumerate(out["resume"]):
        for key, arr in res["restored"].items():
            assert np.array_equal(arr, _slice(sd[key], key, 2, rank)), key


def test_export_param_shards_crosses_to_jax_and_back(tmp_path):
    from tpu_trainer.utils import checkpoint as jckpt

    from tpu_trainer_torch.models.weights import to_jax_params

    _, state = _trained(1)
    tree = to_jax_params(state.params)
    port_dir = ckpt.export_param_shards(tree, str(tmp_path / "p"),
                                        world=3)
    jax_dir = jckpt.export_param_shards(tree, str(tmp_path / "j"), world=3)

    def flat(t, prefix=""):
        out = {}
        for k, v in t.items():
            name = f"{prefix}/{k}" if prefix else k
            out.update(flat(v, name) if isinstance(v, dict)
                       else {name: np.asarray(v)})
        return out

    for loader, path in ((jckpt.load_param_shards, port_dir),
                         (ckpt.load_param_shards, jax_dir)):
        got, want = flat(loader(path)), flat(tree)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    # The same files: manifests, markers and meta equal, npz members too.
    for sub in ("shards", "commit"):
        names = sorted(os.listdir(os.path.join(port_dir, sub)))
        assert names == sorted(os.listdir(os.path.join(jax_dir, sub)))
        for name in names:
            a, b = (os.path.join(d, sub, name) for d in (port_dir, jax_dir))
            if name.endswith(".npz"):
                with np.load(a) as za, np.load(b) as zb:
                    assert za.files == zb.files
                    for f in za.files:
                        assert np.array_equal(za[f], zb[f])
            else:
                assert open(a).read() == open(b).read(), name
    assert ckpt.load_meta(port_dir) == jckpt.load_meta(jax_dir)


@pytest.mark.parametrize("state,gbs,world", [
    (None, 8, 2),
    ({"kind": "dummy", "epoch": 0, "batch_index": 3, "seed": 3}, 8, 2),
    ({"kind": "map", "epoch": 1, "batch_index": 3, "seed": 0,
      "global_batch_size": 8, "feed_world": 2}, 8, 1),
    ({"kind": "dummy", "epoch": 0, "batch_index": 3, "seed": 3,
      "global_batch_size": 16, "feed_world": 4}, 6, 1),
    ({"kind": "streaming", "epoch": 0, "batch_index": 5, "seed": 0,
      "global_batch_size": 4, "feed_world": 2}, 3, None),
])
def test_remap_data_state_matches_jax(state, gbs, world):
    from tpu_trainer.utils.checkpoint import remap_data_state as jremap

    assert ckpt.remap_data_state(
        state, new_global_batch_size=gbs, new_feed_world=world) == jremap(
        state, new_global_batch_size=gbs, new_feed_world=world)
