"""Data parallelism across processes: DDP, ZeRO-2, ZeRO-3 and
HYBRID_SHARD on gloo CPU ranks against one process and the JAX trainer.

Each spawn runs several jobs on one process group
(``tests/torch_dist_worker.py``, a ``file://`` rendezvous under
``tmp_path``, every collective bounded). Tiny geometry (``bench.py``'s
tiny model at seq 16), f32, dropout off unless a test is about dropout.

Tolerances, and why:
- Equal global batch against one process: losses rtol 2e-5, params rtol
  1e-4 / atol 1e-5 (``tests/test_distributed.py``'s): the rank sums and
  the sharded global norm add in another order than one process does.
- DDP with one micro-batch a rank against one process with one
  micro-batch a rank: bitwise (the rank-order sum of two operands is the
  world-1 accumulation).
- Against the JAX ``FULL_SHARD`` trainer on two devices: the shards at
  init bitwise (the same shard rule on the same values); after three
  steps loss and grad_norm rtol 1e-4 and params atol 1e-4
  (``test_torch_train.py``'s trajectory bounds).
- MoE (both routers under DDP, ZeRO-2 and ZeRO-3 at world 2, the
  capacity router under HYBRID_SHARD at world 4; accumulation 1: the
  global micro-batch is the ranks' rows in rank order) against one
  process at the same global batch: every capacity layer call's queue
  positions and keep mask, the ranks' concatenated, bitwise; losses and
  the ranks' mean router aux within 1e-5; the state at the
  equal-global-batch bounds above. A planted fault (rank 1's positions
  ignoring rank 0's tokens) must move the keep masks.
"""

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.ops.dropout import hash_keep
from tpu_trainer_torch.parallel.sharding import leaf_specs
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import ParallelConfig, Trainer

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=16, dropout=0.0, attention_dropout=0.0,
             use_flash_attention=True, dtype="float32",
             param_dtype="float32")
TRAIN = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=2,
             max_steps=100, warmup_steps=5, learning_rate=3e-3,
             mixed_precision="fp32", seed=0)
STEPS = 4


def _world1(model=MODEL, steps=STEPS, data_seed=11, **train):
    """One process: losses, grad norms and the final global arrays. One
    CPU thread, as each rank runs (the CPU matmul's summation order
    depends on its thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _world1_run(model, steps, data_seed, **train)
    finally:
        torch.set_num_threads(threads)


def _world1_run(model, steps, data_seed, **train):
    tr = Trainer(GPTConfig(**model), TrainingConfig(**{**TRAIN, **train}),
                 device="cpu")
    state = tr.init_state()
    losses, norms = [], []
    for batch in DummyDataLoader(tr.global_batch_size, 16,
                                 model["vocab_size"], num_batches=steps,
                                 seed=data_seed):
        state, m = tr.train_step(state, batch)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return np.array(losses), np.array(norms), state.state_dict()


def _job(name, strategy, mesh=None, model=MODEL, steps=STEPS, **train):
    return {"name": name, "kind": "train", "strategy": strategy,
            "mesh": mesh or {}, "model": model,
            "train": {**TRAIN, **train}, "steps": steps}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    jobs = [
        _job("ddp", "replicated"),
        _job("ddp_a1", "replicated", gradient_accumulation_steps=1),
        _job("zero2", "SHARD_GRAD_OP", {"data": 1, "fsdp": 2}),
        _job("zero3", "FULL_SHARD", {"data": 1, "fsdp": 2}),
        _job("zero3_remat", "FULL_SHARD", {"data": 1, "fsdp": 2},
             model={**MODEL, "gradient_checkpointing": True,
                    "remat_policy": "dots"}),
        {**_job("ddp_fault", "replicated", gradient_accumulation_steps=1),
         "scale_grad_rank": 1},
        {"name": "dropout", "kind": "dropout", "strategy": "FULL_SHARD",
         "mesh": {"data": 1, "fsdp": 2},
         "model": {**MODEL, "dropout": 0.1, "attention_dropout": 0.1},
         "train": TRAIN, "rows": 2, "seed": 5},
        {"name": "guards", "kind": "guards"},
    ]
    return run_world(tmp, 2, jobs)


def _check_equal_global_batch(out, ref):
    losses, norms, sd = ref
    for rank in out:
        np.testing.assert_allclose(rank["losses"], losses, rtol=2e-5,
                                   atol=1e-5)
    got = assemble([r["records"] for r in out])
    for key, want in sd.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("name", ["ddp", "zero2", "zero3", "zero3_remat"])
def test_world2_equals_world1_at_equal_global_batch(world2, name):
    # World 2 x batch 2 x accum 2 against one process x batch 4 x accum 2.
    _check_equal_global_batch(world2[name], _world1(batch_size=4))
    # Every rank reads the same all-reduced loss and norm.
    a, b = world2[name]
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert [r["feed"] for r in world2[name]] == [(0, 2), (1, 2)]


def test_ddp_world2_is_bitwise_world1_with_accum2(world2):
    # Rank r's one micro-batch is the world-1 step's micro-batch r.
    losses, norms, sd = _world1(batch_size=2, gradient_accumulation_steps=2)
    for rank in world2["ddp_a1"]:
        assert rank["losses"] == losses.tolist()
        assert rank["grad_norms"] == norms.tolist()
        for key, arr in rank["final"].items():
            assert np.array_equal(arr, sd[key]), key


def test_sharded_state_at_rest(world2):
    """ZeRO-3 keeps every rank's masters and moments a half where a leaf
    shards; ZeRO-2 keeps the moments a half and the masters whole."""
    specs = leaf_specs({n: s for n, (s, _) in _param_shapes().items()},
                       "zero3", 2)
    full = sum(np.prod(s.shape) for s in specs.values())
    for name, sharded_params in (("zero3", True), ("zero2", False)):
        for rank in world2[name]:
            sizes = {k: v.size for k, v in rank["final"].items()}
            p = sum(v for k, v in sizes.items() if k.startswith("params/"))
            mu = sum(v for k, v in sizes.items() if "/mu/" in k)
            assert mu == full // 2          # every tiny leaf divides
            assert p == (full // 2 if sharded_params else full)


def test_zero3_regathers_saved_weights_without_a_second_forward(world2):
    """Without remat, ZeRO-3's backward regathers every gathered weight
    that autograd saved instead of keeping it: a layer's two norm weights
    and four matmul weights (q/k/v and gate/up fused, each cast to the
    compute dtype), the embedding and the final norm, a micro-batch. It
    runs as many all-gathers as the remat rerun (which gathers inside the
    block again), and under remat only the two outside the blocks are
    regathered."""
    micro = STEPS * TRAIN["gradient_accumulation_steps"]
    layers = MODEL["num_layers"]
    plain = world2["zero3"][0]["collectives"]
    remat = world2["zero3_remat"][0]["collectives"]
    assert plain["regather_saved"] == micro * (6 * layers + 2)
    assert remat["regather_saved"] == micro * 2
    assert plain["all_gather"] == remat["all_gather"]


def _param_shapes():
    from tpu_trainer_torch.models.weights import param_specs

    return param_specs(GPTConfig(**MODEL))


def test_planted_gradient_fault_is_visible(world2):
    # One rank's gradients scaled at step 1: the replicas diverge, so the
    # losses leave the clean run's from the next step on.
    clean = world2["ddp_a1"][0]["losses"]
    bad = world2["ddp_fault"][0]["losses"]
    assert bad[:2] == clean[:2]
    assert not np.allclose(bad[2:], clean[2:], rtol=2e-5, atol=1e-5)
    r0, r1 = world2["ddp_fault"]
    assert any(not np.array_equal(r0["final"][k], r1["final"][k])
               for k in r0["final"])


def test_hosts_in_sync_and_votes_across_ranks(world2):
    for rank, out in enumerate(world2["guards"]):
        # Agreeing ranks pass; a rank whose loss differs fails every rank.
        assert "cross-host divergence at step 7" in out["caught"]
        assert "[2.5, 3.5]" in out["caught"]
        assert out["any"] is True and out["none"] is False
        assert out["from0"] == {"rank": 0}


def test_dropout_masks_follow_the_data_shard(world2):
    r0, r1 = world2["dropout"]
    b, s, h = 2, 16, MODEL["hidden_size"]
    # The world-1 mask over the global [2b, s, h] rows, same seed.
    gen = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2**32, (1,), generator=gen,
                             dtype=torch.int64).item())
    world1 = hash_keep((2 * b, s, h), 0.1, seed).numpy()
    for rank, out in enumerate((r0, r1)):
        assert out["shard"] == (rank, 2)
        assert np.array_equal(out["residual_keep"],
                              world1[rank * b:(rank + 1) * b])
    # Attention seeds fold the shard coordinate: the masks differ.
    assert r0["attention_seed"] != r1["attention_seed"]
    k0 = hash_keep((4, 16, 16), 0.1, r0["attention_seed"]).numpy()
    k1 = hash_keep((4, 16, 16), 0.1, r1["attention_seed"]).numpy()
    assert not np.array_equal(k0, k1)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("world4"), 4, [
        _job("hybrid", "HYBRID_SHARD", {"data": 2, "fsdp": 2}, batch_size=1),
        _job("hybrid_z2", "zero2", {"data": 2, "fsdp": 2}, batch_size=1),
        {**_job("hybrid_moe", "HYBRID_SHARD", {"data": 2, "fsdp": 2},
                model={**MOE, "moe_impl": "capacity"}, steps=MOE_STEPS,
                batch_size=1, gradient_accumulation_steps=1),
         "record_moe": True},
    ])


def test_hybrid_shard_world4_equals_world1(world4):
    out = world4
    ref = _world1(batch_size=4)
    for name in ("hybrid", "hybrid_z2"):
        _check_equal_global_batch(out[name], ref)
        assert [r["feed"] for r in out[name]] == [(i, 4) for i in range(4)]
    # Data replicas hold equal shards; fsdp peers hold different halves.
    r = out["hybrid"]
    key = "params/layers/attention/q_proj/kernel"
    assert np.array_equal(r[0]["final"][key], r[2]["final"][key])
    assert not np.array_equal(r[0]["final"][key], r[1]["final"][key])


def _jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_jax_flat(v, name))
        else:
            out[name] = v
    return out


def test_zero3_matches_jax_full_shard(tmp_path):
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.serving.remote import save_params_npz
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer
    from tpu_trainer_torch.models.weights import _adam_state

    train = {**TRAIN, "gradient_accumulation_steps": 1}
    mesh_cfg = MeshConfig(data=1, fsdp=2)
    jtr = JTrainer(JConfig(**MODEL), JTrain(**train),
                   JPar(mesh_cfg, "FULL_SHARD"),
                   mesh=make_mesh(mesh_cfg, devices=jax.devices()[:2]))
    jstate = jtr.init_state(0)
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jax.tree.map(np.asarray, jstate.params))

    def shards(state):
        """JAX device r's addressable shard of every params / mu / nu
        leaf, under the port's checkpoint keys."""
        adam = _adam_state(state.opt_state)
        trees = {"params": state.params, "opt_state/mu": adam.mu,
                 "opt_state/nu": adam.nu}
        out = [{}, {}]
        for prefix, tree in trees.items():
            for name, leaf in _jax_flat(tree).items():
                for sh in leaf.addressable_shards:
                    r = jax.devices().index(sh.device)
                    out[r][f"{prefix}/{name}"] = np.asarray(sh.data)
        return out

    want_init = shards(jstate)
    jlosses, jnorms = [], []
    for batch in DummyDataLoader(jtr.global_batch_size, 16, 256,
                                 num_batches=3, seed=11):
        jstate, m = jtr.train_step(jstate, batch)
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    want_final = shards(jstate)

    job = _job("jax3", "FULL_SHARD", {"data": 1, "fsdp": 2}, steps=3,
               gradient_accumulation_steps=1)
    out = run_world(tmp_path, 2, [{**job, "params_npz": path}])["jax3"]
    for r, rank in enumerate(out):
        assert set(rank["init"]) == set(want_init[r])
        for key, arr in rank["init"].items():
            assert np.array_equal(arr, want_init[r][key]), key
        np.testing.assert_allclose(rank["losses"], jlosses, rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(rank["grad_norms"], jnorms, rtol=1e-4,
                                   atol=1e-7)
        for key, arr in rank["final"].items():
            if key.startswith("params/"):
                np.testing.assert_allclose(arr, want_final[r][key],
                                           atol=1e-4, rtol=0, err_msg=key)


def _cli_argv(tmp_path, yaml, tag):
    return ["--device", "cpu", "--config", str(yaml), "--max_steps", "2",
            "--log_interval", "1", "--eval_interval", "0",
            "--save_interval", "0", "--no_auto_resume",
            "--checkpoint_dir", str(tmp_path / f"ck_{tag}"),
            "--metrics_jsonl", str(tmp_path / f"{tag}.jsonl")]


def _losses(path):
    import json

    return [r["loss"] for r in map(json.loads, open(path))
            if r.get("kind") == "train"]


@pytest.mark.parametrize("mode,extra", [
    ("ddp", ["--mesh_data", "2"]),
    ("fsdp", ["--sharding", "FULL_SHARD"]),
])
def test_torchrun_cli_matches_one_process(tmp_path, mode, extra):
    """``torchrun --standalone --nproc_per_node 2 -m ...train_<mode>`` on
    gloo CPU ranks against one process at the same global batch."""
    import os
    import subprocess
    import sys

    from tpu_trainer_torch.training import cli

    yaml = tmp_path / "t.yaml"
    yaml.write_text(
        "model:\n  vocab_size: 256\n  hidden_size: 64\n  num_layers: 2\n"
        "  num_heads: 4\n  max_seq_len: 16\n  dropout: 0.0\n"
        "  attention_dropout: 0.0\ntraining:\n  batch_size: 2\n"
        "  gradient_accumulation_steps: 1\n  warmup_steps: 1\n"
        "  learning_rate: 0.003\ndistributed:\n  mixed_precision: fp32\n")
    assert cli.run_training(_cli_argv(tmp_path, yaml, "one")
                            + ["--grad_accum", "2"], mode=mode) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1", COORDINATOR_TIMEOUT_S="120")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         f"tpu_trainer_torch.training.train_{mode}"]
        + _cli_argv(tmp_path, yaml, "two") + extra,
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "processes=2" in proc.stdout
    one, two = (_losses(tmp_path / f"{t}.jsonl") for t in ("one", "two"))
    assert len(two) == 2
    np.testing.assert_allclose(two, one, rtol=2e-5, atol=1e-5)
    assert os.path.exists(tmp_path / "ck_two" / "step_00000002" / "shards")


# -- MoE at world 2 ----------------------------------------------------------

MOE = {**MODEL, "num_experts": 4, "moe_top_k": 2, "router_z_weight": 1e-3,
       "expert_capacity_factor": 0.5}
MOE_STEPS = 3


def _moe_world1(model):
    """One process at the world-2 runs' global batch (batch 4, accumulation
    1), recording every MoE layer call as the ranks do."""
    from tests.torch_dist_worker import record_moe

    rec = {}
    restore = record_moe(rec)
    try:
        out = _world1(model=model, steps=MOE_STEPS, batch_size=4,
                      gradient_accumulation_steps=1)
    finally:
        restore()
    return out, rec


@pytest.fixture(scope="module")
def moe_world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_world2")
    jobs = []
    for impl in ("capacity", "dropless"):
        model = {**MOE, "moe_impl": impl}
        for name, strategy, mesh in (("ddp", "replicated", None),
                                     ("zero2", "SHARD_GRAD_OP",
                                      {"data": 1, "fsdp": 2}),
                                     ("zero3", "FULL_SHARD",
                                      {"data": 1, "fsdp": 2})):
            jobs.append({**_job(f"{impl}_{name}", strategy, mesh, model=model,
                                steps=MOE_STEPS,
                                gradient_accumulation_steps=1),
                         "record_moe": True})
    jobs.append({**_job("offsets_fault", "replicated",
                        model={**MOE, "moe_impl": "capacity"}, steps=1,
                        gradient_accumulation_steps=1),
                 "record_moe": True, "zero_offsets_rank": 1})
    return run_world(tmp, 2, jobs)


def _check_moe_equals_world1(out, name, ref, rec):
    """Every rank of a MoE run against one process at the same global
    batch (``ref``, ``rec``: ``_moe_world1``): the state at the
    equal-global-batch bounds, losses and the ranks' mean aux within 1e-5,
    one all-gather of the ``[k, E]`` counts a layer a forward, and every
    capacity layer call's positions and keep mask (the ranks'
    concatenated) bitwise."""
    losses, norms, sd = ref
    calls = MOE_STEPS * MOE["num_layers"]
    _check_equal_global_batch(out, ref)
    for rank in out:
        np.testing.assert_allclose(rank["losses"], losses, rtol=1e-5,
                                   atol=1e-5)
        assert rank["collectives"]["moe_counts"] == calls
    np.testing.assert_allclose(np.mean([r["moe_aux"] for r in out], axis=0),
                               rec["moe_aux"], rtol=1e-5, atol=1e-5)
    for key in ("moe_keep", "moe_pos"):
        assert len(out[0][key]) == len(rec[key])
        for i, want in enumerate(rec[key]):
            got = np.concatenate([r[key][i] for r in out])
            assert np.array_equal(got, want), (name, key, i)


@pytest.mark.parametrize("impl", ["capacity", "dropless"])
def test_moe_world2_equals_world1(moe_world2, impl):
    ref, rec = _moe_world1({**MOE, "moe_impl": impl})
    calls = MOE_STEPS * MOE["num_layers"]
    assert len(rec["moe_aux"]) == calls
    assert len(rec["moe_keep"]) == (calls if impl == "capacity" else 0)
    if impl == "capacity":
        assert not all(k.all() for k in rec["moe_keep"])   # drops
    for name in ("ddp", "zero2", "zero3"):
        out = moe_world2[f"{impl}_{name}"]
        _check_moe_equals_world1(out, name, ref, rec)
        if name == "zero3":
            # ZeRO-3 keeps no gathered weight the backward needs: a layer's
            # two norms, q/k/v, o, the router and the three expert
            # weights, and the embedding and final norm, are regathered.
            for rank in out:
                assert rank["collectives"]["regather_saved"] == (
                    8 * calls + 2 * MOE_STEPS)


def test_moe_rank_offset_fault_moves_the_keep_masks(moe_world2):
    _, rec = _moe_world1({**MOE, "moe_impl": "capacity"})
    bad = moe_world2["offsets_fault"]
    got = np.concatenate([r["moe_keep"][0] for r in bad])
    assert np.array_equal(bad[0]["moe_keep"][0],
                          rec["moe_keep"][0][:len(bad[0]["moe_keep"][0])])
    assert not np.array_equal(got, rec["moe_keep"][0])


def test_moe_hybrid_shard_world4_equals_world1(world4):
    """The capacity router under HYBRID_SHARD (data 2 x fsdp 2): the four
    ranks route their rows together, as one process routes the batch."""
    ref, rec = _moe_world1({**MOE, "moe_impl": "capacity"})
    out = world4["hybrid_moe"]
    _check_moe_equals_world1(out, "hybrid", ref, rec)
    assert not all(k.all() for k in rec["moe_keep"])          # drops
