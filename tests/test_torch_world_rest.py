"""The rest of world > 1 training on gloo CPU ranks: int8 Adam moments and
host offload on shards, their checkpoints across world sizes, telemetry
steps and ``nan_scan`` combined across ranks, and the per-device offload
budget; against one process and the JAX package.

One spawn of two ranks runs every job (``tests/torch_dist_worker.py``, a
``file://`` rendezvous under ``tmp_path``, every collective bounded).
Tiny geometry (``bench.py``'s tiny model at seq 16), f32, dropout off.
Every leaf of the tiny model is below the 65,536-element threshold of the
narrow moments, so the int8 jobs widen the MLP to 1152: its gate and up
leaves ``[2, 64, 1152]`` are quantized, their fsdp dim is the last, a
rank's 576 columns would pick a block of 64 where the leaf's is 128, and
the block 512..640 straddles the two ranks. Offload int8 packs every leaf
with two dims, so the tiny q/k/v/o leaves ``[2, 64, 64]`` (block 64, a
rank's 32 columns) straddle too.

Tolerances, and why:
- int8 packs, bf16 and f32 moments and masters, with the clip off: world
  2 at one micro-batch a rank against world 1 at two micro-batches of the
  same rows, bitwise. The rank-order sum of two gradients is the world-1
  accumulation, each update is elementwise, and a rank's pack is its
  slice of the one-process pack (the clip's global norm adds the shards
  in another order, so it is off).
- Checkpoints across world sizes: bitwise (the arrays are stored whole).
- The telemetry record at world 2 against world 1 at the same global
  batch (one micro-batch, so the global micro-batch is the same rows):
  the same keys, every value within rtol 1e-5 (atol 1e-7 for the
  near-zero ones): the ranks' sums of squares, maxima and mean router
  probabilities add in another order than one process's reductions.
  Against the JAX trainer on the same weights (the ``a/b/c``-key npz):
  rtol 1e-4 (``test_torch_telemetry.py``'s port-to-JAX bound at world 1).
- ``nan_scan``: the sites bitwise, the finite stats as the telemetry.
"""

import numpy as np
import pytest
import torch

from tests.torch_dist_worker import assemble, run_world
from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.weights import from_jax_params, load_params_npz
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import (
    ParallelConfig,
    Trainer,
    moment_key,
    select_resident_moments,
)
from tpu_trainer_torch.utils import checkpoint as ckpt
from tpu_trainer_torch.utils import telemetry
from tpu_trainer_torch.utils.quant import (
    BlockCut,
    cut_boxes,
    cut_from_global,
    quant_block_len,
    quantize_blockwise_int8,
)

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_seq_len=16, dropout=0.0, attention_dropout=0.0,
             use_flash_attention=True, dtype="float32",
             param_dtype="float32")
WIDE = {**MODEL, "intermediate_size": 1152}
MOE = {**MODEL, "num_experts": 4, "moe_top_k": 2}
# The clip off: the norm's shard sums add in another order (docstring).
TRAIN = dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=1,
             max_steps=100, warmup_steps=5, learning_rate=3e-3,
             mixed_precision="fp32", seed=0, grad_clip=1e9)
STEPS = 3
TEL = dict(rtol=1e-5, atol=1e-7)
JAX_TEL = dict(rtol=1e-4, atol=1e-7)
Z2 = ("SHARD_GRAD_OP", {"data": 1, "fsdp": 2})
Z3 = ("FULL_SHARD", {"data": 1, "fsdp": 2})


def _job(name, strategy_mesh, model=MODEL, steps=STEPS, parallel=None,
         **train):
    strategy, mesh = strategy_mesh
    return {"name": name, "kind": "train", "strategy": strategy,
            "mesh": mesh, "model": model, "train": {**TRAIN, **train},
            "parallel": parallel or {}, "steps": steps}


def _one_thread(fn):
    """Run ``fn`` on one CPU thread, as each rank runs (the CPU matmul's
    summation order depends on its thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _world1(model, parallel=None, steps=STEPS, save_dir=None, params=None,
            telemetry_at=(), **train):
    """One process over the same global batch: ``(trainer, state,
    telemetry records, losses)``."""
    def run():
        tr = Trainer(GPTConfig(**model), TrainingConfig(**{**TRAIN, **train}),
                     ParallelConfig(**(parallel or {})), device="cpu")
        state = tr.init_state(params=None if params is None else
                              from_jax_params(params, tr.model_config,
                                              device="cpu"))
        tels, losses = [], []
        for batch in DummyDataLoader(tr.global_batch_size, 16,
                                     model["vocab_size"], num_batches=steps,
                                     seed=11):
            state, m = tr.train_step(state, batch,
                                     telemetry=state.step in telemetry_at)
            losses.append(m["loss"])
            if "telemetry" in m:
                tels.append(telemetry.flatten_scalars(m["telemetry"]))
        if save_dir is not None:
            ckpt.save_checkpoint(save_dir, state,
                                 model_config=tr.model_config,
                                 training_config=tr.training_config)
        return tr, state, tels, losses
    return _one_thread(run)


def _jax_trainer(model):
    """The JAX trainer at world 1 over the global batch (4 rows)."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig as JTrain
    from tpu_trainer.training.trainer import ParallelConfig as JPar
    from tpu_trainer.training.trainer import Trainer as JTrainer

    return JTrainer(JConfig(**model), JTrain(**{**TRAIN, "batch_size": 4}),
                    JPar(), mesh=make_mesh(MeshConfig(data=1, fsdp=1),
                                           devices=jax.devices()[:1]))


def _jax_params(path, model):
    """The JAX trainer's initial weights (``init_state(0)``), saved as the
    ``a/b/c``-key npz both sides load."""
    jax = pytest.importorskip("jax")
    from tpu_trainer.serving.remote import save_params_npz

    params = jax.tree.map(np.asarray, _jax_trainer(model).init_state(0).params)
    save_params_npz(path, params)
    return load_params_npz(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World-1 references and checkpoints in this process, then one spawn
    of two ranks for every job."""
    tmp = tmp_path_factory.mktemp("world_rest")
    ref = {}
    # World 1 at two micro-batches of batch 2: rank r's one micro-batch.
    a2 = dict(gradient_accumulation_steps=2)
    ref["q"] = _world1(WIDE, save_dir=str(tmp / "w1_q"),
                       optimizer_state_dtype="int8", **a2)
    ref["off_int8"] = _world1(
        MODEL, save_dir=str(tmp / "w1_off"),
        parallel=dict(sharding_strategy="FULL_SHARD", cpu_offload=True,
                      offload_dtype="int8"), **a2)
    ref["off_bf16"] = _world1(
        MODEL, parallel=dict(cpu_offload=True, offload_dtype="bfloat16"),
        **a2)
    ref["f32"] = _world1(MODEL, **a2)
    npz = {name: str(tmp / f"{name}.npz") for name in ("dense", "moe")}
    params = {"dense": _jax_params(npz["dense"], MODEL),
              "moe": _jax_params(npz["moe"], {**MOE, "moe_impl": "dropless"})}
    # Telemetry: world 1 at one micro-batch of the global batch (4 rows).
    for name, model, key in (("tel", MODEL, "dense"),
                             ("tel_cap", {**MOE, "moe_impl": "capacity"},
                              "moe"),
                             ("tel_dl", {**MOE, "moe_impl": "dropless"},
                              "moe")):
        ref[name] = _world1(model, steps=2, params=params[key],
                            telemetry_at=(1,), batch_size=4)
    off = dict(cpu_offload=True, offload_dtype="int8")
    jobs = [
        {**_job("q_z2", Z2, WIDE, optimizer_state_dtype="int8"),
         "save_at": STEPS, "save_dir": str(tmp / "w2_q_z2")},
        {**_job("q_z3", Z3, WIDE, optimizer_state_dtype="int8"),
         "save_at": STEPS, "save_dir": str(tmp / "w2_q_z3")},
        {**_job("off_z3_int8", Z3, parallel=off),
         "save_at": STEPS, "save_dir": str(tmp / "w2_off")},
        _job("off_z2_bf16", Z2, parallel=dict(cpu_offload=True,
                                              offload_dtype="bfloat16")),
        _job("off_z3_budget", Z3, parallel=dict(
            cpu_offload=True, offload_budget_gb=40000 / 2**30)),
        {**_job("rs_q_z2", Z2, WIDE, steps=0, optimizer_state_dtype="int8"),
         "restore": str(tmp / "w1_q" / "step_00000003")},
        {**_job("rs_off_z3", Z3, steps=0, parallel=off),
         "restore": str(tmp / "w1_off" / "step_00000003")},
        {**_job("tel", Z3, steps=2), "params_npz": npz["dense"],
         "telemetry_at": [1]},
        {**_job("tel_cap", ("replicated", {}),
                {**MOE, "moe_impl": "capacity"}, steps=2),
         "params_npz": npz["moe"], "telemetry_at": [1]},
        {**_job("tel_dl", Z2, {**MOE, "moe_impl": "dropless"}, steps=2),
         "params_npz": npz["moe"], "telemetry_at": [1]},
        {**_job("nan", Z3), "kind": "nan_scan", "params_npz": npz["dense"],
         "plant": {"rank": 1, "layer": 1, "row": 0}},
        {**_job("nan_clean", Z3), "kind": "nan_scan",
         "params_npz": npz["dense"]},
    ]
    out = run_world(tmp, 2, jobs)
    return {"ref": ref, "w2": out, "tmp": tmp, "params": params}


def _moments(sd):
    return {k: v for k, v in sd.items() if k.startswith("opt_state/")}


def _assert_arrays_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


# -- int8 and offload on shards ---------------------------------------------

@pytest.mark.parametrize("name", ["q_z2", "q_z3"])
def test_int8_packs_on_shards_are_the_world1_packs(runs, name):
    """The quantized MLP leaves' packs (a shard that would change the
    block length and a block that straddles the ranks among them), every
    f32 moment and every master, bitwise."""
    tr, state, _, losses = runs["ref"]["q"]
    want = state.state_dict()
    got = assemble([r["records"] for r in runs["w2"][name]])
    got = {k: v for k, v in got.items() if k != "generator"}
    want = {k: v for k, v in want.items() if isinstance(v, np.ndarray)
            and k != "generator"}
    assert "opt_state/nu/layers/mlp/gate_proj/kernel/q" in got
    _assert_arrays_equal(got, want)
    for rank in runs["w2"][name]:
        np.testing.assert_allclose(rank["losses"], losses, rtol=2e-5)


def test_cut_packs_tile_the_one_process_pack():
    """A rank's slice of the one-process pack (``cut_from_global``)
    dequantizes to its slice of the leaf, and the ranks' boxes
    (``cut_boxes``) write every element of ``q`` and ``scale`` exactly
    once. Without the group's max a straddling block scales by its own
    half: the collective is what makes the slices agree."""
    d, world = 1152, 2
    x = torch.randn(3, d, generator=torch.Generator().manual_seed(0))
    x[:, 600] = 50.0                        # rank 1's half of block 4
    whole = quantize_blockwise_int8(x, nonneg=False)
    assert quant_block_len(d) == 128 and quant_block_len(d // world) == 64
    hits_q = np.zeros(tuple(whole.q.shape), np.int64)
    hits_s = np.zeros(tuple(whole.scale.shape), np.int64)
    q_all = np.zeros(tuple(whole.q.shape), np.int8)
    s_all = np.zeros(tuple(whole.scale.shape), np.float32)
    full = whole.q.float() * whole.scale[..., None]
    for r in range(world):
        cut = BlockCut(r * d // world, (r + 1) * d // world, d)
        assert cut.straddles and (cut.first, cut.end) == ((0, 5), (4, 9))[r]
        q, sc = cut_from_global(whole.q.numpy(), whole.scale.numpy(), cut)
        from tpu_trainer_torch.utils.quant import (QuantPack,
                                                   dequantize_blockwise_int8)
        mine = dequantize_blockwise_int8(
            QuantPack(torch.from_numpy(q), torch.from_numpy(sc), cut),
            (3, cut.hi - cut.lo), torch.float32, nonneg=False)
        assert torch.equal(mine, full.reshape(3, d)[:, cut.lo:cut.hi])
        boxes, sboxes = cut_boxes(q, sc, cut)
        for into, hits, bxs in ((q_all, hits_q, boxes),
                                (s_all, hits_s, sboxes)):
            for start, arr in bxs:
                sl = tuple(slice(a, a + n) for a, n in zip(start, arr.shape))
                into[sl] = arr
                hits[sl] += 1
        alone = quantize_blockwise_int8(x[:, cut.lo:cut.hi], nonneg=False,
                                        cut=cut)
        assert np.array_equal(alone.scale.numpy(), sc) == (r == 1)
    assert (hits_q == 1).all() and (hits_s == 1).all()
    np.testing.assert_array_equal(q_all, whole.q.numpy())
    np.testing.assert_array_equal(s_all, whole.scale.numpy())


def test_offloaded_shards_are_the_world1_state(runs):
    """Offload at world 2: int8 (every two-dim leaf packed, most of them
    straddling), bf16, and f32 with a per-device budget, bitwise the
    world-1 state."""
    for name, ref in (("off_z3_int8", "off_int8"), ("off_z2_bf16",
                                                    "off_bf16"),
                      ("off_z3_budget", "f32")):
        want = {k: v for k, v in runs["ref"][ref][1].state_dict().items()
                if isinstance(v, np.ndarray) and k != "generator"}
        got = {k: v for k, v in assemble(
            [r["records"] for r in runs["w2"][name]]).items()
            if k != "generator"}
        _assert_arrays_equal(got, want)


def test_offload_budget_is_per_device(runs):
    """A kept leaf costs its shard's bytes and a leaf with no
    fsdp-divisible dim its full bytes (the JAX
    ``test_partial_offload_budget_is_per_device_under_fsdp``); the world-2
    ranks keep what the rule keeps for the tiny model."""
    meta = {("mu",): torch.empty(64, 32, device="meta"),
            ("nu",): torch.empty(64, 32, device="meta"),
            ("bias",): torch.empty(30, device="meta")}
    big = 64 * 32 * 4
    keep, used = select_resident_moments(meta, big)
    assert len(keep) == 1 and used == big
    keep8, used8 = select_resident_moments(meta, big, shard_count=8)
    assert keep8 == frozenset({("mu",), ("nu",), ("bias",)})
    assert used8 == 2 * (big // 8) + 30 * 4
    shapes = {moment_key(m, n): torch.empty(s, device="meta")
              for n, s in _shapes(MODEL).items() for m in ("mu", "nu")}
    want = select_resident_moments(shapes, 40000, shard_count=2)
    for rank in runs["w2"]["off_z3_budget"]:
        assert rank["offload"]["resident"] == want[1] > 0
        assert [tuple(k) for k in rank["offload"]["keep"]] == sorted(want[0])
    # At one process the same budget counts whole leaves.
    assert select_resident_moments(shapes, 40000) != want


def _shapes(model):
    from tpu_trainer_torch.models.weights import param_specs

    return {n: s for n, (s, _) in param_specs(GPTConfig(**model)).items()}


# -- checkpoints across world sizes -------------------------------------------

@pytest.mark.parametrize("name,ref,model,parallel,osd", [
    ("w2_q_z2", "q", WIDE, {}, "int8"),
    ("w2_q_z3", "q", WIDE, {}, "int8"),
    ("w2_off", "off_int8", MODEL, {"cpu_offload": True,
                                   "offload_dtype": "int8"}, "float32"),
])
def test_world2_checkpoint_restores_at_world1(runs, name, ref, model,
                                              parallel, osd):
    """A world-2 int8 or offloaded checkpoint loads at world 1 into the
    pack one process would hold."""
    path = str(runs["tmp"] / name / "step_00000003")
    assert ckpt.load_meta(path)["shard_world"] == 2
    tr = Trainer(GPTConfig(**model),
                 TrainingConfig(**{**TRAIN, "optimizer_state_dtype": osd,
                                   "gradient_accumulation_steps": 2}),
                 ParallelConfig(**parallel), device="cpu")
    state, _ = ckpt.restore_checkpoint(path, tr)
    want = runs["ref"][ref][1].state_dict()
    got = state.state_dict()
    _assert_arrays_equal(
        {k: v for k, v in got.items() if isinstance(v, np.ndarray)},
        {k: v for k, v in want.items() if isinstance(v, np.ndarray)})


@pytest.mark.parametrize("name,ref", [("rs_q_z2", "q"),
                                      ("rs_off_z3", "off_int8")])
def test_world1_checkpoint_restores_at_world2(runs, name, ref):
    """The other way round: each rank takes its slices of the world-1
    packs, and the ranks' slices tile them."""
    want = {k: v for k, v in runs["ref"][ref][1].state_dict().items()
            if isinstance(v, np.ndarray)}
    got = assemble([r["restored_records"] for r in runs["w2"][name]])
    _assert_arrays_equal(got, want)


# -- telemetry and nan_scan -----------------------------------------------------

@pytest.mark.parametrize("name", ["tel", "tel_cap", "tel_dl"])
def test_world2_telemetry_record_is_the_world1_record(runs, name):
    """ZeRO-3 dense (sharded gradients, masters and updates), the
    capacity router under DDP and the dropless router under ZeRO-2 (the
    router's load, drop and group fractions from the global counts, its
    entropy from the mean probability of every rank)."""
    want = runs["ref"][name][2][0]
    for rank in runs["w2"][name]:
        got, = rank["telemetry"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TEL)
    if name != "tel":
        assert "telemetry/router/entropy/L01" in want
        assert "telemetry/router/mean_prob/L00/max" not in want
    if name == "tel_cap":
        assert any(v > 0 for k, v in want.items()
                   if k.startswith("telemetry/router/drop_frac"))


@pytest.mark.parametrize("name,model", [
    ("tel", MODEL), ("tel_dl", {**MOE, "moe_impl": "dropless"})])
def test_world2_telemetry_record_is_the_jax_record(runs, name, model):
    pytest.importorskip("jax")
    from tpu_trainer.utils import telemetry as jtel

    jtr = _jax_trainer(model)
    jstate = jtr.init_state(0)             # the npz's weights
    for i, batch in enumerate(DummyDataLoader(4, 16, 256, num_batches=2,
                                              seed=11)):
        jstate, jm = jtr.train_step(jstate, batch, telemetry=i == 1)
    want = jtel.flatten_scalars(jm["telemetry"])
    for rank in runs["w2"][name]:
        got, = rank["telemetry"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       **JAX_TEL)


def test_nan_scan_names_the_site_one_process_names(runs):
    """A NaN in rank 1's first row at layer 1's input: both ranks report
    layer 1's attention, as one process does with the NaN in the same row
    of the global batch; without it, no site."""
    tr = Trainer(GPTConfig(**MODEL), TrainingConfig(**{**TRAIN,
                                                       "batch_size": 4}),
                 device="cpu")
    state = tr.init_state(params=from_jax_params(
        runs["params"]["dense"], tr.model_config, device="cpu"))
    from tests.torch_dist_worker import plant_block

    plant_block(tr, 1, 2)                   # rank 1's row 0
    batch = next(iter(DummyDataLoader(4, 16, 256, num_batches=1, seed=11)))
    want = tr.nan_scan(state, batch)
    assert want["first_nan"] == {"site": "attn", "layer": 1}
    for rank in runs["w2"]["nan"]:
        assert rank["first_nan"] == want["first_nan"]
        assert rank["sites"] == want["sites"]
        assert sorted(rank["stats"]) == sorted(want["stats"])
        for k, v in want["stats"].items():
            if np.isfinite(v):
                np.testing.assert_allclose(rank["stats"][k], v, err_msg=k,
                                           **TEL)
            else:
                assert not np.isfinite(rank["stats"][k]), k
    for rank in runs["w2"]["nan_clean"]:
        assert rank["first_nan"] is None and rank["sites"] == []
