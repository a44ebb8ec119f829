"""The port's mesh planner, comms model and ``tools/plan`` against the JAX
package's (``tpu_trainer/parallel/planner.py``, ``comms_model.py``,
``tools/plan.py``) on the same inputs, without a process group.

Held equal: ``enumerate_meshes`` for 1 to 16 devices; the
``feasibility_error`` strings over a grid of meshes for a dense, a MoE,
a GQA and an interleaved model, and ``validate_mesh_config``'s error;
``abstract_params`` leaf by leaf against ``jax.eval_shape``;
``estimate_memory`` and ``build_core`` per axis; the whole ``plan()``
and ``plan_single()`` records for ``TPU v5e`` with ``hbm_gb`` given (up
to float rounding), the rendered table and ``mesh_config_for``. The H100
rows: an SXM card (NVLink 4) and a PCIe card rank the same candidates
with the link-bound ones dearer on PCIe, and an ``hbm_gb`` budget prunes
the meshes that need more. ``tools/plan --json`` run as a module gives
the JAX planner's record; ranks that share a card split its memory. The
counter crosscheck books each call to the split axes of its group, and
flags a planted missing axis, the replicated strategy's gradient sums
over an fsdp axis that the model charges nothing, and the gradient sums
over the sequence ranks, which it charges for the ring alone.
"""

import json
import math
import runpy
import sys

import pytest

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.parallel import comms_model as tcomms
from tpu_trainer_torch.parallel import planner as tplanner
from tpu_trainer_torch.parallel.mesh import MESH_AXES, MeshConfig

SXM = "NVIDIA H100 80GB HBM3"
PCIE = "NVIDIA H100 PCIe"

_MODELS = {
    "dense": dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                  max_seq_len=128),
    "moe": dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                max_seq_len=128, num_experts=4, moe_top_k=2),
    "gqa": dict(vocab_size=512, hidden_size=64, num_layers=4, num_heads=4,
                num_kv_heads=2, max_seq_len=128),
    "interleaved": dict(vocab_size=512, hidden_size=64, num_layers=4,
                        num_heads=4, max_seq_len=128,
                        pipeline_schedule="interleaved",
                        pipeline_microbatches=4),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import types

    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel import comms_model as jcomms
    from tpu_trainer.parallel import planner as jplanner
    from tpu_trainer.parallel.mesh import MeshConfig as JMesh
    return types.SimpleNamespace(Config=JConfig, comms=jcomms,
                                 planner=jplanner, Mesh=JMesh)


def _configs(jx, name, **kw):
    cfg = {**_MODELS[name], **kw}
    return GPTConfig(**cfg), jx.Config(**cfg)


def _close(got, want, path=""):
    """Equal records: the same keys and values, floats to rounding."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-300), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


_SHAPES = {}


def _jax_shapes(jx, jcfg):
    """The JAX ``abstract_params`` tree of ``jcfg`` and its leaves' shapes
    by dotted name (one ``eval_shape`` a config)."""
    import jax

    if jcfg not in _SHAPES:
        tree = jx.comms.abstract_params(jcfg)
        _SHAPES[jcfg] = tree, {
            ".".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return _SHAPES[jcfg]


# -- enumeration and feasibility -----------------------------------------------

def test_enumerate_meshes_1_to_16(jx):
    for n in range(1, 17):
        assert (list(tplanner.enumerate_meshes(n))
                == list(jx.planner.enumerate_meshes(n))), n


_GRID = [dict(zip(MESH_AXES, s)) for s in (
    (1, 1, 1, 1, 1, 1), (2, 2, 1, 1, 1, 1), (1, 1, 2, 2, 1, 1),
    (1, 1, 1, 4, 1, 1), (1, 1, 1, 8, 1, 1), (1, 1, 3, 1, 1, 1),
    (1, 1, 1, 1, 2, 1), (1, 1, 1, 1, 8, 1), (1, 1, 1, 1, 1, 2),
    (1, 1, 1, 1, 1, 3), (1, 1, 1, 2, 1, 2), (4, 1, 1, 1, 1, 2),
    (1, 1, 1, 1, 1, 4), (3, 1, 1, 1, 1, 1), (0, 1, 1, 1, 1, 1))]


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_feasibility_errors_match_jax(jx, name):
    tcfg, jcfg = _configs(jx, name)
    for sizes in _GRID:
        n = max(1, math.prod(sizes.values()))
        for rows, devices in ((8, n), (6, n), (8, n + 1)):
            kw = dict(n_devices=devices, global_rows=rows, max_seq_len=128)
            assert (tplanner.feasibility_error(sizes, tcfg, **kw)
                    == jx.planner.feasibility_error(sizes, jcfg, **kw)), (
                sizes, rows, devices)


def test_validate_mesh_config_matches_jax(jx):
    tcfg, jcfg = _configs(jx, "dense")
    kw = dict(n_devices=8, global_rows=8, max_seq_len=128)
    assert (tplanner.validate_mesh_config(MeshConfig(data=2, tensor=4),
                                          tcfg, **kw)
            == jx.planner.validate_mesh_config(jx.Mesh(data=2, tensor=4),
                                               jcfg, **kw))
    with pytest.raises(ValueError) as ours:
        tplanner.validate_mesh_config(MeshConfig(data=1, tensor=8), tcfg,
                                      **kw)
    with pytest.raises(ValueError) as theirs:
        jx.planner.validate_mesh_config(jx.Mesh(data=1, tensor=8), jcfg,
                                        **kw)
    assert str(ours.value) == str(theirs.value)


# -- the comms model -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(_MODELS))
def test_abstract_params_match_eval_shape(jx, name):
    tcfg, jcfg = _configs(jx, name, dtype="bfloat16")
    assert tcomms.abstract_params(tcfg) == _jax_shapes(jx, jcfg)[1]


_CASES = [
    ("dense", "zero3", {"data": 2, "fsdp": 2, "tensor": 2}),
    ("dense", "zero2", {"fsdp": 4, "sequence": 2}),
    ("dense", "replicated", {"data": 2, "stage": 2, "tensor": 2}),
    ("moe", "zero3", {"expert": 4, "fsdp": 2}),
    ("gqa", "zero3", {"tensor": 2, "sequence": 2, "stage": 2}),
    ("interleaved", "zero2", {"stage": 2, "data": 2}),
]


@pytest.mark.parametrize("name,strategy,axes", _CASES)
def test_build_core_and_memory_match_jax(jx, name, strategy, axes):
    tcfg, jcfg = _configs(jx, name, dtype="bfloat16")
    tree, _ = _jax_shapes(jx, jcfg)
    shapes = tcomms.abstract_params(tcfg)
    kw = dict(batch_size=4, max_seq_len=128)
    for accum in (1, 3):
        got = tcomms.build_core(shapes, axes, strategy, model_config=tcfg,
                                grad_accum=accum, device_kind="TPU v5e",
                                peak_flops=197e12, **kw)
        want = jx.comms.build_core(tree, axes, strategy, model_config=jcfg,
                                   grad_accum=accum, device_kind="TPU v5e",
                                   peak_flops=197e12, **kw)
        _close(got, want)
    for opt, cast in ((4, True), (1, False)):
        _close(tplanner.estimate_memory(shapes, axes, strategy,
                                        model_config=tcfg,
                                        opt_state_bytes=opt,
                                        carry_cast=cast, **kw),
               jx.planner.estimate_memory(tree, axes, strategy,
                                          model_config=jcfg,
                                          opt_state_bytes=opt,
                                          carry_cast=cast, **kw))


# -- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("name,devices", [
    ("dense", 8), ("moe", 8), ("gqa", 4), ("interleaved", 8)])
def test_plan_record_matches_jax(jx, name, devices):
    """The whole ``plan()`` record for ``TPU v5e`` with a budget that
    prunes, its table and its winner's ``MeshConfig``; ``plan_single``
    of the winner's mesh."""
    tcfg, jcfg = _configs(jx, name, dtype="bfloat16")
    kw = dict(global_rows=16, max_seq_len=128, grad_accum=2,
              strategy="zero3", device_kind="TPU v5e", top_k=50)
    peaks = sorted(e["peak_hbm_gb"] for e in tplanner.plan(
        tcfg, devices, **kw)["ranked"])
    kw["hbm_gb"] = peaks[len(peaks) // 2]
    got = tplanner.plan(tcfg, devices, **kw)
    want = jx.planner.plan(jcfg, devices, **kw)
    _close(got, want)
    assert got["pruned"]["hbm"] > 0
    assert tplanner.render_table(got) == jx.planner.render_table(want)
    assert (tplanner.mesh_config_for(got["chosen"]).__dict__
            == jx.planner.mesh_config_for(want["chosen"]).__dict__)
    single = dict(global_rows=16, max_seq_len=128, grad_accum=2,
                  device_kind="TPU v5e", hbm_gb=8)
    _close(tplanner.plan_single(tcfg, got["chosen"]["mesh"], "zero2",
                                **single),
           jx.planner.plan_single(jcfg, want["chosen"]["mesh"], "zero2",
                                  **single))


def test_no_feasible_plan_raises_like_jax(jx):
    tcfg, jcfg = _configs(jx, "dense")
    kw = dict(global_rows=7, max_seq_len=127, grad_accum=1)
    with pytest.raises(tplanner.NoFeasiblePlanError) as ours:
        tplanner.plan(tcfg, 6, **kw)
    with pytest.raises(jx.planner.NoFeasiblePlanError) as theirs:
        jx.planner.plan(jcfg, 6, **kw)
    assert str(ours.value) == str(theirs.value)


def test_h100_rows():
    """NVLink 4 on the SXM card, PCIe Gen5 on the PCIe card: the same
    candidates and compute, the comms dearer by the rate ratio on PCIe;
    the peak from ``utils/logging``; a budget prunes."""
    cfg = GPTConfig.preset("small", dtype="bfloat16")
    kw = dict(global_rows=64, max_seq_len=1024, grad_accum=1,
              strategy="zero3", top_k=100)
    sxm = tplanner.plan(cfg, 8, device_kind=SXM, **kw)
    pcie = tplanner.plan(cfg, 8, device_kind=PCIE, **kw)
    assert sxm["n_feasible"] == pcie["n_feasible"] == len(sxm["ranked"])
    by_mesh = {tuple(e["mesh"].values()): e for e in pcie["ranked"]}
    for e in sxm["ranked"]:
        p = by_mesh[tuple(e["mesh"].values())]
        assert p["compute_ms"] * 756 == pytest.approx(e["compute_ms"] * 989)
        assert p["comms_ms"] * 6.4e10 == pytest.approx(e["comms_ms"] * 4.5e11)
    assert tcomms.peak_flops_for_kind(SXM) == 989e12
    assert tcomms.peak_flops_for_kind(PCIE) == 756e12
    assert tcomms.peak_flops_for_kind("TPU v5 lite") == 197e12
    assert tcomms._link_bytes_per_sec(SXM) == 4.5e11
    assert tcomms._link_bytes_per_sec(PCIE) == 6.4e10
    small = tplanner.plan(cfg, 8, device_kind=SXM, hbm_gb=2.5, **kw)
    assert small["pruned"]["hbm"] > 0
    assert small["hbm_budget_gb"] == 2.5
    assert all(e["peak_hbm_gb"] <= 2.5 for e in small["ranked"])
    assert small["n_feasible"] == sxm["n_feasible"] - small["pruned"]["hbm"]
    assert tplanner.hbm_budget_bytes(2) == 2 * 2**30


def test_ranks_sharing_a_card_split_its_memory(monkeypatch):
    """The budget on a card is its memory over the ranks of the process
    group on it, however they were started (each gathers every rank's
    host and card); a CPU device has none."""
    import torch
    import torch.distributed as dist

    from tpu_trainer_torch.parallel import mesh as mesh_lib

    total = 80 * 2**30
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (total // 2, total))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"uuid": f"card{dev.index}"}))
    monkeypatch.setattr(mesh_lib.socket, "gethostname", lambda: "h")
    # Outside a process group the card is this rank's alone.
    assert tplanner.hbm_budget_bytes(device="cuda:0") == total
    # Four ranks: three on card 0 (spawned, each naming card 0), one on 1.
    cards = [("h", "card0")] * 3 + [("h", "card1")]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)

    def gather(out, obj, group=None):
        out[:] = cards
    monkeypatch.setattr(dist, "all_gather_object", gather)
    assert tplanner.hbm_budget_bytes(device="cuda:0") == total / 3
    assert tplanner.hbm_budget_bytes(device="cuda:1") == total
    assert tplanner.hbm_budget_bytes(40, device="cuda:0") == 40 * 2**30
    assert tplanner.hbm_budget_bytes(device="cpu") is None
    cfg = GPTConfig(**_MODELS["dense"])
    kw = dict(global_rows=8, max_seq_len=128, grad_accum=1, device_kind=SXM)
    assert tplanner.plan(cfg, 4, **kw)["hbm_budget_gb"] == pytest.approx(
        80 / 3)
    assert tplanner.plan(cfg, 4, device="cuda:1", **kw)["hbm_budget_gb"] == 80
    assert tplanner.plan(cfg, 4, device="cpu", **kw)["hbm_budget_gb"] is None


def test_tools_plan_json_matches_jax(jx, capsys, monkeypatch):
    """``python -m tpu_trainer_torch.tools.plan --json`` against the JAX
    planner on the same options and a TPU kind (the rows both tables
    hold), the memory without a compute-dtype copy of the parameters (the
    port holds none); an infeasible split exits 2."""
    argv = ["--model", "tiny", "--devices", "4", "--batch-size", "2",
            "--seq-len", "64", "--strategy", "zero2", "--device-kind",
            "TPU v5e", "--hbm_gb", "1", "--top-k", "3", "--json"]
    monkeypatch.setattr(sys, "argv", ["plan", *argv])
    with pytest.raises(SystemExit) as done:
        runpy.run_module("tpu_trainer_torch.tools.plan", run_name="__main__")
    assert done.value.code == 0
    out = capsys.readouterr().out
    jcfg = jx.Config(vocab_size=256, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=64)
    want = jx.planner.plan(jcfg, 4, global_rows=8, max_seq_len=64,
                           grad_accum=1, strategy="zero2",
                           device_kind="TPU v5e", hbm_gb=1, top_k=3,
                           carry_cast=False)
    _close(json.loads(out.strip().splitlines()[-1]), want)
    from tpu_trainer_torch.tools import plan as plan_tool

    assert plan_tool.main(["--model", "tiny", "--devices", "7", "--seq-len",
                           "64", "--global-batch", "5"]) == 2
    assert "no feasible mesh" in capsys.readouterr().err


# -- the counter crosscheck ------------------------------------------------------

def _record(axes, strategy="zero3"):
    cfg = GPTConfig(**_MODELS["dense"])
    return tcomms.build_core(tcomms.abstract_params(cfg), axes, strategy,
                             model_config=cfg, batch_size=4,
                             max_seq_len=128, grad_accum=1,
                             device_kind=SXM, peak_flops=989e12)


def test_crosscheck_flags_a_missing_axis():
    rec = _record({"sequence": 2, "tensor": 2})
    seq, tp = ("sequence",), ("tensor",)
    calls = {(seq, "ring_permute"): 12, (seq, "ring_permute_bytes"): 4096,
             (tp, "tp_allreduce"): 16, (tp, "tp_allreduce_bytes"): 8192}
    got = tcomms.crosscheck(rec, calls)
    assert got["collective_mismatches"] == []
    assert got["collective_counts"]["sequence"]["bytes"] == 4096
    assert got["collective_counts"]["tensor"]["calls"] == 16
    # Planted: the sequence axis's counter kind missing from the step.
    planted = tcomms.crosscheck(rec, {k: v for k, v in calls.items()
                                      if not k[1].startswith("ring_")})
    assert len(planted["collective_mismatches"]) == 1
    assert "axis 'sequence'" in planted["collective_mismatches"][0]
    assert "ring_permute" in planted["collective_mismatches"][0]


def test_crosscheck_notes_unmodelled_replicated_fsdp_sums():
    """The replicated strategy over an fsdp axis: the trainer sums the
    gradients over the fsdp ranks, and the model (the JAX one's
    arithmetic) charges that axis nothing."""
    rec = _record({"fsdp": 2}, strategy="replicated")
    assert rec["per_axis"]["fsdp"]["bytes"] == 0
    fsdp = ("fsdp",)
    notes = tcomms.crosscheck(rec, {(fsdp, "reduce_scatter"): 5,
                                    (fsdp, "reduce_scatter_bytes"): 100,
                                    (fsdp, "all_gather"): 5,
                                    (fsdp, "all_gather_bytes"): 100})
    assert notes["collective_mismatches"] == [
        "counted 10 calls (200 B) of ['all_gather', 'reduce_scatter'] on "
        "axis 'fsdp' but the model charges it nothing"]
    lines = tcomms.summary_lines({**rec, **notes})
    assert lines[-1].startswith("comms_model | collective cross-check: ")


def test_crosscheck_books_each_call_to_its_group():
    """Gradient sums over the sequence ranks (a group of data x fsdp x
    sequence whose only split axis is sequence) count on the sequence
    axis, which the model charges for the ring alone: a note; a group of
    two split axes counts on both; sums of a few scalars count and are
    noted nowhere."""
    rec = _record({"data": 2, "sequence": 2}, strategy="zero3")
    seq, both = ("sequence",), ("data", "sequence")
    calls = {(seq, "ring_permute"): 12, (seq, "ring_permute_bytes"): 4096,
             (both, "reduce_scatter"): 3, (both, "reduce_scatter_bytes"): 900,
             (both, "all_gather"): 3, (both, "all_gather_bytes"): 300,
             (both, "scalars"): 2, (both, "scalars_bytes"): 12}
    got = tcomms.crosscheck(rec, calls)
    counts = got["collective_counts"]
    assert counts["data"]["calls"] == 8 and counts["data"]["bytes"] == 1212
    assert counts["sequence"]["calls"] == 20
    assert counts["sequence"]["kinds"] == {
        "all_gather": 3, "reduce_scatter": 3, "ring_permute": 12,
        "scalars": 2}
    assert counts["fsdp"]["calls"] == 0
    assert got["collective_mismatches"] == [
        "counted 6 calls (1.2e+03 B) of ['all_gather', 'reduce_scatter'] on "
        "axis 'sequence' but the model charges it for ['ring_permute'] "
        "only"]
    scalars_only = {k: v for k, v in calls.items()
                    if k[1] not in ("reduce_scatter", "reduce_scatter_bytes",
                                    "all_gather", "all_gather_bytes")}
    assert tcomms.crosscheck(rec, scalars_only)["collective_mismatches"] == [
        f"modeled {rec['per_axis']['data']['bytes']:.3g} B/step on axis "
        "'data' but none of ('reduce_scatter', 'all_gather') ran"]


def test_collectives_book_calls_to_the_split_axes():
    """``collectives.group_calls`` keys a call by the split axes of its
    group, a scalar-sized plain sum under ``scalars``."""
    import torch

    from tpu_trainer_torch.parallel import collectives as coll_lib

    c = coll_lib.Collectives.__new__(coll_lib.Collectives)
    c.axes = ("data", "sequence")
    before = dict(coll_lib.group_calls)
    c._count("reduce_scatter", torch.zeros(64))
    c._count("reduce_scatter", torch.zeros(4))
    c._count("tp_max", torch.zeros(4))
    ran = {k: v - before.get(k, 0) for k, v in coll_lib.group_calls.items()
           if v != before.get(k, 0)}
    assert ran == {(c.axes, "reduce_scatter"): 1,
                   (c.axes, "reduce_scatter_bytes"): 256,
                   (c.axes, "scalars"): 1, (c.axes, "scalars_bytes"): 16,
                   (c.axes, "tp_max"): 1, (c.axes, "tp_max_bytes"): 16}
