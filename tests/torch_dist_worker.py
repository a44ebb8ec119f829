"""One rank of a multi-process port test, run as a script:

    python tests/torch_dist_worker.py <spec.json> <rank>

``spec.json`` names the world size, a ``file://`` rendezvous store (no
TCP port, so parallel test workers never collide) and a list of jobs;
each job writes ``<out>/<name>_r<rank>.pt`` (``torch.save`` of a dict of
numpy arrays and scalars) for the test to compare. Jobs:

- ``train``: a ``Trainer`` at the job's strategy, mesh and ``parallel``
  options (offload) takes ``steps`` steps of ``DummyDataLoader`` batches
  (this rank's rows), a telemetry step at each index of ``telemetry_at``;
  writes the losses, grad norms, the flattened telemetry records, the
  offload's kept leaves and bytes, this rank's local arrays at init and
  at the end, its ``shard_records()``, the collectives it ran
  (``collectives.calls``), with ``eval`` the ``eval_step`` of the first
  batch after the last step (``eval: "init"``: before the first step), with ``record_dropout`` every residual
  dropout call's seed, offsets and kept mask (``record_dropout`` below),
  with ``plant_local_fold`` the pipeline's dropout fold keyed by the
  rank's local layer index instead of the global one (a planted fault),
  with ``plant_moe: "no_combine"`` a MoE layer's sum over the expert and
  tensor ranks dropped (a planted fault),
  with ``record_moe`` every MoE layer call's router aux and, for the
  capacity router, its queue positions and keep mask (``record_moe``
  below; ``zero_offsets_rank`` plants a fault there), and optionally arms
  a fault plan
  (``faults``), saves a checkpoint at each step of ``save_at``, restores
  a checkpoint (``restore``) into a fresh state and restores the newest
  loadable checkpoint of a directory (``restore_latest``; every rank
  lists the directory before any rank goes on, so a rank that renames
  cannot hide a step from a slower peer's scan);
- ``dropout``: this rank's residual keep mask and attention seed, drawn
  the way the training forward draws them;
- ``guards``: ``check_hosts_in_sync`` on agreeing and disagreeing
  ``(step, loss)`` pairs, and the mesh's ``global_any`` and
  ``broadcast_from_host0``;
- ``nan_scan``: ``Trainer.nan_scan`` of the first batch, with a NaN
  planted (``plant``: ``{"rank", "layer", "row"}``) in one rank's rows at
  the input of one layer (``plant_block``);
- ``tp_loss``: ``ops.loss._tp_loss`` over a tensor group of every rank,
  on the inputs of an npz (``inputs``: ``emb``, ``x``, ``labels``,
  ``mask``), this rank holding its hidden slice of ``emb``: the loss and
  the gradients of the slice and of ``x``;
- ``ring``: ``ops.ring.ring_attention_local`` over a sequence group of
  every rank (``collectives.SequencePermute``), on this rank's chunk of
  the npz's ``q``, ``k``, ``v``: the output chunk and its gradients for
  the npz's cotangent ``g``;
- ``mesh_dropout``: the residual keep mask of a ``[rows, seq, hidden]``
  activation (this rank's slice under sequence) and two attention seeds,
  drawn as the training forward draws them under the job's mesh;
- ``moe_layer``: ``models.moe.moe_ffn`` of each config of ``cases`` on
  the npz's inputs (``inputs``: ``x``, ``router``, ``gate``, ``up``,
  ``down``, ``dout``) over an expert group of every rank, this rank
  holding its experts' slices: the output, aux, queue positions and keep
  mask, and the gradients of ``x``, the router and its expert slices for
  the cotangent ``dout`` (aux's 1);
- ``quant_cut``: the int8 pack of this rank's tensor slice of the npz's
  ``leaf`` (a ``BlockCut`` over a tensor group of every rank), as
  ``cut_boxes`` places it in the one-process pack;
- ``errors``: the messages of trainers, forwards, train steps and CLI
  runs that must refuse (``cases``: ``{name: {"model", "mesh", "train",
  "parallel", "forward", "step", "window_delta"}}``, ``step``: one train
  step of a dummy batch, ``window_delta``: the pipeline's simulated
  window changed by that much, a planted fault; or ``{name: {"argv"}}``
  for ``run_training``);
- ``cli``: ``training.cli.run_training(argv)`` in this process (the group
  is the worker's) for each argv of ``runs``, optionally removing a step
  directory first (``remove``), and ``eval.infer.main`` for each of
  ``infer``; returns the infer results.

The CPU only, gloo, f32.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_trainer_torch.data.dummy import DummyDataLoader  # noqa: E402
from tpu_trainer_torch.models.config import GPTConfig  # noqa: E402
from tpu_trainer_torch.models.gpt import _TrainStep  # noqa: E402
from tpu_trainer_torch.models.weights import (  # noqa: E402
    from_jax_params,
    load_params_npz,
)
from tpu_trainer_torch.parallel import collectives  # noqa: E402
from tpu_trainer_torch.parallel import mesh as mesh_lib  # noqa: E402
from tpu_trainer_torch.parallel.mesh import (  # noqa: E402
    MeshConfig,
    initialize_distributed,
)
from tpu_trainer_torch.training.config import TrainingConfig  # noqa: E402
from tpu_trainer_torch.training.trainer import (  # noqa: E402
    ParallelConfig,
    Trainer,
    _moment_arrays,
)
from tpu_trainer_torch.utils import checkpoint as ckpt  # noqa: E402
from tpu_trainer_torch.utils import faults  # noqa: E402
from tpu_trainer_torch.utils import telemetry  # noqa: E402


def local_arrays(state) -> dict:
    """This rank's slice of every checkpoint array, by key."""
    out = {}
    for prefix, tree in state._trees():
        for name, m in tree.items():
            out.update(_moment_arrays(f"{prefix}/{name.replace('.', '/')}",
                                      m))
    return out


def record_moe(out: dict, zero_offsets_rank=None):
    """Wrap ``models/moe.py``'s ``route`` and ``capacity_positions`` to
    append each call's aux (``moe_aux``), positions (``moe_pos``) and keep
    mask (``moe_keep``) to ``out``; ``zero_offsets_rank`` plants a fault:
    that rank's queue positions ignore the earlier ranks' tokens. Returns
    the function that restores the originals."""
    from tpu_trainer_torch.models import moe

    route, positions, offsets = (moe.route, moe.capacity_positions,
                                 moe.rank_offsets)
    for key in ("moe_aux", "moe_pos", "moe_keep"):
        out[key] = []

    def rec_route(*a, **k):
        res = route(*a, **k)
        out["moe_aux"].append(float(res[2].detach()))
        return res

    def rec_positions(*a, **k):
        pos, keep = positions(*a, **k)
        out["moe_pos"].append(pos.numpy())
        out["moe_keep"].append(keep.numpy())
        return pos, keep

    def zero_offsets(counts, rank, *layout):
        if rank == zero_offsets_rank:
            return counts[0] * 0
        return offsets(counts, rank, *layout)

    moe.route, moe.capacity_positions = rec_route, rec_positions
    moe.rank_offsets = zero_offsets

    def restore():
        moe.route, moe.capacity_positions, moe.rank_offsets = (
            route, positions, offsets)
    return restore


def record_dropout(out: list):
    """Wrap ``models/gpt.py``'s ``hash_dropout`` to append each call's
    ``(seed, offset, total, seq_slice, kept mask)`` to ``out``; returns the
    function that restores it."""
    from tpu_trainer_torch.models import gpt

    orig = gpt.hash_dropout

    def rec(x, rate, seed, **kw):
        y = orig(x, rate, seed, **kw)
        out.append((int(seed), int(kw.get("offset", 0)),
                    int(kw.get("total", 0)), kw.get("seq_slice"),
                    (y != 0).numpy()))
        return y
    gpt.hash_dropout = rec

    def restore():
        gpt.hash_dropout = orig
    return restore


def make_trainer(job) -> Trainer:
    mesh = MeshConfig(**job.get("mesh", {}))
    return Trainer(GPTConfig(**job["model"]), TrainingConfig(**job["train"]),
                   ParallelConfig(mesh=mesh,
                                  sharding_strategy=job["strategy"],
                                  **job.get("parallel", {})),
                   device="cpu")


def plant_block(trainer: Trainer, layer: int, row: int) -> None:
    """Make ``trainer``'s forward put a NaN into row ``row`` of layer
    ``layer``'s input (a non-finite activation in those rows only)."""
    block = trainer.model._train_block
    calls = {"n": 0}

    def planted(x, p, step):
        if calls["n"] % trainer.model_config.num_layers == layer:
            x = x.clone()
            x[row, 0, 0] = float("nan")
        calls["n"] += 1
        return block(x, p, step)
    trainer.model._train_block = planted


def _first_batch_eval(tr, job, state) -> float:
    """``eval_step`` of this rank's rows of the job's first batch."""
    first = next(iter(DummyDataLoader(
        tr.global_batch_size, job["train"]["max_seq_len"],
        job["model"]["vocab_size"], num_batches=1,
        seed=job.get("data_seed", 11), process_index=tr.data_feed_rank,
        process_count=tr.data_feed_world)))
    return float(tr.eval_step(state, first))


def load_params(job, tr):
    if not job.get("params_npz"):
        return None
    return from_jax_params(load_params_npz(job["params_npz"]),
                           tr.model_config, device="cpu")


def train(job) -> dict:
    if job.get("faults"):
        faults.install(job["faults"])
    collectives.calls.clear()
    moe_out = {}
    restore_moe = (record_moe(moe_out, job.get("zero_offsets_rank"))
                   if job.get("record_moe") else None)
    drops = []
    restore_drop = (record_dropout(drops) if job.get("record_dropout")
                    else None)
    from tpu_trainer_torch.models import moe

    expert_sum = moe.expert_sum
    if job.get("plant_moe") == "no_combine":
        moe.expert_sum = lambda out, group: out
    tr = make_trainer(job)
    if job.get("plant_local_fold"):
        tr.model.stage_layers = list(range(len(tr.model.stage_layers)))
    state = tr.init_state(params=load_params(job, tr))
    out = {"init": local_arrays(state), "losses": [], "grad_norms": [],
           "feed": (tr.data_feed_rank, tr.data_feed_world),
           "telemetry": [],
           "offload": {"keep": sorted(tr._offload_keep),
                       "resident": tr.offload_resident_bytes}}
    if job.get("eval") == "init":
        out["eval"] = _first_batch_eval(tr, job, state)
    loader = DummyDataLoader(tr.global_batch_size, job["train"]["max_seq_len"],
                             job["model"]["vocab_size"],
                             num_batches=job["steps"],
                             seed=job.get("data_seed", 11),
                             process_index=tr.data_feed_rank,
                             process_count=tr.data_feed_world)
    for batch in loader:
        if job.get("scale_grad_rank") == tr.process_index and state.step == 1:
            # A planted fault: this rank's gradient shard scaled before
            # the update (the test requires the run to be caught).
            orig = tr.optimizer.apply

            def scaled(grads, *a, **k):
                return orig({n: g * 1.5 for n, g in grads.items()}, *a, **k)
            tr.optimizer.apply = scaled
        state, m = tr.train_step(
            state, batch,
            telemetry=state.step in job.get("telemetry_at", []))
        if "telemetry" in m:
            out["telemetry"].append(telemetry.flatten_scalars(
                m["telemetry"]))
        out["losses"].append(m["loss"])
        out["grad_norms"].append(m["grad_norm"])
        save_at = job.get("save_at")
        if state.step in (save_at if isinstance(save_at, list)
                          else [save_at]):
            ckpt.save_checkpoint(job["save_dir"], state,
                                 model_config=tr.model_config,
                                 training_config=tr.training_config,
                                 data_state={"kind": "dummy", "epoch": 0,
                                             "batch_index": state.step,
                                             "seed": 11,
                                             **tr.feed_signature})
    moe.expert_sum = expert_sum
    if job.get("eval") is True:
        out["eval"] = _first_batch_eval(tr, job, state)
    if restore_drop is not None:
        restore_drop()
        out["dropout"] = drops
    out["final"] = local_arrays(state)
    out["records"] = state.shard_records()
    out["scalars"] = state.scalars()
    out["collectives"] = dict(collectives.calls)
    out["pipeline"] = dataclasses.asdict(tr.pipeline_stats)
    if restore_moe is not None:
        restore_moe()
        out.update(moe_out)
    if job.get("restore"):
        restored, meta = ckpt.restore_checkpoint(job["restore"],
                                                 make_trainer(job))
        out["restored"] = local_arrays(restored)
        out["restored_records"] = restored.shard_records()
        out["restored_scalars"] = restored.scalars()
        out["restored_generator"] = restored.generator.get_state().numpy()
    if job.get("restore_latest"):
        scan = ckpt.list_checkpoints

        def scan_together(d):
            found = scan(d)
            mesh_lib.barrier()
            return found
        ckpt.list_checkpoints = scan_together
        try:
            restored, meta, path = ckpt.restore_latest(
                job["restore_latest"], make_trainer(job))
        finally:
            ckpt.list_checkpoints = scan
        out["latest"] = {"path": path, "step": meta["step"]}
        out["restored"] = local_arrays(restored)
    faults.clear()
    return out


def dropout(job) -> dict:
    tr = make_trainer(job)
    cfg = tr.model_config
    b, s, h = job["rows"], job["train"]["max_seq_len"], cfg.hidden_size
    gen = torch.Generator().manual_seed(job["seed"])
    step = _TrainStep(train=True, generator=gen, rope=None,
                      segment_ids=None, shard=tr.model.data_shard)
    kept = tr.model._residual_dropout(torch.ones(b, s, h), step) != 0
    return {"residual_keep": kept.numpy(),
            "attention_seed": step.attention_seed(),
            "shard": tr.model.data_shard}


def guards(job) -> dict:
    from tpu_trainer_torch.utils.guards import (DivergenceError,
                                                check_hosts_in_sync)

    rank = mesh_lib.process_index()
    check_hosts_in_sync(7, 2.5)
    try:
        check_hosts_in_sync(7, 2.5 + rank)
        caught = None
    except DivergenceError as e:
        caught = str(e)
    mesh_lib.barrier()
    return {"caught": caught,
            "any": mesh_lib.global_any(rank == 1),
            "none": mesh_lib.global_any(False),
            "from0": mesh_lib.broadcast_from_host0({"rank": rank})}


def nan_scan(job) -> dict:
    tr = make_trainer(job)
    state = tr.init_state(params=load_params(job, tr))
    plant = job.get("plant")
    if plant and plant["rank"] == mesh_lib.process_index():
        plant_block(tr, plant["layer"], plant["row"])
    batch = next(iter(DummyDataLoader(
        tr.global_batch_size, job["train"]["max_seq_len"],
        job["model"]["vocab_size"], num_batches=1,
        seed=job.get("data_seed", 11), process_index=tr.data_feed_rank,
        process_count=tr.data_feed_world)))
    return tr.nan_scan(state, batch)


def tp_loss(job) -> dict:
    from tpu_trainer_torch.ops.loss import _tp_loss

    d = np.load(job["inputs"])
    coll = collectives.topology(1, 1, 1, mesh_lib.process_count()).tensor
    emb = torch.from_numpy(d["emb"])
    hc = emb.shape[1] // coll.world
    e_l = emb[:, coll.rank * hc:(coll.rank + 1) * hc].clone()
    e_l.requires_grad_(True)
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    collectives.calls.clear()
    loss = _tp_loss(e_l, x, torch.from_numpy(d["labels"]),
                    torch.from_numpy(d["mask"]), coll, 0)
    de, dx = torch.autograd.grad(loss, (e_l, x))
    return {"loss": loss.detach().numpy(), "de": de.numpy(),
            "dx": dx.numpy(), "calls": dict(collectives.calls)}


def ring(job) -> dict:
    from tpu_trainer_torch.ops.ring import ring_attention_local

    d = np.load(job["inputs"])
    sp = mesh_lib.process_count()
    seq = collectives.topology(1, 1, sp, 1).sequence
    j = seq.rank
    parts = [torch.from_numpy(d[n]).chunk(sp, dim=1)[j].clone()
             .requires_grad_(True) for n in ("q", "k", "v")]
    collectives.calls.clear()
    out = ring_attention_local(
        [parts[0]], [parts[1]], [parts[2]], [j], sp,
        collectives.SequencePermute(seq), zigzag=job.get("zigzag"))[0]
    g = torch.from_numpy(d["g"]).chunk(sp, dim=1)[j]
    grads = torch.autograd.grad(out, parts, g)
    return {"out": out.detach().numpy(),
            "grads": [x.numpy() for x in grads],
            "calls": dict(collectives.calls)}


def mesh_dropout(job) -> dict:
    from tpu_trainer_torch.models.gpt import _attention_coord
    from tpu_trainer_torch.parallel import context as ctx_lib

    tr = make_trainer(job)
    cfg = tr.model_config
    ctx = tr.mesh_context
    b, s, h = job["rows"], job["train"]["max_seq_len"], cfg.hidden_size
    seq = None
    if ctx.sp > 1:
        s //= ctx.sp
        seq = (ctx.sp_rank, ctx.sp, None)
    gen = torch.Generator().manual_seed(job["seed"])
    step = _TrainStep(train=True, generator=gen, rope=None,
                      segment_ids=None, shard=tr.model.data_shard, seq=seq,
                      attn_coord=_attention_coord(ctx, tr.model.data_shard,
                                                  cfg))
    with ctx_lib.use_mesh(ctx):
        kept = tr.model._residual_dropout(torch.ones(b, s, h), step) != 0
    return {"residual_keep": kept.numpy(),
            "attention_seeds": [step.attention_seed() for _ in range(2)],
            "coords": ctx.coords}


def moe_layer(job) -> dict:
    from tpu_trainer_torch.models import moe
    from tpu_trainer_torch.parallel import context as ctx_lib

    d = np.load(job["inputs"])
    ep = mesh_lib.process_count()
    topo = collectives.topology(1, 1, 1, 1, ep)
    sizes = (1, 1, 1, 1, ep, 1)
    ctx = ctx_lib.MeshContext(sizes=sizes, coords=mesh_lib.mesh_coords(
        sizes, mesh_lib.process_index()), expert=topo.expert,
        expert_tensor=topo.expert_tensor)
    x0 = topo.expert_coord
    out = {}
    for name, case in job["cases"].items():
        cfg = GPTConfig(**case)
        n = cfg.num_experts // ep
        x = torch.from_numpy(d["x"]).requires_grad_(True)
        router = torch.from_numpy(d["router"]).requires_grad_(True)
        ws = [torch.from_numpy(d[k][x0 * n:(x0 + 1) * n].copy())
              .requires_grad_(True) for k in ("gate", "up", "down")]
        rec = {}
        restore = record_moe(rec)
        try:
            with ctx_lib.use_mesh(ctx):
                y, aux = moe.moe_ffn(x, router, *ws, cfg, group=topo.rep)
                grads = torch.autograd.grad(
                    [y, aux], [x, router] + ws,
                    [torch.from_numpy(d["dout"]), torch.tensor(1.0)])
        finally:
            restore()
        r = {"out": y.detach().numpy(), "aux": float(aux.detach()),
             "grads": [g.numpy() for g in grads]}
        if rec["moe_pos"]:
            r.update(pos=rec["moe_pos"][0], keep=rec["moe_keep"][0])
        out[name] = r
    return out


def quant_cut(job) -> dict:
    from tpu_trainer_torch.utils.quant import (BlockCut, cut_boxes,
                                               quantize_blockwise_int8)

    leaf = torch.from_numpy(np.load(job["inputs"])["leaf"])
    tp = mesh_lib.process_count()
    coll = collectives.topology(1, 1, 1, tp).tensor
    k = leaf.shape[-1] // tp
    cut = BlockCut(coll.rank * k, (coll.rank + 1) * k, leaf.shape[-1],
                   group=coll)
    out = {}
    for nonneg in (False, True):
        pack = quantize_blockwise_int8(
            leaf[..., cut.lo:cut.hi].contiguous(), nonneg=nonneg, cut=cut)
        out[nonneg] = cut_boxes(pack.q.numpy(), pack.scale.numpy(), cut)
    return out


def errors(job) -> dict:
    from tpu_trainer_torch.parallel import context as ctx_lib

    from tpu_trainer_torch.training import cli as cli_lib

    out = {}
    for name, case in job["cases"].items():
        try:
            if case.get("argv"):
                cli_lib.run_training(case["argv"])
                out[name] = ("ok", None)
                continue
            if case.get("window_delta"):
                from tpu_trainer_torch.parallel import pipeline

                sim = pipeline.window
                pipeline.window = (lambda *a, d=case["window_delta"]:
                                   sim(*a) + d)
                try:
                    tr = make_trainer(case)
                finally:
                    pipeline.window = sim
            else:
                tr = make_trainer(case)
            if case.get("step"):
                state = tr.init_state()
                batch = next(iter(DummyDataLoader(
                    tr.global_batch_size, tr.training_config.max_seq_len,
                    tr.model_config.vocab_size, num_batches=1,
                    process_index=tr.data_feed_rank,
                    process_count=tr.data_feed_world)))
                tr.train_step(state, batch)
            if case.get("forward"):
                ids = torch.zeros((1, tr.training_config.max_seq_len),
                                  dtype=torch.long)
                tr.init_state()
                with ctx_lib.use_mesh(tr.mesh_context):
                    if tr.schedule is not None:
                        tr.model.pipeline_step(
                            ids, ids, [], train=False, backward=False,
                            segment_ids=torch.ones_like(ids))
                    tr.model(ids[:, :ids.shape[1] // tr.mesh_sizes[2]],
                             segment_ids=torch.ones_like(ids))
            out[name] = ("ok", tr.model_config.fused_projections)
        except Exception as e:  # noqa: BLE001 - the message is the result
            out[name] = (type(e).__name__, str(e))
    return out


def cli(job) -> dict:
    import shutil

    from tpu_trainer_torch.eval import infer
    from tpu_trainer_torch.training import cli as cli_lib

    for run in job["runs"]:
        mesh_lib.barrier()
        if run.get("remove") and mesh_lib.process_index() == 0:
            shutil.rmtree(run["remove"])
        mesh_lib.barrier()
        rc = cli_lib.run_training(run["argv"], mode=run.get("mode", "ddp"))
        assert rc == 0, rc
    results = []
    for argv in job.get("infer", []):
        res = {}
        assert infer.main(argv, result=res) == 0
        results.append(res["tokens"])
    return {"infer": results}


def run_world(tmp_path, world: int, jobs, timeout: float = 240.0) -> dict:
    """Run ``jobs`` on ``world`` rank processes (this script); returns
    ``{job name: [rank 0's result, rank 1's, ...]}``. A rank that fails
    or outlives ``timeout`` fails the caller with every rank's output."""
    import subprocess
    import uuid

    tag = uuid.uuid4().hex[:8]
    spec = {"world": world, "store": str(tmp_path / f"store_{tag}"),
            "out": str(tmp_path), "jobs": jobs}
    spec_path = tmp_path / f"spec_{tag}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1", COORDINATOR_TIMEOUT_S="120")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(spec_path), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r} (rc {procs[r].returncode})\n"
                               f"{outs[r][-4000:] if r < len(outs) else ''}"
                               for r in bad)
    return {job["name"]: [torch.load(tmp_path / f"{job['name']}_r{r}.pt",
                                     weights_only=False)
                          for r in range(world)] for job in jobs}


def assemble(records_by_rank) -> dict:
    """Global arrays from every rank's ``shard_records()``."""
    out = {}
    for records in records_by_rank:
        for rec in records:
            buf = out.get(rec["key"])
            if buf is None:
                buf = out[rec["key"]] = np.zeros(rec["global_shape"],
                                                 dtype=rec["dtype"])
            for starts, arr in rec["shards"]:
                buf[tuple(slice(s, s + n) for s, n in
                          zip(starts, arr.shape))] = arr
    return out


def main(spec_path: str, rank: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(num_processes=spec["world"], process_id=rank,
                           init_method=f"file://{spec['store']}")
    for job in spec["jobs"]:
        result = {"train": train, "dropout": dropout, "guards": guards,
                  "nan_scan": nan_scan, "tp_loss": tp_loss, "ring": ring,
                  "mesh_dropout": mesh_dropout, "errors": errors,
                  "cli": cli, "moe_layer": moe_layer,
                  "quant_cut": quant_cut}[job["kind"]](job)
        torch.save(result, os.path.join(spec["out"],
                                        f"{job['name']}_r{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
