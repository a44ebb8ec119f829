"""The port's mesh, feed and ZeRO rules against the JAX package's
(``tpu_trainer/parallel/mesh.py``, ``sharding.py``), without a process
group: pure functions of shapes and sizes, compared exactly."""

import pytest

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.weights import param_specs
from tpu_trainer_torch.parallel import mesh as tmesh
from tpu_trainer_torch.parallel import sharding as tshard
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import ParallelConfig, Trainer

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4)


@pytest.mark.parametrize("axes,n", [
    ({}, 1), ({}, 8), ({"data": 2, "fsdp": 4}, 8), ({"data": 1, "fsdp": -1}, 4),
    ({"data": -1, "fsdp": 2}, 6), ({"data": 4}, 8), ({"data": -1, "fsdp": 3}, 8),
    ({"data": -1, "fsdp": -1}, 4), ({"data": 2, "fsdp": 2}, 1),
])
def test_mesh_resolve_matches_jax(axes, n):
    from tpu_trainer.parallel.mesh import MeshConfig as JMesh

    def outcome(cfg):
        try:
            return cfg.resolve(n)
        except ValueError as e:
            return ("error", str(e))

    assert outcome(tmesh.MeshConfig(**axes)) == outcome(JMesh(**axes))


def test_unported_axes_raise_naming_their_entry():
    tmesh.check_ported((2, 2, 1, 1, 1, 1))
    # The sequence ring, tensor and expert parallelism run.
    tmesh.check_ported((1, 2, 2, 2, 1, 1))
    tmesh.check_ported((1, 1, 1, 1, 2, 1))
    tmesh.check_ported((2, 1, 1, 1, 4, 1))
    # And the pipeline's stage axis: no axis is left unported.
    sizes = tuple(2 if ax == "stage" else 1 for ax in tmesh.MESH_AXES)
    tmesh.check_ported(sizes)
    tmesh.check_ported((2, 2, 2, 1, 2, 4))
    assert tmesh.UNPORTED_AXES == {}


def _feed(axes, n_proc, pidx, rows=16):
    from tpu_trainer.parallel.mesh import MeshConfig as JMesh

    sizes = JMesh(**axes).resolve(8)
    per = 8 // n_proc
    return tmesh.host_feed_info(sizes, rows, process_of_device=lambda d:
                                d // per, process_index=pidx)


def test_feed_disjoint_data_hosts():
    # data=8 over 4 hosts of 2 devices: classic disjoint feeding.
    assert [_feed({"data": 8}, 4, p) for p in range(4)] == [
        (0, 4), (1, 4), (2, 4), (3, 4)]


def test_feed_sequence_axis_spanning_hosts():
    # data=2 x sequence=4 over 4 hosts: host pairs share a data shard.
    axes = {"data": 2, "fsdp": 1, "sequence": 4}
    assert [_feed(axes, 4, p) for p in range(4)] == [
        (0, 2), (0, 2), (1, 2), (1, 2)]


def test_feed_all_hosts_replicated():
    axes = {"data": 1, "fsdp": 1, "sequence": 8}
    assert [_feed(axes, 4, p) for p in range(4)] == [(0, 1)] * 4


def test_feed_interleaved_layout_rejected():
    with pytest.raises(ValueError, match="not contiguous"):
        tmesh.host_feed_info((8, 1, 1, 1, 1, 1), 16,
                             process_of_device=lambda d: d % 2,
                             process_index=0)


def test_feed_matches_jax_host_feed_info():
    """The port's rule against the JAX function on the real batch
    sharding, for every process of several layouts."""
    from tpu_trainer.parallel.mesh import MeshConfig as JMesh
    from tpu_trainer.parallel.mesh import (batch_sharding, host_feed_info,
                                           make_mesh)

    for axes, n_proc in (({"data": 8}, 4), ({"data": 2, "fsdp": 4}, 2),
                         ({"data": 2, "fsdp": 2, "sequence": 2}, 4),
                         ({"data": 1, "fsdp": 8}, 8)):
        mesh = make_mesh(JMesh(**axes))
        per = 8 // n_proc
        for p in range(n_proc):
            want = host_feed_info(batch_sharding(mesh), (1, 16, 8),
                                  row_dim=1,
                                  process_of_device=lambda d: d.id // per,
                                  process_index=p)
            assert _feed(axes, n_proc, p) == want, (axes, p)


def test_trainer_single_process_degenerates():
    tr = Trainer(GPTConfig(**TINY, max_seq_len=16),
                 TrainingConfig(batch_size=2, max_seq_len=16,
                                gradient_accumulation_steps=3),
                 ParallelConfig(sharding_strategy="FULL_SHARD"),
                 device="cpu")
    assert (tr.data_feed_rank, tr.data_feed_world) == (0, 1)
    assert (tr.process_index, tr.process_count, tr.dp_size) == (0, 1, 1)
    assert tr.is_main_process and tr.global_batch_size == 6
    assert tr.tokens_per_step == 6 * 16
    assert tr.feed_signature == {"global_batch_size": 6, "feed_world": 1}
    assert tr.topology is None and tr.model.zero3 is None


def _jax_leaves(cfg_kw):
    """The JAX model's abstract param leaves as ``{a/b/c: shape}``."""
    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.parallel.comms_model import abstract_params

    import jax

    tree = abstract_params(JConfig(**cfg_kw))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf.shape
    return out


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_fsdp_spec_matches_jax_on_every_leaf(preset):
    from tpu_trainer.parallel.sharding import (fsdp_spec,
                                               grads_specs_from_sizes,
                                               opt_state_specs_from_sizes,
                                               params_specs_from_sizes)

    cfg_kw = TINY if preset == "tiny" else {}
    jleaves = _jax_leaves(cfg_kw)
    cfg = GPTConfig(**cfg_kw) if cfg_kw else GPTConfig.preset("small")
    ours = {n.replace(".", "/"): s for n, (s, _) in param_specs(cfg).items()}
    assert ours == {k: tuple(v) for k, v in jleaves.items()}
    for n in (2, 4, 8):
        for key, shape in ours.items():
            assert tshard.fsdp_spec(shape, n) == tuple(fsdp_spec(shape, n)), \
                (key, n)
        # The per-strategy split of params, grads and moments.
        import jax

        tree = {k: jax.ShapeDtypeStruct(s, "float32") for k, s in
                ours.items()}
        for strategy in ("FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD",
                         "HYBRID_SHARD"):
            specs = tshard.leaf_specs(ours, strategy, n)
            for fn, field in ((params_specs_from_sizes, "param_dim"),
                              (grads_specs_from_sizes, "state_dim"),
                              (opt_state_specs_from_sizes, "state_dim")):
                want = fn(tree, {"fsdp": n}, strategy)
                for key, spec in want.items():
                    dim = getattr(specs[key], field)
                    got = () if dim is None else tuple(
                        "fsdp" if i == dim else None
                        for i in range(len(ours[key])))
                    assert got == tuple(spec), (key, strategy, field)


def test_strategy_aliases_match_jax():
    from tpu_trainer.parallel.sharding import STRATEGY_ALIASES

    assert tshard.STRATEGY_ALIASES == STRATEGY_ALIASES
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        tshard.canonical_strategy("ZERO9")
