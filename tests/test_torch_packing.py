"""Port parity: sequence packing and the packed training path.

- The port's ``data/packing.py`` against the JAX package's, bitwise: the
  synthetic corpus, first-fit and best-fit rows and segment ids, the
  pad-to-seq baseline, ``PackedDataLoader`` batches, ``non_pad_frac``,
  ``state_dict`` and the resumed cursor, and ``packed_synthetic_loader``
  against ``training/cli.py::_packed_synthetic_loader``.
- A tiny packed ``Trainer(device="cpu")`` trajectory against the JAX
  ``Trainer`` on the same packed batches and weights (vocab 128, hidden
  32, 2 layers, seq 32, f32, dropout off, flash attention: the port's CPU
  path is the plain attention with segment masks, the JAX one its
  segment-aware dispatch). Tolerances as ``test_torch_train.py``'s
  trajectory: loss, grad norm and lr rtol 1e-4, final parameters atol
  1e-4 (Adam turns O(ulp) gradient differences of near-zero elements into
  O(lr) steps).
"""

import types

import numpy as np
import pytest

from tpu_trainer_torch.data import packing as tpack


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax

    from tpu_trainer.data import packing
    return types.SimpleNamespace(jax=jax, packing=packing)


def _docs(seed=3, n=60, mean=12, vocab=97):
    return lambda: tpack.synthetic_documents(n, mean, vocab, seed=seed)


def test_synthetic_documents_bitwise(jx):
    for args in ((50, 12, 97, 3), (20, 300, 50257, 17, 5)):
        want = list(jx.packing.synthetic_documents(*args))
        assert list(tpack.synthetic_documents(*args)) == want


@pytest.mark.parametrize("strategy,bins,lookahead", [
    ("first_fit", 8, 64), ("first_fit", 1, 64), ("best_fit", 8, 64),
    ("best_fit", 2, 4)])
@pytest.mark.parametrize("seq_len", [16, 37])
def test_pack_documents_bitwise(jx, strategy, bins, lookahead, seq_len):
    docs = list(_docs()())
    want = list(jx.packing.pack_documents(docs, seq_len, bins, strategy,
                                          lookahead))
    got = list(tpack.pack_documents(docs, seq_len, bins, strategy, lookahead))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_pad_documents_and_split_long_bitwise(jx):
    docs = list(_docs(mean=30)())
    for g, w in zip(tpack.pad_documents(docs, 16),
                    jx.packing.pad_documents(docs, 16), strict=True):
        np.testing.assert_array_equal(g, w)
    assert list(tpack._split_long(list(range(40)), 16)) == list(
        jx.packing._split_long(list(range(40)), 16))
    with pytest.raises(ValueError, match="strategy"):
        list(tpack.pack_documents(docs, 16, strategy="worst_fit"))


@pytest.mark.parametrize("pack,strategy", [(True, "first_fit"),
                                           (True, "best_fit"),
                                           (False, "first_fit")])
def test_loader_batches_frac_and_resume_bitwise(jx, pack, strategy):
    kw = dict(pack=pack, strategy=strategy, seed=5, drop_last=False)
    jl = jx.packing.PackedDataLoader(_docs(), 3, 16, **kw)
    tl = tpack.PackedDataLoader(_docs(), 3, 16, **kw)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) > 2
    for g, w in zip(tb, jb):
        np.testing.assert_array_equal(g, w)
    assert tl.non_pad_frac == jl.non_pad_frac < 1.0
    assert tl.last_non_pad_frac == jl.last_non_pad_frac

    # Resume after two batches: the JAX loader's cursor drives the port's.
    jl2 = jx.packing.PackedDataLoader(_docs(), 3, 16, **kw)
    it = iter(jl2)
    next(it), next(it)
    state = jl2.state_dict()
    tl2 = tpack.PackedDataLoader(_docs(), 3, 16, **kw)
    tl2.load_state_dict(state)
    assert tl2.state_dict() == state
    rest = list(tl2)
    assert len(rest) == len(jb) - 2
    for g, w in zip(rest, jb[2:]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="packed"):
        tl2.load_state_dict({"kind": "dummy"})


def test_packed_synthetic_loader_matches_cli_helper(jx):
    from tpu_trainer.training.cli import _packed_synthetic_loader

    for kw in (dict(feed_rank=0, feed_world=1, max_open_bins=8),
               dict(feed_rank=1, feed_world=2, max_open_bins=4,
                    strategy="best_fit")):
        want = list(_packed_synthetic_loader(4, 64, 300, 3, 17, **kw))
        got = list(tpack.packed_synthetic_loader(4, 64, 300, 3, 17, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.shape == (4, 64, 2)
            np.testing.assert_array_equal(g, w)


BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=32, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2,
            use_flash_attention=True)


@pytest.mark.parametrize("accum", [1, 2])
def test_packed_trainer_trajectory_matches_jax(jx, accum):
    import torch

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.training.trainer import ParallelConfig, Trainer
    from tpu_trainer_torch.models.config import GPTConfig as TConfig
    from tpu_trainer_torch.models.weights import from_jax_params, to_jax_params
    from tpu_trainer_torch.training.config import TrainingConfig as TTrain
    from tpu_trainer_torch.training.trainer import Trainer as TTrainer

    steps = 5
    tkw = dict(batch_size=2, max_seq_len=32, gradient_accumulation_steps=accum,
               mixed_precision="fp32", learning_rate=3e-3, warmup_steps=2,
               max_steps=steps, seed=0)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1),
                     devices=jx.jax.devices()[:1])
    jtr = Trainer(GPTConfig(**BASE), TrainingConfig(**tkw), ParallelConfig(),
                  mesh=mesh)
    jstate = jtr.init_state(0)
    ttr = TTrainer(TConfig(**BASE), TTrain(**tkw), device="cpu")
    tree = jx.jax.tree.map(np.asarray, jstate.params)
    tstate = ttr.init_state(params=from_jax_params(tree, ttr.model_config,
                                                   device="cpu"))
    loader = tpack.packed_synthetic_loader(2 * accum, 32, 128, steps, 17)
    rows = []
    for batch in loader:
        assert batch.shape == (2 * accum, 32, 2)
        assert (batch[..., 1] == 0).any() or (batch[..., 1] > 1).any()
        jstate, jm = jtr.train_step(jstate, batch)
        tstate, tm = ttr.train_step(tstate, batch)
        rows.append(({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")},
                     tm))
    assert len(rows) == steps and tstate.step == steps
    for j, t in rows:
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-7,
                                       err_msg=key)
    want = _flat(jx.jax.tree.map(np.asarray, jstate.params))
    got = _flat(to_jax_params(tstate.params))
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, rtol=0,
                                   err_msg=n)
    assert isinstance(tstate.params["norm.weight"], torch.nn.Parameter)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.asarray(v)
    return out
