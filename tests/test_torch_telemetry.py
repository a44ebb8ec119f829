"""Port parity: in-step telemetry, nan_scan, the goodput ledger, the spike
detector and the deferred fetch (``tpu_trainer_torch/utils/telemetry.py``
against ``tpu_trainer/utils/telemetry.py``).

Weights cross as in ``tests/test_torch_train.py`` (the JAX trainer's
``init_state`` params through ``from_jax_params``), tiny geometry, f32,
dropout off, the same ``DummyDataLoader`` batches on both sides.

Tolerances, and why:
- Telemetry scalars rtol=1e-4 (atol 1e-7 for the near-zero ones): the
  stats are f32 reductions of activations, gradients and updates that
  already agree at the trainer tests' 1e-4 (``test_torch_train.py``).
- The recombination identity rel 1e-6: the same f32 sums in one fixed
  order on both sides of the identity, so only the final square roots'
  rounding differs.
- Everything host-side (ledger records, spike decisions, nan_report sites,
  flattened keys) is compared exactly.
"""

import math
import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.models import moe as tmoe
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.weights import from_jax_params, init_params
from tpu_trainer_torch.training.config import TrainingConfig as TTrain
from tpu_trainer_torch.training.optimizer import global_norm
from tpu_trainer_torch.training.trainer import Trainer as TTrainer
from tpu_trainer_torch.utils import telemetry

BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=16, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2)
MOE = dict(num_experts=4, moe_top_k=2, moe_impl="dropless",
           use_flash_attention=False)
TEL_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig
    from tpu_trainer.utils import telemetry as jtel
    return types.SimpleNamespace(jax=jax, jnp=jnp, GPTConfig=GPTConfig,
                                 tel=jtel)


def _tkw(accum):
    return dict(batch_size=2, max_seq_len=16, gradient_accumulation_steps=accum,
                mixed_precision="fp32", learning_rate=3e-3, warmup_steps=1,
                max_steps=10, seed=0)


def _jax_trainer(jx, mkw, tkw):
    from tpu_trainer.parallel.mesh import MeshConfig, make_mesh
    from tpu_trainer.training.config import TrainingConfig
    from tpu_trainer.training.trainer import ParallelConfig, Trainer

    mesh = make_mesh(MeshConfig(data=1, fsdp=1),
                     devices=jx.jax.devices()[:1])
    return Trainer(jx.GPTConfig(**mkw), TrainingConfig(**tkw),
                   ParallelConfig(), mesh=mesh)


def _pair(jx, mkw, tkw):
    """The JAX and the port trainer on the same initial weights."""
    jtr = _jax_trainer(jx, mkw, tkw)
    jstate = jtr.init_state(0)
    ttr = TTrainer(TConfig(**mkw), TTrain(**tkw), device="cpu")
    tree = jx.jax.tree.map(np.asarray, jstate.params)
    tstate = ttr.init_state(params=from_jax_params(tree, ttr.model_config,
                                                   device="cpu"))
    return jtr, jstate, ttr, tstate


@pytest.mark.parametrize("case,accum", [("dense", 1), ("dense", 2),
                                        ("moe", 1)])
def test_telemetry_step_matches_jax(jx, case, accum):
    """Two steps, the second a telemetry step: the same ``telemetry/*``
    keys, every value within rtol 1e-4, and the step's own metrics too."""
    mkw = {**BASE, **({"use_flash_attention": True} if case == "dense"
                      else MOE)}
    tkw = _tkw(accum)
    jtr, jstate, ttr, tstate = _pair(jx, mkw, tkw)
    loader = DummyDataLoader(batch_size=2 * accum, seq_len=16,
                             vocab_size=128, num_batches=2)
    for i, batch in enumerate(loader):
        jstate, jm = jtr.train_step(jstate, batch, telemetry=i == 1)
        tstate, tm = ttr.train_step(tstate, batch, telemetry=i == 1)
    want = jx.tel.flatten_scalars(jm["telemetry"])
    got = telemetry.flatten_scalars(tm["telemetry"])
    assert sorted(got) == sorted(want)
    assert any(k.startswith("telemetry/act/attn_rms/L01") for k in got)
    if case == "moe":
        assert "telemetry/router/load/L01/max" in got
        assert got["telemetry/router/dropless/L00"] == 1.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TEL_TOL)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-4)


def test_telemetry_step_is_the_plain_step():
    """With dropout on, a telemetry step's loss, parameters, moments and
    generator are bitwise the plain step's: the stats draw nothing."""
    mkw = {**BASE, "dropout": 0.1, "attention_dropout": 0.1,
           "use_flash_attention": True}
    runs = []
    for tel in (False, True):
        tr = TTrainer(TConfig(**mkw), TTrain(**_tkw(2)), device="cpu")
        st = tr.init_state(0)
        losses = [tr.train_step(st, b, telemetry=tel)[1]["loss"]
                  for b in DummyDataLoader(4, 16, 128, 3)]
        runs.append((losses, st))
    (la, a), (lb, b) = runs
    assert la == lb
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
        assert torch.equal(a.opt_state.mu[n], b.opt_state.mu[n]), n
        assert torch.equal(a.opt_state.nu[n], b.opt_state.nu[n]), n
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_records_once_and_equal(policy):
    """Under remat the backward reruns every block; the stats are the
    first forward's, one entry a layer, bitwise those without remat."""
    stats = {}
    for remat in (False, True):
        cfg = TConfig(**{**BASE, "num_layers": 3, "use_flash_attention": True,
                         "gradient_checkpointing": remat,
                         "remat_policy": policy})
        model = TGPT(cfg, device="meta")
        model.load_state_dict(
            {n: torch.nn.Parameter(t)
             for n, t in init_params(cfg, 0, device="cpu").items()},
            strict=True, assign=True)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, 128, (2, 16))).long()
        # The backward runs inside the capture here on purpose: the rerun
        # must still record nothing.
        with telemetry.capture() as cap:
            _, loss = model(ids, ids, train=True)
            loss.backward()
        stats[remat] = telemetry.assemble(cap.stats)
    for k, v in stats[False]["act"].items():
        assert v.shape == stats[True]["act"][k].shape, k
        assert torch.equal(v, stats[True]["act"][k]), k
    assert stats[True]["act"]["attn_rms"].shape == (3,)


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"layers": {"attn": {"kernel": arr(3, 4, 5), "bias": arr(3, 5)},
                       "mlp": {"w": arr(3, 7)}},
            "embed_tokens": {"embedding": arr(11, 4)},
            "norm": {"scale": arr(4)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            out[name] = torch.from_numpy(v)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_norms_recombine_and_match_jax(jx, seed):
    tree = _tree(seed)
    flat = _flat(tree)
    norms = telemetry.group_norms(flat)
    assert set(norms) == {"per_layer", "embed_tokens", "norm"}
    assert norms["per_layer"].shape == (3,)
    got = float(telemetry.combine_group_norms(norms))
    assert got == pytest.approx(float(global_norm(flat.values())), rel=1e-6)
    want = jx.tel.group_norms(jx.jax.tree.map(jx.jnp.asarray, tree))
    for k, v in want.items():
        np.testing.assert_allclose(norms[k].numpy(), np.asarray(v),
                                   rtol=1e-6, err_msg=k)
    for i in range(3):
        layer = [t[i] for n, t in flat.items() if n.startswith("layers.")]
        assert float(norms["per_layer"][i]) == pytest.approx(
            float(global_norm(layer)), rel=1e-6)


def test_update_norms_fed_leaf_by_leaf_equal_the_tree_norms():
    flat = _flat(_tree(3))
    acc = telemetry.GroupNorms()
    for n, t in flat.items():
        acc.add(n, t)
    for k, v in telemetry.group_norms(flat).items():
        assert torch.equal(acc.norms()[k], v), k


def test_router_stats_match_jax(jx):
    import flax

    from tpu_trainer.models.moe import MoEMLP

    kw = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_seq_len=8, use_flash_attention=False,
              num_experts=4, moe_top_k=2, moe_impl="dropless")
    m = MoEMLP(jx.GPTConfig(**kw))
    x = np.random.default_rng(0).normal(size=(2, 8, 16)).astype(np.float32)
    params = flax.core.unfreeze(m.init(jx.jax.random.PRNGKey(0),
                                       jx.jnp.asarray(x)))["params"]
    with jx.tel.capture() as cap:
        m.apply({"params": params}, jx.jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in cap.stats["router"].items()}
    got = {}
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in
         (("router", params["router"]["kernel"]),
          ("gate", params["experts_gate"]), ("up", params["experts_up"]),
          ("down", params["experts_down"]))}
    tmoe.dropless_moe(torch.from_numpy(x), p["router"], p["gate"], p["up"],
                      p["down"], TConfig(**kw), router_stats=got)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(got["load"].sum()) == pytest.approx(1.0, abs=1e-6)
    assert float(got["drop_frac"]) == 0.0


def test_uniform_router_has_maximal_entropy():
    cfg = TConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                  intermediate_size=32, max_seq_len=8, num_experts=4,
                  moe_top_k=2, moe_impl="dropless")
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0))
    w = [torch.randn(4, 16, 32), torch.randn(4, 16, 32), torch.randn(4, 32, 16)]
    stats = {}
    tmoe.dropless_moe(x, torch.zeros(16, 4), *w, cfg, router_stats=stats)
    assert float(stats["entropy"]) == pytest.approx(math.log(4), abs=1e-4)
    skewed = torch.zeros(16, 4)
    skewed[:, 0] = 50.0
    stats2 = {}
    tmoe.dropless_moe(x, skewed, *w, cfg, router_stats=stats2)
    assert float(stats2["entropy"]) < float(stats["entropy"]) - 0.1


@pytest.mark.parametrize("stats", [
    {"act": {"embed_out_absmax": 1.0, "attn_absmax": np.array([1.0, 2.0]),
             "ffn_absmax": np.array([1.0, np.nan]),
             "block_absmax": np.array([1.0, np.nan]),
             "final_norm_absmax": np.nan}, "loss": np.nan},
    {"act": {"embed_out_absmax": np.inf}, "loss": 1.0},
    {"act": {"embed_out_absmax": 1.0, "logits_absmax": np.nan}, "loss": 2.0},
    {"act": {"embed_out_absmax": 1.0}, "loss": 2.0},
])
def test_nan_report_equals_jax(jx, stats):
    assert telemetry.nan_report(stats) == jx.tel.nan_report(stats)


def test_nan_scan_names_planted_layer_like_jax(jx):
    """An inf in layer 1's attention output projection: both trainers'
    ``nan_scan`` name layer 1, site attn; unplanted, no site."""
    mkw = {**BASE, "use_flash_attention": True}
    jtr, jstate, ttr, tstate = _pair(jx, mkw, _tkw(1))
    batch = next(iter(DummyDataLoader(2, 16, 128, 1)))
    assert ttr.nan_scan(tstate, batch)["first_nan"] is None
    kernel = jstate.params["layers"]["attention"]["o_proj"]["kernel"]
    jparams = dict(jstate.params)
    jparams["layers"] = dict(jparams["layers"])
    jparams["layers"]["attention"] = dict(jparams["layers"]["attention"])
    jparams["layers"]["attention"]["o_proj"] = {
        "kernel": kernel.at[1, 0, 0].set(np.inf)}
    want = jtr.nan_scan(jstate.replace(params=jparams), batch)
    with torch.no_grad():
        tstate.params["layers.attention.o_proj.kernel"][1, 0, 0] = math.inf
    got = ttr.nan_scan(tstate, batch)
    assert got["first_nan"] == want["first_nan"] == {"site": "attn",
                                                    "layer": 1}
    assert got["sites"] == want["sites"]
    assert sorted(got["stats"]) == sorted(want["stats"])


def test_flatten_scalars_equals_jax(jx):
    telem = {"act": {"attn_rms": np.array([1.5, 2.5], np.float32),
                     "embed_out_absmax": np.float32(3.0)},
             "router": {"load": np.arange(8, dtype=np.float32).reshape(2, 4)},
             "grad_norm": {"per_layer": np.array([0.5, 0.25], np.float32),
                           "norm": np.float32(0.125)}}
    tt = {g: {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
          for g, d in telem.items()}
    assert telemetry.flatten_scalars(tt) == jx.tel.flatten_scalars(telem)


def _clock_series(ledger_cls):
    t = [0.0]
    ledger = ledger_cls(clock=lambda: t[0])
    for cat, dt, idle in (("compile", 5.0, 0.25), ("data_wait", 0.5, 0.0),
                          ("step", 3.0, 0.5), ("eval", 1.0, 0.0),
                          ("checkpoint_save", 0.75, 0.125),
                          ("checkpoint_commit_wait", 0.25, 0.0),
                          ("checkpoint_restore", 2.0, 0.0),
                          ("rollback_replay", 1.5, 0.5), ("step", 4.0, 0.0)):
        with ledger.track(cat):
            t[0] += dt
        t[0] += idle
    ledger.add_tokens(4096, 4000)
    ledger.add_tokens(4096)
    return ledger


def test_goodput_ledger_equals_jax(jx):
    a, b = _clock_series(telemetry.GoodputLedger), _clock_series(
        jx.tel.GoodputLedger)
    assert a.record(step=7, final=True) == b.record(step=7, final=True)
    assert a.record() == b.record()
    assert a.summary_lines() == b.summary_lines()
    rec = a.record()
    tracked = sum(v for k, v in rec.items() if k.endswith("_frac")
                  and k not in ("productive_frac", "untracked_frac"))
    assert tracked <= 1.0 + 1e-9


@pytest.mark.parametrize("series", ["noise_then_spike", "descent",
                                    "sustained", "with_nonfinite"])
def test_spike_decisions_equal_jax(jx, series):
    rng = np.random.default_rng(0)
    losses = {
        "noise_then_spike": list(4.0 + 0.05 * rng.standard_normal(60))
        + [8.0, 4.0, 40.0],
        "descent": [10.0 * 0.97 ** i for i in range(80)],
        "sustained": [4.0] * 30 + [40.0, 40.0, 41.0],
        "with_nonfinite": [None, float("nan"), 1000.0]
        + list(2.0 + 0.01 * rng.standard_normal(40)) + [float("inf"), 9.0],
    }[series]
    a = telemetry.SpikeDetector(sigma=6.0)
    b = jx.tel.SpikeDetector(sigma=6.0)
    got = [a.update(x) for x in losses]
    assert got == [b.update(x) for x in losses]
    if series in ("noise_then_spike", "sustained"):
        assert any(s for s, _ in got)
    a.reset()
    assert not a.update(40.0)[0]


def test_deferred_fetcher_window_and_transform():
    d = telemetry.DeferredFetcher(window=2)
    assert d.push(0, {"loss": torch.tensor(1.0)}) == []
    assert d.push(1, {"loss": torch.tensor(2.0)},
                  lambda m: dict(m, loss=-1.0)) == []
    out = d.push(2, {"loss": torch.tensor(3.0),
                     "telemetry": {"x": torch.tensor([1.0, 2.0])}})
    assert len(out) == 1 and out[0][0] == 0
    assert out[0][1]["loss"] == 1.0 and isinstance(out[0][1]["loss"], float)
    rest = d.drain()
    assert [s for s, _, _ in rest] == [1, 2] and rest[0][1]["loss"] == -1.0
    np.testing.assert_array_equal(rest[1][1]["telemetry"]["x"], [1.0, 2.0])
    # Each entry carries its step's end: in push order, not read order.
    ends = [out[0][2]] + [e for _, _, e in rest]
    assert ends == sorted(ends) and all(isinstance(e, float) for e in ends)
    assert len(d) == 0
    zero = telemetry.DeferredFetcher(window=0)
    (entry,) = zero.push(5, {"loss": torch.tensor(0.5)})
    assert entry[:2] == (5, {"loss": 0.5})


def test_logger_rates_come_from_step_ends():
    """Records that mature together (a drain) still get the steps' own
    rates: the window runs between the steps' ends, not the reads."""
    from tpu_trainer_torch.utils.logging import MetricLogger

    logger = MetricLogger(None, tokens_per_step=1000, stdout=False)
    t0 = logger._t0
    recs = [logger.log(i, {"loss": 1.0}, now=t0 + 0.5 * (i + 1))
            for i in range(3)]
    assert [r["tokens_per_sec"] for r in recs] == [2000.0] * 3
    assert [r["elapsed_s"] for r in recs] == [0.5, 1.0, 1.5]


def test_capture_stack_and_no_capture_no_stats():
    assert not telemetry.capturing()
    with telemetry.capture() as outer:
        assert telemetry.capturing() and not telemetry.capturing(deep=True)
        with telemetry.capture(deep=True):
            assert telemetry.capturing(deep=True)
        telemetry.record("x", 1)
        assert telemetry.pop("x") == 1 and telemetry.pop("x") is None
    assert outer.stats == {} and not telemetry.capturing()
    telemetry.record("y", 2)          # no active capture: a no-op
    assert telemetry.pop("y") is None
