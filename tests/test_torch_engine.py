"""Port parity: the serving engine against the JAX ``ServingEngine``.

The same seeded greedy trace runs through both engines in the
deterministic ``steps`` clock mode on the tiny f32 geometry, with the
JAX weights carried over through ``save_params_npz`` / ``load_params_npz``
/ ``from_jax_params``. ``initializer_range=0.5`` makes the greedy margins
dwarf cross-framework rounding, so the streams must be EQUAL, as must
every scheduler decision (kind, rids, prefill chunks, block tables,
cumulative preemptions — recorded by wrapping ``schedule()`` on each
instance) and the ``summary()`` counters. Modes: plain with a pool tight
enough to preempt, chunked prefill, and prefix caching.

Port-only sampling checks follow: sampled draws independent of batch
composition, identical sampled streams with and without preemption, and
``filter_logits`` equal to JAX's (identical ``-inf`` masks, values to
1e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.models.gpt import GPT as JGPT
from tpu_trainer.serving.engine import ServingEngine as JEngine
from tpu_trainer.serving.engine import poisson_trace as j_trace
from tpu_trainer.serving.remote import save_params_npz
from tpu_trainer.serving.sampling import filter_logits as j_filter
from tpu_trainer.serving.scheduler import Request as JRequest
from tpu_trainer.serving.scheduler import SamplingParams as JSampling
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import from_jax_params, load_params_npz
from tpu_trainer_torch.serving import sampling as tsampling
from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
from tpu_trainer_torch.serving.engine import poisson_trace as t_trace
from tpu_trainer_torch.serving.scheduler import Request as TRequest
from tpu_trainer_torch.serving.scheduler import SamplingParams as TSampling

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, attention_dropout=0.0,
           dtype="float32", param_dtype="float32", initializer_range=0.5)
TIMING_KEYS = {"wall_s", "tokens_per_s", "oldest_wait_s"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jcfg = JConfig(**CFG)
    params = JGPT(jcfg).init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    path = str(tmp_path_factory.mktemp("w") / "params.npz")
    save_params_npz(path, jax.tree.map(np.asarray, params))
    sd = from_jax_params(load_params_npz(path), TConfig(**CFG), device="cpu")
    return params, sd


def _prefix_trace(req_cls, samp_cls, n=8, seed=5):
    """Requests sharing one of two 16-token system prefixes."""
    rs = np.random.RandomState(seed)
    heads = [rs.randint(1, 128, 16).tolist() for _ in range(2)]
    out = []
    for i in range(n):
        tail = rs.randint(1, 128, int(rs.randint(3, 12))).tolist()
        out.append(req_cls(
            rid=i, prompt=heads[i % 2] + tail,
            max_new_tokens=int(rs.randint(4, 10)),
            sampling=samp_cls(temperature=0.0, seed=i),
            arrival_time=float(i // 2)))
    return out


MODES = {
    # name: (engine kwargs, trace kind)
    "plain_preempt": (dict(num_blocks=9), "poisson"),
    "chunked": (dict(prefill_chunk_tokens=8), "poisson"),
    "prefix": (dict(prefix_cache=True, num_blocks=20), "prefix"),
}


def _trace(kind, module):
    if kind == "prefix":
        if module == "jax":
            return _prefix_trace(JRequest, JSampling)
        return _prefix_trace(TRequest, TSampling)
    fn = j_trace if module == "jax" else t_trace
    return fn(8, vocab_size=128, rate=1.0, seed=3, prompt_len_range=(4, 24),
              max_new_range=(4, 12), temperature=0.0)


def _record(engine):
    log = []
    sched, cs = engine.scheduler, engine.cache_state
    orig = sched.schedule

    def schedule():
        kind, reqs = orig()
        log.append((kind, [r.rid for r in reqs],
                    [r.prefill_chunk for r in reqs] if kind == "prefill"
                    else [], cs.tables.tolist(), sched.n_preemptions))
        return kind, reqs

    sched.schedule = schedule
    return log


def _run(engine, reqs):
    log = _record(engine)
    done = engine.run(reqs, time_mode="steps")
    summary = {k: v for k, v in engine.summary().items()
               if k not in TIMING_KEYS}
    return {r.rid: list(r.generated) for r in done}, log, summary


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_jax(mode, weights):
    params, sd = weights
    kw, kind = MODES[mode]
    common = dict(max_batch=4, block_size=8, **kw)
    jreqs, treqs = _trace(kind, "jax"), _trace(kind, "torch")
    assert [r.prompt for r in jreqs] == [r.prompt for r in treqs]
    j_streams, j_log, j_sum = _run(JEngine(params, JConfig(**CFG), **common),
                                   jreqs)
    t_engine = TEngine(sd, TConfig(**CFG), device="cpu", **common)
    t_streams, t_log, t_sum = _run(t_engine, treqs)
    assert len(t_streams) == len(treqs)
    assert t_engine.tracer.conservation()["ok"]
    assert t_streams == j_streams
    assert t_log == j_log
    assert t_sum == j_sum
    if mode == "plain_preempt":
        assert t_sum["preemptions"] > 0
    if mode == "prefix":
        assert t_sum["prefix_hit_tokens"] > 0
    if mode == "chunked":
        assert t_sum["prefill_chunks"] > len(treqs)


def test_engine_requires_cuda_or_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, sd = weights
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(sd, TConfig(**CFG))


# --- sampling (port-only) --------------------------------------------------

def _logits(b, vocab=128, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, vocab)) * 3).astype(np.float32)


def test_sampled_draws_independent_of_batch():
    lg = torch.from_numpy(_logits(4))
    temps = np.array([0.8, 1.0, 0.0, 1.3], np.float32)
    topks = np.array([0, 5, 0, 20], np.int64)
    topps = np.array([1.0, 1.0, 1.0, 0.9], np.float32)
    keys = [tsampling.request_key(s) for s in (11, 12, 13, 14)]
    steps = [3, 0, 7, 2]
    full = tsampling.sample_tokens(lg, temps, topks, topps, keys, steps,
                                   k_cap=20)
    for r in range(4):
        one = tsampling.sample_tokens(
            lg[r:r + 1], temps[r:r + 1], topks[r:r + 1], topps[r:r + 1],
            keys[r:r + 1], steps[r:r + 1], k_cap=int(max(1, topks[r])))
        assert int(one[0]) == int(full[r])
    assert int(full[2]) == int(torch.argmax(lg[2]))   # greedy row
    # A different token index draws differently somewhere.
    other = [tsampling.sample_tokens(lg, temps, topks, topps, keys,
                                     [s + k for s in steps], k_cap=20)
             for k in range(1, 6)]
    assert any(not torch.equal(o, full) for o in other)


def test_sampled_streams_survive_preemption(weights):
    _, sd = weights
    streams = []
    for num_blocks in (None, 9):
        reqs = t_trace(8, vocab_size=128, rate=1.0, seed=4,
                       prompt_len_range=(4, 24), max_new_range=(4, 12),
                       temperature=1.0, top_k=8)
        eng = TEngine(sd, TConfig(**CFG), max_batch=4, block_size=8,
                      num_blocks=num_blocks, device="cpu")
        done = eng.run(reqs, time_mode="steps")
        streams.append({r.rid: r.generated for r in done})
        preempted = eng.summary()["preemptions"]
    assert preempted > 0
    assert streams[0] == streams[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_matches_jax(seed):
    b = 6
    lg = _logits(b, seed=seed)
    temps = np.array([0.0, 0.7, 1.0, 1.5, 1.0, 0.9], np.float32)
    topks = np.array([0, 3, 0, 10, 1, 40], np.int32)
    topps = np.array([1.0, 1.0, 0.8, 0.5, 1.0, 0.95], np.float32)
    want = np.asarray(j_filter(jnp.asarray(lg), jnp.asarray(temps),
                               jnp.asarray(topks), jnp.asarray(topps),
                               k_cap=40))
    got = tsampling.filter_logits(
        torch.from_numpy(lg), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(topps), k_cap=40).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=1e-6)


# --- CLI -------------------------------------------------------------------

CLI_TINY = ["--requests", "4", "--vocab", "64", "--hidden", "32",
            "--layers", "1", "--heads", "2", "--max-seq-len", "128",
            "--time-mode", "steps", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--kv-int8", "--prefill-chunk", "8",
                                        "--prefix-cache", "--top-k", "5"]])
def test_cli_serves_on_cpu(extra, capsys):
    from tpu_trainer_torch.serving.engine import _main

    assert _main(CLI_TINY + extra) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["finished"] == 4
    assert summary["device"] == "cpu"
    assert summary["generated_tokens"] > 0 and "ttft_p50" in summary


def test_cli_spec_not_ported(capsys):
    """``--spec`` was refused until speculative decoding was ported; now
    it serves, and an unknown proposer is an argparse error."""
    from tpu_trainer_torch.serving.engine import _main

    assert _main(CLI_TINY + ["--spec", "ngram"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["finished"] == 4 and summary["spec_steps"] > 0
    with pytest.raises(SystemExit):
        _main(CLI_TINY + ["--spec", "banana"])
