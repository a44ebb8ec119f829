"""Port parity: speculative decoding (``tpu_trainer_torch/serving/spec.py``)
against the JAX package's ``serving/spec.py``.

Tiny geometry of ``tests/test_spec.py`` (vocab 128, hidden 32, 2 layers,
f32, ``attention="reference"``, CPU) with ``initializer_range=0.2``:
wide enough greedy margins that the two frameworks' streams agree, and a
model whose streams repeat often enough that drafts land and miss.
Weights cross over through ``from_jax_params``.

- Held exactly against the JAX functions: ``NGramProposer`` drafts,
  ``AdaptiveK``'s sequence of K, greedy ``accept_emit`` on the same
  seeded logits, ``draft_from_target``'s slices and validation.
- Greedy engine streams with n-gram spec (plain, chunked, prefix,
  chunked+prefix, int8) and draft spec equal the port's spec-off streams
  and the JAX engine's spec-off streams (one module-scoped JAX run per
  pool dtype), with drafts accepted.
- The port's own properties: a window of one is ``sample_tokens``; the
  sampled mixture keeps the target distribution (chi-square); sampled
  replays are deterministic; preemption mid-speculation, an always-wrong
  proposer and block accounting; the draft's rewind clamps.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.models.gpt import GPT as JGPT
from tpu_trainer.serving import spec as jspec
from tpu_trainer.serving.engine import ServingEngine as JEngine
from tpu_trainer.serving.sampling import request_key as j_request_key
from tpu_trainer.serving.scheduler import Request as JRequest
from tpu_trainer.serving.scheduler import SamplingParams as JSampling
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import from_jax_params
from tpu_trainer_torch.serving import spec as tspec
from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
from tpu_trainer_torch.serving.sampling import (filter_logits, request_key,
                                                sample_tokens)
from tpu_trainer_torch.serving.scheduler import Request as TRequest
from tpu_trainer_torch.serving.scheduler import SamplingParams as TSampling

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, attention_dropout=0.0,
           dtype="float32", param_dtype="float32", initializer_range=0.2)
TCFG = TConfig(**CFG)
PLENS = [5, 11, 16, 3]


@pytest.fixture(scope="module")
def weights():
    params = JGPT(JConfig(**CFG)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                         device="cpu")
    return params, sd


def _requests(req_cls, samp_cls, plens=PLENS, max_new=8, temperature=0.0,
              top_k=0):
    """``tests/test_spec.py``'s repetitive prompts: a 4-token motif."""
    rs = np.random.RandomState(1)
    out = []
    for i, p in enumerate(plens):
        motif = rs.randint(1, 128, size=4).tolist()
        out.append(req_cls(
            rid=i, prompt=(motif * p)[:p], max_new_tokens=max_new,
            sampling=samp_cls(temperature=temperature, top_k=top_k,
                              seed=100 + i)))
    return out


def _streams(sd, *, spec, plens=PLENS, max_new=8, temperature=0.0, top_k=0,
             **kw):
    eng = TEngine(sd, TCFG, max_batch=2, block_size=8,
                  attention="reference", spec=spec, spec_k=3, device="cpu",
                  **kw)
    fin = eng.run(_requests(TRequest, TSampling, plens, max_new,
                            temperature, top_k), time_mode="steps")
    if not kw.get("prefix_cache"):
        assert eng.cache_state.pool.occupancy == 0.0
    return [r.generated for r in fin], eng


@pytest.fixture(scope="module")
def jax_off(weights):
    """The JAX engine's spec-off greedy streams, f32 and int8 pools."""
    params, _ = weights
    out = {}
    for int8 in (False, True):
        eng = JEngine(params, JConfig(**CFG), max_batch=2, block_size=8,
                      attention="reference", kv_int8=int8)
        fin = eng.run(_requests(JRequest, JSampling), time_mode="steps")
        out[int8] = [list(r.generated) for r in fin]
    return out


@pytest.fixture(scope="module")
def port_off(weights):
    return _streams(weights[1], spec="off")[0]


# --- pure functions against JAX ---------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_ngram_drafts_equal_jax(seed):
    rs = np.random.RandomState(seed)
    motif = rs.randint(1, 9, size=int(rs.randint(2, 6))).tolist()
    ctx = (motif * 6)[:int(rs.randint(3, 24))] + rs.randint(
        1, 9, size=int(rs.randint(0, 4))).tolist()
    for max_ngram in (1, 2, 3):
        for k in (0, 1, 3, 5):
            want = jspec.NGramProposer(max_ngram).propose_one(ctx, k)
            got = tspec.NGramProposer(max_ngram).propose_one(ctx, k)
            assert got == want, (ctx, max_ngram, k)
    assert tspec.NGramProposer().propose_one([1, 2, 3, 9] * 3, 5) == \
        [1, 2, 3, 9, 1]
    with pytest.raises(ValueError):
        tspec.NGramProposer(max_ngram=2, min_ngram=3)


def test_adaptive_k_sequence_equals_jax():
    rs = np.random.RandomState(0)
    a, b = jspec.AdaptiveK(4), tspec.AdaptiveK(4)
    for _ in range(200):
        drafted = int(rs.randint(0, 5))
        accepted = int(rs.randint(0, drafted + 1))
        assert b.update(drafted, accepted) == a.update(drafted, accepted)
        assert b.ewma == a.ewma
    with pytest.raises(ValueError):
        tspec.AdaptiveK(0)


@pytest.mark.parametrize("seed", range(3))
def test_greedy_accept_emit_equals_jax(seed):
    """Logits whose argmax the drafts hit for a random number of leading
    positions: ``emitted`` and ``n_acc`` bitwise JAX's, every row."""
    b, w, vocab = 6, 5, 32
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((b, w, vocab)).astype(np.float32)
    tgt = logits.argmax(-1)
    ids = rs.randint(0, vocab, size=(b, w)).astype(np.int32)
    for r in range(b):
        hit = int(rs.randint(0, w))
        ids[r, 1:1 + hit] = tgt[r, :hit]
    dlens = rs.randint(0, w, size=b).astype(np.int32)
    zeros_f = np.zeros((b,), np.float32)
    zeros_i = np.zeros((b,), np.int32)
    ones_f = np.ones((b,), np.float32)
    j_em, j_acc = jspec.accept_emit(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(dlens),
        jnp.asarray(zeros_f), jnp.asarray(zeros_i), jnp.asarray(ones_f),
        jnp.stack([j_request_key(i) for i in range(b)]),
        jnp.asarray(zeros_i), k_cap=1)
    t_em, t_acc = tspec.accept_emit(
        torch.from_numpy(logits), torch.from_numpy(ids).long(), dlens,
        zeros_f, zeros_i, ones_f, [request_key(i) for i in range(b)],
        zeros_i, k_cap=1)
    assert t_acc.tolist() == np.asarray(j_acc).tolist()
    assert t_em.tolist() == np.asarray(j_em).tolist()


def test_draft_from_target_equals_jax(weights):
    params, sd = weights
    j_draft, j_cfg = jspec.draft_from_target(params, JConfig(**CFG), 1)
    t_draft, t_cfg = tspec.draft_from_target(sd, TCFG, 1)
    assert t_cfg.num_layers == j_cfg.num_layers == 1
    want = from_jax_params(jax.tree.map(np.asarray, j_draft), t_cfg,
                           device="cpu")
    assert sorted(want) == sorted(t_draft)
    for name in want:
        assert torch.equal(t_draft[name], want[name]), name
    for bad in (0, TCFG.num_layers):
        with pytest.raises(ValueError):
            tspec.draft_from_target(sd, TCFG, bad)
        with pytest.raises(ValueError):
            jspec.draft_from_target(params, JConfig(**CFG), bad)


# --- engine streams ----------------------------------------------------------


@pytest.mark.parametrize("engine_kw", [
    {}, {"prefill_chunk_tokens": 4}, {"prefix_cache": True},
    {"prefill_chunk_tokens": 4, "prefix_cache": True},
], ids=["plain", "chunked", "prefix", "chunked+prefix"])
def test_greedy_ngram_equals_spec_off_and_jax(weights, port_off, jax_off,
                                              engine_kw):
    on, eng = _streams(weights[1], spec="ngram", **engine_kw)
    assert port_off == jax_off[False]
    assert on == port_off
    assert eng.stats["spec_accepted"] > 0
    assert eng.stats["spec_accepted"] < eng.stats["spec_drafted"]


def test_greedy_ngram_int8_equals_spec_off_and_jax(weights, jax_off):
    off, _ = _streams(weights[1], spec="off", kv_int8=True)
    on, eng = _streams(weights[1], spec="ngram", kv_int8=True)
    assert off == jax_off[True]
    assert on == off
    assert eng.stats["spec_accepted"] > 0


def test_greedy_draft_model_equals_spec_off_and_jax(weights, port_off,
                                                    jax_off):
    """Four requests through two slots also reuse draft slots: the
    second wave must not read the first wave's draft K/V."""
    dp, dc = tspec.draft_from_target(weights[1], TCFG, 1)
    on, eng = _streams(weights[1], spec="draft", draft_params=dp,
                       draft_config=dc)
    assert on == port_off == jax_off[False]
    assert eng.stats["spec_accepted"] > 0
    prop = eng.spec_decoder.proposer
    assert prop.decode_dispatches > 0
    s = eng.summary()
    assert s["spec_accept_hist"] and sum(s["spec_accept_hist"]) == \
        s["spec_steps"]


def test_engine_rejects_unknown_spec_and_bad_draft(weights):
    with pytest.raises(ValueError, match="spec"):
        TEngine(weights[1], TCFG, spec="banana", device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        TEngine(weights[1], TCFG, spec="draft", device="cpu")


# --- sampling ----------------------------------------------------------------


def test_window_of_one_is_sample_tokens():
    b, vocab = 32, 16
    rs = np.random.RandomState(3)
    logits = torch.from_numpy(rs.standard_normal((b, vocab))
                              .astype(np.float32))
    temps = np.full((b,), 0.8, np.float32)
    topks = np.full((b,), 5, np.int64)
    topps = np.full((b,), 0.9, np.float32)
    keys = [request_key(i) for i in range(b)]
    steps = list(range(b))
    want = sample_tokens(logits, temps, topks, topps, keys, steps, k_cap=8)
    emitted, n_acc = tspec.accept_emit(
        logits[:, None, :], torch.zeros((b, 1), dtype=torch.long),
        np.zeros((b,), np.int64), temps, topks, topps, keys, steps,
        k_cap=8)
    assert torch.equal(emitted[:, 0], want)
    assert int(n_acc.sum()) == 0


def test_sampled_mixture_keeps_target_distribution():
    """Over 4096 independent streams the first emitted token (draft
    accepted w.p. p(d), else the residual draw) is distributed as p:
    Pearson's chi-square over the 8 tokens below 24.32, the 0.001
    quantile of chi-square with 7 degrees of freedom."""
    n, vocab, w = 4096, 8, 3
    rs = np.random.RandomState(0)
    row = rs.standard_normal(vocab).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.broadcast_to(row, (n, w, vocab)).copy())
    draft = int(np.argmax(row))
    ids = torch.zeros((n, w), dtype=torch.long)
    ids[:, 1] = draft
    ones = np.ones((n,), np.float32)
    emitted, _ = tspec.accept_emit(
        logits, ids, np.full((n,), 2, np.int64), ones,
        np.zeros((n,), np.int64), ones,
        [request_key(i) for i in range(n)], np.zeros((n,), np.int64),
        k_cap=1)
    first = emitted[:, 0].numpy()
    p = torch.softmax(torch.from_numpy(row), -1).numpy().astype(np.float64)
    counts = np.bincount(first, minlength=vocab)
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts, n * p)
    assert (first == draft).mean() > p[draft] * 0.9


def test_sampled_filter_matches_sample_tokens_rows():
    """The verify step filters each window position as the plain sampler
    filters its row (same temperature, top-k, top-p)."""
    rs = np.random.RandomState(5)
    logits = torch.from_numpy(rs.standard_normal((4, 3, 16))
                              .astype(np.float32))
    temps = np.array([0.5, 0.9, 1.0, 1.3], np.float32)
    topks = np.array([0, 3, 5, 16], np.int64)
    topps = np.array([1.0, 0.8, 0.9, 0.5], np.float32)
    flat = filter_logits(
        logits.reshape(12, 16), torch.from_numpy(np.repeat(temps, 3)),
        torch.from_numpy(np.repeat(topks, 3)),
        torch.from_numpy(np.repeat(topps, 3)), k_cap=16)
    for i in range(3):
        row = filter_logits(logits[:, i], torch.from_numpy(temps),
                            torch.from_numpy(topks),
                            torch.from_numpy(topps), k_cap=16)
        assert torch.equal(flat.reshape(4, 3, 16)[:, i], row)


def test_sampled_streams_replay_identically(weights):
    kw = dict(spec="ngram", plens=[5, 11, 3], max_new=6, temperature=0.9,
              top_k=20)
    on1, _ = _streams(weights[1], **kw)
    on2, _ = _streams(weights[1], **kw)
    assert on1 == on2
    for s in on1:
        assert len(s) == 6 and all(0 <= t < 128 for t in s)


# --- scheduling ----------------------------------------------------------------


def test_preempt_mid_speculation_resumes_identically(weights, port_off):
    tight, eng = _streams(weights[1], spec="ngram", num_blocks=5)
    assert eng.scheduler.n_preemptions > 0
    assert tight == port_off


class _AlwaysWrongProposer:
    """Drafts the greedy argmax can never equal: every verify step is a
    full rejection."""

    name = "wrong"

    def propose(self, reqs, k_of):
        return {r.rid: [((r.prompt + r.generated)[-1] + 1 + i) % 128
                        for i in range(k_of[r.rid])] for r in reqs}

    def rewind(self, req, accepted):
        pass


def test_always_wrong_proposer_is_harmless(weights, port_off):
    eng = TEngine(weights[1], TCFG, max_batch=2, block_size=8,
                  attention="reference", spec="ngram", spec_k=3,
                  spec_proposer=_AlwaysWrongProposer(), device="cpu")
    for r in _requests(TRequest, TSampling):
        eng.scheduler.add(r)
    fin = {}
    for _ in range(500):
        if not eng.scheduler.has_work():
            break
        for r in eng.step():
            fin[r.rid] = r.generated
        for r in eng.scheduler.running:
            nb = len(eng.cache_state.slot_blocks(r.slot))
            assert r.cached_tokens() <= nb * 8 < r.cached_tokens() + 16
    assert not eng.scheduler.has_work()
    assert [fin[i] for i in sorted(fin)] == port_off
    assert eng.stats["spec_accepted"] == 0 < eng.stats["spec_drafted"]
    assert eng.cache_state.pool.occupancy == 0.0


def test_block_accounting_holds_under_spec(weights):
    eng = TEngine(weights[1], TCFG, max_batch=4, block_size=8, num_blocks=6,
                  attention="reference", spec="ngram", spec_k=3,
                  device="cpu")
    for r in _requests(TRequest, TSampling, [5, 8, 14, 20, 6, 11],
                       max_new=6):
        eng.scheduler.add(r)
    pool = eng.cache_state.pool
    for _ in range(500):
        if not eng.scheduler.has_work():
            break
        eng.step()
        assert 0 <= pool.free_blocks <= pool.num_blocks - 1
        for r in eng.scheduler.running:
            nb = len(eng.cache_state.slot_blocks(r.slot))
            assert r.cached_tokens() <= nb * 8
            assert nb <= eng.cache_state.max_blocks
    assert not eng.scheduler.has_work()
    assert pool.occupancy == 0.0
    assert eng.tracer.conservation()["ok"]


def test_draft_rewind_clamps_to_fed(weights):
    dp, dc = tspec.draft_from_target(weights[1], TCFG, 1)
    prop = tspec.DraftModelProposer(dp, dc, slots=1, block_size=8,
                                    attention="reference", device="cpu")
    [req] = _requests(TRequest, TSampling, [5])
    req.slot = 0
    out = prop.propose([req], {req.rid: 3})
    assert len(out[req.rid]) == 3
    assert prop.decode_dispatches == 2
    prop.rewind(req, 99)                    # over-accept is clamped
    assert prop.good[0] == prop.fed[0]
    prop.rewind(req, 0)
    assert prop.good[0] == prop.base[0]


# --- the command lines -------------------------------------------------------


def test_engine_cli_runs_draft_spec(capsys):
    """``--spec draft`` slices ``--spec-draft-layers`` of the synthetic
    model (``--spec ngram``: ``test_torch_engine.py``)."""
    from tpu_trainer_torch.serving.engine import _main

    assert _main(["--requests", "4", "--vocab", "128", "--hidden", "32",
                  "--layers", "2", "--heads", "2", "--max-seq-len", "128",
                  "--temperature", "0", "--time-mode", "steps",
                  "--device", "cpu", "--spec", "draft",
                  "--spec-draft-layers", "1"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["finished"] == 4
    assert summary["spec_steps"] > 0 and "spec_accept_hist" in summary
