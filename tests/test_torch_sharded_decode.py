"""Port parity: the tensor-parallel (head-sharded) paged decode
(``tpu_trainer_torch/serving/sharding.py``, ``ops/flash.py::
paged_attention_sharded``, the engine's ``mesh_tensor`` / ``mesh_devices``)
against the JAX package's (``tests/test_sharded_decode.py``).

- ``paged_attention_sharded`` within 1e-5 of the JAX plain version and
  interpreted Pallas kernel, and of the JAX ``shard_map`` dispatch on the
  conftest's fake 8-device mesh, and bitwise the port's unsharded call, in
  both pool layouts: kv heads sharded (``kvh % tp == 0``) and replicated
  (``tp % kvh == 0``, each shard reading its one kv head in place,
  ``kv_head_base``).
- Engines at tp 2 and 4 give the JAX sharded engine's streams, scheduling
  log and summary on a run composing int8 pools, chunked prefill, the
  prefix cache and preemption, and equal the port at tp 1 bitwise in each
  case alone: plain, int8 + chunked + prefix, n-gram spec, preempt-resume,
  and GQA with replicated pools.
- ``pool_shard_stats`` and ``device_block_budget`` per shard, the mesh in
  the frozen config, ``KVB1`` frames of a sharded engine byte-equal to tp
  1's and a store shared by the two, in-process ``replica_device_sets``,
  one worker built from 2-way parameter shards with a device set, and
  the persistent bytes of each shard.

Tiny geometry of ``tests/test_sharded_decode.py`` (vocab 64, hidden 32, 2
layers, 4 heads, f32, block 8), with ``initializer_range=0.5`` for greedy
margins that both frameworks keep; the weights are one Flax-layout numpy
tree, which the JAX engine takes as it is and the port through
``from_jax_params``. Engines run on the CPU, where the mesh ids are
labels and every shard is a CPU tensor.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.ops import flash as jflash
from tpu_trainer.serving import sharding as jsharding
from tpu_trainer.serving.engine import ServingEngine as JEngine
from tpu_trainer.serving.engine import poisson_trace as j_trace
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import (from_jax_params, init_params,
                                              to_jax_params)
from tpu_trainer_torch.ops import flash as tflash
from tpu_trainer_torch.serving import kv_store as tstore
from tpu_trainer_torch.serving import remote as tremote
from tpu_trainer_torch.serving import sharding as tsharding
from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
from tpu_trainer_torch.serving.engine import poisson_trace as t_trace
from tpu_trainer_torch.serving.frontend import ServingFrontend
from tpu_trainer_torch.serving.scheduler import Request as TRequest
from tpu_trainer_torch.serving.scheduler import SamplingParams as TSampling

pytestmark = pytest.mark.skipif(
    jax.device_count() < 4, reason="needs >= 4 (fake) devices")

CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64, dropout=0.0, attention_dropout=0.0,
           dtype="float32", param_dtype="float32", initializer_range=0.5)
ENGINE_KW = dict(max_batch=4, block_size=8)
TIMING_KEYS = {"wall_s", "tokens_per_s", "oldest_wait_s"}


# --- the dispatch: shards against the JAX shard_map and one call ------------

def _pool_case(*, b=2, h=8, d=8, kvh=8, bsz=4, nblk=10, mb=4, seed=0):
    """``tests/test_sharded_decode.py::_pool_case``'s numbers."""
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, d).astype(np.float32),
            rs.randn(nblk, bsz, kvh, d).astype(np.float32),
            rs.randn(nblk, bsz, kvh, d).astype(np.float32),
            rs.randint(1, nblk, size=(b, mb)).astype(np.int32),
            rs.randint(1, mb * bsz + 1, size=(b,)).astype(np.int32))


def _shards(pool, tp, kvh):
    """Per-shard pools as the engine holds them: the kv-heads axis cut in
    shard order, or the whole pool on every shard."""
    t = torch.from_numpy(pool)
    if tsharding.kv_sharded(kvh, tp):
        return [c.contiguous() for c in t.chunk(tp, dim=2)]
    return [t.clone() for _ in range(tp)]


# The JAX shard_map dispatch compiles for seconds a case on the CPU: the
# port is held to it (the interpreted kernel) on the replicated layout,
# where each shard reads one kv head, and to the JAX unsharded plain
# version and kernel on every case (the JAX tests hold its dispatch to
# them).
JAX_SHARDED = {(4, 2): "kernel"}


@pytest.mark.parametrize("tp,kvh", [(2, 8), (4, 8), (2, 2), (4, 2), (4, 1)])
def test_sharded_dispatch_matches_jax(tp, kvh):
    q, pk, pv, tables, lengths = _pool_case(kvh=kvh)
    jargs = [jnp.asarray(a) for a in (q, pk, pv, tables, lengths)]
    wants = [jflash.paged_attention_reference(*jargs),
             jflash.flash_decode(*jargs, interpret=True)]
    if (tp, kvh) in JAX_SHARDED:
        wants.append(jflash.paged_attention_sharded(
            *jargs, mesh=jsharding.tp_mesh(tp, None),
            impl=JAX_SHARDED[tp, kvh], interpret=True))
    tq, ttab, tlen = (torch.from_numpy(a) for a in (q, tables, lengths))
    got = tflash.paged_attention_sharded(
        tq, _shards(pk, tp, kvh), _shards(pv, tp, kvh), ttab, tlen,
        kv_heads=kvh)
    for want in wants:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    one = tflash.flash_decode(tq, torch.from_numpy(pk), torch.from_numpy(pv),
                              ttab, tlen)
    assert torch.equal(got, one)


def test_kv_head_window_equals_a_copied_pool():
    """``kv_head_base`` / ``kv_heads`` read a window of a wider pool in
    place: the same result as the window copied out, int8 scales too."""
    from tpu_trainer_torch.utils.quant import quantize_kv_int8

    q, pk, pv, tables, lengths = _pool_case(h=4, kvh=4)
    tq, ttab, tlen = (torch.from_numpy(a) for a in (q, tables, lengths))
    k, sk = quantize_kv_int8(torch.from_numpy(pk))
    v, sv = quantize_kv_int8(torch.from_numpy(pv))
    for base, n in ((1, 1), (2, 2), (0, 4)):
        w = slice(base, base + n)
        got = tflash.flash_decode(tq, k, v, ttab, tlen, k_scale=sk,
                                  v_scale=sv, kv_head_base=base, kv_heads=n)
        want = tflash.paged_attention_reference(
            tq, k[:, :, w].contiguous(), v[:, :, w].contiguous(), ttab, tlen,
            k_scale=sk[:, :, w].contiguous(), v_scale=sv[:, :, w].contiguous())
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        tflash.flash_decode(tq, k, v, ttab, tlen, k_scale=sk, v_scale=sv,
                            kv_head_base=3, kv_heads=2)


def test_rejects_indivisible_heads():
    q, pk, pv, tables, lengths = _pool_case(h=6, kvh=6)
    with pytest.raises(ValueError, match="heads 6 % tp 4"):
        tflash.paged_attention_sharded(
            torch.from_numpy(q), _shards(pk, 4, 6), _shards(pv, 4, 6),
            torch.from_numpy(tables), torch.from_numpy(lengths), kv_heads=6)
    with pytest.raises(ValueError, match="does not divide num_heads"):
        TConfig(**{**CFG, "paged_tp": 3})
    with pytest.raises(ValueError, match="kv_heads=3"):
        TConfig(**{**CFG, "num_heads": 6, "hidden_size": 48,
                   "num_kv_heads": 3, "paged_tp": 2})


# --- engines: sharded port against the JAX sharded engine and tp 1 -----------

@pytest.fixture(scope="module")
def models():
    """``{kvh: (Flax-layout numpy tree, port state dict)}`` for MHA and
    GQA 2: drawn once as numpy (no JAX init to compile) and carried to
    the port by ``from_jax_params``."""
    out = {}
    for kvh in (None, 2):
        tcfg = TConfig(**{**CFG, "num_kv_heads": kvh})
        tree = to_jax_params(init_params(tcfg, seed=0, device="cpu"))
        out[kvh] = (tree, from_jax_params(tree, tcfg, device="cpu"))
    return out


def _trace(module):
    fn = j_trace if module == "jax" else t_trace
    return fn(6, vocab_size=64, rate=50.0, seed=1, temperature=0.0,
              prompt_len_range=(8, 24), max_new_range=(4, 8))


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


def _port(sd, kvh, tp, **kw):
    return TEngine(sd, TConfig(**{**CFG, "num_kv_heads": kvh}), device="cpu",
                   mesh_tensor=tp if tp > 1 else None, **ENGINE_KW, **kw)


# The JAX sharded engine compiles its steps for 6-17 s a config on the
# CPU, so it runs once (its streams equal its single-device engine's,
# tests/test_sharded_decode.py), composing the cases: int8 pools, chunked
# prefill, the prefix cache and a pool tight enough to preempt. Each case
# alone, n-gram spec and the replicated GQA pools are held to tp 1.
COMPOSED = dict(prefill_chunk_tokens=8, kv_int8=True, prefix_cache=True)
TP1_MODES = {
    # name: (kwargs, the tight pool: tp 1 blocks or None, kv heads)
    "plain": ({}, None, None),
    "int8_chunked_prefix": (COMPOSED, None, None),
    "spec_ngram": (dict(spec="ngram"), None, None),
    "preempt_resume": ({}, 12, None),
    "gqa_replicated": (dict(COMPOSED, spec="ngram"), 12, 2),
}


def _pool_kw(tp, blocks, kvh):
    """The same total pool at every tp: ``blocks`` at tp 1, a per-shard
    budget of ``blocks / shard_factor`` above it."""
    if blocks is None:
        return {}
    if tp == 1:
        return dict(num_blocks=blocks)
    return dict(device_block_budget=blocks // tsharding.shard_factor(
        4 if kvh is None else kvh, tp))


def _same_run(got, want, tp):
    """Streams, scheduling log and summary equal, but for the shard
    figures of ``pool_shard_stats``."""
    shard_keys = ("tp", "device_pool_blocks")
    assert got[0] == want[0], tp
    assert got[1] == want[1], tp
    assert ({k: v for k, v in got[2].items() if k not in shard_keys}
            == {k: v for k, v in want[2].items() if k not in shard_keys}), tp
    assert got[2]["tp"] == tp


def test_sharded_engine_matches_jax_and_tp1(models):
    tree, sd = models[None]
    want = _run(JEngine(tree, JConfig(**CFG), mesh_tensor=2, **ENGINE_KW,
                        **COMPOSED, **_pool_kw(2, 12, None)), _trace("jax"))
    base = _run(_port(sd, None, 1, **COMPOSED, **_pool_kw(1, 12, None)),
                _trace("torch"))
    _same_run(base, want, 1)
    for tp in (2, 4):
        got = _run(_port(sd, None, tp, **COMPOSED, **_pool_kw(tp, 12, None)),
                   _trace("torch"))
        _same_run(got, want, tp)
    assert base[2]["preemptions"] > 0 and base[2]["prefill_chunks"] > 6
    assert base[2]["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("mode", sorted(TP1_MODES))
def test_sharded_engine_equals_tp1(mode, models):
    kw, blocks, kvh = TP1_MODES[mode]
    sd = models[kvh][1]
    base = _run(_port(sd, kvh, 1, **kw, **_pool_kw(1, blocks, kvh)),
                _trace("torch"))
    for tp in (2, 4):
        got = _run(_port(sd, kvh, tp, **kw, **_pool_kw(tp, blocks, kvh)),
                   _trace("torch"))
        _same_run(got, base, tp)
    if blocks:
        assert base[2]["preemptions"] > 0
    if kw.get("spec"):
        assert base[2]["spec_drafted"] > 0


def test_device_block_budget_is_per_shard(models):
    params, sd = models[None]
    j = JEngine(params, JConfig(**CFG), mesh_tensor=2, device_block_budget=9,
                **ENGINE_KW)
    for tp, want in ((2, {"tp": 2, "total_pool_blocks": 18,
                          "device_pool_blocks": 9}),
                     (4, {"tp": 4, "total_pool_blocks": 36,
                          "device_pool_blocks": 9})):
        eng = _port(sd, None, tp, device_block_budget=9)
        assert eng.scheduler.pool_shard_stats() == want
        for sh in eng.device_cache["shards"]:
            assert tuple(sh["pool_k"].shape) == (2, want["total_pool_blocks"],
                                                 8, 4 // tp, 8)
    assert j.scheduler.pool_shard_stats() == _port(
        sd, None, 2, device_block_budget=9).scheduler.pool_shard_stats()
    # GQA-replicated pools gain nothing a shard.
    gqa = _port(models[2][1], 2, 4, device_block_budget=9)
    assert gqa.scheduler.pool_shard_stats() == {
        "tp": 4, "total_pool_blocks": 9, "device_pool_blocks": 9}


def test_mesh_identity_in_config(models):
    """Same arch on two device sets: the frozen configs differ (as the
    JAX jit memo key does), and a missing CUDA ordinal raises."""
    sd = models[None][1]
    kw = dict(device="cpu", **ENGINE_KW)
    e1 = TEngine(sd, TConfig(**CFG), mesh_devices=(0, 1), **kw)
    e2 = TEngine(sd, TConfig(**CFG), mesh_devices=(2, 3), **kw)
    e0 = TEngine(sd, TConfig(**CFG), **kw)
    assert e1.config.paged_tp == e2.config.paged_tp == 2
    assert e1.config != e2.config and e0.config.paged_tp == 1
    assert e0.config != e1.config
    assert e1.mesh.ids == (0, 1) and e2.mesh.ids == (2, 3)
    assert tsharding.tp_mesh(2, (0, 0), "cpu").shares_card
    assert tsharding.tp_mesh(4, None, "cpu").ids == (0, 1, 2, 3)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="not visible"):
            tsharding.resolve_devices(2, None, "cuda")
    assert tsharding.pick_shard_axis((257, 24), 4) == 1
    assert tsharding.pick_shard_axis((8, 96), 4) == 1
    assert tsharding.pick_shard_axis((8, 8), 4) == 0
    assert tsharding.pick_shard_axis((3, 2), 4) is None


def test_persistent_bytes_per_shard(models):
    """A shard holds P/tp parameter bytes (every leaf divides here) and
    1/tp of the pools, or the whole pools when they replicate; the
    gather is the state dict, bitwise."""
    for kvh, tp in ((None, 2), (None, 4), (2, 4)):
        sd = models[kvh][1]
        full = sum(t.numel() * t.element_size() for t in sd.values())
        one = _port(sd, kvh, 1)
        pools = sum(one.device_cache[k].numel()
                    * one.device_cache[k].element_size()
                    for k in ("pool_k", "pool_v"))
        eng = _port(sd, kvh, tp)
        assert eng.model.params.nbytes() == [full // tp] * tp
        gathered = tsharding.gather_params(eng.model.params)
        assert all(torch.equal(gathered[n], sd[n]) for n in sd)
        per = pools // tp if tsharding.kv_sharded(kvh or 4, tp) else pools
        for sh in eng.device_cache["shards"]:
            assert sum(t.numel() * t.element_size()
                       for t in sh.values()) == per


# --- block I/O: frames, a shared store ---------------------------------------

def _prefix_reqs(n, seed=0, max_new=6):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, 64, size=16).tolist()
    return [TRequest(rid=i, prompt=prefix + rs.randint(
                1, 64, size=4 + (i % 3) * 5).tolist(),
                max_new_tokens=max_new,
                sampling=TSampling(temperature=0.0, seed=100 + i))
            for i in range(n)]


def _streams(done):
    return {r.rid: list(r.generated) for r in done}


@pytest.mark.parametrize("kvh,tp,int8", [(None, 2, False), (None, 2, True),
                                         (2, 4, False)])
def test_kvb1_frames_equal_tp1_and_store_shared(models, kvh, tp, int8):
    """After one trace a tp engine's blocks encode to tp 1's ``KVB1``
    frames byte for byte; a cold tp engine fills from a tp-1 engine's
    store and a cold tp-1 engine from the tp engine's, each giving the
    undisturbed streams."""
    sd = models[kvh][1]
    kw = dict(kv_int8=int8, prefix_cache=True)
    stores = {n: tstore.KVBlockStore(host_bytes=32 << 20) for n in (1, tp)}
    warm = {n: _port(sd, kvh, n, kv_store=stores[n], **kw) for n in (1, tp)}
    want = _streams(warm[1].run(_prefix_reqs(6), time_mode="steps"))
    assert _streams(warm[tp].run(_prefix_reqs(6), time_mode="steps")) == want
    index = warm[1].cache_state._prefix
    assert index and index == warm[tp].cache_state._prefix
    for bid in sorted(set(index.values())) + [0]:
        a, b = warm[1].read_block(bid), warm[tp].read_block(bid)
        assert tremote.encode_kv_block(a) == tremote.encode_kv_block(b)
    for src, dst in ((1, tp), (tp, 1)):
        cold = _port(sd, kvh, dst, kv_store=stores[src], **kw)
        assert _streams(cold.run(_prefix_reqs(6), time_mode="steps")) == want
        assert cold.summary()["store_hit_tokens"] > 0


def test_write_block_refuses_other_layouts(models):
    sd = models[None][1]
    eng = _port(sd, None, 2)
    leaves = eng.read_block(1)
    assert eng.write_block(1, leaves)
    assert not eng.write_block(1, [x[:, :, :2] for x in leaves])
    assert not eng.write_block(1, leaves[:1])


# --- the fleet: in-process meshes and one worker -----------------------------

def test_replica_device_sets_in_process(models):
    sd = models[None][1]
    kw = dict(time_mode="steps", device="cpu", routing="least_loaded",
              **ENGINE_KW)
    want = ServingFrontend(sd, TConfig(**CFG), replicas=2, **kw).run(
        _trace("torch"))
    fe = ServingFrontend(sd, TConfig(**CFG), replicas=2,
                         replica_device_sets=[[0, 1], [2, 3, 4, 5]], **kw)
    got = fe.run(_trace("torch"))
    assert _streams(got) == _streams(want)
    engines = [h.engine.engine for h in fe._replicas]
    assert [e.config.paged_tp_devices for e in engines] == [
        (0, 1), (2, 3, 4, 5)]
    assert [e.mesh.tp for e in engines] == [2, 4]


def test_sharded_worker_from_param_shards(models, tmp_path):
    """One worker process (the supervisor's ``device_sets``) builds a tp-2
    engine from 2-way parameter shards and serves tp 1's streams."""
    sd = models[None][1]
    sup = tremote.WorkerSupervisor(
        sd, TConfig(**CFG), run_dir=str(tmp_path / "w"),
        engine_kwargs=dict(device="cpu", **ENGINE_KW),
        param_shard_world=2, device_sets=[[0, 1]],
        launch_prefix=["env", "OMP_NUM_THREADS=1"])
    try:
        with open(os.path.join(sup.run_dir, "spec.json")) as f:
            assert json.load(f)["device_sets"] == [[0, 1]]
        assert max(sup.param_shard_bytes) * 2 < 1.5 * sup.param_bytes_full
        fe = ServingFrontend(sd, TConfig(**CFG), replicas=1,
                             time_mode="steps", replica_factory=sup)
        got = fe.run(_trace("torch"))
        want = _run(_port(sd, None, 1), _trace("torch"))[0]
        assert _streams(got) == want
    finally:
        sup.close()
