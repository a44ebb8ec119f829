"""Port parity: the KV block store, the ``KVB1`` codec and engine-to-engine
migration (``tpu_trainer_torch/serving/{kv_store,remote,engine}.py``)
against the JAX package.

- ``KVB1`` frames of f32, int8 (with scales) and bf16 (``<V2``) leaves
  are byte-equal to the JAX ``encode_kv_block``'s, and each side decodes
  the other's; torn, oversized and malformed frames raise ``FrameError``.
- ``KVBlockStore`` makes the JAX store's LRU, spill and promote decisions
  over one seeded sequence of puts and gets, with and without a disk
  tier, and ends with its counters; ``MigrationPricer`` answers as JAX's.
- ``read_block`` after the same requests gives the JAX engine's leaves,
  in its order and shapes: f32 values within 1e-5, int8 codes bitwise,
  int8 scales within rtol 2e-6 (the K/V they scale come from matmuls
  that round differently in the two frameworks: up to 6.2e-7 seen).
- A cold engine sharing only the store fills from it, bitwise the store's
  entries, and its greedy streams equal the undisturbed engine's and
  JAX's (f32 and int8); store fills count into prefix hits.
- Prefill-role to decode-role migration reproduces one engine's streams,
  greedy and sampled, composed with chunked prefill and n-gram spec.

Tiny geometry of ``tests/test_kv_store.py`` (vocab 128, hidden 32, 2
layers, f32, ``attention="reference"``, block 8, CPU), with
``initializer_range=0.2`` for greedy margins that both frameworks keep.
"""

import socket
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.models.gpt import GPT as JGPT
from tpu_trainer.serving import kv_store as jstore
from tpu_trainer.serving import remote as jremote
from tpu_trainer.serving.engine import ServingEngine as JEngine
from tpu_trainer.serving.scheduler import Request as JRequest
from tpu_trainer.serving.scheduler import SamplingParams as JSampling
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.weights import from_jax_params
from tpu_trainer_torch.serving import kv_store as tstore
from tpu_trainer_torch.serving import remote as tremote
from tpu_trainer_torch.serving.engine import ServingEngine as TEngine
from tpu_trainer_torch.serving.scheduler import Request as TRequest
from tpu_trainer_torch.serving.scheduler import SamplingParams as TSampling

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0, attention_dropout=0.0,
           dtype="float32", param_dtype="float32", initializer_range=0.2)
TCFG = TConfig(**CFG)
BLOCK = 8
ENGINE_KW = dict(block_size=BLOCK, attention="reference", prefix_cache=True,
                 max_batch=4)


@pytest.fixture(scope="module")
def weights():
    params = JGPT(JConfig(**CFG)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = from_jax_params(jax.tree.map(np.asarray, params), TCFG,
                         device="cpu")
    return params, sd


def _prefix_requests(req_cls, samp_cls, n, prefix_len=2 * BLOCK, max_new=6,
                     seed=0, mixed=False):
    """``tests/test_kv_store.py``'s shared-prefix trace: a 2-block prefix
    and varied tails; odd rids sampled when ``mixed``."""
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, 128, size=prefix_len).tolist()
    reqs = []
    for i in range(n):
        tail = rs.randint(1, 128, size=4 + (i % 3) * 5).tolist()
        temp = 0.8 if (mixed and i % 2) else 0.0
        reqs.append(req_cls(
            rid=i, prompt=prefix + tail, max_new_tokens=max_new,
            sampling=samp_cls(temperature=temp, top_p=0.9, seed=100 + i)))
    return reqs


def _treqs(n, **kw):
    return _prefix_requests(TRequest, TSampling, n, **kw)


def _engine(sd, **kw):
    return TEngine(sd, TCFG, device="cpu", **{**ENGINE_KW, **kw})


def _streams(done):
    return {r.rid: list(r.generated) for r in done}


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX engine after the 6-request trace, f32 and int8 pools:
    its streams and every indexed block's ``read_block``."""
    params, _ = weights
    out = {}
    for int8 in (False, True):
        eng = JEngine(params, JConfig(**CFG), kv_int8=int8, **ENGINE_KW)
        done = eng.run(_prefix_requests(JRequest, JSampling, 6),
                       time_mode="steps")
        blocks = {dig: eng.read_block(bid)
                  for dig, bid in eng.cache_state._prefix.items()}
        out[int8] = (_streams(done), blocks)
    return out


# --- the KVB1 codec and frames ---------------------------------------------


def _leaves(kind, seed=0):
    """One block entry of each kind as (JAX-side leaves, port-side
    leaves): the same bits, a bf16 leaf as ``ml_dtypes.bfloat16`` for JAX
    and as its raw words (void ``V2``) for the port."""
    rs = np.random.RandomState(seed)
    shape = (2, BLOCK, 2, 16)
    if kind == "int8":
        out = [rs.randint(-128, 128, size=shape).astype(np.int8),
               rs.randint(-128, 128, size=shape).astype(np.int8),
               rs.standard_normal(shape[:-1] + (1,)).astype(np.float32),
               rs.standard_normal(shape[:-1] + (1,)).astype(np.float32)]
        return out, out
    f32 = [rs.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kind == "f32":
        return f32, f32
    bf = [a.astype(ml_dtypes.bfloat16) for a in f32]
    return bf, [a.view(np.uint16).view(np.dtype("V2")) for a in bf]


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_kvb1_frames_byte_equal_jax(kind):
    j_leaves, t_leaves = _leaves(kind)
    frame = tremote.encode_kv_block(t_leaves)
    assert frame == jremote.encode_kv_block(j_leaves)
    if kind == "bf16":
        assert b"<V2" in frame
    for a, b in zip(t_leaves, jremote.decode_kv_block(frame)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    back = tremote.decode_kv_block(jremote.encode_kv_block(j_leaves))
    for a, b in zip(t_leaves, back):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_binary_frame_round_trip_and_json_where_binary_promised():
    a, b = socket.socketpair()
    try:
        payload = tremote.encode_kv_block(_leaves("int8")[1])
        tremote.send_binary_frame(a, payload)
        assert tremote.recv_binary_frame(b) == payload
        tremote.send_frame(a, {"id": 1, "method": "kv_get"})
        assert tremote.recv_frame(b) == {"id": 1, "method": "kv_get"}
        tremote.send_frame(a, {"id": 2})
        with pytest.raises(tremote.FrameError, match="expected a binary"):
            tremote.recv_binary_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("poison", [
    struct.pack(">I", 0x8000_0000),                               # zero
    struct.pack(">I", (tremote.MAX_FRAME_BYTES + 1) | 0x8000_0000),  # big
    struct.pack(">I", 100 | 0x8000_0000) + b"short",              # torn
], ids=["zero", "oversized", "torn"])
def test_torn_binary_frame_raises_frame_error(poison):
    a, b = socket.socketpair()
    try:
        a.sendall(poison)
        a.close()
        with pytest.raises(tremote.FrameError):
            tremote.recv_binary_frame(b)
    finally:
        b.close()


def test_torn_json_frame_raises_and_clean_eof_is_none():
    for poison in (struct.pack(">I", 0), struct.pack(">I", 5) + b"{",
                   struct.pack(">I", 3) + b"\xff\xfe\x00"):
        a, b = socket.socketpair()
        try:
            a.sendall(poison)
            a.close()
            with pytest.raises(tremote.FrameError):
                tremote.recv_frame(b)
        finally:
            b.close()
    a, b = socket.socketpair()
    a.close()
    assert tremote.recv_frame(b) is None
    b.close()


def test_malformed_block_payload_raises_frame_error():
    good = tremote.encode_kv_block(_leaves("f32")[1])
    torn = bytearray(good)
    torn[6] ^= 0xFF              # the first leaf's dtype length byte
    for bad in (b"XXXX" + good[4:], good[:-5], good + b"\x00\x00",
                bytes(torn)):
        with pytest.raises(tremote.FrameError):
            tremote.decode_kv_block(bad)
        with pytest.raises(jremote.FrameError):
            jremote.decode_kv_block(bad)
    with pytest.raises(tremote.FrameError, match="exceeds max frame"):
        tremote.encode_kv_block(
            [np.zeros(tremote.MAX_FRAME_BYTES + 8, np.uint8)])


# --- the store ----------------------------------------------------------------


def _store_ops(store, seed):
    """One seeded sequence of puts, gets and probes; every answer."""
    rs = np.random.RandomState(seed)
    digests = [bytes([i]) * 16 for i in range(12)]
    answers = []
    for step in range(300):
        dig = digests[int(rs.randint(0, 12))]
        op = int(rs.randint(0, 4))
        if op == 0:
            n = int(rs.randint(16, 160))
            leaves = [np.full((n,), step, np.float32)]
            answers.append(("put", store.put(dig, leaves,
                                             announce=bool(step % 3))))
        elif op == 1:
            got = store.get(dig)
            answers.append(("get", None if got is None else
                            (got[0], [a.tobytes() for a in got[1]])))
        elif op == 2:
            answers.append(("nbytes", store.entry_nbytes(dig)))
        else:
            answers.append(("has", store.has(dig)))
    answers.append(("new", store.drain_new_digests()))
    answers.append(("stats", store.stats()))
    answers.append(("host", list(store._host)))
    answers.append(("disk", list(store._disk)))
    return answers


@pytest.mark.parametrize("disk", [False, True], ids=["host", "host+disk"])
def test_store_decisions_equal_jax(tmp_path, disk):
    """Same LRU, spill and promote decisions and counters as the JAX
    store (1 KiB host tier, 2 KiB disk tier)."""
    kw = dict(host_bytes=1024, disk_bytes=2048)
    j = jstore.KVBlockStore(
        disk_dir=str(tmp_path / "j") if disk else None, **kw)
    t = tstore.KVBlockStore(
        disk_dir=str(tmp_path / "t") if disk else None, **kw)
    want = _store_ops(j, 0)
    assert _store_ops(t, 0) == want
    stats = want[-3][1]
    assert stats["evictions_host"] > 0 and stats["hits_host"] > 0
    if disk:
        assert stats["spills_to_disk"] > 0 and stats["hits_disk"] > 0


def test_disk_tier_keeps_bf16_leaves(tmp_path):
    store = tstore.KVBlockStore(host_bytes=1024, disk_dir=str(tmp_path))
    bf = np.arange(64, dtype=np.uint16).view(np.dtype("V2"))
    store.put(b"b" * 16, [bf, np.ones(32, np.float32)])       # 256 B
    for i in range(4):                    # evicts the bf16 entry to disk
        store.put(bytes([i]) * 16, [np.zeros(64, np.float32)])
    tier, leaves = store.get(b"b" * 16)
    assert tier == "disk"
    assert leaves[0].dtype == np.dtype("V2")
    assert leaves[0].tobytes() == bf.tobytes()


def test_pricer_equals_jax():
    for flops in (1e3, 1e9):
        for link in (1e9, 1e10):
            j = jstore.MigrationPricer(flops, 1e12, link)
            t = tstore.MigrationPricer(flops, 1e12, link)
            for tokens in (8, 64, 1024):
                for nbytes in (100_000, 1 << 20, 1 << 30):
                    assert t.recompute_s(tokens) == j.recompute_s(tokens)
                    assert t.transfer_s(nbytes) == j.transfer_s(nbytes)
                    assert (t.prefers_transfer(tokens, nbytes)
                            == j.prefers_transfer(tokens, nbytes))
    leaves = _leaves("int8")[1]
    assert tstore.leaves_nbytes(leaves) == jstore.leaves_nbytes(leaves)


# --- engine block I/O ----------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_read_block_equals_jax(weights, jax_runs, int8):
    eng = _engine(weights[1], kv_int8=int8)
    done = eng.run(_treqs(6), time_mode="steps")
    j_streams, j_blocks = jax_runs[int8]
    assert _streams(done) == j_streams
    index = eng.cache_state._prefix
    assert list(index) == list(j_blocks)       # same digests, same order
    for dig, bid in index.items():
        got, want = eng.read_block(bid), j_blocks[dig]
        assert [(a.shape, a.dtype) for a in got] == \
            [(a.shape, a.dtype) for a in want]
        if int8:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[2], want[2], rtol=2e-6)
            np.testing.assert_allclose(got[3], want[3], rtol=2e-6)
        else:
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_write_block_refuses_layout_mismatch(weights):
    eng = _engine(weights[1])
    leaves = eng.read_block(1)
    before = [t.clone() for t in eng._pool_leaves()]
    assert not eng.write_block(1, leaves[:1])
    assert not eng.write_block(1, [leaves[0][:, :4], leaves[1]])
    assert not eng.write_block(1, [leaves[0].astype(np.float64), leaves[1]])
    for a, b in zip(before, eng._pool_leaves()):
        assert torch.equal(a, b)
    new = [np.full_like(a, 0.5) for a in leaves]
    assert eng.write_block(1, new)
    assert all(np.array_equal(a, b) for a, b in zip(eng.read_block(1), new))


def test_bf16_block_round_trips_through_the_frame(weights):
    cfg = TConfig(**dict(CFG, dtype="bfloat16"))
    a = TEngine(weights[1], cfg, device="cpu", **ENGINE_KW)
    a.run(_treqs(2), time_mode="steps")
    bid = next(iter(a.cache_state._prefix.values()))
    leaves = a.read_block(bid)
    assert [x.dtype for x in leaves] == [np.dtype("V2")] * 2
    back = tremote.decode_kv_block(tremote.encode_kv_block(leaves))
    b = TEngine(weights[1], cfg, device="cpu", **ENGINE_KW)
    assert b.write_block(3, back)
    assert torch.equal(b.device_cache["pool_k"][:, 3],
                       a.device_cache["pool_k"][:, bid])
    assert torch.equal(b.device_cache["pool_v"][:, 3],
                       a.device_cache["pool_v"][:, bid])


# --- store-backed engines ------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_cold_engine_fills_from_store(weights, jax_runs, int8):
    want = _streams(_engine(weights[1], kv_int8=int8).run(
        _treqs(6), time_mode="steps"))
    assert want == jax_runs[int8][0]
    store = tstore.KVBlockStore(host_bytes=32 << 20)
    warm = _engine(weights[1], kv_int8=int8, kv_store=store)
    warm.run(_treqs(6), time_mode="steps")
    assert store.counters["puts"] > 0
    cold = _engine(weights[1], kv_int8=int8, kv_store=store)
    fin = cold.run(_treqs(6), time_mode="steps")
    assert _streams(fin) == want
    s = cold.summary()
    assert s["store_hit_tokens"] > 0 and store.counters["hits_host"] > 0
    # Every block the cold engine filled holds the store entry's bytes.
    filled = 0
    for dig, bid in cold.cache_state._prefix.items():
        got = store.get(dig)
        if got is not None:
            filled += 1
            for a, b in zip(cold.read_block(bid), got[1]):
                assert a.tobytes() == b.tobytes()
    assert filled * BLOCK >= s["store_hit_tokens"] > 0


def test_store_fill_counts_into_prefix_hit_tokens(weights):
    store = tstore.KVBlockStore(host_bytes=32 << 20)
    _engine(weights[1], kv_store=store).run(_treqs(4), time_mode="steps")
    cold = _engine(weights[1], kv_store=store)
    fin = cold.run(_treqs(4), time_mode="steps")
    assert max(r.prefix_hit_tokens for r in fin) >= 2 * BLOCK


def test_eviction_spills_into_the_store(weights):
    """A pool too small to keep the index evicts prefix blocks; one the
    store no longer holds (its host tier holds two entries) is spilled
    into it instead of forgotten, and the streams do not move."""
    want = _streams(_engine(weights[1]).run(_treqs(6, seed=3),
                                            time_mode="steps"))
    store = tstore.KVBlockStore(host_bytes=2 * 2 * 2 * BLOCK * 2 * 16 * 4)
    eng = _engine(weights[1], kv_store=store, num_blocks=9, max_batch=2)
    assert _streams(eng.run(_treqs(6, seed=3), time_mode="steps")) == want
    s = eng.summary()
    assert eng.cache_state.n_prefix_evictions > 0
    assert s["store_spills"] > 0 and s["kv_store_evictions_host"] > 0


# --- migration ----------------------------------------------------------------


def _migrated(sd, reqs, **kw):
    """A prefill-role engine hands each request, after its first token,
    to a decode-role engine sharing the store (full prompt blocks by
    digest, the tail raw): the front end's orchestration, in a loop."""
    store = tstore.KVBlockStore(host_bytes=32 << 20)
    pre = _engine(sd, kv_store=store, role="prefill", **kw)
    dec = _engine(sd, kv_store=store, role="decode", **kw)
    for r in reqs:
        pre.scheduler.add(r)
    done, moved, nbytes = {}, 0, 0
    for _ in range(1000):
        if not (pre.scheduler.has_work() or dec.scheduler.has_work()):
            break
        assert pre.step() == []               # a prefill engine finishes none
        for rid in pre.migratable_rids():
            req, payload = pre.extract_request(rid)
            if payload["leaves"] is not None:
                nbytes += tstore.leaves_nbytes(payload["leaves"])
            req._kv_migration = payload
            dec.scheduler.add(req)
            moved += 1
        for r in dec.step():
            done[r.rid] = r
    assert pre.tracer.conservation()["ok"]
    return done, moved, nbytes, pre, dec


@pytest.mark.parametrize("mixed", [False, True], ids=["greedy", "sampled"])
def test_migration_equals_one_engine_composed(weights, mixed):
    """Chunked prefill + n-gram spec, through prefill -> decode
    migration: the decode engine's streams are one engine's."""
    extra = dict(prefill_chunk_tokens=4, spec="ngram", spec_k=2)
    want = _streams(_engine(weights[1], **extra).run(
        _treqs(6, mixed=mixed), time_mode="steps"))
    done, moved, nbytes, pre, dec = _migrated(
        weights[1], _treqs(6, mixed=mixed), **extra)
    assert {rid: list(r.generated) for rid, r in done.items()} == want
    assert moved == 6 and nbytes > 0
    assert dec.summary()["migrated_tail_fills"] == 6
    assert all(r.prefix_hit_tokens == len(r.prompt) for r in done.values())
    assert pre.summary()["finished"] == 0
    assert dec.summary()["finished"] == 6


def test_roles_validated(weights):
    with pytest.raises(ValueError, match="prefill | decode"):
        _engine(weights[1], role="prefil")
    eng = _engine(weights[1])
    with pytest.raises(ValueError, match="prefill | decode"):
        eng.set_role("banana")
    eng.set_role("prefill")
    assert not eng.scheduler.decode_enabled
    eng.set_role(None)
    assert eng.scheduler.decode_enabled
    assert eng.extract_request(0) is None
