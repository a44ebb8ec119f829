"""Port parity: the text data path (tokenizer, native byte tokenizer, text
loaders and their cursors, host and device prefetch).

The same temporary corpus (lines made with numpy from a fixed seed) and
the same seed go through the JAX package's loaders and the port's; the
batches, segment channels and cursors must be bitwise equal.
"""

import gzip
import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch import native
from tpu_trainer_torch.data import text as ttext
from tpu_trainer_torch.data.device_prefetch import DevicePrefetcher
from tpu_trainer_torch.data.packing import PackedDataLoader
from tpu_trainer_torch.data.prefetch import Prefetcher
from tpu_trainer_torch.data.openwebtext import create_openwebtext_dataloader
from tpu_trainer_torch.data.tinystories import create_tinystories_dataloader
from tpu_trainer_torch.utils.tokenizer import ByteTokenizer, get_tokenizer

SEQ = 32


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    from tpu_trainer import native as jnative
    from tpu_trainer.data import text as jtext
    from tpu_trainer.data.openwebtext import (
        create_openwebtext_dataloader as jowt)
    from tpu_trainer.data.packing import PackedDataLoader as JPacked
    from tpu_trainer.data.tinystories import (
        create_tinystories_dataloader as jts)
    from tpu_trainer.utils.tokenizer import ByteTokenizer as JByte
    return types.SimpleNamespace(native=jnative, text=jtext, owt=jowt,
                                 ts=jts, Packed=JPacked, Byte=JByte)


def _lines(n=60, seed=3):
    """Seeded stories: words of lowercase letters, some blank lines and
    leading/trailing blanks, so strip and skip matter."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        if i % 17 == 5:
            out.append("   ")
            continue
        words = ["".join(rng.choice(letters, rng.integers(1, 8)))
                 for _ in range(rng.integers(3, 40))]
        out.append(("  " if i % 7 == 0 else "") + " ".join(words))
    return out


@pytest.fixture
def corpus(tmp_path):
    lines = _lines()
    p = tmp_path / "stories.txt"
    p.write_text("\n".join(lines) + "\n")
    gz = tmp_path / "web.txt.gz"
    with gzip.open(gz, "wt") as f:
        f.write("\n".join(lines) + "\n")
    uni = tmp_path / "unicode.txt"
    uni.write_text("\n".join(lines[:20] + ["café naïve — ok",
                                           "tab\there\r"]) + "\n")
    return types.SimpleNamespace(txt=str(p), gz=str(gz), uni=str(uni))


def _drain(loader, n=None):
    out = []
    for i, b in enumerate(loader):
        if n is not None and i >= n:
            break
        out.append(np.asarray(b))
    return out


def _assert_batches_equal(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_byte_tokenizer_matches_jax(jx):
    text = "Once upon a time, café — \U0001F600 end."
    ours, theirs = ByteTokenizer(), jx.Byte()
    assert ours.encode(text) == theirs.encode(text)
    ids = ours.encode(text) + [ours.eos_token_id, 300]
    assert ours.decode(ids) == theirs.decode(ids)
    assert (ours.vocab_size, ours.eos_token_id) == (50257, 50256)
    assert isinstance(get_tokenizer("byte"), ByteTokenizer)


def test_tokenizer_fallback_policy():
    with pytest.raises(RuntimeError, match="--tokenizer byte"):
        get_tokenizer("no-such-tokenizer-here", on_fallback="error")
    with pytest.warns(UserWarning, match="byte-level"):
        assert isinstance(get_tokenizer("no-such-tokenizer-here"),
                          ByteTokenizer)


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
@pytest.mark.parametrize("max_tokens", [None, 500])
def test_native_byte_tokenize_matches_jax_and_python(jx, corpus, shard,
                                                     max_tokens):
    """The built library against the JAX package's and against the
    byte-tokenizer Python loop."""
    assert native.get_lib() is not None
    data = open(corpus.txt, "rb").read()
    ours = native.byte_tokenize(data, 50256, *shard, max_tokens=max_tokens)
    theirs = jx.native.byte_tokenize(data, 50256, *shard,
                                     max_tokens=max_tokens)
    np.testing.assert_array_equal(ours, theirs)
    want = []
    for i, line in enumerate(data.decode().splitlines()):
        if i % shard[1] == shard[0] and line.strip():
            want += list(line.strip().encode()) + [50256]
    if max_tokens is not None:
        want = want[:max_tokens]
    np.testing.assert_array_equal(ours, np.asarray(want, np.int32))
    # Bytes with Python text semantics (non-ASCII, \r) defer to Python.
    assert native.byte_tokenize(open(corpus.uni, "rb").read(), 50256) is None


@pytest.mark.parametrize("path", ["txt", "gz", "uni"])
@pytest.mark.parametrize("native_on", [True, False])
def test_map_style_batches_and_eval_split_match_jax(jx, corpus, path,
                                                    native_on, monkeypatch):
    """Map-style chunks (native and Python tokenize paths), the shuffled
    epochs, the eval tail split and the cursor."""
    if not native_on:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    p = getattr(corpus, path)
    kw = dict(tokenizer_name="byte", seed=5, eval_split=0.1, prefetch=2)
    ours = create_tinystories_dataloader(p, 4, SEQ, **kw)
    theirs = jx.ts(p, 4, SEQ, **kw)
    for _ in range(2):                       # two epochs
        _assert_batches_equal(_drain(ours), _drain(theirs))
        assert ours.state_dict() == theirs.state_dict()
    _assert_batches_equal(_drain(ours.eval_loader),
                          _drain(theirs.eval_loader))


@pytest.mark.parametrize("name", ["tinystories", "openwebtext"])
@pytest.mark.parametrize("streaming", [False, True])
def test_dataset_factories_match_jax(jx, corpus, name, streaming):
    """``data/tinystories.py`` and ``data/openwebtext.py``: the JAX
    factories' signatures, and their batches, cursors and held-out eval
    batches bitwise on the seeded corpus (map-style: the eval tail split;
    streaming: the every-N-th-line holdout, through the gz file)."""
    import inspect

    ours_fn = {"tinystories": create_tinystories_dataloader,
               "openwebtext": create_openwebtext_dataloader}[name]
    theirs_fn = {"tinystories": jx.ts, "openwebtext": jx.owt}[name]
    def params(fn):
        """The positional parameters in order, the keyword-only ones by
        name (their order does not change a call)."""
        ps = inspect.signature(fn).parameters.values()
        return ([(p.name, p.kind, p.default) for p in ps
                 if p.kind != p.KEYWORD_ONLY],
                {p.name: p.default for p in ps if p.kind == p.KEYWORD_ONLY})
    assert params(ours_fn) == params(theirs_fn)
    path = corpus.gz if name == "openwebtext" else corpus.txt
    kw = dict(tokenizer_name="byte", seed=4, streaming=streaming,
              process_index=1, process_count=2, prefetch=0,
              **({"eval_holdout_every": 3} if streaming
                 else {"eval_split": 0.1}))
    ours = ours_fn(path, 2, SEQ, **kw)
    theirs = theirs_fn(path, 2, SEQ, **kw)
    _assert_batches_equal(_drain(ours), _drain(theirs))
    assert ours.state_dict() == theirs.state_dict()
    _assert_batches_equal(_drain(ours.eval_loader),
                          _drain(theirs.eval_loader))


def test_map_style_threaded_tokenize_and_budget_match_jax(jx, corpus):
    def make(mod, path):
        return mod.TextDataLoader(mod.TextDataset(
            path, SEQ, tokenizer_name="byte", max_tokens=700,
            num_workers=3), 2, prefetch=0)

    for p in (corpus.uni, corpus.txt):
        _assert_batches_equal(_drain(make(ttext, p)),
                              _drain(make(jx.text, p)))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("mask", [False, True])
def test_streaming_batches_holdout_and_gz_match_jax(jx, corpus, workers,
                                                    mask):
    """Streaming (gz), the every-N-th-line holdout for eval, the segment
    channel of ``mask_doc_boundaries``, the threaded tokenizer pool."""
    kw = dict(tokenizer_name="byte", streaming=True, seed=1,
              eval_holdout_every=4, num_workers=workers,
              mask_doc_boundaries=mask, cache_max_tokens=300)
    ours = create_openwebtext_dataloader(corpus.gz, 3, SEQ, **kw)
    theirs = jx.owt(corpus.gz, 3, SEQ, **kw)
    _assert_batches_equal(_drain(ours), _drain(theirs))
    assert ours.state_dict() == theirs.state_dict()
    _assert_batches_equal(_drain(ours.eval_loader),
                          _drain(theirs.eval_loader))
    if mask:
        assert _drain(ours)[0].shape == (3, SEQ, 2)


@pytest.mark.parametrize("streaming", [False, True])
def test_cursor_resume_matches_jax(jx, corpus, streaming):
    """A loader stopped after k batches and a fresh one positioned by
    ``load_state_dict`` continue with the same batches, in both packages;
    the cursors are equal."""
    kw = dict(tokenizer_name="byte", streaming=streaming, seed=2)
    full = _drain(create_tinystories_dataloader(corpus.txt, 2, SEQ, **kw))
    for make in (create_tinystories_dataloader, jx.ts):
        first = make(corpus.txt, 2, SEQ, **kw)
        it = iter(first)
        for _ in range(3):
            next(it)
        state = first.state_dict()
        assert state["batch_index"] == 3
        again = make(corpus.txt, 2, SEQ, **kw)
        again.load_state_dict(state)
        _assert_batches_equal(_drain(again), full[3:])
    ours = create_tinystories_dataloader(corpus.txt, 2, SEQ, **kw)
    theirs = jx.ts(corpus.txt, 2, SEQ, **kw)
    _drain(ours, 2)
    _drain(theirs, 2)
    assert ours.state_dict() == theirs.state_dict()


def test_packed_text_rows_match_jax(jx, corpus):
    """Lines binned into packed rows (tokens + segment ids) by each
    package's packer over each package's document stream."""
    def docs(mod):
        return mod.StreamingTextDataset(corpus.txt, SEQ,
                                        tokenizer_name="byte").iter_documents

    ours = PackedDataLoader(docs(ttext), 4, SEQ, seed=9)
    theirs = jx.Packed(docs(jx.text), 4, SEQ, seed=9)
    _assert_batches_equal(_drain(ours), _drain(theirs))
    assert ours.state_dict() == theirs.state_dict()


def test_prefetcher_reraises_producer_error():
    def make():
        yield 1
        yield 2
        raise KeyError("broken shard")

    got = []
    with pytest.raises(KeyError, match="broken shard"):
        for x in Prefetcher(make, depth=2):
            got.append(x)
    assert got == [1, 2]
    assert list(Prefetcher(lambda: iter(range(5)), depth=0)) == list(
        range(5))


def test_device_prefetcher_republishes_consumed_cursor(corpus):
    """With batches buffered ahead, the published cursor is that of the
    last batch handed out, and resuming from it replays the buffered
    batches."""
    loader = create_tinystories_dataloader(corpus.txt, 2, SEQ,
                                           tokenizer_name="byte", seed=4,
                                           prefetch=0)
    full = _drain(create_tinystories_dataloader(
        corpus.txt, 2, SEQ, tokenizer_name="byte", seed=4, prefetch=0))
    it = iter(loader)
    feed = DevicePrefetcher(lambda: next(it),
                            place=lambda b: torch.from_numpy(b),
                            cursor_fn=loader.state_dict, depth=3,
                            device="cpu")
    assert feed.state_dict()["batch_index"] == 0
    for k in range(2):
        got = feed.next()
        np.testing.assert_array_equal(got.numpy(), full[k])
    assert feed.buffered() == 3
    assert loader.state_dict()["batch_index"] == 5      # loader ran ahead
    cursor = feed.state_dict()
    assert cursor["batch_index"] == 2
    resumed = create_tinystories_dataloader(corpus.txt, 2, SEQ,
                                            tokenizer_name="byte", seed=4,
                                            prefetch=0)
    resumed.load_state_dict(cursor)
    _assert_batches_equal(_drain(resumed), full[2:])
    with pytest.raises(ValueError):
        DevicePrefetcher(lambda: None, place=lambda b: b, depth=-1)


def test_loader_without_cuda_stream_places_inline():
    """On the CPU there is no side stream: ``next`` returns ``place``'s
    tensor as it is."""
    items = iter([np.arange(4)])
    feed = DevicePrefetcher(lambda: next(items),
                            place=lambda b: torch.from_numpy(b) + 1,
                            depth=2, device="cpu")
    assert feed.next().tolist() == [1, 2, 3, 4]
    with pytest.raises(StopIteration):
        feed.next()


# -- per-process sharding (several ranks) ---------------------------------------

def _rows(batches):
    return [r.tobytes() for b in batches for r in b]


@pytest.mark.parametrize("world", [2, 3])
def test_map_style_rank_rows_match_jax_disjoint_covering(jx, corpus, world):
    """Rank r's map-style batches (a stride of the epoch's permutation,
    ragged tail dropped) are the JAX loader's bitwise, the ranks' rows are
    disjoint and together cover every row of the whole-epoch stride."""
    kw = dict(tokenizer_name="byte", seed=5, eval_split=0.1, prefetch=0)
    per_rank = []
    for r in range(world):
        ours = create_tinystories_dataloader(corpus.txt, 2, SEQ,
                                             process_index=r,
                                             process_count=world, **kw)
        theirs = jx.ts(corpus.txt, 2, SEQ, process_index=r,
                       process_count=world, **kw)
        got = _drain(ours)
        _assert_batches_equal(got, _drain(theirs))
        assert len(ours) == len(theirs) == len(got)
        _assert_batches_equal(_drain(ours.eval_loader),
                              _drain(theirs.eval_loader))
        per_rank.append(_rows(got))
    assert len({len(rows) for rows in per_rank}) == 1
    everything = [row for rows in per_rank for row in rows]
    assert len(set(everything)) == len(everything)          # disjoint
    # Covering: one process with the ranks' joint batch reads the same
    # rows, the permutation's first world * batches * 2 entries.
    whole = create_tinystories_dataloader(corpus.txt, 2 * world, SEQ, **kw)
    assert set(_rows(_drain(whole))) == set(everything)


@pytest.mark.parametrize("world", [2, 3])
def test_streaming_rank_rows_match_jax_disjoint_covering(jx, corpus, world):
    """Rank r streams the lines ``i % world == r``: its batches and held-out
    batches are the JAX loader's bitwise, and the ranks' documents are
    disjoint and cover the file's (the packed document stream shows it
    per line)."""
    kw = dict(tokenizer_name="byte", streaming=True, seed=1,
              eval_holdout_every=3, prefetch=0)
    docs = []
    for r in range(world):
        ours = create_openwebtext_dataloader(corpus.gz, 2, SEQ,
                                             process_index=r,
                                             process_count=world, **kw)
        theirs = jx.owt(corpus.gz, 2, SEQ, process_index=r,
                        process_count=world, **kw)
        _assert_batches_equal(_drain(ours), _drain(theirs))
        assert ours.state_dict() == theirs.state_dict()
        _assert_batches_equal(_drain(ours.eval_loader),
                              _drain(theirs.eval_loader))
        for role in ("train", "eval"):
            ds = ttext.StreamingTextDataset(
                corpus.gz, SEQ, tokenizer_name="byte", shard_id=r,
                num_shards=world, holdout=(role, 3))
            jds = jx.text.StreamingTextDataset(
                corpus.gz, SEQ, tokenizer_name="byte", shard_id=r,
                num_shards=world, holdout=(role, 3))
            mine = [tuple(d) for d in ds.iter_documents()]
            assert mine == [tuple(d) for d in jds.iter_documents()]
            docs.extend(mine)
    whole = ttext.StreamingTextDataset(corpus.gz, SEQ,
                                       tokenizer_name="byte")
    assert sorted(docs) == sorted(tuple(d) for d in whole.iter_documents())
