"""The port's generation (``models/gpt.py``: ``GPT.decode``,
``generate_kv``, ``generate``) and the infer CLI (``eval/infer.py``).

Greedy tokens of the port's ``generate_kv`` equal the JAX package's from
the same weights (uniform and ragged prompts), and so do the port's
exact-shape ``generate`` and the JAX ``generate_bucketed``; the cached logits equal the
uncached forward's within 2e-5 (f32 through two layers, as the
paged-forward tests bound it). Tiny f32 geometry on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from tpu_trainer_torch.data.dummy import DummyDataLoader
from tpu_trainer_torch.eval import infer
from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import GPT, generate, generate_kv, init_cache
from tpu_trainer_torch.models.weights import from_jax_params
from tpu_trainer_torch.training.config import TrainingConfig
from tpu_trainer_torch.training.trainer import Trainer
from tpu_trainer_torch.utils import checkpoint as ckpt

BASE = dict(vocab_size=300, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2)
CONFIGS = {"mha": {}, "gqa": {"num_heads": 4, "num_kv_heads": 2}}


def _model(cfg, seed=0):
    from tpu_trainer_torch.models.weights import init_params

    model = GPT(cfg, device="meta")
    model.load_state_dict(init_params(cfg, seed, device="cpu"), strict=True,
                          assign=True)
    return model.requires_grad_(False)


def _prompts(b, width, vocab, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, width))).long()


def _jax_and_port(kw):
    """JAX params and config, and the port's model on the same weights."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.config import GPTConfig as JConfig
    from tpu_trainer.models.gpt import GPT as JGPT

    jcfg = JConfig(**kw)
    params = JGPT(jcfg).init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = GPTConfig(**kw)
    model = GPT(cfg, device="meta")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu"),
                          strict=True, assign=True)
    return params, jcfg, model.requires_grad_(False)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_kv_greedy_matches_jax(name, ragged):
    params, jcfg, model = _jax_and_port({**BASE, **CONFIGS[name]})
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.gpt import generate_kv as jgenerate_kv

    cfg = model.config
    ids = _prompts(3, 9, cfg.vocab_size)
    lens = np.array([9, 4, 6]) if ragged else None
    if ragged:
        ids[1, 4:] = 0
        ids[2, 6:] = 0
    want = jgenerate_kv(params, jax.random.PRNGKey(0),
                        jnp.asarray(ids.numpy(), jnp.int32), config=jcfg,
                        max_new_tokens=12, temperature=0.0,
                        prompt_lens=None if lens is None else
                        jnp.asarray(lens, jnp.int32))
    got = generate_kv(model, ids, max_new_tokens=12, temperature=0.0,
                      prompt_lens=None if lens is None else
                      torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_incremental_logits_match_uncached_forward(name):
    cfg = GPTConfig(**{**BASE, **CONFIGS[name]})
    model = _model(cfg)
    ids = _prompts(2, 20, cfg.vocab_size)
    want, _ = model(ids)
    cache = init_cache(cfg, 2, device="cpu", max_len=32)
    parts = [model.decode(ids[:, :8], cache)]
    for i in range(8, 20):
        parts.append(model.decode(ids[:, i:i + 1], cache))
    assert cache["idx"] == 20
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(),
                               want.numpy(), atol=2e-5, rtol=2e-5)


def test_ragged_cache_rows_match_their_own_prompts():
    """A left-padded row of a ragged batch decodes as that prompt alone."""
    cfg = GPTConfig(**BASE)
    model = _model(cfg)
    ids = _prompts(2, 10, cfg.vocab_size)
    ids[1, 6:] = 0
    both = generate_kv(model, ids, max_new_tokens=8, temperature=0.0,
                       prompt_lens=torch.tensor([10, 6]))
    alone = generate_kv(model, ids[1:, :6], max_new_tokens=8,
                        temperature=0.0)
    assert both[1, :14].tolist() == alone[0].tolist()
    assert both[1, 14:].tolist() == [0] * 4
    with pytest.raises(ValueError, match="prompt_lens"):
        generate_kv(model, ids, max_new_tokens=2,
                    prompt_lens=torch.tensor([11, 3]))


@pytest.mark.parametrize("max_new", [7, 62])
def test_generate_bucketed_matches_exact_shapes(max_new):
    """The JAX ``generate_bucketed`` (power-of-two widths; at 62 new
    tokens the window crops and it runs the exact shapes) gives the port's
    exact-shape ``generate`` greedy tokens."""
    params, jcfg, model = _jax_and_port(BASE)
    import jax
    import jax.numpy as jnp

    from tpu_trainer.models.gpt import generate_bucketed as jbucketed

    ids = _prompts(2, 5, model.config.vocab_size)
    want = jbucketed(params, jax.random.PRNGKey(0),
                     jnp.asarray(ids.numpy(), jnp.int32), config=jcfg,
                     max_new_tokens=max_new, temperature=0.0)
    got = generate(model, ids, max_new_tokens=max_new, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_kv_greedy_equals_windowed_generate():
    cfg = GPTConfig(**BASE)
    model = _model(cfg)
    ids = _prompts(2, 5, cfg.vocab_size)
    kv = generate_kv(model, ids, max_new_tokens=7, temperature=0.0)
    assert kv.tolist() == generate(model, ids, max_new_tokens=7,
                                   temperature=0.0).tolist()


def test_sampling_is_deterministic_per_seed_and_position():
    cfg = GPTConfig(**BASE)
    model = _model(cfg)
    ids = _prompts(1, 5, cfg.vocab_size).repeat(2, 1)
    a = generate_kv(model, ids, max_new_tokens=10, temperature=1.0,
                    top_k=50, seed=7)
    b = generate_kv(model, ids, max_new_tokens=10, temperature=1.0,
                    top_k=50, seed=7)
    c = generate_kv(model, ids, max_new_tokens=10, temperature=1.0,
                    top_k=50, seed=8)
    assert a.tolist() == b.tolist() != c.tolist()
    # Equal prompts: row 1 of seed 7 is row 0 of seed 8 (each row draws
    # from seed + row), and rows of one seed differ.
    assert a[1].tolist() == c[0].tolist() != a[0].tolist()


# -- the CLI ----------------------------------------------------------------

MODEL = GPTConfig(**dict(BASE, vocab_size=50257, hidden_size=16,
                         initializer_range=0.02, dropout=0.1))
TRAIN = TrainingConfig(batch_size=2, max_seq_len=64,
                       gradient_accumulation_steps=1, mixed_precision="fp32",
                       warmup_steps=1)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    trainer = Trainer(MODEL, TRAIN, device="cpu")
    state = trainer.init_state()
    for b in DummyDataLoader(2, 64, 256, num_batches=2):
        state, _ = trainer.train_step(state, b)
    path = ckpt.save_checkpoint(str(d), state, model_config=MODEL,
                                training_config=TRAIN)
    return path, ckpt.export_consolidated(path, state.params)


def _run(args, capsys):
    result = {}
    assert infer.main(["--device", "cpu", "--tokenizer", "byte"] + args,
                      result=result) == 0
    return capsys.readouterr().out, result


@pytest.mark.parametrize("where", ["step_dir", "root", "consolidated"])
def test_cli_prints_text_from_every_checkpoint_form(saved, where, capsys):
    path = {"step_dir": saved[0], "root": os.path.dirname(saved[0]),
            "consolidated": saved[1]}[where]
    out, res = _run(["--checkpoint", path, "--prompt", "hi",
                     "--max_new_tokens", "6", "--temperature", "0"], capsys)
    assert out.startswith("hi")
    assert len(res["tokens"][0]) == 8
    base, _ = _run(["--checkpoint", saved[0], "--prompt", "hi",
                    "--max_new_tokens", "6", "--temperature", "0"], capsys)
    assert out == base


def test_cli_serve_greedy_equals_kv_path(saved, tmp_path, capsys):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("Once upon a time\nhi\nthe cat sat\n")
    args = ["--checkpoint", saved[0], "--prompt_file", str(prompts),
            "--max_new_tokens", "9", "--temperature", "0"]
    kv_out, kv = _run(args, capsys)
    trace = tmp_path / "trace.jsonl"
    serve_out, served = _run(args + ["--serve", "--record_trace",
                                     str(trace)], capsys)
    assert served["tokens"] == kv["tokens"]
    assert serve_out == kv_out and len(kv_out.splitlines()) == 3
    # One decode iteration a token after the prefill's first.
    assert served["stats"]["decode_iters"] == 8
    assert len(trace.read_text().splitlines()) == 3
    full, _ = _run(["--checkpoint", saved[0], "--prompt", "hi",
                    "--max_new_tokens", "4", "--temperature", "0",
                    "--no_kv_cache"], capsys)
    assert full.splitlines()[0] == kv_out.splitlines()[1][:len(
        full.splitlines()[0])]


def test_cli_sampled_serve_equals_kv_path(saved, capsys):
    """The KV path samples row r with seed + r, as ``--serve`` seeds
    request r."""
    args = ["--checkpoint", saved[0], "--prompt", "abc",
            "--max_new_tokens", "8", "--temperature", "0.9", "--top_k", "40",
            "--seed", "5"]
    _, kv = _run(args, capsys)
    _, served = _run(args + ["--serve"], capsys)
    assert kv["tokens"] == served["tokens"]


@pytest.mark.parametrize("extra,match", [
    # --spec is a serving-engine feature (the JAX CLI's usage error).
    (["--spec", "ngram"], (SystemExit, "2")),
    # Data-parallel and tensor-parallel decode run; at one process a
    # 2-way mesh is the world-size error.
    (["--mesh_data", "2"], (SystemExit, "wants 2 devices but 1 are")),
    (["--mesh_tensor", "2"], (SystemExit, "wants 2 devices but 1 are")),
])
def test_cli_later_item_flags_raise(saved, extra, match):
    exc, text = match
    with pytest.raises(exc, match=text):
        infer.main(["--checkpoint", saved[0], "--device", "cpu"] + extra)


def test_cli_without_cuda_raises(saved):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--checkpoint", saved[0]])


@pytest.mark.parametrize("temperature", ["0", "0.9"])
def test_cli_mesh_data_two_ranks_equals_one_process(saved, tmp_path, capsys,
                                                    temperature):
    """``--mesh_data 2`` on two gloo CPU ranks under ``torchrun
    --standalone``: each rank decodes half the ragged prompts, rank 0
    alone prints every row, and the text is the one-process run's, greedy
    and sampled (each row keeps its global seed)."""
    import subprocess
    import sys

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("Once upon a time\nhi\nthe cat sat\nab\n")
    args = ["--checkpoint", saved[0], "--prompt_file", str(prompts),
            "--max_new_tokens", "5", "--temperature", temperature,
            "--top_k", "20", "--seed", "3"]
    one, _ = _run(args, capsys)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "tpu_trainer_torch.eval.infer",
         "--device", "cpu", "--tokenizer", "byte", "--mesh_data", "2"]
        + args,
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 COORDINATOR_TIMEOUT_S="120"),
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    # Both ranks write to torchrun's stdout: rank 1 adds nothing.
    assert proc.stdout == one
    with pytest.raises(SystemExit):
        infer.main(["--checkpoint", saved[0], "--device", "cpu",
                    "--mesh_data", "3"])


@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_cli_serve_spec_equals_plain_serve(saved, spec, capsys):
    """``--serve --spec`` decodes speculatively; greedy text is the plain
    ``--serve`` text, and drafts were verified."""
    args = ["--checkpoint", saved[0], "--prompt", "abcabcabc",
            "--max_new_tokens", "12", "--temperature", "0", "--serve"]
    plain, _ = _run(args, capsys)
    out, res = _run(args + ["--spec", spec, "--spec_k", "3",
                            "--spec_draft_layers", "1"], capsys)
    assert out == plain
    assert res["stats"]["spec_steps"] > 0
