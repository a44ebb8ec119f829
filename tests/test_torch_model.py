"""Port parity: the paged GPT forward against JAX ``GPT.apply(decode=True)``.

Weights cross frameworks the way a deployment carries them: the JAX
params go through ``save_params_npz`` -> the port's ``load_params_npz``
-> ``from_jax_params``. Tiny geometry (vocab 128, hidden 32, 2 layers),
f32, dropout off. One scenario per config: a whole-prompt prefill, a
second chunk that attends pooled history, then two decode steps with an
idle row — the shapes the engine feeds. Logits of the real positions
must agree to atol=rtol=2e-5 (f32 through two layers and a 128-wide head;
framework matmul/softmax reduction orders differ by a few ulp), and the
fp pools the port writes in place must equal the pools JAX returns to
the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_trainer.models.config import GPTConfig as JConfig
from tpu_trainer.models.gpt import GPT as JGPT
from tpu_trainer.models.gpt import init_paged_cache as j_init_cache
from tpu_trainer.serving.remote import save_params_npz
from tpu_trainer_torch.models.config import GPTConfig as TConfig
from tpu_trainer_torch.models.gpt import GPT as TGPT
from tpu_trainer_torch.models.gpt import init_paged_cache as t_init_cache
from tpu_trainer_torch.models.weights import (
    from_jax_params,
    init_params,
    load_params_npz,
    param_specs,
)

TOL = dict(atol=2e-5, rtol=2e-5)
BASE = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
            max_seq_len=64, dropout=0.0, attention_dropout=0.0,
            dtype="float32", param_dtype="float32", initializer_range=0.2)
PAGED = dict(decode_paged=True, paged_block_size=4, paged_num_blocks=13,
             paged_max_blocks=6)
CONFIGS = {
    "mha": {},
    "gqa": {"num_heads": 4, "num_kv_heads": 2},
    "int8": {"paged_kv_int8": True},
    "unfused": {"fused_projections": False},
}


def _jax_params(cfg_kw, tmp_path):
    jcfg = JConfig(**{**BASE, **cfg_kw})
    params = JGPT(jcfg).init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]
    path = str(tmp_path / "params.npz")
    save_params_npz(path, jax.tree.map(np.asarray, params))
    return params, path


def _passes():
    """(ids [3, s], tables, lengths, offsets, hist_blocks) per pass; row 2
    is idle throughout (table 0, length 0)."""
    rs = np.random.RandomState(3)
    tables = np.zeros((3, 6), np.int32)
    tables[0] = np.arange(1, 7)
    tables[1] = np.arange(7, 13)
    out = []
    ids = np.zeros((3, 8), np.int32)
    ids[0, :7] = rs.randint(1, 128, 7)
    ids[1, :5] = rs.randint(1, 128, 5)
    out.append((ids, tables, np.array([7, 5, 0], np.int32),
                np.zeros(3, np.int32), 0))
    ids = np.zeros((3, 8), np.int32)
    ids[0, :5] = rs.randint(1, 128, 5)
    ids[1, :3] = rs.randint(1, 128, 3)
    out.append((ids, tables, np.array([12, 8, 0], np.int32),
                np.array([7, 5, 0], np.int32), 2))
    for lens in ([12, 8, 0], [13, 9, 0]):
        dec_tables = tables.copy()
        out.append((rs.randint(1, 128, (3, 1)).astype(np.int32), dec_tables,
                    np.array(lens, np.int32), np.zeros(3, np.int32), 0))
    return out


def _jax_pass(jcfg, params, cache, ids, tables, lengths, offsets, hb):
    def put(path, x):
        key = getattr(path[-1], "key", None)
        if key in ("tables", "lengths", "offsets"):
            src = {"tables": tables, "lengths": lengths, "offsets": offsets}
            return jnp.broadcast_to(jnp.asarray(src[key]), x.shape)
        return x

    cache = jax.tree_util.tree_map_with_path(put, cache)
    cfg = dataclasses.replace(jcfg, paged_hist_blocks=hb)
    (logits, _), out = JGPT(cfg).apply(
        {"params": params, "cache": cache}, jnp.asarray(ids), decode=True,
        mutable=["cache"])
    return np.asarray(logits), out["cache"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_forward_matches_jax(name, tmp_path):
    cfg_kw = CONFIGS[name]
    params, path = _jax_params(cfg_kw, tmp_path)
    jcfg = JConfig(**{**BASE, **cfg_kw, **PAGED})
    tcfg = TConfig(**{**BASE, **cfg_kw, **PAGED})
    model = TGPT(tcfg, device="meta")
    model.load_state_dict(
        from_jax_params(load_params_npz(path), tcfg, device="cpu"),
        strict=True, assign=True)
    jcache = j_init_cache(jcfg, 3)
    tcache = t_init_cache(tcfg, 3, device="cpu")

    for ids, tables, lengths, offsets, hb in _passes():
        want, jcache = _jax_pass(jcfg, params, jcache, ids, tables, lengths,
                                 offsets, hb)
        tcache["tables"].copy_(torch.from_numpy(tables))
        tcache["lengths"].copy_(torch.from_numpy(lengths))
        tcache["offsets"].copy_(torch.from_numpy(offsets))
        with torch.inference_mode():
            got = model(torch.from_numpy(ids).long(), tcache,
                        hist_blocks=hb).numpy()
        s = ids.shape[1]
        for r in range(2):                    # row 2 is idle
            n = s if s == 1 else lengths[r] - offsets[r]
            np.testing.assert_allclose(got[r, :n], want[r, :n], **TOL)
        if s > 1:
            # logits_at picks one position per row from the same pass.
            at = np.maximum(lengths - offsets - 1, 0)
            assert np.isfinite(got).all()
            assert got[np.arange(3), at].shape == (3, 128)

    # The pools the port updated in place equal the JAX cache (real
    # blocks 1..12; block 0 takes the colliding masked writes).
    for key in ("pool_k", "pool_v"):
        j = np.asarray(jcache["layers"]["attention"][key])[:, 1:]
        t = tcache[key][:, 1:].float().numpy()
        if tcfg.paged_kv_int8:
            assert np.abs(t - j).max() <= 1     # one int8 step at most
        else:
            np.testing.assert_allclose(t, j, **TOL)


def test_logits_at_selects_rows(tmp_path):
    params, path = _jax_params({}, tmp_path)
    tcfg = TConfig(**BASE, **PAGED)
    model = TGPT(tcfg, device="meta")
    model.load_state_dict(
        from_jax_params(load_params_npz(path), tcfg, device="cpu"),
        assign=True)
    ids, tables, lengths, offsets, _ = _passes()[0]
    at = torch.tensor([6, 4, 0])
    outs = []
    for sel in (None, at):
        cache = t_init_cache(tcfg, 3, device="cpu")
        cache["tables"].copy_(torch.from_numpy(tables))
        cache["lengths"].copy_(torch.from_numpy(lengths))
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(ids).long(), cache,
                              logits_at=sel))
    full, picked = outs
    assert picked.shape == (3, 1, 128)
    torch.testing.assert_close(picked[:, 0], full[torch.arange(3), at],
                               atol=1e-6, rtol=1e-6)


def test_weights_names_and_init(tmp_path):
    params, path = _jax_params({"num_heads": 4, "num_kv_heads": 2}, tmp_path)
    cfg = TConfig(**{**BASE, "num_heads": 4, "num_kv_heads": 2})
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if hasattr(v, "items"):
                walk(v, name)
            else:
                flat[name] = tuple(v.shape)

    walk(params, "")
    specs = param_specs(cfg)
    assert flat == {n: shape for n, (shape, _) in specs.items()}
    sd = init_params(cfg, seed=1, device="cpu")
    assert set(sd) == set(specs)
    assert torch.equal(sd["norm.weight"], torch.ones(32))
    emb = sd["embed_tokens.embedding"]
    assert abs(float(emb.std()) - 0.2) < 0.02
    again = init_params(cfg, seed=1, device="cpu")
    assert all(torch.equal(sd[n], again[n]) for n in sd)
    bad = load_params_npz(path)
    del bad["norm"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, cfg, device="cpu")
