"""Port parity: the fused LM-head + cross entropy and the shifted loss.

- ``head_ce_reference`` (which ``head_ce_forward`` runs on CPU tensors)
  against the JAX Pallas kernel in interpret mode: vocab-major logits,
  lse and label logit, on shapes with ragged token and vocab edges.
- ``pallas_head_ce``'s loss, dE and dx against ``jax.vjp`` of the JAX
  ``pallas_head_ce(interpret=True)``.
- ``fused_shifted_cross_entropy`` (the chunked path on both sides) with
  and without segment ids, loss and gradients.

f32 inputs from a numpy seed. Tolerance atol=rtol=2e-5: f32 logits of
at most 64-wide dot products and logsumexps over at most 300 entries,
whose reduction orders differ between frameworks by a few ulp. bf16 runs
compare in f32 after both sides round the logits the same way.

The JAX side comes in through the ``jx`` fixture; the ``gpu`` tests at the
end run without JAX (``pytest --noconftest -m gpu
tests/test_torch_head_ce.py``).
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.ops import head_ce as thce
from tpu_trainer_torch.ops import loss as tloss

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.ops import head_ce, loss
    return types.SimpleNamespace(jax=jax, jnp=jnp, head_ce=head_ce,
                                 loss=loss)


def _case(seed, b, s, h, V):
    rs = np.random.RandomState(seed)
    emb = rs.standard_normal((V, h)).astype(np.float32)
    x = rs.standard_normal((b, s, h)).astype(np.float32)
    labels = rs.randint(0, V, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < s - 1).astype(np.float32).repeat(b, 0)
    return emb, x, labels, mask


SHAPES = [(2, 16, 32, 97), (1, 300, 64, 300), (3, 128, 32, 2050)]


@pytest.mark.parametrize("b,s,h,V", SHAPES)
def test_forward_matches_jax_interpret_kernel(jx, b, s, h, V):
    emb, x, labels, _ = _case(V, b, s, h, V)
    x2, lab = x.reshape(b * s, h), labels.reshape(b * s)
    jl, jlse, jll = jx.head_ce.head_ce_forward(
        jx.jnp.asarray(x2), jx.jnp.asarray(emb), jx.jnp.asarray(lab),
        interpret=True)
    tl, tlse, tll = thce.head_ce_reference(
        torch.from_numpy(x2), torch.from_numpy(emb), torch.from_numpy(lab))
    assert tl.shape == (V, b * s) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), **TOL)


def test_forward_bf16_logits_round_alike(jx):
    emb, x, labels, _ = _case(7, 2, 64, 32, 521)
    jnp = jx.jnp
    x2 = x.reshape(128, 32)
    jl, jlse, jll = jx.head_ce.head_ce_forward(
        jnp.asarray(x2).astype(jnp.bfloat16),
        jnp.asarray(emb).astype(jnp.bfloat16),
        jnp.asarray(labels.reshape(128)), interpret=True)
    tl, tlse, tll = thce.head_ce_reference(
        torch.from_numpy(x2).bfloat16(), torch.from_numpy(emb).bfloat16(),
        torch.from_numpy(labels.reshape(128)))
    assert tl.dtype == torch.bfloat16
    # Same f32 logits up to ulps, then one bf16 rounding on each side: at
    # most one bf16 ulp apart (2**-7 relative).
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-5)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), **TOL)


@pytest.mark.parametrize("b,s,h,V", SHAPES)
def test_pallas_head_ce_loss_and_grads_match_jax(jx, b, s, h, V):
    jax, jnp = jx.jax, jx.jnp
    emb, x, labels, mask = _case(V + 1, b, s, h, V)
    g = 1.7

    def jfn(e_, x_):
        return jx.head_ce.pallas_head_ce(e_, x_, jnp.asarray(labels),
                                         jnp.asarray(mask), None, True)

    want, vjp = jax.vjp(jfn, jnp.asarray(emb), jnp.asarray(x))
    w_de, w_dx = vjp(jnp.float32(g))
    te = torch.from_numpy(emb).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = thce.pallas_head_ce(te, tx, torch.from_numpy(labels).long(),
                              torch.from_numpy(mask))
    (got * g).backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(w_de), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(w_dx), **TOL)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("chunk", [0, 32])
def test_fused_shifted_cross_entropy_matches_jax(jx, segmented, chunk):
    jax, jnp = jx.jax, jx.jnp
    b, s, h, V = 2, 64, 32, 211
    emb, x, labels, _ = _case(3, b, s, h, V)
    seg = np.repeat(np.array([[1, 1, 2, 3], [1, 2, 2, 0]]), s // 4,
                    axis=1).astype(np.int32)

    def jfn(e_, x_):
        return jx.loss.fused_shifted_cross_entropy(
            e_, x_, jnp.asarray(labels), chunk_size=chunk,
            segment_ids=jnp.asarray(seg) if segmented else None)

    want, grads = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(x))
    te = torch.from_numpy(emb).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tloss.fused_shifted_cross_entropy(
        te, tx, torch.from_numpy(labels).long(), chunk_size=chunk,
        segment_ids=torch.from_numpy(seg) if segmented else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(grads[0]), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[1]), **TOL)


@pytest.mark.parametrize("b,s,c", [(8, 1024, 0), (1, 300, 0), (4, 97, 0),
                                   (2, 512, 100), (64, 1024, 0)])
def test_chunk_len_matches(jx, b, s, c):
    assert tloss._chunk_len(b, s, c) == jx.loss._chunk_len(b, s, c)


def test_segment_target_mask_matches(jx):
    seg = np.array([[1, 1, 2, 2, 0, 0], [3, 3, 3, 1, 1, 1]], np.int32)
    want = np.asarray(jx.loss.segment_target_mask(jx.jnp.asarray(seg)))
    got = tloss.segment_target_mask(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_pallas_rule_is_cuda_bf16_in_range():
    x = torch.zeros((2, 1024, 8), dtype=torch.bfloat16)
    assert not tloss._pallas_head_ok(x, 0)            # a CPU tensor
    assert not tloss._pallas_head_ok(x.float(), 0)
    before = thce.head_ce_forward.launches
    emb = torch.zeros((16, 8))
    tloss.fused_shifted_cross_entropy(emb, x, torch.zeros((2, 1024),
                                                          dtype=torch.long))
    assert thce.head_ce_forward.launches == before


@pytest.mark.parametrize("T,V,sms", [(8192, 50257, 132), (2048, 50257, 132),
                                     (300, 2050, 132), (256, 97, 132),
                                     (8192, 50257, 114), (200, 300, 7)])
def test_work_split_covers_every_tile_once(T, V, sms):
    """The kernel's persistent walk (unit u = token tile u % nt, split
    u // nt; block b takes units b, b + grid, ...) over work_split's count
    covers every (token tile, vocab tile) once, leaves no split empty, and
    gives the busiest block the fewest vocab tiles of any split count."""
    bt, bv = thce._BLOCK_T, thce._BLOCK_V
    nt, nv = -(-T // bt), -(-V // bv)

    def walk(n):
        tps = -(-nv // n)
        units = nt * n
        grid = min(sms, units)
        seen, busiest = [], 0
        for blk in range(grid):
            tiles = 0
            for u in range(blk, units, grid):
                vts = range(u // nt * tps, min(nv, (u // nt + 1) * tps))
                seen += [(u % nt, vt) for vt in vts]
                tiles += len(vts)
            busiest = max(busiest, tiles)
        return seen, busiest, tps

    n = thce.work_split(T, V, sms)
    seen, busiest, tps = walk(n)
    assert sorted(seen) == [(t, v) for t in range(nt) for v in range(nv)]
    assert (n - 1) * tps < nv
    assert busiest == min(walk(m)[1] for m in range(1, nv + 1)
                          if (m - 1) * -(-nv // m) < nv)


def test_pad_hidden_keeps_the_logits():
    """H off a multiple of 8 gets zero columns (TMA's 16-byte rows); the
    plain version's logits, lse and label logit on the padded operands are
    those of the originals."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.standard_normal((30, 100)).astype(np.float32))
    e = torch.from_numpy(rs.standard_normal((50, 100)).astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, 50, 30))
    xp, ep = thce._pad_hidden(x, e)
    assert xp.shape == (30, 104) and ep.shape == (50, 104)
    assert torch.equal(xp[:, :100], x) and not xp[:, 100:].any()
    assert torch.equal(ep[:, :100], e) and not ep[:, 100:].any()
    for a, b in zip(thce.head_ce_reference(xp, ep, lab),
                    thce.head_ce_reference(x, e, lab)):
        torch.testing.assert_close(a, b, **TOL)
    x8, e8 = x[:, :96].contiguous(), e[:, :96].contiguous()
    assert thce._pad_hidden(x8, e8) == (x8, e8)


@pytest.mark.parametrize("T,ldt", [(300, 304), (8192, 8192), (5, 8)])
def test_logits_buffer_rows_are_16_byte_strided(T, ldt):
    """The kernel's [V, T] logits have rows a multiple of 8 elements apart;
    head_ce_grads takes the strided view as it takes a contiguous copy."""
    buf = thce._logits_buffer(7, T, torch.zeros((), dtype=torch.bfloat16))
    assert buf.shape == (7, T) and buf.stride() == (ldt, 1)
    assert buf.dtype == torch.bfloat16
    assert buf.is_contiguous() == (T == ldt)
    if T > 8:
        return
    rs = np.random.RandomState(T)
    x = torch.from_numpy(rs.standard_normal((T, 16)).astype(np.float32))
    e = torch.from_numpy(rs.standard_normal((7, 16)).astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, 7, T))
    lg, lse, _ = thce.head_ce_reference(x, e, lab)
    view = thce._logits_buffer(7, T, lg)
    view.copy_(lg)
    w = torch.full((T,), 1.0 / T)
    for a, b in zip(thce.head_ce_grads(view, lse, lab, w, x, e),
                    thce.head_ce_grads(lg.clone(), lse, lab, w, x, e)):
        assert torch.equal(a, b)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,H,V", [(256, 64, 97),
                                   (300, 768, 2050),   # T % 8: padded rows
                                   (2048, 96, 50257),
                                   (200, 100, 300),    # H % 8: padded H
                                   (8192, 768, 50257)])  # the training shape
def test_kernel_matches_plain_on_card(cuda_device, T, H, V):
    rs = np.random.RandomState(T)
    x = torch.from_numpy(rs.standard_normal((T, H)).astype(np.float32))
    e = torch.from_numpy(rs.standard_normal((V, H)).astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, V, T).astype(np.int64))
    x, e, lab = (t.to(cuda_device) for t in (x, e, lab))
    x, e = x.bfloat16(), e.bfloat16()
    before = thce.head_ce_forward.launches
    lg, lse, ll = thce.head_ce_forward(x, e, lab)
    torch.cuda.synchronize()
    assert thce.head_ce_forward.launches == before + 1
    rlg, rlse, rll = thce.head_ce_reference(x, e, lab)
    # Same bf16 products summed in f32 in another order: the f32 logits
    # differ by ulps of |logit| <= ~4 sqrt(H), so at most one bf16 ulp
    # after rounding; lse/ll are f32 (ulps of the sums).
    torch.testing.assert_close(lg.float(), rlg.float(), atol=1e-2,
                               rtol=2**-7)
    torch.testing.assert_close(lse, rlse, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(ll, rll, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T,H,V,dtype", [(8192, 768, 50257, "bfloat16"),
                                         (300, 100, 2050, "float16")])
def test_kernel_bitwise_twice_on_card(cuda_device, T, H, V, dtype):
    """Every logit is owned by one unit of the persistent grid and the vocab
    splits merge in a fixed order: logits, lse and ll are bitwise the same
    from run to run."""
    rs = np.random.RandomState(V)
    x = torch.from_numpy(rs.standard_normal((T, H)).astype(np.float32))
    e = torch.from_numpy((rs.standard_normal((V, H)) * 0.05).astype(np.float32))
    lab = torch.from_numpy(rs.randint(0, V, T).astype(np.int64))
    dt = getattr(torch, dtype)
    x, e, lab = x.to(cuda_device, dt), e.to(cuda_device, dt), lab.to(cuda_device)
    first = [t.clone() for t in thce.head_ce_forward(x, e, lab)]
    second = thce.head_ce_forward(x, e, lab)
    torch.cuda.synchronize()
    for name, a, b in zip(("logits", "lse", "ll"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_kernel_rejects_f32(cuda_device):
    x = torch.zeros((128, 64), device=cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        thce.head_ce_forward(x, torch.zeros((10, 64), device=cuda_device),
                             torch.zeros(128, dtype=torch.long,
                                         device=cuda_device))
