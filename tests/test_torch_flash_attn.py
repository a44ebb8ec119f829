"""Port parity: training flash attention and the dropout masks.

- The port's ``_keep_mask`` and ``hash_dropout`` against the JAX
  package's, bitwise, including positions whose ``row * seq`` wraps
  2**32.
- ``flash_attention_reference`` (which ``flash_attention`` runs on CPU
  tensors) against the JAX Pallas kernels in interpret mode
  (``tpu_trainer.ops.flash.flash_attention(..., interpret=True)`` with
  32-blocks, so the kernel streams two blocks and regenerates the dropout
  mask per block): outputs and q/k/v gradients for MHA and GQA, RoPE on
  and off, dropout with the same seed bits, and segment ids. f32 inputs
  from a numpy seed. Tolerance atol=rtol=2e-5: both sides are f32 softmax
  sums over at most 64 unit-scale positions whose reduction orders differ
  (online vs one-shot softmax); that is a few ulp of O(1) values, and the
  gradients add one more reduction. With segment ids, against the JAX
  forward and split backward (``backward="split"``) at atol=rtol=1e-5.

The JAX side comes in through the ``jx`` fixture: the card's machine has
no JAX, and there the ``gpu`` tests at the end run alone
(``pytest --noconftest -m gpu tests/test_torch_flash_attn.py``) while the
parity tests skip.
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.ops import dropout as tdrop
from tpu_trainer_torch.ops import flash as tflash
from tpu_trainer_torch.ops.rope import rope_tables

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash and dropout modules, ``jax`` and
    ``jax.numpy``."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.ops import dropout, flash
    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=flash,
                                 dropout=dropout)


@pytest.mark.parametrize("seed,salt,q_start,k_start,bq,bk,seq,rate", [
    (0xFEEDBEEF, 5, 0, 0, 64, 64, 64, 0.25),
    (123, 0, 512, 256, 32, 48, 1024, 0.1),
    (2**32 - 1, 2**20 + 7, 0, 0, 16, 16, 16, 0.5),
    # row * seq wraps 2**32: rows near 2**31, seq 60000.
    (77, 3, 2**31 - 64, 1000, 32, 40, 60000, 0.1),
    (9, 11, 4096, 0, 8, 8, 65535, 0.9),
])
def test_keep_mask_bitwise(jx, seed, salt, q_start, k_start, bq, bk, seq,
                           rate):
    jnp = jx.jnp
    want = np.asarray(jx.flash._keep_mask(
        jnp.uint32(seed), jnp.uint32(salt), q_start, k_start, bq, bk, seq,
        rate))
    got = tflash._keep_mask(seed, salt, q_start, k_start, bq, bk, seq, rate)
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_mask_full_salts(jx):
    """The [b, h, s, s] mask takes salt b * heads + h per (batch, head)."""
    jnp = jx.jnp
    full = tflash.keep_mask_full(99, 2, 3, 40, 0.3)
    for ib in range(2):
        for ih in range(3):
            want = np.asarray(jx.flash._keep_mask(
                jnp.uint32(99), jnp.uint32(ib * 3 + ih), 0, 0, 40, 40, 40,
                0.3))
            np.testing.assert_array_equal(full[ib, ih].numpy(), want)


@pytest.mark.parametrize("shape,dtype,rate", [
    ((4, 16, 32), "float32", 0.1),
    ((2, 8, 24), "bfloat16", 0.1),
    ((3, 50), "float32", 0.5),
])
@pytest.mark.parametrize("key", [0, 17])
def test_hash_dropout_bitwise(jx, shape, dtype, rate, key):
    jax, jnp = jx.jax, jx.jnp
    x = np.random.RandomState(key).standard_normal(shape).astype(np.float32)
    rng = jax.random.PRNGKey(key)
    want = jx.dropout.hash_dropout(jnp.asarray(x).astype(dtype), rate, rng)
    seed = int(jax.random.bits(rng, dtype=jnp.uint32))
    got = tdrop.hash_dropout(torch.from_numpy(x).to(getattr(torch, dtype)),
                             rate, seed)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_mul32_matches_uint32():
    rs = np.random.RandomState(0)
    x = rs.randint(0, 2**32, 1000, dtype=np.uint64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0xFFFFFFFF, 1):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = tdrop.mul32(torch.from_numpy(x.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


CASES = {
    # name: (h, kvh, rope, dropout_rate, segmented)
    "mha": (4, 4, False, 0.0, False),
    "mha_rope": (4, 4, True, 0.0, False),
    "gqa_rope": (4, 2, True, 0.0, False),
    "dropout_rope": (4, 4, True, 0.3, False),
    "gqa_dropout": (4, 2, False, 0.3, False),
    "gqa_rope_dropout": (4, 2, True, 0.3, False),
    "gqa_rope_dropout_segments": (4, 2, True, 0.3, True),
    "segments": (4, 2, True, 0.0, True),
}


def _inputs(h, kvh, b=2, s=64, d=16, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, s, h, d)).astype(np.float32)
    k = rs.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rs.standard_normal((b, s, kvh, d)).astype(np.float32)
    do = rs.standard_normal((b, s, h, d)).astype(np.float32)
    seg = np.repeat(np.array([[1, 1, 2, 3], [1, 2, 2, 0]]), s // 4, axis=1)
    return q, k, v, do, seg.astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_interpret_kernel(jx, case):
    jax, jnp = jx.jax, jx.jnp
    h, kvh, rope, rate, segmented = CASES[case]
    q, k, v, do, seg = _inputs(h, kvh)
    s, d = q.shape[1], q.shape[3]
    cos, sin = rope_tables(s, d)
    rng = jax.random.PRNGKey(5) if rate else None
    seed = int(jax.random.bits(rng, dtype=jnp.uint32)) if rate else None

    def jfn(q_, k_, v_):
        return jx.flash.flash_attention(
            q_, k_, v_, block_q=32, block_k=32, interpret=True,
            dropout_rate=rate, dropout_rng=rng,
            rope=(jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
            if rope else None,
            segment_ids=jnp.asarray(seg) if segmented else None)

    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tflash.flash_attention_reference(
        tq, tk, tv, dropout_rate=rate, seed=seed,
        rope=(cos, sin) if rope else None,
        segment_ids=torch.from_numpy(seg) if segmented else None)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)


SEG_LAYOUTS = {
    # [b=2, s=64] segment ids, 0 = padding.
    "packed": [[1] * 20 + [2] * 30 + [3] * 10 + [0] * 4,
               [1] * 5 + [2] * 3 + [3] * 40 + [4] * 16],
    "short_docs": [[i // 3 + 1 for i in range(60)] + [0] * 4,
                   [1] * 64],
    "across_blocks": [[1] * 50 + [2] * 14, [1] * 2 + [2] * 61 + [0]],
}
SEG_CASES = {
    # name: (h, kvh, rope, dropout_rate, layout)
    "mha_rope_packed": (4, 4, True, 0.0, "packed"),
    "gqa_rope_short_docs": (4, 2, True, 0.0, "short_docs"),
    "dropout_rope_across_blocks": (4, 4, True, 0.3, "across_blocks"),
    "gqa_dropout_packed": (4, 2, False, 0.3, "packed"),
}
SEG_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_segmented_reference_matches_jax_split_kernels(jx, case):
    """The plain version with segment ids against the JAX forward and
    split backward kernels in interpret mode (32-blocks, so tiles are
    skipped, masked and uniform), GQA, RoPE and dropout with the same seed
    bits. atol=rtol=1e-5: f32 softmax sums over at most 64 positions in
    another order."""
    jax, jnp = jx.jax, jx.jnp
    h, kvh, rope, rate, layout = SEG_CASES[case]
    q, k, v, do, _ = _inputs(h, kvh, seed=3)
    seg = np.asarray(SEG_LAYOUTS[layout], np.int32)
    s, d = q.shape[1], q.shape[3]
    cos, sin = rope_tables(s, d)
    rng = jax.random.PRNGKey(9) if rate else None
    seed = int(jax.random.bits(rng, dtype=jnp.uint32)) if rate else None

    def jfn(q_, k_, v_):
        return jx.flash.flash_attention(
            q_, k_, v_, block_q=32, block_k=32, interpret=True,
            dropout_rate=rate, dropout_rng=rng, backward="split",
            rope=(jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
            if rope else None, segment_ids=jnp.asarray(seg))

    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = tflash.flash_attention(
        tq, tk, tv, dropout_rate=rate, seed=seed,
        rope=(cos, sin) if rope else None, segment_ids=torch.from_numpy(seg),
        backward="split")
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **SEG_TOL)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **SEG_TOL)


def test_backward_choice():
    """Segment ids take the split backward; "fused" with them raises, as
    in the JAX package (on any device); unsegmented calls take the fused
    backward up to _FUSED_BWD_MAX_SEQ."""
    top = tflash._FUSED_BWD_MAX_SEQ
    assert tflash.backward_impl(top, False) == "fused"
    assert tflash.backward_impl(top + 1, False) == "split"
    assert tflash.backward_impl(64, False, "split") == "split"
    assert tflash.backward_impl(64, True) == "split"
    with pytest.raises(NotImplementedError, match="split backward"):
        tflash.backward_impl(64, True, "fused")
    with pytest.raises(ValueError, match="backward"):
        tflash.backward_impl(64, False, "auto-ish")
    q, k, v, _, seg = (torch.from_numpy(x) for x in _inputs(4, 2))
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tflash.flash_attention(q, k, v, segment_ids=seg, backward="fused")


def test_cpu_dispatch_is_the_plain_version():
    q, k, v, _, seg = _inputs(4, 2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    rope = rope_tables(q.shape[1], q.shape[3])
    counters = (tflash.flash_forward, tflash.flash_backward,
                tflash.flash_backward_dkv, tflash.flash_backward_dq)
    before = [c.launches for c in counters]
    for kw in ({}, {"dropout_rate": 0.2, "seed": 3, "rope": rope},
               {"segment_ids": torch.from_numpy(seg)}):
        got = tflash.flash_attention(tq, tk, tv, **kw)
        want = tflash.flash_attention_reference(tq, tk, tv, **kw)
        assert torch.equal(got, want)
    assert [c.launches for c in counters] == before


def test_lse_and_residuals_of_the_plain_version():
    """lse is the f32 logsumexp of the scaled scores; the residuals are
    the RoPE'd q times 1/sqrt(d) and the RoPE'd k."""
    q, k, v, _, _ = _inputs(4, 4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    cos, sin = rope_tables(q.shape[1], q.shape[3])
    o, lse, qs, ks = tflash._reference_parts(
        tq, tk, tv, causal=True, dropout_rate=0.0, seed=None,
        rope=(cos, sin), segment_ids=None)
    from tpu_trainer_torch.ops.rope import apply_rotary_pos_emb

    qr, kr = apply_rotary_pos_emb(tq, tk, cos, sin)
    torch.testing.assert_close(qs, qr * 0.25, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ks, kr, atol=1e-6, rtol=1e-6)
    sc = torch.einsum("bqhd,bkhd->bhqk", qs, ks)
    sc = sc.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(),
                        float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(sc, -1), **TOL)
    assert o.shape == tq.shape


@pytest.mark.parametrize("bad", ["rank", "kv_heads", "no_seed", "segments"])
def test_rejects_bad_operands(bad):
    q, k, v, _, seg = (torch.from_numpy(x) for x in _inputs(4, 2))
    kw = {}
    if bad == "rank":
        q = q[0]
    elif bad == "kv_heads":
        k, v = k[:, :, :1].repeat(1, 1, 3, 1), v[:, :, :1].repeat(1, 1, 3, 1)
    elif bad == "no_seed":
        kw["dropout_rate"] = 0.1
    elif bad == "segments":
        kw["segment_ids"] = seg[:, :10]
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("fn", ["flash_backward", "flash_backward_dkv",
                                "flash_backward_dq"])
def test_backward_wrappers_refuse_cpu_tensors(fn):
    """The backward kernels' wrappers launch or raise: a CPU tensor is
    refused, not sent to the plain version."""
    q, k, v, do, seg = (torch.from_numpy(x) for x in _inputs(4, 4, d=64))
    lse = torch.zeros((2, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "flash_backward":
            tflash.flash_backward(q, k, v, q, lse, do)
        elif fn == "flash_backward_dkv":
            tflash.flash_backward_dkv(q, k, v, q, lse, do, segment_ids=seg)
        else:
            tflash.flash_backward_dq(q, k, v, do, lse, lse)


@pytest.mark.parametrize("dtype,kvh,direct", [
    ("bfloat16", 4, True), ("float16", 4, True), ("bfloat16", 2, False),
    ("float32", 4, False)])
def test_dkv_outputs_direct_only_at_group_one(dtype, kvh, direct):
    """The backward kernels write dk/dv in a 16-bit compute type at GQA
    group 1; otherwise into f32 per-query-head partials [b, s, h, d] that
    are group-summed after the kernel."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(dt) for x in _inputs(4, kvh)[:3])
    dk, dv, got = tflash._dkv_outputs(q, k, v)
    assert got is direct
    want = (k.shape, dt) if direct else (q.shape, torch.float32)
    for t in (dk, dv):
        assert (t.shape, t.dtype) == want


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_CASES = [
    # (b, s, h, kvh, d, dtype, rope, rate, causal)
    (2, 128, 4, 4, 64, "float32", True, 0.0, True),
    (2, 128, 4, 4, 64, "bfloat16", True, 0.1, True),
    (1, 100, 4, 2, 128, "bfloat16", True, 0.0, True),
    (2, 77, 4, 1, 64, "float16", False, 0.2, True),
    (1, 200, 2, 2, 128, "float32", False, 0.1, True),
    # The 16-bit forward's 128-row q tile: s one past a tile, a ragged
    # last tile, and d = 128 with GQA under dropout.
    (1, 129, 4, 4, 64, "bfloat16", True, 0.1, True),
    (1, 1000, 4, 2, 64, "bfloat16", True, 0.1, True),
    (1, 300, 8, 2, 128, "bfloat16", True, 0.1, True),
    # The 16-bit fused backward (128-key tiles, 64-row q tiles): a
    # non-causal call; s = 1000 under dropout with a ragged k tile and dk/dv
    # written in the compute type; a GQA group of 4 at d = 128 under
    # dropout on the f32-partials path; fp16 without GQA.
    (2, 256, 4, 4, 64, "bfloat16", True, 0.1, False),
    (1, 1000, 4, 4, 64, "bfloat16", True, 0.1, True),
    (1, 640, 8, 2, 128, "bfloat16", True, 0.1, True),
    (2, 200, 4, 4, 64, "float16", True, 0.1, True),
]
# f32 kernel vs plain on the same inputs: reduction order only. bf16/fp16:
# the kernels and the plain version both round (p, the products' operands,
# the outputs), each in its own places, so neither is the truth; both are
# held against the plain version run in f32 on the same values, and the
# kernel's worst-element and L2 errors must stay within NEAR_FACTOR times
# the plain version's plus NEAR_FLOOR times the truth's rms (half the unit
# roundoff of the result's type, 2**-8 for bf16 and 2**-11 for fp16; f32
# results such as lse come from f32 sums on both sides and get 2**-15).
F32_TOL = 1e-4
NEAR_FACTOR = 2.0
NEAR_FLOOR = {torch.bfloat16: 2.0**-9, torch.float16: 2.0**-12,
              torch.float32: 2.0**-15}


def _assert_near_truth(what, got, plain, truth):
    floor = NEAR_FLOOR[got.dtype]
    got, plain, truth = (t.detach().double() for t in (got, plain, truth))
    assert torch.isfinite(got).all(), what
    rms = float(truth.pow(2).mean().sqrt())
    for norm, n in ((lambda t: float(t.abs().max()), 1.0),
                    (lambda t: float(t.norm()), truth.numel() ** 0.5)):
        k, p = norm(got - truth), norm(plain - truth)
        assert k <= NEAR_FACTOR * p + floor * rms * n, (what, k, p, rms)


def _plain_parts(xs, do, kw, causal=True):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    o, lse, qs, ks = tflash._reference_parts(*xs, causal=causal,
                                             segment_ids=None, **kw)
    o.backward(do)
    return [o, lse] + [x.grad for x in xs], (qs, ks)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kvh,d,dtype,rope,rate,causal", GPU_CASES)
def test_kernels_match_plain_on_card(cuda_device, b, s, h, kvh, d, dtype,
                                     rope, rate, causal):
    dev = cuda_device
    dt = getattr(torch, dtype)
    q, k, v, do, _ = _inputs(h, kvh, b=b, s=s, d=d, seed=s)
    tq, tk, tv = (torch.from_numpy(x).to(dev, dt).requires_grad_(True)
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(dev, dt)
    tabs = rope_tables(s, d, device=dev) if rope else None
    kw = dict(dropout_rate=rate, seed=1234 if rate else None, rope=tabs)
    before = (tflash.flash_forward.launches, tflash.flash_backward.launches)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, **kw)
    got.backward(tdo)
    torch.cuda.synchronize()
    assert (tflash.flash_forward.launches,
            tflash.flash_backward.launches) == (before[0] + 1, before[1] + 1)
    _, lse, qs, ks = tflash.flash_forward(tq.detach(), tk.detach(),
                                          tv.detach(), causal=causal, **kw)
    kernel = [got, lse, tq.grad, tk.grad, tv.grad]
    plain, (rqs, rks) = _plain_parts((tq, tk, tv), tdo, kw, causal=causal)
    torch.testing.assert_close(qs, rqs, atol=0, rtol=0)
    torch.testing.assert_close(ks, rks, atol=0, rtol=0)
    names = ("o", "lse", "dq", "dk", "dv")
    if dt == torch.float32:
        for n, a, r in zip(names, kernel, plain):
            torch.testing.assert_close(a, r, atol=F32_TOL, rtol=F32_TOL,
                                       msg=n)
        return
    truth, _ = _plain_parts([t.float() for t in (tq, tk, tv)], tdo.float(),
                            kw, causal=causal)
    for n, a, r, t in zip(names, kernel, plain, truth):
        _assert_near_truth(n, a, r, t)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,seed", [(True, 1234), (True, 99),
                                         (False, 1234)])
def test_forward_dropout_seeds_on_card(cuda_device, causal, seed):
    """The 16-bit forward, causal and not, with dropout at two seeds (a
    wrong element-to-(row, col) map in the kernel moves the masks),
    through the backward too."""
    dev, dt = cuda_device, torch.bfloat16
    q, k, v, do, _ = _inputs(4, 2, b=2, s=200, d=64, seed=seed)
    tq, tk, tv = (torch.from_numpy(x).to(dev, dt).requires_grad_(True)
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(dev, dt)
    kw = dict(dropout_rate=0.1, seed=seed, rope=rope_tables(200, 64,
                                                            device=dev))
    got = tflash.flash_attention(tq, tk, tv, causal=causal, **kw)
    got.backward(tdo)
    _, lse, _, _ = tflash.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                        causal=causal, **kw)
    torch.cuda.synchronize()
    kernel = [got, lse, tq.grad, tk.grad, tv.grad]
    plain, _ = _plain_parts((tq, tk, tv), tdo, kw, causal=causal)
    truth, _ = _plain_parts([t.float() for t in (tq, tk, tv)], tdo.float(),
                            kw, causal=causal)
    for n, a, r, t in zip(("o", "lse", "dq", "dk", "dv"), kernel, plain,
                          truth):
        _assert_near_truth(n, a, r, t)


@pytest.mark.gpu
@pytest.mark.parametrize("bq,bk,k_major", [(128, 128, False), (64, 256, True),
                                           (256, 64, False)])
def test_keep_mask_kernel_bitwise(cuda_device, bq, bk, k_major):
    got = tflash.keep_mask_cuda(0xFEEDBEEF, 5, 1000, 0.25, block_q=bq,
                                block_k=bk, k_major=k_major)
    want = tflash._keep_mask(0xFEEDBEEF, 5, 0, 0, 1000, 1000, 1000, 0.25)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    """Segment ids run on CUDA and match the plain version; "fused" with
    them raises; the kernels refuse what they cannot take."""
    q, k, v, _, seg = (torch.from_numpy(x).to(cuda_device)
                       for x in _inputs(4, 2, d=16))
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_attention(q, k, v)
    q, k, v, _, seg = (torch.from_numpy(x).to(cuda_device)
                       for x in _inputs(4, 2, d=64))
    before = tflash.flash_backward_dq.launches
    got = tflash.flash_attention(q, k, v, segment_ids=seg)
    torch.testing.assert_close(got, tflash.flash_attention_reference(
        q, k, v, segment_ids=seg), atol=F32_TOL, rtol=F32_TOL)
    assert tflash.flash_backward_dq.launches == before
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tflash.flash_attention(q, k, v, segment_ids=seg, backward="fused")
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)


def _mixed_docs(s):
    """[2, s] ids: row 0 documents of 1 to 40 tokens (many inside one
    tile), row 1 documents of 300 to 600 (each across tiles); both end in a
    padding tail (id 0) that makes s ragged against every tile."""
    rs = np.random.RandomState(s)
    rows = []
    for lo, hi in ((1, 41), (300, 601)):
        ids, pos, doc = [], 0, 1
        while pos < s - 37:
            n = min(int(rs.randint(lo, hi)), s - 37 - pos)
            ids += [doc] * n
            pos, doc = pos + n, doc + 1
        rows.append(ids + [0] * (s - pos))
    return rows


def _seg_ids(layout, s, device):
    """The int32 [2, s] ids of a named layout (None: no segments)."""
    if layout is None:
        return None
    ids = _mixed_docs(s) if layout == "mixed_docs" else SEG_LAYOUTS[layout]
    return torch.tensor(ids, dtype=torch.int32, device=device)


SEG_GPU_CASES = [
    # (b, s, h, kvh, d, dtype, layout, rate, backward, causal)
    (2, 64, 4, 4, 64, "float32", "packed", 0.0, None, True),
    (2, 64, 4, 2, 64, "bfloat16", "short_docs", 0.1, None, True),
    (2, 64, 4, 4, 128, "bfloat16", "across_blocks", 0.0, None, True),
    (2, 300, 4, 4, 64, "bfloat16", None, 0.1, "split", True),
    (1, 200, 2, 2, 128, "float32", None, 0.1, "split", True),
    # The 16-bit dq kernel's 128-row q tiles: a ragged s = 1000 with
    # documents inside one tile and across several, and a non-causal call
    # (every k tile reaches every q tile).
    (2, 1000, 4, 4, 64, "bfloat16", "mixed_docs", 0.1, None, True),
    (2, 300, 4, 2, 128, "bfloat16", None, 0.1, "split", False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kvh,d,dtype,layout,rate,backward,causal",
                         SEG_GPU_CASES)
def test_split_kernels_match_plain_on_card(cuda_device, b, s, h, kvh, d,
                                           dtype, layout, rate, backward,
                                           causal):
    """The segmented forward and the split backward (dk/dv and dq kernels)
    against the plain version, held as test_kernels_match_plain_on_card
    holds the fused pair."""
    dev = cuda_device
    dt = getattr(torch, dtype)
    q, k, v, do, _ = _inputs(h, kvh, b=b, s=s, d=d, seed=s + 1)
    seg = _seg_ids(layout, s, dev)
    tq, tk, tv = (torch.from_numpy(x).to(dev, dt).requires_grad_(True)
                  for x in (q, k, v))
    tdo = torch.from_numpy(do).to(dev, dt)
    kw = dict(dropout_rate=rate, seed=99 if rate else None,
              rope=rope_tables(s, d, device=dev))
    counters = (tflash.flash_backward, tflash.flash_backward_dkv,
                tflash.flash_backward_dq)
    before = [c.launches for c in counters]
    got = tflash.flash_attention(tq, tk, tv, causal=causal, segment_ids=seg,
                                 backward=backward, **kw)
    got.backward(tdo)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [0, 1, 1]
    _, lse, _, _ = tflash.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                        causal=causal, segment_ids=seg, **kw)
    kernel = [got, lse, tq.grad, tk.grad, tv.grad]

    def plain(xs, grad_out):
        xs = [x.detach().clone().requires_grad_(True) for x in xs]
        o, lse_, _, _ = tflash._reference_parts(*xs, causal=causal,
                                                segment_ids=seg, **kw)
        o.backward(grad_out)
        return [o, lse_] + [x.grad for x in xs]

    names = ("o", "lse", "dq", "dk", "dv")
    ref = plain((tq, tk, tv), tdo)
    if dt == torch.float32:
        for n, a, r in zip(names, kernel, ref):
            torch.testing.assert_close(a, r, atol=F32_TOL, rtol=F32_TOL,
                                       msg=n)
        return
    truth = plain([t.float() for t in (tq, tk, tv)], tdo.float())
    for n, a, r, t in zip(names, kernel, ref, truth):
        _assert_near_truth(n, a, r, t)


DET_CASES = [
    # (b, s, h, kvh, d, dtype, rate, causal): the fused backward's dq parts
    # summed in a fixed order: ragged s, GQA at d = 128, a non-causal call
    # (every key tile reaches every q tile), the f32 checking path.
    (2, 1000, 4, 4, 64, "bfloat16", 0.1, True),
    (1, 640, 8, 2, 128, "bfloat16", 0.1, True),
    (2, 256, 4, 4, 64, "bfloat16", 0.0, False),
    (2, 300, 4, 4, 64, "float32", 0.1, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kvh,d,dtype,rate,causal", DET_CASES)
def test_fused_backward_bitwise_twice_on_card(cuda_device, b, s, h, kvh, d,
                                              dtype, rate, causal):
    """The fused backward twice on the same inputs: dq, dk and dv bitwise
    equal."""
    dev, dt = cuda_device, getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(dev, dt)
                   for x in _inputs(h, kvh, b=b, s=s, d=d, seed=s)[:4])
    kw = dict(dropout_rate=rate, seed=77 if rate else None,
              rope=rope_tables(s, d, device=dev))
    o, lse, qs, ks = tflash.flash_forward(q, k, v, causal=causal, **kw)
    first = tflash.flash_backward(qs, ks, v, o, lse, do, causal=causal, **kw)
    first = [t.clone() for t in first]
    second = tflash.flash_backward(qs, ks, v, o, lse, do, causal=causal, **kw)
    torch.cuda.synchronize()
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), name


@pytest.mark.gpu
@pytest.mark.parametrize("h,kvh,d,dtype,layout", [
    (4, 4, 64, "bfloat16", "packed"),
    (4, 2, 128, "bfloat16", "short_docs"),
    (4, 4, 128, "float16", "across_blocks"),
    (4, 4, 64, "float32", "packed"),
])
def test_split_dkv_bitwise_twice_on_card(cuda_device, monkeypatch, h, kvh,
                                         d, dtype, layout):
    """The split dk/dv kernel twice on the same inputs: dk, dv and delta
    bitwise equal; at group 1 in a 16-bit type the kernel writes dk/dv in
    that type itself (no f32 partials group-summed after it)."""
    dev, dt = cuda_device, getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(dev, dt)
                   for x in _inputs(h, kvh, d=d, seed=8)[:4])
    seg = torch.tensor(SEG_LAYOUTS[layout], dtype=torch.int32, device=dev)
    kw = dict(dropout_rate=0.1, seed=5, rope=rope_tables(64, d, device=dev),
              segment_ids=seg)
    o, lse, qs, ks = tflash.flash_forward(q, k, v, **kw)
    if h == kvh and dt != torch.float32:
        def no_group_sum(*_):
            raise AssertionError("group-summed at group 1")
        monkeypatch.setattr(tflash, "_group_sum", no_group_sum)
    first = [t.clone() for t in tflash.flash_backward_dkv(
        qs, ks, v, o, lse, do, **kw)]
    second = tflash.flash_backward_dkv(qs, ks, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert first[0].dtype == first[1].dtype == dt
    assert tuple(first[2].shape) == (2, h, 64)
    for name, a, c in zip(("dk", "dv", "delta"), first, second):
        assert torch.equal(a, c), name


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kvh,d,dtype,layout", [
    (8, 1024, 4, 4, 64, "bfloat16", "packed_rows"),
    (2, 64, 4, 2, 128, "bfloat16", "short_docs"),
    (2, 64, 4, 4, 128, "float16", "across_blocks"),
    (2, 64, 4, 4, 64, "float32", "packed"),
])
def test_split_dq_bitwise_twice_on_card(cuda_device, b, s, h, kvh, d, dtype,
                                        layout):
    """The split dq kernel twice on the same inputs under dropout: dq
    bitwise equal (each block owns its q tile and sums its k tiles in
    order). "packed_rows": rows of the port's packer at the packed path's
    b and s."""
    dev, dt = cuda_device, getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x).to(dev, dt)
                   for x in _inputs(h, kvh, b=b, s=s, d=d, seed=9)[:4])
    if layout == "packed_rows":
        from tpu_trainer_torch.data.packing import packed_synthetic_loader
        rows = next(iter(packed_synthetic_loader(b, s, 50257, 1, 17)))
        seg = torch.as_tensor(rows[..., 1], dtype=torch.int32, device=dev)
    else:
        seg = _seg_ids(layout, s, dev)
    kw = dict(dropout_rate=0.1, seed=5, rope=rope_tables(s, d, device=dev),
              segment_ids=seg)
    o, lse, qs, ks = tflash.flash_forward(q, k, v, **kw)
    _, _, delta = tflash.flash_backward_dkv(qs, ks, v, o, lse, do, **kw)
    first = tflash.flash_backward_dq(qs, ks, v, do, lse, delta, **kw).clone()
    second = tflash.flash_backward_dq(qs, ks, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert first.dtype == dt
    assert torch.equal(first, second)
