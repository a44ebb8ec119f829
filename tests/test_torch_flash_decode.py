"""Port parity: paged flash-decode and int8 KV quantization.

The port's plain ``paged_attention_reference`` (and ``flash_decode``, which
runs it for CPU tensors) against the JAX ``paged_attention_reference`` and
the JAX Pallas kernel in interpret mode, on the fixture of
tests/test_serving.py. Inputs are numpy arrays from a seed, f32.
Tolerance atol=1e-5: both sides are f32 softmax-weighted sums over at most
24 unit-scale positions, whose reduction orders differ between frameworks
by a few ulp of values of order 1.

The JAX side comes in through the ``jx`` fixture, not a top-level import:
the card's machine has no JAX, and there the ``gpu`` tests at the end run
alone (``pytest --noconftest -m gpu tests/test_torch_flash_decode.py``)
while the parity tests skip.
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.ops import flash as tflash
from tpu_trainer_torch.utils import quant as tquant

ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's flash and quant modules, and ``jax.numpy``."""
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax.numpy as jnp

    from tpu_trainer.ops import flash
    from tpu_trainer.utils import quant
    return types.SimpleNamespace(jnp=jnp, flash=flash, quant=quant)


def _paged_fixture(b=3, h=4, kvh=2, d=16, bsz=8, mb=3, nblk=12,
                   lengths=(1, 10, 24), seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b, h, d)).astype(np.float32)
    pool_k = rs.standard_normal((nblk, bsz, kvh, d)).astype(np.float32)
    pool_v = rs.standard_normal((nblk, bsz, kvh, d)).astype(np.float32)
    tables = rs.permutation(np.arange(1, nblk))[: b * mb]
    tables = tables.reshape(b, mb).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    return q, pool_k, pool_v, tables, lengths


CASES = {
    # name: (fixture kwargs, n_splits, int8)
    "gqa_fp": ({}, 0, False),
    "mha_fp": ({"h": 4, "kvh": 4}, 0, False),
    "odd_splits_len1": ({"lengths": (1, 17, 24)}, 3, False),
    "one_split": ({}, 1, False),
    "gqa_int8": ({}, 0, True),
    "mha_int8_d32": ({"h": 2, "kvh": 2, "d": 32}, 3, True),
    # Lengths at and one past page boundaries; block sizes 16 and 32.
    "page_edges": ({"bsz": 16, "lengths": (16, 17, 32)}, 0, False),
    "page_edges_int8": ({"bsz": 16, "lengths": (16, 17, 32)}, 0, True),
    "block32": ({"bsz": 32, "lengths": (1, 40, 96)}, 0, False),
    # One split over a 64-page row.
    "one_split_64_pages": ({"mb": 64, "nblk": 200,
                            "lengths": (1, 300, 512)}, 1, False),
    # GQA groups of 4 and 8 at head_dim 128.
    "gqa4_d128": ({"h": 8, "kvh": 2, "d": 128}, 0, False),
    "gqa4_d128_int8": ({"h": 8, "kvh": 2, "d": 128}, 0, True),
    "gqa8_d128": ({"h": 16, "kvh": 2, "d": 128}, 0, False),
    "gqa8_d128_int8": ({"h": 16, "kvh": 2, "d": 128}, 0, True),
}


def _operands(jx, kw, int8):
    q, pk, pv, tb, ln = _paged_fixture(**kw)
    if not int8:
        return (q, pk, pv, tb, ln), {}, {}
    jk, jsk = jx.quant.quantize_kv_int8(jx.jnp.asarray(pk))
    jv, jsv = jx.quant.quantize_kv_int8(jx.jnp.asarray(pv))
    jax_ops = (q, jk, jv, tb, ln)
    return jax_ops, {"k_scale": jsk, "v_scale": jsv}, {
        "k_scale": torch.from_numpy(np.array(jsk)),
        "v_scale": torch.from_numpy(np.array(jsv))}


def _torch(ops):
    return [torch.from_numpy(np.array(x)) for x in ops]


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax_reference_and_kernel(jx, case):
    kw, n_splits, int8 = CASES[case]
    ops, jscales, tscales = _operands(jx, kw, int8)
    want_ref = np.asarray(jx.flash.paged_attention_reference(*ops, **jscales))
    want_kernel = np.asarray(jx.flash.flash_decode(
        *ops, **jscales, n_splits=n_splits, interpret=True))
    got = tflash.paged_attention_reference(*_torch(ops), **tscales).numpy()
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    # flash_decode on CPU tensors is the plain version, bit for bit, and
    # never counts a kernel launch.
    before = tflash.flash_decode.launches
    via = tflash.flash_decode(*_torch(ops), **tscales, n_splits=n_splits)
    assert torch.equal(via, torch.from_numpy(got))
    assert tflash.flash_decode.launches == before


@pytest.mark.parametrize("shape", [(5, 8, 2, 64), (3, 4, 1, 16), (7, 96)])
def test_quantize_kv_int8_bitwise(jx, shape):
    rs = np.random.RandomState(sum(shape))
    x = (rs.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[:3] = 0.0                      # an all-zero-ish block edge
    jq, js = jx.quant.quantize_kv_int8(jx.jnp.asarray(x))
    tq, ts = tquant.quantize_kv_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jx.quant.dequantize_kv_int8(jq, js, jx.jnp.float32)
    td = tquant.dequantize_kv_int8(tq, ts, torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("d", [16, 24, 32, 64, 96, 128, 512])
def test_quant_block_len_matches(jx, d):
    assert tquant.quant_block_len(d) == jx.quant.quant_block_len(d)


@pytest.mark.parametrize("mb", [1, 2, 3, 4, 5, 6, 8, 9, 64])
def test_auto_splits_matches(jx, mb):
    assert tflash._auto_splits(mb) == jx.flash._auto_splits(mb)


@pytest.mark.parametrize("bad", ["q_rank", "dtype", "tables_dtype",
                                 "missing_scale", "splits"])
def test_wrapper_rejects_bad_operands(bad):
    q, pk, pv, tb, ln = _torch(_paged_fixture())
    kw = {}
    if bad == "q_rank":
        q = q[:, None]
    elif bad == "dtype":
        pk, pv = pk.double(), pv.double()
    elif bad == "tables_dtype":
        tb = tb.long()
    elif bad == "missing_scale":
        pk, pv = pk.to(torch.int8), pv.to(torch.int8)
    elif bad == "splits":
        kw["n_splits"] = 2                       # mb = 3
    with pytest.raises(ValueError):
        tflash.flash_decode(q, pk, pv, tb, ln, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# int8 pools are quantized from f32 values, so they take one pool dtype.
GPU_CASES = [(c, dt) for c in sorted(CASES)
             for dt in (("int8",) if CASES[c][2] else ("float32", "bfloat16"))]


@pytest.mark.gpu
@pytest.mark.parametrize("case,pool_dtype", GPU_CASES)
@pytest.mark.parametrize("d", [64, 128])
def test_kernel_matches_plain_on_card(cuda_device, case, pool_dtype, d):
    kw, n_splits, int8 = CASES[case]
    kw = dict(kw, d=d)
    q, pk, pv, tb, ln = _paged_fixture(**kw)
    tb[0] = 0                                    # a null-block row (length 1)
    dev = cuda_device
    args = [torch.from_numpy(x).to(dev) for x in (q, pk, pv, tb, ln)]
    scales = {}
    if int8:
        args[1], sk = tquant.quantize_kv_int8(args[1])
        args[2], sv = tquant.quantize_kv_int8(args[2])
        scales = {"k_scale": sk, "v_scale": sv}
    else:
        dt = getattr(torch, pool_dtype)
        args[1], args[2] = args[1].to(dt), args[2].to(dt)
    before = tflash.flash_decode.launches
    got = tflash.flash_decode(*args, **scales, n_splits=n_splits)
    torch.cuda.synchronize()
    assert tflash.flash_decode.launches == before + 1
    want = tflash.paged_attention_reference(*args, **scales)
    # Both read the same pool values in f32; an online softmax over splits
    # against a one-shot softmax differs by ~1e-6 relative.
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q, pk, pv, tb, ln = (torch.from_numpy(x).to(cuda_device)
                         for x in _paged_fixture(d=16, h=4, kvh=2))
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_decode(q[..., :12].contiguous(), pk[..., :12].contiguous(),
                            pv[..., :12].contiguous(), tb, ln)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_decode(q, pk.transpose(0, 1), pv.transpose(0, 1), tb, ln)


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("base,n", [(0, 1), (1, 1), (3, 1), (2, 2)])
def test_kernel_kv_head_window_on_card(cuda_device, pool_dtype, base, n):
    """``kv_head_base`` / ``kv_heads``: the kernel reads kv heads ``base ..
    base + n - 1`` of a 4-head pool in place (the pool's row stride),
    against the plain version on the same window; and the sharded
    dispatch over replicated pools (tp 4, 2 kv heads: shard i reads kv
    head i // 2) equals one call, bitwise."""
    q, pk, pv, tb, ln = _paged_fixture(h=4, kvh=4, d=64)
    tb[0] = 0
    args = [torch.from_numpy(x).to(cuda_device) for x in (q, pk, pv, tb, ln)]
    scales = {}
    if pool_dtype == "int8":
        args[1], sk = tquant.quantize_kv_int8(args[1])
        args[2], sv = tquant.quantize_kv_int8(args[2])
        scales = {"k_scale": sk, "v_scale": sv}
    else:
        dt = getattr(torch, pool_dtype)
        args[1], args[2] = args[1].to(dt), args[2].to(dt)
    window = dict(kv_head_base=base, kv_heads=n)
    got = tflash.flash_decode(*args, **scales, **window)
    want = tflash.paged_attention_reference(*args, **scales, **window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    pk2, pv2 = args[1][:, :, :2].contiguous(), args[2][:, :, :2].contiguous()
    sc2 = {k: v[:, :, :2].contiguous() for k, v in scales.items()}
    one = tflash.flash_decode(args[0], pk2, pv2, *args[3:], **sc2)
    before = tflash.flash_decode.launches
    sharded = tflash.paged_attention_sharded(
        args[0], [pk2] * 4, [pv2] * 4, *args[3:], kv_heads=2,
        k_scales=[sc2["k_scale"]] * 4 if sc2 else None,
        v_scales=[sc2["v_scale"]] * 4 if sc2 else None)
    assert tflash.flash_decode.launches == before + 4
    assert torch.equal(sharded, one)
