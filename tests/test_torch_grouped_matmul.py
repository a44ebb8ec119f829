"""Port parity: the grouped matmuls of the dropless MoE.

- ``gmm_reference`` / ``tgmm_reference`` (what ``gmm`` / ``tgmm`` run on
  CPU tensors) against the JAX package's Pallas kernels in interpret mode
  (``gmm``/``tgmm(..., use_kernel=True, interpret=True)``), with empty
  groups, a group straddling 8-row tiles, ``G % tile != 0`` and
  ``sum(group_sizes) < G``; ``gmm``'s autograd (d(lhs) through ``gmm``
  against ``rhs^T``, d(rhs) through ``tgmm``) against ``jax.vjp`` of the
  JAX ``gmm``. f32 inputs from a numpy seed; tolerance atol=rtol=1e-5
  (f32 sums of at most 16 products in another order).
- The CPU dispatch never launches a kernel, and the kernel wrappers refuse
  CPU tensors.
- ``gpu``-marked: ``gmm_cuda``/``tgmm_cuda`` against the plain versions on
  the card (skipped without one).

The JAX side comes in through the ``jx`` fixture, so the ``gpu`` tests run
where JAX is not installed (``pytest --noconftest -m gpu``).
"""

import types

import numpy as np
import pytest
import torch

from tpu_trainer_torch.ops import grouped_matmul as tgm

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    # name: (G, H, N, group sizes); tile 8 in the JAX kernel below.
    "empty_groups": (40, 16, 24, [0, 13, 0, 20, 7]),
    "straddle": (29, 16, 8, [3, 17, 9]),
    "sum_below_G": (37, 8, 16, [5, 0, 11, 6]),
    "one_group": (21, 16, 16, [0, 21, 0]),
    "above_90pct": (40, 16, 8, [37, 0, 2, 1]),
    "runs_of_empty": (24, 8, 16, [0, 0, 11, 0, 13, 0]),
    "ragged_G_full": (30, 8, 8, [10, 10, 10]),
}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax", reason="the JAX reference is not installed")
    import jax
    import jax.numpy as jnp

    from tpu_trainer.ops import grouped_matmul
    return types.SimpleNamespace(jax=jax, jnp=jnp, gm=grouped_matmul)


def _inputs(G, H, N, sizes, seed=0):
    rs = np.random.RandomState(seed)
    lhs = rs.standard_normal((G, H)).astype(np.float32)
    rhs = rs.standard_normal((len(sizes), H, N)).astype(np.float32)
    dout = rs.standard_normal((G, N)).astype(np.float32)
    return lhs, rhs, dout, np.asarray(sizes, np.int32)


def _kernel_kw():
    return dict(use_kernel=True, interpret=True, tile_tokens=8, tile_cols=8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_and_tgmm_match_jax_interpret_kernels(jx, case):
    jnp = jx.jnp
    lhs, rhs, dout, sizes = _inputs(*CASES[case])
    want = np.asarray(jx.gm.gmm(jnp.asarray(lhs), jnp.asarray(rhs),
                                jnp.asarray(sizes), **_kernel_kw()))
    want_t = np.asarray(jx.gm.tgmm(jnp.asarray(lhs), jnp.asarray(dout),
                                   jnp.asarray(sizes), **_kernel_kw()))
    ts = torch.from_numpy(sizes)
    got = tgm.gmm(torch.from_numpy(lhs), torch.from_numpy(rhs), ts)
    got_t = tgm.tgmm(torch.from_numpy(lhs), torch.from_numpy(dout), ts)
    assert got.dtype == torch.float32 and got_t.dtype == torch.float32
    # Rows past the sum: zero here; the interpret kernel never visits a
    # whole tile past the sum and leaves its rows unwritten (NaN).
    rows = int(sizes.sum())
    np.testing.assert_allclose(got.numpy()[:rows], want[:rows], **TOL)
    np.testing.assert_allclose(got_t.numpy(), want_t, **TOL)
    assert not got[rows:].any()
    for e in np.flatnonzero(sizes == 0):
        assert not got_t[e].any()          # empty groups' blocks are zero


@pytest.mark.parametrize("case", sorted(CASES))
def test_gmm_autograd_matches_jax_vjp(jx, case):
    jax, jnp = jx.jax, jx.jnp
    lhs, rhs, dout, sizes = _inputs(*CASES[case], seed=1)
    out, vjp = jax.vjp(
        lambda a, b: jx.gm.gmm(a, b, jnp.asarray(sizes), **_kernel_kw()),
        jnp.asarray(lhs), jnp.asarray(rhs))
    want_dl, want_dr = vjp(jnp.asarray(dout))
    tl, tr = (torch.from_numpy(x).requires_grad_(True) for x in (lhs, rhs))
    got = tgm.gmm(tl, tr, torch.from_numpy(sizes))
    got.backward(torch.from_numpy(dout))
    rows = int(sizes.sum())
    np.testing.assert_allclose(got.detach().numpy()[:rows],
                               np.asarray(out)[:rows], **TOL)
    np.testing.assert_allclose(tl.grad.numpy()[:rows],
                               np.asarray(want_dl)[:rows], **TOL)
    assert not tl.grad[rows:].any()
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(want_dr), **TOL)


def test_reference_dtypes_and_transpose():
    """gmm returns lhs's dtype from f32 sums; transpose_rhs reads rhs as
    [E, N, K]; tgmm returns f32."""
    lhs, rhs, dout, sizes = _inputs(*CASES["empty_groups"])
    ts = torch.from_numpy(sizes)
    bl = torch.from_numpy(lhs).bfloat16()
    out = tgm.gmm_reference(bl, torch.from_numpy(rhs).bfloat16(), ts)
    assert out.dtype == torch.bfloat16
    want = tgm.gmm_reference(bl.float(), torch.from_numpy(rhs).bfloat16()
                             .float(), ts).bfloat16()
    assert torch.equal(out, want)
    back = tgm.gmm_reference(torch.from_numpy(dout), torch.from_numpy(rhs),
                             ts, transpose_rhs=True)
    torch.testing.assert_close(back, tgm.gmm_reference(
        torch.from_numpy(dout), torch.from_numpy(rhs).transpose(1, 2)
        .contiguous(), ts))
    assert tgm.tgmm(bl, torch.from_numpy(dout).bfloat16(),
                    ts).dtype == torch.float32
    assert torch.equal(tgm.group_offsets(ts),
                       torch.tensor([0, 0, 13, 13, 33, 40], dtype=torch.int32))


def test_cpu_dispatch_launches_nothing():
    lhs, rhs, dout, sizes = _inputs(*CASES["straddle"])
    before = (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches)
    tl = torch.from_numpy(lhs).requires_grad_(True)
    tgm.gmm(tl, torch.from_numpy(rhs), torch.from_numpy(sizes)).sum().backward()
    tgm.tgmm(tl.detach(), torch.from_numpy(dout), torch.from_numpy(sizes))
    assert (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches) == before


@pytest.mark.parametrize("bad", ["rank", "hidden", "sizes"])
def test_gmm_rejects_bad_operands(bad):
    lhs, rhs, _, sizes = (torch.from_numpy(x) for x in
                          _inputs(*CASES["straddle"]))
    if bad == "rank":
        lhs = lhs[None]
    elif bad == "hidden":
        rhs = rhs[:, :8]
    else:
        sizes = sizes[:2]
    with pytest.raises(ValueError):
        tgm.gmm(lhs, rhs, sizes)


@pytest.mark.parametrize("fn", ["gmm_cuda", "tgmm_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    x = torch.zeros((16, 8))
    offs = tgm.group_offsets(torch.tensor([8, 8]))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "gmm_cuda":
            tgm.gmm_cuda(x, torch.zeros((2, 8, 8)), offs)
        else:
            tgm.tgmm_cuda(x, x, offs)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


GPU_CASES = [
    # (G, H, N, sizes)
    (300, 64, 96, [0, 130, 0, 100, 70]),
    (1000, 128, 256, [900, 1, 0, 50, 49]),
    (257, 32, 40, [128, 0, 100]),           # sum < G, G % 128 != 0
    # The 16-bit kernel's 128-row tiles: boundaries inside a tile, runs of
    # empty groups, one group above 90%, G % 128 != 0 with sum == G.
    (512, 128, 128, [100, 156, 256]),
    (384, 64, 64, [0, 0, 200, 0, 184, 0]),
    (2048, 64, 128, [1900, 20, 0, 128]),
    (1000, 64, 72, [333, 333, 334]),
    (600, 128, 320, [0, 250, 1, 0, 300]),
    # The MoE widths: K = 3072 -> N = 768 in the forward, and in the dgrad
    # of the 768 -> 3072 projection.
    (1024, 3072, 768, [300, 0, 500, 224]),
    (1024, 768, 3072, [224, 500, 0, 300]),
]


def _f32_tol(k):
    """f32 kernel against the plain version: the same k-long sums of
    products of unit normals in another order. Each order's rounding error
    grows about as k * 2^-24 (a sum of k terms whose partial sums reach
    ~sqrt(k), each step rounding at 2^-24 of it, ~sqrt(k) * sqrt(k)); a
    margin of 4 over that, and never below the 1e-4 that covers short
    sums. k = 3072 gives 7.3e-4 (the largest difference the card showed
    there was 2.6e-4)."""
    return dict(atol=max(1e-4, 4 * k * 2.0**-24), rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,H,N,sizes", GPU_CASES)
def test_kernels_match_plain_on_card(cuda_device, G, H, N, sizes, dtype):
    dt = getattr(torch, dtype)
    lhs, rhs, dout, sz = (torch.from_numpy(x).to(cuda_device)
                          for x in _inputs(G, H, N, sizes))
    lhs, rhs, dout = (t.to(dt) for t in (lhs, rhs, dout))
    offs = tgm.group_offsets(sz)
    before = (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches)
    got = tgm.gmm_cuda(lhs, rhs, offs)
    back = tgm.gmm_cuda(dout, rhs, offs, transpose_rhs=True)
    tg = tgm.tgmm_cuda(lhs, dout, offs,
                       out=torch.full((len(sizes), H, N), float("nan"),
                                      device=cuda_device))
    torch.cuda.synchronize()
    assert (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    # f32 sums in another order on both sides (a tolerance by reduction
    # length: H for gmm, N for the dgrad); bf16 outputs round once on both
    # sides, so they may differ by one bf16 ulp of the value.
    def tol(k):
        return _f32_tol(k) if dt == torch.float32 else dict(atol=1e-2,
                                                            rtol=2**-7)
    torch.testing.assert_close(got, tgm.gmm_reference(lhs, rhs, sz), **tol(H))
    torch.testing.assert_close(back, tgm.gmm_reference(
        dout, rhs, sz, transpose_rhs=True), **tol(N))
    torch.testing.assert_close(tg, tgm.tgmm_reference(lhs, dout, sz),
                               atol=1e-4, rtol=1e-4)
    assert not got[sum(sizes):].any()


@pytest.mark.gpu
def test_autograd_goes_through_the_kernels(cuda_device):
    lhs, rhs, dout, sz = (torch.from_numpy(x).to(cuda_device)
                          for x in _inputs(*GPU_CASES[0]))
    tl, tr = (t.clone().requires_grad_(True) for t in (lhs, rhs))
    before = (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches)
    tgm.gmm(tl, tr, sz).backward(dout)
    torch.cuda.synchronize()
    assert (tgm.gmm_cuda.launches, tgm.tgmm_cuda.launches) == (
        before[0] + 2, before[1] + 1)
    pl, pr = (t.clone().requires_grad_(True) for t in (lhs, rhs))
    tgm.gmm_reference(pl, pr, sz).backward(dout)
    torch.testing.assert_close(tl.grad, pl.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tr.grad, pr.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    offs = tgm.group_offsets(torch.tensor([4, 4], device=cuda_device))
    with pytest.raises(ValueError, match="multiples of 8"):
        tgm.gmm_cuda(torch.zeros((8, 12), device=cuda_device),
                     torch.zeros((2, 12, 16), device=cuda_device), offs)
    with pytest.raises(ValueError, match="contiguous"):
        tgm.gmm_cuda(torch.zeros((16, 8), device=cuda_device).T,
                     torch.zeros((2, 16, 8), device=cuda_device), offs)
