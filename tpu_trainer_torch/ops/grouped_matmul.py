"""Grouped (ragged) matmuls for dropless MoE (port of
``tpu_trainer/ops/grouped_matmul.py``).

``gmm(lhs [G, H], rhs [E, H, N], group_sizes [E]) -> [G, N]`` multiplies
each contiguous row group of ``lhs`` by its own expert's weights: rows
``[offsets[e], offsets[e+1])`` (``offsets = [0, cumsum(group_sizes)]``)
hit ``rhs[e]``; rows past ``sum(group_sizes)`` give zeros. ``tgmm(lhs,
dout, group_sizes) -> [E, H, N]`` f32 is the per-group ``lhs^T @ dout``
(the weight gradient), zero for an empty group. ``gmm`` is
differentiable: d(lhs) is a ``gmm`` against ``rhs^T`` and d(rhs) a
``tgmm``, as the JAX package's ``_gmm_bwd``.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
``csrc/grouped_matmul.cu`` (``gmm_cuda`` and ``tgmm_cuda``, which replace
the Pallas TPU kernels ``_gmm_kernel`` and ``_tgmm_kernel``); the group
offsets are computed on the device, so nothing waits for the host. On a
CPU tensor they run the plain versions, ``gmm_reference`` (a per-group
loop of f32 matmuls, returning lhs's dtype) and ``tgmm_reference``. There
is no other fallback: a CUDA call launches its kernel or raises. Each
kernel wrapper counts its launches in ``<wrapper>.launches``.

The dgrad ``gmm(dout, rhs^T)`` passes ``transpose_rhs=True``: the kernel
reads ``rhs [E, H, N]`` as its transpose in place, with no transposed
copy of the weights.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_trainer_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _library() -> ctypes.CDLL:
    lib = _build.load("grouped_matmul")
    if lib.gmm_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gmm_launch.argtypes = [P] * 4 + [I] * 6 + [P]
        lib.gmm_launch.restype = I
        lib.tgmm_launch.argtypes = [P] * 4 + [I] * 5 + [P]
        lib.tgmm_launch.restype = I
        lib.gmm_error_string.argtypes = [I]
        lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.gmm_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def group_offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """int32 ``[E + 1]`` ``[0, cumsum(group_sizes)]`` on the sizes'
    device."""
    sizes = group_sizes.to(torch.int32)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=sizes.device),
                      torch.cumsum(sizes, 0, dtype=torch.int32)])


def _kernel_operands(what, a, b, offsets, n_groups):
    if a.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors; got {a.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"{what}: dtypes {a.dtype}/{b.dtype}: one of "
                         f"float32, bfloat16, float16")
    for t in (b, offsets):
        if t.device != a.device:
            raise ValueError(f"{what}: operand on {t.device}, lhs on "
                             f"{a.device}")
    for t in (a, b, offsets):
        if not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous")
    for t in (a, b):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} operands must start 16-byte aligned")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (n_groups + 1,):
        raise ValueError(f"{what}: offsets must be int32 [E + 1]")


def gmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor, offsets: torch.Tensor, *,
             transpose_rhs: bool = False) -> torch.Tensor:
    """The gmm kernel on CUDA tensors: ``[G, N]`` in lhs's dtype from
    ``lhs [G, K]``, ``rhs [E, K, N]`` (``transpose_rhs``: ``[E, N, K]``
    read as its transpose) and ``offsets`` (``group_offsets``). K and N
    must be multiples of 8."""
    if lhs.dim() != 2 or rhs.dim() != 3:
        raise ValueError(f"lhs must be [G, K] and rhs [E, K, N]; got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    E = rhs.shape[0]
    G, K = lhs.shape
    n, k_rhs = (rhs.shape[1], rhs.shape[2]) if transpose_rhs else (
        rhs.shape[2], rhs.shape[1])
    if k_rhs != K:
        raise ValueError(f"lhs {tuple(lhs.shape)} does not fit rhs "
                         f"{tuple(rhs.shape)} (transpose_rhs={transpose_rhs})")
    _kernel_operands("gmm_cuda", lhs, rhs, offsets, E)
    if K % 8 or n % 8:
        raise ValueError(f"gmm_cuda: K={K} and N={n} must be multiples of 8")
    out = torch.empty((G, n), dtype=lhs.dtype, device=lhs.device)
    if G == 0:
        return out
    lib = _library()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = lib.gmm_launch(
            ctypes.c_void_p(lhs.data_ptr()), ctypes.c_void_p(rhs.data_ptr()),
            ctypes.c_void_p(offsets.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), G, K, n, E,
            _DTYPE_CODES[lhs.dtype], int(transpose_rhs),
            ctypes.c_void_p(stream))
    _raise_on(lib, err, "gmm_cuda")
    gmm_cuda.launches += 1
    return out


gmm_cuda.launches = 0


def tgmm_cuda(lhs: torch.Tensor, dout: torch.Tensor, offsets: torch.Tensor,
              *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tgmm kernel on CUDA tensors: f32 ``[E, H, N]`` per-group
    ``lhs^T @ dout`` from ``lhs [G, H]``, ``dout [G, N]`` and ``offsets``
    (``group_offsets``, E + 1 entries), into ``out`` when given; every
    group's block is written, zeros for an empty one. H and N must be
    multiples of 8. Each output tile is summed by one block, in one order:
    the result is bitwise the same from run to run."""
    if lhs.dim() != 2 or dout.dim() != 2 or dout.shape[0] != lhs.shape[0]:
        raise ValueError(f"lhs [G, H] and dout [G, N] expected; got "
                         f"{tuple(lhs.shape)}, {tuple(dout.shape)}")
    E = offsets.shape[0] - 1
    G, H = lhs.shape
    N = dout.shape[1]
    _kernel_operands("tgmm_cuda", lhs, dout, offsets, E)
    if H % 8 or N % 8:
        raise ValueError(f"tgmm_cuda: H={H} and N={N} must be multiples of 8")
    if out is None:
        out = torch.empty((E, H, N), dtype=torch.float32, device=lhs.device)
    elif (out.dtype != torch.float32 or tuple(out.shape) != (E, H, N)
          or out.device != lhs.device or not out.is_contiguous()):
        raise ValueError(f"tgmm_cuda: out must be contiguous f32 "
                         f"{(E, H, N)} on {lhs.device}")
    if G == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream(lhs.device).cuda_stream
        err = lib.tgmm_launch(
            ctypes.c_void_p(lhs.data_ptr()), ctypes.c_void_p(dout.data_ptr()),
            ctypes.c_void_p(offsets.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), G, H, N, E,
            _DTYPE_CODES[lhs.dtype], ctypes.c_void_p(stream))
    _raise_on(lib, err, "tgmm_cuda")
    tgmm_cuda.launches += 1
    return out


tgmm_cuda.launches = 0


def _group_bounds(group_sizes: torch.Tensor, rows: int):
    """Host ``(start, end)`` row spans of the groups, clipped to ``rows``."""
    out, start = [], 0
    for n in group_sizes.tolist():
        end = start + int(n)
        out.append((min(start, rows), min(end, rows)))
        start = end
    return out


def gmm_reference(lhs: torch.Tensor, rhs: torch.Tensor,
                  group_sizes: torch.Tensor, *,
                  transpose_rhs: bool = False) -> torch.Tensor:
    """Plain ``gmm``: a per-group loop of f32 matmuls, lhs's dtype out
    (rows past ``sum(group_sizes)`` zero)."""
    w = rhs.transpose(1, 2) if transpose_rhs else rhs
    out = torch.zeros((lhs.shape[0], w.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    for e, (a, b) in enumerate(_group_bounds(group_sizes, lhs.shape[0])):
        if b > a:
            out[a:b] = lhs[a:b].float() @ w[e].float()
    return out.to(lhs.dtype)


def tgmm_reference(lhs: torch.Tensor, dout: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain ``tgmm``: per-group ``lhs^T @ dout`` in f32 ``[E, H, N]``."""
    E = group_sizes.shape[0]
    out = torch.zeros((E, lhs.shape[1], dout.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for e, (a, b) in enumerate(_group_bounds(group_sizes, lhs.shape[0])):
        if b > a:
            out[e] = lhs[a:b].float().T @ dout[a:b].float()
    return out


def tgmm(lhs: torch.Tensor, dout: torch.Tensor,
         group_sizes: torch.Tensor) -> torch.Tensor:
    """``tgmm_cuda`` on CUDA tensors, ``tgmm_reference`` on CPU ones."""
    if lhs.device.type == "cpu":
        return tgmm_reference(lhs, dout, group_sizes)
    return tgmm_cuda(lhs.contiguous(), dout.contiguous(),
                     group_offsets(group_sizes))


class _GroupedMatmul(torch.autograd.Function):
    """gmm forward; d(lhs) = gmm against rhs^T, d(rhs) = tgmm (the JAX
    ``_gmm_bwd``), each rounded to its operand's dtype."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        if lhs.device.type == "cpu":
            return gmm_reference(lhs, rhs, group_sizes)
        return gmm_cuda(lhs.contiguous(), rhs.contiguous(),
                        group_offsets(group_sizes))

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.contiguous()
        if lhs.device.type == "cpu":
            dlhs = gmm_reference(dout, rhs, group_sizes, transpose_rhs=True)
            drhs = tgmm_reference(lhs, dout, group_sizes)
        else:
            offsets = group_offsets(group_sizes)
            dlhs = gmm_cuda(dout, rhs.contiguous(), offsets,
                            transpose_rhs=True)
            drhs = tgmm_cuda(lhs.contiguous(), dout, offsets)
        return dlhs.to(lhs.dtype), drhs.to(rhs.dtype), None


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul, differentiable in ``lhs`` and ``rhs``.

    - ``lhs [G, H]`` rows sorted by group;
    - ``rhs [E, H, N]`` the per-group weights;
    - ``group_sizes [E]`` integer rows per group (``sum <= G``; rows past
      the sum give zeros).

    Returns ``[G, N]`` in lhs's dtype (f32 accumulation on both paths).
    """
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"lhs [G, H] and rhs [E, H, N] expected; got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    if tuple(group_sizes.shape) != (rhs.shape[0],):
        raise ValueError(f"group_sizes must be [E] = [{rhs.shape[0]}]; got "
                         f"{tuple(group_sizes.shape)}")
    if lhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lhs.device}")
    return _GroupedMatmul.apply(lhs, rhs, group_sizes)
