"""Fused LM-head + cross-entropy (port of ``tpu_trainer/ops/head_ce.py``).

``head_ce_forward`` computes the tied head's logits ``E x^T``, stored
vocab-major ``[V, T]`` in the compute dtype, and the f32 per-token
logsumexp and label logit. On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/head_ce.cu``, which replaces the Pallas TPU kernel
``tpu_trainer/ops/head_ce.py::_head_ce_fwd_kernel``; on a CPU tensor it
runs ``head_ce_reference``, the plain version. There is no other
fallback: a CUDA call launches the kernel or raises.

``pallas_head_ce`` is the differentiable mean masked cross entropy over
the kernel (the name of the JAX function it ports). Its backward is
``(softmax - onehot) * w`` from the saved logits followed by two matrix
products, as in the JAX package (``head_ce.py:267-320``).

The kernel is bound by operations: ``2 T V H`` flops on the tensor cores
(989 TFLOP/s dense bf16 on an H100 SXM, NVIDIA data sheet). It is a
persistent TMA/wgmma GEMM whose units are (token tile, vocab split) pairs;
``work_split`` derives the split count from T, V and the SM count, and the
wrapper pads what TMA cannot take (H and the logits' row stride to a
multiple of 8, 16-byte rows).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpu_trainer_torch.ops import _build

_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}
_BLOCK_T = 128   # csrc/head_ce.cu kBT
_BLOCK_V = 256   # csrc/head_ce.cu kBV
_ROW_ALIGN = 8   # 16-bit elements of a 16-byte TMA row stride


def head_ce_reference(x2: torch.Tensor, emb: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain ``head_ce_forward``: f32 logits ``E x^T`` of the inputs' values,
    ``lse`` and the label logit from the f32 logits, the logits returned
    vocab-major in ``x2``'s dtype."""
    lg = emb.float() @ x2.float().T                       # [V, T] f32
    lse = torch.logsumexp(lg, dim=0)
    ll = lg.gather(0, labels.long()[None, :])[0]
    return lg.to(x2.dtype), lse, ll


def _check(x2, emb, labels):
    if x2.dim() != 2 or emb.dim() != 2 or x2.shape[1] != emb.shape[1]:
        raise ValueError(f"x2 must be [T, H] and emb [V, H]; got "
                         f"{tuple(x2.shape)}, {tuple(emb.shape)}")
    if tuple(labels.shape) != (x2.shape[0],):
        raise ValueError(f"labels must be [T] = ({x2.shape[0]},); got "
                         f"{tuple(labels.shape)}")
    if emb.dtype != x2.dtype:
        raise ValueError(f"emb dtype {emb.dtype} != x2 dtype {x2.dtype}")


def head_ce_forward(x2: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused head + CE forward on flattened tokens.

    ``x2 [T, H]`` and ``emb [V, H]`` in the compute dtype, ``labels [T]``
    integer ids. Returns ``(logitsT [V, T] compute dtype, lse [T] f32,
    ll [T] f32)``; the per-token loss is ``lse - ll``. The kernel's logits
    have rows a multiple of 8 elements apart (contiguous when T is one).
    ``head_ce_forward.launches`` counts kernel launches.
    """
    _check(x2, emb, labels)
    if x2.device.type == "cpu":
        return head_ce_reference(x2, emb, labels)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    return _launch(x2, emb, labels)


head_ce_forward.launches = 0


def work_split(T: int, V: int, sms: int) -> int:
    """Vocab splits of the kernel's persistent walk. Unit ``u`` is (token
    tile ``u % nt``, split ``u // nt``), a split holds ``ceil(nv / splits)``
    vocab tiles (the last one the rest), and block ``b`` of ``grid =
    min(sms, units)`` takes units ``b, b + grid, ...``. The count gives
    the busiest block the fewest vocab tiles, the fewest splits among
    equals, and leaves no split empty."""
    nt, nv = -(-T // _BLOCK_T), -(-V // _BLOCK_V)
    best = None
    for n in range(1, nv + 1):
        tps = -(-nv // n)
        if (n - 1) * tps >= nv:
            continue
        load = -(-nt * n // sms) * tps
        if best is None or load < best[0]:
            best = (load, n)
    return best[1]


def _pad_hidden(x2, emb):
    """``x2`` and ``emb`` with zero columns appended up to a multiple of 8
    (TMA's 16-byte row stride); themselves when H already is one. Zeros
    leave every logit as it is."""
    pad = -x2.shape[1] % _ROW_ALIGN
    if not pad:
        return x2, emb
    return (torch.nn.functional.pad(x2, (0, pad)),
            torch.nn.functional.pad(emb, (0, pad)))


def _logits_buffer(V: int, T: int, like: torch.Tensor) -> torch.Tensor:
    """``[V, T]`` in ``like``'s dtype and device, rows ``ldt`` apart with
    ``ldt`` = T rounded up to a multiple of 8 (TMA's 16-byte row stride);
    contiguous when T already is one."""
    ldt = -(-T // _ROW_ALIGN) * _ROW_ALIGN
    return torch.empty((V, ldt), dtype=like.dtype, device=like.device)[:, :T]


def _launch(x2, emb, labels):
    if x2.dtype not in _DTYPE_CODES:
        raise ValueError(f"head_ce kernel takes bfloat16 or float16; got "
                         f"{x2.dtype}")
    if emb.device != x2.device or labels.device != x2.device:
        raise ValueError("x2, emb and labels must be on one device")
    if not (x2.is_contiguous() and emb.is_contiguous()):
        raise ValueError("head_ce_forward operands must be contiguous")
    if x2.data_ptr() % 16 or emb.data_ptr() % 16:
        raise ValueError("head_ce_forward operands must start 16-byte "
                         "aligned (the kernel's TMA loads)")
    T = x2.shape[0]
    V = emb.shape[0]
    x2, emb = _pad_hidden(x2, emb)
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    n_splits = work_split(T, V, sms)
    lab = labels.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=x2.device)
    logits_t = _logits_buffer(V, T, x2)
    parts = torch.empty((3, n_splits, T), **f32)
    lse = torch.empty((T,), **f32)
    ll = torch.empty((T,), **f32)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.head_ce_fwd(
            ptr(x2), ptr(emb), ptr(lab), ptr(logits_t), ptr(parts[0]),
            ptr(parts[1]), ptr(parts[2]), ptr(lse), ptr(ll), T, x2.shape[1],
            V, logits_t.stride(0), n_splits, _DTYPE_CODES[x2.dtype],
            ctypes.c_void_p(stream))
    if err != 0:
        msg = lib.head_ce_error_string(err).decode()
        raise RuntimeError(f"head_ce kernel launch failed: {msg} ({err})")
    head_ce_forward.launches += 1
    return logits_t, lse, ll


def _library() -> ctypes.CDLL:
    lib = _build.load("head_ce")
    if lib.head_ce_fwd.argtypes is None:
        lib.head_ce_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        lib.head_ce_fwd.restype = ctypes.c_int
        lib.head_ce_error_string.argtypes = [ctypes.c_int]
        lib.head_ce_error_string.restype = ctypes.c_char_p
    return lib


def head_ce_grads(logits_t, lse, labels, w, x2, emb
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx [T, H], dE [V, H])`` in the compute dtype from the saved
    vocab-major logits: ``dlg = ((softmax - onehot) * w)`` rounded to the
    compute dtype, then ``dx = dlg^T E`` and ``dE = dlg x``."""
    T = logits_t.shape[1]
    p = logits_t.float()
    p.sub_(lse[None, :]).exp_()
    p[labels.long(), torch.arange(T, device=p.device)] -= 1.0
    p.mul_(w[None, :])
    dlg = p.to(x2.dtype)
    del p
    return dlg.T @ emb, dlg @ x2


class _PallasHeadCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e_c, x, labels, mask):
        b, s, h = x.shape
        x2 = x.reshape(b * s, h)
        lab = labels.reshape(b * s)
        logits_t, lse, ll = head_ce_forward(x2, e_c, lab)
        m = mask.reshape(b * s).float()
        denom = torch.clamp(m.sum(), min=1.0)
        loss = ((lse - ll) * m).sum() / denom
        ctx.save_for_backward(e_c, x2, lab, m, logits_t, lse, denom)
        ctx.x_shape = x.shape
        return loss

    @staticmethod
    def backward(ctx, g):
        e_c, x2, lab, m, logits_t, lse, denom = ctx.saved_tensors
        dx, de = head_ce_grads(logits_t, lse, lab, m * (g / denom), x2, e_c)
        return de, dx.reshape(ctx.x_shape), None, None


def pallas_head_ce(emb: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean masked cross entropy through ``head_ce_forward`` (labels already
    shifted): ``x [b, s, h]``, ``labels [b, s]``, ``mask [b, s]`` weights;
    scalar f32. ``emb`` is cast to ``x``'s dtype first; its gradient flows
    back through that cast."""
    return _PallasHeadCE.apply(emb.to(x.dtype), x, labels, mask)
