#!/usr/bin/env python3
"""Where the ring's extra bf16 error comes from, on the CPU.

Runs the ring (``ops/ring.py``, every rank in this process through the
loopback permute, each chunk through the plain twin of the flash kernel)
in bf16 at sp 2 and 4, contiguous and zigzag, and prints each output's
worst-element and L2 error against the f32 twin over the whole sequence,
as a multiple of one bf16 pass's. Then the same with the K/V carried
through the permutes in f32 (each chunk still gets bf16 K/V, so each
chunk's partial dk/dv is still rounded to bf16, but the partials meet in
f32 and are rounded once at the end). If the two rows agree, the ring's
extra error is the chunks' own rounding, not the bf16 sums through the
permutes' transposes.

Run from the repository root: ``python3 scripts/ring_rounding.py``
(about ten seconds; prints one line per ring and carry).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpu_trainer_torch.ops import flash, ring  # noqa: E402


class _F32Carry:
    """``ring``'s view of ``torch`` and of ``flash`` with the stacked K/V
    carried in f32 and cast back to the queries' dtype for each chunk."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over.get(name) or getattr(self._base, name)


def _grads(fn, xs, do):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    o = fn(*xs)
    return [o.detach().float()] + [
        g.float() for g in torch.autograd.grad(o, xs, do)]


def main() -> int:
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 256, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), dtype=np.float32)).bfloat16() for _ in range(4))
    truth = _grads(flash.flash_attention_reference,
                   [t.float() for t in (q, k, v)], do.float())
    one = _grads(flash.flash_attention_reference, [q, k, v], do)
    f32_carry = {
        "torch": _F32Carry(torch, stack=lambda xs: torch.stack(xs).float()),
        "flash_lib": _F32Carry(flash, flash_attention=lambda q_, k_, v_, **kw:
                               flash.flash_attention(q_, k_.to(q_.dtype),
                                                     v_.to(q_.dtype), **kw)),
    }
    print("ring  carry  worst |err| / L2 err vs the f32 twin, as multiples "
          "of one bf16 pass's")
    for sp in (2, 4):
        for zz in (False, True):
            for carry in ("bf16", "f32"):
                saved = {n: getattr(ring, n) for n in f32_carry}
                if carry == "f32":
                    for n, shim in f32_carry.items():
                        setattr(ring, n, shim)
                try:
                    got = _grads(lambda *x: ring.ring_attention_loopback(
                        *x, sp, zigzag=zz), [q, k, v], do)
                finally:
                    for n, mod in saved.items():
                        setattr(ring, n, mod)
                cells = []
                for n, a, p, t in zip(("o", "dq", "dk", "dv"), got, one,
                                      truth):
                    mx = float((a - t).abs().max() / (p - t).abs().max())
                    l2 = float((a - t).norm() / (p - t).norm())
                    cells.append(f"{n} {mx:.2f}/{l2:.2f}")
                tag = f"sp{sp} {'zigzag' if zz else 'contiguous'}"
                print(f"{tag:<16} {carry:<5} " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
