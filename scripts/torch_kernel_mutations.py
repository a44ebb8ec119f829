#!/usr/bin/env python3
"""Mutation checks of the port's hand-written CUDA kernels, on the card.

For each named mutation: copy the port (``tpu_trainer_torch/`` and
``chip_smoke.py``) into a temporary directory, plant one fault into a
kernel source there, and run the ``chip_smoke.py`` phase that must catch it.
The check passes when that phase fails. The faults keep every kernel's walk
over its tiles or pages as it is (a producer and its consumers that fall
out of step hang instead of failing):

- ``bwd_hash_swapped``: the fused backward (``flash_bwd_tma_kernel``)
  hashes its dropout mask at (row = key, col = q) instead of (row = q,
  col = key); phase ``train_kernel`` must fail.
- ``decode_drops_page_end``: flash-decode masks the last position of every
  page; phase ``kernel`` must fail.
- ``dkv_no_segment_test``: the split dk/dv kernel (``flash_bwd_tma_kernel``
  without DQ) drops its element-wise ``qseg == kseg`` test, keeping only
  the tile skips; phase ``train_split`` must fail.
- ``tgmm_tail_rows_kept``: tgmm leaves the rows of a group's last chunk
  that lie past ``offsets[e + 1]`` (the next group's) unzeroed; phase
  ``gmm`` must fail.
- ``dq_no_segment_test``: the split dq kernel (``flash_bwd_dq_tma_kernel``)
  drops its element-wise ``qseg == kseg`` test, keeping only the tile
  skips; phase ``train_split`` must fail.
- ``head_ce_no_vocab_mask``: the head + CE kernel leaves the columns past
  V of its last vocab tile (E's zero-filled rows, logit 0) in the
  statistics; phase ``train_kernel`` must fail.

Needs one CUDA GPU and nvcc; writes nothing into the checkout. Run from the
repository root: ``python3 scripts/torch_kernel_mutations.py [name ...]``.
Exits 0 when every mutation was caught.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name: (source, text, mutated text, chip_smoke phase that must fail)
MUTATIONS = {
    "bwd_hash_swapped": (
        "tpu_trainer_torch/csrc/flash_attn.cu",
        "hkey, static_cast<uint32_t>(q), static_cast<uint32_t>(key),",
        "hkey, static_cast<uint32_t>(key), static_cast<uint32_t>(q),",
        "train_kernel"),
    "decode_drops_page_end": (
        "tpu_trainer_torch/csrc/flash_decode.cu",
        "sc[g][r] = (t < bsz && start + t < length) ? s : -INFINITY;",
        "sc[g][r] = (t < bsz - 1 && start + t < length) ? s : -INFINITY;",
        "kernel"),
    "dkv_no_segment_test": (
        "tpu_trainer_torch/csrc/flash_attn.cu",
        "ok = ok && ((e & 1) ? qz.y : qz.x) == (e < 2 ? kseg_a : kseg_b);",
        "ok = ok && qz.x == qz.x;",
        "train_split"),
    "tgmm_tail_rows_kept": (
        "tpu_trainer_torch/csrc/grouped_matmul.cu",
        "if (keep < kTgmmChunk) {",
        "if (keep < 0) {",
        "gmm"),
    "dq_no_segment_test": (
        "tpu_trainer_torch/csrc/flash_attn.cu",
        "ok = ok && ((e & 1) ? kz.y : kz.x) == (e < 2 ? qseg_a : qseg_b);",
        "ok = ok && kz.x == kz.x;",
        "train_split"),
    "head_ce_no_vocab_mask": (
        "tpu_trainer_torch/csrc/head_ce.cu",
        "if (ragged && v0 + col >= V) x = acc[4 * j + e] = kNeg;",
        "if (ragged && v0 + col < 0) x = acc[4 * j + e] = kNeg;",
        "train_kernel"),
}


def run(name: str, timeout: float = 600.0) -> bool:
    """Plants mutation ``name`` in a copy and runs its phase; True when the
    phase failed (the fault was caught)."""
    src, text, mutated, phase = MUTATIONS[name]
    with tempfile.TemporaryDirectory(prefix=f"mutation-{name}-") as tmp:
        shutil.copytree(ROOT / "tpu_trainer_torch",
                        Path(tmp) / "tpu_trainer_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy2(ROOT / "chip_smoke.py", tmp)
        path = Path(tmp) / src
        code = path.read_text()
        if code.count(text) != 1:
            raise RuntimeError(f"{name}: the text to mutate occurs "
                               f"{code.count(text)} times in {src}")
        path.write_text(code.replace(text, mutated))
        program = ("import torch, chip_smoke as cs\n"
                   "torch.backends.cuda.matmul.allow_tf32 = False\n"
                   "r = {}\ncs.phase_card(r)\n"
                   f"cs.phase_{phase}(r)\n")
        proc = subprocess.run([sys.executable, "-c", program], cwd=tmp,
                              capture_output=True, text=True,
                              timeout=timeout)
    tail = [ln for ln in (proc.stdout + proc.stderr).splitlines()
            if "FAILED" in ln or "Error" in ln or "error" in ln][-3:]
    caught = proc.returncode != 0
    print(f"[mutation] {name}: phase {phase} "
          f"{'FAILED as it must' if caught else 'PASSED: fault not caught'} "
          f"(rc {proc.returncode})", flush=True)
    for ln in tail:
        print(f"[mutation]   {ln[:400]}", flush=True)
    return caught


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(MUTATIONS)
    unknown = [n for n in names if n not in MUTATIONS]
    if unknown:
        print(f"unknown mutations {unknown}; choices {list(MUTATIONS)}",
              file=sys.stderr)
        return 2
    caught = [run(n) for n in names]
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
