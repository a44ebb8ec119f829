#!/usr/bin/env python3
"""Measure the tile constants of the port's split dq and head + CE kernels.

The constants are compile-time: each variant is a copy of the port
(``tpu_trainer_torch/`` and ``chip_smoke.py``) in a temporary directory
with one choice changed in a kernel source there, built with nvcc and
timed at the main path's shape with ``chip_smoke.py``'s helpers (CUDA
events, median of 5):

- the split dq kernel (``csrc/flash_attn.cu`` ``DqTmaSmem``, shipped: 64
  keys a K/V tile, 3 ring stages) at the packed shape (b 8, s 1024, h 12,
  d 64, bf16, dropout 0.1, RoPE, the packer's rows) and unsegmented at
  s = 1024 and 8192; variants: 128-key tiles, 2 and 4 stages;
- head + CE (``csrc/head_ce.cu``, shipped: N = 256 vocab rows, 3 stages,
  each hidden chunk's products waited before its stage is freed) at T
  8192, H 768, V 50257; variants: N = 128 with 4 stages, and one chunk's
  products kept in flight (``wait_group 1``).

Each variant's result is also held against the plain version run in f32
(relative L2 error, printed; a variant that disagrees is not a choice).
The shipped kernels run first and last, so the spread of one run shows.
Needs one CUDA GPU and nvcc; writes nothing into the checkout. Run from
the repository root: ``python3 scripts/torch_kernel_variants.py [--out
FILE]``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_WAIT_EACH_CHUNK = """        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
"""
_ONE_CHUNK_IN_FLIGHT = """        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (c > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((n + kStages - 1) % kStages));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((n + kStages - 1) % kStages));
"""
_DQ_STAGES = ("  static constexpr int kStages = 3;\n"
              "  static constexpr int kQBytes = kDqBQ")
_CE_N128 = [("csrc/head_ce.cu", "constexpr int kBV = 256;",
             "constexpr int kBV = 128;"),
            ("csrc/head_ce.cu", "constexpr int kStages = 3;",
             "constexpr int kStages = 4;"),
            ("ops/head_ce.py", "_BLOCK_V = 256", "_BLOCK_V = 128")]

# name: (kernel, [(file under tpu_trainer_torch/, text, replacement)])
VARIANTS = {
    "dq shipped (64 keys, 3 stages)": ("dq", []),
    "dq 128 keys": ("dq", [(
        "csrc/flash_attn.cu", "static constexpr int BK = 64;",
        "static constexpr int BK = 128;")]),
    "dq 2 stages": ("dq", [("csrc/flash_attn.cu", _DQ_STAGES,
                            _DQ_STAGES.replace("= 3;", "= 2;"))]),
    "dq 4 stages": ("dq", [("csrc/flash_attn.cu", _DQ_STAGES,
                            _DQ_STAGES.replace("= 3;", "= 4;"))]),
    "head_ce shipped (N 256, 3 stages)": ("head_ce", []),
    "head_ce N 128, 4 stages": ("head_ce", _CE_N128),
    "head_ce one chunk in flight": ("head_ce", [(
        "csrc/head_ce.cu", _WAIT_EACH_CHUNK, _ONE_CHUNK_IN_FLIGHT)]),
}

_TIME = r"""
import json, sys, torch
import chip_smoke as cs
from tpu_trainer_torch.ops import flash, head_ce
from tpu_trainer_torch.ops.rope import rope_tables

torch.backends.cuda.matmul.allow_tf32 = False
out = {}
if sys.argv[1] == "dq":
    for tag, b, s, seg in (("packed", 8, 1024, cs._packed_segments(8, 1024, 17)),
                           ("unsegmented s=1024", 8, 1024, None),
                           ("unsegmented s=8192", 1, 8192, None)):
        sets = [cs._attn_set(b, s, 12, 12, 64, "bfloat16", seed=i)
                for i in range(4)]
        kw = dict(dropout_rate=0.1, seed=7, segment_ids=seg,
                  rope=rope_tables(s, 64, device="cuda"))
        res = [flash.flash_forward(q, k, v, **kw) for q, k, v, _ in sets]
        dl = [flash.flash_backward_dkv(r[2], r[3], x[2], r[0], r[1], x[3],
                                       **kw)[2] for r, x in zip(res, sets)]
        dq = lambda i: flash.flash_backward_dq(  # noqa: E731
            res[i][2], res[i][3], sets[i][2], sets[i][3], res[i][1], dl[i],
            **kw)
        out[tag + " ms"] = cs.event_ms(dq, 4)
        if s <= 1024:
            q, k, v, do = sets[0]
            xs = [t.float().requires_grad_(True) for t in (q, k, v)]
            flash._reference_parts(*xs, causal=True, **kw)[0].backward(
                do.float())
            want = xs[0].grad
            out[tag + " rel err"] = float((dq(0).float() - want).norm()
                                          / want.norm())
else:
    x, e, lab, _ = cs._head_ce_case(8192, 768, 50257, seed=1)
    out["ms"] = cs.event_ms(lambda i: head_ce.head_ce_forward(x, e, lab), 3)
    lg, lse, ll = head_ce.head_ce_forward(x, e, lab)
    want = head_ce.head_ce_reference(x.float(), e.float(), lab)
    out["logits rel err"] = float((lg.float() - want[0]).norm()
                                  / want[0].norm())
    out["lse max err"] = float((lse - want[1]).abs().max())
    out["ll max err"] = float((ll - want[2]).abs().max())
print("RESULT " + json.dumps(out), flush=True)
"""


def _copy(dst: Path, name: str, edits) -> Path:
    shutil.copytree(ROOT / "tpu_trainer_torch", dst / "tpu_trainer_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst)
    for rel, text, new in edits:
        path = dst / "tpu_trainer_torch" / rel
        code = path.read_text()
        if code.count(text) != 1:
            raise RuntimeError(f"{name}: the text to change occurs "
                               f"{code.count(text)} times in {rel}")
        path.write_text(code.replace(text, new))
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write the timings here as JSON")
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[variants] {card}", flush=True)
    results = {"card": card}
    with tempfile.TemporaryDirectory(prefix="kernel-variants-") as tmp:
        dirs = {n: (_copy(Path(tmp) / f"v{i}", n, edits), kernel)
                for i, (n, (kernel, edits)) in enumerate(VARIANTS.items())}
        builds = {n: subprocess.Popen(
            [sys.executable, "-c", "from tpu_trainer_torch.ops import "
             f"_build; _build.build(['{'flash_attn' if k == 'dq' else k}'])"],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for n, (d, k) in dirs.items()}
        for n, proc in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{n}: build failed:\n{log[-3000:]}")
        shipped = [n for n in VARIANTS if "shipped" in n]
        for n in list(VARIANTS) + shipped:
            d, kernel = dirs[n]
            proc = subprocess.run([sys.executable, "-c", _TIME, kernel],
                                  cwd=d, capture_output=True, text=True,
                                  timeout=300)
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not line:
                raise RuntimeError(f"{n}: rc {proc.returncode}\n"
                                   f"{proc.stderr[-3000:]}")
            rec = json.loads(line[-1][len("RESULT "):])
            results.setdefault(n, []).append(rec)
            print(f"[variants] {n}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in rec.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
