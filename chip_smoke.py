#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tpu_trainer_torch``).

Drives the port on one NVIDIA GPU (written for the H100) and nothing of the
JAX package. Phases, each fatal on failure:

1. card    -- the card's name and power limit; builds every CUDA kernel of
              ``tpu_trainer_torch/csrc`` with nvcc for sm_90a (one nvcc a
              source, all started together) and prints the build time and
              ptxas's report.
2. kernel  -- ``flash_decode``'s kernel against its plain PyTorch version
              (``paged_attention_reference``) on the card: the serving
              path's shape (b=8, h=kvh=12, d=64, block 16, 64 blocks a row,
              513 pool blocks, 4 splits, ragged lengths 1..1024 with a
              null-block row), a GQA shape (h=32, kvh=8, d=128) and odd
              splits (mb=3), each with f32, bf16 and int8 pools. Times the
              kernel (also at 8 and 16 splits), the plain version and
              ``scaled_dot_product_attention`` over pre-gathered K/V (a
              yardstick only) on the device clock: one call per layer's
              pools (12 layers, so the 50 MB L2 holds none of them) in a
              CUDA graph, replayed between CUDA events, median of repeats.
              Computes the bound from the bytes and operations.
3. reference -- a tiny f32 engine on the card against the same engine on
              the CPU (the plain attention path): greedy streams, scheduler
              counters and kernel launches.
4. engine  -- the serving path: ``ServingEngine(device="cuda")`` at GPT-2
              small full width (vocab 50257, hidden 768, 12 layers, 12
              heads), bf16 compute over f32 params from ``init_params``,
              max_batch 8, block 16, replays a seeded Poisson trace of 24
              requests (prompts 64-512, 16-64 new tokens, greedy and
              sampled). Checks every request's token count, kernel launches
              == decode iterations x 12, finite logits, and kernel against
              plain attention on one live decode step's real pools.
   profile -- then, with the counts already read, where the engine's
              time goes: device busy share and the top kernels and host
              ops of a short trace under ``torch.profiler``.
5. int8    -- a short ``kv_int8=True`` run of the same engine, same checks.
6. train-kernel -- the flash forward and fused backward kernels against
              ``flash_attention_reference`` (o, lse, the rotated q/k, and
              dq/dk/dv through autograd of the plain version) at the
              training shape (b=8, s=1024, h=12, d=64; f32 and bf16, with
              and without dropout), a GQA shape (h=32, kvh=8, d=128) and a
              ragged s=1000; the head + CE kernel against
              ``head_ce_reference`` at T=8192, H=768, V=50257 bf16, at
              V=1000 and at T=300, H=100 (the padded row stride and hidden
              dim) (logits, lse, label logit, loss, dx/dE through the
              backward), each twice on the same inputs with logits, lse and
              ll bitwise equal. f32 results are held against the f32 plain
              version; bf16 results against the plain version run in f32
              (the truth), next to the bf16 plain version's error; the
              check must reject planted faults (among them the plain
              version run with another dropout seed: the masks at other
              positions). Times each kernel, its plain version and one
              PyTorch call as a yardstick (SDPA forward/backward; matmul
              + ``cross_entropy``, and cuBLAS's bf16 product alone with V
              padded to 50304) with CUDA events, computes the bounds,
              times the bf16 forward without dropout and RoPE, and splits
              the fused backward's device time (``torch.profiler``) into
              its pre-pass, its kernel and its dq finalize, and head +
              CE's into its GEMM and its merge. The fused
              backward runs twice on the same inputs (bf16 and f32 at
              the main shape, bf16 GQA d=128): dq, dk and dv must be
              bitwise equal (dq's fixed summation order).
7. mask    -- the dropout keep mask dumped by a CUDA kernel through the
              flash kernels' ``__device__`` hash, under 128/64/256 tilings
              in q-major and k-major order, bitwise against the torch
              ``_keep_mask``; keep rate within 3 sigma of 1 - rate.
8. train-split -- the segmented forward and the split backward (dk/dv and
              dq kernels) against the plain version the same way: packed
              rows of the port's packer at b=8, s=1024, h=12, d=64 (f32 and
              bf16, with and without dropout, RoPE), GQA (h=32, kvh=8,
              d=128), a ragged s=1000 with documents shorter than a tile
              and across several tiles, unsegmented s=4096 through
              ``backward="split"``; planted faults (the split dq without
              the segment mask, the fused backward on segments) must fail;
              the dk/dv kernel twice on the same inputs (packed, packed
              GQA) must give bitwise equal results; at group 1 in bf16
              without summing f32 partials afterwards; the dq kernel twice
              (packed bf16, packed GQA d=128, mixed-docs fp16, f32) too.
              Times at the packed shape next to SDPA with the equivalent
              boolean mask, and the fused/split table (unsegmented, b*s =
              8192, s = 1024..8192) behind ``_FUSED_BWD_MAX_SEQ``.
9. gmm     -- the grouped-matmul kernels (gmm, its dgrad against rhs^T,
              tgmm) against ``gmm_reference`` / ``tgmm_reference`` at the
              MoE path's shapes (G=16384, E=8, 768 -> 3072 and 3072 -> 768;
              f32 and bf16) for balanced, skewed, empty-group and
              G % 128 != 0 group sizes, tgmm's output pre-filled with NaN;
              planted faults (a boundary tile's second group left out, an
              all-zero tgmm) must fail; tgmm twice on the skewed sizes
              (one group of 15706 rows) must be bitwise equal. Times next
              to ``torch._grouped_mm``
              (or a per-expert matmul loop where this torch lacks it or
              refuses the operands), for the dgrad on the transposed view
              of rhs too.
10. train-reference -- a tiny f32 ``Trainer`` (hidden 128, 2 heads of 64,
              2 layers, vocab 512, dropout off) for 5 steps on the card
              against the same on the CPU, equal weights and batches: loss,
              grad-norm and lr trajectories.
11. train-grads -- one GPT-2 small bf16 step (batch 8 x 1024, dropout 0.1)
              through the kernels and through their plain versions, both
              held against the plain step in f32 on the same weights,
              batch and dropout seeds: loss, global grad norm and every
              parameter's gradient.
12. train  -- the training path: ``Trainer(device="cuda")`` at GPT-2 small
              full width and depth with the configuration bench.py
              measures (batch 8 x 1024, bf16 over f32 masters, dropout 0.1
              on the residuals and in attention, flash attention, fused
              head + CE, accumulation 1), 10 steps of ``DummyDataLoader``
              batches with every launch count zeroed just before. Checks
              every loss finite (the first near ln(vocab)) and the launches
              the path must make (forward == fused backward == 12 x steps,
              head-CE == steps); prints step ms, tok/s, MFU, peak device
              memory and a ``torch.profiler`` split of two more steps.
13. train-packed -- the packed path: the same trainer on [8, 1024, 2]
              batches of ``packed_synthetic_loader`` (first-fit, mean
              document 256, corpus seed 17: bench.py --packed's packed
              lane), 10 steps: forward == dk/dv == dq launches == 12 x
              steps, no fused backward, head-CE == steps; also effective
              (non-pad) tok/s and ``non_pad_frac``.
14. moe-grads -- as train-grads with the MoE lane's dropless experts.
15. train-moe -- the dropless MoE path: bench.py --moe's dropless lane (8
              experts, top-2, z-loss 1e-3) at GPT-2 small width, 10 steps
              on ``DummyDataLoader`` batches and 10 on bench.py's skewed
              4-id stream: gmm == 6 x 12 x steps, tgmm == 3 x 12 x steps,
              forward == fused backward == 12 x steps; per-layer group
              sizes of one step; MFU on the active parameters.

16. cli     -- the training CLI as a user runs it: a seeded 4 MB corpus
              (one story a line) in a temporary directory;
              ``train_ddp.main`` on ``configs/small_model.yaml`` (GPT-2
              small, bf16 over f32 masters, dropout 0.1, accumulation 4)
              with ``--tokenizer byte``, 8 steps, saves and evals every
              4; step 8's checkpoint set aside and deleted, and the same
              argv again in a fresh process (``_cli_child``), which
              resumes from step 4: step 8's params, Adam moments and
              dropout generator and the losses of steps 5-8 must be
              bitwise equal, and that run's launches exactly 4 steps x 4
              micro-batches plus its eval batches. Prints tok/s and MFU
              from the run's JSONL, the checkpoint's save (sync, async)
              and restore seconds, and the device busy share of steady
              CLI steps under ``torch.profiler``; then 3 ``--pack_sequences``
              steps (split dk/dv and dq launches) and 3 steps of
              ``configs/moe_small.yaml --moe_impl dropless`` (gmm, tgmm).
17. infer   -- ``eval.infer.main`` on that checkpoint, greedy, 4 ragged
              prompts of 64 new tokens: the KV path and ``--serve`` (the
              flash-decode kernel; launches exactly 63 x 12) on the
              checkpoint root, then both on the consolidated
              ``params.npz`` in f32 compute, whose greedy tokens must be
              equal (a differing token only at a top-2 tie).
18. remat   -- ``train_ddp --config configs/large_1b_single_chip.yaml``
              (1.008 B parameters: 36 layers, hidden 1280, batch 4 x 1024,
              full remat, bf16 Adam moments) on the cli phase's corpus, 6
              steps with a save at step 3; the same command in a fresh
              process resumes from step 3, and step 6's state (params, the
              bf16 moments' bits, the generator) and the losses of steps
              4-6 must be bitwise equal; launches exact (the flash forward
              twice a layer a micro-batch). tok/s, MFU and peak memory
              from the run's JSONL. Then one step's gradients at that
              width without remat, with full remat and with "dots": loss,
              every gradient and the generator after the step bitwise the
              plain step's; a planted fault (a recompute that draws fresh
              dropout seeds) must move them. Peak memory and step time of
              each, and the device busy share and top kernels of two
              profiled trainer steps.
19. offload -- ``train_fsdp --config configs/medium_model.yaml`` (454 M
              parameters, FULL_SHARD at one process, remat on, batch 8 x
              4 x 1024, dummy data), 3 steps on the card and with the Adam
              moments in pinned host memory as float32, bfloat16, int8 and
              int8 with 0.5 GB kept on the card: f32 offload's step-3
              state bitwise the on-card run's, the narrow ones' losses
              within rtol 0.05, the partial offload's startup line equal to
              ``select_resident_moments``; bytes each way a step, H2D and
              D2H ms (CUDA events), GB/s, step time and peak memory of each.
20. moe-remat -- ``configs/moe_small.yaml --moe_impl dropless
              --gradient_checkpointing``, 2 steps: gmm 9 a layer a
              micro-batch (3 forward, 3 recompute, 3 dgrad), tgmm 3.
21. ft      -- fault tolerance and the run's telemetry on ``small_model.yaml``
              (8 steps, the cli phase's corpus), held to the cli phase's
              straight run: a chain of restarted processes under
              ``kill_in_save@4``, ``kill@5`` and ``truncate_meta@6``
              resuming at the last complete checkpoint, ending with every
              loss and the step-8 state bitwise (each restart's time to
              its first step split into imports, CUDA init, kernel
              loading, restore and the first step); a ``nan_loss``
              rollback with its crash report; a preemption notice drained
              at exit 143 and resumed bitwise; telemetry steps (per-layer
              grad norms recombining to the global norm within 1e-5, the
              state bitwise) with a profiling window whose Chrome trace
              must hold the flash forward's device events, a live
              ``/metrics`` scrape and the analyzer on the run's JSONL;
              the same activation stats under remat; MoE router
              telemetry; ``--nan_scan`` on a checkpoint with a planted inf.
              Launches exact on every path; the ``kernels`` line counts
              them beside the main paths'.

Every phase runs at full depth; the whole run takes about twelve minutes
on an H100 (700 W), builds included.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result. Run from the repository root: ``python3 chip_smoke.py``
(``--out FILE`` also writes every measured number as JSON).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s and
# non-tensor-core f32 FLOP/s (the kernel's products run on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# Kernel vs plain: both read the same pool values and compute in f32; an
# online softmax over up to 1024 positions in 4 splits against a one-shot
# softmax differs by a few f32 ulps of O(1) sums.
KERNEL_ATOL = 5e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, n_layers: int, replays: int = 20, repeats: int = 5
            ) -> float:
    """Device time of one call ``fn(i)``: one call per layer captured in a
    CUDA graph (so host overhead is not timed), the graph replayed
    ``replays`` times between CUDA events; median over ``repeats``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_layers):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_layers):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (replays * n_layers))
    return statistics.median(times)


# -- phase 1 ---------------------------------------------------------------

def phase_card(results: dict) -> None:
    from tpu_trainer_torch.ops import _build

    line = nvidia_smi_line()
    log("card", f"nvidia-smi: {line}")
    log("card", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"{torch.cuda.get_device_name(0)} "
                f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    for name in _build.SOURCES:
        _build.load(name)
    secs = time.perf_counter() - t0
    log("card", f"built {list(_build.SOURCES)} in {secs:.1f} s")
    for name in _build.SOURCES:
        for ln in _build.BUILD_LOG.get(name, "").splitlines():
            if any(w in ln for w in ("properties for", "registers", "spill",
                                     "warning")):
                log("card", f"ptxas {name}: {ln.strip()}")
    results["card"] = {"nvidia_smi": line, "build_s": secs}


# -- phase 2 ---------------------------------------------------------------

def _kernel_case(name, *, b, h, kvh, d, bsz, mb, nblk, lengths, layers=1,
                 null_row=None, n_splits=0, seed=0):
    """f32 q and ``layers`` f32 pools on the card, tables of distinct real
    blocks per row (a ``null_row`` reads block 0 only), int32 lengths."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    shape = (layers, nblk, bsz, kvh, d)
    pk = torch.randn(shape, generator=gen, device=dev)
    pv = torch.randn(shape, generator=gen, device=dev)
    perm = torch.randperm(nblk - 1, generator=gen, device=dev) + 1
    if b * mb <= nblk - 1:
        tables = perm[:b * mb].reshape(b, mb)
    else:
        tables = perm[torch.arange(b * mb, device=dev) % (nblk - 1)]
        tables = tables.reshape(b, mb)
    tables = tables.to(torch.int32)
    if null_row is not None:
        tables[null_row] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, pk=pk, pv=pv, tables=tables, lengths=lens,
                n_splits=n_splits, b=b, h=h, kvh=kvh, d=d, bsz=bsz, mb=mb)


def _pools(case, dtype):
    """``(pool_k, pool_v, k_scale, v_scale)`` of ``case`` in ``dtype``
    (scales None unless int8)."""
    from tpu_trainer_torch.utils.quant import quantize_kv_int8

    if dtype == "int8":
        k, sk = quantize_kv_int8(case["pk"])
        v, sv = quantize_kv_int8(case["pv"])
        return k, v, sk, sv
    dt = getattr(torch, dtype)
    return case["pk"].to(dt), case["pv"].to(dt), None, None


def _bound_ms(case, dtype, nbq) -> tuple:
    """Least time of one call: (ms, "bytes" | "operations"). Bytes: q,
    the K/V (and int8 scales) of every position below each row's length,
    tables, lengths and the output, each once. Operations: 2d for QK and
    2d for PV per (head, position), on the f32 CUDA cores."""
    b, h, kvh, d, mb = case["b"], case["h"], case["kvh"], case["d"], case["mb"]
    pos = int(case["lengths"].sum())
    elem = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    kv = 2 * pos * kvh * d * elem
    if dtype == "int8":
        kv += 2 * pos * kvh * nbq * 4
    nbytes = kv + 2 * b * h * d * 4 + b * mb * 4 + b * 4
    ops = 4 * d * h * pos
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _sdpa_ms(case, pk, pv, n_layers) -> float:
    """``scaled_dot_product_attention`` over K/V gathered beforehand from
    each layer's pools (the gather is not timed), ragged lengths as a
    boolean mask. A yardstick: the port never calls it."""
    import torch.nn.functional as F

    b, h, kvh, d = case["b"], case["h"], case["kvh"], case["d"]
    tl = case["tables"].long()
    span = case["mb"] * case["bsz"]
    ks, vs = [], []
    for i in range(n_layers):
        k = pk[i][tl].reshape(b, span, kvh, d).transpose(1, 2)
        v = pv[i][tl].reshape(b, span, kvh, d).transpose(1, 2)
        if h != kvh:
            k = k.repeat_interleave(h // kvh, dim=1)
            v = v.repeat_interleave(h // kvh, dim=1)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
    q = case["q"].to(pk.dtype)[:, :, None]
    mask = (torch.arange(span, device=q.device)[None]
            < case["lengths"][:, None].long())[:, None, None]
    return cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, ks[i], vs[i], attn_mask=mask), n_layers=n_layers)


def phase_kernel(results: dict) -> dict:
    from tpu_trainer_torch.ops import flash

    cases = [
        _kernel_case("main", b=8, h=12, kvh=12, d=64, bsz=16, mb=64,
                     nblk=513, layers=12, null_row=1,
                     lengths=[1024, 1, 517, 64, 300, 1000, 33, 768]),
        _kernel_case("gqa", b=4, h=32, kvh=8, d=128, bsz=16, mb=16,
                     nblk=65, lengths=[1, 256, 100, 17], null_row=0, seed=1),
        _kernel_case("odd_splits", b=3, h=4, kvh=2, d=64, bsz=16, mb=3,
                     nblk=12, lengths=[1, 17, 48], n_splits=3, seed=2),
    ]
    rows = []
    max_err = 0.0
    for case in cases:
        for dtype in ("float32", "bfloat16", "int8"):
            pk, pv, sk, sv = _pools(case, dtype)
            n_layers = pk.shape[0]
            scales = lambda i: ({} if sk is None  # noqa: E731
                                else {"k_scale": sk[i], "v_scale": sv[i]})
            ops = (case["tables"], case["lengths"])
            got = flash.flash_decode(case["q"], pk[0], pv[0], *ops,
                                     **scales(0), n_splits=case["n_splits"])
            torch.cuda.synchronize()
            want = flash.paged_attention_reference(case["q"], pk[0], pv[0],
                                                   *ops, **scales(0))
            if not torch.isfinite(got).all():
                raise AssertionError(f"{case['name']}/{dtype}: non-finite")
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            row = {"case": case["name"], "dtype": dtype, "max_abs_err": err,
                   "atol": KERNEL_ATOL}
            if err > KERNEL_ATOL:
                raise AssertionError(
                    f"{case['name']}/{dtype}: kernel vs plain max |err| "
                    f"{err:.3e} > {KERNEL_ATOL:.0e}")
            if case["name"] == "main":
                row["ms"] = cuda_ms(lambda i: flash.flash_decode(
                    case["q"], pk[i], pv[i], *ops, **scales(i)),
                    n_layers=n_layers)
                row["plain_ms"] = cuda_ms(
                    lambda i: flash.paged_attention_reference(
                        case["q"], pk[i], pv[i], *ops, **scales(i)),
                    n_layers=n_layers)
                row["library_ms"] = (None if dtype == "int8"
                                     else _sdpa_ms(case, pk, pv, n_layers))
                # The split count is the kernel's parallelism knob; the
                # default is _auto_splits (4 here).
                row["ms_by_splits"] = {ns: cuda_ms(
                    lambda i: flash.flash_decode(
                        case["q"], pk[i], pv[i], *ops, **scales(i),
                        n_splits=ns), n_layers=n_layers) for ns in (8, 16)}
                nbq = sk.shape[-1] if sk is not None else 1
                row["bound_ms"], row["bound_by"] = _bound_ms(case, dtype, nbq)
            rows.append(row)
            extra = ""
            if "ms" in row:
                lib = row["library_ms"]
                by = ", ".join(f"{v:.4f} ms at {k} splits"
                               for k, v in row["ms_by_splits"].items())
                extra = (f"  kernel {row['ms']:.4f} ms ({by}), plain "
                         f"{row['plain_ms']:.4f} ms, sdpa "
                         f"{'-' if lib is None else f'{lib:.4f}'} ms, bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            log("kernel", f"{case['name']:<10} {dtype:<8} max|err| "
                          f"{err:.2e} <= {KERNEL_ATOL:.0e}{extra}")
            del pk, pv, sk, sv
    results["kernel"] = rows
    results["kernel_max_abs_err"] = max_err
    return next(r for r in rows
                if r["case"] == "main" and r["dtype"] == "bfloat16")


# -- phase 3 ---------------------------------------------------------------

def phase_reference(results: dict) -> None:
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.serving.engine import ServingEngine, poisson_trace

    # Large init so greedy margins dwarf CPU/GPU f32 rounding differences.
    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, num_kv_heads=2, max_seq_len=64,
                    dropout=0.0, attention_dropout=0.0,
                    initializer_range=0.5, dtype="float32",
                    param_dtype="float32")
    params = init_params(cfg, seed=3, device="cpu")
    for kw in ({}, {"prefill_chunk_tokens": 8}):
        out = {}
        for dev in ("cpu", "cuda"):
            reqs = poisson_trace(8, vocab_size=128, rate=1.0, seed=3,
                                 prompt_len_range=(4, 24),
                                 max_new_range=(4, 12), temperature=0.0)
            eng = ServingEngine(params, cfg, max_batch=4, block_size=8,
                                num_blocks=9, device=dev, **kw)
            flash.flash_decode.launches = 0
            done = eng.run(reqs, time_mode="steps")
            launches = flash.flash_decode.launches
            summ = eng.summary()
            out[dev] = ({r.rid: r.generated for r in done},
                        {k: v for k, v in summ.items()
                         if k not in ("wall_s", "tokens_per_s",
                                      "oldest_wait_s")}, launches)
        (c_streams, c_sum, c_launch), (g_streams, g_sum, g_launch) = (
            out["cpu"], out["cuda"])
        if len(g_streams) != 8 or g_streams != c_streams:
            raise AssertionError(f"reference {kw}: CUDA greedy streams differ "
                                 f"from the CPU engine's")
        if g_sum != c_sum:
            raise AssertionError(f"reference {kw}: summaries differ: "
                                 f"{c_sum} vs {g_sum}")
        want = g_sum["decode_iters"] * cfg.num_layers
        if c_launch != 0 or g_launch != want:
            raise AssertionError(f"reference {kw}: launches cpu {c_launch}, "
                                 f"cuda {g_launch}, want 0 / {want}")
        log("reference", f"tiny f32 engine {kw or 'plain'}: 8 greedy streams "
                         f"equal on cuda and cpu, {g_sum['decode_iters']} "
                         f"decode iters, {g_sum['preemptions']} preemptions, "
                         f"{g_launch} kernel launches")
    results["reference"] = "ok"


# -- training phases ---------------------------------------------------------

# Dense bf16 tensor-core peak of an H100 SXM (NVIDIA data sheet, 700 W).
BF16_FLOPS = 989e12
# f32 kernel vs its f32 plain version on the same inputs: |err| <= atol +
# rtol * max|plain|. Reduction order only (dq adds across blocks with
# atomics, so its order changes from run to run).
F32_TOL = (1e-4, 1e-4)
# A bf16 kernel and its bf16 plain version both round (p, the products'
# operands, the outputs), each in its own places, so neither is the truth.
# Both are held against the plain version run in f32 on the same values:
# the kernel's error must stay within NEAR_FACTOR times the bf16 plain
# version's, as the worst element and as an L2 norm, plus a floor of
# NEAR_FLOOR[dtype of the result] times the truth's rms (for bf16 results
# half the unit roundoff 2^-8 of a typical element; f32 results such as
# lse come from f32 sums on both sides).
NEAR_FACTOR = 2.0
NEAR_FLOOR = {torch.bfloat16: 2.0**-9, torch.float32: 2.0**-15}
# The tiny f32 trainer on the card against the same trainer on the CPU:
# f32 sums in other orders (TF32 off); Adam turns O(ulp) differences of
# near-zero gradients into O(lr) parameter differences, which the loss and
# grad norm see at the 1e-5 level after 5 steps.
TRAIN_REF_RTOL = 1e-4


def event_ms(fn, n: int, *, reps: int = 5) -> float:
    """Device time of one call: ``fn(i)`` for i in 0..n-1 between CUDA
    events after a warm-up round, median over ``reps``. For calls of a
    millisecond or more, where host launch time hides behind the device."""
    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ms_by_kernel(fn, n: int, *, names) -> dict:
    """Device time of one call ``fn(i)`` (i in 0..n-1, after a warm-up
    round) by kernel, from ``torch.profiler``: each of ``names`` (a kernel
    counts toward the first name its symbol contains) and "other"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(n):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    out = {k: 0.0 for k in (*names, "other")}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = next((k for k in names if k in e.key), "other")
        out[key] += us / 1e3 / n
    return out


def _close(what, got, want) -> float:
    """An f32 kernel result against its f32 plain version (F32_TOL);
    returns max |kernel - plain|."""
    atol, rtol = F32_TOL
    got, want = got.detach().float(), want.detach().float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = float((got - want).abs().max())
    lim = atol + rtol * float(want.abs().max())
    if err > lim:
        raise AssertionError(f"{what}: kernel vs plain max |err| {err:.3e} "
                             f"> {lim:.3e}")
    return err


def _near_truth(what, got, plain, truth) -> dict:
    """A bf16 kernel result against the f32 truth, next to its bf16 plain
    version's error (NEAR_FACTOR, NEAR_FLOOR). Returns the errors; raises
    when the kernel's worst element or L2 error is past its limit."""
    floor = NEAR_FLOOR[got.dtype]
    got, plain, truth = (t.detach().float() for t in (got, plain, truth))
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    rms = float(torch.linalg.vector_norm(truth, dtype=torch.float64)
                ) / math.sqrt(truth.numel())
    out = {"vs_plain": float((got - plain).abs().max())}
    for name, norm in (("max", lambda t: float(t.abs().max())),
                       ("l2", lambda t: float(torch.linalg.vector_norm(
                           t, dtype=torch.float64)))):
        k, p = norm(got - truth), norm(plain - truth)
        n = 1.0 if name == "max" else math.sqrt(truth.numel())
        lim = NEAR_FACTOR * p + floor * rms * n
        out[name] = {"kernel": k, "plain": p, "limit": lim}
        if not k <= lim:
            raise AssertionError(
                f"{what}: kernel {name} error vs the f32 truth {k:.3e} > "
                f"{lim:.3e} ({NEAR_FACTOR:g} x the bf16 plain version's "
                f"{p:.3e} + {floor:.1e} x rms {rms:.3e} x {n:.0f})")
    return out


def _attn_set(b, s, h, kvh, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda heads: torch.randn((b, s, heads, d), generator=gen,  # noqa
                                   device="cuda").to(dt)
    return mk(h), mk(kvh), mk(kvh), mk(h)


def _bound(nbytes: float, flops: float) -> dict:
    """Least time: bytes over 3.35 TB/s or tensor-core flops over 989
    TFLOP/s, whichever is larger."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": flops}


def _causal_pairs(b, s, seg=None) -> int:
    """(q, k) pairs a causal call attends: all k <= q, or with segment ids
    those inside one id (c (c + 1) / 2 for an id held by c positions of a
    row, whatever the layout)."""
    if seg is None:
        return b * s * (s + 1) // 2
    pairs = 0
    for row in seg.cpu():
        c = torch.unique(row, return_counts=True)[1].long()
        pairs += int((c * (c + 1) // 2).sum())
    return pairs


def _attn_bounds(b, s, h, kvh, d, elem, seg=None) -> dict:
    """Least times of the forward, the fused backward and the split pair's
    two calls: bytes (each input read once, each output written once) over
    3.35 TB/s; the tensor-core products' flops on the attended pairs
    (``_causal_pairs``) over 989 TFLOP/s: 4d a pair and head forward, 10d
    fused, 8d in the dk/dv call (S, dP, dV, dK) and 6d in the dq call (S,
    dP, dQ)."""
    pairs = _causal_pairs(b, s, seg)
    qb, kvb = b * s * h * d * elem, b * s * kvh * d * elem
    rows, rope = b * h * s * 4, 2 * s * d * 4
    segb = 0 if seg is None else b * s * 4
    return {
        # q, k, v -> o, qs, ks, lse
        "fwd": _bound(qb + 2 * kvb + rope + segb + 2 * qb + kvb + rows,
                      4 * d * h * pairs),
        # qs, ks, v, o, do, lse -> dq, dk, dv
        "bwd": _bound(3 * qb + 2 * kvb + rows + rope + qb + 2 * kvb,
                      10 * d * h * pairs),
        # qs, ks, v, o, do, lse -> dk, dv, delta
        "dkv": _bound(3 * qb + 2 * kvb + rows + rope + segb + 2 * kvb + rows,
                      8 * d * h * pairs),
        # qs, ks, v, do, lse, delta -> dq
        "dq": _bound(2 * qb + 2 * kvb + 2 * rows + rope + segb + qb,
                     6 * d * h * pairs),
    }


def _bitwise_twice(what, fn) -> int:
    """Runs ``fn()`` (a tuple of tensors) twice on the same inputs and
    requires every output bitwise equal (the kernels' fixed summation
    orders); returns the number of elements compared."""
    first = [t.clone() for t in fn()]
    second = fn()
    torch.cuda.synchronize()
    n = 0
    for i, (a, b) in enumerate(zip(first, second)):
        if not torch.equal(a, b):
            diff = int((a != b).sum())
            raise AssertionError(f"{what}: output {i} differs between two "
                                 f"runs on the same inputs in {diff} of "
                                 f"{a.numel()} elements")
        n += a.numel()
    return n


def _must_reject(what, check) -> None:
    """``check()`` holds a planted fault against the truth and must
    raise."""
    try:
        check()
    except AssertionError:
        return
    raise AssertionError(f"the check passed a planted fault: {what}")


def _flash_case(tag, b, s, h, kvh, d, dtype, rate, seg=None,
                backward=None, faults=False) -> dict:
    """One shape through the kernels (the autograd Function, and
    ``flash_forward`` alone) and through the plain version: f32 results
    against the f32 plain version, bf16 results against the f32 truth
    next to the bf16 plain version. The rotated q/k residuals must equal
    the plain version's bitwise. ``seg`` (int32 [b, s] segment ids) and
    ``backward`` go to ``flash_attention``; the launches of the backward
    ``backward_impl`` picks are checked. ``faults``: also hold planted
    faults of the split backward against the same check. Returns max
    |kernel - plain| per result (and the truth errors for bf16)."""
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.ops.rope import rope_tables

    q, k, v, do = _attn_set(b, s, h, kvh, d, dtype, seed=s + h)
    kw = dict(dropout_rate=rate, seed=0x5EED if rate else None,
              rope=rope_tables(s, d, device="cuda"))

    def plain(xs, grad_out):
        xs = [x.clone().requires_grad_(True) for x in xs]
        o, lse, qs, ks = flash._reference_parts(*xs, causal=True,
                                                segment_ids=seg, **kw)
        o.backward(grad_out)
        return {"o": o, "lse": lse, "qs": qs, "ks": ks, "dq": xs[0].grad,
                "dk": xs[1].grad, "dv": xs[2].grad}

    impl = flash.backward_impl(s, seg is not None, backward)
    counters = (flash.flash_forward, flash.flash_backward,
                flash.flash_backward_dkv, flash.flash_backward_dq)
    before = [c.launches for c in counters]
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, segment_ids=seg,
                                backward=backward, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    want = [1, 1, 0, 0] if impl == "fused" else [1, 0, 1, 1]
    if launched != want:
        raise AssertionError(f"{tag}: launches (forward, fused, dkv, dq) "
                             f"{launched}, want {want}")
    o, lse, qs, ks = flash.flash_forward(q, k, v, segment_ids=seg, **kw)
    torch.cuda.synchronize()
    got = {"o": out, "o_direct": o, "lse": lse, "dq": tq.grad,
           "dk": tk.grad, "dv": tv.grad}
    ref = plain((q, k, v), do)
    ref["o_direct"] = ref["o"]
    for name, a, r in (("rotated q", qs, ref["qs"]),
                       ("rotated k", ks, ref["ks"])):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} {name}: {int((a != r).sum())} "
                                 f"elements differ from the plain version")
    shape = f"b={b} s={s} h={h} kvh={kvh} d={d} {impl}"
    if dtype == "float32":
        errs = {n: _close(f"{tag} {n}", t, ref[n]) for n, t in got.items()}
        log("train-kernel", f"flash {tag:<24} {shape}: rotated q/k bitwise; "
                            f"max|kernel - plain| " + ", ".join(
                                f"{n} {e:.2e}" for n, e in errs.items()))
        return errs
    truth = plain([x.float() for x in (q, k, v)], do.float())
    near = {n: _near_truth(f"{tag} {n}", t, ref[n], truth[n.split("_")[0]])
            for n, t in got.items()}
    if rate and tag.startswith("main"):
        _must_reject(f"{tag} o divided by l, not l (1 - rate)",
                     lambda: _near_truth("o", out * (1 - rate), ref["o"],
                                         truth["o"]))
        # The same dropout masks at other positions (another seed): what a
        # kernel that maps its accumulator elements to the wrong (row, col)
        # would produce.
        moved = flash._reference_parts(q, k, v, causal=True, segment_ids=seg,
                                       **dict(kw, seed=kw["seed"] + 1))[0]
        _must_reject(f"{tag} o with the dropout masks moved",
                     lambda: _near_truth("o", moved, ref["o"], truth["o"]))
        _must_reject(f"{tag} dq all zero",
                     lambda: _near_truth("dq", torch.zeros_like(tq.grad),
                                         ref["dq"], truth["dq"]))
    if faults:
        # The split dq without the segment mask, and the fused backward
        # (which has none) on the segmented forward's residuals.
        kwb = dict(kw, segment_ids=seg)
        _, _, delta = flash.flash_backward_dkv(qs, ks, v, o, lse, do, **kwb)
        bad_dq = flash.flash_backward_dq(qs, ks, v, do, lse, delta, **kw)
        _must_reject(f"{tag} split dq without the segment mask",
                     lambda: _near_truth("dq", bad_dq, ref["dq"],
                                         truth["dq"]))
        fused = flash.flash_backward(qs, ks, v, o, lse, do, **kw)
        for n, g in zip(("dq", "dk", "dv"), fused):
            _must_reject(f"{tag} the fused backward's {n} on segments",
                         lambda g=g, n=n: _near_truth(n, g, ref[n],
                                                      truth[n]))
    log("train-kernel", f"flash {tag:<24} {shape}: rotated q/k bitwise; "
                        f"error vs the f32 truth, kernel/plain bf16, max and "
                        f"L2: " + ", ".join(
                            f"{n} {r['max']['kernel']:.1e}/"
                            f"{r['max']['plain']:.1e} "
                            f"{r['l2']['kernel']:.2e}/{r['l2']['plain']:.2e}"
                            for n, r in near.items() if n != "o_direct"))
    return {**{n: r["vs_plain"] for n, r in near.items()}, "truth": near}


def phase_train_kernel(results: dict) -> dict:
    """Flash forward/backward against ``flash_attention_reference`` (o,
    lse, rotated q/k, and dq/dk/dv through autograd of the plain version),
    and the head + CE kernel against ``head_ce_reference`` (logits, lse,
    label logit, loss, dx/dE through the two-matmul backward). Every case
    runs; the phase fails after the last if any failed."""
    import torch.nn.functional as F

    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.ops.rope import rope_tables

    cases = [("main", 8, 1024, 12, 12, 64, dt, rate)
             for dt in ("float32", "bfloat16") for rate in (0.0, 0.1)]
    cases += [("gqa", 2, 1024, 32, 8, 128, "bfloat16", 0.1),
              ("ragged", 2, 1000, 12, 12, 64, "bfloat16", 0.1)]
    rows, fwd_err, bwd_err, failures = [], 0.0, 0.0, []
    for name, b, s, h, kvh, d, dtype, rate in cases:
        tag = f"{name}/{dtype}/p={rate}"
        try:
            row = _flash_case(tag, b, s, h, kvh, d, dtype, rate)
        except AssertionError as e:
            failures.append(str(e))
            log("train-kernel", f"flash {tag}: FAILED: {e}")
            continue
        fwd_err = max(fwd_err, *(row[n] for n in ("o", "o_direct", "lse")))
        bwd_err = max(bwd_err, *(row[n] for n in ("dq", "dk", "dv")))
        rows.append({"case": name, "dtype": dtype, "dropout": rate,
                     "shape": [b, s, h, kvh, d], **row})

    # The fused backward twice on the same inputs: dq (summed across blocks
    # in a fixed order), dk and dv bitwise equal, bf16 under dropout and
    # RoPE and f32, at the main shape and the GQA d = 128 one.
    rows_det = []
    for dt, (b, s, h, kvh, d) in (("bfloat16", (8, 1024, 12, 12, 64)),
                                  ("float32", (8, 1024, 12, 12, 64)),
                                  ("bfloat16", (2, 1024, 32, 8, 128))):
        tag = f"fused backward twice, {dt} b={b} s={s} h={h} kvh={kvh} d={d}"
        try:
            q, k, v, do = _attn_set(b, s, h, kvh, d, dt, seed=11)
            kw = dict(dropout_rate=0.1, seed=7,
                      rope=rope_tables(s, d, device="cuda"))
            o, lse, qs, ks = flash.flash_forward(q, k, v, **kw)
            n = _bitwise_twice(tag, lambda: flash.flash_backward(
                qs, ks, v, o, lse, do, **kw))
            rows_det.append({"dtype": dt, "shape": [b, s, h, kvh, d],
                             "elements": n})
            log("train-kernel", f"{tag}: dq, dk, dv bitwise equal ({n} "
                                f"elements)")
        except AssertionError as e:
            failures.append(str(e))
            log("train-kernel", f"{tag}: FAILED: {e}")

    # Times at the main path's shape and settings (bf16, dropout 0.1,
    # RoPE), four input sets so L2 holds none between calls.
    b, s, h, d = 8, 1024, 12, 64
    sets = [_attn_set(b, s, h, h, d, "bfloat16", seed=i) for i in range(4)]
    rope = rope_tables(s, d, device="cuda")
    kw = dict(dropout_rate=0.1, seed=7, rope=rope)
    res = [flash.flash_forward(q, k, v, **kw) for q, k, v, _ in sets]
    t = {"fwd_ms": event_ms(lambda i: flash.flash_forward(
             *sets[i][:3], **kw), 4),
         # What the dropout hash and the RoPE prologue's k rotation cost.
         "fwd_no_dropout_ms": event_ms(lambda i: flash.flash_forward(
             *sets[i][:3], rope=rope), 4),
         "fwd_no_dropout_no_rope_ms": event_ms(lambda i: flash.flash_forward(
             *sets[i][:3]), 4),
         "bwd_ms": event_ms(lambda i: flash.flash_backward(
             res[i][2], res[i][3], sets[i][2], res[i][0], res[i][1],
             sets[i][3], **kw), 4)}
    # The backward's device time by kernel: the pre-pass (delta, padded
    # lse, zeroed dq accumulator), the kernel itself and the dq finalize.
    t["bwd_parts_ms"] = device_ms_by_kernel(lambda i: flash.flash_backward(
        res[i][2], res[i][3], sets[i][2], res[i][0], res[i][1], sets[i][3],
        **kw), 4, names=("bwd_prep_kernel", "flash_bwd_tma_kernel",
                         "dq_finalize_kernel"))
    with torch.no_grad():
        t["plain_fwd_ms"] = event_ms(lambda i: flash.flash_attention_reference(
            *sets[i][:3], **kw), 4, reps=3)
    q, k, v, do = (x.clone().requires_grad_(i < 3)
                   for i, x in enumerate(sets[0]))
    ref = flash.flash_attention_reference(q, k, v, **kw)
    t["plain_bwd_ms"] = event_ms(lambda i: torch.autograd.grad(
        ref, (q, k, v), do, retain_graph=True), 2, reps=3)
    del ref
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in sets[0][:3])
    dot = sets[0][3].transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, dropout_p=0.1)
    with torch.no_grad():
        t["sdpa_fwd_ms"] = event_ms(lambda i: sdpa(), 4)
    lib_out = sdpa()
    t["sdpa_bwd_ms"] = event_ms(lambda i: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 4)
    del lib_out, res, sets
    bounds = _attn_bounds(b, s, h, h, d, 2)
    log("train-kernel", f"flash at b={b} s={s} h={h} d={d} bf16, dropout "
                        f"0.1, RoPE: forward {t['fwd_ms']:.3f} ms (bound "
                        f"{bounds['fwd']['bound_ms']:.4f} ms by "
                        f"{bounds['fwd']['bound_by']}: "
                        f"{bounds['fwd']['bytes'] / 1e6:.1f} MB, "
                        f"{bounds['fwd']['flops'] / 1e9:.2f} GFLOP), plain "
                        f"{t['plain_fwd_ms']:.3f} ms, SDPA "
                        f"{t['sdpa_fwd_ms']:.3f} ms")
    log("train-kernel", f"forward without dropout "
                        f"{t['fwd_no_dropout_ms']:.4f} ms, without dropout "
                        f"and RoPE {t['fwd_no_dropout_no_rope_ms']:.4f} ms")
    log("train-kernel", f"flash backward {t['bwd_ms']:.3f} ms (bound "
                        f"{bounds['bwd']['bound_ms']:.4f} ms by "
                        f"{bounds['bwd']['bound_by']}: "
                        f"{bounds['bwd']['bytes'] / 1e6:.1f} MB, "
                        f"{bounds['bwd']['flops'] / 1e9:.2f} GFLOP), plain "
                        f"{t['plain_bwd_ms']:.3f} ms, SDPA "
                        f"{t['sdpa_bwd_ms']:.3f} ms")
    log("train-kernel", "flash backward device time by kernel: " + ", ".join(
        f"{n} {v:.4f} ms" for n, v in t["bwd_parts_ms"].items()))
    head = _head_ce_checks(failures)
    results["train_kernel"] = {"flash_checks": rows, "flash_times": t,
                               "flash_bounds": bounds, "head_ce": head,
                               "bitwise_twice": rows_det,
                               "failures": failures}
    if failures:
        raise AssertionError(f"train-kernel: {len(failures)} failed: "
                             + " | ".join(failures))
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "times": t,
            "bounds": bounds, "head": head}


def _head_ce_case(T, H, V, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, H), generator=gen, device="cuda").bfloat16()
    e = (torch.randn((V, H), generator=gen, device="cuda") * 0.05).bfloat16()
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda")
    w = torch.ones(T, device="cuda")
    w[1023::1024] = 0.0                       # each row's last position
    return x, e, lab, w / w.sum()


def _head_ce_checks(failures: list) -> dict:
    """The head + CE kernel and the backward from its logits against the
    f32 truth (``head_ce_reference`` on f32 values, whose lse and label
    logit the bf16 plain version shares), next to the bf16 plain version.
    A failing shape is added to ``failures``."""
    import torch.nn.functional as F

    from tpu_trainer_torch.ops import head_ce

    out = {"checks": [], "max_abs_err": 0.0}
    # The main shape, a small vocab, and T and H off a multiple of 8 (the
    # wrapper's padded hidden dim and logits row stride).
    for T, H, V in ((8192, 768, 50257), (2048, 768, 1000), (300, 100, 2050)):
        x, e, lab, w = _head_ce_case(T, H, V, seed=V)
        tag = f"head_ce T={T} H={H} V={V}"
        lg, lse, ll = head_ce.head_ce_forward(x, e, lab)
        torch.cuda.synchronize()
        try:
            # Every logit owned by one unit, the splits merged in a fixed
            # order: logits, lse and ll bitwise the same from run to run.
            n_bits = _bitwise_twice(
                f"{tag} twice", lambda: head_ce.head_ce_forward(x, e, lab))
        except AssertionError as err:
            failures.append(str(err))
            log("train-kernel", f"{tag}: FAILED: {err}")
            continue
        got = {"logits": lg, "lse": lse, "ll": ll,
               "loss": ((lse - ll) * w).sum()}
        plain = dict(zip(("logits", "lse", "ll"),
                         head_ce.head_ce_reference(x, e, lab)))
        plain["loss"] = ((plain["lse"] - plain["ll"]) * w).sum()
        truth = dict(zip(("logits", "lse", "ll"), head_ce.head_ce_reference(
            x.float(), e.float(), lab)))
        truth["loss"] = ((truth["lse"] - truth["ll"]) * w).sum()
        try:
            near = {n: _near_truth(f"{tag} {n}", got[n], plain[n], truth[n])
                    for n in got}
            grads = {}
            for name, src, xs in (("got", got, (x, e)),
                                  ("plain", plain, (x, e)),
                                  ("truth", truth, (x.float(), e.float()))):
                # head_ce_grads consumes f32 logits in place: truth last.
                grads[name] = dict(zip(("dx", "dE"), head_ce.head_ce_grads(
                    src["logits"], src["lse"], lab, w, *xs)))
            for n in ("dx", "dE"):
                near[n] = _near_truth(f"{tag} {n}", grads["got"][n],
                                      grads["plain"][n], grads["truth"][n])
            if V == 50257:
                _must_reject(f"{tag} dE all zero", lambda: _near_truth(
                    "dE", torch.zeros_like(grads["got"]["dE"]),
                    grads["plain"]["dE"], grads["truth"]["dE"]))
        except AssertionError as err:
            failures.append(str(err))
            log("train-kernel", f"{tag}: FAILED: {err}")
            continue
        errs = {n: r["vs_plain"] for n, r in near.items()}
        out["checks"].append({"shape": [T, H, V], **errs, "truth": near,
                              "bitwise_twice_elements": n_bits})
        out["max_abs_err"] = max(out["max_abs_err"], *errs.values())
        log("train-kernel", tag + f": logits, lse, ll bitwise equal over two "
            f"runs ({n_bits} elements); error vs the f32 truth, kernel/plain "
            "bf16, max and L2: " + ", ".join(
                f"{n} {r['max']['kernel']:.1e}/{r['max']['plain']:.1e} "
                f"{r['l2']['kernel']:.2e}/{r['l2']['plain']:.2e}"
                for n, r in near.items()))
        del got, plain, truth, grads
    T, H, V = 8192, 768, 50257
    x, e, lab, _ = _head_ce_case(T, H, V, seed=1)
    out["ms"] = event_ms(lambda i: head_ce.head_ce_forward(x, e, lab), 3)
    with torch.no_grad():
        out["plain_ms"] = event_ms(
            lambda i: head_ce.head_ce_reference(x, e, lab), 2, reps=3)
        out["library_ms"] = event_ms(lambda i: F.cross_entropy(
            (x @ e.T).float(), lab), 3)
        # The floor of any library route: cuBLAS's bf16 product alone, with
        # V padded to a multiple of 64 (50304) so its leading dimension is
        # aligned, vocab-major as the kernel stores it.
        e_pad = torch.zeros((-(-V // 64) * 64, H), dtype=e.dtype,
                            device="cuda")
        e_pad[:V] = e
        out["cublas_product_ms"] = event_ms(lambda i: e_pad @ x.T, 3)
        del e_pad
    # The kernel's device time by kernel: the persistent GEMM with its
    # epilogue, and the merge of the splits. (Inside the GEMM the profiler
    # sees one kernel: the mainloop's and the epilogue's shares are not
    # separable there.)
    out["parts_ms"] = device_ms_by_kernel(
        lambda i: head_ce.head_ce_forward(x, e, lab), 3,
        names=("head_ce_tma_kernel", "head_ce_merge_kernel"))
    nbytes = T * H * 2 + V * H * 2 + T * 8 + V * T * 2 + 2 * T * 4
    flops = 2 * T * V * H
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    out.update(bound_ms=1e3 * max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               bytes=nbytes, flops=flops)
    log("train-kernel", f"head_ce at T={T} H={H} V={V} bf16: kernel "
                        f"{out['ms']:.3f} ms (bound {out['bound_ms']:.4f} ms "
                        f"by {out['bound_by']}: {nbytes / 1e6:.1f} MB, "
                        f"{flops / 1e9:.1f} GFLOP; "
                        f"{flops / out['ms'] / 1e9:.0f} TFLOP/s), plain "
                        f"{out['plain_ms']:.3f} ms, matmul + cross_entropy "
                        f"{out['library_ms']:.3f} ms, cuBLAS bf16 product "
                        f"alone (V padded to 64) "
                        f"{out['cublas_product_ms']:.3f} ms")
    log("train-kernel", "head_ce device time by kernel: " + ", ".join(
        f"{n} {v:.4f} ms" for n, v in out["parts_ms"].items()))
    return out


def phase_mask(results: dict) -> dict:
    """The dropout keep mask dumped by the CUDA kernel (the flash kernels'
    ``__device__`` hash) under several tilings and block orders, bitwise
    against the torch ``_keep_mask``; keep rate within 3 sigma."""
    from tpu_trainer_torch.ops import flash

    seq, rate, seed, salt = 1024, 0.1, 0xFEEDBEEF, 5
    want = flash._keep_mask(seed, torch.tensor(salt, device="cuda"), 0, 0,
                            seq, seq, seq, rate)
    rows = []
    for bq, bk, k_major in ((128, 128, False), (128, 128, True),
                            (64, 64, False), (256, 256, True),
                            (64, 256, False), (256, 64, True)):
        got = flash.keep_mask_cuda(seed, salt, seq, rate, block_q=bq,
                                   block_k=bk, k_major=k_major)
        if not torch.equal(got, want):
            raise AssertionError(f"mask {bq}x{bk} k_major={k_major}: "
                                 f"{int((got != want).sum())} bits differ")
        rows.append([bq, bk, k_major])
    n = seq * seq
    keep = float(want.float().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    if abs(keep - (1 - rate)) > 3 * sigma:
        raise AssertionError(f"keep rate {keep:.5f} outside 3 sigma of "
                             f"{1 - rate}")
    salt_t = torch.tensor(salt, device="cuda")
    rec = {"tilings": rows, "keep_rate": keep, "sigma": sigma,
           "ms": event_ms(lambda i: flash.keep_mask_cuda(
               seed, salt, seq, rate, block_q=128, block_k=128), 8),
           "plain_ms": event_ms(lambda i: flash._keep_mask(
               seed, salt_t, 0, 0, seq, seq, seq, rate), 8),
           "bound_ms": 1e3 * n / HBM_BYTES_PER_S, "bound_by": "bytes"}
    results["mask"] = rec
    log("mask", f"keep mask [{seq}, {seq}] bitwise equal to _keep_mask under "
                f"{len(rows)} tilings (q- and k-major); keep rate {keep:.5f} "
                f"vs {1 - rate} +- 3 sigma {3 * sigma:.5f}; kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
                f"{rec['bound_ms']:.5f} ms (1 byte an element written)")
    return rec


def _packed_segments(b, s, seed) -> torch.Tensor:
    """int32 [b, s] segment ids of ``b`` rows from the port's packer
    (first-fit over the synthetic ragged corpus, mean document s // 4)."""
    from tpu_trainer_torch.data.packing import packed_synthetic_loader

    batch = next(iter(packed_synthetic_loader(b, s, 50257, 1, seed)))
    return torch.as_tensor(batch[..., 1], dtype=torch.int32, device="cuda")


def _mixed_segments(s) -> torch.Tensor:
    """Two rows of length ``s``: row 0 documents of 1 to 40 tokens (many
    inside one 64-tile), row 1 documents of 300 to 600 (each across several
    tiles); both end in a padding tail (id 0)."""
    gen = torch.Generator().manual_seed(s)
    rows = []
    for lo, hi in ((1, 41), (300, 601)):
        ids, pos, doc = [], 0, 1
        while pos < s - 37:
            n = min(int(torch.randint(lo, hi, (1,), generator=gen)),
                    s - 37 - pos)
            ids += [doc] * n
            pos, doc = pos + n, doc + 1
        rows.append(ids + [0] * (s - pos))
    return torch.tensor(rows, dtype=torch.int32, device="cuda")


def _sdpa_mask(seg, s) -> torch.Tensor:
    """The boolean [b, 1, s, s] mask equal to causal and segment masking."""
    causal = torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
    if seg is None:
        return causal[None, None]
    return (causal[None] & (seg[:, :, None] == seg[:, None, :]))[:, None]


def _split_times(seg, b, s, h, d, rate=0.1) -> dict:
    """Device times at one shape (bf16, RoPE, ``rate`` dropout): the
    forward, the split pair's dk/dv and dq calls, their plain versions
    (autograd of ``flash_attention_reference`` to (k, v) and to q) and
    ``scaled_dot_product_attention`` with the equivalent boolean mask
    (forward, and backward to (k, v) and to q) as yardsticks."""
    import torch.nn.functional as F

    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.ops.rope import rope_tables

    sets = [_attn_set(b, s, h, h, d, "bfloat16", seed=i) for i in range(4)]
    kw = dict(dropout_rate=rate, seed=7 if rate else None,
              rope=rope_tables(s, d, device="cuda"))
    res = [flash.flash_forward(q, k, v, segment_ids=seg, **kw)
           for q, k, v, _ in sets]
    dkv = [flash.flash_backward_dkv(r[2], r[3], st[2], r[0], r[1], st[3],
                                    segment_ids=seg, **kw)
           for r, st in zip(res, sets)]
    t = {"fwd_ms": event_ms(lambda i: flash.flash_forward(
             *sets[i][:3], segment_ids=seg, **kw), 4),
         "dkv_ms": event_ms(lambda i: flash.flash_backward_dkv(
             res[i][2], res[i][3], sets[i][2], res[i][0], res[i][1],
             sets[i][3], segment_ids=seg, **kw), 4),
         "dq_ms": event_ms(lambda i: flash.flash_backward_dq(
             res[i][2], res[i][3], sets[i][2], sets[i][3], res[i][1],
             dkv[i][2], segment_ids=seg, **kw), 4)}
    del dkv, res
    q, k, v, do = (x.clone().requires_grad_(i < 3)
                   for i, x in enumerate(sets[0]))
    with torch.no_grad():
        t["plain_fwd_ms"] = event_ms(lambda i: flash.flash_attention_reference(
            q, k, v, segment_ids=seg, **kw), 2, reps=3)
    ref = flash.flash_attention_reference(q, k, v, segment_ids=seg, **kw)
    t["plain_dkv_ms"] = event_ms(lambda i: torch.autograd.grad(
        ref, (k, v), do, retain_graph=True), 2, reps=3)
    t["plain_dq_ms"] = event_ms(lambda i: torch.autograd.grad(
        ref, (q,), do, retain_graph=True), 2, reps=3)
    del ref
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in sets[0][:3])
    dot = sets[0][3].transpose(1, 2).contiguous()
    mask = _sdpa_mask(seg, s).expand(b, 1, s, s)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, dropout_p=rate)
    with torch.no_grad():
        t["sdpa_fwd_ms"] = event_ms(lambda i: sdpa(), 4)
    lib = sdpa()
    t["sdpa_dkv_ms"] = event_ms(lambda i: torch.autograd.grad(
        lib, (kt, vt), dot, retain_graph=True), 4)
    t["sdpa_dq_ms"] = event_ms(lambda i: torch.autograd.grad(
        lib, (qt,), dot, retain_graph=True), 4)
    return t


def phase_train_split(results: dict) -> dict:
    """The segmented forward and the split backward against the plain
    version (``_flash_case``): packed rows from the port's packer at the
    packed path's shape (b=8, s=1024, h=12, d=64; f32 and bf16, with and
    without dropout; RoPE), a GQA shape (h=32, kvh=8, d=128), a ragged
    s=1000 with documents shorter than a tile and across several tiles,
    and unsegmented s=4096 through ``backward="split"``; planted faults of
    the split dq and of the fused backward on segments must fail the
    check. Then times at the packed shape and the fused/split table
    (unsegmented, b*s = 8192) that sets ``_FUSED_BWD_MAX_SEQ``."""
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.ops.rope import rope_tables

    main_seg = _packed_segments(8, 1024, 17)
    cases = [(f"main/packed/{dt}/p={rate}", 8, 1024, 12, 12, 64, dt, rate,
              main_seg, None, dt == "bfloat16" and rate > 0)
             for dt in ("float32", "bfloat16") for rate in (0.0, 0.1)]
    cases += [
        ("gqa/packed/bf16", 2, 1024, 32, 8, 128, "bfloat16", 0.1,
         _packed_segments(2, 1024, 18), None, False),
        ("ragged/mixed-docs/bf16", 2, 1000, 12, 12, 64, "bfloat16", 0.1,
         _mixed_segments(1000), None, False),
        ("ragged/mixed-docs/f32", 2, 1000, 12, 12, 64, "float32", 0.0,
         _mixed_segments(1000), None, False),
        ("long/unsegmented/split", 2, 4096, 12, 12, 64, "bfloat16", 0.1,
         None, "split", False),
    ]
    rows, failures, fwd_err, dkv_err, dq_err = [], [], 0.0, 0.0, 0.0
    for tag, b, s, h, kvh, d, dtype, rate, seg, bwd, faults in cases:
        try:
            row = _flash_case(tag, b, s, h, kvh, d, dtype, rate, seg=seg,
                              backward=bwd, faults=faults)
        except AssertionError as e:
            failures.append(str(e))
            log("train-split", f"{tag}: FAILED: {e}")
            continue
        fwd_err = max(fwd_err, *(row[n] for n in ("o", "o_direct", "lse")))
        dkv_err = max(dkv_err, row["dk"], row["dv"])
        dq_err = max(dq_err, row["dq"])
        rows.append({"case": tag, "shape": [b, s, h, kvh, d],
                     "segments": None if seg is None else int(
                         sum(len(torch.unique(r)) for r in seg.cpu())),
                     **row})
    # The dk/dv kernel twice on the same inputs, bitwise (packed bf16 with
    # dropout; packed GQA d = 128, whose f32 partials are group-summed);
    # at group 1 it writes dk/dv in the compute type itself: a third call
    # counts the calls of flash._group_sum (0 at group 1, dk and dv under
    # GQA).
    for tag, (b, s, h, kvh, d), seg in (
            ("packed bf16", (8, 1024, 12, 12, 64), main_seg),
            ("packed GQA bf16", (2, 1024, 32, 8, 128),
             _packed_segments(2, 1024, 18))):
        what = f"dk/dv kernel twice, {tag} b={b} s={s} h={h} kvh={kvh} d={d}"
        try:
            q, k, v, do = _attn_set(b, s, h, kvh, d, "bfloat16", seed=5)
            kw = dict(dropout_rate=0.1, seed=7, segment_ids=seg,
                      rope=rope_tables(s, d, device="cuda"))
            o, lse, qs, ks = flash.flash_forward(q, k, v, **kw)
            n = _bitwise_twice(what, lambda: flash.flash_backward_dkv(
                qs, ks, v, o, lse, do, **kw))
            sums, group_sum = [], flash._group_sum
            flash._group_sum = lambda *a: sums.append(1) or group_sum(*a)
            try:
                dk, dv, _ = flash.flash_backward_dkv(qs, ks, v, o, lse, do,
                                                     **kw)
            finally:
                flash._group_sum = group_sum
            want = 0 if kvh == h else 2
            if (dk.dtype, dv.dtype) != (k.dtype, v.dtype) or len(sums) != want:
                raise AssertionError(f"{what}: dk/dv {dk.dtype}/{dv.dtype} "
                                     f"after {len(sums)} f32 partial sums, "
                                     f"want {k.dtype} after {want}")
            log("train-split", f"{what}: dk, dv, delta bitwise equal ({n} "
                               f"elements), dk/dv {dk.dtype} after "
                               f"{len(sums)} f32 partial sums")
        except AssertionError as e:
            failures.append(str(e))
            log("train-split", f"{what}: FAILED: {e}")
    # The split dq kernel twice on the same inputs: dq bitwise equal (its
    # blocks own their q tiles; no cross-block sums), packed bf16 with
    # dropout, packed GQA d = 128, fp16 across blocks and the f32 path.
    for tag, (b, s, h, kvh, d), dt, seg in (
            ("packed bf16", (8, 1024, 12, 12, 64), "bfloat16", main_seg),
            ("packed GQA bf16", (2, 1024, 32, 8, 128), "bfloat16",
             _packed_segments(2, 1024, 18)),
            ("mixed-docs fp16", (2, 1000, 12, 12, 64), "float16",
             _mixed_segments(1000)),
            ("packed f32", (2, 1024, 12, 12, 64), "float32",
             _packed_segments(2, 1024, 19))):
        what = (f"dq kernel twice, {tag} b={b} s={s} h={h} kvh={kvh} "
                f"d={d}")
        try:
            q, k, v, do = _attn_set(b, s, h, kvh, d, dt, seed=6)
            kw = dict(dropout_rate=0.1, seed=7, segment_ids=seg,
                      rope=rope_tables(s, d, device="cuda"))
            o, lse, qs, ks = flash.flash_forward(q, k, v, **kw)
            _, _, delta = flash.flash_backward_dkv(qs, ks, v, o, lse, do,
                                                   **kw)
            n = _bitwise_twice(what, lambda: (flash.flash_backward_dq(
                qs, ks, v, do, lse, delta, **kw),))
            log("train-split", f"{what}: dq bitwise equal ({n} elements)")
        except AssertionError as e:
            failures.append(str(e))
            log("train-split", f"{what}: FAILED: {e}")
    if failures:
        results["train_split"] = {"checks": rows, "failures": failures}
        raise AssertionError(f"train-split: {len(failures)} failed: "
                             + " | ".join(failures))

    b, s, h, d = 8, 1024, 12, 64
    t = _split_times(main_seg, b, s, h, d)
    bounds = _attn_bounds(b, s, h, h, d, 2, seg=main_seg)
    nonpad = float((main_seg != 0).float().mean())
    log("train-split", f"packed b={b} s={s} h={h} d={d} bf16, dropout 0.1, "
                       f"RoPE, {int(sum(len(torch.unique(r)) for r in main_seg.cpu()))} "
                       f"segments, non-pad {nonpad:.4f}, "
                       f"{_causal_pairs(b, s, main_seg)} attended pairs:")
    for name in ("fwd", "dkv", "dq"):
        bd = bounds[name]
        log("train-split", f"  {name:<4} kernel {t[name + '_ms']:.3f} ms (bound "
                           f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}: "
                           f"{bd['bytes'] / 1e6:.1f} MB, "
                           f"{bd['flops'] / 1e9:.2f} GFLOP), plain "
                           f"{t['plain_' + name + '_ms']:.3f} ms, SDPA with "
                           f"the boolean mask {t['sdpa_' + name + '_ms']:.3f} "
                           f"ms")

    # Fused against split, unsegmented, b * s = 8192 tokens.
    sweep = []
    for s_ in (1024, 2048, 4096, 8192):
        b_ = 8192 // s_
        sets = [_attn_set(b_, s_, h, h, d, "bfloat16", seed=i)
                for i in range(2)]
        kw = dict(dropout_rate=0.1, seed=7,
                  rope=rope_tables(s_, d, device="cuda"))
        res = [flash.flash_forward(q, k, v, **kw) for q, k, v, _ in sets]
        args = lambda i: (res[i][2], res[i][3], sets[i][2], res[i][0],  # noqa
                          res[i][1], sets[i][3])
        fused = event_ms(lambda i: flash.flash_backward(*args(i), **kw), 2)
        split = event_ms(lambda i: flash.flash_backward_split(*args(i), **kw),
                         2)
        sweep.append({"s": s_, "b": b_, "fused_ms": fused, "split_ms": split})
        log("train-split", f"  unsegmented backward b={b_} s={s_}: fused "
                           f"{fused:.3f} ms, split {split:.3f} ms "
                           f"({split / fused:.2f}x)")
        del sets, res
    rec = {"checks": rows, "times": t, "bounds": bounds, "sweep": sweep,
           "fused_max_seq": flash._FUSED_BWD_MAX_SEQ, "fwd_err": fwd_err,
           "dkv_err": dkv_err, "dq_err": dq_err, "non_pad_frac": nonpad}
    results["train_split"] = rec
    return rec


def _group_sizes(kind: str, G: int, E: int = 8) -> torch.Tensor:
    """Group sizes of ``G`` rows over ``E`` experts: balanced, skewed (one
    group with >= 90% of the rows), with empty groups (and boundaries inside
    tiles), or summing to a G that is not a multiple of 128."""
    if kind == "balanced":
        sizes = [G // E] * E
        sizes[-1] += G - sum(sizes)
    elif kind == "skewed":
        rest = [37, 0, 129, 1, 300, 0, 211]
        sizes = [G - sum(rest)] + rest
    elif kind == "empty":
        sizes = [0, 5000, 0, 0, 3001, 6000, 0, 0]
        sizes[-1] = G - sum(sizes)
    else:
        raise ValueError(kind)
    assert sum(sizes) == G and len(sizes) == E and min(sizes) >= 0
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _gmm_bound(sizes, K, N, elem, wgrad=False) -> dict:
    """Least time of one gmm (or tgmm): 2 K N flops a routed row; bytes:
    lhs [G, K] (tgmm: and dout [G, N]) read, the weights of every non-empty
    group read (tgmm: written f32 for every group), the output written."""
    G = int(sizes.sum())
    used = int((sizes > 0).sum())
    E = sizes.numel()
    if wgrad:
        nbytes = G * K * elem + G * N * elem + E * K * N * 4 + (E + 1) * 4
    else:
        nbytes = G * K * elem + used * K * N * elem + G * N * elem + \
            (E + 1) * 4
    return _bound(nbytes, 2 * G * K * N)


def _gmm_library(lhs, rhs, sizes):
    """One PyTorch call for the same grouped product, as a yardstick:
    ``torch._grouped_mm`` where this torch has it for these operands, else
    a per-expert ``torch.matmul`` loop. Returns (callable, label)."""
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    gm = getattr(torch, "_grouped_mm", None)
    if gm is not None and lhs.dtype == torch.bfloat16:
        try:
            gm(lhs, rhs, offs=offs)
            torch.cuda.synchronize()
            return (lambda: gm(lhs, rhs, offs=offs)), "torch._grouped_mm"
        except Exception as e:  # noqa: BLE001 - a yardstick only
            log("gmm", f"torch._grouped_mm refused these operands ({e!r:.120})"
                       f"; timing a per-expert torch.matmul loop instead")
    bounds = [0] + offs.tolist()

    def loop():
        return [lhs[a:b] @ rhs[e] for e, (a, b) in
                enumerate(zip(bounds[:-1], bounds[1:])) if b > a]
    return loop, "per-expert torch.matmul loop"


def phase_gmm(results: dict) -> dict:
    """gmm (forward and the dgrad against rhs^T) and tgmm against
    ``gmm_reference`` / ``tgmm_reference`` at the MoE path's shapes (G =
    16384 routed rows, E = 8, H = 768 -> N = 3072 and 3072 -> 768; f32
    against the f32 plain version, bf16 against the plain version run in
    f32 next to the bf16 plain version) for balanced, skewed, empty-group
    and G % 128 != 0 group sizes; tgmm's output pre-filled with NaN. Planted
    faults (a boundary tile's second group left out of a gmm, an all-zero
    tgmm) must fail the check. Then times of each kernel, its plain version
    and one PyTorch call at the path's shapes."""
    from tpu_trainer_torch.ops import grouped_matmul as gm

    E, G = 8, 16384
    cases = [(kind, G, H, N) for kind in ("balanced", "skewed", "empty")
             for H, N in ((768, 3072), (3072, 768))]
    cases += [("ragged-G", G - 37, 768, 3072)]
    checks, failures, gmm_err, tgmm_err = [], [], 0.0, 0.0
    for kind, g, H, N in cases:
        sizes = _group_sizes("balanced" if kind == "ragged-G" else kind, g)
        offs = gm.group_offsets(sizes)
        gen = torch.Generator(device="cuda").manual_seed(H + N + g)
        lhs32 = torch.randn((g, H), generator=gen, device="cuda")
        rhs32 = torch.randn((E, H, N), generator=gen, device="cuda") * 0.05
        dout32 = torch.randn((g, N), generator=gen, device="cuda")
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            lhs, rhs, dout = (t.to(dt) for t in (lhs32, rhs32, dout32))
            tag = f"{kind} G={g} {H}->{N} {dtype}"
            try:
                got = {"gmm": gm.gmm_cuda(lhs, rhs, offs),
                       "dgrad": gm.gmm_cuda(dout, rhs, offs,
                                            transpose_rhs=True)}
                tg = torch.full((E, H, N), float("nan"), device="cuda")
                got["tgmm"] = gm.tgmm_cuda(lhs, dout, offs, out=tg)
                torch.cuda.synchronize()
                plain = {"gmm": gm.gmm_reference(lhs, rhs, sizes),
                         "dgrad": gm.gmm_reference(dout, rhs, sizes,
                                                   transpose_rhs=True),
                         "tgmm": gm.tgmm_reference(lhs, dout, sizes)}
                # tgmm's result is f32 from f32 sums of exact products
                # whatever the input type: reduction order only, F32_TOL.
                errs = {"tgmm": _close(f"{tag} tgmm", got["tgmm"],
                                       plain["tgmm"])}
                if dtype == "float32":
                    errs.update({n: _close(f"{tag} {n}", got[n], plain[n])
                                 for n in ("gmm", "dgrad")})
                else:
                    f = (lhs.float(), rhs.float(), dout.float())
                    truth = {"gmm": gm.gmm_reference(f[0], f[1], sizes),
                             "dgrad": gm.gmm_reference(f[2], f[1], sizes,
                                                       transpose_rhs=True)}
                    near = {n: _near_truth(f"{tag} {n}", got[n], plain[n],
                                           truth[n]) for n in truth}
                    errs.update({n: r["vs_plain"] for n, r in near.items()})
                if kind == "empty" and H == 768 and dtype == "bfloat16":
                    _must_reject(f"{tag} gmm with a boundary tile's second "
                                 f"group left out", lambda: _near_truth(
                                     "gmm", _drop_second_group(got["gmm"],
                                                               sizes),
                                     plain["gmm"], truth["gmm"]))
                    _must_reject(f"{tag} all-zero tgmm", lambda: _close(
                        "tgmm", torch.zeros_like(got["tgmm"]),
                        plain["tgmm"]))
            except AssertionError as e:
                failures.append(str(e))
                log("gmm", f"{tag}: FAILED: {e}")
                continue
            gmm_err = max(gmm_err, errs["gmm"], errs["dgrad"])
            tgmm_err = max(tgmm_err, errs["tgmm"])
            checks.append({"case": kind, "G": g, "H": H, "N": N,
                           "dtype": dtype, "sizes": sizes.tolist(), **errs})
            log("gmm", f"{tag}: max|kernel - plain| " + ", ".join(
                f"{n} {e:.2e}" for n, e in errs.items())
                + ("" if dtype == "float32" else
                   " (bf16 gmm/dgrad within the f32-truth limits)")
                + ("; tgmm's NaN-filled output fully written"
                   if "empty" == kind else ""))
        del lhs32, rhs32, dout32
    # tgmm twice on the same inputs, bitwise, at the skewed sizes (the heavy
    # group's tiles listed first).
    for H, N in ((768, 3072), (3072, 768)):
        sizes = _group_sizes("skewed", G)
        what = f"tgmm twice, skewed G={G} {H}->{N} bf16"
        try:
            gen = torch.Generator(device="cuda").manual_seed(H + N)
            lhs = torch.randn((G, H), generator=gen, device="cuda").bfloat16()
            dout = torch.randn((G, N), generator=gen, device="cuda").bfloat16()
            offs = gm.group_offsets(sizes)
            n = _bitwise_twice(what, lambda: (gm.tgmm_cuda(lhs, dout, offs),))
            log("gmm", f"{what}: bitwise equal ({n} elements; the largest "
                       f"group {int(sizes.max())} rows)")
        except AssertionError as e:
            failures.append(str(e))
            log("gmm", f"{what}: FAILED: {e}")
    if failures:
        results["gmm"] = {"checks": checks, "failures": failures}
        raise AssertionError(f"gmm: {len(failures)} failed: "
                             + " | ".join(failures))

    # Times at the path's shapes, bf16, balanced and skewed groups.
    times = {}
    for kind in ("balanced", "skewed"):
        sizes = _group_sizes(kind, G)
        offs = gm.group_offsets(sizes)
        for H, N in ((768, 3072), (3072, 768)):
            gen = torch.Generator(device="cuda").manual_seed(1)
            ins = [(torch.randn((G, H), generator=gen, device="cuda").bfloat16(),
                    (torch.randn((E, H, N), generator=gen, device="cuda")
                     * 0.05).bfloat16(),
                    torch.randn((G, N), generator=gen, device="cuda").bfloat16())
                   for _ in range(2)]
            lib_fn, lib_label = _gmm_library(ins[0][0], ins[0][1], sizes)
            lib_dgrad, lib_dgrad_label = _gmm_library(
                ins[0][2], ins[0][1].transpose(1, 2), sizes)
            rec = {
                "gmm_ms": event_ms(lambda i: gm.gmm_cuda(
                    ins[i][0], ins[i][1], offs), 2),
                "dgrad_ms": event_ms(lambda i: gm.gmm_cuda(
                    ins[i][2], ins[i][1], offs, transpose_rhs=True), 2),
                "tgmm_ms": event_ms(lambda i: gm.tgmm_cuda(
                    ins[i][0], ins[i][2], offs), 2),
                "plain_gmm_ms": event_ms(lambda i: gm.gmm_reference(
                    ins[i][0], ins[i][1], sizes), 2, reps=3),
                "plain_tgmm_ms": event_ms(lambda i: gm.tgmm_reference(
                    ins[i][0], ins[i][2], sizes), 2, reps=3),
                "library_gmm_ms": event_ms(lambda i: lib_fn(), 2),
                "library_gmm": lib_label,
                "library_dgrad_ms": event_ms(lambda i: lib_dgrad(), 2),
                "library_dgrad": lib_dgrad_label,
                "library_tgmm_ms": event_ms(lambda i: [
                    ins[0][0][a:b].T @ ins[0][2][a:b] for a, b in zip(
                        [0] + torch.cumsum(sizes, 0).tolist()[:-1],
                        torch.cumsum(sizes, 0).tolist()) if b > a], 2),
                "library_tgmm": "per-expert torch.matmul loop",
                "gmm_bound": _gmm_bound(sizes, H, N, 2),
                "tgmm_bound": _gmm_bound(sizes, H, N, 2, wgrad=True),
            }
            times[f"{kind} {H}->{N}"] = rec
            log("gmm", f"{kind} G={G} {H}->{N} bf16: gmm {rec['gmm_ms']:.3f} "
                       f"ms (bound {rec['gmm_bound']['bound_ms']:.4f} ms by "
                       f"{rec['gmm_bound']['bound_by']}, "
                       f"{rec['gmm_bound']['flops'] / 1e9:.1f} GFLOP), dgrad "
                       f"{rec['dgrad_ms']:.3f} ms, tgmm {rec['tgmm_ms']:.3f} ms "
                       f"(bound {rec['tgmm_bound']['bound_ms']:.4f} ms); plain "
                       f"gmm {rec['plain_gmm_ms']:.3f} ms, tgmm "
                       f"{rec['plain_tgmm_ms']:.3f} ms; {lib_label} "
                       f"{rec['library_gmm_ms']:.3f} ms, dgrad "
                       f"{rec['library_dgrad_ms']:.3f} ms "
                       f"({lib_dgrad_label} on rhs^T), tgmm loop "
                       f"{rec['library_tgmm_ms']:.3f} ms")
            del ins
    out = {"checks": checks, "times": times, "gmm_err": gmm_err,
           "tgmm_err": tgmm_err}
    results["gmm"] = out
    return out


def _drop_second_group(out, sizes) -> torch.Tensor:
    """A planted gmm fault: in the first 128-row tile that straddles a group
    boundary, the rows of the tile's second group zeroed."""
    bad = out.clone()
    ends = torch.cumsum(sizes, 0).tolist()
    for end in ends[:-1]:
        if end % 128 and end < out.shape[0]:
            tile_end = min((end // 128 + 1) * 128, out.shape[0])
            bad[end:tile_end] = 0
            return bad
    raise AssertionError("no group boundary inside a tile")


def phase_train_reference(results: dict) -> None:
    """A tiny f32 Trainer on the card against the same on the CPU: equal
    weights and batches, dropout off, 5 steps."""
    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.training.config import TrainingConfig
    from tpu_trainer_torch.training.trainer import Trainer

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128, dropout=0.0,
                    attention_dropout=0.0, use_flash_attention=True)
    tc = TrainingConfig(batch_size=2, max_seq_len=128,
                        gradient_accumulation_steps=1, mixed_precision="fp32",
                        learning_rate=1e-3, warmup_steps=2, max_steps=5)
    params = init_params(cfg, seed=0, device="cpu")
    traj = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(cfg, tc, device=dev)
        state = trainer.init_state(0, params=params)
        before = (flash.flash_forward.launches, flash.flash_backward.launches)
        traj[dev] = []
        for batch in DummyDataLoader(2, 128, 512, 5):
            state, m = trainer.train_step(state, batch)
            traj[dev].append(m)
        launches = (flash.flash_forward.launches - before[0],
                    flash.flash_backward.launches - before[1])
        want = (0, 0) if dev == "cpu" else (10, 10)
        if launches != want:
            raise AssertionError(f"train-reference {dev}: flash launches "
                                 f"{launches}, want {want}")
    worst = 0.0
    for c, g in zip(traj["cpu"], traj["cuda"]):
        for key in ("loss", "grad_norm", "lr"):
            rel = abs(g[key] - c[key]) / max(abs(c[key]), 1e-12)
            worst = max(worst, rel)
            if rel > TRAIN_REF_RTOL:
                raise AssertionError(f"train-reference {key}: cuda {g[key]} "
                                     f"cpu {c[key]} (rel {rel:.2e})")
    results["train_reference"] = {"cpu": traj["cpu"], "cuda": traj["cuda"],
                                  "max_rel": worst}
    log("train-reference", "tiny f32 trainer 5 steps: losses "
        + " ".join(f"{m['loss']:.5f}" for m in traj["cuda"])
        + f" on cuda; loss/grad_norm/lr within {worst:.1e} relative of the "
          f"cpu run (<= {TRAIN_REF_RTOL:.0e}); 10 forward + 10 backward "
          f"kernel launches")


# One full-width bf16 step's gradients through the kernels and through
# their plain versions, each held against the plain step run in f32 (the
# truth) on the same weights, batch and dropout seeds: the kernel step's
# relative L2 error on every parameter's gradient, on the global gradient
# norm and on the loss must stay within STEP_FACTOR times the plain bf16
# step's plus STEP_FLOOR (half the bf16 unit roundoff 2^-8, relative).
STEP_FACTOR, STEP_FLOOR = 2.0, 2.0**-9


def _step_grads(cfg, params, tokens, *, plain: bool):
    """Loss and f32 gradients of one training forward/backward of ``GPT``
    at ``cfg`` (dropout seeds from a generator seeded 1). ``plain`` swaps
    the flash kernels for ``flash_attention_reference``, the head + CE
    kernel for the chunked cross entropy (``fused_loss_pallas=False``) and
    the grouped-matmul kernels for ``gmm_reference`` (differentiated by
    autograd)."""
    import dataclasses

    from torch import nn

    from tpu_trainer_torch.models import moe
    from tpu_trainer_torch.models.gpt import GPT
    from tpu_trainer_torch.ops import flash, grouped_matmul

    model = GPT(dataclasses.replace(cfg, fused_loss_pallas=not plain),
                device="meta")
    model.load_state_dict({n: nn.Parameter(t.clone())
                           for n, t in params.items()}, strict=True,
                          assign=True)
    names, leaves = zip(*model.named_parameters())
    kernels = (flash.flash_attention, moe.gmm)
    if plain:
        flash.flash_attention = flash.flash_attention_reference
        moe.gmm = grouped_matmul.gmm_reference
    try:
        _, loss = model(tokens, tokens, train=True,
                        generator=torch.Generator().manual_seed(1))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        flash.flash_attention, moe.gmm = kernels
    return float(loss.detach()), {n: g.float() for n, g in zip(names, grads)}


def _small_config(**kw):
    """GPT-2 small as bench.py sets it for the training lanes: seq 1024,
    flash attention, dropout 0.1 on the residuals and in attention, fused
    head + CE, fused projections, no remat (``kw`` adds e.g. the MoE
    fields)."""
    from tpu_trainer_torch.models.config import GPTConfig

    return GPTConfig.preset("small", max_seq_len=1024, use_flash_attention=True,
                            gradient_checkpointing=False, dropout=0.1,
                            attention_dropout=0.1, **kw)


# The MoE lane of bench.py --moe: 8 routed experts, top-2, dropless,
# z-loss 1e-3 (moe_aux_weight keeps its default 0.01).
MOE = dict(num_experts=8, moe_top_k=2, moe_impl="dropless",
           router_z_weight=1e-3)


def _counters():
    """Every kernel wrapper's launch counter, by name."""
    from tpu_trainer_torch.ops import flash, grouped_matmul, head_ce

    return {"flash_forward": flash.flash_forward,
            "flash_backward": flash.flash_backward,
            "flash_backward_dkv": flash.flash_backward_dkv,
            "flash_backward_dq": flash.flash_backward_dq,
            "head_ce": head_ce.head_ce_forward,
            "gmm": grouped_matmul.gmm_cuda, "tgmm": grouped_matmul.tgmm_cuda}


def _want_launches(cfg, steps: int, *, segmented: bool, seq: int = 1024):
    """The launches ``steps`` training steps of ``cfg`` must make: one
    forward a layer and the backward ``backward_impl`` picks, one head + CE
    a step, and with MoE 6 gmm (3 forward, 3 dgrad) and 3 tgmm a layer;
    under remat the forward and its 3 gmm run again in the backward."""
    from tpu_trainer_torch.ops import flash

    n = cfg.num_layers * steps
    fwd = 2 if cfg.gradient_checkpointing else 1
    fused = flash.backward_impl(seq, segmented) == "fused"
    moe_on = cfg.num_experts > 0
    return {"flash_forward": fwd * n, "flash_backward": n if fused else 0,
            "flash_backward_dkv": 0 if fused else n,
            "flash_backward_dq": 0 if fused else n, "head_ce": steps,
            "gmm": 3 * (fwd + 1) * n if moe_on else 0,
            "tgmm": 3 * n if moe_on else 0}


def phase_train_grads(results: dict, *, moe: bool = False) -> dict:
    """The main path's model and batch shape (GPT-2 small, 8 x 1024,
    dropout 0.1 in attention and on the residuals; ``moe``: with the MoE
    lane's dropless experts): one bf16 step's gradients through the kernels
    against the f32 truth, next to the bf16 plain step's (STEP_FACTOR,
    STEP_FLOOR)."""
    import dataclasses

    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.training.optimizer import global_norm

    phase = "moe-grads" if moe else "train-grads"
    cfg = _small_config(dtype="bfloat16", param_dtype="float32",
                        **(MOE if moe else {}))
    params = init_params(cfg, seed=0, device="cuda")
    batch = next(iter(DummyDataLoader(8, 1024, cfg.vocab_size, 1)))
    tokens = torch.as_tensor(batch, dtype=torch.long, device="cuda")
    counters = _counters()
    runs, launches = {}, {}
    for name, dtype, plain in (("kernel", "bfloat16", False),
                               ("plain", "bfloat16", True),
                               ("truth", "float32", True)):
        before = {k: c.launches for k, c in counters.items()}
        runs[name] = _step_grads(dataclasses.replace(cfg, dtype=dtype),
                                 params, tokens, plain=plain)
        torch.cuda.synchronize()
        launches[name] = {k: c.launches - before[k]
                          for k, c in counters.items()}
    zero = {k: 0 for k in counters}
    want = {"kernel": _want_launches(cfg, 1, segmented=False),
            "plain": zero, "truth": zero}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b, dtype=torch.float64)
                     / torch.linalg.vector_norm(b, dtype=torch.float64))

    truth = runs["truth"][1]
    errs = {n: (rel(runs["kernel"][1][n], g), rel(runs["plain"][1][n], g))
            for n, g in truth.items()}
    norms = {k: float(global_norm(r[1].values())) for k, r in runs.items()}
    for key, vals in (("grad_norm", norms),
                      ("loss", {k: r[0] for k, r in runs.items()})):
        t = vals["truth"]
        errs[key] = (abs(vals["kernel"] - t) / t, abs(vals["plain"] - t) / t)
    ratio = {n: k / (STEP_FACTOR * p + STEP_FLOOR)
             for n, (k, p) in errs.items()}
    worst = max(ratio, key=ratio.get)
    rec = {"loss": {k: r[0] for k, r in runs.items()}, "grad_norm": norms,
           "rel_err": errs, "worst": worst, "worst_ratio": ratio[worst],
           "launches": launches["kernel"]}
    results[phase.replace("-", "_")] = rec
    bad = [f"{n} {errs[n][0]:.3e} vs plain {errs[n][1]:.3e}"
           for n, r in ratio.items() if not r <= 1.0]
    if bad:
        raise AssertionError(f"{phase}: kernel step past STEP_FACTOR x the "
                             "plain step's error + STEP_FLOOR: "
                             + "; ".join(bad))
    k, p = errs[worst]
    log(phase, f"GPT-2 small{' MoE 8 x top-2' if moe else ''} bf16 step, "
               f"batch 8 x 1024, dropout 0.1: loss kernel "
               f"{rec['loss']['kernel']:.5f} plain {rec['loss']['plain']:.5f} "
               f"f32 {rec['loss']['truth']:.5f}; grad norm "
               f"{norms['kernel']:.5f} / {norms['plain']:.5f} / "
               f"{norms['truth']:.5f}; relative error vs f32 (kernel/plain): "
               f"grad_norm {errs['grad_norm'][0]:.2e}/"
               f"{errs['grad_norm'][1]:.2e}, worst of the {len(truth)} "
               f"gradients, norm and loss: {worst} {k:.2e}/{p:.2e} "
               f"({ratio[worst]:.2f} of its limit); launches "
               f"{ {n: v for n, v in launches['kernel'].items() if v} }")
    return rec


def _train_steps(phase, trainer, state, batches, steps, *, segmented,
                 profile=True) -> dict:
    """``steps`` training steps over ``batches`` with every launch count
    zeroed just before and read just after (they must equal
    ``_want_launches``), each step timed on the host clock up to a
    synchronize; every loss finite and the first near ln(vocab) (plus the
    router auxiliaries with MoE). Then, with the counts read, a profile of
    two more steps (``profile``)."""
    from tpu_trainer_torch.utils.guards import check_finite
    from tpu_trainer_torch.utils.logging import (
        flops_per_token, mfu, peak_flops_for_name)

    cfg = trainer.model_config
    seq = batches[0].shape[2]
    bs = batches[0].shape[1]
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    metrics, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        check_finite(i, m["loss"])
        metrics.append(m)
    launches = {k: c.launches for k, c in counters.items()}
    want = _want_launches(cfg, steps, segmented=segmented, seq=seq)
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    if not 9.0 < metrics[0]["loss"] < 12.5:
        raise AssertionError(f"{phase}: first loss {metrics[0]['loss']} is "
                             f"not near ln(vocab) = "
                             f"{math.log(cfg.vocab_size):.2f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = step_ms[2:]
    ms = statistics.median(steady)
    tok_s = bs * seq / (ms / 1e3)
    name = torch.cuda.get_device_name(0)
    util = mfu(tok_s, cfg, peak_flops=peak_flops_for_name(name), seq_len=seq)
    rec = {"steps": steps, "losses": [m["loss"] for m in metrics],
           "grad_norms": [m["grad_norm"] for m in metrics],
           "lrs": [m["lr"] for m in metrics], "step_ms": step_ms,
           "step_ms_median_3_to_10": ms, "tokens_per_s": tok_s, "mfu": util,
           "flops_per_token": flops_per_token(cfg, seq),
           "peak_memory_gb": peak_gb,
           "launches": {k: v for k, v in launches.items() if v}}
    log(phase, f"{steps} steps, losses "
               + " ".join(f"{x:.4f}" for x in rec["losses"]))
    log(phase, f"launches {rec['launches']} as the path must make them")
    log(phase, f"step {ms:.2f} ms (median of steps 3-{steps}; all: "
               + " ".join(f"{x:.1f}" for x in step_ms)
               + f"), {tok_s:.0f} tok/s, MFU {util:.4f} against "
                 f"{peak_flops_for_name(name) / 1e12:.0f} TFLOP/s "
                 f"({rec['flops_per_token'] / 1e9:.3f} GFLOP a token), peak "
                 f"device memory {peak_gb:.2f} GB")
    if profile:
        rec["profile"] = p = _profile_steps(trainer, state,
                                            batches[steps:steps + 2], ms)
        log("profile", f"{phase}: 2 profiled steps: device kernels busy "
                       f"{p['device_busy_ms_per_step']:.1f} ms a step = "
                       f"{p['device_busy_frac_of_step']:.3f} of the "
                       f"unprofiled step; "
                       f"{p['kernel_launches_per_step']:.0f} launches a step")
        for g, ms_g in p["groups_ms_per_step"].items():
            log("profile", f"  group  {ms_g:8.3f} ms/step  {g}")
        for k in p["kernels"]:
            log("profile", f"  device {k['ms_per_step']:8.3f} ms/step "
                           f"x{k['count']:<5} {k['name']}")
    return rec


def _trainer(cfg):
    from tpu_trainer_torch.training.config import TrainingConfig
    from tpu_trainer_torch.training.trainer import Trainer

    tc = TrainingConfig(batch_size=8, max_seq_len=1024,
                        gradient_accumulation_steps=1, mixed_precision="bf16",
                        optimizer_state_dtype="float32")
    trainer = Trainer(cfg, tc, device="cuda")
    return trainer, trainer.init_state(0)


def phase_train(results: dict) -> dict:
    """The main path: ``Trainer`` at GPT-2 small full width and depth, the
    configuration bench.py measures (bf16 over f32 masters, dropout 0.1 on
    the residuals and in attention, flash attention, fused head + CE,
    batch 8 x 1024, accumulation 1), 10 steps of ``DummyDataLoader``
    batches."""
    from tpu_trainer_torch.data.dummy import DummyDataLoader

    steps = 10
    cfg = _small_config()
    trainer, state = _trainer(cfg)
    loader = DummyDataLoader(batch_size=8, seq_len=1024,
                             vocab_size=cfg.vocab_size, num_batches=steps + 2)
    batches = [trainer.put_batch(b) for b in loader]
    log("train", "GPT-2 small, batch 8 x 1024, bf16 over f32 masters, "
                 "dropout 0.1, DummyDataLoader batches:")
    rec = _train_steps("train", trainer, state, batches, steps,
                       segmented=False)
    results["train"] = rec
    return rec["launches"]


def phase_train_packed(results: dict) -> dict:
    """The packed path: the same ``Trainer`` on ``[8, 1024, 2]`` batches of
    the port's packer (``packed_synthetic_loader``: first-fit, mean document
    256 tokens, corpus seed 17, as bench.py --packed's packed lane): the
    segmented flash forward, the split backward and head + CE with the
    segment target mask; 10 steps."""
    from tpu_trainer_torch.data.packing import packed_synthetic_loader

    steps = 10
    cfg = _small_config()
    trainer, state = _trainer(cfg)
    loader = packed_synthetic_loader(8, 1024, cfg.vocab_size, steps + 2, 17)
    host = list(loader)
    batches = [trainer.put_batch(b) for b in host]
    nonpad = float(sum((b[..., 1] != 0).sum() for b in host[:steps])
                   / sum(b[..., 1].size for b in host[:steps]))
    docs = sum(len(set(r.tolist()) - {0}) for b in host[:steps]
               for r in b[..., 1])
    log("train-packed", f"GPT-2 small, packed batches 8 x 1024 x 2, "
                        f"{docs} documents in {steps} batches, non_pad_frac "
                        f"{nonpad:.4f}:")
    rec = _train_steps("train-packed", trainer, state, batches, steps,
                       segmented=True)
    rec["non_pad_frac"] = nonpad
    rec["effective_tokens_per_s"] = rec["tokens_per_s"] * nonpad
    log("train-packed", f"effective (non-pad) {rec['effective_tokens_per_s']:.0f} "
                        f"tok/s at non_pad_frac {nonpad:.4f}")
    results["train_packed"] = rec
    return rec["launches"]


def phase_train_moe(results: dict) -> dict:
    """The dropless MoE path: ``Trainer`` at GPT-2 small with bench.py
    --moe's dropless lane (8 experts, top-2, z-loss 1e-3, aux weight 0.01;
    dropout 0.1, flash, fused head + CE; batch 8 x 1024, bf16 over f32
    masters), 10 steps on ``DummyDataLoader`` batches and 10 on bench.py's
    skewed stream (``default_rng(23).integers(0, 4, (8, 1024))``, which
    piles the top-2 choices onto a few experts). Prints the per-layer group
    sizes of one more step on each stream."""
    import numpy as np

    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.models import moe

    steps = 10
    cfg = _small_config(**MOE)
    trainer, state = _trainer(cfg)
    log("train-moe", f"GPT-2 small MoE {cfg.num_experts} experts top-"
                     f"{cfg.moe_top_k} dropless, {cfg.num_parameters() / 1e9:.3f}"
                     f" B parameters ({cfg.num_active_parameters() / 1e9:.3f} B "
                     f"active), batch 8 x 1024, bf16 over f32 masters")
    rng = np.random.default_rng(23)
    streams = {
        "dummy": [trainer.put_batch(b) for b in DummyDataLoader(
            8, 1024, cfg.vocab_size, steps + 3)],
        "skewed": [trainer.put_batch(rng.integers(0, 4, (8, 1024),
                                                  dtype=np.int32))
                   for _ in range(steps + 3)]}
    out = {}
    for name, batches in streams.items():
        rec = _train_steps(f"train-moe/{name}", trainer, state,
                           batches[:steps + 2], steps, segmented=False,
                           profile=name == "dummy")
        sizes, dispatch = [], moe.dispatch

        def record(gate_idx, num_experts):
            counts, perm, inv = dispatch(gate_idx, num_experts)
            sizes.append(counts.tolist())
            return counts, perm, inv

        moe.dispatch = record
        try:
            trainer.train_step(state, batches[steps + 2])
        finally:
            moe.dispatch = dispatch
        rec["group_sizes"] = sizes
        log(f"train-moe/{name}", "group sizes of one step, layer by layer: "
            + " | ".join(",".join(str(c) for c in layer) for layer in sizes))
        out[name] = rec
    results["train_moe"] = out
    return out["dummy"]["launches"]


# Device kernels by what they serve, for the step's breakdown (first
# match wins): the port's kernels, the GEMMs (cuBLAS), and the int64
# elementwise kernels, which are the counter-based residual dropout's
# uint32 hash (ops/dropout.py).
_KERNEL_GROUPS = (
    ("flash attention (csrc/flash_attn.cu)",
     ("flash_fwd_kernel", "flash_fwd_tma_kernel", "flash_bwd_kernel",
      "flash_bwd_tma_kernel", "flash_bwd_dq_kernel", "flash_bwd_dq_tma_kernel",
      "rope_prep_kernel", "delta_kernel", "bwd_prep_kernel",
      "dq_finalize_kernel")),
    ("head + CE forward (csrc/head_ce.cu)", ("head_ce_",)),
    ("grouped matmuls (csrc/grouped_matmul.cu)", ("gmm_kernel",
                                                  "gmm_tma_kernel")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("int64 elementwise (hash dropout)", ("<long", "long>", "long,")),
)


def _profile_steps(trainer, state, batches, step_ms: float) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    n = len(batches)
    avgs = list(prof.key_averages())
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    groups = {}
    for e in kernels:
        name = e.key
        group = next((g for g, keys in _KERNEL_GROUPS if any(
            k in name for k in keys)), "other elementwise / copies")
        groups[group] = groups.get(group, 0.0) + dev_us(e) / 1e3 / n
    return {"device_busy_ms_per_step": busy,
            "device_busy_frac_of_step": busy / step_ms,
            "kernel_launches_per_step": launches / n,
            "groups_ms_per_step": dict(sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
            "kernels": [{"name": e.key[:90], "count": e.count // n,
                         "ms_per_step": dev_us(e) / 1e3 / n}
                        for e in kernels[:15]]}


# -- phases 4 and 5 --------------------------------------------------------

def _trace(n, *, seed, prompt_len_range, max_new_range, vocab):
    """Seeded Poisson trace; even rids greedy, odd rids sampled."""
    from tpu_trainer_torch.serving.engine import poisson_trace
    from tpu_trainer_torch.serving.scheduler import SamplingParams

    reqs = poisson_trace(n, vocab_size=vocab, rate=20.0, seed=seed,
                         prompt_len_range=prompt_len_range,
                         max_new_range=max_new_range, temperature=0.8,
                         top_k=50, top_p=0.95)
    for r in reqs:
        if r.rid % 2 == 0:
            r.sampling = SamplingParams(temperature=0.0, seed=r.sampling.seed)
    return reqs


def _serve(phase, engine, reqs, *, capture_call):
    """Run ``reqs`` through ``engine`` (wall clock) with the launch count
    zeroed just before; keep the operands and live output of kernel launch
    number ``capture_call``; watch every logit."""
    from tpu_trainer_torch.ops import flash

    launch = flash._launch
    dev = engine.device
    finite = torch.ones((), dtype=torch.bool, device=dev)
    captured = {}
    calls = [0]

    def watch(_module, _inputs, logits):
        finite.logical_and_(torch.isfinite(logits).all())

    def capture(q, pool_k, pool_v, tables, lengths, k_scale, v_scale,
                n_splits):
        out = launch(q, pool_k, pool_v, tables, lengths, k_scale, v_scale,
                     n_splits)
        calls[0] += 1
        if calls[0] == capture_call:
            captured.update(
                args=[t.clone() for t in (q, pool_k, pool_v, tables, lengths)],
                kw={"k_scale": None if k_scale is None else k_scale.clone(),
                    "v_scale": None if v_scale is None else v_scale.clone()},
                out=out.clone())
        return out

    hook = engine.model.register_forward_hook(watch)
    flash._launch = capture
    try:
        flash.flash_decode.launches = 0
        done = engine.run(reqs, time_mode="wall")
        torch.cuda.synchronize()
        launches = flash.flash_decode.launches
    finally:
        flash._launch = launch
        hook.remove()
    summ = engine.summary()
    if len(done) != len(reqs):
        raise AssertionError(f"{phase}: {len(done)}/{len(reqs)} finished")
    for r in done:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"{phase}: request {r.rid} produced "
                                 f"{len(r.generated)} of {r.max_new_tokens}")
    want = summ["decode_iters"] * engine.config.num_layers
    if launches != want:
        raise AssertionError(f"{phase}: {launches} kernel launches, want "
                             f"decode_iters x layers = {want}")
    if not bool(finite):
        raise AssertionError(f"{phase}: a logit was NaN or infinite")
    if not captured:
        raise AssertionError(f"{phase}: decode call {capture_call} never ran")
    # Kernel (its live output) against plain attention on the same pools.
    plain = flash.paged_attention_reference(*captured["args"],
                                            **captured["kw"])
    err = float((captured["out"] - plain).abs().max())
    live_len = int(captured["args"][4].max())
    if err > KERNEL_ATOL:
        raise AssertionError(f"{phase}: live decode step kernel vs plain "
                             f"max |err| {err:.3e} > {KERNEL_ATOL:.0e}")
    return done, summ, launches, err, live_len


def _latency(done, summ) -> dict:
    from tpu_trainer_torch.serving.engine import request_metrics

    lat = request_metrics(done)
    out = {"tokens_per_s": summ["tokens_per_s"], "wall_s": summ["wall_s"]}
    for name in ("ttft", "tpot"):
        series = lat[name]
        out[f"{name}_p50_ms"] = 1e3 * float(statistics.median(series))
        out[f"{name}_p99_ms"] = 1e3 * float(
            sorted(series)[max(0, math.ceil(0.99 * len(series)) - 1)])
    return out


def phase_engine(results: dict, *, kv_int8: bool) -> int:
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving.engine import ServingEngine

    phase = "int8" if kv_int8 else "engine"
    cfg = GPTConfig.gpt2_small(dropout=0.0, attention_dropout=0.0,
                               dtype="bfloat16", param_dtype="float32")
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(params, cfg, max_batch=8, block_size=16,
                           kv_int8=kv_int8, device="cuda")
    vocab = cfg.vocab_size
    # Warm-up (allocator, cuBLAS handles), then a clean timed run.
    engine.run(_trace(3, seed=99, prompt_len_range=(64, 128),
                      max_new_range=(4, 8), vocab=vocab), time_mode="wall")
    engine.reset_stats()
    if kv_int8:
        reqs = _trace(8, seed=2, prompt_len_range=(64, 256),
                      max_new_range=(16, 32), vocab=vocab)
    else:
        reqs = _trace(24, seed=1, prompt_len_range=(64, 512),
                      max_new_range=(16, 64), vocab=vocab)
    # Capture layer 0 of the 8th decode iteration (batch full by then).
    done, summ, launches, err, live_len = _serve(
        phase, engine, reqs, capture_call=7 * cfg.num_layers + 1)
    lat = _latency(done, summ)
    ledger = engine.serve_ts[-1]
    rec = {"requests": len(reqs), "launches": launches,
           "decode_iters": summ["decode_iters"],
           "prefill_iters": summ["prefill_iters"],
           "generated_tokens": summ["generated_tokens"],
           "prompt_tokens": summ["prompt_tokens"],
           "preemptions": summ["preemptions"],
           "live_step_max_abs_err": err, "live_step_max_len": live_len,
           **lat, **{f"{c}_frac": ledger.get(f"{c}_frac", 0.0)
                     for c in ("dispatch", "host_sched", "idle")}}
    results[phase] = rec
    log(phase, f"{len(done)}/{len(reqs)} requests finished, "
               f"{summ['generated_tokens']} tokens, "
               f"{summ['decode_iters']} decode + {summ['prefill_iters']} "
               f"prefill iters, {summ['preemptions']} preemptions")
    log(phase, f"flash_decode launches {launches} == decode_iters x "
               f"{cfg.num_layers}; logits finite; live decode step (max "
               f"length {live_len}) kernel vs plain max|err| {err:.2e}")
    log(phase, f"{lat['tokens_per_s']:.1f} tok/s over {lat['wall_s']:.3f} s; "
               f"TTFT p50 {lat['ttft_p50_ms']:.2f} ms p99 "
               f"{lat['ttft_p99_ms']:.2f} ms; TPOT p50 "
               f"{lat['tpot_p50_ms']:.2f} ms p99 {lat['tpot_p99_ms']:.2f} ms")
    log(phase, f"serve loop wall: dispatch {rec['dispatch_frac']:.3f}, "
               f"host_sched {rec['host_sched_frac']:.3f}, idle "
               f"{rec['idle_frac']:.3f} (ServingLedger fractions)")
    return launches, engine


def profile_engine(results: dict, engine) -> None:
    """Where the engine's time goes: an 8-request trace of the engine
    phase's kind, run once on the wall clock and once more under
    ``torch.profiler``; the device kernels' busy time against the
    unprofiled wall, and the kernels and host ops that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace():
        return _trace(8, seed=3, prompt_len_range=(64, 512),
                      max_new_range=(16, 64), vocab=engine.config.vocab_size)

    engine.reset_stats()
    engine.run(trace(), time_mode="wall")
    unprofiled_wall_s = engine.wall_elapsed
    engine.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(trace(), time_mode="wall")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    avgs = list(prof.key_averages())
    # Device-side entries only (kernels, memcpy/memset); the host ops that
    # launched them carry the same time again.
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    host = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    iters = engine.stats["decode_iters"] + engine.stats["prefill_iters"]
    launches = sum(e.count for e in avgs if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    rec = {"wall_ms": wall_ms, "unprofiled_wall_ms": 1e3 * unprofiled_wall_s,
           "device_busy_ms": busy_ms,
           "device_busy_frac_of_unprofiled_wall":
               busy_ms / (1e3 * unprofiled_wall_s),
           "decode_iters": engine.stats["decode_iters"],
           "prefill_iters": engine.stats["prefill_iters"],
           "kernel_launches_per_iter": launches / max(1, iters),
           "kernels": [{"name": e.key[:90], "count": e.count,
                        "ms": dev_us(e) / 1e3} for e in kernels[:15]],
           "host_ops": [{"name": e.key[:60], "count": e.count,
                         "ms": e.self_cpu_time_total / 1e3}
                        for e in host[:12]]}
    results["profile"] = rec
    log("profile", f"device kernels busy {busy_ms:.1f} ms = "
                   f"{rec['device_busy_frac_of_unprofiled_wall']:.3f} of the "
                   f"unprofiled serve loop ({1e3 * unprofiled_wall_s:.1f} ms; "
                   f"profiled {wall_ms:.1f} ms); {rec['decode_iters']} decode "
                   f"+ {rec['prefill_iters']} prefill iters, "
                   f"{rec['kernel_launches_per_iter']:.0f} launches per iter")
    for k in rec["kernels"]:
        log("profile", f"  device {k['ms']:9.3f} ms  x{k['count']:<6} "
                       f"{k['name']}")
    for k in rec["host_ops"]:
        log("profile", f"  host   {k['ms']:9.3f} ms  x{k['count']:<6} "
                       f"{k['name']}")


# -- phases 16 and 17: the user surface -------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))


def _write_corpus(path: str, n_bytes: int = 4 << 20, seed: int = 0) -> int:
    """A seeded synthetic corpus, one story a line (ASCII words from a
    4096-word vocabulary, 20-160 words a line) of about ``n_bytes``;
    returns the line count."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.integers(2, 10)))
             for _ in range(4096)]
    size, lines = 0, []
    while size < n_bytes:
        idx = rng.integers(0, len(words), rng.integers(20, 160))
        line = " ".join(words[i] for i in idx).capitalize() + "."
        lines.append(line)
        size += len(line) + 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def _cli_child(argv: list, out: str) -> None:
    """The resumed run of the cli phase, in a fresh process: every launch
    count zeroed, ``train_ddp.main(argv)``, the counts written to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tpu_trainer_torch.training import train_ddp

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rc = train_ddp.main(argv)
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": {k: c.launches
                                          for k, c in counters.items()}}, f)


def _jsonl(path: str, kind: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def _cli_in_process(phase: str, argv: list, entry=None, rc_want: int = 0
                    ) -> dict:
    """``entry(argv)`` (default ``train_ddp.main``) here with every launch
    count zeroed just before and read just after; its exit code must be
    ``rc_want``."""
    from tpu_trainer_torch.training import train_ddp

    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()   # the run's own peak in its JSONL
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rc = (entry or train_ddp.main)(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != rc_want:
        raise AssertionError(f"{phase}: train_ddp exited {rc}, want "
                             f"{rc_want}")
    return {"launches": {k: c.launches for k, c in counters.items()},
            "seconds": secs}


def _micro_launches(cfg, train_micro: int, eval_micro: int, *,
                    segmented: bool) -> dict:
    """Launches of ``train_micro`` training and ``eval_micro`` eval
    micro-batches: a forward a layer each (twice a training one under
    remat: the backward reruns it), the backward of the training ones,
    one head + CE each; with MoE 3 gmm a layer a forward, 3 more and 3
    tgmm a layer backward."""
    from tpu_trainer_torch.ops import flash

    L = cfg.num_layers
    fwd = 2 if cfg.gradient_checkpointing else 1
    fused = flash.backward_impl(cfg.max_seq_len, segmented) == "fused"
    moe_on = cfg.num_experts > 0
    return {"flash_forward": L * (fwd * train_micro + eval_micro),
            "flash_backward": L * train_micro if fused else 0,
            "flash_backward_dkv": 0 if fused else L * train_micro,
            "flash_backward_dq": 0 if fused else L * train_micro,
            "head_ce": train_micro + eval_micro,
            "gmm": (3 * L * ((fwd + 1) * train_micro + eval_micro)
                    if moe_on else 0),
            "tgmm": 3 * L * train_micro if moe_on else 0}


def _busy_share(argv: list) -> dict:
    """Device busy share of the CLI's steady steps: ``train_ddp.main`` over
    six steps under ``torch.profiler``, each ``Trainer.train_step`` marked
    by a ``record_function``; the union of device kernel intervals between
    the start of step 2 and the start of step 5, over that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_trainer_torch.training import train_ddp
    from tpu_trainer_torch.training.trainer import Trainer

    original = Trainer.train_step

    def marked(self, state, batch, *args, **kwargs):
        with record_function("cli_train_step"):
            return original(self, state, batch, *args, **kwargs)

    Trainer.train_step = marked
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rc = train_ddp.main(argv)
            torch.cuda.synchronize()
    finally:
        Trainer.train_step = original
    if rc != 0:
        raise AssertionError(f"cli: profiled run exited {rc}")
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name == "cli_train_step"
                    and e.device_type == DeviceType.CPU)
    if len(starts) != 6:
        raise AssertionError(f"cli: {len(starts)} marked steps, want 6")
    lo, hi = starts[2], starts[5]
    # Device activity (kernels, copies, memsets), not the marks' own
    # annotation spans on the GPU timeline.
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "cli_train_step"
                   and e.time_range.end > lo and e.time_range.start < hi)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    if busy <= 0:
        raise AssertionError("cli: the profiler saw no device time")
    return {"window_ms": (hi - lo) / 1e3, "steps": 3,
            "device_events": len(spans), "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / (hi - lo)}


def phase_cli(results: dict, tmp: str) -> dict:
    """The training CLI as a user runs it: ``configs/small_model.yaml`` on
    a seeded corpus, 8 steps with saves and evals every 4 (run 1, here);
    step 8's checkpoint set aside and deleted, and the same command again
    in a fresh process, which resumes from step 4 (run 2). Step 8's state
    (params, Adam moments, dropout generator) and the losses of steps 5-8
    must be bitwise equal across the two; run 2's launches exact. Then 3
    packed steps (split dk/dv and dq launches), 3 dropless-MoE steps of
    ``configs/moe_small.yaml`` (gmm and tgmm), the checkpoint save and
    restore times, steps 6-8 again with a sync save and without the eval,
    and the device busy share of six profiled steps."""
    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import Trainer
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    card = nvidia_smi_line()
    corpus = os.path.join(tmp, "stories.txt")
    n_lines = _write_corpus(corpus)
    small = os.path.join(ROOT, "configs", "small_model.yaml")
    base = ["--config", small, "--dataset", "tinystories", "--data_path",
            corpus, "--tokenizer", "byte", "--log_interval", "1"]
    argv = base + ["--max_steps", "8", "--save_interval", "4",
                   "--eval_interval", "4", "--keep_last_n", "0",
                   "--checkpoint_dir", os.path.join(tmp, "a"),
                   "--metrics_jsonl", os.path.join(tmp, "a.jsonl")]
    log("cli", f"corpus: {n_lines} lines, {os.path.getsize(corpus)} bytes "
               f"(seed 0); run 1: {' '.join(argv[2:])}")
    res = _resume_check("cli", argv, tmp, 8, 4)
    run1, run2, run2_s = res["run1"], res["run2"], res["run2_s"]
    train, evals, n_arrays = res["train"], res["evals"], res["state_arrays"]
    step8 = os.path.join(tmp, "a", "step_00000008")
    if [r["step"] for r in evals] != [4, 8, 8]:
        raise AssertionError(f"cli: eval records {evals}")
    n_eval = evals[-1]["eval_batches"]
    model_config, tc, _, _ = cli.resolve_configs(
        cli.build_parser().parse_args(argv))
    accum = tc.gradient_accumulation_steps
    want = _micro_launches(model_config, 4 * accum, n_eval * accum,
                           segmented=False)
    if run2["launches"] != want or n_eval < 1:
        raise AssertionError(f"cli: run 2 launches {run2['launches']}, "
                             f"want {want} (4 steps x {accum} micro-batches"
                             f" + {n_eval} eval batches x {accum})")
    steady = [r for r in train[:8] if r["step"] not in (0, 4)]
    tok_s = statistics.median(r["tokens_per_sec"] for r in steady)
    util = statistics.median(r["mfu"] for r in steady)
    rec = {"corpus_bytes": os.path.getsize(corpus), "corpus_lines": n_lines,
           "run1_s": run1["seconds"], "run2_s": run2_s,
           "losses": [r["loss"] for r in train[:8]],
           "eval_losses": [r["eval_loss"] for r in evals],
           "eval_batches": n_eval, "state_arrays_bitwise": n_arrays,
           "run2_launches": {k: v for k, v in run2["launches"].items() if v},
           "tokens_per_sec_median": tok_s, "mfu_median": util,
           "tokens_per_sec": [r["tokens_per_sec"] for r in train[:8]],
           "peak_mem_gb": max(r["peak_mem_gb"] for r in train[:8]),
           "nvidia_smi": card}
    log("cli", f"resume bitwise: {n_arrays} state arrays (params, moments, "
               f"generator) of step 8 and the losses of steps 5-8 equal "
               f"after a restart at step 4; run 2 launches "
               f"{rec['run2_launches']} (4 steps x {accum} + {n_eval} eval "
               f"batches x {accum})")
    log("cli", f"GPT-2 small, batch {accum} x {tc.batch_size} x "
               f"{tc.max_seq_len}, bf16, dropout 0.1: losses "
               + " ".join(f"{x:.4f}" for x in rec["losses"])
               + f"; eval {rec['eval_losses']}")
    log("cli", f"tok/s median of steps 2-4, 6-8 from the run's JSONL: "
               f"{tok_s:.0f}, MFU {util:.4f}, peak {rec['peak_mem_gb']} GiB "
               f"on {card}")

    # Checkpoint save and restore times at this model (f32 params + Adam).
    trainer = Trainer(model_config, tc, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = ckpt_lib.restore_checkpoint(step8, trainer)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(os.path.join(tmp, "timed"), state,
                             model_config=model_config, training_config=tc)
    rec["save_s"] = time.perf_counter() - t0
    saver = ckpt_lib.AsyncSaver()
    t0 = time.perf_counter()
    saver.save(os.path.join(tmp, "timed_async"), state,
               model_config=model_config, training_config=tc)
    rec["async_save_blocking_s"] = time.perf_counter() - t0
    saver.wait()
    rec["async_save_total_s"] = time.perf_counter() - t0
    rec["checkpoint_bytes"] = os.path.getsize(os.path.join(step8,
                                                           "state.npz"))
    del state, trainer
    for d in ("timed", "timed_async"):
        shutil.rmtree(os.path.join(tmp, d))
    log("cli", f"checkpoint {rec['checkpoint_bytes'] / 2**30:.2f} GiB: "
               f"restore {rec['restore_s']:.2f} s, sync save "
               f"{rec['save_s']:.2f} s, async save blocks "
               f"{rec['async_save_blocking_s']:.2f} s of "
               f"{rec['async_save_total_s']:.2f} s on {card}")

    # Steps 6-8 ran slower than steps 2-4 in run 1, after the step-4 eval
    # and the async save. Two more straight runs separate the two: one
    # saves on the loop's thread (the writer is done before step 5), one
    # skips the eval (the writer runs under steps 5-8).
    after = {"run1": [r["tokens_per_sec"] for r in train[5:8]]}
    for name, extra in (("sync_save", ["--no_async_checkpointing"]),
                        ("no_eval", ["--eval_interval", "0"])):
        torch.cuda.empty_cache()
        jsonl = os.path.join(tmp, f"{name}.jsonl")
        _cli_in_process("cli", argv[:-4] + extra + [
            "--checkpoint_dir", os.path.join(tmp, name),
            "--metrics_jsonl", jsonl])
        shutil.rmtree(os.path.join(tmp, name))
        after[name] = [r["tokens_per_sec"]
                       for r in _jsonl(jsonl, "train")[5:8]]
    rec["after_save_tokens_per_sec"] = after
    log("cli", "tok/s of steps 6-8 (straight runs, save and eval at step "
               "4): " + "; ".join(f"{k} " + " ".join(f"{x:.0f}" for x in v)
                                  for k, v in after.items())
               + f" on {card}")

    torch.cuda.empty_cache()
    prof_argv = base + ["--max_steps", "6", "--save_interval", "0",
                        "--eval_interval", "0", "--eval_batches", "1",
                        "--no_auto_resume",
                        "--checkpoint_dir", os.path.join(tmp, "prof")]
    rec["profile"] = _busy_share(prof_argv)
    shutil.rmtree(os.path.join(tmp, "prof"), ignore_errors=True)
    prof = rec["profile"]
    log("profile", f"cli: {prof['device_events']} device activities busy "
                   f"{prof['device_busy_ms']:.1f} of {prof['window_ms']:.1f}"
                   f" ms over steps 3-5 (profiled) = "
                   f"{prof['device_busy_share']:.3f} on {card}")

    torch.cuda.empty_cache()
    packed = _cli_in_process("cli", base + [
        "--pack_sequences", "--max_steps", "3", "--save_interval", "0",
        "--eval_interval", "0", "--no_auto_resume",
        "--checkpoint_dir", os.path.join(tmp, "p")])
    shutil.rmtree(os.path.join(tmp, "p"))
    want = _micro_launches(model_config, 3 * accum, 0, segmented=True)
    if packed["launches"] != want:
        raise AssertionError(f"cli: packed launches {packed['launches']}, "
                             f"want {want}")
    rec["packed_launches"] = {k: v for k, v in packed["launches"].items()
                              if v}
    log("cli", f"--pack_sequences, 3 steps in {packed['seconds']:.1f} s: "
               f"launches {rec['packed_launches']}")

    torch.cuda.empty_cache()
    moe_argv = ["--config", os.path.join(ROOT, "configs", "moe_small.yaml"),
                "--moe_impl", "dropless", "--max_steps", "3",
                "--log_interval", "1", "--eval_batches", "1",
                "--no_auto_resume", "--checkpoint_dir",
                os.path.join(tmp, "m")]
    moe = _cli_in_process("cli", moe_argv)
    shutil.rmtree(os.path.join(tmp, "m"))
    moe_cfg = cli.resolve_configs(cli.build_parser().parse_args(moe_argv))[0]
    want = _micro_launches(moe_cfg, 3 * accum, accum, segmented=False)
    if moe["launches"] != want:
        raise AssertionError(f"cli: MoE launches {moe['launches']}, want "
                             f"{want}")
    rec["moe_launches"] = {k: v for k, v in moe["launches"].items() if v}
    log("cli", f"moe_small.yaml --moe_impl dropless, 3 steps + 1 eval batch "
               f"in {moe['seconds']:.1f} s: launches {rec['moe_launches']}")
    results["cli"] = rec
    return rec


def _top2_gap(ckpt_path, row, upto):
    """(top-1 minus top-2 logit, max |logit|) of the next-token logits after
    ``row[:upto]``, from the checkpoint's model."""
    import dataclasses

    from tpu_trainer_torch.models.weights import build_model
    from tpu_trainer_torch.utils.checkpoint import restore_params

    params, config = restore_params(ckpt_path)
    config = dataclasses.replace(config, dropout=0.0, attention_dropout=0.0)
    model = build_model(config, params, "cuda")
    with torch.no_grad():
        logits, _ = model(torch.tensor([row[:upto]], device="cuda"))
    last = logits[0, -1]
    top = torch.topk(last, 2).values
    return float(top[0] - top[1]), float(last.abs().max())


def phase_infer(results: dict, tmp: str, new: int = 64) -> dict:
    """``eval.infer.main`` on the cli phase's checkpoints, greedy: the KV
    path and ``--serve`` on the checkpoint root (its compute dtype, bf16),
    then both on the consolidated export beside a ``meta.json`` whose
    model computes in f32; their greedy tokens must be equal (a differing
    token passes only at a tie: a top-2 logit gap below 1e-5 x the logits'
    absolute maximum). ``--serve``'s flash-decode launches must be exact:
    (new tokens - 1) x layers."""
    from tpu_trainer_torch.eval import infer
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    card = nvidia_smi_line()
    root = os.path.join(tmp, "a")
    step8 = ckpt_lib.latest_checkpoint(root)
    meta = ckpt_lib.load_meta(step8)
    layers = meta["model_config"]["num_layers"]
    params, _ = ckpt_lib.restore_params(step8)
    f32_dir = os.path.join(tmp, "f32")
    os.makedirs(f32_dir)
    export = ckpt_lib.export_consolidated(f32_dir, params)
    del params
    meta["model_config"]["dtype"] = "float32"
    with open(os.path.join(f32_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "stories.txt")) as f:
        stories = [next(f) for _ in range(4)]
    prompts = os.path.join(tmp, "prompts.txt")
    with open(prompts, "w") as f:
        for i, s in enumerate(stories):
            f.write(" ".join(s.split()[:4 + 3 * i]) + "\n")
    rec = {"nvidia_smi": card, "max_new_tokens": new}
    for where, path, dtype in (("root", root, None),
                               ("consolidated", export, "float32")):
        outs = {}
        for mode in ("kv", "serve"):
            argv = ["--checkpoint", path, "--prompt_file", prompts,
                    "--tokenizer", "byte", "--temperature", "0",
                    "--max_new_tokens", str(new)]
            argv += ["--serve"] if mode == "serve" else []
            res = {}
            torch.cuda.synchronize()
            flash.flash_decode.launches = 0
            t0 = time.perf_counter()
            rc = infer.main(argv, result=res)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = flash.flash_decode.launches
            if rc != 0:
                raise AssertionError(f"infer: {where} {mode} exited {rc}")
            want = (new - 1) * layers if mode == "serve" else 0
            if launched != want or (mode == "serve" and
                                    res["stats"]["decode_iters"] != new - 1):
                raise AssertionError(
                    f"infer: {where} {mode}: flash_decode launches "
                    f"{launched}, want {want}")
            lens = [len(t) for t in res["tokens"]]
            outs[mode] = res["tokens"]
            rec[f"{where}_{mode}"] = {"s": secs, "launches": launched,
                                      "lengths": lens}
            log("infer", f"{where} ({dtype or 'checkpoint dtype'}) {mode}: "
                         f"{len(lens)} prompts, {new} new tokens each in "
                         f"{secs:.2f} s, flash_decode launches {launched}")
        if dtype == "float32":
            ties = []
            for r, (a, b) in enumerate(zip(outs["kv"], outs["serve"])):
                if a == b:
                    continue
                pos = next(i for i, (x, y) in enumerate(zip(a, b))
                           if x != y)
                gap, scale = _top2_gap(export, a, pos)
                log("infer", f"row {r} differs at position {pos}: top-2 "
                             f"gap {gap:.3e}, |logits| max {scale:.3e}")
                if not gap < 1e-5 * scale:
                    raise AssertionError(
                        f"infer: f32 greedy tokens of the KV path and "
                        f"--serve differ at row {r} position {pos} with a "
                        f"top-2 gap {gap:.3e} (not a tie)")
                ties.append({"row": r, "pos": pos, "gap": gap})
            rec["f32_ties"] = ties
            log("infer", f"f32 greedy tokens of the KV path and --serve: "
                         f"{'equal' if not ties else f'{len(ties)} ties'} "
                         f"on {card}")
    results["infer"] = rec
    return rec


# -- phases 18-20: remat, host offload, MoE under remat ------------------------

def _resume_check(phase: str, argv: list, tmp: str, last: int,
                  resume_at: int, entry: str = "train_ddp") -> dict:
    """Run ``argv`` here to step ``last`` (a save at ``resume_at``), move
    step ``last``'s checkpoint aside, rerun ``argv`` in a fresh process
    (``_cli_child``) and require that it resumed from ``resume_at`` and
    that step ``last``'s ``state.npz`` and ``meta.json`` and the losses
    of the steps after ``resume_at`` are bitwise equal. Returns run 1's
    and run 2's launches, run 1's JSONL train records and the seconds."""
    import numpy as np

    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    ckdir = argv[argv.index("--checkpoint_dir") + 1]
    jsonl = argv[argv.index("--metrics_jsonl") + 1]
    run1 = _cli_in_process(phase, argv)
    final = os.path.join(ckdir, f"step_{last:08d}")
    aside = os.path.join(tmp, f"{phase}_aside")
    os.replace(final, aside)
    out = os.path.join(tmp, f"{phase}_child.json")
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke._cli_child({argv!r}, {out!r})"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    run2_s = time.perf_counter() - t0
    for ln in child.stdout.splitlines():
        log(phase, f"  run 2 | {ln}")
    if child.returncode != 0:
        raise AssertionError(f"{phase}: run 2 exited {child.returncode}: "
                             f"{child.stderr[-3000:]}")
    with open(out) as f:
        run2 = json.load(f)
    if f"step_{resume_at:08d}" not in child.stdout:
        raise AssertionError(f"{phase}: run 2 did not resume from step "
                             f"{resume_at}")
    with np.load(os.path.join(final, "state.npz")) as a, np.load(
            os.path.join(aside, "state.npz")) as b:
        if a.files != b.files:
            raise AssertionError(f"{phase}: state arrays differ in name")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        n_arrays = len(a.files)
        dtypes = sorted({str(a[k].dtype) for k in a.files})
    if differ:
        raise AssertionError(f"{phase}: resumed step-{last} state not "
                             f"bitwise: {len(differ)} of {n_arrays} arrays "
                             f"differ, e.g. {differ[:5]}")
    if ckpt_lib.load_meta(final) != ckpt_lib.load_meta(aside):
        raise AssertionError(f"{phase}: resumed step-{last} meta differs")
    train = _jsonl(jsonl, "train")
    steps = [r["step"] for r in train]
    want = list(range(last)) + list(range(resume_at, last))
    if steps != want:
        raise AssertionError(f"{phase}: train records at steps {steps}")
    first = [r["loss"] for r in train[resume_at:last]]
    again = [r["loss"] for r in train[last:]]
    if first != again:
        raise AssertionError(f"{phase}: losses after step {resume_at} "
                             f"{first} vs resumed {again}")
    shutil.rmtree(aside)
    return {"run1": run1, "run2": run2, "run2_s": run2_s, "train": train,
            "evals": _jsonl(jsonl, "eval"), "state_arrays": n_arrays,
            "state_dtypes": dtypes}


def _remat_step(cfg, params, tokens):
    """One forward/backward of ``GPT`` at ``cfg`` on ``params``: (loss,
    f32-master gradients, the dropout generator's state after the step,
    ms on the host clock up to a synchronize, peak device memory above
    what was allocated before, launches)."""
    from torch import nn

    from tpu_trainer_torch.models.gpt import GPT

    model = GPT(cfg, device="meta")
    model.load_state_dict({n: nn.Parameter(t) for n, t in params.items()},
                          strict=True, assign=True)
    names, leaves = zip(*model.named_parameters())
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    _, loss = model(tokens, tokens, train=True, generator=gen)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return (loss.detach(), dict(zip(names, grads)), gen.get_state(), ms,
            peak, {k: c.launches for k, c in counters.items()})


def _naive_remat(self, x, p, step):
    """The planted fault: a checkpoint around the block whose recompute
    draws fresh dropout seeds from the step's generator."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(lambda x_in: self._train_block(x_in, p, step), x,
                      use_reentrant=False)


def phase_remat(results: dict, tmp: str) -> dict:
    """The 1B-on-one-card recipe: ``train_ddp --config
    configs/large_1b_single_chip.yaml`` unchanged in its model and
    training sections (36 layers, hidden 1280, 20 heads of 64, vocab
    50257, batch 4 x 1024, full remat, bf16 Adam moments, dropout 0.1) on
    the cli phase's corpus: 6 steps with a save at step 3, then the same
    command in a fresh process resumes from step 3, and step 6's state and
    the losses of steps 4-6 must be bitwise equal; launches exact (the
    flash forward twice a layer a micro-batch). Then at the same width one
    step's gradients without remat, with full remat and with "dots": the
    remat ones bitwise equal to the plain one (loss, every gradient, the
    generator after the step), the planted fault (fresh seeds in the
    recompute) rejected; peak memory and step time of each; and the
    device busy share of two profiled trainer steps."""
    import dataclasses

    from tpu_trainer_torch.data.dummy import DummyDataLoader
    from tpu_trainer_torch.models.gpt import GPT
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import Trainer

    card = nvidia_smi_line()
    corpus = os.path.join(tmp, "stories.txt")
    large = os.path.join(ROOT, "configs", "large_1b_single_chip.yaml")
    argv = ["--config", large, "--dataset", "tinystories", "--data_path",
            corpus, "--tokenizer", "byte", "--log_interval", "1",
            "--eval_batches", "1", "--eval_interval", "0",
            "--max_steps", "6", "--save_interval", "3", "--keep_last_n", "0",
            "--checkpoint_dir", os.path.join(tmp, "r"),
            "--metrics_jsonl", os.path.join(tmp, "r.jsonl")]
    cfg, tc, _, _ = cli.resolve_configs(cli.build_parser().parse_args(argv))
    if not (cfg.gradient_checkpointing and cfg.remat_policy == "full"
            and tc.optimizer_state_dtype == "bfloat16"
            and cfg.num_layers == 36 and cfg.hidden_size == 1280):
        raise AssertionError(f"remat: {large} resolved to {cfg}, {tc}")
    log("remat", f"{os.path.basename(large)}: {cfg.num_parameters():,} "
                 f"params, batch {tc.gradient_accumulation_steps} x "
                 f"{tc.batch_size} x {tc.max_seq_len}, remat "
                 f"{cfg.remat_policy}, moments {tc.optimizer_state_dtype}")
    res = _resume_check("remat", argv, tmp, 6, 3)
    shutil.rmtree(os.path.join(tmp, "r"))
    n_eval = res["evals"][-1]["eval_batches"]
    want1 = _micro_launches(cfg, 6, n_eval, segmented=False)
    want2 = _micro_launches(cfg, 3, n_eval, segmented=False)
    if (res["run1"]["launches"] != want1
            or res["run2"]["launches"] != want2):
        raise AssertionError(f"remat: launches {res['run1']['launches']} "
                             f"/ {res['run2']['launches']}, want {want1} / "
                             f"{want2}")
    train = res["train"][:6]
    steady = [r for r in train if r["step"] in (1, 2, 4, 5)]
    tok_s = statistics.median(r["tokens_per_sec"] for r in steady)
    util = statistics.median(r["mfu"] for r in steady)
    rec = {"nvidia_smi": card, "losses": [r["loss"] for r in train],
           "tokens_per_sec": [r["tokens_per_sec"] for r in train],
           "tokens_per_sec_median": tok_s, "mfu_median": util,
           "peak_mem_gib": max(r["peak_mem_gb"] for r in train),
           "state_arrays_bitwise": res["state_arrays"],
           "state_dtypes": res["state_dtypes"],
           "run1_s": res["run1"]["seconds"], "run2_s": res["run2_s"],
           "launches_run1": {k: v for k, v in
                             res["run1"]["launches"].items() if v}}
    log("remat", f"resume bitwise: {res['state_arrays']} state arrays "
                 f"({', '.join(res['state_dtypes'])}: bf16 moments as their "
                 f"bits) of step 6 and the losses of steps 4-6 equal after a "
                 f"restart at step 3; launches {rec['launches_run1']} (6 "
                 f"steps + {n_eval} eval batch) and run 2's exact")
    log("remat", "losses " + " ".join(f"{x:.4f}" for x in rec["losses"])
                 + f"; tok/s median of steps 2, 3, 5, 6 {tok_s:.0f}, MFU "
                   f"{util:.4f}, max_memory_allocated "
                   f"{rec['peak_mem_gib']:.2f} GiB on {card} (run 1 "
                   f"{rec['run1_s']:.1f} s, run 2 {rec['run2_s']:.1f} s "
                   f"with its process start and restore)")

    # One step at the same width without remat, with full and with dots.
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device="cuda")
    batch = next(iter(DummyDataLoader(tc.batch_size, tc.max_seq_len,
                                      cfg.vocab_size, 1)))
    tokens = torch.as_tensor(batch, dtype=torch.long, device="cuda")
    variants = (("none", dataclasses.replace(cfg,
                                             gradient_checkpointing=False)),
                ("full", cfg),
                ("dots", dataclasses.replace(cfg, remat_policy="dots")))
    ref, steps = None, {}
    for name, c in variants:
        first = _remat_step(c, params, tokens)
        want = _want_launches(c, 1, segmented=False)
        timed = []
        for _ in range(3):                          # warm: timed
            again = _remat_step(c, params, tokens)
            timed.append(again[3:])
            del again
        if first[5] != want or any(t[2] != want for t in timed):
            raise AssertionError(f"remat: {name} step launches {first[5]}, "
                                 f"want {want}")
        steps[name] = {"ms": statistics.median(t[0] for t in timed),
                       "ms_all": [first[3]] + [t[0] for t in timed],
                       "peak_gb": max(t[1] for t in timed),
                       "loss": float(first[0])}
        if ref is None:
            ref = first
            continue
        differ = [n for n in ref[1] if not torch.equal(ref[1][n], first[1][n])]
        if (differ or not torch.equal(ref[0], first[0])
                or not torch.equal(ref[2], first[2])):
            raise AssertionError(
                f"remat: {name} step not bitwise the plain step: loss "
                f"{float(first[0])} vs {float(ref[0])}, {len(differ)} "
                f"gradients differ, e.g. {differ[:5]}")
        del first
    original = GPT._remat_block
    GPT._remat_block = _naive_remat
    try:
        fault = _remat_step(cfg, params, tokens)
    finally:
        GPT._remat_block = original
    caught = [n for n in ref[1] if not torch.equal(ref[1][n], fault[1][n])]
    if not caught:
        raise AssertionError("remat: the planted fault (fresh seeds in the "
                             "recompute) gave the plain step's gradients")
    rec["one_step"] = steps
    rec["planted_fault_gradients_differ"] = len(caught)
    for name, v in steps.items():
        log("remat", f"one step, {name:4s}: {v['ms']:.1f} ms (median of 3 "
                     f"warm; all: " + " ".join(f"{x:.0f}" for x in
                                               v["ms_all"])
                     + f"), peak {v['peak_gb']:.2f} GB above "
                     f"the f32 params, loss {v['loss']:.6f} on {card}")
    log("remat", f"full and dots: loss, all {len(ref[1])} gradients and the "
                 f"generator bitwise the plain step's; the planted fault "
                 f"moved {len(caught)} gradients")
    del ref, fault, params, tokens
    torch.cuda.empty_cache()

    # Trainer steps: the median of 5 after a warm-up (one host stall can
    # take seconds), then two profiled steps: device busy share, launches
    # and the top kernels.
    trainer = Trainer(cfg, tc, device="cuda")
    state = trainer.init_state(0)
    batches = [trainer.put_batch(b) for b in DummyDataLoader(
        tc.batch_size, tc.max_seq_len, cfg.vocab_size, 8)]
    times = []
    for b in batches[:6]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.train_step(state, b)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    step_ms = statistics.median(times[1:])
    rec["trainer_step_ms"] = times
    rec["profile"] = prof = _profile_steps(trainer, state, batches[6:8],
                                           step_ms)
    log("profile", f"remat: trainer step {step_ms:.1f} ms (median of steps "
                   f"2-6; all: " + " ".join(f"{x:.0f}" for x in times)
                   + f"); 2 profiled steps: device busy "
                     f"{prof['device_busy_ms_per_step']:.1f} ms a step = "
                     f"{prof['device_busy_frac_of_step']:.3f} of the step, "
                     f"{prof['kernel_launches_per_step']:.0f} launches a "
                     f"step on {card}")
    for g, ms_g in prof["groups_ms_per_step"].items():
        log("profile", f"  group  {ms_g:8.3f} ms/step  {g}")
    for k in prof["kernels"][:8]:
        log("profile", f"  device {k['ms_per_step']:8.3f} ms/step "
                       f"x{k['count']:<5} {k['name']}")
    del trainer, state, batches
    torch.cuda.empty_cache()
    results["remat"] = rec
    return rec


OFFLOAD_VARIANTS = (
    ("device", []),
    ("float32", ["--cpu_offload", "--offload_dtype", "float32"]),
    ("bfloat16", ["--cpu_offload", "--offload_dtype", "bfloat16"]),
    ("int8", ["--cpu_offload", "--offload_dtype", "int8"]),
    ("int8_budget", ["--cpu_offload", "--offload_dtype", "int8",
                     "--offload_budget_gb", "0.5"]),
)
# tests/test_offload.py's bound on a narrow-storage loss trajectory.
OFFLOAD_RTOL = 0.05


def _fsdp_run(phase: str, argv: list) -> dict:
    """``train_fsdp.main(argv)`` with the launches zeroed before and read
    after, its stdout kept, and each ``Trainer.train_step`` timed up to a
    synchronize with the step's host-link bytes and copy times."""
    import contextlib
    import io

    from tpu_trainer_torch.training import train_fsdp
    from tpu_trainer_torch.training.trainer import Trainer

    original = Trainer.train_step
    seen = {"steps": []}

    def timed(self, state, batch, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = original(self, state, batch, *args, **kwargs)
        torch.cuda.synchronize()
        seen["trainer"] = self
        seen["steps"].append({"ms": 1e3 * (time.perf_counter() - t0),
                              "link": self.last_link_ms(),
                              "bytes": self.offload_stream_bytes})
        return state, m

    class Tee(io.StringIO):
        def write(self, text):
            sys.__stdout__.write(text)
            return super().write(text)

    out = Tee()
    Trainer.train_step = timed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with contextlib.redirect_stdout(out):
            run = _cli_in_process(phase, argv, entry=train_fsdp.main)
    finally:
        Trainer.train_step = original
    run.update(seen, stdout=out.getvalue(),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return run


def phase_offload(results: dict, tmp: str) -> dict:
    """``train_fsdp --config configs/medium_model.yaml`` at its full width
    (24 layers, hidden 1024, 16 heads, batch 8 x 4 x 1024, FULL_SHARD at
    one process, remat on by default, its dummy data), 3 steps on the
    card and with the Adam moments offloaded to pinned host memory in
    float32, bfloat16, int8 and int8 with 0.5 GB kept on the device:
    f32 offload's step-3 params and moments bitwise the on-device run's;
    bf16 and int8 losses within OFFLOAD_RTOL of it; the partial offload's
    startup line equal to ``select_resident_moments``; launches exact.
    Prints the bytes streamed each way a step, the copy times (CUDA
    events), the implied GB/s, the step time and the peak memory of each
    variant."""
    import numpy as np

    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import select_resident_moments

    card = nvidia_smi_line()
    medium = os.path.join(ROOT, "configs", "medium_model.yaml")
    base = ["--config", medium, "--max_steps", "3", "--log_interval", "1",
            "--eval_interval", "0", "--eval_batches", "1", "--num_batches",
            "4", "--no_auto_resume"]
    runs = {}
    for name, extra in OFFLOAD_VARIANTS:
        argv = base + extra + ["--checkpoint_dir",
                               os.path.join(tmp, f"o_{name}"),
                               "--metrics_jsonl",
                               os.path.join(tmp, f"o_{name}.jsonl")]
        cfg, tc, par, _ = cli.resolve_configs(
            cli.build_parser("fsdp").parse_args(argv), "fsdp")
        run = _fsdp_run("offload", argv)
        accum = tc.gradient_accumulation_steps
        want = _micro_launches(cfg, 3 * accum, accum, segmented=False)
        if run["launches"] != want:
            raise AssertionError(f"offload: {name} launches "
                                 f"{run['launches']}, want {want}")
        if not (cfg.gradient_checkpointing and cfg.num_layers == 24
                and par.sharding_strategy == "FULL_SHARD"):
            raise AssertionError(f"offload: {medium} resolved to {cfg}, "
                                 f"{par}")
        run["losses"] = [r["loss"] for r in _jsonl(argv[-1], "train")]
        if name != "int8_budget":
            del run["trainer"]              # its parameters' memory
        runs[name] = run
        if name not in ("device", "float32"):
            shutil.rmtree(os.path.join(tmp, f"o_{name}"))

    # f32 offload: the on-device run's step-3 state, bitwise.
    paths = [os.path.join(tmp, f"o_{n}", "step_00000003", "state.npz")
             for n in ("device", "float32")]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        differ = [k for k in a.files if a.files != b.files
                  or not np.array_equal(a[k], b[k])]
        n_arrays = len(a.files)
    if differ:
        raise AssertionError(f"offload: f32 offload's step-3 state differs "
                             f"from the on-device run's in {differ[:5]}")
    for n in ("device", "float32"):
        shutil.rmtree(os.path.join(tmp, f"o_{n}"))
    if runs["float32"]["losses"] != runs["device"]["losses"]:
        raise AssertionError("offload: f32 offload losses differ")
    exact = np.array(runs["device"]["losses"])
    for name in ("bfloat16", "int8", "int8_budget"):
        got = np.array(runs[name]["losses"])
        if not np.allclose(got, exact, rtol=OFFLOAD_RTOL, atol=0):
            raise AssertionError(f"offload: {name} losses {got} vs "
                                 f"{exact} (rtol {OFFLOAD_RTOL})")
    trainer = runs["int8_budget"]["trainer"]
    _, kept = select_resident_moments(trainer._moment_shapes(),
                                      int(0.5 * 2**30))
    line = f"partial offload: {kept / 2**30:.2f} GB of optimizer moments"
    if (trainer.offload_resident_bytes != kept or kept == 0
            or line not in runs["int8_budget"]["stdout"]):
        raise AssertionError(f"offload: resident bytes "
                             f"{trainer.offload_resident_bytes} vs "
                             f"select_resident_moments {kept}")

    rec = {"nvidia_smi": card, "state_arrays_bitwise": n_arrays,
           "resident_bytes": kept, "variants": {}}
    for name, run in runs.items():
        later = run["steps"][1:]
        link = [s["link"] for s in later if s["link"]]
        v = {"losses": run["losses"], "peak_gb": run["peak_gb"],
             "step_ms": [s["ms"] for s in run["steps"]],
             "step_ms_median_2_3": statistics.median(s["ms"] for s in later),
             "launches": {k: x for k, x in run["launches"].items() if x}}
        if link:
            nbytes = run["steps"][-1]["bytes"]
            h2d = statistics.median(x["h2d_ms"] for x in link)
            d2h = statistics.median(x["d2h_ms"] for x in link)
            v.update(bytes_each_way=nbytes, h2d_ms=h2d, d2h_ms=d2h,
                     h2d_gb_s=nbytes / h2d / 1e6, d2h_gb_s=nbytes / d2h / 1e6)
        rec["variants"][name] = v
        log("offload", f"{name:11s}: step {v['step_ms_median_2_3']:.1f} ms "
                       f"(median of steps 2-3), peak {v['peak_gb']:.2f} GB, "
                       f"losses " + " ".join(f"{x:.5f}" for x in v["losses"])
                       + (f"; {v['bytes_each_way'] / 1e9:.3f} GB each way a "
                          f"step, H2D {v['h2d_ms']:.1f} ms "
                          f"({v['h2d_gb_s']:.1f} GB/s), D2H "
                          f"{v['d2h_ms']:.1f} ms ({v['d2h_gb_s']:.1f} GB/s)"
                          if link else "") + f" on {card}")
    log("offload", f"f32 offload bitwise the on-device run ({n_arrays} "
                   f"state arrays at step 3); bf16 and int8 losses within "
                   f"rtol {OFFLOAD_RTOL}; partial offload keeps "
                   f"{kept / 2**30:.2f} GiB as select_resident_moments "
                   f"picks; launches {rec['variants']['device']['launches']}")
    results["offload"] = rec
    return rec


def phase_moe_remat(results: dict, tmp: str) -> dict:
    """``configs/moe_small.yaml --moe_impl dropless
    --gradient_checkpointing`` at full depth, 2 steps: gmm 9 a layer a
    micro-batch (3 forward, 3 recompute, 3 dgrad), tgmm 3, the flash
    forward twice."""
    from tpu_trainer_torch.training import cli

    argv = ["--config", os.path.join(ROOT, "configs", "moe_small.yaml"),
            "--moe_impl", "dropless", "--gradient_checkpointing",
            "--max_steps", "2", "--log_interval", "1", "--eval_batches", "1",
            "--no_auto_resume", "--checkpoint_dir",
            os.path.join(tmp, "mr"), "--metrics_jsonl",
            os.path.join(tmp, "mr.jsonl")]
    cfg, tc, _, _ = cli.resolve_configs(cli.build_parser().parse_args(argv))
    torch.cuda.empty_cache()
    run = _cli_in_process("moe-remat", argv)
    shutil.rmtree(os.path.join(tmp, "mr"))
    accum = tc.gradient_accumulation_steps
    want = _micro_launches(cfg, 2 * accum, accum, segmented=False)
    if run["launches"] != want or not cfg.gradient_checkpointing:
        raise AssertionError(f"moe-remat: launches {run['launches']}, want "
                             f"{want}")
    losses = [r["loss"] for r in _jsonl(argv[-1], "train")]
    rec = {"launches": {k: v for k, v in run["launches"].items() if v},
           "losses": losses, "seconds": run["seconds"]}
    log("moe-remat", f"moe_small.yaml dropless under full remat, 2 steps + 1 "
                     f"eval batch in {run['seconds']:.1f} s: losses "
                     + " ".join(f"{x:.4f}" for x in losses)
                     + f"; launches {rec['launches']} as the path must make "
                       f"them")
    results["moe_remat"] = rec
    return rec


# -- phase 21: fault tolerance and the run's telemetry ---------------------------

def _ft_child(argv: list, out: str, t0: float) -> None:
    """One restarted run of the ft phase in a fresh process (``t0``: the
    wall clock as the interpreter began): times its imports, CUDA init and
    kernel loading, then ``train_ddp.main(argv)`` with the launch counts
    zeroed. The times up to the first step's end are written to ``out``
    as soon as that step ends (an injected kill may end the process
    later); the exit code and the launches, when ``main`` returns."""
    t_chip = time.time()
    from tpu_trainer_torch.ops import _build
    from tpu_trainer_torch.training import train_ddp
    from tpu_trainer_torch.training.trainer import Trainer

    t_imports = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.time()
    for name in _build.SOURCES:
        _build.load(name)
    t_kernels = time.time()
    times = {"t0": t0, "imports_s": t_imports - t0,
             "chip_smoke_import_s": t_chip - t0,
             "cuda_init_s": t_cuda - t_imports,
             "kernel_load_s": t_kernels - t_cuda}
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    original = Trainer.train_step

    def first_step(self, state, batch, *args, **kwargs):
        result = original(self, state, batch, *args, **kwargs)
        if "first_step_end" not in times:
            torch.cuda.synchronize()
            times["first_step_end"] = time.time()
            with open(out, "w") as f:
                json.dump(times, f)
        return result

    Trainer.train_step = first_step
    rc = train_ddp.main(argv)
    torch.cuda.synchronize()
    times.update(rc=rc, launches={k: c.launches
                                  for k, c in counters.items()})
    with open(out, "w") as f:
        json.dump(times, f)


def _ft_spawn(tag: str, argv: list, tmp: str, rc_want: int) -> dict:
    """``_ft_child(argv)`` in a fresh process; its exit code must be
    ``rc_want`` (an injected kill: ``faults.KILL_EXIT_CODE``)."""
    out = os.path.join(tmp, f"ft_{tag}.json")
    code = ("import time; t0 = time.time(); import chip_smoke; "
            f"chip_smoke._ft_child({argv!r}, {out!r}, t0)")
    t_spawn = time.time()
    child = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
    for ln in child.stdout.splitlines():
        log("ft", f"  {tag} | {ln}")
    if child.returncode != rc_want:
        raise AssertionError(f"ft: {tag} exited {child.returncode}, want "
                             f"{rc_want}: {child.stderr[-3000:]}")
    rec = {"stdout": child.stdout, "rc": child.returncode}
    if os.path.exists(out):
        with open(out) as f:
            rec.update(json.load(f))
        rec["interpreter_s"] = rec["t0"] - t_spawn
        if "first_step_end" in rec:
            rec["to_first_step_s"] = rec["first_step_end"] - t_spawn
    return rec


def _restart_split(child: dict, jsonl: str) -> dict:
    """A restarted process's spawn-to-first-step time, split: the
    interpreter, imports, CUDA init, kernel loading, the restore and the
    first step (both from the run's own goodput ledger), the rest (the
    trainer, the data loader, the logger)."""
    gp = _jsonl(jsonl, "goodput")[0]
    split = {"interpreter_s": child["interpreter_s"],
             "torch_import_s": child["chip_smoke_import_s"],
             "port_import_s": (child["imports_s"]
                               - child["chip_smoke_import_s"]),
             "cuda_init_s": child["cuda_init_s"],
             "kernel_load_s": child["kernel_load_s"],
             "restore_s": gp.get("checkpoint_restore_seconds", 0.0),
             "first_step_s": gp.get("compile_seconds", 0.0)}
    split["other_s"] = child["to_first_step_s"] - sum(split.values())
    split["total_s"] = child["to_first_step_s"]
    return split


def _state_equal(phase: str, path: str, want: str) -> int:
    import numpy as np

    with np.load(os.path.join(path, "state.npz")) as a, np.load(
            os.path.join(want, "state.npz")) as b:
        if a.files != b.files:
            raise AssertionError(f"{phase}: state arrays differ in name")
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        if differ:
            raise AssertionError(f"{phase}: {path} not bitwise the straight "
                                 f"run's: {len(differ)} of {len(a.files)} "
                                 f"arrays differ, e.g. {differ[:4]}")
        return len(a.files)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_ft(results: dict, tmp: str) -> dict:
    """Fault tolerance and telemetry of the training CLI at GPT-2-small
    width (``configs/small_model.yaml`` on the cli phase's corpus, 8
    steps), held to the cli phase's straight run (its step-8 state and the
    losses of steps 1-8):

    - a chain of fresh processes, each a restart of the last:
      ``kill_in_save@4`` (exit 137, step 4 left without ``meta.json``),
      ``kill@5`` (resumes at step 2: the torn step is invisible; exit
      137), ``truncate_meta@6,kill@6`` with sync saves (resumes at step 4;
      exit 137), and a clean run that skips the truncated step 6, resumes
      at step 4 and ends with every loss and the step-8 state bitwise;
      each restart's time to its first step, split;
    - ``nan_loss@6``: one rollback record, exit 0, ``crash_report.json``
      holding the ring of records;
    - a preemption notice file present at launch: a drain after step 1,
      exit 143 with a complete checkpoint; the resumed run ends bitwise;
    - 8 steps with ``--telemetry_interval 2``, a 2-step profiling window
      and ``--metrics_port``: every second record carries
      ``telemetry/*`` scalars whose per-layer grad norms recombine to the
      record's ``grad_norm`` within 1e-5, the final state is bitwise, the
      launches exact, the Chrome trace holds the flash forward kernel's
      device events, one scrape finds the tokens/s gauge; then the
      analyzer on that JSONL (exit 0, the goodput table; ``--compare``
      against itself: PASS);
    - 2 steps under ``--gradient_checkpointing``: step 1's activation
      scalars bitwise the telemetry run's, once a layer;
    - ``moe_small.yaml --moe_impl dropless`` 2 telemetry steps: each
      layer's load fractions sum to 1 within 1e-6, drop_frac 0, gmm/tgmm
      launches exact;
    - ``--nan_scan`` on step 8's checkpoint with one inf planted in layer
      5's attention output projection names layer 5, site attn (the
      unplanted checkpoint: none), launching one forward a layer."""
    import numpy as np

    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import Trainer
    from tpu_trainer_torch.utils import faults

    card = nvidia_smi_line()
    corpus = os.path.join(tmp, "stories.txt")
    small = os.path.join(ROOT, "configs", "small_model.yaml")
    straight = os.path.join(tmp, "a", "step_00000008")
    ref = {r["step"]: r["loss"]
           for r in _jsonl(os.path.join(tmp, "a.jsonl"), "train")[:8]}
    base = ["--config", small, "--dataset", "tinystories", "--data_path",
            corpus, "--tokenizer", "byte", "--log_interval", "1",
            "--max_steps", "8", "--eval_interval", "0", "--eval_batches",
            "1", "--keep_last_n", "0"]
    cfg, tc, _, _ = cli.resolve_configs(cli.build_parser().parse_args(base))
    accum = tc.gradient_accumulation_steps
    rec = {"nvidia_smi": card, "section_s": {}}
    ft_launches: dict = {}
    last = [time.perf_counter()]

    def lap(name) -> str:
        now = time.perf_counter()
        rec["section_s"][name] = now - last[0]
        last[0] = now
        return f" [{rec['section_s'][name]:.1f} s]"

    def ft_dir(name):
        return ["--checkpoint_dir", os.path.join(tmp, f"ft_{name}"),
                "--metrics_jsonl", os.path.join(tmp, f"ft_{name}.jsonl")]

    def losses(*names):
        got = {}
        for n in names:
            got.update({r["step"]: r["loss"] for r in
                        _jsonl(os.path.join(tmp, f"ft_{n}.jsonl"), "train")})
        return got

    # -- kills, a torn save, a truncated meta: a chain of restarts --------
    ck = os.path.join(tmp, "ft_k")
    chain = [("p1", ["--inject_fault", "kill_in_save@4"], None),
             ("p2", ["--inject_fault", "kill@5",
                     "--no_async_checkpointing"], 2),
             ("p3", ["--inject_fault", "truncate_meta@6,kill@6",
                     "--no_async_checkpointing"], 4),
             ("p4", [], 4)]
    children = {}
    for tag, extra, resumes in chain:
        argv = base + ["--save_interval", "2", "--checkpoint_dir", ck,
                       "--metrics_jsonl", os.path.join(tmp, f"ft_{tag}.jsonl"),
                       *extra]
        rc_want = 0 if tag == "p4" else faults.KILL_EXIT_CODE
        child = children[tag] = _ft_spawn(tag, argv, tmp, rc_want)
        said = (f"resumed from {os.path.join(ck, f'step_{resumes:08d}')}"
                if resumes is not None else None)
        if (said is None) != ("resumed from" not in child["stdout"]) or (
                said is not None and said not in child["stdout"]):
            raise AssertionError(f"ft: {tag} resumed wrongly (want step "
                                 f"{resumes}): {child['stdout'][-2000:]}")
        if tag == "p1" and (
                not os.path.exists(os.path.join(ck, "step_00000004",
                                                "state.npz"))
                or os.path.exists(os.path.join(ck, "step_00000004",
                                               "meta.json"))):
            raise AssertionError("ft: kill_in_save@4 left no torn step 4")
        if tag == "p3" and os.path.getsize(
                os.path.join(ck, "step_00000006", "meta.json")) != 0:
            raise AssertionError("ft: truncate_meta@6 left meta.json whole")
    got = losses("p1", "p2", "p3", "p4")
    if got != ref:
        raise AssertionError(f"ft: restarted losses {got} vs the straight "
                             f"run's {ref}")
    n_arrays = _state_equal("ft", os.path.join(ck, "step_00000008"),
                            straight)
    p4 = children["p4"]
    n_eval = _jsonl(os.path.join(tmp, "ft_p4.jsonl"), "eval")[-1][
        "eval_batches"]
    want = _micro_launches(cfg, 4 * accum, n_eval * accum, segmented=False)
    if p4["launches"] != want:
        raise AssertionError(f"ft: resumed run launches {p4['launches']}, "
                             f"want {want}")
    _add_launches(ft_launches, p4["launches"])
    rec["restart"] = {tag: _restart_split(children[tag], os.path.join(
        tmp, f"ft_{tag}.jsonl")) for tag in ("p2", "p3", "p4")}
    shutil.rmtree(ck)
    log("ft", f"kill_in_save@4 -> 137, kill@5 -> 137 (resumed at 2), "
              f"truncate_meta@6 -> skipped (resumed at 4 twice): the losses "
              f"of steps 1-8 and {n_arrays} step-8 state arrays bitwise the "
              f"straight run's; the last run's launches "
              f"{ {k: v for k, v in want.items() if v} }" + lap("kills"))
    for tag, sp in rec["restart"].items():
        log("ft", f"restart {tag}: spawn to first step {sp['total_s']:.2f} s"
                  f" = interpreter {sp['interpreter_s']:.2f} + imports "
                  f"(torch {sp['torch_import_s']:.2f}, the port "
                  f"{sp['port_import_s']:.2f}) + CUDA init "
                  f"{sp['cuda_init_s']:.2f}"
                  f" + kernel load {sp['kernel_load_s']:.3f} + restore "
                  f"{sp['restore_s']:.2f} + first step "
                  f"{sp['first_step_s']:.2f} + other {sp['other_s']:.2f} on "
                  f"{card}")

    # -- a NaN rolls back ------------------------------------------------
    calls = {"n": 0}
    original = Trainer.train_step

    def counted(self, state, batch, *args, **kwargs):
        calls["n"] += 1
        return original(self, state, batch, *args, **kwargs)

    Trainer.train_step = counted
    try:
        run = _cli_in_process("ft", base + [
            "--save_interval", "2", "--guard_interval", "1",
            "--inject_fault", "nan_loss@6", "--flight_recorder_steps", "64",
            *ft_dir("nan")])
    finally:
        Trainer.train_step = original
    rollbacks = _jsonl(os.path.join(tmp, "ft_nan.jsonl"), "rollback")
    report = json.load(open(os.path.join(tmp, "ft_nan", "crash_report.json")))
    n_eval = _jsonl(os.path.join(tmp, "ft_nan.jsonl"), "eval")[-1][
        "eval_batches"]
    want = _micro_launches(cfg, calls["n"] * accum, n_eval * accum,
                           segmented=False)
    if (len(rollbacks) != 1 or rollbacks[0]["restored_step"] != 6
            or report["reason"] != "rollback:FloatingPointError"
            or not report["records"]
            or report["records"][-1]["kind"] != "rollback"
            or run["launches"] != want or not os.path.exists(os.path.join(
                tmp, "ft_nan", "step_00000008", "meta.json"))):
        raise AssertionError(f"ft: nan rollback {rollbacks}, crash report "
                             f"{report['reason']} with "
                             f"{len(report['records'])} records, launches "
                             f"{run['launches']} want {want}")
    _add_launches(ft_launches, run["launches"])
    shutil.rmtree(os.path.join(tmp, "ft_nan"))
    rec["nan_rollback"] = {"steps_run": calls["n"],
                           "ring_records": len(report["records"])}
    log("ft", f"nan_loss@6: one rollback to step 6, {calls['n']} steps run, "
              f"exit 0; crash_report.json holds {len(report['records'])} "
              f"records ending in the rollback" + lap("nan_rollback"))

    # -- a preemption notice ---------------------------------------------
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    notice = os.path.join(tmp, "ft_notice")
    with open(notice, "w") as f:
        json.dump({"deadline_s": 60.0}, f)
    run = _cli_in_process("ft", base + [
        "--save_interval", "2", "--preempt_notice", f"file:{notice}",
        "--preempt_vote_interval", "1", "--preemption_grace_s", "60",
        *ft_dir("pre")], rc_want=143)
    want = _micro_launches(cfg, accum, 0, segmented=False)
    if run["launches"] != want:
        raise AssertionError(f"ft: drained run launches {run['launches']}, "
                             f"want {want}")
    _add_launches(ft_launches, run["launches"])
    pre = os.path.join(tmp, "ft_pre")
    meta = ckpt_lib.load_meta(ckpt_lib.latest_checkpoint(pre))
    if meta["step"] != 1 or meta["data_state"]["batch_index"] != 1:
        raise AssertionError(f"ft: the notice drain saved {meta['step']}")
    run = _cli_in_process("ft", base + ["--save_interval", "2",
                                        *ft_dir("pre")])
    n_eval = _jsonl(os.path.join(tmp, "ft_pre.jsonl"), "eval")[-1][
        "eval_batches"]
    want = _micro_launches(cfg, 7 * accum, n_eval * accum, segmented=False)
    if run["launches"] != want:
        raise AssertionError(f"ft: resumed run launches {run['launches']}, "
                             f"want {want}")
    _add_launches(ft_launches, run["launches"])
    _state_equal("ft", os.path.join(pre, "step_00000008"), straight)
    if losses("pre") != ref:
        raise AssertionError(f"ft: drained + resumed losses {losses('pre')}")
    shutil.rmtree(pre)
    log("ft", "preemption notice at launch: drained after step 1, exit 143 "
              "with a complete step-1 checkpoint; resumed to step 8 bitwise"
        + lap("notice"))

    # -- telemetry, a profiling window, live metrics ---------------------
    import threading
    import urllib.request

    import tpu_trainer_torch.obs.http as http_mod
    from tpu_trainer_torch.utils.logging import MetricLogger

    servers, scraped, steps = [], {}, []
    real_server, real_log = http_mod.MetricsServer, MetricLogger.log

    class Spy(real_server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    def scrape_once(self, step, metrics, *args, **kwargs):
        out = real_log(self, step, metrics, *args, **kwargs)
        if out is not None and "body" not in scraped:
            def get():
                with urllib.request.urlopen(servers[0].url + "/metrics",
                                            timeout=10) as r:
                    scraped["body"] = r.read().decode()
            t = threading.Thread(target=get)
            t.start()
            t.join(15)
        return out

    def timed(self, state, batch, *args, **kwargs):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = original(self, state, batch, *args, **kwargs)
        ev[1].record()
        torch.cuda.synchronize()
        steps.append({"telemetry": bool(kwargs.get("telemetry")),
                      "wall_ms": 1e3 * (time.perf_counter() - t0),
                      "device_ms": ev[0].elapsed_time(ev[1])})
        return out

    from tpu_trainer_torch.utils import profiling

    real_stop, export = profiling._stop_trace, {}

    def timed_stop(*args):
        t0 = time.perf_counter()
        path = real_stop(*args)
        export["s"] = time.perf_counter() - t0
        return path

    port = _free_port()
    prof_dir = os.path.join(tmp, "ft_prof")
    http_mod.MetricsServer, MetricLogger.log = Spy, scrape_once
    Trainer.train_step, profiling._stop_trace = timed, timed_stop
    try:
        run = _cli_in_process("ft", base + [
            "--save_interval", "8", "--telemetry_interval", "2",
            "--profile_dir", prof_dir, "--profile_start", "4",
            "--profile_steps", "2", "--metrics_port", str(port),
            *ft_dir("tel")])
    finally:
        http_mod.MetricsServer, MetricLogger.log = real_server, real_log
        Trainer.train_step, profiling._stop_trace = original, real_stop
    tel_jsonl = os.path.join(tmp, "ft_tel.jsonl")
    train = _jsonl(tel_jsonl, "train")
    n_eval = _jsonl(tel_jsonl, "eval")[-1]["eval_batches"]
    want = _micro_launches(cfg, 8 * accum, n_eval * accum, segmented=False)
    if run["launches"] != want:
        raise AssertionError(f"ft: telemetry run launches {run['launches']},"
                             f" want {want}")
    _add_launches(ft_launches, run["launches"])
    _state_equal("ft", os.path.join(tmp, "ft_tel", "step_00000008"),
                 straight)
    if {r["step"]: r["loss"] for r in train} != ref:
        raise AssertionError("ft: the telemetry run's losses moved")
    worst = 0.0
    for r in train:
        keys = [k for k in r if k.startswith("telemetry/")]
        if bool(keys) != (r["step"] % 2 == 1):
            raise AssertionError(f"ft: step {r['step']} telemetry keys "
                                 f"{len(keys)}")
        if not keys:
            continue
        per = [k for k in keys if k.startswith("telemetry/grad_norm/")]
        layers = [k for k in per if "/per_layer/" in k]
        if len(layers) != cfg.num_layers:
            raise AssertionError(f"ft: {len(layers)} per-layer grad norms")
        norm = math.sqrt(sum(r[k] ** 2 for k in per))
        worst = max(worst, abs(norm - r["grad_norm"]) / r["grad_norm"])
    if worst > 1e-5:
        raise AssertionError(f"ft: per-layer grad norms recombine to "
                             f"{worst:.2e} relative of grad_norm")
    host_dir = os.path.join(prof_dir, "host_0")
    (trace_name,) = os.listdir(host_dir)
    with open(os.path.join(host_dir, trace_name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash_ev = [e for e in kernels if "flash_fwd_tma_kernel" in e["name"]]
    marks = {e["name"] for e in events
             if str(e.get("name", "")).startswith("train_step_")}
    # The profiler may drop an event at the window's edge (one H100 run's
    # trace held 95 of the window's 96 forward launches), so the trace
    # must hold the forward's device events, not all of them.
    if not kernels or len(flash_ev) < cfg.num_layers or (
            marks != {"train_step_4", "train_step_5"}):
        raise AssertionError(f"ft: trace has {len(kernels)} kernel events, "
                             f"{len(flash_ev)} flash forward events, marks "
                             f"{sorted(marks)}")
    if "train_tokens_per_sec" not in scraped.get("body", ""):
        raise AssertionError("ft: the /metrics scrape found no tokens/s "
                             "gauge")
    # Device busy ms of the two traced steps (plain 4, telemetry 5): the
    # union of device activity inside each step's mark (each step ends in
    # a synchronize inside its mark).
    busy = {}
    for name in ("train_step_4", "train_step_5"):
        (mark,) = [e for e in events if e.get("name") == name
                   and e.get("cat") == "user_annotation"]
        lo, hi = mark["ts"], mark["ts"] + mark["dur"]
        spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset")
                       and e["ts"] < hi and e["ts"] + e["dur"] > lo)
        total, cur = 0.0, None
        for a, b in spans:
            if cur is None or a > cur[1]:
                total += 0 if cur is None else cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        busy[name] = (total + (cur[1] - cur[0] if cur else 0.0)) / 1e3
    wall = [x["wall_ms"] for x in steps]
    inside, outside = wall[4] + wall[5], (wall[2] + wall[3] + wall[6]
                                          + wall[7]) / 2
    # Outside the window (steps 0 and 1 warm the two kinds up).
    pm, tm = (wall[2] + wall[6]) / 2, (wall[3] + wall[7]) / 2
    rec["telemetry"] = {
        "recombine_rel_err": worst, "trace_kernel_events": len(kernels),
        "trace_flash_fwd_events": len(flash_ev),
        "window_flash_fwd_launches": 2 * accum * cfg.num_layers,
        "steps": steps,
        "plain_wall_ms": pm, "telemetry_wall_ms": tm,
        "plain_busy_ms": busy["train_step_4"],
        "telemetry_busy_ms": busy["train_step_5"],
        # Steps 4 (plain) and 5 (telemetry) ran under the profiler; 2, 3,
        # 6 and 7 are the same kinds outside it.
        "profile_overhead": inside / outside - 1.0,
        "profile_export_s": export["s"]}
    t = rec["telemetry"]
    log("ft", f"--telemetry_interval 2: 4 telemetry records, per-layer grad "
              f"norms recombine within {worst:.1e}; state and losses bitwise;"
              f" trace {len(kernels)} kernel events ({len(flash_ev)} "
              f"flash_fwd_tma_kernel), /metrics scraped on port {port}")
    log("ft", f"step wall (each to a synchronize; mean of steps 2 and 6, "
              f"3 and 7): plain {pm:.1f} ms, telemetry {tm:.1f} ms; device "
              f"busy under the "
              f"profiler: plain {t['plain_busy_ms']:.1f} ms, telemetry "
              f"{t['telemetry_busy_ms']:.1f} ms; the profiling window "
              f"{100 * t['profile_overhead']:+.1f}% on its 2 steps, its "
              f"trace written in {export['s']:.2f} s, on {card}")
    gp = [g for g in _jsonl(tel_jsonl, "goodput") if g.get("final")][0]
    rec["telemetry"]["goodput"] = gp

    # The report and the verdicts against itself, in one call.
    rep = subprocess.run([sys.executable, "-m",
                          "tpu_trainer_torch.tools.analyze", tel_jsonl,
                          "--compare", tel_jsonl], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    if (rep.returncode != 0 or "goodput" not in rep.stdout
            or "PASS" not in rep.stdout or "FAIL" in rep.stdout):
        raise AssertionError(f"ft: analyze exited {rep.returncode}: "
                             f"{rep.stdout[-2000:]} {rep.stderr[-2000:]}")
    for ln in rep.stdout.splitlines():
        if not ln.startswith("SKIP "):
            log("ft", f"  analyze | {ln}")
    log("ft", "telemetry, profiling, metrics, analyzer" + lap("telemetry"))
    shutil.rmtree(os.path.join(tmp, "ft_tel"))
    shutil.rmtree(prof_dir)

    # -- telemetry under remat -------------------------------------------
    run = _cli_in_process("ft", base + [
        "--max_steps", "2", "--save_interval", "0", "--telemetry_interval",
        "2", "--gradient_checkpointing", *ft_dir("remat")])
    rcfg = cli.resolve_configs(cli.build_parser().parse_args(
        base + ["--gradient_checkpointing"]))[0]
    n_eval = _jsonl(os.path.join(tmp, "ft_remat.jsonl"), "eval")[-1][
        "eval_batches"]
    want = _micro_launches(rcfg, 2 * accum, n_eval * accum, segmented=False)
    if run["launches"] != want:
        raise AssertionError(f"ft: remat launches {run['launches']}, want "
                             f"{want}")
    _add_launches(ft_launches, run["launches"])
    r1 = _jsonl(os.path.join(tmp, "ft_remat.jsonl"), "train")[1]
    t1 = train[1]
    act = sorted(k for k in t1 if k.startswith("telemetry/act/"))
    per_site = [k for k in act if k.startswith("telemetry/act/attn_rms/")]
    if (sorted(k for k in r1 if k.startswith("telemetry/act/")) != act
            or any(r1[k] != t1[k] for k in act)
            or len(per_site) != cfg.num_layers):
        raise AssertionError("ft: remat activation scalars differ from the "
                             "plain run's")
    shutil.rmtree(os.path.join(tmp, "ft_remat"), ignore_errors=True)
    log("ft", f"--gradient_checkpointing: step 1's {len(act)} activation "
              f"scalars bitwise the plain run's, one a layer a site"
        + lap("remat"))

    # -- MoE router telemetry ---------------------------------------------
    router = []

    def keep_router(self, state, batch, *args, **kwargs):
        state, m = original(self, state, batch, *args, **kwargs)
        if "telemetry" in m:
            router.append({k: v.detach().float().cpu()
                           for k, v in m["telemetry"]["router"].items()})
        return state, m

    moe_argv = ["--config", os.path.join(ROOT, "configs", "moe_small.yaml"),
                "--moe_impl", "dropless", "--max_steps", "2",
                "--telemetry_interval", "1", "--log_interval", "1",
                "--eval_batches", "1", "--no_auto_resume", *ft_dir("moe")]
    Trainer.train_step = keep_router
    try:
        run = _cli_in_process("ft", moe_argv)
    finally:
        Trainer.train_step = original
    moe_cfg = cli.resolve_configs(cli.build_parser().parse_args(moe_argv))[0]
    want = _micro_launches(moe_cfg, 2 * accum, accum, segmented=False)
    sums = torch.stack([r["load"].sum(dim=-1) for r in router])
    if (run["launches"] != want or len(router) != 2
            or (sums - 1.0).abs().max() > 1e-6
            or any(r["drop_frac"].abs().max() != 0 for r in router)
            or any((r["dropless"] != 1).any() for r in router)
            or router[0]["load"].shape != (moe_cfg.num_layers,
                                           moe_cfg.num_experts)):
        raise AssertionError(f"ft: MoE telemetry launches {run['launches']} "
                             f"want {want}, load sums {sums}")
    _add_launches(ft_launches, run["launches"])
    shutil.rmtree(os.path.join(tmp, "ft_moe"), ignore_errors=True)
    rec["moe"] = {"load_sum_max_err": float((sums - 1.0).abs().max()),
                  "max_group_frac": [float(r["max_group_frac"].max())
                                     for r in router]}
    log("ft", f"MoE telemetry, 2 steps: load fractions sum to 1 within "
              f"{rec['moe']['load_sum_max_err']:.1e} on every layer, "
              f"drop_frac 0; launches {want['gmm']} gmm, {want['tgmm']} tgmm"
        + lap("moe"))

    # -- nan_scan on a planted checkpoint ---------------------------------
    planted = os.path.join(tmp, "ft_planted", "step_00000008")
    os.makedirs(planted)
    with np.load(os.path.join(straight, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["params/layers/attention/o_proj/kernel"][5, 0, 0] = np.inf
    np.savez(os.path.join(planted, "state.npz"), **arrays)
    del arrays
    shutil.copy(os.path.join(straight, "meta.json"), planted)
    timer = {}
    real_scan = Trainer.nan_scan

    def timed_scan(self, state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_scan(self, state, batch)
        timer.setdefault("s", []).append(time.perf_counter() - t0)
        return out

    Trainer.nan_scan = timed_scan
    scans = {}
    try:
        for tag, path in (("planted", planted), ("clean", straight)):
            run = _cli_in_process("ft", base + [
                "--nan_scan", "--resume_from", path, *ft_dir(f"scan_{tag}")])
            scans[tag] = _jsonl(os.path.join(tmp, f"ft_scan_{tag}.jsonl"),
                                "nan_scan")[0]["first_nan"]
            want = _micro_launches(cfg, 0, 1, segmented=False)
            if run["launches"] != want:
                raise AssertionError(f"ft: nan_scan launches "
                                     f"{run['launches']}, want {want}")
            _add_launches(ft_launches, run["launches"])
    finally:
        Trainer.nan_scan = real_scan
    shutil.rmtree(os.path.join(tmp, "ft_planted"))
    if scans != {"planted": {"site": "attn", "layer": 5}, "clean": None}:
        raise AssertionError(f"ft: nan_scan found {scans}")
    rec["nan_scan_s"] = timer["s"]
    log("ft", f"--nan_scan: the planted inf found at layer 5, site attn; the "
              f"clean checkpoint has none; one forward a layer; "
              f"{timer['s'][0]:.3f} / {timer['s'][1]:.3f} s on {card}"
        + lap("nan_scan"))

    gp = [g for g in _jsonl(os.path.join(tmp, "a.jsonl"), "goodput")
          if g.get("final")][0]
    rec["cli_goodput"] = gp
    log("ft", "the cli phase's straight run, goodput: " + ", ".join(
        f"{k[:-5]} {gp[k]:.3f}" for k in sorted(gp) if k.endswith("_frac"))
        + f" of {gp['total_seconds']:.2f} s on {card}")
    rec["launches"] = ft_launches
    results["ft"] = rec
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", help="also write every measured number here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    results: dict = {}
    phase_card(results)
    main_row = phase_kernel(results)
    phase_reference(results)
    launches, engine = phase_engine(results, kv_int8=False)
    profile_engine(results, engine)
    del engine
    phase_engine(results, kv_int8=True)
    torch.cuda.empty_cache()
    train_k = phase_train_kernel(results)
    mask = phase_mask(results)
    split = phase_train_split(results)
    grouped = phase_gmm(results)
    torch.cuda.empty_cache()
    phase_train_reference(results)
    phase_train_grads(results)
    torch.cuda.empty_cache()
    train_launches = phase_train(results)
    torch.cuda.empty_cache()
    packed_launches = phase_train_packed(results)
    torch.cuda.empty_cache()
    phase_train_grads(results, moe=True)
    torch.cuda.empty_cache()
    moe_launches = phase_train_moe(results)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        phase_cli(results, tmp)
        torch.cuda.empty_cache()
        phase_infer(results, tmp)
        torch.cuda.empty_cache()
        phase_remat(results, tmp)
        phase_offload(results, tmp)
        phase_moe_remat(results, tmp)
        torch.cuda.empty_cache()
        ft = phase_ft(results, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    max_err = max(results["kernel_max_abs_err"],
                  results["engine"]["live_step_max_abs_err"],
                  results["int8"]["live_step_max_abs_err"])
    t, bounds, head = train_k["times"], train_k["bounds"], train_k["head"]
    st, sb = split["times"], split["bounds"]
    gt = grouped["times"]["balanced 768->3072"]

    def row(name, source, replaces, launched, err, ms, plain_ms, bound,
            library_ms):
        return {"name": name, "route": "cuda",
                "source": f"tpu_trainer_torch/csrc/{source}",
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms}

    # The ft phase's paths launch the training kernels too: each row counts
    # its main path's launches plus the ft phase's.
    ftl = ft["launches"]
    train_launches = {k: v + ftl.get(k, 0) for k, v in train_launches.items()}
    packed_launches = {k: v + ftl.get(k, 0)
                       for k, v in packed_launches.items()}
    moe_launches = {k: v + ftl.get(k, 0) for k, v in moe_launches.items()}
    kernels = {"kernels": [
        row("flash_decode", "flash_decode.cu",
            "tpu_trainer/ops/flash.py:1574", launches, max_err,
            main_row["ms"], main_row["plain_ms"], main_row,
            main_row["library_ms"]),
        row("flash_attn_forward", "flash_attn.cu",
            "tpu_trainer/ops/flash.py:250", train_launches["flash_forward"],
            max(train_k["fwd_err"], split["fwd_err"]), t["fwd_ms"],
            t["plain_fwd_ms"], bounds["fwd"], t["sdpa_fwd_ms"]),
        row("flash_attn_backward", "flash_attn.cu",
            "tpu_trainer/ops/flash.py:577", train_launches["flash_backward"],
            train_k["bwd_err"], t["bwd_ms"], t["plain_bwd_ms"], bounds["bwd"],
            t["sdpa_bwd_ms"]),
        row("head_ce_forward", "head_ce.cu", "tpu_trainer/ops/head_ce.py:67",
            train_launches["head_ce"], head["max_abs_err"], head["ms"],
            head["plain_ms"], head, head["library_ms"]),
        row("flash_attn_backward_dkv", "flash_attn.cu",
            "tpu_trainer/ops/flash.py:762",
            packed_launches["flash_backward_dkv"], split["dkv_err"],
            st["dkv_ms"], st["plain_dkv_ms"], sb["dkv"], st["sdpa_dkv_ms"]),
        row("flash_attn_backward_dq", "flash_attn.cu",
            "tpu_trainer/ops/flash.py:892",
            packed_launches["flash_backward_dq"], split["dq_err"],
            st["dq_ms"], st["plain_dq_ms"], sb["dq"], st["sdpa_dq_ms"]),
        row("gmm", "grouped_matmul.cu",
            "tpu_trainer/ops/grouped_matmul.py:232", moe_launches["gmm"],
            grouped["gmm_err"], gt["gmm_ms"], gt["plain_gmm_ms"],
            gt["gmm_bound"], gt["library_gmm_ms"]),
        row("tgmm", "grouped_matmul.cu",
            "tpu_trainer/ops/grouped_matmul.py:254", moe_launches["tgmm"],
            grouped["tgmm_err"], gt["tgmm_ms"], gt["plain_tgmm_ms"],
            gt["tgmm_bound"], gt["library_tgmm_ms"]),
        # The test-only mask dump is on no path (0 launches there); bitwise.
        row("keep_mask", "flash_attn.cu", "tpu_trainer/validate.py:65", 0,
            0.0, mask["ms"], mask["plain_ms"], mask, None),
    ]}
    results["kernels"] = kernels["kernels"]
    results["seconds"] = time.perf_counter() - t0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    log("done", f"all phases passed in {results['seconds']:.1f} s")
    print(json.dumps(kernels))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
