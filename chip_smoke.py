#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``tpu_trainer_torch``).

Drives the port on one NVIDIA GPU (written for the H100) and nothing of the
JAX package. Phases, each fatal on failure:

1. card    -- the card's name and power limit; builds every CUDA kernel of
              the serving path from ``tpu_trainer_torch/csrc`` with nvcc
              for sm_90a and prints the build time and ptxas's report.
2. kernel  -- ``flash_decode``'s kernel against its plain PyTorch version
              (``paged_attention_reference``) on the card: the main path's
              shape (b=8, h=kvh=12, d=64, block 16, 64 blocks a row, 513
              pool blocks, 4 splits, ragged lengths 1..1024 with a
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
4. engine  -- the main path: ``ServingEngine(device="cuda")`` at GPT-2
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

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result. Run from the repository root: ``python3 chip_smoke.py``
(``--out FILE`` also writes every measured number as JSON).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
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
            if "properties for" in ln or "registers" in ln or "spill" in ln:
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

    max_err = max(results["kernel_max_abs_err"],
                  results["engine"]["live_step_max_abs_err"],
                  results["int8"]["live_step_max_abs_err"])
    kernels = {"kernels": [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "tpu_trainer_torch/csrc/flash_decode.cu",
        "replaces": "tpu_trainer/ops/flash.py:1574",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}
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
