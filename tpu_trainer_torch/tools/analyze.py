"""Offline run analyzer + regression gate over metrics JSONL (the port's
copy of ``tpu_trainer/tools/analyze.py``, so it runs where JAX is not
installed; the report and verdicts are the same).

    python -m tpu_trainer_torch.tools.analyze run.jsonl
    python -m tpu_trainer_torch.tools.analyze run.jsonl --compare base.jsonl

Turns the stream a training run (or bench.py) emits —
train/eval/goodput/telemetry/cost_analysis/comms_model/recompile/rollback
records — into a human report: step-time percentiles, tok/s stability,
the goodput table, spike/rollback/recompile events, and the comms share
of the step. ``serve`` records (benchmarks/serve_bench.py) and ``decode``
records (benchmarks/decode_bench.py) fold into the same report, so one
file can carry a whole train+serve CI run. The elastic supervisor's
``supervisor.jsonl`` (``host_death`` / ``recovery`` / ``world_grow`` /
``elastic_summary`` records, see training/elastic.py) folds in too: the
report shows each restart's detection-to-first-step recovery time and
each grow-back's grant-to-first-grown-step time. With ``--compare`` it
renders PASS/FAIL verdicts for the new run against a baseline run on
throughput, MFU, peak HBM, final loss, serving tok/s and p99 tail
latency, and decode-path tok/s — plus four elastic gates: ABSOLUTE caps
on per-restart recovery seconds (``--recovery-tol``) and per-grow
re-expansion seconds (``--grow-tol``), a restart-count-regression check,
and a failure-to-regrow check (an ``--allow_grow`` run that lost hosts
must finish back at its desired world). ``frontend`` records
(``serve_bench --replicas``, the multi-replica front-end) add two more:
an ABSOLUTE admission-reject ceiling (``--reject-tol``) and a
categorical affinity-vs-random prefix-hit-rate check over the same
``--ab`` run. It exits nonzero on any FAIL —
a CI-usable gate over the bench trajectory (exit 0 clean, 1 regression,
2 unreadable/mis-schema'd input).

Every record must carry the ``schema_version`` stamp MetricLogger writes;
unversioned or mismatched records abort with exit 2 so old runs fail
loudly instead of misparsing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional

from tpu_trainer_torch.utils.schema import SCHEMA_VERSION


class SchemaError(ValueError):
    """A JSONL line the analyzer refuses to interpret."""


def load_records(path: str) -> List[dict]:
    """Parse one record per line, enforcing the schema_version stamp."""
    records = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{ln}: not valid JSON ({e})")
            if not isinstance(rec, dict):
                raise SchemaError(f"{path}:{ln}: record is not an object")
            version = rec.get("schema_version")
            if version is None:
                raise SchemaError(
                    f"{path}:{ln}: record (kind={rec.get('kind')!r}) carries "
                    f"no schema_version — this run predates the stamped "
                    f"JSONL schema; re-run it under the current trainer")
            if version != SCHEMA_VERSION:
                raise SchemaError(
                    f"{path}:{ln}: schema_version {version!r} != supported "
                    f"{SCHEMA_VERSION}")
            records.append(rec)
    if not records:
        raise SchemaError(f"{path}: no records")
    return records


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    if len(xs) == 1:
        return xs[0]
    pos = q / 100.0 * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _stats(xs: List[float]) -> Optional[dict]:
    xs = [x for x in xs if x is not None and math.isfinite(x)]
    if not xs:
        return None
    mean = sum(xs) / len(xs)
    var = sum((x - mean) ** 2 for x in xs) / len(xs)
    return {
        "n": len(xs),
        "mean": mean,
        "p10": _percentile(xs, 10),
        "p50": _percentile(xs, 50),
        "p90": _percentile(xs, 90),
        "cv": math.sqrt(var) / mean if mean else None,
    }


def summarize(records: List[dict]) -> dict:
    """Reduce a record stream to the report dict ``render`` prints and
    ``compare`` gates on."""
    by_kind: Dict[str, List[dict]] = {}
    for rec in records:
        by_kind.setdefault(str(rec.get("kind")), []).append(rec)

    report: dict = {"n_records": len(records)}

    train = sorted(by_kind.get("train", []), key=lambda r: r.get("step", 0))
    # Drop the first record: it absorbs compile time, and every steady-state
    # statistic (and the compare gate) should see the post-warmup run.
    steady = train[1:] if len(train) > 2 else train
    if train:
        losses = [r.get("loss") for r in steady if r.get("loss") is not None]
        step_times = []
        for a, b in zip(train, train[1:]):
            ds = b.get("step", 0) - a.get("step", 0)
            dt = (b.get("elapsed_s") or 0) - (a.get("elapsed_s") or 0)
            if ds > 0 and dt > 0:
                step_times.append(dt / ds)
        report["train"] = {
            "steps": [train[0].get("step"), train[-1].get("step")],
            "final_loss": (_percentile(losses[-5:], 50) if losses else None),
            "tok_per_sec": _stats(
                [r.get("tokens_per_sec") for r in steady]),
            "step_time_s": _stats(step_times[1:] or step_times),
            "mfu": _stats([r.get("mfu") for r in steady
                           if r.get("mfu") is not None]),
            "peak_mem_gb": max(
                (r["peak_mem_gb"] for r in train if r.get("peak_mem_gb")),
                default=None),
        }

    evals = by_kind.get("eval", [])
    if evals:
        report["eval"] = {
            "final_loss": evals[-1].get("eval_loss"),
            "final_perplexity": evals[-1].get("perplexity"),
            "n": len(evals),
        }

    goodput = by_kind.get("goodput", [])
    if goodput:
        final = [g for g in goodput if g.get("final")] or goodput
        g = final[-1]
        report["goodput"] = {
            "total_seconds": g.get("total_seconds"),
            "productive_frac": g.get("productive_frac"),
            "fractions": {
                k[:-len("_frac")]: v for k, v in sorted(g.items())
                if k.endswith("_frac")
                # (the ledger's token ratio is non_pad_token_ratio,
                # deliberately outside this namespace; "packing" below)
                and k not in ("productive_frac", "untracked_frac")
            },
            "untracked_frac": g.get("untracked_frac"),
        }

    # Sequence-packing efficiency: the loader-side cumulative non-pad token
    # fraction rides the train records (MetricLogger.non_pad_frac) and the
    # goodput ledger; cumulative → the last record is the run's number.
    pack_fracs = [r.get("non_pad_frac") for r in train
                  if r.get("non_pad_frac") is not None]
    ledger_frac = None
    if goodput:
        final = [g2 for g2 in goodput if g2.get("final")] or goodput
        ledger_frac = final[-1].get("non_pad_token_ratio")
    if pack_fracs or ledger_frac is not None:
        report["packing"] = {
            "non_pad_frac": (pack_fracs[-1] if pack_fracs else ledger_frac),
            "ledger_non_pad_frac": ledger_frac,
            "effective_tok_per_sec": _stats(
                [r.get("effective_tokens_per_sec") for r in steady
                 if r.get("effective_tokens_per_sec") is not None]),
        }

    comms = by_kind.get("comms_model", [])
    if comms:
        c = comms[-1]
        report["comms"] = {
            "mesh": c.get("mesh"),
            "strategy": c.get("strategy"),
            "total_bytes_per_device_per_step":
                c.get("total_bytes_per_device_per_step"),
            "per_axis_bytes": {
                axis: info.get("bytes")
                for axis, info in (c.get("per_axis") or {}).items()
                if info.get("bytes")},
            "comms_seconds_est": c.get("comms_seconds_est"),
            "compute_seconds_est": c.get("compute_seconds_est"),
            "comms_compute_ratio": c.get("comms_compute_ratio"),
            "bound": c.get("bound"),
            "hlo_mismatches": c.get("hlo_mismatches"),
        }

    # Mesh auto-planner validation loop (parallel/planner.py): the
    # mesh_plan record carries the chosen split and its predicted step
    # time; bench train records carry a per-window plan_error_frac, whose
    # MEDIAN is the number the --plan-tol gate prices. A run with train
    # windows but no mesh_plan record (training CLI --mesh auto runs log
    # the plan but never a measured step-ms) still reports the plan.
    plans = by_kind.get("mesh_plan", [])
    plan_errors = [r.get("plan_error_frac") for r in train
                   if r.get("plan_error_frac") is not None]
    if plans:
        p = plans[-1]
        chosen = p.get("chosen") or {}
        report["plan"] = {
            "auto": p.get("auto"),
            "mesh": chosen.get("mesh"),
            "strategy": p.get("strategy"),
            "batch_per_shard": chosen.get("batch_per_shard"),
            "n_enumerated": p.get("n_enumerated"),
            "n_feasible": p.get("n_feasible"),
            "pruned": p.get("pruned"),
            "predicted_step_ms": p.get("predicted_step_ms"),
            "measured_step_ms": p.get("measured_step_ms"),
            "plan_error_frac": (_percentile(plan_errors, 50)
                                if plan_errors
                                else p.get("plan_error_frac")),
            "bound": chosen.get("bound"),
            "predicted_peak_hbm_gb": chosen.get("peak_hbm_gb"),
        }

    cost = by_kind.get("cost_analysis", [])
    if cost:
        report["cost"] = {k: cost[-1].get(k) for k in (
            "xla_flops_per_step", "analytic_flops_per_step",
            "xla_peak_bytes") if cost[-1].get(k) is not None}

    recompiles = by_kind.get("recompile", [])
    if recompiles:
        report["recompiles"] = {
            "count": len(recompiles),
            "steps": [r.get("step") for r in recompiles],
            "shapes": sorted({str(r.get("batch_abstract"))
                              for r in recompiles}),
            "storm": any(r.get("storm") for r in recompiles),
        }

    rollbacks = by_kind.get("rollback", [])
    if rollbacks:
        report["rollbacks"] = [{
            "step": r.get("step"),
            "cause": r.get("cause"),
            "restored_step": r.get("restored_step"),
        } for r in rollbacks]

    serves = by_kind.get("serve", [])
    if serves:
        # serve_bench.py records: last one wins (a file may accumulate
        # runs; the newest reflects the current tree).
        s = serves[-1]
        report["serve"] = {k: s.get(k) for k in (
            "tokens_per_s", "ttft_p50_s", "ttft_p99_s", "tpot_p50_s",
            "tpot_p99_s", "queue_wait_p50_s", "queue_wait_p99_s",
            "occupancy_mean", "occupancy_max", "preemptions",
            "sequential_tokens_per_s", "concurrent_speedup", "n_requests",
            "concurrency", "workload", "lane", "prefill_chunk",
            "prefix_cache", "prefill_chunks", "prefix_hit_rate",
            "prefix_hit_tokens", "prompt_tokens",
            "prefix_evictions", "spec", "spec_k", "spec_steps",
            "spec_drafted", "spec_accepted", "spec_accept_mean",
            "spec_accept_rate", "spec_accept_hist",
            "tp", "device_pool_blocks", "total_pool_blocks",
            "peak_pool_blocks", "wire_bytes_per_worker", "wire_ratio",
            "tp_token_match",
            ) if s.get(k) is not None}

    fronts = by_kind.get("frontend", [])
    if fronts:
        # serve_bench.py --replicas records (the multi-replica front-end,
        # serving/frontend.py). Latest record wins for the summary line;
        # the routing A/B is read from whichever record carries its own
        # random baseline (serve_bench --ab annotates the policy lane),
        # falling back to pairing this file's newest policy and random
        # lanes.
        f = fronts[-1]
        report["frontend"] = {k: f.get(k) for k in (
            "workload", "lane", "routing", "replicas", "replicas_live",
            "tokens_per_s", "ttft_p99_s", "submitted", "accepted",
            "queue_wait_p50_s", "queue_wait_p99_s",
            "rejected", "reject_rate", "prefix_hit_rate",
            "load_imbalance_mean", "load_imbalance_max",
            "failover_events", "failed_over_requests", "wait_age_p99_s",
            "transport", "workers", "worker_deaths",
            "finished", "cancelled", "deadline_exceeded",
            "tp", "device_pool_blocks", "total_pool_blocks",
            "wire_bytes_per_worker", "wire_ratio", "tp_token_match",
            "fleet_prefix_hit_rate", "store_hit_tokens",
            "store_hit_tokens_host", "store_hit_tokens_disk",
            "migrations", "migrated_bytes",
            "baseline_prefix_hit_rate", "disagg_token_match",
            ) if f.get(k) is not None}

    # Sharded-decode (tensor-parallel) parity: EVERY record that carries
    # a tp_token_match verdict counts — the bench stamps one per lane
    # compared against the unsharded / no-fault base lane, so one
    # mismatch anywhere in the file is a real divergence, not noise the
    # newest record should shadow.
    tp_recs = [r for r in serves + fronts
               if r.get("tp_token_match") is not None]
    if tp_recs:
        bad = [r.get("lane") for r in tp_recs if not r["tp_token_match"]]
        report["tp_parity"] = {
            "tp": max(int(r.get("tp") or 0) for r in tp_recs),
            "records": len(tp_recs),
            "mismatched": len(bad),
            "mismatched_lanes": bad,
        }
        # Lifecycle / chaos metrics (deadline misses, hung-RPC stalls,
        # fence counts) live on whichever lane carried the deadline or
        # fault — scan for the newest record with each, like the RPC
        # overhead scan below.
        for k in ("deadline_miss_rate", "deadline_miss_slack_p50",
                  "deadline_miss_slack_p99", "stall_recovery_max_s",
                  "fenced"):
            r = next((x for x in reversed(fronts)
                      if x.get(k) is not None), None)
            if r is not None:
                report["frontend"][k] = r.get(k)
        # The RPC-overhead fields live on the cross-process A/B lane's
        # record, which may not be the newest (a worker_kill lane often
        # follows it) — scan for the newest rpc-transport record.
        rpc = next((r for r in reversed(fronts)
                    if r.get("transport") == "rpc"
                    and r.get("rpc_overhead_p99_s") is not None),
                   None) or next((r for r in reversed(fronts)
                                  if r.get("transport") == "rpc"), None)
        if rpc is not None:
            for k in ("rpc_overhead_p50_s", "rpc_overhead_p99_s",
                      "tok_s_vs_inproc", "inproc_tokens_per_s"):
                if rpc.get(k) is not None:
                    report["frontend"][k] = rpc.get(k)
            report["frontend"]["transport"] = "rpc"
            report["frontend"]["workers"] = rpc.get("workers")
            report["frontend"]["worker_deaths"] = max(
                int(r.get("worker_deaths") or 0) for r in fronts)
        ab = next((r for r in reversed(fronts)
                   if r.get("random_prefix_hit_rate") is not None), None)
        if ab is None:
            aff = next((r for r in reversed(fronts)
                        if r.get("routing") != "random"
                        and r.get("lane") != "replica_kill"), None)
            rnd = next((r for r in reversed(fronts)
                        if r.get("routing") == "random"), None)
            if aff is not None and rnd is not None:
                ab = dict(aff,
                          random_prefix_hit_rate=rnd.get("prefix_hit_rate"))
        if ab is not None:
            report["frontend"]["ab"] = {
                "routing": ab.get("routing"),
                "prefix_hit_rate": ab.get("prefix_hit_rate"),
                "random_prefix_hit_rate": ab.get("random_prefix_hit_rate"),
                "tok_s_vs_random": ab.get("tok_s_vs_random"),
            }

    # Disaggregated-serving / fleet-KV-store metrics live on whichever
    # lane ran with the store (serve_bench --disagg stamps the disagg
    # lane; a plain kv_store lane carries store counters too) — the
    # newest store-bearing record wins the summary so a later storeless
    # lane can't shadow it. Like tp parity, the migrated-stream verdict
    # counts EVERY record carrying one: a single migrated stream that
    # diverged from the single-engine pin is a real divergence, not
    # noise the newest record should hide.
    dis_recs = [r for r in fronts
                if r.get("disagg_token_match") is not None
                or r.get("migrations") or r.get("store_hit_tokens")]
    if dis_recs:
        d = dis_recs[-1]
        pinned = [r for r in fronts
                  if r.get("disagg_token_match") is not None]
        bad = [r.get("lane") for r in pinned
               if not r["disagg_token_match"]]
        report["disagg"] = {k: d.get(k) for k in (
            "lane", "workload", "routing",
            "fleet_prefix_hit_rate", "baseline_prefix_hit_rate",
            "store_hit_tokens", "store_hit_tokens_host",
            "store_hit_tokens_disk", "migrations", "migrated_bytes",
            ) if d.get(k) is not None}
        report["disagg"]["records"] = len(pinned)
        report["disagg"]["mismatched"] = len(bad)
        report["disagg"]["mismatched_lanes"] = bad
        roles = [p.get("role") for p in (d.get("per_replica") or ())]
        if any(roles):
            report["disagg"]["roles"] = roles

    # Serve-timeline section: kind:"span" records (serving/tracing.py,
    # emitted by serve_bench per finished rid). Phase percentiles and the
    # worst-p99 waterfall read the LATEST lane's spans (lanes differ in
    # chunking/spec config, so mixing them would muddy the tail), while
    # span conservation is checked over EVERY span in the file — a
    # dropped terminal event is a loss regardless of which lane dropped
    # it. Each record carries its own event list, so conservation is per
    # record (rids repeat across lanes; cross-record grouping would
    # false-positive on the collision).
    spans = by_kind.get("span", [])
    if spans:
        last_lane = spans[-1].get("lane")
        lane_spans = [r for r in spans if r.get("lane") == last_lane]
        open_rids, multi = [], []
        for r in spans:
            kinds = [e.get("event") for e in (r.get("events") or ())]
            if "rejected" in kinds:
                continue
            if not any(k in ("submitted", "admitted") for k in kinds):
                continue
            n_term = sum(1 for k in kinds if k in (
                "finished", "cancelled", "deadline_exceeded", "failed"))
            if n_term > 1:
                multi.append(r.get("rid"))
            elif n_term == 0 and "exported" not in kinds:
                open_rids.append(r.get("rid"))
        phases = {}
        for name in ("queue_wait", "prefill", "decode", "total"):
            vals = [r.get(f"{name}_s") for r in lane_spans
                    if r.get(f"{name}_s") is not None]
            if vals:
                phases[name] = {
                    "n": len(vals),
                    "p50": _percentile(vals, 50),
                    "p99": _percentile(vals, 99),
                }
        worst = sorted(
            (r for r in lane_spans if r.get("total_s") is not None),
            key=lambda r: r["total_s"], reverse=True)[:3]
        report["spans"] = {
            "n": len(spans),
            "lane": last_lane,
            "conservation_ok": not open_rids and not multi,
            "open": open_rids[:10],
            "multi_terminal": multi[:10],
            "phases": phases,
            "waterfall": [{k: r.get(k) for k in (
                "rid", "replica", "queue_wait_s", "prefill_s",
                "decode_s", "total_s", "n_events")} for r in worst],
        }

    # Fleet time series: kind:"serve_ts" samples (ServingLedger.record).
    # Same latest-lane convention as the span percentiles.
    ts = by_kind.get("serve_ts", [])
    if ts:
        last_lane = ts[-1].get("lane")
        lane_ts = [r for r in ts if r.get("lane") == last_lane]
        final = next((r for r in reversed(lane_ts) if r.get("final")),
                     lane_ts[-1])
        depths = [r.get("queue_depth") for r in lane_ts
                  if r.get("queue_depth") is not None]
        report["serve_ts"] = {
            "n": len(lane_ts),
            "lane": last_lane,
            "total_seconds": final.get("total_seconds"),
            "dispatch_frac": final.get("dispatch_frac"),
            "host_sched_frac": final.get("host_sched_frac"),
            "rpc_wait_frac": final.get("rpc_wait_frac"),
            "idle_frac": final.get("idle_frac"),
            "untracked_frac": final.get("untracked_frac"),
            "queue_depth": _stats([float(d) for d in depths]),
            "queue_depth_series": [float(d) for d in depths],
            "outstanding_tokens": _stats(
                [float(r["outstanding_tokens"]) for r in lane_ts
                 if r.get("outstanding_tokens") is not None]),
            "occupancy": _stats(
                [float(r["occupancy"]) for r in lane_ts
                 if r.get("occupancy") is not None]),
        }

    # Incidents: fence/failover/worker-death/drain-failure markers from
    # the serving flight recorder (frontend._dump_incident).
    incidents = by_kind.get("incident", [])
    if incidents:
        by_reason: Dict[str, int] = {}
        for r in incidents:
            by_reason[str(r.get("reason"))] = (
                by_reason.get(str(r.get("reason")), 0) + 1)
        report["incidents"] = {
            "n": len(incidents),
            "by_reason": by_reason,
            "dumps": [r.get("dump_dir") for r in incidents
                      if r.get("dump_dir")],
        }

    decodes = by_kind.get("decode", [])
    if decodes:
        rows = decodes[-1].get("rows") or []
        paths: Dict[str, float] = {}
        for r in rows:
            key = f"{r.get('path')}/bs{r.get('batch')}"
            tps = r.get("tok_per_sec")
            if tps is not None:
                paths[key] = max(paths.get(key, 0.0), float(tps))
        kv_best = max((v for k, v in paths.items() if k.startswith("kv/")),
                      default=None)
        report["decode"] = {"paths": paths, "kv_best_tok_per_sec": kv_best}

    deaths = by_kind.get("host_death", [])
    recoveries = by_kind.get("recovery", [])
    grows = by_kind.get("world_grow", [])
    esummary = by_kind.get("elastic_summary", [])
    if deaths or recoveries or grows or esummary:
        rec_secs = [r.get("recovery_seconds") for r in recoveries
                    if r.get("recovery_seconds") is not None]
        grow_secs = [g.get("grow_seconds") for g in grows
                     if g.get("grow_seconds") is not None]
        summary = esummary[-1] if esummary else {}
        report["elastic"] = {
            "restarts": summary.get("restarts", len(recoveries)),
            "final_world": summary.get("final_world"),
            "desired_world": summary.get("desired_world"),
            "allow_grow": summary.get("allow_grow"),
            "supervisor_exit_code": summary.get("exit_code"),
            "deaths": [{"host": d.get("host"), "cause": d.get("cause")}
                       for d in deaths],
            "proactive_drains": sum(1 for d in deaths if d.get("proactive")),
            "recovery_seconds": rec_secs,
            "recovery_seconds_total": summary.get(
                "recovery_seconds_total", sum(rec_secs) or None),
            "recovery_seconds_max": max(rec_secs, default=None),
            "rolled_back_steps": [r.get("rolled_back_steps")
                                  for r in recoveries],
            "standby_promotions": summary.get("standby_promotions"),
            "worlds": [[r.get("world_before"), r.get("world_after")]
                       for r in recoveries],
            "grows": summary.get("grows", len(grows)),
            "grow_seconds": grow_secs,
            "grow_seconds_total": summary.get(
                "grow_seconds_total", sum(grow_secs) or None),
            "grow_seconds_max": max(grow_secs, default=None),
            "grow_worlds": [[g.get("world_before"), g.get("world_after")]
                            for g in grows],
        }

    # Per-source loss: mixture runs tag each train record with the source
    # that produced its batch (``data_source``), so one mixed run yields a
    # loss curve per corpus — the signal mixture weights are tuned from.
    by_src: Dict[str, List[float]] = {}
    for r in train:
        src = r.get("data_source")
        if src is not None and r.get("loss") is not None:
            by_src.setdefault(str(src), []).append(float(r["loss"]))
    if by_src:
        report["sources"] = {
            src: {
                "n": len(ls),
                "loss": _stats(ls),
                "final_loss": _percentile(ls[-5:], 50),
            }
            for src, ls in sorted(by_src.items())
        }

    telemetry_steps = [r.get("step") for r in train
                       if any(k.startswith("telemetry/") for k in r)]
    if telemetry_steps:
        report["telemetry_steps"] = len(telemetry_steps)

    # MoE router health.  models/moe.py records per-layer router stats that
    # utils/telemetry.flatten_scalars spreads into
    # ``telemetry/router/<key>/L..`` train-record scalars: ``entropy``
    # (routing distribution), ``drop_frac`` (tokens past capacity — 0 by
    # construction under moe_impl="dropless"), ``max_group_frac`` (largest
    # expert's share of routed tokens; 1/E is perfectly balanced, ~1.0 is a
    # collapsed router), and a ``dropless`` 0/1 marker.  drop_frac and
    # max_group_frac aggregate as max-over-layers per record so one bad
    # layer can't hide behind healthy siblings.
    def _router_vals(rec: dict, key: str) -> List[float]:
        pfx = f"telemetry/router/{key}/"
        return [float(v) for k, v in rec.items() if k.startswith(pfx)]

    router_recs = [r for r in train
                   if any(k.startswith("telemetry/router/") for k in r)]
    if router_recs:
        drops = [max(_router_vals(r, "drop_frac") or [0.0])
                 for r in router_recs]
        imbal = [max(_router_vals(r, "max_group_frac") or [0.0])
                 for r in router_recs]
        last_entropy = _router_vals(router_recs[-1], "entropy")
        dl_marks = _router_vals(router_recs[-1], "dropless")
        report["router"] = {
            "n": len(router_recs),
            "dropless": bool(dl_marks) and min(dl_marks) >= 0.5,
            "entropy": _stats(last_entropy),
            "drop_frac": _stats(drops),
            "drop_frac_max": max(drops) if drops else None,
            "max_group_frac": _stats(imbal),
        }
    return report


def _fmt(x, nd=2, default="-"):
    if x is None:
        return default
    if isinstance(x, float):
        return f"{x:,.{nd}f}"
    return str(x)


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(xs: List[float], width: int = 32) -> str:
    """Down-sampled unicode sparkline of a series (mean per bucket)."""
    xs = [x for x in xs if x is not None and math.isfinite(x)]
    if not xs:
        return ""
    if len(xs) > width:
        per = len(xs) / width
        xs = [sum(xs[int(i * per):max(int(i * per) + 1, int((i + 1) * per))])
              / max(1, len(xs[int(i * per):max(int(i * per) + 1,
                                               int((i + 1) * per))]))
              for i in range(width)]
    lo, hi = min(xs), max(xs)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((x - lo) / span * (len(_SPARK) - 1)))] for x in xs)


def render(report: dict) -> List[str]:
    """Human report lines."""
    lines = [f"== run analysis ({report['n_records']} records) =="]
    t = report.get("train")
    if t:
        lines.append(f"steps {t['steps'][0]}..{t['steps'][1]}"
                     f" | final loss {_fmt(t['final_loss'], 4)}")
        tok = t.get("tok_per_sec")
        if tok:
            lines.append(
                f"tok/s   p10 {_fmt(tok['p10'], 0)}  p50 {_fmt(tok['p50'], 0)}"
                f"  p90 {_fmt(tok['p90'], 0)}  cv {_fmt(tok['cv'], 3)}")
        st = t.get("step_time_s")
        if st:
            lines.append(
                f"step_s  p10 {_fmt(st['p10'], 4)}  p50 {_fmt(st['p50'], 4)}"
                f"  p90 {_fmt(st['p90'], 4)}")
        if t.get("mfu"):
            lines.append(f"mfu     p50 {_fmt(t['mfu']['p50'], 4)}")
        if t.get("peak_mem_gb") is not None:
            lines.append(f"peak HBM {_fmt(t['peak_mem_gb'])} GB")
    else:
        lines.append("no train records")
    e = report.get("eval")
    if e:
        lines.append(f"eval    loss {_fmt(e['final_loss'], 4)}"
                     f"  ppl {_fmt(e['final_perplexity'])} ({e['n']} evals)")
    g = report.get("goodput")
    if g:
        fr = "  ".join(f"{k} {_fmt(v * 100, 1)}%"
                       for k, v in g["fractions"].items())
        lines.append(f"goodput {_fmt((g.get('productive_frac') or 0) * 100, 1)}%"
                     f" productive over {_fmt(g['total_seconds'], 1)}s"
                     f" | {fr}"
                     f" | untracked {_fmt((g.get('untracked_frac') or 0) * 100, 1)}%")
    p = report.get("packing")
    if p:
        eff = p.get("effective_tok_per_sec")
        eff_s = (f" | effective tok/s p50 {_fmt(eff['p50'], 0)}"
                 if eff else "")
        lines.append(
            f"packing non-pad frac {_fmt(p['non_pad_frac'], 4)}{eff_s}")
    c = report.get("comms")
    if c:
        axes = "  ".join(f"{k} {_fmt(v / 1e6, 1)}MB"
                         for k, v in c["per_axis_bytes"].items())
        lines.append(
            f"comms   {_fmt((c.get('total_bytes_per_device_per_step') or 0) / 1e6, 1)}"
            f" MB/device/step ({axes or 'none'})"
            f" | est comms/compute {_fmt(c.get('comms_compute_ratio'))}"
            f" -> {c.get('bound')}-bound")
        for m in c.get("hlo_mismatches") or []:
            lines.append(f"comms   HLO mismatch: {m}")
    pl = report.get("plan")
    if pl:
        mesh_s = ("x".join(str(v) for v in (pl.get("mesh") or {}).values())
                  or "?")
        err = pl.get("plan_error_frac")
        lines.append(
            f"plan    {'auto ' if pl.get('auto') else ''}mesh {mesh_s}"
            f" ({pl.get('strategy')}, batch/shard"
            f" {pl.get('batch_per_shard')})"
            + (f" | {pl['n_feasible']}/{pl['n_enumerated']} feasible"
               if pl.get("n_enumerated") else "")
            + f" | predicted {_fmt(pl.get('predicted_step_ms'))}ms"
            + (f" measured {_fmt(pl.get('measured_step_ms'))}ms"
               if pl.get("measured_step_ms") is not None else "")
            + (f" | median err {_fmt(err * 100, 1)}%"
               if err is not None else "")
            + (f" -> {pl.get('bound')}-bound" if pl.get("bound") else ""))
    ro = report.get("router")
    if ro:
        ent = ro.get("entropy")
        drop = ro.get("drop_frac")
        imbal = ro.get("max_group_frac")
        flag = ""
        if ro.get("dropless") and drop and drop["p90"] > 0:
            flag = "  ** TOKENS DROPPED ON DROPLESS RUN **"
        lines.append(
            f"router  {'dropless' if ro.get('dropless') else 'capacity'}"
            f" | entropy p50 {_fmt(ent['p50'], 3) if ent else '-'}"
            f" | drop_frac p90 {_fmt(drop['p90'], 4) if drop else '-'}"
            f" | max_group_frac p90"
            f" {_fmt(imbal['p90'], 3) if imbal else '-'}{flag}")
    r = report.get("recompiles")
    if r:
        flag = "  ** RECOMPILE STORM (loader shape churn?) **" if r["storm"] else ""
        lines.append(f"recompiles {r['count']} at steps {r['steps']}"
                     f" shapes {r['shapes']}{flag}")
    for rb in report.get("rollbacks", []):
        lines.append(f"rollback at step {rb['step']} ({rb['cause']})"
                     f" -> restored step {rb['restored_step']}")
    s = report.get("serve")
    if s:
        lines.append(
            f"serve   {_fmt(s.get('tokens_per_s'), 0)} tok/s"
            f" ({s.get('n_requests')} reqs @ {s.get('concurrency')})"
            f" | TTFT p50 {_fmt((s.get('ttft_p50_s') or 0) * 1e3, 1)}ms"
            f" p99 {_fmt((s.get('ttft_p99_s') or 0) * 1e3, 1)}ms"
            f" | TPOT p50 {_fmt((s.get('tpot_p50_s') or 0) * 1e3, 1)}ms"
            f" p99 {_fmt((s.get('tpot_p99_s') or 0) * 1e3, 1)}ms")
        lines.append(
            f"serve   occupancy mean {_fmt(s.get('occupancy_mean'))}"
            f" max {_fmt(s.get('occupancy_max'))}"
            f" | preemptions {s.get('preemptions')}"
            + (f" | {_fmt(s.get('concurrent_speedup'))}x vs sequential"
               if s.get("concurrent_speedup") is not None else ""))
        if s.get("prefill_chunk") or s.get("prefix_cache"):
            lines.append(
                f"serve   chunk {s.get('prefill_chunk') or '-'}"
                f" ({s.get('prefill_chunks') or 0} chunks)"
                f" | prefix hit rate {_fmt(s.get('prefix_hit_rate'))}"
                f" ({s.get('prefix_hit_tokens') or 0}"
                f"/{s.get('prompt_tokens') or 0} prompt tokens,"
                f" {s.get('prefix_evictions') or 0} evictions)")
        if s.get("tp") and s.get("tp") > 1:
            wire = ""
            if s.get("wire_bytes_per_worker") is not None:
                wire = (f" | wire/worker {s['wire_bytes_per_worker']} B"
                        f" ({_fmt(s.get('wire_ratio'))}x full/tp)")
            match = s.get("tp_token_match")
            lines.append(
                f"serve   tp {s['tp']}:"
                f" {s.get('device_pool_blocks')} blocks/device"
                f" x{s['tp']} = {s.get('total_pool_blocks')} total"
                f" (peak {s.get('peak_pool_blocks', '-')})"
                f"{wire}"
                + ("" if match is None else
                   f" | token match {'ok' if match else 'DIVERGED'}"))
        if s.get("spec") and s.get("spec") != "off":
            lines.append(
                f"serve   spec {s['spec']} k={s.get('spec_k')}:"
                f" {_fmt(s.get('spec_accept_mean'))} accepted drafts/step"
                f" (rate {_fmt(s.get('spec_accept_rate'))},"
                f" {s.get('spec_accepted') or 0}"
                f"/{s.get('spec_drafted') or 0} over"
                f" {s.get('spec_steps') or 0} verify steps)"
                f" hist {s.get('spec_accept_hist')}")
    tpp = report.get("tp_parity")
    if tpp:
        lines.append(
            f"tp      parity tp={tpp['tp']}: {tpp['records']} sharded"
            f" lanes, {tpp['mismatched']} diverged"
            + (f" ({', '.join(str(x) for x in tpp['mismatched_lanes'])})"
               f"  ** SHARDED STREAMS DIVERGED **"
               if tpp["mismatched"] else " (all bit-exact)"))
    fe = report.get("frontend")
    if fe:
        lines.append(
            f"frontend {fe.get('replicas_live')}/{fe.get('replicas')}"
            f" replicas ({fe.get('routing')} routing, lane"
            f" {fe.get('lane')}) | {_fmt(fe.get('tokens_per_s'), 0)} tok/s"
            f" aggregate | TTFT p99"
            f" {_fmt((fe.get('ttft_p99_s') or 0) * 1e3, 1)}ms")
        lines.append(
            f"frontend {fe.get('accepted')}/{fe.get('submitted')} accepted"
            f" (reject rate {_fmt(fe.get('reject_rate'), 3)})"
            f" | load imbalance mean {_fmt(fe.get('load_imbalance_mean'))}"
            f" max {_fmt(fe.get('load_imbalance_max'))}"
            f" | failovers {fe.get('failover_events') or 0}"
            f" ({fe.get('failed_over_requests') or 0} reqs)")
        if (fe.get("cancelled") or fe.get("deadline_exceeded")
                or fe.get("deadline_miss_rate") is not None):
            line = (f"frontend lifecycle: {fe.get('finished') or 0} finished,"
                    f" {fe.get('cancelled') or 0} cancelled,"
                    f" {fe.get('deadline_exceeded') or 0} deadline_exceeded")
            if fe.get("deadline_miss_rate") is not None:
                line += (
                    f" | deadline miss rate"
                    f" {_fmt(fe.get('deadline_miss_rate'), 3)} slack p99"
                    f" {_fmt(fe.get('deadline_miss_slack_p99'), 3)}s")
            lines.append(line)
        if fe.get("stall_recovery_max_s") is not None:
            lines.append(
                f"frontend max failover stall"
                f" {_fmt(fe.get('stall_recovery_max_s'), 2)}s"
                f" ({fe.get('fenced') or 0} fenced)")
        if fe.get("transport") == "rpc":
            line = (f"frontend transport rpc ({fe.get('workers')} worker"
                    f" processes, {fe.get('worker_deaths') or 0} deaths)")
            if fe.get("rpc_overhead_p99_s") is not None:
                line += (
                    f" | RPC overhead p50"
                    f" {_fmt((fe.get('rpc_overhead_p50_s') or 0) * 1e3, 1)}ms"
                    f" p99"
                    f" {_fmt((fe.get('rpc_overhead_p99_s') or 0) * 1e3, 1)}ms")
            if fe.get("tok_s_vs_inproc") is not None:
                line += f" | tok/s x{_fmt(fe.get('tok_s_vs_inproc'))} vs in-process"
            lines.append(line)
        if fe.get("tp") and fe.get("tp") > 1:
            line = (f"frontend tp {fe['tp']} per replica:"
                    f" {fe.get('device_pool_blocks')} blocks/device"
                    f" x{fe['tp']} = {fe.get('total_pool_blocks')} total")
            if fe.get("wire_bytes_per_worker") is not None:
                line += (f" | wire/worker {fe['wire_bytes_per_worker']} B"
                         f" ({_fmt(fe.get('wire_ratio'))}x full/tp)")
            lines.append(line)
        ab = fe.get("ab")
        if ab:
            lines.append(
                f"frontend A/B {ab.get('routing')} hit rate"
                f" {_fmt(ab.get('prefix_hit_rate'))} vs random"
                f" {_fmt(ab.get('random_prefix_hit_rate'))}"
                + (f" | tok/s x{_fmt(ab.get('tok_s_vs_random'))}"
                   if ab.get("tok_s_vs_random") is not None else ""))
    dis = report.get("disagg")
    if dis:
        line = (f"disagg  lane {dis.get('lane')}: fleet prefix hit"
                f" {_fmt(dis.get('fleet_prefix_hit_rate'))}")
        if dis.get("baseline_prefix_hit_rate") is not None:
            line += (f" vs per-replica baseline"
                     f" {_fmt(dis.get('baseline_prefix_hit_rate'))}")
        if dis.get("roles"):
            line += f" | roles {'/'.join(str(r) for r in dis['roles'])}"
        lines.append(line)
        lines.append(
            f"disagg  store-hit tokens {dis.get('store_hit_tokens') or 0}"
            f" (host {dis.get('store_hit_tokens_host') or 0} / disk"
            f" {dis.get('store_hit_tokens_disk') or 0})"
            f" | migrations {dis.get('migrations') or 0}"
            f" ({dis.get('migrated_bytes') or 0} B)")
        if dis.get("records"):
            lines.append(
                f"disagg  parity: {dis['records']} store lanes vs"
                f" single-engine pin, {dis['mismatched']} diverged"
                + (f" ({', '.join(str(x) for x in dis['mismatched_lanes'])})"
                   f"  ** MIGRATED STREAMS DIVERGED **"
                   if dis["mismatched"] else " (all bit-exact)"))
    sp = report.get("spans")
    if sp:
        flag = "" if sp.get("conservation_ok") else (
            f"  ** SPAN CONSERVATION BROKEN"
            f" ({len(sp.get('open') or [])} open,"
            f" {len(sp.get('multi_terminal') or [])} multi-terminal) **")
        ph = sp.get("phases") or {}

        def _ph(name):
            d = ph.get(name)
            if not d:
                return f"{name} -"
            return (f"{name} p50 {_fmt(d['p50'] * 1e3, 1)}ms"
                    f" p99 {_fmt(d['p99'] * 1e3, 1)}ms")

        lines.append(
            f"spans   {sp['n']} requests (lane {sp.get('lane')})"
            f" | {_ph('queue_wait')} | {_ph('prefill')}"
            f" | {_ph('decode')}{flag}")
        wf = sp.get("waterfall") or []
        if wf:
            lines.append("spans   worst-total waterfall"
                         " (queue|prefill|decode, ms):")
            for w in wf:
                lines.append(
                    f"spans     rid {w.get('rid')}"
                    + (f" r{w.get('replica')}"
                       if w.get("replica") is not None else "")
                    + f"  {_fmt((w.get('queue_wait_s') or 0) * 1e3, 1)}"
                    + f" | {_fmt((w.get('prefill_s') or 0) * 1e3, 1)}"
                    + f" | {_fmt((w.get('decode_s') or 0) * 1e3, 1)}"
                    + f"  = {_fmt((w.get('total_s') or 0) * 1e3, 1)}"
                    + f" ({w.get('n_events')} events)")
    sts = report.get("serve_ts")
    if sts:
        parts = []
        for k in ("dispatch", "host_sched", "rpc_wait", "idle"):
            v = sts.get(f"{k}_frac")
            if v is not None:
                parts.append(f"{k} {_fmt(v * 100, 1)}%")
        parts.append(
            f"untracked {_fmt((sts.get('untracked_frac') or 0) * 100, 1)}%")
        lines.append(
            f"serve_ts {sts['n']} samples over"
            f" {_fmt(sts.get('total_seconds'), 1)}s | " + "  ".join(parts))
        qd = sts.get("queue_depth")
        if qd:
            spark = _sparkline(sts.get("queue_depth_series") or [])
            lines.append(
                f"serve_ts queue depth p50 {_fmt(qd['p50'], 1)}"
                f" p90 {_fmt(qd['p90'], 1)}"
                + (f"  {spark}" if spark else ""))
    inc = report.get("incidents")
    if inc:
        reasons = "  ".join(f"{k} x{v}"
                            for k, v in sorted(inc["by_reason"].items()))
        lines.append(
            f"incidents {inc['n']} ({reasons})"
            + (f" | dumps: {len(inc['dumps'])}" if inc.get("dumps") else ""))
    src = report.get("sources")
    if src:
        parts = "  ".join(
            f"{name} {_fmt(v['loss']['p50'], 4)} (n={v['n']})"
            for name, v in src.items())
        lines.append(f"sources p50 loss by data_source: {parts}")
    d = report.get("decode")
    if d:
        tbl = "  ".join(f"{k} {_fmt(v, 0)}"
                        for k, v in sorted(d["paths"].items()))
        lines.append(f"decode  tok/s: {tbl}")
    el = report.get("elastic")
    if el:
        deaths = "  ".join(f"host{d['host']}({d['cause']})"
                           for d in el["deaths"]) or "none"
        worlds = "  ".join(f"{a}→{b}" for a, b in el["worlds"])
        lines.append(
            f"elastic {el['restarts']} restart(s) | deaths: {deaths}"
            + (f" | world {worlds}" if worlds else "")
            + f" | recovery total {_fmt(el.get('recovery_seconds_total'), 1)}s"
              f" max {_fmt(el.get('recovery_seconds_max'), 1)}s"
            + (f" | supervisor exit {el['supervisor_exit_code']}"
               if el.get("supervisor_exit_code") is not None else ""))
        if el.get("grows"):
            gworlds = "  ".join(f"{a}→{b}" for a, b in el["grow_worlds"])
            lines.append(
                f"regrow  {el['grows']} grow(s)"
                + (f" | world {gworlds}" if gworlds else "")
                + f" | grow total {_fmt(el.get('grow_seconds_total'), 1)}s"
                  f" max {_fmt(el.get('grow_seconds_max'), 1)}s"
                + (f" | standby promotions {el['standby_promotions']}"
                   if el.get("standby_promotions") else ""))
    return lines


# --- the regression gate ---------------------------------------------------

def compare(base: dict, new: dict, *, tok_tol: float = 0.10,
            mfu_tol: float = 0.10, mem_tol: float = 0.10,
            loss_tol: float = 0.05, overhead_tol: float = 0.10,
            serve_lat_tol: float = 0.25,
            recovery_tol: float = 120.0,
            grow_tol: float = 120.0,
            pack_tol: float = 0.05,
            plan_tol: float = 0.30,
            moe_drop_tol: float = 0.0,
            spec_accept_tol: float = 0.0,
            reject_tol: float = 0.05,
            rpc_overhead_tol: float = 1.0,
            deadline_miss_tol: float = 0.05,
            stall_recovery_tol: float = 30.0,
            queue_wait_tol: float = 1.0,
            tp_parity_tol: float = 0.0,
            fleet_hit_tol: float = 0.05) -> List[dict]:
    """PASS/FAIL/SKIP verdicts for ``new`` against baseline ``base``.

    Relative regressions at or beyond the tolerance FAIL (so exactly-10%
    tok/s loss fails the default gate); metrics absent from either run
    SKIP (CPU runs have no MFU or HBM) — SKIP never fails CI.

    ``overlap_overhead`` is an ABSOLUTE gate: the goodput share lost
    to ``checkpoint_save + data_wait``. Async checkpointing and prefetch exist
    to keep that share near zero, so a run whose combined share grows by
    >= ``overhead_tol`` (fraction-of-wall-clock points, not relative — a
    0.1% -> 0.2% doubling is noise, 2% -> 12% is a broken overlap) FAILs.

    Four elastic gates cover chaos-lane runs (recovery/restarts and
    grow/regrow of the elastic supervisor):

    - ``recovery_seconds_max`` is ABSOLUTE too, but against a fixed
      budget rather than the baseline: the slowest single host-death
      recovery (death detected -> first post-restart heartbeat) must stay
      under ``recovery_tol`` seconds regardless of what the baseline did
      — a recovery that was already slow must not grandfather itself in.
    - ``elastic_restarts`` fails when the new run needed MORE restarts
      than the baseline of the same chaos scenario (each injected fault
      should cost exactly one restart; a second one means the first
      recovery itself died). SKIP when the baseline has no elastic
      records to anchor the count.
    - ``grow_seconds_max`` mirrors the recovery gate for the way back up:
      the slowest single grow-back (capacity grant detected -> first
      heartbeat at the larger world, which includes the graceful drain of
      the smaller attempt) must stay under ``grow_tol`` seconds ABSOLUTE.
    - ``elastic_regrow`` fails when the new run ran with ``allow_grow``,
      lost hosts, and still finished below its desired world — capacity
      came back (or never did) and the run stayed shrunk. SKIP when the
      run didn't opt into growing or lost nothing.

    ``non_pad_frac`` is ABSOLUTE as well: the packed-data non-pad token
    fraction dropping by >= ``pack_tol`` fraction points against the
    baseline FAILs (bin-packing efficiency regressed — first-fit heuristic
    change, bin-flush bug, loader reorder). Relative would mis-scale: a
    0.98 -> 0.93 drop and a 0.40 -> 0.38 drop are both ~5% relative but
    only the first burns five points of paid-for compute. SKIP when either
    run doesn't track packing.

    ``plan_error_frac`` is ABSOLUTE against a fixed budget, like the
    elastic gates: the mesh auto-planner's median predicted-vs-measured
    step-time error (parallel/planner.py, bench.py's per-window
    ``plan_error_frac``) must stay under ``plan_tol`` regardless of the
    baseline — a cost model that's 50% off misranks meshes whether or not
    it was 50% off last week. SKIP when the run carries no mesh_plan
    record with a measured step time.

    ``moe_drop_frac`` is ABSOLUTE against a fixed budget too, and the
    budget defaults to zero: a run whose router telemetry says
    ``moe_impl="dropless"`` (the ``dropless`` marker scalar) must log
    ``drop_frac == 0`` at every captured step — dropless routing admits
    every token by construction (models/moe.py ``_dropless_ffn``), so any
    nonzero drop means the permutation/bincount path is broken. FAIL when
    the worst captured drop_frac exceeds ``moe_drop_tol``; SKIP for
    capacity-mode or non-MoE runs (drops there are a tuning choice, not a
    bug).

    Three front-end gates cover multi-replica serving runs (``kind=
    "frontend"`` records from ``serve_bench --replicas`` /
    ``--workers``):

    - ``frontend_reject_rate`` is ABSOLUTE against a fixed ceiling:
      the share of submitted requests shed at admission must stay under
      ``reject_tol`` regardless of the baseline — backpressure is a
      safety valve, and a valve that is open 20% of the time is an
      undersized fleet (or a routing bug piling work on one replica),
      not a healthy steady state. SKIP when the run has no frontend
      records.
    - ``frontend_affinity`` is categorical: in a routing A/B
      (``serve_bench --ab`` stamps the policy lane's record with the
      random lane's ``random_prefix_hit_rate``), the affinity policy's
      aggregate prefix hit rate must not fall below the random-routing
      baseline measured in the same run. Affinity routing exists only
      to buy cache hits; losing to a coin flip means the key, the
      rendezvous hash, or the spill threshold is broken. SKIP when the
      record set carries no A/B pair.
    - ``frontend_rpc_overhead`` is ABSOLUTE against a fixed budget:
      the p99 per-request RPC overhead of cross-process serving
      (``serve_bench --workers --ab`` stamps the rpc lane's record with
      the submit-to-first-token delta vs the identical in-process fleet
      on the same trace) must stay under ``rpc_overhead_tol`` seconds.
      SKIP on in-process runs (no rpc record, or no A/B delta).
    - ``frontend_deadline_miss`` is ABSOLUTE against a fixed ceiling:
      the fraction of deadline-carrying terminal requests that finished
      (or expired) past their deadline must stay under
      ``deadline_miss_tol`` — an SLO is a promise, not a baseline-
      relative metric. SKIP when the run carried no deadlines (the
      metric is only emitted when deadline margins were observed).
    - ``frontend_stall_recovery`` is ABSOLUTE against a fixed budget:
      the longest single front-end stall on a replica step that ended
      in failover (a hung worker fenced at the RPC timeout, or a death
      mid-call) must stay under ``stall_recovery_tol`` seconds — the
      per-call timeout exists precisely to bound this. SKIP when the
      run had no such stall.
    - ``frontend_fleet_hit`` is ABSOLUTE in fraction points against the
      baseline run: the fleet-wide token-weighted prefix hit rate (device
      hits plus store-fill hits, serve_bench ``--disagg`` /
      ``--kv-store-mb``) dropping by >= ``fleet_hit_tol`` points means
      the digest-addressed store stopped rescuing cross-replica misses —
      a store that hid 60% of prefill yesterday and 40% today is a real
      capacity loss even if both clear some relative bar. Relative would
      mis-scale exactly like ``non_pad_frac``. SKIP when either run has
      no fleet hit rate.
    - ``frontend_disagg_parity`` is categorical, like tp parity: every
      lane that serve_bench pinned against a single undisturbed engine
      (``disagg_token_match``) must match bit-exactly — migration moves
      K/V blocks, never token distributions, so ANY diverged migrated
      stream is a codec/fill/ordering bug, not a regression to tolerate.
      SKIP when the new run pinned nothing.
    """
    def get(report, *keys):
        cur = report
        for k in keys:
            if not isinstance(cur, dict) or cur.get(k) is None:
                return None
            cur = cur[k]
        return cur

    specs = [
        ("tok_per_sec_p50", ("train", "tok_per_sec", "p50"), "higher", tok_tol),
        ("mfu_p50", ("train", "mfu", "p50"), "higher", mfu_tol),
        ("peak_mem_gb", ("train", "peak_mem_gb"), "lower", mem_tol),
        ("final_loss", ("train", "final_loss"), "lower", loss_tol),
        # Serving (serve_bench.py) and decode (decode_bench.py) records:
        # throughput gates share tok_tol; latency gets the looser
        # serve_lat_tol (tail latency is noisier than aggregate tok/s).
        ("serve_tok_per_sec", ("serve", "tokens_per_s"), "higher", tok_tol),
        ("serve_ttft_p99_s", ("serve", "ttft_p99_s"), "lower", serve_lat_tol),
        ("serve_tpot_p99_s", ("serve", "tpot_p99_s"), "lower", serve_lat_tol),
        # Prefix-cache effectiveness: a hit rate dropping against the
        # baseline means sharing broke (digest change, eviction bug, cursor
        # regression). SKIPs when either run didn't serve with the cache on
        # (older records carry no hit rate; a zero baseline is skipped by
        # the b == 0 guard below rather than dividing by it).
        ("serve_prefix_hit_rate",
         ("serve", "prefix_hit_rate"), "higher", serve_lat_tol),
        ("decode_kv_tok_per_sec",
         ("decode", "kv_best_tok_per_sec"), "higher", tok_tol),
        ("effective_tok_per_sec_p50",
         ("packing", "effective_tok_per_sec", "p50"), "higher", tok_tol),
    ]
    verdicts = []
    eps = 1e-9
    for name, keys, better, tol in specs:
        b, n = get(base, *keys), get(new, *keys)
        if b is None or n is None or b == 0:
            verdicts.append({"metric": name, "verdict": "SKIP",
                             "base": b, "new": n})
            continue
        delta = (n - b) / abs(b)
        regression = -delta if better == "higher" else delta
        verdicts.append({
            "metric": name,
            "verdict": "FAIL" if regression >= tol - eps else "PASS",
            "base": b,
            "new": n,
            "delta_pct": round(delta * 100, 2),
            "tolerance_pct": round(tol * 100, 2),
        })

    def overhead(report):
        fr = get(report, "goodput", "fractions")
        if fr is None:
            return None
        vals = [fr.get("checkpoint_save"), fr.get("data_wait")]
        if all(v is None for v in vals):
            return None
        return sum(v for v in vals if v is not None)

    b, n = overhead(base), overhead(new)
    if b is None or n is None:
        verdicts.append({"metric": "overlap_overhead", "verdict": "SKIP",
                         "base": b, "new": n})
    else:
        delta = n - b  # absolute, in fraction-of-wall-clock points
        verdicts.append({
            "metric": "overlap_overhead",
            "verdict": "FAIL" if delta >= overhead_tol - eps else "PASS",
            "base": round(b, 4),
            "new": round(n, 4),
            "delta_pct": round(delta * 100, 2),
            "tolerance_pct": round(overhead_tol * 100, 2),
            "absolute": True,
        })

    b_frac = get(base, "packing", "non_pad_frac")
    n_frac = get(new, "packing", "non_pad_frac")
    if b_frac is None or n_frac is None:
        verdicts.append({"metric": "non_pad_frac", "verdict": "SKIP",
                         "base": b_frac, "new": n_frac})
    else:
        delta = b_frac - n_frac  # absolute, in fraction points
        verdicts.append({
            "metric": "non_pad_frac",
            "verdict": "FAIL" if delta >= pack_tol - eps else "PASS",
            "base": round(b_frac, 4),
            "new": round(n_frac, 4),
            "delta_pct": round(-delta * 100, 2),
            "tolerance_pct": round(pack_tol * 100, 2),
            "absolute": True,
        })

    # Planner prediction-quality gate: only a run that actually measured
    # (bench) carries measured_step_ms; a training CLI --mesh auto run
    # logs the plan without one and SKIPs.
    new_plan_err = (get(new, "plan", "plan_error_frac")
                    if get(new, "plan", "measured_step_ms") is not None
                    else None)
    if new_plan_err is None:
        verdicts.append({"metric": "plan_error_frac", "verdict": "SKIP",
                         "base": get(base, "plan", "plan_error_frac"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "plan_error_frac",
            "verdict": "FAIL" if new_plan_err >= plan_tol - eps else "PASS",
            "base": get(base, "plan", "plan_error_frac"),
            "new": round(new_plan_err, 4),
            "tolerance_frac": plan_tol,
            "absolute": True,
        })

    # Dropless-MoE correctness gate: only gates runs that SAY they are
    # dropless; the worst drop_frac across captured steps must stay at (or
    # under) the absolute budget, baseline irrelevant.
    new_drop_max = (get(new, "router", "drop_frac_max")
                    if get(new, "router", "dropless") else None)
    if new_drop_max is None:
        verdicts.append({"metric": "moe_drop_frac", "verdict": "SKIP",
                         "base": get(base, "router", "drop_frac_max"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "moe_drop_frac",
            "verdict": "FAIL" if new_drop_max > moe_drop_tol + eps else "PASS",
            "base": get(base, "router", "drop_frac_max"),
            "new": round(new_drop_max, 6),
            "tolerance_frac": moe_drop_tol,
            "absolute": True,
        })

    # Speculative-decode acceptance gate: only gates runs whose serve
    # record ran with a proposer; mean accepted drafts per verify step
    # must clear the absolute floor (0.0 default = always passes — set
    # per workload, e.g. --spec-accept-tol 1.0 on a repetitive trace).
    new_accept = (get(new, "serve", "spec_accept_mean")
                  if (get(new, "serve", "spec") or "off") != "off" else None)
    if new_accept is None:
        verdicts.append({"metric": "spec_accept_mean", "verdict": "SKIP",
                         "base": get(base, "serve", "spec_accept_mean"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "spec_accept_mean",
            "verdict": ("FAIL" if new_accept < spec_accept_tol - eps
                        else "PASS"),
            "base": get(base, "serve", "spec_accept_mean"),
            "new": round(new_accept, 4),
            "tolerance": spec_accept_tol,
            "absolute": True,
        })

    new_rec_max = get(new, "elastic", "recovery_seconds_max")
    if new_rec_max is None:
        verdicts.append({"metric": "recovery_seconds_max", "verdict": "SKIP",
                         "base": get(base, "elastic", "recovery_seconds_max"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "recovery_seconds_max",
            "verdict": "FAIL" if new_rec_max >= recovery_tol - eps else "PASS",
            "base": get(base, "elastic", "recovery_seconds_max"),
            "new": round(new_rec_max, 2),
            "tolerance_s": recovery_tol,
            "absolute": True,
        })

    b_restarts = get(base, "elastic", "restarts")
    n_restarts = get(new, "elastic", "restarts")
    if b_restarts is None or n_restarts is None:
        verdicts.append({"metric": "elastic_restarts", "verdict": "SKIP",
                         "base": b_restarts, "new": n_restarts})
    else:
        verdicts.append({
            "metric": "elastic_restarts",
            "verdict": "FAIL" if n_restarts > b_restarts else "PASS",
            "base": b_restarts,
            "new": n_restarts,
            "absolute": True,
        })

    new_grow_max = get(new, "elastic", "grow_seconds_max")
    if new_grow_max is None:
        verdicts.append({"metric": "grow_seconds_max", "verdict": "SKIP",
                         "base": get(base, "elastic", "grow_seconds_max"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "grow_seconds_max",
            "verdict": "FAIL" if new_grow_max >= grow_tol - eps else "PASS",
            "base": get(base, "elastic", "grow_seconds_max"),
            "new": round(new_grow_max, 2),
            "tolerance_s": grow_tol,
            "absolute": True,
        })

    # Failure-to-regrow: a run that lost hosts under --allow_grow and
    # finished BELOW the world it wanted never got back up — the grow
    # probe, capacity protocol, or relaunch is broken even if every
    # recovery individually passed.
    n_el = new.get("elastic") if isinstance(new.get("elastic"), dict) else {}
    wants_regrow = (n_el.get("allow_grow") and n_el.get("deaths")
                    and n_el.get("desired_world") is not None
                    and n_el.get("final_world") is not None)
    if not wants_regrow:
        verdicts.append({"metric": "elastic_regrow", "verdict": "SKIP",
                         "base": None, "new": n_el.get("final_world")})
    else:
        verdicts.append({
            "metric": "elastic_regrow",
            "verdict": ("PASS" if n_el["final_world"] >= n_el["desired_world"]
                        else "FAIL"),
            "base": n_el["desired_world"],
            "new": n_el["final_world"],
            "absolute": True,
        })

    new_reject = get(new, "frontend", "reject_rate")
    if new_reject is None:
        verdicts.append({"metric": "frontend_reject_rate", "verdict": "SKIP",
                         "base": get(base, "frontend", "reject_rate"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "frontend_reject_rate",
            "verdict": "FAIL" if new_reject > reject_tol + eps else "PASS",
            "base": get(base, "frontend", "reject_rate"),
            "new": round(new_reject, 4),
            "tolerance_frac": reject_tol,
            "absolute": True,
        })

    # Sharded-decode parity is categorical, like span conservation: a
    # tensor-parallel lane whose greedy stream diverges from its
    # unsharded (or no-fault) base lane leaked the sharded compute path
    # into the tokens — exactness is by construction, so ANY mismatch
    # past ``tp_parity_tol`` (a fraction of sharded lanes, default 0 —
    # one diverged lane fails) is a bug, not a regression to tolerate.
    # SKIP when the new run served nothing sharded.
    n_tpp = get(new, "tp_parity") or {}
    if not n_tpp:
        verdicts.append({"metric": "serve_tp_parity", "verdict": "SKIP",
                         "base": (get(base, "tp_parity") or {}).get(
                             "mismatched"),
                         "new": None})
    else:
        frac = n_tpp["mismatched"] / max(n_tpp["records"], 1)
        verdicts.append({
            "metric": "serve_tp_parity",
            "verdict": "FAIL" if frac > tp_parity_tol + eps else "PASS",
            "base": (get(base, "tp_parity") or {}).get("mismatched"),
            "new": n_tpp["mismatched"],
            "tolerance": tp_parity_tol,
            "absolute": True,
        })

    # Affinity-vs-random A/B (both hit rates come from the SAME run's
    # record set — see summarize — so this never compares across trees).
    n_ab = get(new, "frontend", "ab") or {}
    aff_hit = n_ab.get("prefix_hit_rate")
    rnd_hit = n_ab.get("random_prefix_hit_rate")
    if aff_hit is None or rnd_hit is None:
        verdicts.append({"metric": "frontend_affinity", "verdict": "SKIP",
                         "base": None, "new": aff_hit})
    else:
        verdicts.append({
            "metric": "frontend_affinity",
            "verdict": "FAIL" if aff_hit < rnd_hit - eps else "PASS",
            "base": round(rnd_hit, 4),
            "new": round(aff_hit, 4),
            "absolute": True,
        })

    # RPC overhead is ABSOLUTE against a fixed budget, like the elastic
    # gates: the p99 per-request submit-to-first-token cost of the wire
    # (measured by serve_bench --workers --ab against the identical
    # in-process fleet on the same trace) must stay under
    # ``rpc_overhead_tol`` seconds regardless of the baseline — framing
    # + socket dispatch costing a second per request is broken whether
    # or not it was broken last week. SKIP on in-process runs (no rpc
    # record or no A/B to measure the delta against).
    new_ovh = get(new, "frontend", "rpc_overhead_p99_s")
    if new_ovh is None:
        verdicts.append({"metric": "frontend_rpc_overhead",
                         "verdict": "SKIP",
                         "base": get(base, "frontend", "rpc_overhead_p99_s"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "frontend_rpc_overhead",
            "verdict": "FAIL" if new_ovh > rpc_overhead_tol + eps else "PASS",
            "base": get(base, "frontend", "rpc_overhead_p99_s"),
            "new": round(new_ovh, 5),
            "tolerance_s": rpc_overhead_tol,
            "absolute": True,
        })

    # Deadline misses and hung-RPC stalls are ABSOLUTE against fixed
    # budgets: an SLO miss rate or a failover stall that was already bad
    # in the baseline must not grandfather itself in. Both SKIP when the
    # run never observed the metric (no deadlines attached; no failover
    # stall) — emission is conditional in frontend.summary() for exactly
    # this reason.
    new_miss = get(new, "frontend", "deadline_miss_rate")
    if new_miss is None:
        verdicts.append({"metric": "frontend_deadline_miss",
                         "verdict": "SKIP",
                         "base": get(base, "frontend", "deadline_miss_rate"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "frontend_deadline_miss",
            "verdict": "FAIL" if new_miss > deadline_miss_tol + eps
            else "PASS",
            "base": get(base, "frontend", "deadline_miss_rate"),
            "new": round(new_miss, 5),
            "tolerance_frac": deadline_miss_tol,
            "absolute": True,
        })
    new_stall = get(new, "frontend", "stall_recovery_max_s")
    if new_stall is None:
        verdicts.append({"metric": "frontend_stall_recovery",
                         "verdict": "SKIP",
                         "base": get(base, "frontend",
                                     "stall_recovery_max_s"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "frontend_stall_recovery",
            "verdict": "FAIL" if new_stall > stall_recovery_tol + eps
            else "PASS",
            "base": get(base, "frontend", "stall_recovery_max_s"),
            "new": round(new_stall, 5),
            "tolerance_s": stall_recovery_tol,
            "absolute": True,
        })

    # Fleet-wide prefix hit rate is ABSOLUTE in fraction points against
    # the baseline run (the disagg summary's store-bearing lane wins,
    # falling back to the newest frontend record): the whole point of
    # the fleet store is that rate, so it regresses in points, not
    # percent-of-itself.
    def fleet_hit(report):
        v = get(report, "disagg", "fleet_prefix_hit_rate")
        return v if v is not None else get(
            report, "frontend", "fleet_prefix_hit_rate")

    b_fleet, n_fleet = fleet_hit(base), fleet_hit(new)
    if b_fleet is None or n_fleet is None:
        verdicts.append({"metric": "frontend_fleet_hit", "verdict": "SKIP",
                         "base": b_fleet, "new": n_fleet})
    else:
        delta = b_fleet - n_fleet  # absolute, in fraction points
        verdicts.append({
            "metric": "frontend_fleet_hit",
            "verdict": "FAIL" if delta >= fleet_hit_tol - eps else "PASS",
            "base": round(b_fleet, 4),
            "new": round(n_fleet, 4),
            "tolerance_frac": fleet_hit_tol,
            "absolute": True,
        })

    # Migrated-stream parity is categorical, like tp parity and span
    # conservation: any lane whose streams diverged from the
    # single-engine pin FAILs, whatever the baseline did.
    n_dis = get(new, "disagg") or {}
    if not n_dis.get("records"):
        verdicts.append({"metric": "frontend_disagg_parity",
                         "verdict": "SKIP",
                         "base": (get(base, "disagg") or {}).get(
                             "mismatched"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "frontend_disagg_parity",
            "verdict": "FAIL" if n_dis["mismatched"] else "PASS",
            "base": (get(base, "disagg") or {}).get("mismatched"),
            "new": n_dis["mismatched"],
            "absolute": True,
        })

    # Queue-wait p99 is ABSOLUTE against a fixed budget: admission-to-
    # arrival latency is an SLO input, not a baseline-relative number —
    # a queue that was already slow must not grandfather itself in.
    # Preferred source: the span-trace phase percentiles (spans carry
    # the true first-admission wait even across failover); falls back to
    # the serve/frontend records' queue_wait series. SKIP when the run
    # traced no queue waits at all.
    new_qw = get(new, "spans", "phases", "queue_wait", "p99")
    if new_qw is None:
        new_qw = get(new, "serve", "queue_wait_p99_s")
    if new_qw is None:
        new_qw = get(new, "frontend", "queue_wait_p99_s")
    if new_qw is None:
        verdicts.append({"metric": "serve_queue_wait_p99",
                         "verdict": "SKIP",
                         "base": get(base, "spans", "phases",
                                     "queue_wait", "p99"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "serve_queue_wait_p99",
            "verdict": "FAIL" if new_qw > queue_wait_tol + eps else "PASS",
            "base": get(base, "spans", "phases", "queue_wait", "p99"),
            "new": round(new_qw, 5),
            "tolerance_s": queue_wait_tol,
            "absolute": True,
        })

    # Span conservation is CATEGORICAL: every opened rid in the new
    # run's span records must close with exactly one terminal event
    # (or an explicit handoff). A dropped or doubled terminal is a
    # bookkeeping bug whatever the baseline did. SKIP when the run
    # emitted no span records.
    new_cons = get(new, "spans", "conservation_ok")
    if new_cons is None:
        verdicts.append({"metric": "span_conservation", "verdict": "SKIP",
                         "base": get(base, "spans", "conservation_ok"),
                         "new": None})
    else:
        verdicts.append({
            "metric": "span_conservation",
            "verdict": "PASS" if new_cons else "FAIL",
            "base": get(base, "spans", "conservation_ok"),
            "new": bool(new_cons),
            "absolute": True,
        })
    return verdicts


def render_verdicts(verdicts: List[dict]) -> List[str]:
    lines = ["== regression gate (new vs base) =="]
    for v in verdicts:
        if v["verdict"] == "SKIP":
            lines.append(f"SKIP {v['metric']:<16} (absent in one run)")
        elif "delta_pct" in v:
            kind = " abs" if v.get("absolute") else ""
            lines.append(
                f"{v['verdict']} {v['metric']:<16} base {_fmt(v['base'], 4)}"
                f" new {_fmt(v['new'], 4)} ({v['delta_pct']:+.1f}%{kind},"
                f" tol {v['tolerance_pct']:.0f}%{kind})")
        else:
            if v.get("tolerance_s") is not None:
                tol = f", tol {_fmt(v['tolerance_s'], 0)}s abs"
            elif v.get("tolerance_frac") is not None:
                tol = f", tol {_fmt(v['tolerance_frac'] * 100, 0)}% abs"
            elif v.get("tolerance") is not None:
                # Plain-units absolute floor (e.g. accepted tokens/step).
                tol = f", floor {_fmt(v['tolerance'], 2)} abs"
            else:
                tol = ""
            lines.append(
                f"{v['verdict']} {v['metric']:<16} base {_fmt(v['base'], 2)}"
                f" new {_fmt(v['new'], 2)} (absolute{tol})")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpu_trainer_torch.tools.analyze",
        description="Analyze a training-run metrics JSONL; optionally gate "
                    "it against a baseline run.")
    parser.add_argument("run", help="metrics JSONL of the run to analyze")
    parser.add_argument("--compare", metavar="BASE",
                        help="baseline JSONL; exit 1 on regression")
    parser.add_argument("--tok-tol", type=float, default=0.10,
                        help="tok/s relative tolerance (default 0.10)")
    parser.add_argument("--mfu-tol", type=float, default=0.10)
    parser.add_argument("--mem-tol", type=float, default=0.10)
    parser.add_argument("--loss-tol", type=float, default=0.05)
    parser.add_argument("--serve-lat-tol", type=float, default=0.25,
                        help="serve p99 TTFT/TPOT relative tolerance "
                             "(default 0.25)")
    parser.add_argument("--overhead-tol", type=float, default=0.10,
                        help="ABSOLUTE gate on the checkpoint_save + "
                             "data_wait goodput share: FAIL if the new "
                             "run's share grows by >= this many fraction-"
                             "of-wall-clock points (default 0.10)")
    parser.add_argument("--pack-tol", type=float, default=0.05,
                        help="ABSOLUTE gate on the packed-data non-pad "
                             "token fraction: FAIL if the new run's "
                             "fraction drops by >= this many fraction "
                             "points vs the baseline (default 0.05)")
    parser.add_argument("--recovery-tol", type=float, default=120.0,
                        help="ABSOLUTE gate on elastic recovery: FAIL if "
                             "any single host-death recovery in the new "
                             "run took >= this many seconds (default 120)")
    parser.add_argument("--grow-tol", type=float, default=120.0,
                        help="ABSOLUTE gate on elastic grow-back: FAIL if "
                             "any single world re-expansion (grant "
                             "detected -> first grown-world heartbeat) "
                             "took >= this many seconds (default 120)")
    parser.add_argument("--plan-tol", type=float, default=0.30,
                        help="ABSOLUTE gate on the mesh auto-planner: FAIL "
                             "if the new run's median predicted-vs-measured "
                             "step-time error is >= this fraction (default "
                             "0.30); SKIP when the run carries no mesh_plan "
                             "record with a measured step time")
    parser.add_argument("--moe-drop-tol", type=float, default=0.0,
                        help="ABSOLUTE gate on dropless-MoE routing: FAIL "
                             "if a run whose router telemetry is marked "
                             "dropless logged drop_frac above this value "
                             "at any captured step (default 0.0 — dropless "
                             "means dropless); SKIP for capacity-mode or "
                             "non-MoE runs")
    parser.add_argument("--spec-accept-tol", type=float, default=0.0,
                        help="ABSOLUTE gate on speculative decoding: FAIL "
                             "if a spec-enabled serve run's mean accepted "
                             "drafts per verify step falls below this floor "
                             "(default 0.0 — always passes); SKIP when the "
                             "new run served without a proposer")
    parser.add_argument("--reject-tol", type=float, default=0.05,
                        help="ABSOLUTE gate on front-end admission: FAIL "
                             "if a multi-replica serving run rejected more "
                             "than this fraction of submitted requests "
                             "(default 0.05); SKIP when the run has no "
                             "frontend records. The affinity-vs-random "
                             "hit-rate gate needs no tolerance: affinity "
                             "losing to random in the same --ab run is a "
                             "categorical FAIL")
    parser.add_argument("--rpc-overhead-tol", type=float, default=1.0,
                        help="ABSOLUTE gate on cross-process serving: FAIL "
                             "if the p99 per-request RPC overhead (the "
                             "submit-to-first-token delta vs the identical "
                             "in-process fleet, serve_bench --workers --ab) "
                             "exceeds this many seconds (default 1.0); SKIP "
                             "on in-process runs")
    parser.add_argument("--deadline-miss-tol", type=float, default=0.05,
                        help="ABSOLUTE gate on request deadlines: FAIL if "
                             "more than this fraction of deadline-carrying "
                             "requests finished or expired past their "
                             "deadline (default 0.05); SKIP when the run "
                             "attached no deadlines")
    parser.add_argument("--stall-recovery-tol", type=float, default=30.0,
                        help="ABSOLUTE gate on failover stalls: FAIL if "
                             "the longest front-end stall on a replica "
                             "step that ended in failover (hung worker "
                             "fenced at the RPC timeout, or death mid-"
                             "call) exceeds this many seconds (default "
                             "30); SKIP when the run had no such stall")
    parser.add_argument("--queue-wait-tol", type=float, default=1.0,
                        help="ABSOLUTE gate on serving queue wait: FAIL if "
                             "the new run's p99 admission-to-arrival wait "
                             "(span traces, else the serve/frontend "
                             "queue_wait series) exceeds this many seconds "
                             "(default 1.0); SKIP when the run traced no "
                             "queue waits. Span conservation needs no "
                             "tolerance: an opened rid without exactly one "
                             "terminal event is a categorical FAIL")
    parser.add_argument("--tp-parity-tol", type=float, default=0.0,
                        help="ABSOLUTE gate on sharded (tensor-parallel) "
                             "decode: FAIL if more than this fraction of "
                             "the run's sharded lanes diverged token-wise "
                             "from their unsharded / no-fault base lane "
                             "(default 0.0 — sharded decode is exact by "
                             "construction, one diverged lane fails); "
                             "SKIP when the run served nothing sharded")
    parser.add_argument("--fleet-hit-tol", type=float, default=0.05,
                        help="ABSOLUTE gate on the fleet-wide token-"
                             "weighted prefix hit rate (device + KV-store "
                             "fills, serve_bench --disagg / --kv-store-mb): "
                             "FAIL if the new run's rate drops by >= this "
                             "many fraction points vs the baseline "
                             "(default 0.05); SKIP when either run has no "
                             "fleet hit rate. Migrated-stream parity vs "
                             "the single-engine pin needs no tolerance: "
                             "any diverged stream is a categorical FAIL")
    parser.add_argument("--json", action="store_true",
                        help="print the report (and verdicts) as JSON")
    args = parser.parse_args(argv)

    try:
        report = summarize(load_records(args.run))
    except SchemaError as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2

    verdicts = None
    if args.compare:
        try:
            base_report = summarize(load_records(args.compare))
        except SchemaError as e:
            print(f"analyze: {e}", file=sys.stderr)
            return 2
        verdicts = compare(
            base_report, report, tok_tol=args.tok_tol, mfu_tol=args.mfu_tol,
            mem_tol=args.mem_tol, loss_tol=args.loss_tol,
            overhead_tol=args.overhead_tol,
            serve_lat_tol=args.serve_lat_tol,
            recovery_tol=args.recovery_tol, grow_tol=args.grow_tol,
            pack_tol=args.pack_tol, plan_tol=args.plan_tol,
            moe_drop_tol=args.moe_drop_tol,
            spec_accept_tol=args.spec_accept_tol,
            reject_tol=args.reject_tol,
            rpc_overhead_tol=args.rpc_overhead_tol,
            deadline_miss_tol=args.deadline_miss_tol,
            stall_recovery_tol=args.stall_recovery_tol,
            queue_wait_tol=args.queue_wait_tol,
            tp_parity_tol=args.tp_parity_tol,
            fleet_hit_tol=args.fleet_hit_tol)

    exit_code = (1 if verdicts is not None
                 and any(v["verdict"] == "FAIL" for v in verdicts) else 0)
    if args.json:
        # Machine-readable envelope for CI: the full report, the verdict
        # list (each row carries metric / verdict / base / new and, when
        # the gate evaluated, delta + tolerance), a PASS/FAIL/SKIP tally,
        # and the exit code the process is about to return — so a caller
        # parsing stdout never has to re-derive the gate decision.
        gate = None
        if verdicts is not None:
            gate = {k: sum(1 for v in verdicts if v["verdict"] == k)
                    for k in ("PASS", "FAIL", "SKIP")}
        print(json.dumps({"report": report, "verdicts": verdicts,
                          "gate": gate, "exit_code": exit_code}, indent=1))
    else:
        for line in render(report):
            print(line)
        if verdicts is not None:
            for line in render_verdicts(verdicts):
                print(line)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
