"""Standalone mesh auto-planner CLI (port of ``tpu_trainer/tools/plan.py``).

Prints the ranked plan table for a model preset and device count without
building a trainer (shape arithmetic only, so a plan for eight H100s
comes from a laptop):

    python -m tpu_trainer_torch.tools.plan --model small --devices 8 \
        --device-kind "NVIDIA H100 80GB HBM3"
    python -m tpu_trainer_torch.tools.plan --model medium --devices 4 \
        --hbm_gb 40 --strategy zero3

``--json`` prints the whole ``kind:"mesh_plan"`` record (the record a
``--mesh auto`` training run logs to its JSONL). The memory estimate
holds no compute-dtype copy of the parameters (``carry_cast`` off): the
port casts a weight where it is used, as the ``--mesh auto`` run plans.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.parallel import planner


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_trainer_torch.tools.plan",
        description="Rank feasible data x fsdp x sequence x tensor x expert "
                    "x stage meshes for a model and device count from the "
                    "analytic comms + roofline model.")
    p.add_argument("--model", default="small",
                   help="GPTConfig preset (small/medium/large/xl) or 'tiny'")
    p.add_argument("--devices", type=int, default=None,
                   help="device count to plan for (default: the process "
                        "group's world size, else torch.cuda.device_count())")
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-data-shard rows per micro-batch used to derive "
                        "the fixed global batch (default 8)")
    p.add_argument("--global-batch", type=int, default=None,
                   help="global rows per micro-batch held fixed across "
                        "candidates (default: batch-size * devices)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="training sequence length (default: the model's "
                        "max_seq_len)")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation steps (default 1)")
    p.add_argument("--strategy", default="zero3",
                   help="sharding strategy to plan under (default zero3)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="make the FFNs MoE with this many experts (opens "
                        "the expert axis)")
    p.add_argument("--hbm_gb", "--hbm-gb", dest="hbm_gb", type=float,
                   default=None,
                   help="per-device memory budget in GiB (default: the "
                        "local CUDA card's total; none on the CPU)")
    p.add_argument("--device-kind", default="",
                   help="plan for this device kind's link and FLOPs tables "
                        "(a CUDA name such as 'NVIDIA H100 80GB HBM3', or a "
                        "TPU kind) instead of the local device")
    p.add_argument("--top-k", type=int, default=10,
                   help="rows in the ranked table (default 10)")
    p.add_argument("--json", action="store_true",
                   help="print the full mesh_plan record as JSON")
    return p


def _model_config(args) -> GPTConfig:
    extra = {}
    if args.seq_len:
        extra["max_seq_len"] = args.seq_len
    if args.num_experts:
        extra["num_experts"] = args.num_experts
        extra["moe_top_k"] = min(2, args.num_experts)
    if args.model == "tiny":
        return GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, **extra)
    return GPTConfig.preset(args.model, **extra)


def _device_count() -> int:
    """The process group's world size, else the CUDA cards here (at
    least 1)."""
    import torch

    from tpu_trainer_torch.parallel import mesh as mesh_lib

    if mesh_lib.process_count() > 1:
        return mesh_lib.process_count()
    return max(1, torch.cuda.device_count())


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    devices = args.devices if args.devices is not None else _device_count()
    model_config = _model_config(args)
    seq_len = args.seq_len or model_config.max_seq_len
    global_rows = args.global_batch or args.batch_size * devices
    try:
        record = planner.plan(
            model_config, devices,
            global_rows=global_rows, max_seq_len=seq_len,
            grad_accum=args.accum, strategy=args.strategy,
            device_kind=args.device_kind, hbm_gb=args.hbm_gb,
            carry_cast=False, top_k=args.top_k)
    except planner.NoFeasiblePlanError as e:
        print(f"plan: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(record))
    else:
        print("\n".join(planner.render_table(record)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
