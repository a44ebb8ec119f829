"""Inference CLI (port of ``tpu_trainer/eval/infer.py``): checkpoint ->
generation -> text. Run::

    python -m tpu_trainer_torch.eval.infer --checkpoint checkpoints/gpt2-small \\
        --prompt "Once upon a time" --max_new_tokens 100 --tokenizer byte

``--checkpoint`` is a step dir, a checkpoint root (its latest step), or a
consolidated ``params.npz`` (``utils/checkpoint.export_consolidated``; its
config from a ``meta.json`` beside it, else ``--model_size``). Decoding
goes through the contiguous KV cache (``models/gpt.generate_kv``), the
windowed full forward with ``--no_kv_cache`` (``generate``), or
the paged serving engine with ``--serve`` (one request a prompt, seed
``--seed`` + row, decode attention through the flash-decode kernel on the
card). ``--prompt_file`` decodes one ragged batch, a prompt a line.
``--serve --spec {ngram,draft}`` decodes speculatively (``--spec_k``
drafts a step; ``--spec_draft_layers`` of the checkpoint's layers make
the draft model); greedy output is the plain ``--serve`` output.

``--mesh_data N`` decodes on N processes (launched as the training CLI
is, e.g. ``torchrun --nproc_per_node N``): the prompt rows split over the
ranks in order (their count must divide), each rank decodes its rows on
the KV path with the global width and row seeds (a MoE model routes every
rank's rows together, as one process routes the whole batch), and rank 0
gathers and prints every row, the tokens the one-process run gives.

``--mesh_tensor T`` (the JAX ``infer.py`` sharded decode) adds Megatron
tensor parallelism on the same KV path: ``--mesh_data`` x ``--mesh_tensor``
processes, rank ``d * T + t``; each rank loads its tensor slice of the
parameters (``models/weights.build_model(tensor=)``), its KV cache holds
its ``kv_heads / T`` heads, the row-parallel products and the head's
logits are summed over the tensor group (``models/gpt.py``), so every
tensor rank samples the same tokens; a MoE layer runs its tensor slice of
every expert's FFN and sums the layer's output over the tensor group
(``models/moe.py``). ``fused_projections`` is turned off (the JAX
gate). ``--serve`` with a mesh stays refused, as in JAX: the paged TP
decode is the serving engine's own (``ServingEngine(mesh_tensor=)``,
``serving/sharding.py``), not this CLI's.

Runs on CUDA unless ``--device cpu``; without a GPU and without that flag
it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import torch

from tpu_trainer_torch.models.config import GPTConfig
from tpu_trainer_torch.models.gpt import generate, generate_kv
from tpu_trainer_torch.models.weights import build_model
from tpu_trainer_torch.parallel import collectives as coll_lib
from tpu_trainer_torch.parallel import context as ctx_lib
from tpu_trainer_torch.parallel import mesh as mesh_lib
from tpu_trainer_torch.utils.checkpoint import (latest_checkpoint,
                                                restore_params)
from tpu_trainer_torch.utils.device import resolve_device
from tpu_trainer_torch.utils.tokenizer import get_tokenizer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate text from a checkpoint")
    a = p.add_argument
    a("--checkpoint", required=True,
      help="step dir, checkpoint root (picks the latest), or params.npz")
    a("--model_size", default=None, choices=["small", "medium", "large", "xl"],
      help="config of a consolidated file without a meta.json beside it")
    a("--prompt", default="Once upon a time")
    a("--max_new_tokens", type=int, default=100)
    a("--temperature", type=float, default=0.8)
    a("--top_k", type=int, default=50)
    a("--seed", type=int, default=0)
    a("--tokenizer", default="gpt2")
    a("--device", default=None, choices=["cuda", "cpu"],
      help="cuda (default) or cpu; without a GPU, cuda raises")
    a("--no_kv_cache", action="store_true",
      help="the windowed full-forward sampler instead of the KV cache")
    a("--prompt_file", default=None,
      help="one prompt a line, decoded as one ragged batch (KV path)")
    a("--serve", action="store_true",
      help="decode through the paged serving engine, a request a prompt")
    a("--serve_batch", type=int, default=8)
    a("--serve_block_size", type=int, default=16)
    a("--spec", default="off", choices=["off", "ngram", "draft"],
      help="speculative decoding proposer (with --serve); greedy output "
           "is the same either way")
    a("--spec_k", type=int, default=4,
      help="max draft tokens per verify step (with --spec)")
    a("--spec_draft_layers", type=int, default=1,
      help="checkpoint layers sliced into the draft model (--spec draft)")
    a("--record_trace", default=None, metavar="OUT.JSONL",
      help="append each served prompt/response as a replayable trace "
           "record (with --serve)")
    a("--mesh_data", type=int, default=1)
    a("--mesh_tensor", type=int, default=1)
    return p


def main(argv=None, *, result: Optional[dict] = None) -> int:
    """Decode and print one text a prompt. ``result`` (a dict), when
    given, receives ``tokens`` (each row's prompt + generated ids) and,
    with ``--serve``, the engine's ``stats``. A process that joined the
    process group here leaves it when it returns
    (``mesh.shutdown_distributed``, as ``training/cli.run_training``
    does); a group its caller made is kept."""
    joined = mesh_lib.process_count() > 1
    try:
        return _main(argv, result)
    finally:
        if not joined and mesh_lib.process_count() > 1:
            mesh_lib.shutdown_distributed()


def _main(argv, result: Optional[dict]) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    shards, tp = args.mesh_data, args.mesh_tensor
    sizes = None
    if shards * tp > 1:
        if device.type == "cuda":
            device = mesh_lib.local_device(device)
        mesh_lib.initialize_distributed(device=device)
        try:
            sizes = mesh_lib.MeshConfig(data=shards, tensor=tp).resolve(
                mesh_lib.process_count())
        except ValueError as mesh_err:
            raise SystemExit(f"mesh: {mesh_err}") from mesh_err
    rank = mesh_lib.process_index() if sizes is not None else 0
    data_rank, tensor_rank = divmod(rank, tp)

    path = latest_checkpoint(args.checkpoint) or args.checkpoint
    if not os.path.exists(path):
        p.error(f"checkpoint not found: {path}")
    if os.path.isdir(path) and not os.path.exists(
            os.path.join(path, "meta.json")):
        p.error(f"no checkpoint (meta.json) at {path}; pass a step dir, a "
                f"checkpoint root holding step_* dirs, or a params.npz")
    params, config = restore_params(path)
    if args.model_size is not None:
        config = GPTConfig.preset(args.model_size)
    if config is None:
        p.error("--model_size is required for a consolidated file without "
                "a meta.json beside it")
    # Decoding is evaluation: no dropout.
    config = dataclasses.replace(config, dropout=0.0, attention_dropout=0.0)
    if tp > 1:
        for what, n in (("num_heads", config.num_heads),
                        ("num_kv_heads", config.kv_heads)):
            if n % tp:
                p.error(f"{what} {n} not divisible by --mesh_tensor {tp}")
        # TP shards the q/k/v kernels along the axis the fusion
        # concatenates (the Trainer's gate).
        config = dataclasses.replace(config, fused_projections=False)

    tokenizer = get_tokenizer(args.tokenizer)
    if args.prompt_file:
        with open(args.prompt_file) as f:
            prompts = [ln.rstrip("\n") for ln in f if ln.strip()]
        if not prompts:
            p.error(f"no prompts in {args.prompt_file}")
    else:
        prompts = [args.prompt]
    eos = min(tokenizer.eos_token_id, config.vocab_size - 1)
    rows = [tokenizer.encode(pr) or [eos] for pr in prompts]
    top = max(max(r) for r in rows)
    if top >= config.vocab_size:
        p.error(f"prompt tokenizes to id {top} but the checkpoint's model "
                f"has vocab_size {config.vocab_size}: tokenizer/model "
                f"mismatch (tokenizer: {tokenizer.name})")
    lens = [len(r) for r in rows]
    width = max(lens)
    fits = width + args.max_new_tokens <= config.max_seq_len
    use_kv = fits and not args.no_kv_cache
    if len(set(lens)) > 1 and not use_kv and not args.serve:
        p.error("ragged multi-prompt decode needs the KV path: shorten "
                "--max_new_tokens to fit max_seq_len, or drop --no_kv_cache")
    if args.record_trace and not args.serve:
        p.error("--record_trace records served requests; add --serve")
    if args.spec != "off" and not args.serve:
        p.error("--spec is a serving-engine feature; add --serve")
    if sizes is not None:
        if args.serve or not use_kv:
            p.error("--mesh_data / --mesh_tensor decode on the KV path: "
                    "drop --serve / --no_kv_cache and fit --max_new_tokens "
                    "in max_seq_len")
        if len(rows) % shards:
            p.error(f"{len(rows)} prompts not divisible by --mesh_data "
                    f"{shards}")

    if args.serve:
        if args.no_kv_cache:
            p.error("--serve is the paged KV path; drop --no_kv_cache")
        if not fits:
            p.error("prompt + --max_new_tokens exceeds max_seq_len")
        from tpu_trainer_torch.serving.engine import ServingEngine
        from tpu_trainer_torch.serving.scheduler import (Request,
                                                         SamplingParams)
        from tpu_trainer_torch.serving.spec import draft_from_target

        state = {n: torch.from_numpy(v) for n, v in params.items()}
        draft_params = draft_config = None
        if args.spec == "draft":
            if args.spec_draft_layers >= config.num_layers:
                p.error(f"--spec_draft_layers {args.spec_draft_layers} must "
                        f"be < the checkpoint's {config.num_layers} layers")
            draft_params, draft_config = draft_from_target(
                state, config, args.spec_draft_layers)
        engine = ServingEngine(
            state, config,
            max_batch=min(len(rows), args.serve_batch),
            block_size=args.serve_block_size, spec=args.spec,
            spec_k=args.spec_k, draft_params=draft_params,
            draft_config=draft_config, device=device)
        reqs = [Request(rid=i, prompt=list(r),
                        max_new_tokens=args.max_new_tokens,
                        sampling=SamplingParams(temperature=args.temperature,
                                                top_k=args.top_k,
                                                seed=args.seed + i))
                for i, r in enumerate(rows)]
        finished = sorted(engine.run(reqs, time_mode="steps"),
                          key=lambda r: r.rid)
        out = [list(r.prompt) + list(r.generated) for r in finished]
        for row in out:
            print(tokenizer.decode(row))
        if args.record_trace:
            with open(args.record_trace, "a") as fh:
                for i, r in enumerate(finished):
                    fh.write(json.dumps({
                        "prompt_len": len(r.prompt),
                        "max_new": r.max_new_tokens,
                        "arrival_time": r.arrival_time,
                        "temperature": r.sampling.temperature,
                        "top_k": r.sampling.top_k,
                        "top_p": r.sampling.top_p,
                        "seed": r.sampling.seed,
                        "prompt_tokens": [int(t) for t in r.prompt],
                        "tokenizer": tokenizer.name,
                        "prompt_text": prompts[i],
                        "response_text": tokenizer.decode(r.generated),
                    }) + "\n")
        if result is not None:
            result.update(tokens=out, stats=dict(engine.stats))
        return 0

    model = build_model(config, params, device, tensor=(tensor_rank, tp))
    mesh = None
    if tp > 1 or (shards > 1 and config.num_experts > 0):
        topo = coll_lib.topology(shards, 1, 1, tp)
        if shards > 1 and config.num_experts > 0:
            # The data shards route their rows together (the tensor ranks
            # of a shard hold the same rows).
            model.moe_group = topo.rep
        if tp > 1:
            mesh = ctx_lib.MeshContext(
                sizes=sizes, coords=mesh_lib.mesh_coords(sizes, rank),
                tensor=topo.tensor, expert_tensor=topo.expert_tensor)
    # This rank's rows (all of them at one process), at the global width
    # and with their global row seeds.
    per = len(rows) // shards
    lo = data_rank * per
    mine = range(lo, lo + per)
    input_ids = torch.tensor([rows[i] + [0] * (width - lens[i])
                              for i in mine], dtype=torch.long, device=device)
    kw = dict(max_new_tokens=args.max_new_tokens,
              temperature=args.temperature, top_k=args.top_k,
              seed=args.seed + lo)
    with ctx_lib.use_mesh(mesh):
        if use_kv:
            prompt_lens = (torch.tensor([lens[i] for i in mine],
                                        device=device)
                           if len(set(lens)) > 1 else None)
            buf = generate_kv(model, input_ids, prompt_lens=prompt_lens,
                              **kw)
        else:
            buf = generate(model, input_ids, **kw)
    buf = buf.cpu().tolist()
    out = []
    for j, i in enumerate(mine):
        n_real = lens[i] + args.max_new_tokens if use_kv else len(buf[j])
        out.append(buf[j][:n_real])
    if sizes is not None:
        parts = [None] * mesh_lib.process_count()
        torch.distributed.all_gather_object(parts, out)
        # Every tensor rank of a data shard decoded its rows: take one.
        out = [row for r, part in enumerate(parts) if r % tp == 0
               for row in part]
    if rank == 0:
        for row in out:
            print(tokenizer.decode(row))
    if result is not None:
        result.update(tokens=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
