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
5a. spec   -- speculative decoding at that width, 4 of its 12 layers
              (random weights, max batch 8, block 16, K = 4) on 24
              requests whose prompts repeat a motif. Parity lane in f32:
              n-gram, draft (2 of the 4 layers) and an oracle proposer
              (the spec-off stream, one draft a window wrong) against
              spec off, greedy: streams equal (a differing token only at
              a tie, printed), drafts accepted, flash-decode launches ==
              the target's plain decodes x 4 + the draft's decode
              dispatches x 2, a live
              draft decode call against the plain version; a verifier
              accepting one draft past the first mismatch must fail.
              Speed lane in bf16 on the wall clock, spec off, n-gram and
              draft: tok/s, TTFT, TPOT, acceptance, the accepted-per-step
              histogram and the ledger fractions; a sampled n-gram run
              (temperature 0.9, top-k 20) replayed identically.
5b. kv-store -- the KV block store at that width (4 layers), bf16 and
              int8 pools, on
              a shared-prefix trace (16 requests, a 2-block prefix): a
              warm engine publishes, a cold engine sharing only the store
              fills from it (every filled block bitwise the store entry,
              the streams those of an engine that kept its blocks, ties
              at ``TIE_BF16``, launches exact); a fill writing a leaf's
              layers reversed must fail; ``read_block`` / ``write_block``
              GB/s; TTFT of a store-filled prefix against a recomputed
              one (2 and 31 blocks); prefill-role -> decode-role
              migration of 8 requests with chunked prefill and n-gram
              spec against one engine, the bytes migrated.
5c. fleet  -- the serving fleet (``serving/frontend.py``, ``remote.py``,
              ``worker.py``) at GPT-2 small's full width and depth (bf16
              over f32 random weights, max batch 8 a replica, block 16)
              on 24 requests in 3 shared-prefix groups (64-token
              prefixes), 64 new tokens each, greedy and sampled, in
              ``steps`` time: A, 2 in-process replicas (each group on one
              replica); B, the same through ``WorkerSupervisor`` and 2
              worker processes on the card (routing, streams and token
              times bitwise A's; the workers' decode launches, from their
              logs, A's); C, ``worker_kill`` mid-decode and D,
              ``worker_hang`` (fenced within ``FLEET_RPC_TIMEOUT_S``, the
              2 s per-call timeout, plus ``FLEET_FENCE_MARGIN_S``, 5 s):
              every request finishes, streams A's under the tie rule
              (sampled rows too: a draw that moved must be a tie under
              the f32 model and the sampler's own noise); E, roles
              prefill -> decode through the front-end's migration.
              Planted faults that must fail: a mirror dropping a delta's
              last token, a router ignoring affinity (a worker restarting
              a resubmitted request's delta cursor is the mutation
              ``fleet_resubmit_stale_cursor``). Prints worker start
              seconds, step RPC p50/p99, tok/s of A and B, the stall and
              the decode launches of A, B (in its workers) and E.
5d. tp-decode -- tensor-parallel paged decode on the one card
              (``serving/sharding.py``, ``paged_attention_sharded``):
              GPT-2 small at full width, max batch 8, block 16, the
              engine phase's 24 requests in ``steps`` time, every shard
              on card 0 (``mesh_devices`` of repeated zeros). The sharded
              dispatch at the decode shape bitwise one ``flash_decode``
              call with kv-sharded pools (tp 2, 4) and replicated ones (2
              kv heads, tp 4: each shard reads its kv head in place,
              ``kv_head_base``), the window against the plain version,
              planted faults (shards reversed, a shard ignoring its kv
              head) rejected; engines at tp 2 and 4 (12 layers), int8
              pools at tp 2, and GQA at tp 4 (4 layers) against tp 1:
              streams bitwise or at the tie rule, decode launches exactly
              tp x layers x decode iterations, a shard's persistent bytes
              ~P/tp of parameters and 1/tp of the pools (whole when they
              replicate), ``KVB1`` frames one device's; one worker
              process (``device_sets=[[0, 0]]``, 2-way parameter shards)
              serving the in-process tp-2 streams bitwise. Prints tok/s
              and TPOT p50 at tp 1, 2 and 4.
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
8a. mesh   -- the flash kernels' ``return_lse`` and ``dlse`` and the ring
              attention in one process at small_model.yaml's width (b=8,
              s=1024, 12 heads of 64, bf16; ``phase_mesh``): ``(o, lse)``
              and the q/k/v gradients for cotangents of both, through the
              fused and the split backward, against the f32 twin within 2x
              the bf16 twin's own error; a backward without ``dlse`` (a
              pre-pass that ignores it) must be rejected; the ring on the
              loopback permute at sp 2 and 4, contiguous and zigzag,
              forward and gradients against the f32 twin, L2 within 2x
              one flash pass's error and the worst element within
              ``RING_MAX_FACTOR`` (3x: a K/V gradient element sums up to
              sp chunks' bf16-rounded partials), its launches (counted
              from zero around it) the ring's schedule; times of the
              forward, the backwards with and without ``dlse`` and each
              ring beside one flash pass.
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
              argv again (a new trainer in this process), which
              resumes from step 4: step 8's params, Adam moments and
              dropout generator and the losses of steps 5-8 must be
              bitwise equal, and that run's launches exactly 4 steps x 4
              micro-batches plus its eval batches. Prints tok/s and MFU
              from the run's JSONL, the checkpoint's save (sync, async)
              and restore seconds, and the device busy share of steady
              CLI steps under ``torch.profiler``; then 3 ``--pack_sequences``
              steps (split dk/dv and dq launches) and 3 steps of
              ``configs/moe_small.yaml --moe_impl dropless`` cut to 2
              layers (gmm, tgmm).
17. infer   -- ``eval.infer.main`` on that checkpoint, greedy, 4 ragged
              prompts of 64 new tokens: the KV path and ``--serve`` (the
              flash-decode kernel; launches exactly 63 x 12) on the
              checkpoint root, then both on the consolidated
              ``params.npz`` in f32 compute, whose greedy tokens must be
              equal (a differing token only at a top-2 tie).
18. remat   -- ``train_ddp --config configs/large_1b_single_chip.yaml``
              at 2 of its 36 layers (hidden 1280, batch 4 x 1024, full
              remat, bf16 Adam moments) on the cli phase's corpus, 6
              steps with a save at step 3; the same command again
              resumes from step 3, and step 6's state (params, the
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
19. offload -- ``train_fsdp --config configs/medium_model.yaml`` cut to
              2 of its 24 layers (FULL_SHARD at one process, remat on,
              batch 8 x
              4 x 1024, dummy data), 3 steps on the card and with the Adam
              moments in pinned host memory as float32, bfloat16, int8 and
              int8 with 0.5 GB kept on the card: f32 offload's step-3
              state bitwise the on-card run's, the narrow ones' losses
              within rtol 0.05, the partial offload's startup line equal to
              ``select_resident_moments``; bytes each way a step, H2D and
              D2H ms (CUDA events), GB/s, step time and peak memory of each.
20. moe-remat -- ``configs/moe_small.yaml --moe_impl dropless
              --gradient_checkpointing`` cut to 2 layers, 2 steps: gmm 9
              a layer a micro-batch (3 forward, 3 recompute, 3 dgrad),
              tgmm 3.
21. moe-capacity -- the capacity router, the JAX default
              (``phase_moe_capacity``): ``configs/moe_small.yaml`` at 2
              of its 12 layers through ``train_ddp`` (3 steps, a restart
              at step 2, bitwise; a telemetry step's
              per-layer
              drop_frac; tok/s and MFU on the active parameters);
              ``infer.py`` on its checkpoint twice, bitwise; bench.py
              --moe's capacity lane (top-2, einsum; 6 of its 12 layers)
              and the same model
              with gather dispatch, 10 steps each plus a profile, losses
              within ``MOE_DISPATCH_LOSS_RTOL``, queue positions bitwise a
              plain loop's; one layer in bf16 against the f32 layer, the
              gather backward twice bitwise; the paged engine over a
              moe_small-width model; planted faults (an inclusive cumsum,
              a combine backward without the gate scale) rejected.
22. ft      -- fault tolerance and the run's telemetry on ``small_model.yaml``
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
23. dist    -- the two trainers across processes, each rank a fresh
              process that joins its group as a launcher would (a file
              rendezvous, two ranks sharing ``cuda:0`` over gloo, every
              collective bounded by ``COORDINATOR_TIMEOUT_S``) and then
              calls the CLI: ``small_model.yaml`` (2 of its 12
              layers) through ``train_ddp`` at
              world 1 in an NCCL process group, bitwise the run without
              one; DDP at world 2 (dropout 0, a rank batch 4) bitwise one
              process at accumulation 2 (losses, grad norms, final masters
              and moments), launches exact on each rank, and a planted
              fault (rank 1's gradients scaled) rejected;
              ``medium_model.yaml`` (2 layers) through ``train_fsdp
              --sharding
              FULL_SHARD`` and ``SHARD_GRAD_OP`` at world 2 (3 steps):
              losses bitwise one process's, grad norms within
              ``DIST_NORM_RTOL`` and every final master and moment within
              ``DIST_STATE_RTOL`` (a control with one moment's rank halves
              swapped rejected), bitwise between the two strategies, a
              rank's masters + moments at rest at most 0.55 of one
              process's (its moments under SHARD_GRAD_OP); a two-phase
              checkpoint of a FULL_SHARD run without remat (the backward
              regathers the saved weights) at step 2 resumed at world 2
              bitwise the straight run's step 4, and restored at world 1
              bitwise the stitched shards. Runs that do not depend on each
              other share the card. Per-rank step ms and peaks (ranks
              time-slicing one card: no multi-GPU speed). Then MoE,
              both routers (``_dist_moe``: moe_small's width cut to 2
              layers, capacity factor 0.5): world 1 over NCCL bitwise one
              process; DDP and FULL_SHARD at world 2 within
              ``DIST_LOSS_RTOL`` / ``DIST_MOE_STATE_L2`` of one process at
              the same global micro-batch, the capacity layer-0 keep mask
              bitwise; a planted fault (rank 1's queue offsets 0)
              rejected. Beside the ZeRO runs, ``train_fsdp --sharding
              FULL_SHARD --cpu_offload`` at world 2 (medium_model.yaml,
              4 layers): losses bitwise one process's, grad norms within
              ``DIST_NORM_RTOL``, its final state (digested, not
              written) bitwise the on-card FULL_SHARD run's; a rank's
              device and host bytes at rest.
23a. expert -- expert parallelism (``_dist_expert``, inside dist: its
              runs start as the MoE group's runs end, against that group's
              one-process runs; ``phase_expert`` runs it alone):
              ``configs/moe_small.yaml``'s documented ``--mesh_data 2
              --mesh_expert 4`` (8 ranks, capacity, einsum) and the
              dropless router at expert 2 x tensor 2 x sequence 2 (8
              ranks: the ring, gmm and tgmm on a rank's experts), both at
              2 layers, 3 steps: losses within ``DIST_LOSS_RTOL``, every
              final leaf within ``DIST_MOE_STATE_L2`` relative L2 (a
              swapped-halves control rejected), launches exact; the
              capacity router under sequence 2, its layer-0 keep mask of
              the global micro-batch bitwise the plain loop's, and a
              planted fault (rank 1's per-row queue offsets 0) rejected.
              Routing equality, drop_frac by layer, a rank's expert bytes
              against one process's, collectives a step and peaks.
24. world-rest -- the rest of world > 1 (``phase_world_rest``,
              small_model.yaml at 2 layers, ranks sharing the card over
              gloo): int8
              moments under SHARD_GRAD_OP at world 2 bitwise one process
              (clip off; a flipped code rejected), that checkpoint
              restored at world 1 bitwise; a SIGTERM to rank 1 alone
              makes both ranks save and exit 143, and the resumed run
              ends bitwise the straight one; a telemetry step at world 2
              within ``WORLD_REST_TEL_RTOL`` of one process; ``--nan_scan``
              with a NaN in rank 1's rows naming one process's site.
24a. mesh-ranks -- tensor and sequence parallelism across processes
              (``phase_mesh_ranks``): ``train_ddp`` on small_model.yaml at
              2 of its 12 layers (dropout 0, batch 8 x 1024, 3 steps) at
              one process, ``--mesh_tensor 2``, ``--mesh_sequence 2``,
              both (4 ranks), ``--mesh_tensor 2 --mesh_stage 2`` (GPipe,
              M 2) and ``train_fsdp --mesh auto`` over 2 ranks, the ranks
              sharing the card over gloo, all started together: each
              against the one process within ``MESH_LOSS_RTOL`` /
              ``MESH_STATE_L2`` (a swapped-halves control rejected),
              launches exact (the ring's schedule a layer under sequence,
              no head + CE under tensor); a rank's step ms, collectives a
              step and parameter bytes at rest; the auto run's plan
              budgeted half the card (two ranks on it) and equal to
              ``tools/plan``'s at that budget, and its ``comms_model``
              crosscheck noting the model's gap and nothing else (the
              gradient sums over the sequence ranks or the stage group,
              which the model does not charge); ``tools/plan``'s tables
              for the card.
25. elastic -- ``python -m tpu_trainer_torch.training.elastic`` at
              small_model.yaml's width (2 layers), two ranks sharing the
              card: ``kill_host`` shrinks to world 1, which resumes from
              the committed checkpoint, ``return_host`` grows back to 2;
              ``supervisor.jsonl``'s deaths, recovery and grow seconds;
              the final state bitwise a replay of the same segments;
              ``hang_host`` caught by the heartbeat timeout; a planted
              supervisor that blames every stale host rejected.
26. pipeline -- pipeline parallelism (``phase_pipeline``, ranks sharing
              the card over gloo): ``train_ddp`` on small_model.yaml at
              all 12 layers (dropout 0, batch 8 x 1024) with
              ``--mesh_stage 4 --pipeline_microbatches 8`` under 1F1B, 3
              steps, against one process on the same batch (losses within
              ``DIST_LOSS_RTOL``, every final master and moment within
              ``PIPE_STATE_L2`` relative L2, a swapped-halves control
              rejected); GPipe, 1F1B and interleaved at stage 2 (4 layers,
              M 8, dropout 0.1, the same masks) against each other, within
              2x run A's readings; run A's model at ``--mesh_tensor 2
              --mesh_stage 2`` (1F1B, M 8) against one process as run A;
              the 1F1B window planted one below the JAX simulation's, which
              every rank must refuse; every rank's launches the
              schedule's; a rank's step ms, ``pp_send`` bytes and receive
              wait a step, the most microbatches in flight and its peak.

Every phase runs at full depth except these, cut so that the whole run
stays well inside its time and its machine's 45 GiB of disk writes: the
cli phase's dropless-MoE run, moe-remat, the ft phase's MoE telemetry run,
the dist phase's MoE group and the expert runs and the moe-capacity
phase's CLI run (moe_small.yaml at 2 layers), the offload phase and the
dist phase's ZeRO and offload runs (medium_model.yaml at 2 layers), the
remat phase (large_1b_single_chip.yaml at 2 layers), the dist phase's
small_model.yaml runs and the ft phase's NaN rollback run (2 layers),
the world-rest phase, the elastic
phase and the mesh-ranks phase (small_model.yaml at 2 layers), the
spec and kv-store phases and the pipeline phase's three schedules (4
layers) and the moe-capacity phase's dispatch bench (6 layers).

The phases run one after another in the order above, except that the
world-rest and elastic phases run one after the other in a process of
their own (``_beside``) while the ft phase runs, before the dist phase;
the ft phase runs its chain of restarted processes on a thread beside
its own sections that time nothing; and the pipeline phase's runs start
as the dist phase's expert runs end and the mesh-ranks phase's as the
pipeline's end, each beside the earlier runs' checks (which read states
on the host); the mesh-ranks phase runs last. Those processes share
the host's cores and the card, so the restart times the ft phase
prints, the world-rest, mesh-ranks and pipeline phases' step times and
the elastic phase's recovery and grow seconds are taken beside that
work. The whole run takes about seventeen minutes on an
H100 (700 W), builds included.

Then the ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result. Run from the repository root: ``python3 chip_smoke.py``
(``--out FILE`` also writes every measured number as JSON).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
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


def _near_truth(what, got, plain, truth, max_factor=NEAR_FACTOR) -> dict:
    """A bf16 kernel result against the f32 truth, next to its bf16 plain
    version's error (NEAR_FACTOR, NEAR_FLOOR; ``max_factor`` for the worst
    element). Returns the errors; raises when the kernel's worst element
    or L2 error is past its limit."""
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
        factor = max_factor if name == "max" else NEAR_FACTOR
        lim = factor * p + floor * rms * n
        out[name] = {"kernel": k, "plain": p, "limit": lim}
        if not k <= lim:
            raise AssertionError(
                f"{what}: kernel {name} error vs the f32 truth {k:.3e} > "
                f"{lim:.3e} ({factor:g} x the bf16 plain version's "
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


# The mesh phase's shape: small_model.yaml's width.
MESH_SHAPE = dict(b=8, s=1024, h=12, kvh=12, d=64)
# The ring against the f32 twin, next to one flash pass over the whole
# sequence: L2 within NEAR_FACTOR of one pass's error, as every bf16
# kernel result; the worst element within RING_MAX_FACTOR. A K/V
# gradient element of the ring is the sum of up to sp chunks' partials,
# each rounded to bf16 where the kernel writes it, where one pass rounds
# its f32 sum once. Carrying the K/V (and so their gradients) through the
# permutes in f32 leaves the worst elements as they are
# (scripts/ring_rounding.py, on the CPU twin), so the excess is the
# chunks' own rounding. On an H100 80GB HBM3 at 700 W the worst dv
# element measured 1.59x one pass's at sp 2 contiguous, 2.02x at sp 2
# zigzag (3.477e-02 against 1.718e-02), 1.76x at sp 4 contiguous and
# 1.33x at sp 4 zigzag; L2 at most 1.45x.
RING_MAX_FACTOR = 3.0


def phase_mesh(results: dict) -> dict:
    """The flash kernels' ``return_lse`` / ``dlse`` and the ring attention
    (``ops/ring.py``) in one process, at ``small_model.yaml``'s width (b=8,
    s=1024, 12 heads of 64, bf16):

    - ``flash_attention(return_lse=True)``: ``o`` and ``lse``, and the q/k/v
      gradients for random cotangents of both (the ``dlse`` the pre-pass
      takes off delta) through the fused and the split backward, against
      the f32 twin within 2x the bf16 twin's own error; a planted fault,
      the backward without ``dlse`` (a pre-pass that ignores it), must be
      rejected by the same check;
    - the ring on the loopback permute (every rank in this process) at sp
      2 and 4, contiguous and zigzag: the output and the q/k/v gradients
      against the f32 twin over the whole sequence, L2 within 2x one
      flash pass's error and the worst element within
      ``RING_MAX_FACTOR``; the launches of each ring (counted from zero around
      it) equal to its schedule, ``ops.ring.forward_launches`` a rank, as
      many backward launches;
    - times (CUDA events): the forward, the fused backward without and
      with ``dlse`` and the split pair with it, and each ring's forward +
      backward next to one flash pass's over the whole sequence.

    These launches compare a kernel with its plain version; the mesh
    path's own launches are the ``mesh-ranks`` phase's."""
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.ops.ring import (forward_launches,
                                            ring_attention_loopback,
                                            use_zigzag)

    phase = "mesh"
    b, s, h, kvh, d = (MESH_SHAPE[k] for k in ("b", "s", "h", "kvh", "d"))
    q, k, v, do = _attn_set(b, s, h, kvh, d, "bfloat16", seed=151)
    gen = torch.Generator(device="cuda").manual_seed(152)
    dlse = torch.randn((b, h, s), generator=gen, device="cuda")
    out = {"card": nvidia_smi_line(), "shape": MESH_SHAPE}

    def grads(fn, inputs, cots):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        res = fn(*xs)
        res = res if isinstance(res, tuple) else (res,)
        g = torch.autograd.grad(res, xs, cots[:len(res)])
        torch.cuda.synchronize()
        return [r.detach() for r in res] + [t.detach() for t in g]

    def lse_fn(impl):
        return lambda *x: flash.flash_attention(*x, return_lse=True,
                                                backward=impl)

    def twin(*x):
        return flash.flash_attention_reference(*x, return_lse=True)

    names = ("o", "lse", "dq", "dk", "dv")
    f32 = [t.float() for t in (q, k, v)]
    truth = grads(twin, f32, (do.float(), dlse))
    plain = grads(twin, (q, k, v), (do, dlse))
    worst = 0.0
    for impl in ("fused", "split"):
        got = grads(lse_fn(impl), (q, k, v), (do, dlse))
        errs = {n: _near_truth(f"{phase}: {impl} return_lse {n}", a, p, t)
                for n, a, p, t in zip(names, got, plain, truth)}
        worst = max([worst] + [e["vs_plain"] for e in errs.values()])
        out[f"lse_{impl}"] = errs
        log(phase, f"return_lse + dlse, {impl} backward: "
                   + ", ".join(f"{n} {e['max']['kernel']:.2e} (twin "
                               f"{e['max']['plain']:.2e})"
                               for n, e in errs.items())
                   + " worst |err| vs the f32 twin")
        ignored = grads(lse_fn(impl), (q, k, v),
                        (do, torch.zeros_like(dlse)))

        def fault(ignored=ignored):
            for n, a, p, t in list(zip(names, ignored, plain, truth))[2:]:
                _near_truth(f"{phase}: {impl} without dlse {n}", a, p, t)
        _must_reject(f"{impl} backward that ignores dlse", fault)
    log(phase, "planted fault rejected: the backward without dlse (a "
               "pre-pass that ignores it), fused and split")

    # Times: the forward and the backwards with and without dlse.
    o, lse, qs, ks = flash.flash_forward(q, k, v)
    times = {
        "fwd_ms": event_ms(lambda i: flash.flash_forward(q, k, v), 5),
        "bwd_ms": event_ms(lambda i: flash.flash_backward(
            qs, ks, v, o, lse, do), 5),
        "bwd_dlse_ms": event_ms(lambda i: flash.flash_backward(
            qs, ks, v, o, lse, do, dlse=dlse), 5),
        "split_dlse_ms": event_ms(lambda i: flash.flash_backward_split(
            qs, ks, v, o, lse, do, dlse=dlse), 5),
    }
    out["times"] = times
    log(phase, "fwd {fwd_ms:.3f} ms, fused bwd {bwd_ms:.3f} ms, with dlse "
               "{bwd_dlse_ms:.3f} ms, split pair with dlse {split_dlse_ms:.3f}"
               " ms ({card})".format(card=out["card"], **times))

    # The ring on the loopback permute against one flash pass.
    one_pass = grads(lambda *x: flash.flash_attention(*x), (q, k, v), (do,))
    whole = grads(flash.flash_attention_reference, f32, (do.float(),))
    pass_ms = event_ms(lambda i: grads(lambda *x: flash.flash_attention(*x),
                                       (q, k, v), (do,)), 3)
    counters = _counters()
    out["ring"] = {}
    for sp in (2, 4):
        for zz in (False, True):
            tag = f"sp{sp} {'zigzag' if zz else 'contiguous'}"
            assert use_zigzag(s // sp, sp) or not zz

            def ring(*x, sp=sp, zz=zz):
                return ring_attention_loopback(*x, sp, zigzag=zz)
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            got = grads(ring, (q, k, v), (do,))
            launched = {n: c.launches for n, c in counters.items()
                        if c.launches}
            per = forward_launches(sp, zz)
            want = {"flash_forward": sp * per, "flash_backward": sp * per}
            if launched != want:
                raise AssertionError(f"{phase}: ring {tag} launches "
                                     f"{launched}, want {want}")
            errs = {n: _near_truth(f"{phase}: ring {tag} {n}", a, p, t,
                                   max_factor=RING_MAX_FACTOR)
                    for n, a, p, t in zip(("o", "dq", "dk", "dv"), got,
                                          one_pass, whole)}
            ms = event_ms(lambda i, ring=ring: grads(ring, (q, k, v), (do,)),
                          3)
            out["ring"][tag] = {"launches": launched, "errors": errs,
                                "ms": ms, "one_pass_ms": pass_ms}
            log(phase, f"ring {tag}: launches {launched} (schedule {per} a "
                       f"rank); worst |err| / L2 err vs the f32 twin, one "
                       f"pass's in brackets: "
                       + ", ".join(f"{n} {e['max']['kernel']:.2e} "
                                   f"[{e['max']['plain']:.2e}] / "
                                   f"{e['l2']['kernel']:.3g} "
                                   f"[{e['l2']['plain']:.3g}]"
                                   for n, e in errs.items())
                       + f"; fwd+bwd {ms:.3f} ms vs one pass {pass_ms:.3f}"
                       f" ms ({ms / pass_ms:.2f}x)")
    out["max_abs_err"] = worst
    results["mesh"] = out
    return out


def _mesh_launches(cfg, rows: int, train_micro: int, eval_micro: int,
                   sp: int, tp: int) -> dict:
    """A rank's launches under a sequence size ``sp`` and tensor size
    ``tp`` (``rows`` a micro-batch): the ring's ``forward_launches`` a
    layer a micro-batch (one flash call without the axis) and as many
    fused backwards; the head + CE kernel when no tensor axis takes the
    vocab-sharded head and the rank's tokens fit the kernel
    (``ops/loss._pallas_head_ok``)."""
    from tpu_trainer_torch.ops.ring import forward_launches, use_zigzag

    L = cfg.num_layers
    sl = cfg.max_seq_len // sp
    per = forward_launches(sp, use_zigzag(sl, sp)) if sp > 1 else 1
    head = tp == 1 and 2048 <= rows * sl <= 16384
    return {"flash_forward": L * per * (train_micro + eval_micro),
            "flash_backward": L * per * train_micro,
            "flash_backward_dkv": 0, "flash_backward_dq": 0,
            "head_ce": train_micro + eval_micro if head else 0,
            "gmm": 0, "tgmm": 0}


# The mesh-ranks phase against one process, bf16, 3 steps, dropout off.
# Under tensor the row-parallel partial products are summed over the
# group in bf16 and the head's statistics in f32 slices; under sequence
# the ring combines bf16 chunk outputs: the losses agree to bf16
# rounding, not bitwise, and the state drifts as in the dist phase's MoE
# group. Held like that group: losses within MESH_LOSS_RTOL, every final
# master and moment on its relative L2 within MESH_STATE_L2, and a
# control (one moment's halves swapped) must fail that bound. On an H100
# 80GB HBM3 at 700 W the sound runs read losses within 8.8e-06 and state
# L2 1.08e-02-1.35e-02; the backward without dlse
# (scripts/torch_kernel_mutations.py bwd_prep_ignores_dlse_ring) moved the
# sequence runs' state to 5.67e-02-5.71e-02 and their losses by under
# 1e-4. MESH_STATE_L2 sits between the two, near their geometric mean.
MESH_LOSS_RTOL = 1e-4
MESH_STATE_L2 = 0.03


def _mesh_ranks_spawn(tmp: str) -> dict:
    """Start the mesh-ranks phase's runs together (``phase_mesh_ranks``)."""
    yaml = _cut_yaml(tmp, "small_model.yaml", "mesh", num_layers=2,
                     dropout=0.0, attention_dropout=0.0)
    steps, rows = 3, 8
    common = ["--log_interval", "1", "--eval_interval", "0",
              "--eval_batches", "1", "--keep_last_n", "0",
              "--no_auto_resume"]

    def argv(tag, *extra, bs=rows):
        return (["--config", yaml, "--max_steps", str(steps),
                 "--batch_size", str(bs), "--grad_accum", "1",
                 "--save_interval", "0",
                 "--checkpoint_dir", os.path.join(tmp, f"ck_{tag}"),
                 "--metrics_jsonl", os.path.join(tmp, f"{tag}.jsonl")]
                + common + list(extra))

    # tag: (world, sequence, tensor, CLI mode).
    runs = {"one": (0, 1, 1, "ddp"), "tp2": (2, 1, 2, "ddp"),
            "sp2": (2, 2, 1, "ddp"), "tp2sp2": (4, 2, 2, "ddp"),
            "tp2pp2_gpipe": (4, 1, 2, "ddp"), "auto": (2, None, None, "fsdp")}
    args = {tag: argv(tag, *(["--mesh_tensor", str(tp)] if tp > 1 else [])
                      + (["--mesh_sequence", str(sp)] if sp > 1 else []))
            for tag, (_, sp, tp, _) in runs.items() if sp is not None}
    # One layer a stage (GPipe, M 2); and the planner's mesh over two
    # ranks for the same global batch (4 rows a rank), under FULL_SHARD.
    args["tp2pp2_gpipe"] += ["--mesh_stage", "2", "--pipeline_microbatches",
                             "2"]
    args["auto"] = argv("auto", "--mesh", "auto", bs=rows // 2)
    t0 = time.perf_counter()
    spawned = [(tag, _dist_spawn(tmp, f"mesh_{tag}", mode, args[tag], w))
               for tag, (w, _, _, mode) in runs.items()]
    return {"t0": t0, "steps": steps, "rows": rows, "runs": runs,
            "args": args, "spawned": spawned}


def phase_mesh_ranks(results: dict, tmp: str, started=None) -> dict:
    """Tensor and sequence parallelism across processes on the one card
    (ranks sharing ``cuda:0`` over gloo, each a fresh process that joins
    its group and calls ``train_ddp``, as the dist phase's): one process,
    ``--mesh_tensor 2``, ``--mesh_sequence 2``, ``--mesh_tensor 2
    --mesh_sequence 2`` (4 ranks), the pipeline under the tensor axis
    (``--mesh_tensor 2 --mesh_stage 2``, GPipe, M 2, a layer a stage; 4
    ranks) and ``train_fsdp --mesh auto`` over 2 ranks (4 rows a rank:
    the same global batch), all started together, each
    ``small_model.yaml`` at 2 of its 12 layers (dropout 0, batch 8 x 1024,
    accumulation 1, 3 steps and one eval micro-batch). Each run against
    the one-process run: losses within ``MESH_LOSS_RTOL``, each final
    master and moment within ``MESH_STATE_L2`` relative L2 (a control with
    one moment's halves swapped must fail), a rank's launches exact
    (``_mesh_launches``: the ring's schedule under sequence, no head + CE
    under tensor; ``_pipe_launches`` under a stage axis); a rank's step
    ms, its collectives' calls and bytes a step, and its parameter bytes
    at rest (under tensor the sharded leaves at half, a quarter beside a
    stage axis). The auto run's ``mesh_plan`` record is printed; its
    budget must be half the card's memory (its two ranks share the card)
    and its mesh ``tools/plan``'s for the same options, card and budget.
    Its ``comms_model`` record is printed with the counted bytes beside
    the modelled ones on each axis. Its crosscheck must note the model's
    gap on the chosen mesh and nothing else: the trainer sums the
    gradients over the sequence ranks, and the leaves outside the layer
    stack over the stage group, and the model (the JAX arithmetic)
    charges neither axis for those sums; a missing or any other note
    fails the phase. ``tools/plan``'s tables for the card at 1, 4 and 8 devices,
    GPT-2 small and medium, are printed. Ranks time-slicing one card
    measure no multi-GPU speed.
    ``started``: the runs' ``_mesh_ranks_spawn``, when the caller started
    them earlier (the whole script starts them as the pipeline phase's
    runs end, beside that phase's checks)."""
    import numpy as np

    from tpu_trainer_torch.models.gpt import GPT
    from tpu_trainer_torch.parallel.sharding import leaf_specs
    from tpu_trainer_torch.training import cli

    from tpu_trainer_torch.parallel import comms_model as comms_lib
    from tpu_trainer_torch.parallel import planner as planner_lib
    from tpu_trainer_torch.tools import plan as plan_tool

    phase = "mesh-ranks"
    st = started or _mesh_ranks_spawn(tmp)
    t0, steps, rows, runs, args = (st["t0"], st["steps"], st["rows"],
                                   st["runs"], st["args"])
    recs = _dist_join_all(st["spawned"])
    group_s = time.perf_counter() - t0
    cfg = cli.resolve_configs(cli.build_parser("ddp").parse_args(
        args["one"]), "ddp")[0]
    card_name = torch.cuda.get_device_name(0)
    plan, = _jsonl(os.path.join(tmp, "auto.jsonl"), "mesh_plan")
    chosen = plan["chosen"]
    meshes = {tag: {"data": 1, "fsdp": 1, "sequence": sp, "tensor": tp,
                    "expert": 1, "stage": 1}
              for tag, (_, sp, tp, _) in runs.items() if sp is not None}
    meshes["tp2pp2_gpipe"]["stage"] = 2
    meshes["auto"] = chosen["mesh"]
    reading = {tag: _background(lambda tag=tag: _dist_state(os.path.join(
        tmp, f"ck_{tag}", f"step_{steps:08d}"))) for tag in runs}
    ref = reading["one"]()
    keys = sorted(k for k in ref if k.startswith(("params/", "opt_state/")))
    one = [r["loss"] for r in _jsonl(os.path.join(tmp, "one.jsonl"),
                                     "train")]

    def state_rel(got, want, ks):
        out = {}
        for k in ks:
            w = np.asarray(want[k], dtype=np.float32).reshape(-1)
            dd = np.asarray(got[k], dtype=np.float32).reshape(-1) - w
            out[k] = float(np.linalg.norm(dd) / max(np.linalg.norm(w),
                                                    1e-30))
        return out

    shapes = {n: tuple(p.shape)
              for n, p in GPT(cfg, device="meta").named_parameters()}
    full_bytes = 4 * sum(math.prod(sh) for sh in shapes.values())

    def rest_bytes(tag):
        """A rank's parameter bytes at rest on ``tag``'s mesh."""
        m = meshes[tag]
        specs = leaf_specs(shapes, "zero3" if runs[tag][3] == "fsdp"
                           else "replicated", m["fsdp"], m["tensor"],
                           m["expert"], m["stage"])
        return 4 * sum(math.prod(sp.shard_shape(sp.param_dim))
                       for sp in specs.values())

    def want_launches(tag, rank):
        m = meshes[tag]
        if m["stage"] > 1:
            pcfg = cli.resolve_configs(cli.build_parser(runs[tag][3])
                                       .parse_args(args[tag]),
                                       runs[tag][3])[0]
            return _pipe_launches(pcfg, m["stage"], rank % m["stage"], steps,
                                  tensor=m["tensor"])
        return _mesh_launches(cfg, rows // (m["data"] * m["fsdp"]), steps, 1,
                              m["sequence"], m["tensor"])

    launches, out = {}, {"group_s": group_s, "card": nvidia_smi_line()}
    faults = []
    for tag, (world, _, _, _) in runs.items():
        for r in recs[tag]:
            want = want_launches(tag, r["rank"])
            if r["launches"] != want:
                raise AssertionError(f"{phase}: {tag} rank {r['rank']} "
                                     f"launches {r['launches']}, want "
                                     f"{want}")
            _add_launches(launches, r["launches"])
        r0 = recs[tag][0]
        res = {"step_ms": [r["step_ms"] for r in recs[tag]],
               "params_bytes_at_rest": r0["rest"][0]["params"],
               "collectives_per_step": {
                   k: v / steps for k, v in sorted(r0["collectives"].items())},
               "launches": r0["launches"]}
        want_bytes = rest_bytes(tag)
        if r0["rest"][0]["params"] != want_bytes:
            raise AssertionError(f"{phase}: {tag}: a rank's parameters at "
                                 f"rest {r0['rest'][0]['params']} bytes, "
                                 f"want {want_bytes}")
        if tag != "one":
            got = [r["loss"] for r in _jsonl(
                os.path.join(tmp, f"{tag}.jsonl"), "train")]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, one))
            final = reading[tag]()
            leaves = state_rel(final, ref, keys)
            worst = max(leaves, key=leaves.get)
            res.update(losses=got, loss_worst_rtol=rel,
                       state_worst_l2=[worst, leaves[worst]])
            # Every run's readings are printed before any is refused.
            if len(got) != len(one) or rel > MESH_LOSS_RTOL:
                faults.append(f"{tag} losses' worst rtol {rel:.3e} > "
                              f"{MESH_LOSS_RTOL:.0e}")
            if leaves[worst] > MESH_STATE_L2:
                faults.append(f"{tag} state's worst relative L2 "
                              f"{leaves[worst]:.3e} > {MESH_STATE_L2}")
            key = max((k for k in keys if "/mu/" in k),
                      key=lambda k: ref[k].size)
            shape = ref[key].shape
            dim = max((i for i, n in enumerate(shape) if n % 2 == 0),
                      key=lambda i: shape[i])
            swapped = {key: np.concatenate(
                np.split(final[key], 2, axis=dim)[::-1], axis=dim)}
            ctrl = state_rel(swapped, ref, [key])[key]
            if ctrl <= MESH_STATE_L2:
                raise AssertionError(f"{phase}: the check passed a planted "
                                     f"fault: {key}'s halves swapped "
                                     f"(relative L2 {ctrl:.3e})")
            res["control_l2"] = ctrl
        out[tag] = res
        m = meshes[tag]
        log(phase, f"{tag} ({max(world, 1)} rank(s), "
                   + (" x ".join(f"{ax} {n}" for ax, n in m.items() if n > 1)
                      or "one process")
                   + f"): step ms {[round(x, 1) for x in res['step_ms'][0]]}"
                   f" (rank 0), params at rest {res['params_bytes_at_rest'] / 1e6:.1f} MB "
                   f"of {full_bytes / 1e6:.1f} MB, collectives a step "
                   + ", ".join(f"{k} {v:g}" for k, v in
                               res["collectives_per_step"].items())
                   + (f"; losses worst rtol {res['loss_worst_rtol']:.2e}, "
                      f"state worst relative L2 {res['state_worst_l2'][1]:.2e}"
                      f" ({res['state_worst_l2'][0]}), control "
                      f"{res['control_l2']:.2e}" if tag != "one" else ""))
    log(phase, f"{len(runs)} runs sharing the card in {group_s:.1f} s "
               f"({out['card']})")
    # The auto run: its plan, against tools/plan's for the same options
    # and card, and its comms model beside the collectives it counted.
    for line in planner_lib.render_table(plan):
        log(phase, f"auto | {line}")
    half = torch.cuda.mem_get_info()[1] / 2 / planner_lib.GiB
    if abs(plan["hbm_budget_gb"] - half) > 1e-9 * half:
        faults.append(f"auto planned with {plan['hbm_budget_gb']} GiB, not "
                      f"its half of the card ({half} GiB)")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = plan_tool.main(["--model", "small", "--devices", "2",
                             "--batch-size", str(rows // 2), "--strategy",
                             "zero3", "--device-kind", card_name,
                             "--hbm_gb", repr(plan["hbm_budget_gb"]),
                             "--json"])
    tool = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or tool["chosen"]["mesh"] != chosen["mesh"]:
        faults.append(f"auto chose {chosen['mesh']}, tools/plan "
                      f"{tool['chosen']['mesh']} (rc {rc})")
    comms, = _jsonl(os.path.join(tmp, "auto.jsonl"), "comms_model")
    for line in comms_lib.summary_lines(comms):
        log(phase, f"auto | {line}")
    for ax, c in comms["collective_counts"].items():
        log(phase, f"auto | {ax} [{c['size']}]: counted {c['calls']} calls, "
                   f"{c['bytes'] / 1e6:.3f} MB, modelled "
                   f"{comms['per_axis'][ax]['bytes'] / 1e6:.3f} MB "
                   f"({c['kinds']})")
    for m in comms["collective_mismatches"]:
        log(phase, f"auto | crosscheck note: {m}")
    gaps = [ax for ax in ("sequence", "stage") if chosen["mesh"][ax] > 1]
    notes = comms["collective_mismatches"]
    if len(notes) != len(gaps) or not all(
            n.startswith("counted ") and
            f"of ['all_gather', 'reduce_scatter'] on axis '{ax}'" in n
            for ax, n in zip(gaps, notes)):
        faults.append(f"auto's comms crosscheck: notes {notes}, expected "
                      f"the gradient sums' gap on {gaps} alone")
    out["auto"].update(plan=plan, tools_plan_mesh=tool["chosen"]["mesh"],
                       comms_model=comms)
    # tools/plan's tables for the card (host only).
    for model in ("small", "medium"):
        for n in (1, 4, 8):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                plan_tool.main(["--model", model, "--devices", str(n),
                                "--device-kind", card_name, "--top-k", "3"])
            for line in buf.getvalue().splitlines():
                log(phase, f"tools/plan {model} x{n} | {line}")
    if faults:
        raise AssertionError(f"{phase}: " + "; ".join(faults))
    out["launches"] = launches
    results[phase] = out
    return out


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


def _poisoned(shape, dtype) -> None:
    """Leave a NaN-filled block of ``shape`` as the caching allocator's
    only free block (the pool emptied first), where the next allocation
    of that size on this stream lands: a kernel's unwritten output shows
    as NaN."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")


def _gmm_local_experts(gm, G: int, E: int) -> dict:
    """An expert rank's grouped matmuls (``models/moe.py``'s dropless
    layer): its experts' groups cover the first rows and the rows past
    them, the other ranks' experts' token-choices, must come out zero.
    gmm and its dgrad at the path's shapes (bf16) on memory the allocator
    hands back NaN-filled (a control shows it does); the groups' rows
    against the plain version, the rest exactly zero; a planted fault (a
    NaN row past the groups) must be rejected."""
    sizes = _group_sizes("balanced", G)[:E // 2]        # 4 of 8 experts
    used = int(sizes.sum())
    offs = gm.group_offsets(sizes)
    gen = torch.Generator(device="cuda").manual_seed(5)
    lhs = torch.randn((G, 768), generator=gen, device="cuda").bfloat16()
    rhs = (torch.randn((E // 2, 768, 3072), generator=gen, device="cuda")
           * 0.05).bfloat16()
    dout = torch.randn((G, 3072), generator=gen, device="cuda").bfloat16()
    _poisoned((G, 3072), torch.bfloat16)
    control = torch.empty((G, 3072), dtype=torch.bfloat16, device="cuda")
    if not bool(control.isnan().all()):
        raise AssertionError("gmm local experts: the allocator did not hand "
                             "back the NaN-filled block; the check cannot "
                             "see unwritten rows")
    del control

    def tail_zero(what, out):
        tail = out[used:]
        if not torch.equal(tail, torch.zeros_like(tail)):
            raise AssertionError(f"gmm local experts: {what}: "
                                 f"{int((tail != 0).any(dim=1).sum())} of "
                                 f"{tail.shape[0]} rows past the groups "
                                 f"not zero")

    out = {}
    for what, a, t, n in (("gmm", lhs, False, 3072),
                          ("dgrad", dout, True, 768)):
        _poisoned((G, n), torch.bfloat16)
        out[what] = gm.gmm_cuda(a, rhs, offs, transpose_rhs=t)
        torch.cuda.synchronize()
        tail_zero(what, out[what])
        plain = gm.gmm_reference(a[:used], rhs, sizes, transpose_rhs=t)
        truth = gm.gmm_reference(a[:used].float(), rhs.float(), sizes,
                                 transpose_rhs=t)
        _near_truth(f"gmm local experts {what}", out[what][:used], plain,
                    truth)
    planted = out["gmm"].clone()
    planted[used + 3] = float("nan")
    _must_reject("gmm local experts: a NaN row past the groups",
                 lambda: tail_zero("planted", planted))
    log("gmm", f"local experts (4 of 8 groups, {used} of {G} rows, bf16): "
               f"gmm and dgrad on NaN-filled memory wrote the {G - used} "
               f"rows past the groups as zeros and the groups' rows within "
               f"the f32-truth limits; a NaN row there rejected")
    return {"case": "local experts", "G": G, "rows": used}


def phase_gmm(results: dict) -> dict:
    """gmm (forward and the dgrad against rhs^T) and tgmm against
    ``gmm_reference`` / ``tgmm_reference`` at the MoE path's shapes (G =
    16384 routed rows, E = 8, H = 768 -> N = 3072 and 3072 -> 768; f32
    against the f32 plain version, bf16 against the plain version run in
    f32 next to the bf16 plain version) for balanced, skewed, empty-group
    and G % 128 != 0 group sizes; tgmm's output pre-filled with NaN; an
    expert rank's groups (``_gmm_local_experts``: rows past them zero).
    Planted faults (a boundary tile's second group left out of a gmm, an
    all-zero tgmm, a NaN row past the groups) must fail the check. Then times of each kernel, its plain version
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
    try:
        checks.append(_gmm_local_experts(gm, G, E))
    except AssertionError as e:
        failures.append(str(e))
        log("gmm", f"local experts: FAILED: {e}")
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
    a step, and with the dropless MoE 6 gmm (3 forward, 3 dgrad) and 3 tgmm
    a layer (the capacity router launches none); under remat the forward
    and its 3 gmm run again in the backward."""
    from tpu_trainer_torch.ops import flash

    n = cfg.num_layers * steps
    fwd = 2 if cfg.gradient_checkpointing else 1
    fused = flash.backward_impl(seq, segmented) == "fused"
    moe_on = cfg.num_experts > 0 and cfg.moe_impl == "dropless"
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

        def record(gate_idx, num_experts, *first):
            counts, perm, inv = dispatch(gate_idx, num_experts, *first)
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
                n_splits, *window):
        out = launch(q, pool_k, pool_v, tables, lengths, k_scale, v_scale,
                     n_splits, *window)
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


# -- phases 5a and 5b: speculative decoding and the KV store ------------------

# The infer phase's tie rule: a differing greedy token passes only where
# the f32 model's top-2 logit gap is below TIE_F32 x the logits' absolute
# maximum. Two bf16 (or int8-pool) computations of the same step round
# differently by about 2^-9 of that scale; their rule is TIE_BF16.
TIE_F32 = 1e-5
TIE_BF16 = 2.0**-6


def _spec_trace(n, *, seed, vocab, temperature=0.0, top_k=0, rid0=0):
    """Seeded Poisson trace (20 a second) whose prompts repeat a motif of
    4-8 tokens, as ``tests/test_spec.py``'s repetitive requests: 64-256
    prompt tokens, 24-48 new tokens; rids from ``rid0`` (an engine's
    draft proposer keys its slots by rid, so a warm-up takes others)."""
    import numpy as np

    from tpu_trainer_torch.serving.scheduler import Request, SamplingParams

    rs = np.random.RandomState(seed)
    arrivals = rs.exponential(1.0 / 20.0, size=n).cumsum()
    out = []
    for i in range(n):
        motif = rs.randint(1, vocab, size=int(rs.randint(4, 9))).tolist()
        plen = int(rs.randint(64, 257))
        out.append(Request(
            rid=rid0 + i, prompt=(motif * plen)[:plen],
            max_new_tokens=int(rs.randint(24, 49)),
            sampling=SamplingParams(temperature=temperature, top_k=top_k,
                                    seed=int(rs.randint(0, 2**31 - 1))),
            arrival_time=float(arrivals[i])))
    return out


def _prefix_trace(n, *, seed, vocab, prefix_blocks=2, block=16,
                  max_new=16):
    """``tests/test_kv_store.py``'s shared-prefix trace at block 16: a
    ``prefix_blocks``-block prefix and tails of 4, 9 or 14 tokens,
    greedy, all arriving at once."""
    import numpy as np

    from tpu_trainer_torch.serving.scheduler import Request, SamplingParams

    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, vocab, size=prefix_blocks * block).tolist()
    return [Request(rid=i, prompt=prefix + rs.randint(
                        1, vocab, size=4 + (i % 3) * 5).tolist(),
                    max_new_tokens=max_new,
                    sampling=SamplingParams(temperature=0.0, seed=100 + i))
            for i in range(n)]


class _TieJudge:
    """Top-2 gaps of the f32 model (the target's weights, plain
    attention) at a stream's first differing token; for a sampled stream
    (top-p off), the gap of its two draws there."""

    def __init__(self, params, cfg):
        from tpu_trainer_torch.models.weights import build_model

        self.device = next(iter(params.values())).device
        self.model = build_model(dataclasses.replace(
            cfg, dtype="float32", decode_paged=False), params, self.device)

    def gap(self, row, upto):
        with torch.no_grad():
            logits, _ = self.model(torch.tensor([row[:upto]],
                                                device=self.device))
        last = logits[0, -1].float()
        top = torch.topk(last, 2).values
        return float(top[0] - top[1]), float(last.abs().max())

    def draw_margins(self, prompt, gen, pos, sampling, other, rel):
        """Sampled token ``pos`` after ``prompt + gen[:pos]`` under the f32
        model and the sampler's own Gumbel noise at that seed and token
        index, for each of ``gen[pos]`` and ``other``: how far (in logits)
        its score falls below the best score of the tokens surely in the
        top-k (a logit ``rel x |logits| max`` above the k-th), and how far
        its logit falls below the k-th; the larger of each over the two
        tokens, and the logits' absolute maximum."""
        from tpu_trainer_torch.serving.sampling import (gumbel_noise,
                                                        request_key)

        with torch.no_grad():
            logits, _ = self.model(torch.tensor([prompt + gen[:pos]],
                                                device=self.device))
        last = logits[0, -1].float()
        scale = float(last.abs().max())
        tol = rel * scale
        t = sampling.temperature
        score = last / t + gumbel_noise(request_key(sampling.seed), pos,
                                        last.numel(), self.device)
        kth = (float(torch.topk(last, sampling.top_k).values[-1])
               if sampling.top_k else float("-inf"))
        sure = last >= kth + tol
        below = short = 0.0
        for tok in (gen[pos], other):
            rest = sure.clone()
            rest[tok] = False
            best = float(score[rest].max()) if bool(rest.any()) else -math.inf
            below = max(below, t * (best - float(score[tok])))
            short = max(short, kth - float(last[tok]))
        return below, short, scale

    def check(self, phase, what, got, want, reqs, rel) -> list:
        """``got`` equal to ``want`` (rid -> tokens), a row differing only
        from a tie on (rel x the logits' absolute maximum); the ties."""
        ties = []
        prompts = {r.rid: r.prompt for r in reqs}
        if sorted(got) != sorted(want):
            raise AssertionError(f"{phase}: {what}: finished rids "
                                 f"{sorted(got)} != {sorted(want)}")
        for rid in sorted(want):
            a, b = want[rid], got[rid]
            if a == b:
                continue
            pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
            row = prompts[rid] + a
            gap, scale = self.gap(row, len(prompts[rid]) + pos)
            log(phase, f"{what}: rid {rid} differs at token {pos}: top-2 "
                       f"gap {gap:.3e}, |logits| max {scale:.3e}")
            if len(a) != len(b) or not gap < rel * scale:
                raise AssertionError(
                    f"{phase}: {what}: rid {rid} differs at token {pos} "
                    f"with a top-2 gap {gap:.3e} (not a tie at "
                    f"{rel:.1e} x {scale:.3e})")
            ties.append({"rid": rid, "pos": pos, "gap": gap})
        return ties

    def check_sampled(self, phase, what, got, want, reqs, rel) -> list:
        """Sampled rows (top-p off): ``got`` equal to ``want`` up to its
        first differing token, where each of the two draws is the argmax
        of the sampler's scores over the top-k up to a bf16-sized change
        of the logits (rel x their absolute maximum): a tie of two scores,
        or a token at the k-th logit's edge. A wrong seed or token index
        draws otherwise."""
        moved = []
        by_rid = {r.rid: r for r in reqs}
        for rid in sorted(want):
            a, b = want[rid], got[rid]
            if a == b:
                continue
            pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       min(len(a), len(b)))
            req = by_rid[rid]
            if len(a) != len(b) or pos >= len(a):
                raise AssertionError(f"{phase}: {what}: sampled rid {rid} "
                                     f"has {len(b)} tokens, want {len(a)}")
            below, short, scale = self.draw_margins(
                req.prompt, a, pos, req.sampling, b[pos], rel)
            log(phase, f"{what}: sampled rid {rid} differs at token {pos}: "
                       f"a draw's score below the top-k's best by "
                       f"{below:.3e}, its logit below the k-th by "
                       f"{short:.3e}, |logits| max {scale:.3e}")
            if not (below < rel * scale and short < rel * scale):
                raise AssertionError(
                    f"{phase}: {what}: sampled rid {rid} differs at token "
                    f"{pos}: a draw {below:.3e} below the top-k's best "
                    f"score, {short:.3e} below the k-th logit (not a tie "
                    f"at {rel:.1e} x {scale:.3e})")
            moved.append({"rid": rid, "pos": pos, "below": below,
                          "short": short})
        return moved


class _DecodeCount:
    """Zero the decode launch count and count the launches the serving
    path must make: each of ``engines``' plain decode forwards launches
    the kernel once a layer, and so does each decode dispatch of a draft
    proposer. ``captured`` keeps the operands and output of kernel launch
    number ``capture_call``. ``launches`` and ``want`` after the block."""

    def __init__(self, *engines, capture_call=0):
        self.engines = engines
        self.capture_call = capture_call
        self.plain = self.draft = self.calls = 0
        self.captured = {}

    def _drafts(self):
        return [e.spec_decoder.proposer for e in self.engines
                if e.spec_decoder is not None and hasattr(
                    e.spec_decoder.proposer, "decode_dispatches")]

    def __enter__(self):
        from tpu_trainer_torch.ops import flash

        self._launch = launch = flash._launch

        def capture(q, pool_k, pool_v, tables, lengths, k_scale, v_scale,
                    n_splits, kv_head_base=0, kv_heads=None):
            out = launch(q, pool_k, pool_v, tables, lengths, k_scale,
                         v_scale, n_splits, kv_head_base, kv_heads)
            self.calls += 1
            if self.calls == self.capture_call:
                self.captured.update(
                    args=[t.clone() for t in (q, pool_k, pool_v, tables,
                                              lengths)],
                    kw={"k_scale": None if k_scale is None
                        else k_scale.clone(),
                        "v_scale": None if v_scale is None
                        else v_scale.clone(),
                        "kv_head_base": kv_head_base, "kv_heads": kv_heads},
                    out=out.clone())
            return out

        for e in self.engines:
            def counted(reqs, *, prefill, _fwd=e._forward):
                self.plain += not prefill
                return _fwd(reqs, prefill=prefill)
            e._forward = counted
        self._draft0 = [p.decode_dispatches for p in self._drafts()]
        flash._launch = capture
        flash.flash_decode.launches = 0
        return self

    def __exit__(self, *exc):
        from tpu_trainer_torch.ops import flash

        torch.cuda.synchronize()
        flash._launch = self._launch
        self.launches = flash.flash_decode.launches
        for e in self.engines:
            del e._forward
        self.want = self.plain * self.engines[0].config.num_layers
        for p, n0 in zip(self._drafts(), self._draft0):
            self.draft += p.decode_dispatches - n0
            self.want += (p.decode_dispatches - n0) * p.config.num_layers
        return False


def _spec_run(engine, reqs, *, time_mode, capture_call=0):
    """Run ``reqs`` under ``_DecodeCount``; the finished requests and
    streams, the summary and the counts."""
    with _DecodeCount(engine, capture_call=capture_call) as cnt:
        done = engine.run(reqs, time_mode=time_mode)
    return {"done": done, "streams": {r.rid: list(r.generated) for r in done},
            "summary": engine.summary(), "launches": cnt.launches,
            "want": cnt.want, "plain_decodes": cnt.plain,
            "draft_decodes": cnt.draft, "captured": cnt.captured}


def _live_err(phase, captured) -> float:
    from tpu_trainer_torch.ops import flash

    if not captured:
        raise AssertionError(f"{phase}: the captured decode call never ran")
    plain = flash.paged_attention_reference(*captured["args"],
                                            **captured["kw"])
    err = float((captured["out"] - plain).abs().max())
    if err > KERNEL_ATOL:
        raise AssertionError(f"{phase}: live decode call kernel vs plain "
                             f"max |err| {err:.3e} > {KERNEL_ATOL:.0e}")
    return err


class _OracleProposer:
    """Drafts the spec-off stream's next tokens with the one at draft
    index (rid + tokens generated) mod K replaced: every window accepts a
    known prefix and then rejects, whatever the weights make of the
    trace's own repetition."""

    name = "oracle"

    def __init__(self, streams, vocab):
        self.streams, self.vocab = streams, vocab

    def propose(self, reqs, k_of):
        out = {}
        for r in reqs:
            n = len(r.generated)
            d = list(self.streams[r.rid][n:n + k_of[r.rid]])
            if d:
                i = (r.rid + n) % len(d)
                d[i] = (d[i] + 1) % self.vocab
            out[r.rid] = d
        return out

    def rewind(self, req, accepted):
        pass


def _plant_over_accept():
    """The planted fault: accept one draft past the first mismatch."""
    import numpy as np

    from tpu_trainer_torch.serving import spec as spec_lib

    real = spec_lib.accept_emit

    def over_accept(logits, ids, draft_lens, *a, **k):
        emitted, n_acc = real(logits, ids, draft_lens, *a, **k)
        dl = torch.as_tensor(np.asarray(draft_lens), device=n_acc.device)
        n2 = torch.minimum(n_acc + 1, dl)
        w = ids.shape[1]
        drafts_at = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], 1)
        iw = torch.arange(w, device=ids.device)[None, :]
        return torch.where(iw < n2[:, None], drafts_at, emitted), n2

    spec_lib.accept_emit = over_accept
    return lambda: setattr(spec_lib, "accept_emit", real)


def phase_spec(results: dict) -> dict:
    """Speculative decoding at GPT-2 small's width, 4 of its 12 layers
    (random weights, max batch 8, block 16) on a repetitive trace. Parity
    lane (f32): n-gram, draft (2 of the 4 layers) and an oracle proposer
    (the spec-off stream with one draft a window wrong) greedy streams
    equal spec off (ties allowed, printed), drafts accepted, decode
    launches exact (the target's plain decodes x 4 + the draft's decode
    dispatches x 2), a
    live draft decode call against the plain version, and a verifier
    accepting one draft past the first mismatch rejected (on the oracle's
    windows, which always hold a mismatch). Speed lane (bf16): the same trace
    with spec off, n-gram and draft; tok/s, TTFT, TPOT, acceptance, the
    accepted-per-step histogram and the ledger fractions; a sampled
    n-gram run (temperature 0.9, top-k 20) replayed identically."""
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving.engine import ServingEngine
    from tpu_trainer_torch.serving.spec import draft_from_target

    phase = "spec"
    card = nvidia_smi_line()
    rec = {"nvidia_smi": card, "lanes": {}}
    total_launches = 0
    errs = []
    for lane, dtype in (("parity", "float32"), ("speed", "bfloat16")):
        cfg = dataclasses.replace(GPTConfig.gpt2_small(
            dropout=0.0, attention_dropout=0.0, dtype=dtype,
            param_dtype="float32"), num_layers=4)
        params = init_params(cfg, seed=0, device="cuda")
        dparams, dcfg = draft_from_target(params, cfg, 2)
        judge = _TieJudge(params, cfg) if lane == "parity" else None
        time_mode = "steps" if lane == "parity" else "wall"
        kinds = ["off", "ngram", "draft"] + (
            ["oracle"] if lane == "parity" else [])
        out = rec["lanes"][lane] = {}
        streams = {}
        for kind in kinds:
            kw = {"ngram": {"spec": "ngram"},
                  "draft": {"spec": "draft", "draft_params": dparams,
                            "draft_config": dcfg},
                  "oracle": {"spec": "ngram", "spec_proposer":
                             _OracleProposer(streams.get("off"),
                                             cfg.vocab_size)}}.get(kind, {})
            engine = ServingEngine(params, cfg, max_batch=8, block_size=16,
                                   spec_k=4, device="cuda", **kw)
            if kind != "oracle":
                engine.run(_spec_trace(2, seed=98, vocab=cfg.vocab_size,
                                       rid0=1000),
                           time_mode=time_mode)        # warm-up
                engine.reset_stats()
            reqs = _spec_trace(24, seed=7, vocab=cfg.vocab_size)
            res = _spec_run(engine, reqs, time_mode=time_mode,
                            capture_call=5 if kind == "draft" else 0)
            got, summ, launches = (res["streams"], res["summary"],
                                   res["launches"])
            total_launches += launches
            if launches != res["want"]:
                raise AssertionError(
                    f"{phase}: {lane} {kind}: flash_decode launches "
                    f"{launches}, want {res['want']} (plain decodes "
                    f"{res['plain_decodes']} x {cfg.num_layers} + draft "
                    f"decodes {res['draft_decodes']} x 2)")
            if len(got) != len(reqs) or any(
                    len(got[r.rid]) != r.max_new_tokens for r in reqs):
                raise AssertionError(f"{phase}: {lane} {kind}: a request "
                                     f"did not finish its tokens")
            if kind == "draft":
                errs.append(_live_err(phase, res["captured"]))
            streams[kind] = got
            row = {"launches": launches,
                   "plain_decodes": res["plain_decodes"],
                   "draft_decodes": res["draft_decodes"],
                   "decode_iters": summ["decode_iters"],
                   "generated_tokens": summ["generated_tokens"]}
            if kind != "off":
                row.update(
                    {k: summ[k] for k in ("spec_steps", "spec_drafted",
                                          "spec_accepted", "spec_accept_mean",
                                          "spec_accept_rate",
                                          "spec_accept_hist")})
                if summ["spec_accepted"] <= 0:
                    raise AssertionError(f"{phase}: {lane} {kind}: no draft "
                                         f"accepted")
                if kind == "oracle" and not (
                        summ["spec_accepted"] < summ["spec_drafted"]):
                    raise AssertionError(f"{phase}: oracle: no draft "
                                         f"rejected")
            if lane == "speed":
                ledger = engine.serve_ts[-1]
                row.update(_latency(res["done"], summ))
                # A window's tokens share one time stamp, so the gaps'
                # median can be 0: also each request's mean time a token.
                per = sorted((r.finished_at - r.first_token_at)
                             / (len(r.generated) - 1) for r in res["done"])
                row["tpot_req_p50_ms"] = 1e3 * statistics.median(per)
                row["tpot_req_p99_ms"] = 1e3 * per[
                    max(0, math.ceil(0.99 * len(per)) - 1)]
                row.update({f"{c}_frac": ledger.get(f"{c}_frac", 0.0)
                            for c in ("dispatch", "host_sched", "idle")})
            if lane == "parity" and kind != "off":
                row["ties"] = judge.check(phase, f"parity {kind}", got,
                                          streams["off"], reqs, TIE_F32)
            out[kind] = row
            log(phase, f"{lane} ({dtype}) {kind}: " + ", ".join(
                f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items() if k != "ties"))
            if kind == "oracle":
                engine.reset_stats()
                restore = _plant_over_accept()
                try:
                    few = _spec_trace(24, seed=7, vocab=cfg.vocab_size)[:6]
                    bad = _spec_run(engine, few, time_mode="steps")["streams"]
                finally:
                    restore()
                _must_reject("a verifier accepting one draft past the "
                             "first mismatch", lambda: judge.check(
                                 phase, "planted", bad,
                                 {r: streams["off"][r] for r in bad}, few,
                                 TIE_F32))
                log(phase, "planted over-accepting verifier rejected")
            del engine
        if lane == "speed":
            sampled = []
            for _ in range(2):
                engine = ServingEngine(params, cfg, max_batch=8,
                                       block_size=16, spec="ngram",
                                       spec_k=4, device="cuda")
                reqs = _spec_trace(8, seed=11, vocab=cfg.vocab_size,
                                   temperature=0.9, top_k=20)
                res = _spec_run(engine, reqs, time_mode="steps")
                summ = res["summary"]
                total_launches += res["launches"]
                if res["launches"] != res["want"]:
                    raise AssertionError(f"{phase}: sampled: launches "
                                         f"{res['launches']}, want "
                                         f"{res['want']}")
                sampled.append(res["streams"])
                del engine
            if sampled[0] != sampled[1]:
                raise AssertionError(f"{phase}: a sampled n-gram replay "
                                     f"differs")
            out["sampled_replay_equal"] = True
            log(phase, f"sampled n-gram (temperature 0.9, top-k 20): 8 "
                       f"streams replayed identically, accepted "
                       f"{summ['spec_accepted']} of {summ['spec_drafted']}")
        del judge, params, dparams
        torch.cuda.empty_cache()
    sp = rec["lanes"]["speed"]
    for kind in ("ngram", "draft"):
        log(phase, f"speed {kind} vs off: tok/s x"
                   f"{sp[kind]['tokens_per_s'] / sp['off']['tokens_per_s']:.3f}"
                   f", a request's TPOT p50 {sp[kind]['tpot_req_p50_ms']:.2f}"
                   f" vs {sp['off']['tpot_req_p50_ms']:.2f} ms on {card}")
    rec["launches"] = total_launches
    rec["max_abs_err"] = max(errs)
    results[phase] = rec
    return rec


def _filled_bitwise(phase, engine, store) -> int:
    """Every prefix-index block whose digest the store holds carries the
    store entry's bytes; returns how many."""
    n = 0
    for dig, bid in engine.cache_state._prefix.items():
        got = store.get(dig)
        if got is None:
            continue
        for i, (a, b) in enumerate(zip(engine.read_block(bid), got[1])):
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{phase}: block {bid} leaf {i} is not "
                                     f"bitwise the store entry")
        n += 1
    return n


def _ttft_ms(params, cfg, store, prompt, kw) -> float:
    from tpu_trainer_torch.serving.engine import ServingEngine
    from tpu_trainer_torch.serving.scheduler import Request, SamplingParams

    engine = ServingEngine(params, cfg, kv_store=store, **kw)
    req = Request(rid=0, prompt=prompt, max_new_tokens=1,
                  sampling=SamplingParams(temperature=0.0))
    engine.run([req], time_mode="wall")
    return 1e3 * (req.first_token_at - req.arrival_time)


def phase_kv_store(results: dict) -> dict:
    """The KV block store at GPT-2 small's width (4 of its 12 layers),
    bf16 and int8 pools, on
    a shared-prefix trace (16 requests, a 2-block prefix, greedy): a warm
    engine publishes to the store; a cold engine sharing only the store
    fills from it, every filled block bitwise the store entry, its
    streams those of an engine that kept its blocks (ties allowed,
    ``TIE_BF16``), decode launches exact; a fill that writes a leaf's
    layers reversed rejected. Prefill-role -> decode-role migration of 8
    requests with chunked prefill (16 tokens) and n-gram spec against one
    such engine. TTFT of a store-filled prefix against a recomputed one
    (2 and 31 blocks), ``read_block`` / ``write_block`` GB/s, the bytes
    migrated."""
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving.engine import ServingEngine
    from tpu_trainer_torch.serving.kv_store import KVBlockStore, leaves_nbytes

    phase = "kv-store"
    card = nvidia_smi_line()
    rec = {"nvidia_smi": card, "lanes": {}}
    total = 0
    cfg = dataclasses.replace(GPTConfig.gpt2_small(
        dropout=0.0, attention_dropout=0.0, dtype="bfloat16",
        param_dtype="float32"), num_layers=4)
    params = init_params(cfg, seed=0, device="cuda")
    judge = _TieJudge(params, cfg)
    vocab = cfg.vocab_size
    for lane, int8 in (("bf16", False), ("int8", True)):
        kw = dict(max_batch=8, block_size=16, prefix_cache=True,
                  kv_int8=int8, device="cuda")
        out = rec["lanes"][lane] = {}

        def trace():
            return _prefix_trace(16, seed=5, vocab=vocab)

        # An engine that keeps its blocks on the card: its second pass.
        ref = ServingEngine(params, cfg, **kw)
        ref.run(trace(), time_mode="steps")
        reqs = trace()
        with _DecodeCount(ref) as cnt:
            want = {r.rid: list(r.generated)
                    for r in ref.run(reqs, time_mode="steps")}
        total += cnt.launches
        store = KVBlockStore(host_bytes=1 << 30)
        warm = ServingEngine(params, cfg, kv_store=store, **kw)
        with _DecodeCount(warm) as cnt_w:
            warm.run(trace(), time_mode="steps")
        total += cnt_w.launches
        if store.counters["puts"] <= 0:
            raise AssertionError(f"{phase}: {lane}: nothing published")
        cold = ServingEngine(params, cfg, kv_store=store, **kw)
        reqs = trace()
        with _DecodeCount(cold) as cnt_c:
            got = {r.rid: list(r.generated)
                   for r in cold.run(reqs, time_mode="steps")}
        total += cnt_c.launches
        for c in (cnt, cnt_w, cnt_c):
            if c.launches != c.want:
                raise AssertionError(f"{phase}: {lane}: flash_decode "
                                     f"launches {c.launches}, want {c.want}")
        summ = cold.summary()
        if summ["store_hit_tokens"] <= 0:
            raise AssertionError(f"{phase}: {lane}: no store fill")
        ties = judge.check(phase, f"{lane} cold engine", got, want, reqs,
                           TIE_BF16)
        filled = _filled_bitwise(phase, cold, store)
        out.update(store_puts=store.counters["puts"],
                   store_hit_tokens=summ["store_hit_tokens"],
                   filled_blocks_bitwise=filled, ties=ties,
                   launches=cnt_c.launches)
        log(phase, f"{lane}: {store.counters['puts']} blocks published, "
                   f"cold engine filled {summ['store_hit_tokens']} prompt "
                   f"tokens from the store, {filled} filled blocks bitwise "
                   f"the entries, 16 streams "
                   f"{'equal' if not ties else f'equal but {len(ties)} ties'}"
                   f"; flash_decode launches {cnt_c.launches} exact")

        # The planted fault: a fill writing the K leaf's layers reversed.
        bad = ServingEngine(params, cfg, kv_store=store, **kw)

        def reversed_fill(digest, bid, _eng=bad):
            got_ = store.get(digest)
            if got_ is None:
                return None
            leaves = [got_[1][0][::-1].copy()] + list(got_[1][1:])
            return got_[0] if _eng.write_block(bid, leaves) else None

        bad.cache_state.fill_fn = reversed_fill
        bad.run(trace()[:4], time_mode="steps")
        _must_reject("a store fill writing a leaf's layers reversed",
                     lambda: _filled_bitwise(phase, bad, store))
        log(phase, f"{lane}: planted reversed-layer fill rejected")
        del bad

        # Block I/O rates on the cold engine's pools (a free block).
        bid = next(iter(cold.cache_state._prefix.values()))
        free = cold.cache_state.pool._free[-1]
        nbytes = leaves_nbytes(cold.read_block(bid))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            payload = cold.read_block(bid)
        read_s = (time.perf_counter() - t) / 50
        t = time.perf_counter()
        for _ in range(50):
            cold.write_block(free, payload)
        torch.cuda.synchronize()
        write_s = (time.perf_counter() - t) / 50
        out.update(block_bytes=nbytes, read_block_ms=1e3 * read_s,
                   write_block_ms=1e3 * write_s,
                   read_block_gb_s=nbytes / read_s / 1e9,
                   write_block_gb_s=nbytes / write_s / 1e9)
        log(phase, f"{lane}: one block {nbytes} B: read_block "
                   f"{1e3 * read_s:.3f} ms ({out['read_block_gb_s']:.3f} "
                   f"GB/s), write_block {1e3 * write_s:.3f} ms "
                   f"({out['write_block_gb_s']:.3f} GB/s)")
        del ref, warm, cold

        # TTFT: a store-filled prefix against a recomputed one.
        for blocks in (2, 31):
            prompt = _prefix_trace(1, seed=9, vocab=vocab,
                                   prefix_blocks=blocks)[0].prompt
            filled_store = KVBlockStore(host_bytes=1 << 30)
            _ttft_ms(params, cfg, filled_store, prompt, kw)   # publishes
            rec_ms = [_ttft_ms(params, cfg, None, prompt, kw)
                      for _ in range(3)]
            fill_ms = [_ttft_ms(params, cfg, filled_store, prompt, kw)
                       for _ in range(3)]
            out[f"ttft_{blocks}_blocks"] = {
                "recompute_ms": rec_ms, "store_fill_ms": fill_ms,
                "prompt_tokens": len(prompt)}
            log(phase, f"{lane}: TTFT of a {len(prompt)}-token prompt "
                       f"({blocks}-block prefix): recomputed "
                       f"{statistics.median(rec_ms):.2f} ms, store-filled "
                       f"{statistics.median(fill_ms):.2f} ms (median of 3)")

        # Prefill-role -> decode-role migration against one engine.
        extra = dict(prefill_chunk_tokens=16, spec="ngram", spec_k=4)
        mreqs = _prefix_trace(8, seed=6, vocab=vocab, max_new=24)
        single = ServingEngine(params, cfg, **kw, **extra)
        with _DecodeCount(single) as cnt_s:
            want_m = {r.rid: list(r.generated)
                      for r in single.run(mreqs, time_mode="steps")}
        mstore = KVBlockStore(host_bytes=1 << 30)
        pre = ServingEngine(params, cfg, kv_store=mstore, role="prefill",
                            **kw, **extra)
        dec = ServingEngine(params, cfg, kv_store=mstore, role="decode",
                            **kw, **extra)
        mreqs = _prefix_trace(8, seed=6, vocab=vocab, max_new=24)
        for r in mreqs:
            pre.scheduler.add(r)
        done, moved, migrated = {}, 0, 0
        with _DecodeCount(pre, dec) as cnt_m:
            for _ in range(10_000):
                if not (pre.scheduler.has_work()
                        or dec.scheduler.has_work()):
                    break
                if pre.step():
                    raise AssertionError(f"{phase}: a prefill-role engine "
                                         f"finished a request")
                for rid in pre.migratable_rids():
                    req, payload = pre.extract_request(rid)
                    if payload["leaves"] is not None:
                        migrated += leaves_nbytes(payload["leaves"])
                    migrated += sum(int(mstore.entry_nbytes(d) or 0)
                                    for d in req._prompt_digests)
                    req._kv_migration = payload
                    dec.scheduler.add(req)
                    moved += 1
                for r in dec.step():
                    done[r.rid] = list(r.generated)
        total += cnt_s.launches + cnt_m.launches
        for c in (cnt_s, cnt_m):
            if c.launches != c.want:
                raise AssertionError(f"{phase}: {lane} migration: launches "
                                     f"{c.launches}, want {c.want}")
        ties_m = judge.check(phase, f"{lane} migrated", done, want_m, mreqs,
                             TIE_BF16)
        dsum = dec.summary()
        if moved != 8 or dsum["migrated_tail_fills"] != 8:
            raise AssertionError(f"{phase}: {lane}: {moved} migrated, "
                                 f"{dsum['migrated_tail_fills']} tails "
                                 f"filled, want 8")
        out.update(migrated_requests=moved, migrated_bytes=migrated,
                   migration_ties=ties_m,
                   migration_spec_accepted=dsum["spec_accepted"],
                   migration_spec_drafted=dsum["spec_drafted"])
        log(phase, f"{lane}: 8 requests migrated prefill -> decode "
                   f"({migrated} bytes: full blocks through the store, the "
                   f"tails raw), streams of one engine "
                   f"{'equal' if not ties_m else f'but {len(ties_m)} ties'} "
                   f"with chunked prefill and n-gram spec (accepted "
                   f"{dsum['spec_accepted']} of {dsum['spec_drafted']})")
        del single, pre, dec
        torch.cuda.empty_cache()
    rec["launches"] = total
    results[phase] = rec
    return rec


# -- phase 5c: the serving fleet ---------------------------------------------

FLEET_ENGINE = dict(max_batch=8, block_size=16, prefix_cache=True,
                    device="cuda")
# The per-call RPC deadline of the fleet's workers once warm, and the
# margin the hang drill's stall may take past it (the fence's SIGKILL and
# reap, the failover's re-prefill).
FLEET_RPC_TIMEOUT_S = 2.0
FLEET_FENCE_MARGIN_S = 5.0
# The front-end iteration of the kill and hang drills: mid-decode.
FLEET_FAULT_AT = 24


def _fleet_owner(req) -> int:
    """The replica of a 2-replica fleet that affinity routes ``req`` to
    (the rendezvous of its first block digest)."""
    import types

    from tpu_trainer_torch.serving.frontend import ServingFrontend
    from tpu_trainer_torch.serving.paged_cache import chained_block_digests

    key = chained_block_digests(req.prompt, FLEET_ENGINE["block_size"])[0]
    return ServingFrontend._rendezvous(
        key, [types.SimpleNamespace(rid=r) for r in (0, 1)]).rid


def _fleet_seed(vocab, seed) -> int:
    """The first trace seed from ``seed`` whose 3 prefix groups affinity
    spreads over both replicas of a 2-replica fleet: both serve."""
    while len({_fleet_owner(r)
               for r in _fleet_trace(vocab, n=3, seed=seed)}) < 2:
        seed += 1
    return seed


def _fleet_trace(vocab, *, n=24, groups=3, new=64, seed=7):
    """24 requests in 3 shared-prefix groups (64-token prefixes, 16-48
    token tails; rid ``i`` in group ``i % 3``), ``new`` new tokens each,
    all arriving at once; even rids greedy, odd rids sampled (temperature
    1, top-k 50)."""
    import numpy as np

    from tpu_trainer_torch.serving.scheduler import Request, SamplingParams

    rs = np.random.RandomState(seed)
    systems = [rs.randint(1, vocab, size=64).tolist() for _ in range(groups)]
    out = []
    for i in range(n):
        tail = rs.randint(1, vocab, size=int(rs.randint(16, 49))).tolist()
        samp = (SamplingParams(temperature=0.0, seed=1000 + i) if i % 2 == 0
                else SamplingParams(temperature=1.0, top_k=50,
                                    seed=1000 + i))
        out.append(Request(rid=i, prompt=systems[i % groups] + tail,
                           max_new_tokens=new, sampling=samp))
    return out


def _fleet_affinity(phase, fe, reqs, groups=3) -> dict:
    """Each prefix group routed to one replica: group -> replica."""
    where: dict = {}
    for r in reqs:
        where.setdefault(r.rid % groups, set()).add(
            fe.submit_results[r.rid].replica)
    split = {g: sorted(v) for g, v in where.items() if len(v) != 1}
    if split:
        raise AssertionError(f"{phase}: prefix groups routed to several "
                             f"replicas: {split}")
    return {g: next(iter(v)) for g, v in where.items()}


def _fleet_done(phase, what, fe, reqs, fin) -> dict:
    """Conservation: every request accepted and finished with all its
    tokens; the streams."""
    s = fe.summary()
    if not (s["accepted"] == s["finished"] == len(fin) == len(reqs)
            and s["in_flight"] == 0):
        raise AssertionError(
            f"{phase}: {what}: accepted {s['accepted']}, finished "
            f"{s['finished']}, returned {len(fin)} of {len(reqs)}")
    for r in fin:
        if len(r.generated) != r.max_new_tokens:
            raise AssertionError(f"{phase}: {what}: rid {r.rid} has "
                                 f"{len(r.generated)} of {r.max_new_tokens}")
    if not s.get("span_conservation_ok", True):
        raise AssertionError(f"{phase}: {what}: span conservation broken")
    return {r.rid: list(r.generated) for r in fin}


def _fleet_bitwise(phase, what, fe, fin, fe_ref, fin_ref) -> None:
    """Routing decisions, streams and token times bitwise the
    reference's (one clock domain: steps-mode times are iterations)."""
    route = {k: (v.replica, v.routed) for k, v in fe.submit_results.items()}
    want = {k: (v.replica, v.routed)
            for k, v in fe_ref.submit_results.items()}
    if route != want:
        raise AssertionError(f"{phase}: {what}: routing differs from the "
                             f"in-process fleet's")
    got = {r.rid: (list(r.generated), list(r.token_times)) for r in fin}
    ref = {r.rid: (list(r.generated), list(r.token_times)) for r in fin_ref}
    bad = sorted(k for k in ref if got.get(k) != ref[k])
    if bad or sorted(got) != sorted(ref):
        raise AssertionError(f"{phase}: {what}: rids {bad} differ from the "
                             f"in-process fleet's streams or token times")


def _fleet_ties(phase, what, got, want, reqs, judge) -> dict:
    """Greedy rows equal ``want``'s or differ only from a tie, sampled
    rows only from a draw on a tie (the infer phase's rule at
    ``TIE_BF16``, ``_TieJudge.check`` and ``check_sampled``)."""
    greedy = {r.rid for r in reqs if r.sampling.temperature == 0.0}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{phase}: {what}: rids {sorted(got)} != "
                             f"{sorted(want)}")
    ties = judge.check(phase, what, {k: got[k] for k in greedy},
                       {k: want[k] for k in greedy}, reqs, TIE_BF16)
    moved = judge.check_sampled(
        phase, what, {k: got[k] for k in want if k not in greedy},
        {k: want[k] for k in want if k not in greedy}, reqs, TIE_BF16)
    return {"ties": ties, "sampled_moved": moved}


def _fleet_inproc(params, cfg, reqs, *, timed=False, **kw):
    """The in-process fleet (``LocalReplica``s on the card) over ``reqs``,
    its decode launches counted exactly; the engine step times."""
    from tpu_trainer_torch.serving.frontend import ServingFrontend

    fe = ServingFrontend(params, cfg, time_mode="steps", spill_tokens=None,
                         **FLEET_ENGINE, **kw)
    step_s = []
    for h in fe._replicas:
        if timed:
            def step(_rep=h.engine, _step=h.engine.step):
                t = time.perf_counter()
                out = _step()
                step_s.append(time.perf_counter() - t)
                return out
            h.engine.step = step
    with _DecodeCount(*[h.engine.engine for h in fe._replicas]) as cnt:
        fin = fe.run(reqs)
    if cnt.launches != cnt.want:
        raise AssertionError(f"fleet: in-process decode launches "
                             f"{cnt.launches}, want {cnt.want}")
    return fe, fin, cnt.launches, step_s


def _fleet_rpc(sup, cfg, reqs, **kw):
    """The same fleet over ``sup``'s worker processes; the step RPCs'
    seconds as the front-end waits for them."""
    from tpu_trainer_torch.serving.frontend import ServingFrontend

    fe = ServingFrontend(None, cfg, time_mode="steps", spill_tokens=None,
                         replica_factory=sup, **kw)
    step_s = []
    handles = [h.engine._handle for h in fe._replicas]
    for hd in handles:
        def rpc(method, params=None, frames=None, _rpc=hd.rpc):
            t = time.perf_counter()
            try:
                return _rpc(method, params, frames=frames)
            finally:
                if method == "step":
                    step_s.append(time.perf_counter() - t)
        hd.rpc = rpc
    try:
        fin = fe.run(reqs)
    finally:
        for hd in handles:
            del hd.rpc
    return fe, fin, step_s


def _pct(xs, q) -> float:
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)] if xs else float("nan")


def _worker_launches(run_dir) -> dict:
    """Each worker log's launch lines: worker -> the cumulative counts
    it printed (at every reset and at its shutdown)."""
    out: dict = {}
    for name in sorted(os.listdir(run_dir)):
        if not (name.startswith("worker") and name.endswith(".log")):
            continue
        with open(os.path.join(run_dir, name)) as f:
            for line in f:
                if line.startswith("{") and "flash_decode_launches" in line:
                    d = json.loads(line)
                    out.setdefault(d["worker"], []).append(
                        d["flash_decode_launches"])
    return out


def phase_fleet(results: dict) -> dict:
    """The serving fleet at GPT-2 small's width (bf16 over f32 random
    weights, max batch 8 a replica, block 16, prefix caching) on 24
    requests in 3 shared-prefix groups (64-token prefixes), 64 new tokens
    each, greedy and sampled, ``steps`` time. At all 12 layers: A, two
    in-process replicas: each group on one replica, decode launches
    exact; B, the same through ``WorkerSupervisor`` with two worker
    processes on the card: routing, streams and token times bitwise A's,
    the workers' decode launches A's. At 4 of the 12 layers (the drills'
    cut), against an undisturbed in-process run of that model: C,
    ``worker_kill`` mid-decode: every request finishes, streams under the
    tie rule; D, ``worker_hang``: the suspect fenced within the per-call
    timeout plus a margin, streams as in C; E, roles prefill -> decode
    through the front-end's own migration (a shared KV store): streams
    under the tie rule, the fleet hit rate. Planted faults that must
    fail: a mirror dropping the last token of a delta (B's check) and a
    router ignoring affinity (A's); a worker restarting a resubmitted
    request's delta cursor is ``scripts/torch_kernel_mutations.py``'s
    ``fleet_resubmit_stale_cursor`` (C's conservation). The five workers
    start together, beside the in-process runs that are not timed.
    Prints worker start seconds, the step RPC's p50 / p99 against the
    in-process step's, tok/s of A and B, the stall, and the decode
    launches of the runs A, B and E: each counted from zero just before
    the run (B's from its workers' logs, as a before / after delta). C's
    and D's are not counted: a killed or fenced worker never reports its
    count."""
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving import frontend as fe_lib
    from tpu_trainer_torch.serving import remote
    from tpu_trainer_torch.utils import faults

    phase = "fleet"
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2_small(dropout=0.0, attention_dropout=0.0,
                               dtype="bfloat16", param_dtype="float32")
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    dev = FLEET_ENGINE["device"]
    params = init_params(cfg, seed=0, device=dev)
    params4 = init_params(cfg4, seed=0, device=dev)
    vocab = cfg.vocab_size
    rec = {"nvidia_smi": card}
    dirs = [tempfile.mkdtemp(prefix=f"fleet{i}-") for i in range(2)]
    sups = []
    spawned = []

    def supervisor(p, c, run_dir, **kw):
        s = remote.WorkerSupervisor(
            p, c, engine_kwargs=FLEET_ENGINE, run_dir=run_dir,
            rpc_timeout_s=FLEET_RPC_TIMEOUT_S, first_step_timeout_s=300.0,
            **kw)
        sups.append(s)
        return s

    try:
        t0 = time.perf_counter()
        sup = supervisor(params, cfg, dirs[0])           # A's model: B
        drill = supervisor(params4, cfg4, dirs[1])       # C and D
        for s, n in ((sup, 2), (drill, 3)):
            spawned += [(s, s._launch()) for _ in range(n)]
        npz_s = time.perf_counter() - t0

        # Beside the workers' start: the in-process runs nothing times.
        seed, small_seed = _fleet_seed(vocab, 7), _fleet_seed(vocab, 11)
        judge4 = _TieJudge(params4, cfg4)
        _must_reject("a router that ignores affinity", lambda: (
            _fleet_planted_router(phase, params, cfg, vocab, seed, fe_lib)))
        reqs = _fleet_trace(vocab, seed=seed)
        fe_r, fin_r, _, _ = _fleet_inproc(params4, cfg4, reqs, replicas=2)
        want4 = _fleet_done(phase, "4-layer reference", fe_r, reqs, fin_r)
        reqs = _fleet_trace(vocab, seed=seed)
        fe_e, fin_e, le, _ = _fleet_inproc(
            params4, cfg4, reqs, replicas=2,
            replica_roles=["prefill", "decode"], kv_store_bytes=1 << 30)
        got = _fleet_done(phase, "E", fe_e, reqs, fin_e)
        se = fe_e.summary()
        if se["migrations"] != len(reqs):
            raise AssertionError(f"{phase}: E: {se['migrations']} "
                                 f"migrations, want {len(reqs)}")
        te = _fleet_ties(phase, "E roles", got, want4, reqs, judge4)
        small = _fleet_trace(vocab, n=6, new=16, seed=small_seed)
        fe_s, fin_s, _, _ = _fleet_inproc(params, cfg, small, replicas=2)
        rec["E"] = {"migrations": se["migrations"],
                    "migrated_bytes": se["migrated_bytes"],
                    "fleet_prefix_hit_rate": se["fleet_prefix_hit_rate"],
                    "reference_prefix_hit_rate":
                        fe_r.summary()["prefix_hit_rate"],
                    "launches": le, **te}

        for s, args in spawned:
            s._pool.append(s._handshake(*args))
        start_s = time.perf_counter() - t0
        # Every worker's first steps (the libraries' first calls) out of
        # the timed runs; a warm worker gets the per-call timeout.
        for s, n, c in ((sup, 2, cfg), (drill, 3, cfg4)):
            _fleet_rpc(s, c, _fleet_trace(vocab, n=2 * n, new=4, seed=3),
                       replicas=n, routing="least_loaded")
            s.reset()
        rec.update(worker_start_s=start_s, params_npz_s=npz_s,
                   warmup_s=time.perf_counter() - t0 - start_s)
        log(phase, f"5 workers started together in {start_s:.2f} s, beside "
                   f"the untimed in-process runs (the params npz "
                   f"{npz_s:.2f} s of it); warm-up {rec['warmup_s']:.2f} s; "
                   f"nvidia-smi: {card}")

        # A: the in-process fleet at 12 layers.
        reqs = _fleet_trace(vocab, seed=seed)
        fe_a, fin_a, l_a, step_a = _fleet_inproc(params, cfg, reqs,
                                                 replicas=2, timed=True)
        _fleet_done(phase, "A", fe_a, reqs, fin_a)
        groups = _fleet_affinity(phase, fe_a, reqs)
        sa = fe_a.summary()
        rec["A"] = {"tokens_per_s": sa["tokens_per_s"],
                    "wall_s": sa["wall_s"], "launches": l_a,
                    "step_p50_ms": 1e3 * _pct(step_a, 0.5),
                    "step_p99_ms": 1e3 * _pct(step_a, 0.99),
                    "groups": groups,
                    "prefix_hit_rate": sa["prefix_hit_rate"]}
        log(phase, f"A in-process: 24/24 finished, groups -> replicas "
                   f"{groups}, {sa['tokens_per_s']:.1f} tok/s, engine step "
                   f"p50 {rec['A']['step_p50_ms']:.2f} ms p99 "
                   f"{rec['A']['step_p99_ms']:.2f} ms, decode launches "
                   f"{l_a}")

        # B: the same fleet over two worker processes.
        reqs = _fleet_trace(vocab, seed=seed)
        before = _worker_launches(dirs[0])
        fe_b, fin_b, rpc_b = _fleet_rpc(sup, cfg, reqs, replicas=2)
        _fleet_done(phase, "B", fe_b, reqs, fin_b)
        _fleet_bitwise(phase, "B", fe_b, fin_b, fe_a, fin_a)
        sb = fe_b.summary()
        wids_b = [h.engine.worker_id for h in fe_b._replicas]
        sup.reset()
        after = _worker_launches(dirs[0])
        lb = sum(after[w][-1] - before.get(w, [0])[-1] for w in wids_b)
        if lb != l_a:
            raise AssertionError(f"{phase}: B's workers launched decode "
                                 f"{lb} times, A's replicas {l_a}")
        rec["B"] = {"tokens_per_s": sb["tokens_per_s"],
                    "wall_s": sb["wall_s"], "launches": lb,
                    "rpc_step_p50_ms": 1e3 * _pct(rpc_b, 0.5),
                    "rpc_step_p99_ms": 1e3 * _pct(rpc_b, 0.99),
                    "tok_s_ratio": sb["tokens_per_s"] / sa["tokens_per_s"]}
        log(phase, f"B 2 workers: routing, streams and token times bitwise "
                   f"A's; {sb['tokens_per_s']:.1f} tok/s "
                   f"({rec['B']['tok_s_ratio']:.3f}x A); step RPC p50 "
                   f"{rec['B']['rpc_step_p50_ms']:.2f} ms p99 "
                   f"{rec['B']['rpc_step_p99_ms']:.2f} ms (in-process "
                   f"step p50 {rec['A']['step_p50_ms']:.2f} ms p99 "
                   f"{rec['A']['step_p99_ms']:.2f} ms); the workers' decode "
                   f"launches {lb} == A's")
        orig_apply = remote.RemoteReplica._apply_delta

        def dropping(self, req, d):
            orig_apply(self, req, dict(d, gen=d["gen"][:-1],
                                       times=d["times"][:-1]))

        def mirror_drop():
            remote.RemoteReplica._apply_delta = dropping
            try:
                small = _fleet_trace(vocab, n=6, new=16, seed=small_seed)
                fe, fin, _ = _fleet_rpc(sup, cfg, small, replicas=2)
            finally:
                remote.RemoteReplica._apply_delta = orig_apply
                sup.reset()
            _fleet_bitwise(phase, "planted mirror", fe, fin, fe_s, fin_s)
        _must_reject("a mirror that drops the last delta token", mirror_drop)

        # C: a real SIGKILL mid-decode (4 layers).
        victim = groups[0]
        os.environ["TPU_TRAINER_FAULT_REPLICA"] = str(victim)
        try:
            reqs = _fleet_trace(vocab, seed=seed)
            with faults.plan(f"worker_kill@{FLEET_FAULT_AT}"):
                fe_c, fin_c, _ = _fleet_rpc(drill, cfg4, reqs, replicas=2)
            sc = fe_c.summary()
            got = _fleet_done(phase, "C", fe_c, reqs, fin_c)
            if sc["worker_deaths"] != 1 or sc["failover_events"] != 1:
                raise AssertionError(f"{phase}: C: {sc['worker_deaths']} "
                                     f"deaths, {sc['failover_events']} "
                                     f"failovers, want 1 and 1")
            tc = _fleet_ties(phase, "C worker_kill", got, want4, reqs,
                             judge4)
            drill.reset()

            # D: a SIGSTOP; the per-call timeout fences the suspect.
            reqs = _fleet_trace(vocab, seed=seed)
            fenced0 = drill.n_fenced    # C's kill fenced its dead worker
            with faults.plan(f"worker_hang@{FLEET_FAULT_AT}"):
                fe_d, fin_d, _ = _fleet_rpc(drill, cfg4, reqs, replicas=2)
            sd_ = fe_d.summary()
            sd_["fenced"] -= fenced0
            got = _fleet_done(phase, "D", fe_d, reqs, fin_d)
            stall = sd_.get("stall_recovery_max_s", 0.0)
            if not (sd_["fenced"] == 1 and sd_["worker_deaths"] == 1
                    and 0.9 * FLEET_RPC_TIMEOUT_S <= stall
                    <= FLEET_RPC_TIMEOUT_S + FLEET_FENCE_MARGIN_S):
                raise AssertionError(
                    f"{phase}: D: fenced {sd_['fenced']}, deaths "
                    f"{sd_['worker_deaths']}, stall {stall:.3f} s (want "
                    f"{FLEET_RPC_TIMEOUT_S} s + at most "
                    f"{FLEET_FENCE_MARGIN_S} s)")
            td = _fleet_ties(phase, "D worker_hang", got, want4, reqs,
                             judge4)
        finally:
            os.environ.pop("TPU_TRAINER_FAULT_REPLICA", None)
        rec["C"] = {"failed_over": sc["failed_over_requests"], **tc}
        rec["D"] = {"stall_s": stall, "fenced": sd_["fenced"], **td}
        log(phase, f"C worker_kill@{FLEET_FAULT_AT} on replica {victim} (4 "
                   f"layers): {sc['failed_over_requests']} requests failed "
                   f"over, 24/24 finished, greedy ties {len(tc['ties'])}, "
                   f"sampled rows moved {len(tc['sampled_moved'])}")
        log(phase, f"D worker_hang@{FLEET_FAULT_AT} (4 layers): fenced after "
                   f"a stall of {stall:.3f} s (per-call timeout "
                   f"{FLEET_RPC_TIMEOUT_S} s, margin "
                   f"{FLEET_FENCE_MARGIN_S} s), 24/24 finished, greedy "
                   f"ties {len(td['ties'])}, sampled rows moved "
                   f"{len(td['sampled_moved'])}")
        log(phase, f"E roles prefill -> decode (4 layers): "
                   f"{se['migrations']} migrated ({se['migrated_bytes']} "
                   f"bytes), fleet hit rate "
                   f"{se['fleet_prefix_hit_rate']:.3f} (two plain replicas "
                   f"{rec['E']['reference_prefix_hit_rate']:.3f}), greedy "
                   f"ties {len(te['ties'])}, sampled rows moved "
                   f"{len(te['sampled_moved'])}")
    finally:
        for s in sups:
            s.close()
        for s, (_wid, proc, _log) in spawned:
            if proc.poll() is None:
                proc.kill()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    rec["worker_launches"] = lb
    rec["launches"] = l_a + lb + le
    rec["seconds"] = time.perf_counter() - t_phase
    log(phase, f"flash_decode launches: A {l_a} in-process, B {lb} in its "
               f"workers (their logs), E {le} in-process; phase "
               f"{rec['seconds']:.1f} s")
    results[phase] = rec
    return rec


def _fleet_planted_router(phase, params, cfg, vocab, seed, fe_lib) -> None:
    """A's affinity check on a fleet whose router ignores affinity (the
    least-loaded replica for every keyed request): submits only."""
    route = fe_lib.ServingFrontend._route

    def least(self, req):
        target, how = route(self, req)
        if how == "affinity":
            return min(self._live(routable=True), key=self._load), how
        return target, how

    fe_lib.ServingFrontend._route = least
    try:
        fe = fe_lib.ServingFrontend(params, cfg, replicas=2,
                                    time_mode="steps", spill_tokens=None,
                                    **FLEET_ENGINE)
        reqs = _fleet_trace(vocab, seed=seed)
        for r in reqs:
            fe.submit(r)
    finally:
        fe_lib.ServingFrontend._route = route
    _fleet_affinity(phase, fe, reqs)


# -- phase 5d: tensor-parallel decode on one card -----------------------------

# The phase's engines: the engine phase's max batch and block; the device
# is patched to "cpu" to rehearse the phase on a CPU.
TP_ENGINE = dict(max_batch=8, block_size=16, device="cuda")


def _tp_model(layers: int = 12, kv_heads=None):
    """GPT-2 small at full width (bf16 over f32 random weights from seed
    0), ``layers`` deep, ``kv_heads`` kv heads."""
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params

    cfg = dataclasses.replace(
        GPTConfig.gpt2_small(dropout=0.0, attention_dropout=0.0,
                             dtype="bfloat16", param_dtype="float32",
                             num_kv_heads=kv_heads), num_layers=layers)
    return cfg, init_params(cfg, seed=0, device=TP_ENGINE["device"])


def _tp_engine(params, cfg, tp: int, **kw):
    """A replica at ``tp`` shards, all on card 0 (``mesh_devices`` = tp
    zeros: one H100 holds every shard)."""
    from tpu_trainer_torch.serving.engine import ServingEngine

    mesh = {"mesh_devices": (0,) * tp} if tp > 1 else {}
    return ServingEngine(params, cfg, **TP_ENGINE, **mesh, **kw)


def _tp_trace(vocab):
    """The engine phase's 24-request trace (even rids greedy)."""
    return _trace(24, seed=1, prompt_len_range=(64, 512),
                  max_new_range=(16, 64), vocab=vocab)


def _tp_serve(phase, what, engine, *, warm: bool) -> dict:
    """The trace through ``engine`` in ``steps`` time (a 3-request warm-up
    first when ``warm``), its decode launches counted from zero: exactly
    tp x layers x decode iterations."""
    vocab, layers = engine.config.vocab_size, engine.config.num_layers
    tp = engine.config.paged_tp
    if warm:
        engine.run(_trace(3, seed=99, prompt_len_range=(64, 128),
                          max_new_range=(4, 8), vocab=vocab),
                   time_mode="steps")
        engine.reset_stats()
    reqs = _tp_trace(vocab)
    with _DecodeCount(engine) as cnt:
        done = engine.run(reqs, time_mode="steps")
    summ = engine.summary()
    if len(done) != len(reqs) or any(
            len(r.generated) != r.max_new_tokens for r in done):
        raise AssertionError(f"{phase}: {what}: {len(done)}/{len(reqs)} "
                             f"finished whole")
    if cnt.launches != cnt.want * tp:
        raise AssertionError(
            f"{phase}: {what}: {cnt.launches} decode launches, want tp "
            f"{tp} x {layers} layers x {cnt.plain} decode iterations = "
            f"{cnt.want * tp}")
    out = {"reqs": reqs, "streams": {r.rid: list(r.generated) for r in done},
           "launches": cnt.launches, "decode_iters": cnt.plain,
           **_latency(done, summ)}
    log(phase, f"{what}: 24/24 finished, decode launches {cnt.launches} == "
               f"{tp} x {layers} x {cnt.plain}; {out['tokens_per_s']:.1f} "
               f"tok/s, TPOT p50 {out['tpot_p50_ms']:.2f} ms")
    return out


def _tp_hold(phase, what, got, want, judge) -> dict:
    """``got``'s streams against ``want``'s: bitwise, or under the tie
    rule (``_fleet_ties``; the judge, the f32 model, built only then)."""
    if got["streams"] == want["streams"]:
        return {"bitwise": True, "ties": [], "sampled_moved": []}
    log(phase, f"{what}: streams not bitwise; holding them at the tie rule")
    return {"bitwise": False, **_fleet_ties(
        phase, what, got["streams"], want["streams"], want["reqs"], judge())}


def _tp_bytes(engine) -> dict:
    """Persistent bytes of each shard, from the engine's own tensors: its
    parameter pieces and its pools."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    cache = engine.device_cache
    if "shards" not in cache:
        return {"params": [nbytes(engine.model.parameters())],
                "pools": [nbytes(cache[k] for k in
                                 ("pool_k", "pool_v", "scale_k", "scale_v")
                                 if k in cache)]}
    return {"params": engine.model.params.nbytes(),
            "pools": [nbytes(sh.values()) for sh in cache["shards"]]}


def _tp_check_bytes(phase, what, got, one, tp, sharded_pools) -> None:
    """A shard's parameters within 1 % of P/tp; its pools 1/tp of one
    device's (kv-sharded) or all of them (replicated)."""
    p, pools = one["params"][0], one["pools"][0]
    want_pool = pools // tp if sharded_pools else pools
    if (len(got["params"]) != tp or max(got["params"]) > 1.01 * p / tp
            or sum(got["params"]) < p or got["pools"] != [want_pool] * tp):
        raise AssertionError(
            f"{phase}: {what}: shard bytes {got}, want params ~{p / tp:.0f} "
            f"and pools {want_pool} each (one device: {one})")


def _tp_blocks(phase, what, a, b, n: int, *, equal: bool) -> int:
    """Blocks 0..n-1: ``b.read_block`` encodes to ``a``'s ``KVB1`` frame
    byte for byte when ``equal``; always, ``a``'s frame written into
    ``b`` reads back as that frame."""
    from tpu_trainer_torch.serving.remote import encode_kv_block

    for bid in range(n):
        fa = a.read_block(bid)
        if equal and encode_kv_block(b.read_block(bid)) != encode_kv_block(
                fa):
            raise AssertionError(f"{phase}: {what}: block {bid}'s frame "
                                 f"differs from one device's")
    spare = n - 1
    keep = b.read_block(spare)
    for bid in range(1, n, max(1, n // 4)):
        fa = a.read_block(bid)
        if not b.write_block(spare, fa) or encode_kv_block(
                b.read_block(spare)) != encode_kv_block(fa):
            raise AssertionError(f"{phase}: {what}: one device's block {bid} "
                                 f"did not round-trip through the shards")
    b.write_block(spare, keep)
    return n


def _tp_kernel_checks(phase) -> dict:
    """The sharded dispatch at the engine's decode shape (b 8, 12 heads
    of 64, block 16, 64 blocks a row, 513 pool blocks, ragged lengths),
    bf16 and int8 pools: kv-sharded at tp 2 and 4 and replicated (2 kv
    heads, tp 4: each shard reads its one kv head in place) bitwise one
    ``flash_decode`` call on the whole pool; the ``kv_head_base`` window
    against the plain version within ``KERNEL_ATOL``; two planted faults
    (shards concatenated in reverse, a shard ignoring its kv head)
    rejected; times of the replicated dispatch and of one call (12
    layers' pools in a CUDA graph, as the kernel phase times)."""
    from tpu_trainer_torch.ops import flash

    lengths = [1024, 1, 517, 64, 300, 1000, 33, 768]
    cases = {
        12: _kernel_case("tp", b=8, h=12, kvh=12, d=64, bsz=16, mb=64,
                         nblk=513, null_row=1, lengths=lengths, seed=3),
        2: _kernel_case("tp-gqa", b=8, h=12, kvh=2, d=64, bsz=16, mb=64,
                        nblk=513, layers=12, null_row=1, lengths=lengths,
                        seed=4),
    }
    rec = {"window_max_abs_err": 0.0, "bitwise_calls": 0}

    def chunks(x, tp, kvh):
        if x is None:
            return None
        if kvh % tp == 0:
            return [c.contiguous() for c in x.chunk(tp, dim=2)]
        return [x] * tp

    for kvh, case in cases.items():
        q, ops = case["q"], (case["tables"], case["lengths"])
        for dtype in ("bfloat16", "int8"):
            pk, pv, sk, sv = _pools(case, dtype)
            pk, pv = pk[0], pv[0]
            sk, sv = (None, None) if sk is None else (sk[0], sv[0])
            kw = {} if sk is None else {"k_scale": sk, "v_scale": sv}
            one = flash.flash_decode(q, pk, pv, *ops, **kw)
            for tp in ((2, 4) if kvh == 12 else (4,)):
                def sharded(tp=tp):
                    return flash.paged_attention_sharded(
                        q, chunks(pk, tp, kvh), chunks(pv, tp, kvh), *ops,
                        kv_heads=kvh, k_scales=chunks(sk, tp, kvh),
                        v_scales=chunks(sv, tp, kvh))

                def same(got, what, tp=tp):
                    if not torch.equal(got, one):
                        raise AssertionError(
                            f"{phase}: {what} (kvh {kvh}, tp {tp}, {dtype}) "
                            f"differs from one call by "
                            f"{float((got - one).abs().max()):.3e}")
                got = sharded()
                same(got, "the sharded dispatch")
                rec["bitwise_calls"] += 1
                _must_reject("shards concatenated in reverse order",
                             lambda got=got, tp=tp: same(torch.cat(
                                 got.chunk(tp, dim=1)[::-1], dim=1),
                                 "reversed shards"))
            if kvh == 2:
                hl = 12 // 4
                for i in range(4):
                    win = dict(kv_head_base=i // 2, kv_heads=1)
                    qi = q[:, i * hl:(i + 1) * hl]
                    got = flash.flash_decode(qi, pk, pv, *ops, **kw, **win)
                    want = flash.paged_attention_reference(qi, pk, pv, *ops,
                                                           **kw, **win)
                    err = float((got - want).abs().max())
                    rec["window_max_abs_err"] = max(
                        rec["window_max_abs_err"], err)
                    if err > KERNEL_ATOL:
                        raise AssertionError(
                            f"{phase}: kv_head_base {i // 2} ({dtype}) "
                            f"kernel vs plain max |err| {err:.3e} > "
                            f"{KERNEL_ATOL:.0e}")
                    if i == 3:
                        def ignores_base():
                            bad = flash.flash_decode(qi, pk, pv, *ops, **kw,
                                                     kv_head_base=0,
                                                     kv_heads=1)
                            if not torch.equal(bad, got):
                                raise AssertionError("shard 3 read kv head "
                                                     "0")
                        _must_reject("a shard that ignores its kv head",
                                     ignores_base)
            del pk, pv, sk, sv
    gq = cases[2]
    pk, pv = gq["pk"].to(torch.bfloat16), gq["pv"].to(torch.bfloat16)
    ops = (gq["tables"], gq["lengths"])
    n_layers = pk.shape[0]
    rec["replicated_tp4_ms"] = cuda_ms(
        lambda i: flash.paged_attention_sharded(
            gq["q"], [pk[i]] * 4, [pv[i]] * 4, *ops, kv_heads=2),
        n_layers=n_layers)
    rec["one_call_ms"] = cuda_ms(
        lambda i: flash.flash_decode(gq["q"], pk[i], pv[i], *ops),
        n_layers=n_layers)
    rec["window_ms"] = cuda_ms(
        lambda i: flash.flash_decode(gq["q"][:, :3], pk[i], pv[i], *ops,
                                     kv_head_base=1, kv_heads=1),
        n_layers=n_layers)
    rec["one_call_bound_ms"], rec["bound_by"] = _bound_ms(gq, "bfloat16", 1)
    rec["window_bound_ms"], _ = _bound_ms(dict(gq, h=3, kvh=1),
                                          "bfloat16", 1)
    log(phase, f"sharded dispatch bitwise one call in {rec['bitwise_calls']} "
               f"cases (kv-sharded tp 2 and 4, replicated tp 4; bf16, "
               f"int8); kv_head_base window vs plain max|err| "
               f"{rec['window_max_abs_err']:.2e} <= {KERNEL_ATOL:.0e}; "
               f"replicated tp 4 {rec['replicated_tp4_ms']:.4f} ms (4 "
               f"launches) vs one call {rec['one_call_ms']:.4f} ms (bound "
               f"{rec['one_call_bound_ms']:.4f} ms, {rec['bound_by']}); one "
               f"shard's window {rec['window_ms']:.4f} ms (bound "
               f"{rec['window_bound_ms']:.4f} ms)")
    return rec


def phase_tp_decode(results: dict) -> dict:
    """Tensor-parallel paged decode on one card (``serving/sharding.py``,
    ``ops/flash.py::paged_attention_sharded``): GPT-2 small at full width
    (bf16 over f32 random weights), max batch 8, block 16, the engine
    phase's 24-request trace in ``steps`` time. Every shard on card 0
    (``mesh_devices`` of repeated zeros). Checks:

    - the dispatch at the decode shape (``_tp_kernel_checks``): bitwise
      one call in both pool layouts, the ``kv_head_base`` window against
      its plain version, two planted faults rejected;
    - at 12 layers, tp 2 ``(0, 0)`` and tp 4 ``(0, 0, 0, 0)`` with
      kv-sharded pools against tp 1, and an int8-pool lane at tp 2
      against int8 at tp 1: streams bitwise (or greedy rows at a tie
      and sampled rows drawn at a tie, ``_fleet_ties``), decode launches
      exactly tp x layers x decode iterations, a shard's persistent
      bytes about P/tp of parameters and 1/tp of the pools, the first 64
      blocks' ``KVB1`` frames one device's (when the streams are bitwise)
      and one device's frames round-tripping through the shards;
    - 2 kv heads (GQA, replicated pools) at tp 4, 4 of the 12 layers,
      against tp 1: the same, each shard holding the whole pools;
    - one worker process (``WorkerSupervisor(device_sets=[[0, 0]],
      param_shard_world=2)``, a tp-2 engine from 2-way parameter shards)
      serving the trace through a front-end: the in-process tp-2 streams
      bitwise, its decode launches (its log) theirs.

    Prints tok/s and TPOT p50 at tp 1, 2 and 4 (host-bound: no gain is
    expected on one card) and the card's name and power limit."""
    from tpu_trainer_torch.serving import remote
    from tpu_trainer_torch.serving.frontend import ServingFrontend

    phase = "tp-decode"
    card = nvidia_smi_line()
    t_phase = time.perf_counter()
    cfg, params = _tp_model()
    rec = {"nvidia_smi": card}
    judges = {}

    def judge(key, p, c):
        def build():
            if key not in judges:
                judges[key] = _TieJudge(p, c)
            return judges[key]
        return build

    wdir = tempfile.mkdtemp(prefix="tp-")
    sup = remote.WorkerSupervisor(
        params, cfg, engine_kwargs=dict(TP_ENGINE, mesh_tensor=2),
        run_dir=wdir, device_sets=[[0, 0]], param_shard_world=2,
        first_step_timeout_s=300.0)
    spawned = sup._launch()
    try:
        # Beside the worker's start: the kernel checks and the untimed
        # GQA and int8 lanes.
        rec["kernel"] = _tp_kernel_checks(phase)

        cfg_g, params_g = _tp_model(layers=4, kv_heads=2)
        runs = {}
        for tp in (1, 4):
            eng = _tp_engine(params_g, cfg_g, tp)
            runs[tp] = _tp_serve(phase, f"GQA 2 kv heads, 4 layers, tp {tp}",
                                 eng, warm=False)
            runs[tp]["bytes"] = _tp_bytes(eng)
            if tp == 1:
                one = eng
            else:
                _tp_check_bytes(phase, "GQA tp 4", runs[4]["bytes"],
                                runs[1]["bytes"], 4, sharded_pools=False)
                held = _tp_hold(phase, "GQA tp 4", runs[4], runs[1],
                                judge("gqa", params_g, cfg_g))
                _tp_blocks(phase, "GQA tp 4", one, eng, 32,
                           equal=held["bitwise"])
        rec["gqa_tp4"] = {"launches": runs[4]["launches"],
                          "launches_tp1": runs[1]["launches"],
                          "bytes": runs[4]["bytes"],
                          "bytes_tp1": runs[1]["bytes"], **held}
        del one, eng, params_g

        int8 = {}
        for tp in (1, 2):
            eng = _tp_engine(params, cfg, tp, kv_int8=True)
            int8[tp] = _tp_serve(phase, f"int8 pools, tp {tp}", eng,
                                 warm=False)
            if tp == 1:
                one = eng
            else:
                held = _tp_hold(phase, "int8 tp 2", int8[2], int8[1],
                                judge("12", params, cfg))
                _tp_blocks(phase, "int8 tp 2", one, eng, 32,
                           equal=held["bitwise"])
        rec["int8_tp2"] = {"launches": int8[2]["launches"],
                           "launches_tp1": int8[1]["launches"], **held}
        del one, eng

        # The worker: a tp-2 engine from 2-way parameter shards.
        sup._pool.append(sup._handshake(*spawned))
        worker_s = time.perf_counter() - t_phase
        reqs = _tp_trace(cfg.vocab_size)
        fe = ServingFrontend(None, cfg, replicas=1, time_mode="steps",
                             replica_factory=sup)
        fin = fe.run(reqs)
        worker = {"reqs": reqs,
                  "streams": {r.rid: list(r.generated) for r in fin}}
        sup.reset()
        counts = _worker_launches(wdir)
        worker["launches"] = sum(v[-1] for v in counts.values())
    finally:
        sup.close()
        if spawned[1].poll() is None:
            spawned[1].kill()
        shutil.rmtree(wdir, ignore_errors=True)

    # The timed lanes, nothing beside them: tp 1, 2, 4.
    lanes = {}
    for tp in (1, 2, 4):
        eng = _tp_engine(params, cfg, tp)
        lanes[tp] = _tp_serve(phase, f"tp {tp}", eng, warm=True)
        lanes[tp]["bytes"] = _tp_bytes(eng)
        if tp == 1:
            one = eng
            continue
        _tp_check_bytes(phase, f"tp {tp}", lanes[tp]["bytes"],
                        lanes[1]["bytes"], tp, sharded_pools=True)
        lanes[tp]["held"] = _tp_hold(phase, f"tp {tp}", lanes[tp], lanes[1],
                                     judge("12", params, cfg))
        _tp_blocks(phase, f"tp {tp}", one, eng, 64,
                   equal=lanes[tp]["held"]["bitwise"])
        del eng
    del one
    if worker["streams"] != lanes[2]["streams"]:
        bad = sorted(k for k in lanes[2]["streams"]
                     if worker["streams"].get(k) != lanes[2]["streams"][k])
        raise AssertionError(f"{phase}: the worker's streams differ from "
                             f"the in-process tp-2 engine's: rids {bad}")
    if worker["launches"] != lanes[2]["launches"]:
        raise AssertionError(f"{phase}: the worker launched decode "
                             f"{worker['launches']} times, the in-process "
                             f"tp-2 engine {lanes[2]['launches']}")
    for tp in (1, 2, 4):
        lane = lanes[tp]
        rec[f"tp{tp}"] = {k: lane[k] for k in (
            "launches", "decode_iters", "tokens_per_s", "wall_s",
            "tpot_p50_ms", "tpot_p99_ms", "ttft_p50_ms", "bytes")}
        if tp > 1:
            rec[f"tp{tp}"].update(lane["held"])
    rec["worker"] = {"launches": worker["launches"],
                     "ready_s": worker_s}
    rec["launches"] = (sum(lanes[tp]["launches"] for tp in lanes)
                       + sum(int8[tp]["launches"] for tp in int8)
                       + sum(runs[tp]["launches"] for tp in runs)
                       + worker["launches"])
    rec["seconds"] = time.perf_counter() - t_phase
    p1 = lanes[1]["bytes"]["params"][0]
    log(phase, "tok/s " + ", ".join(
        f"tp {tp} {lanes[tp]['tokens_per_s']:.1f} (TPOT p50 "
        f"{lanes[tp]['tpot_p50_ms']:.2f} ms)" for tp in lanes)
        + f"; bitwise tp 2 {lanes[2]['held']['bitwise']}, tp 4 "
        f"{lanes[4]['held']['bitwise']}, int8 tp 2 "
        f"{rec['int8_tp2']['bitwise']}, GQA tp 4 {rec['gqa_tp4']['bitwise']}")
    log(phase, "shard bytes: params " + ", ".join(
        f"tp {tp} {max(lanes[tp]['bytes']['params']) / p1:.4f} of P"
        for tp in (2, 4)) + ", pools " + ", ".join(
        f"tp {tp} {lanes[tp]['bytes']['pools'][0]} of "
        f"{lanes[1]['bytes']['pools'][0]}" for tp in (2, 4))
        + f"; GQA tp 4 pools {rec['gqa_tp4']['bytes']['pools'][0]} of "
        f"{rec['gqa_tp4']['bytes_tp1']['pools'][0]} a shard")
    log(phase, f"the worker (device set [0, 0], 2-way parameter shards, "
               f"ready {worker_s:.1f} s into the phase): streams bitwise "
               f"the in-process tp-2 engine's, decode launches "
               f"{worker['launches']}; phase decode launches "
               f"{rec['launches']}; {rec['seconds']:.1f} s ({card})")
    results[phase] = rec
    return rec


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


def _cut_yaml(tmp: str, name: str, tag: str, **fields) -> str:
    """``configs/<name>`` with model fields set, written to
    ``tmp/<tag>_<name>``: a field the yaml has is replaced in place, any
    other joins its ``model:`` section. For the runs that take a shipped
    config without dropout, at a smaller depth or with another router."""
    import re

    with open(os.path.join(ROOT, "configs", name)) as f:
        text = f.read()
    for key, value in fields.items():
        v = f'"{value}"' if isinstance(value, str) else str(value)
        text, n = re.subn(rf"(?m)^(\s*{key}:).*$", rf"\g<1> {v}", text)
        if not n:
            text = re.sub(r"(?m)^model:$", f"model:\n  {key}: {v}", text,
                          count=1)
    path = os.path.join(tmp, f"{tag}_{name}")
    with open(path, "w") as f:
        f.write(text)
    return path


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
    one head + CE each; with the dropless MoE 3 gmm a layer a forward, 3
    more and 3 tgmm a layer backward (the capacity router launches
    none)."""
    from tpu_trainer_torch.ops import flash

    L = cfg.num_layers
    fwd = 2 if cfg.gradient_checkpointing else 1
    fused = flash.backward_impl(cfg.max_seq_len, segmented) == "fused"
    moe_on = cfg.num_experts > 0 and cfg.moe_impl == "dropless"
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
    here, which resumes from step 4 (run 2). Step 8's state
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
    moe_argv = ["--config", _cut_yaml(tmp, "moe_small.yaml", "l2",
                                      num_layers=2),
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
    log("cli", f"moe_small.yaml at 2 layers --moe_impl dropless, 3 steps + "
               f"1 eval batch "
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
    step ``last``'s checkpoint aside, rerun ``argv`` here too (run 2: a new
    trainer that restores from disk; the ft phase's chain restarts in
    fresh processes, and times them) and require that it resumed from
    ``resume_at`` and that step ``last``'s ``state.npz`` and
    ``meta.json`` and the losses of the steps after ``resume_at`` are
    bitwise equal. Returns run 1's and run 2's launches, run 1's JSONL
    train records and the seconds."""
    import numpy as np

    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    ckdir = argv[argv.index("--checkpoint_dir") + 1]
    jsonl = argv[argv.index("--metrics_jsonl") + 1]
    run1 = _cli_in_process(phase, argv)
    final = os.path.join(ckdir, f"step_{last:08d}")
    aside = os.path.join(tmp, f"{phase}_aside")
    os.replace(final, aside)
    t0 = time.perf_counter()
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        run2 = _cli_in_process(phase, argv)
    run2_s = time.perf_counter() - t0
    for ln in said.getvalue().splitlines():
        log(phase, f"  run 2 | {ln}")
    if f"step_{resume_at:08d}" not in said.getvalue():
        raise AssertionError(f"{phase}: run 2 did not resume from step "
                             f"{resume_at}")
    with np.load(os.path.join(final, "state.npz")) as a, np.load(
            os.path.join(aside, "state.npz")) as b:
        if a.files != b.files:
            raise AssertionError(f"{phase}: state arrays differ in name")
        differ = []
        for k in a.files:
            # Each file's member read on its own thread (the read and its
            # CRC leave the interpreter lock).
            theirs = _background(lambda k=k: b[k])
            if not np.array_equal(a[k], theirs()):
                differ.append(k)
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
    configs/large_1b_single_chip.yaml`` at its full width and 2 of its 36
    layers, the rest of its model and training sections unchanged (hidden
    1280, 20 heads of 64, vocab 50257, batch 4 x 1024, full remat, bf16
    Adam moments, dropout 0.1) on
    the cli phase's corpus: 6 steps with a save at step 3, then the same
    command again resumes from step 3, and step 6's state and
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
    large = _cut_yaml(tmp, "large_1b_single_chip.yaml", "l2", num_layers=2)
    argv = ["--config", large, "--dataset", "tinystories", "--data_path",
            corpus, "--tokenizer", "byte", "--log_interval", "1",
            "--eval_batches", "1", "--eval_interval", "0",
            "--max_steps", "6", "--save_interval", "3", "--keep_last_n", "0",
            "--checkpoint_dir", os.path.join(tmp, "r"),
            "--metrics_jsonl", os.path.join(tmp, "r.jsonl")]
    cfg, tc, _, _ = cli.resolve_configs(cli.build_parser().parse_args(argv))
    if not (cfg.gradient_checkpointing and cfg.remat_policy == "full"
            and tc.optimizer_state_dtype == "bfloat16"
            and cfg.num_layers == 2 and cfg.hidden_size == 1280):
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
                   f"with its restore)")

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
    and 2 of its 24 layers (hidden 1024, 16 heads, batch 8 x 4 x 1024,
    FULL_SHARD at
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
    medium = _cut_yaml(tmp, "medium_model.yaml", "l2", num_layers=2)
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
        if not (cfg.gradient_checkpointing and cfg.num_layers == 2
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
    --gradient_checkpointing`` at 2 of its 12 layers, 2 steps: gmm 9 a
    layer a micro-batch (3 forward, 3 recompute, 3 dgrad), tgmm 3, the
    flash forward twice."""
    from tpu_trainer_torch.training import cli

    argv = ["--config", _cut_yaml(tmp, "moe_small.yaml", "l2", num_layers=2),
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
    log("moe-remat", f"moe_small.yaml at 2 layers, dropless under full "
                     f"remat, 2 steps + 1 "
                     f"eval batch in {run['seconds']:.1f} s: losses "
                     + " ".join(f"{x:.4f}" for x in losses)
                     + f"; launches {rec['launches']} as the path must make "
                       f"them")
    results["moe_remat"] = rec
    return rec


# -- phase 21: the capacity router ------------------------------------------

# The two dispatches of one capacity trainer (bench.py --moe's capacity
# lane, top-2) on the same weights and batches: expert inputs and expert
# outputs are bitwise the same, but the top-2 combine rounds each gated
# row to bf16 before adding on the gather path and adds in f32 inside one
# product on the einsum path. So step 0's losses agree to bf16's unit
# roundoff, and the trajectories drift from there (skewed stream, lr
# warm-up): steps 1-9 within 2^-5 relative.
MOE_DISPATCH_LOSS_RTOL = (2.0**-8, 2.0**-5)


def _capacity_plain(gate_idx, capacity: int):
    """Queue positions and keep mask of ``gate_idx [T, k]`` (host ints) by
    a plain loop: each expert's queue filled in choice-major order (every
    token's first choice, then every second choice), a place kept below
    ``capacity``."""
    import numpy as np

    T, k = gate_idx.shape
    pos = np.zeros((T, k), np.int64)
    fill = {}
    for j in range(k):
        for t in range(T):
            e = int(gate_idx[t, j])
            pos[t, j] = fill.get(e, 0)
            fill[e] = pos[t, j] + 1
    return pos, pos < capacity


def _record_positions(out: list, limit: int):
    """Wrap ``models/moe.capacity_positions`` to keep the routing
    (``gate_idx``), positions and keep mask of its first ``limit`` calls
    in ``out``; returns the function that restores it."""
    from tpu_trainer_torch.models import moe

    original = moe.capacity_positions

    def recording(gate_idx, counts, rank, slots, *layout):
        pos, keep = original(gate_idx, counts, rank, slots, *layout)
        if len(out) < limit:
            out.append({"gate_idx": gate_idx.cpu().numpy(),
                        "pos": pos.cpu().numpy(), "keep": keep.cpu().numpy(),
                        "capacity": slots})
        return pos, keep

    moe.capacity_positions = recording

    def restore():
        moe.capacity_positions = original
    return restore


def _check_positions(what: str, calls: list) -> int:
    """Every recorded call's positions and keep mask bitwise the plain
    loop's on its own routing; returns the token-choices compared."""
    import numpy as np

    n = 0
    for i, c in enumerate(calls):
        pos, keep = _capacity_plain(c["gate_idx"], c["capacity"])
        if not (np.array_equal(pos, c["pos"])
                and np.array_equal(keep, c["keep"])):
            raise AssertionError(
                f"{what}: call {i}: queue positions differ from the plain "
                f"loop's in {int((pos != c['pos']).sum())} of {pos.size} "
                f"token-choices")
        n += pos.size
    return n


def _capacity_layer(cfg, x, weights, dout, dispatch: str, dtype: str):
    """One capacity layer forward and backward: ``(out, dx, d_router,
    d_gate, d_up, d_down)`` at ``dispatch`` computing in ``dtype`` (the
    weights stay f32 masters, cast inside as the model casts them)."""
    import dataclasses

    from tpu_trainer_torch.models import moe

    c = dataclasses.replace(cfg, moe_dispatch=dispatch, dtype=dtype)
    xx = x.detach().to(c.compute_dtype, copy=True).requires_grad_(True)
    ws = [w.clone().requires_grad_(True) for w in weights]
    out, aux = moe.capacity_moe(xx, *ws, c)
    torch.autograd.backward([out, aux], [dout.to(out.dtype),
                                         torch.ones_like(aux)])
    return (out.detach(), xx.grad) + tuple(w.grad for w in ws)


def _capacity_layer_checks(failures: list, k: int) -> dict:
    """One capacity layer at moe_small's width (T = 8 x 1024, H = 768, I =
    3072, E = 8; ``k`` 1 at capacity factor 1.25 as the yaml, 2 as bench
    --moe's lane) on inputs that pile onto a few experts: gather and
    einsum in f32 agree (F32_TOL); the bf16 gather layer's output and
    every gradient against the f32 einsum layer (the truth) next to the
    bf16 einsum layer's (``_near_truth``); the bf16 gather backward twice
    bitwise; the queue positions bitwise the plain loop's. Times the bf16
    forward + backward of each dispatch (CUDA events)."""
    from tpu_trainer_torch.models.config import GPTConfig

    cfg = GPTConfig.gpt2_small(num_experts=8, moe_top_k=k,
                               expert_capacity_factor=1.25,
                               router_z_weight=1e-3 if k == 2 else 0.0,
                               dropout=0.0, attention_dropout=0.0)
    gen = torch.Generator(device="cuda").manual_seed(40 + k)
    H, I, E = 768, 3072, 8
    lean = torch.randn(H, generator=gen, device="cuda")
    x = (torch.randn(8, 1024, H, generator=gen, device="cuda")
         + 0.7 * lean).to(torch.bfloat16).float()
    weights = [torch.randn(H, E, generator=gen, device="cuda") * 0.05,
               torch.randn(E, H, I, generator=gen, device="cuda") * 0.02,
               torch.randn(E, H, I, generator=gen, device="cuda") * 0.02,
               torch.randn(E, I, H, generator=gen, device="cuda") * 0.02]
    dout = torch.randn(8, 1024, H, generator=gen, device="cuda")
    names = ("out", "dx", "d_router", "d_gate", "d_up", "d_down")
    calls = []
    restore = _record_positions(calls, 1)
    try:
        truth = _capacity_layer(cfg, x, weights, dout, "einsum", "float32")
    finally:
        restore()
    f32 = _capacity_layer(cfg, x, weights, dout, "gather", "float32")
    plain = _capacity_layer(cfg, x, weights, dout, "einsum", "bfloat16")
    got = _capacity_layer(cfg, x, weights, dout, "gather", "bfloat16")
    rec = {"k": k, "capacity": calls[0]["capacity"],
           "drop_frac": float(1.0 - calls[0]["keep"].mean()),
           "f32_gather_vs_einsum": {}, "near": {}}
    for n, a, b in zip(names, f32, truth):
        rec["f32_gather_vs_einsum"][n] = _close(
            f"moe-capacity k={k}: f32 gather vs einsum {n}", a, b)
    for n, g, p, t in zip(names, got, plain, truth):
        try:
            rec["near"][n] = _near_truth(
                f"moe-capacity k={k}: bf16 gather {n}", g, p, t)
        except AssertionError as e:
            failures.append(str(e))
    rec["bitwise_elements"] = _bitwise_twice(
        f"moe-capacity k={k}: bf16 gather backward",
        lambda: _capacity_layer(cfg, x, weights, dout, "gather", "bfloat16"))
    rec["positions_compared"] = _check_positions(
        f"moe-capacity k={k}", calls)
    for dispatch in ("gather", "einsum"):
        rec[f"{dispatch}_ms"] = event_ms(
            lambda i: _capacity_layer(cfg, x, weights, dout, dispatch,
                                      "bfloat16"), 3)
    rec["checks"] = (cfg, x, weights, dout, truth, plain, calls)
    return rec


def _plant_inclusive_cumsum():
    """A planted fault: every queue position one higher (an inclusive
    cumsum where the exclusive one belongs)."""
    from tpu_trainer_torch.models import moe

    original = moe.capacity_positions

    def inclusive(gate_idx, counts, rank, slots, *layout):
        pos, _ = original(gate_idx, counts, rank, slots, *layout)
        return pos + 1, pos + 1 < slots

    moe.capacity_positions = inclusive
    return lambda: setattr(moe, "capacity_positions", original)


def _plant_unscaled_combine():
    """A planted fault: the gather combine's backward without the gate
    scale."""
    from tpu_trainer_torch.models import moe

    original = moe._CombineRows.backward

    def unscaled(ctx, dout):
        eo, gates, flat_ids, slot_tc = ctx.saved_tensors
        k, H = flat_ids.shape[1], eo.shape[1]
        d_eo = torch.cat([dout] * k + [dout.new_zeros(1, H)])[slot_tc]
        eo_pad = torch.cat([eo, eo.new_zeros(1, H)])
        d_gates = torch.stack(
            [(eo_pad[flat_ids[:, j]] * dout).float().sum(dim=-1)
             for j in range(k)], dim=1).to(gates.dtype)
        return d_eo, d_gates, None, None

    moe._CombineRows.backward = staticmethod(unscaled)
    return lambda: setattr(moe._CombineRows, "backward",
                           staticmethod(original))


def phase_moe_capacity(results: dict, tmp: str) -> dict:
    """The capacity router (``moe_impl="capacity"``, the JAX default), in
    the cli phase's temporary directory (its corpus):

    (a) ``configs/moe_small.yaml`` (8 experts, top-1, capacity factor
        1.25, gather dispatch; cut to 2 of its 12 layers, for its
        checkpoints' writes and the run's time)
        through ``train_ddp`` with the byte tokenizer, 3 steps with a save
        at step 2 and a telemetry step at step 3; step 3's checkpoint set
        aside and the same argv again,
        which resumes from step 2 and must end bitwise;
        launches exact (no grouped matmul); windowed tok/s, MFU on the
        active parameters, and the telemetry step's per-layer drop_frac;
    (b) bench.py --moe's capacity lane (GPT-2 small's width at 6 of its
        12 layers, 8 experts, top-2, z-loss 1e-3, einsum dispatch; batch
        8 x 1024, dropout 0.1) and
        the same model with gather dispatch, each 10 steps on bench's
        skewed stream and two profiled steps: step ms, busy share,
        launches, top device kernels; losses within
        ``MOE_DISPATCH_LOSS_RTOL``; step 0's layer-0 keep masks bitwise
        each other's and every recorded call's positions bitwise the
        plain loop's (``_capacity_plain``);
    (c) one capacity layer in bf16 against the f32 layer
        (``_capacity_layer_checks``, top-1 and top-2);
    (d) a ``ServingEngine`` over a moe_small-width model (``init_params``
        seed 0, bf16, max batch 8, block 16) on the engine phase's trace:
        flash_decode launches == decode iterations x 12, logits finite,
        the live decode step's kernel against plain attention; tok/s,
        TTFT and TPOT;
    (e) ``infer.main`` greedy on (a)'s checkpoint twice: tokens bitwise;
    (f) planted faults, each of which the checks must reject: positions
        from an inclusive cumsum, a combine backward without the gate
        scale."""
    import dataclasses

    import numpy as np

    from tpu_trainer_torch.eval import infer
    from tpu_trainer_torch.models import moe
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.serving.engine import ServingEngine
    from tpu_trainer_torch.training import cli

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    rec = {"nvidia_smi": card}
    secs = {}

    # (a) moe_small.yaml through the CLI, at 2 of its 12 layers.
    t0 = time.perf_counter()
    ckdir = os.path.join(tmp, "mc")
    jsonl = os.path.join(tmp, "mc.jsonl")
    argv = ["--config", _cut_yaml(tmp, "moe_small.yaml", "l2", num_layers=2),
            "--dataset", "tinystories", "--data_path",
            os.path.join(tmp, "stories.txt"), "--tokenizer", "byte",
            "--max_steps", "3", "--save_interval", "2",
            "--telemetry_interval", "3", "--eval_batches", "1",
            "--keep_last_n", "0", "--log_interval", "1",
            "--checkpoint_dir", ckdir, "--metrics_jsonl", jsonl]
    cfg, tc, _, _ = cli.resolve_configs(cli.build_parser().parse_args(argv))
    if (cfg.moe_impl, moe.dispatch_mode(cfg), cfg.num_experts,
            cfg.moe_top_k) != ("capacity", "gather", 8, 1):
        raise AssertionError(f"moe-capacity: moe_small.yaml resolves to "
                             f"{moe.describe(cfg)}")
    res = _resume_check("moe-capacity", argv, tmp, 3, 2)
    accum = tc.gradient_accumulation_steps
    n_eval = res["evals"][-1]["eval_batches"]
    want = _micro_launches(cfg, accum, n_eval * accum, segmented=False)
    if res["run2"]["launches"] != want:
        raise AssertionError(f"moe-capacity: run 2 launches "
                             f"{res['run2']['launches']}, want {want}")
    train = res["train"][:3]
    tel = train[2]
    drops = [tel[f"telemetry/router/drop_frac/L{i:02d}"]
             for i in range(cfg.num_layers)]
    loads = [tel[f"telemetry/router/load/L{i:02d}/max"]
             for i in range(cfg.num_layers)]
    tokens = tc.batch_size * tc.max_seq_len
    slots = moe.capacity(cfg, tokens)
    cli_rec = {
        "losses": [r["loss"] for r in train],
        "tokens_per_sec": [r["tokens_per_sec"] for r in train],
        "mfu": [r["mfu"] for r in train],
        # The second step is the steady one: the first warms the
        # allocator and cuBLAS, the third runs under the second's
        # checkpoint commit.
        "tokens_per_sec_step2": train[1]["tokens_per_sec"],
        "mfu_step2": train[1]["mfu"],
        "drop_frac_step3": drops, "load_max_step3": loads,
        "capacity": slots, "state_arrays_bitwise": res["state_arrays"],
        "run1_s": res["run1"]["seconds"], "run2_s": res["run2_s"],
        "run2_launches": {k: v for k, v in res["run2"]["launches"].items()
                          if v}}
    rec["cli"] = cli_rec
    log("moe-capacity", f"moe_small.yaml at {cfg.num_layers} layers "
                        f"({moe.describe(cfg)}), "
                        f"batch {accum} x {tc.batch_size} x "
                        f"{tc.max_seq_len}: losses "
        + " ".join(f"{x:.4f}" for x in cli_rec["losses"])
        + f"; resumed at step 2, {res['state_arrays']} "
          f"state arrays of step 3 and its loss bitwise; run 2 launches "
          f"{cli_rec['run2_launches']}")
    log("moe-capacity", f"tok/s of step 2 (the JSONL window; step 3 runs "
                        f"under step 2's checkpoint commit) "
                        f"{cli_rec['tokens_per_sec_step2']:.0f}, MFU on "
                        f"active parameters {cli_rec['mfu_step2']:.4f}; "
                        f"steps 1-3 "
                        + " ".join(f"{x:.0f}"
                                   for x in cli_rec["tokens_per_sec"])
                        + f" tok/s on {card}")
    log("moe-capacity", "telemetry step 3, drop_frac by layer: "
        + " ".join(f"{d:.4f}" for d in drops))
    if max(drops) <= 0.0:
        log("moe-capacity", f"no drop at step 3: the busiest expert took "
                            f"{max(loads):.4f} of a micro-batch's "
                            f"{tokens} first choices, under the capacity "
                            f"{slots} = {slots / tokens:.4f} of them")
    secs["cli"] = time.perf_counter() - t0

    # (e) infer.py on (a)'s checkpoint, greedy, twice.
    t0 = time.perf_counter()
    prompts = os.path.join(tmp, "mc_prompts.txt")
    with open(os.path.join(tmp, "stories.txt")) as f:
        stories = [next(f) for _ in range(4)]
    with open(prompts, "w") as f:
        for i, s in enumerate(stories):
            f.write(" ".join(s.split()[:3 + 4 * i]) + "\n")
    runs = []
    for _ in range(2):
        out = {}
        if infer.main(["--checkpoint", ckdir, "--prompt_file", prompts,
                       "--tokenizer", "byte", "--temperature", "0",
                       "--max_new_tokens", "32"], result=out) != 0:
            raise AssertionError("moe-capacity: infer exited non-zero")
        runs.append(out["tokens"])
    if runs[0] != runs[1] or any(len(r) < 33 for r in runs[0]):
        raise AssertionError("moe-capacity: infer's greedy tokens differ "
                             "between two runs")
    shutil.rmtree(ckdir)
    rec["infer"] = {"rows": len(runs[0]),
                    "lengths": [len(r) for r in runs[0]]}
    secs["infer"] = time.perf_counter() - t0
    log("moe-capacity", f"infer.py on step 3's checkpoint, 4 ragged prompts "
                        f"x 32 greedy tokens, twice: bitwise "
                        f"({secs['infer']:.1f} s)")
    torch.cuda.empty_cache()

    # (b) bench.py --moe's capacity lane, einsum and gather.
    t0 = time.perf_counter()
    steps = 10
    lane = dataclasses.replace(_small_config(
        num_experts=8, moe_top_k=2, moe_impl="capacity",
        moe_dispatch="einsum", router_z_weight=1e-3), num_layers=6)
    rng = np.random.default_rng(23)
    host = [rng.integers(0, 4, (8, 1024), dtype=np.int32)
            for _ in range(steps + 2)]
    lanes, step0 = {}, {}
    for dispatch in ("einsum", "gather"):
        trainer, state = _trainer(dataclasses.replace(
            lane, moe_dispatch=dispatch))
        batches = [trainer.put_batch(b) for b in host]
        calls = []
        restore = _record_positions(calls, lane.num_layers)
        try:
            lanes[dispatch] = _train_steps(
                f"moe-capacity/{dispatch}", trainer, state, batches, steps,
                segmented=False)
        finally:
            restore()
        step0[dispatch] = calls
        lanes[dispatch]["drop_frac_step1"] = [
            float(1.0 - c["keep"].mean()) for c in calls]
        lanes[dispatch]["positions_compared"] = _check_positions(
            f"moe-capacity/{dispatch}", calls)
        log(f"moe-capacity/{dispatch}", "step 1 drop_frac by layer: "
            + " ".join(f"{d:.4f}" for d in lanes[dispatch]["drop_frac_step1"])
            + f"; {lanes[dispatch]['positions_compared']} token-choices' "
              f"positions bitwise the plain loop's")
        del trainer, state, batches
        torch.cuda.empty_cache()
    if not np.array_equal(step0["einsum"][0]["keep"],
                          step0["gather"][0]["keep"]):
        raise AssertionError("moe-capacity: step 1's layer-0 keep masks "
                             "differ between the dispatches")
    worst = [0.0, 0.0]
    for i, (a, b) in enumerate(zip(lanes["einsum"]["losses"],
                                   lanes["gather"]["losses"])):
        rel = abs(a - b) / abs(a)
        worst[i > 0] = max(worst[i > 0], rel)
        if rel > MOE_DISPATCH_LOSS_RTOL[i > 0]:
            raise AssertionError(
                f"moe-capacity: step {i + 1} loss einsum {a} vs gather {b} "
                f"(rel {rel:.2e} > {MOE_DISPATCH_LOSS_RTOL[i > 0]:.1e})")
    rec["bench"] = {k: {kk: vv for kk, vv in v.items()}
                    for k, v in lanes.items()}
    rec["bench"]["loss_worst_rel"] = worst
    secs["bench"] = time.perf_counter() - t0
    log("moe-capacity", f"einsum vs gather losses: step 1 within "
                        f"{worst[0]:.2e}, steps 2-10 within {worst[1]:.2e} "
                        f"(bounds {MOE_DISPATCH_LOSS_RTOL[0]:.1e} / "
                        f"{MOE_DISPATCH_LOSS_RTOL[1]:.1e}); step 1's layer-0 "
                        f"keep masks bitwise; step ms einsum "
                        f"{lanes['einsum']['step_ms_median_3_to_10']:.2f}, "
                        f"gather "
                        f"{lanes['gather']['step_ms_median_3_to_10']:.2f} "
                        f"on {card}")

    # (c) and (f): one layer against the f32 layer, and planted faults.
    t0 = time.perf_counter()
    failures = []
    layer = {}
    for k in (1, 2):
        layer[k] = _capacity_layer_checks(failures, k)
    if failures:
        raise AssertionError("moe-capacity: " + "; ".join(failures))
    cfg2, x2, w2, dout2, truth2, plain2, _ = layer[2].pop("checks")
    layer[1].pop("checks")

    def planted_positions():
        calls = []
        restore = _record_positions(calls, 1)
        try:
            _capacity_layer(cfg2, x2, w2, dout2, "gather", "bfloat16")
        finally:
            restore()
        _check_positions("planted", calls)

    def planted_combine():
        got = _capacity_layer(cfg2, x2, w2, dout2, "gather", "bfloat16")
        for n, g, p, t in zip(("out", "dx", "d_router", "d_gate", "d_up",
                               "d_down"), got, plain2, truth2):
            _near_truth(f"planted {n}", g, p, t)

    for what, plant, check in (
            ("positions from an inclusive cumsum", _plant_inclusive_cumsum,
             planted_positions),
            ("a combine backward without the gate scale",
             _plant_unscaled_combine, planted_combine)):
        undo = plant()
        try:
            _must_reject(f"moe-capacity: {what}", check)
        finally:
            undo()
    for k, r in layer.items():
        worst_n = max(r["near"], key=lambda n: r["near"][n]["l2"]["kernel"]
                      / max(r["near"][n]["l2"]["limit"], 1e-30))
        log("moe-capacity", f"layer k={k} (C {r['capacity']}, drop_frac "
                            f"{r['drop_frac']:.4f}): f32 gather vs einsum "
                            f"max |err| "
                            f"{max(r['f32_gather_vs_einsum'].values()):.2e}; "
                            f"bf16 gather vs f32 next to bf16 einsum: worst "
                            f"{worst_n} l2 "
                            f"{r['near'][worst_n]['l2']['kernel']:.3e} (limit "
                            f"{r['near'][worst_n]['l2']['limit']:.3e}); "
                            f"backward bitwise twice ({r['bitwise_elements']} "
                            f"elements); fwd+bwd ms gather "
                            f"{r['gather_ms']:.3f}, einsum "
                            f"{r['einsum_ms']:.3f}")
    log("moe-capacity", "planted faults rejected: an inclusive cumsum's "
                        "positions, a combine backward without the gate "
                        "scale")
    rec["layer"] = layer
    secs["layer"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # (d) the paged engine over a moe_small-width model.
    t0 = time.perf_counter()
    ecfg = dataclasses.replace(cfg, dropout=0.0, attention_dropout=0.0,
                               dtype="bfloat16", param_dtype="float32")
    engine = ServingEngine(init_params(ecfg, seed=0, device="cuda"), ecfg,
                           max_batch=8, block_size=16, device="cuda")
    vocab = ecfg.vocab_size
    engine.run(_trace(3, seed=99, prompt_len_range=(64, 128),
                      max_new_range=(4, 8), vocab=vocab), time_mode="wall")
    engine.reset_stats()
    reqs = _trace(24, seed=1, prompt_len_range=(64, 512),
                  max_new_range=(16, 64), vocab=vocab)
    done, summ, launches, err, live_len = _serve(
        "moe-capacity/engine", engine, reqs,
        capture_call=7 * ecfg.num_layers + 1)
    lat = _latency(done, summ)
    rec["engine"] = {"launches": launches,
                     "decode_iters": summ["decode_iters"],
                     "prefill_iters": summ["prefill_iters"],
                     "generated_tokens": summ["generated_tokens"],
                     "live_step_max_abs_err": err, **lat}
    del engine
    torch.cuda.empty_cache()
    secs["engine"] = time.perf_counter() - t0
    log("moe-capacity/engine", f"{len(done)}/{len(reqs)} requests, "
                               f"{summ['decode_iters']} decode + "
                               f"{summ['prefill_iters']} prefill iters; "
                               f"flash_decode launches {launches} == "
                               f"decode_iters x {ecfg.num_layers}; logits "
                               f"finite; live decode step kernel vs plain "
                               f"max|err| {err:.2e}")
    log("moe-capacity/engine", f"{lat['tokens_per_s']:.1f} tok/s; TTFT p50 "
                               f"{lat['ttft_p50_ms']:.2f} ms p99 "
                               f"{lat['ttft_p99_ms']:.2f} ms; TPOT p50 "
                               f"{lat['tpot_p50_ms']:.2f} ms p99 "
                               f"{lat['tpot_p99_ms']:.2f} ms on {card}")

    rec["launches"] = {
        k: res["run2"]["launches"].get(k, 0) + res["run1"]["launches"].get(
            k, 0) + sum(v["launches"].get(k, 0) for v in lanes.values())
        for k in _counters()}
    rec["phase_seconds"] = secs
    rec["seconds"] = time.perf_counter() - t_phase
    log("moe-capacity", f"phase {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    results["moe_capacity"] = rec
    return rec


# -- phase 22: fault tolerance and the run's telemetry -----------------------

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
      each restart's time to its first step, split (the chain runs on a
      thread beside the rollback, notice, MoE and nan_scan sections);
    - ``nan_loss@6`` (at 2 of the 12 layers): one rollback record, exit
      0, ``crash_report.json`` holding the ring of records;
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
    - ``moe_small.yaml --moe_impl dropless`` (2 layers) 2 telemetry
      steps: each
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
    # The chain's processes run one after another on a thread while this
    # process runs the sections that time nothing (the rollback, the
    # notice, the MoE telemetry, nan_scan); the telemetry and remat
    # sections, which time steps, run after the chain has ended.
    ck = os.path.join(tmp, "ft_k")

    def kill_chain() -> dict:
        t0 = time.perf_counter()
        chain = [("p1", ["--inject_fault", "kill_in_save@4"], None),
                 ("p2", ["--inject_fault", "kill@5",
                         "--no_async_checkpointing"], 2),
                 ("p3", ["--inject_fault", "truncate_meta@6,kill@6",
                         "--no_async_checkpointing"], 4),
                 ("p4", [], 4)]
        children = {}
        for tag, extra, resumes in chain:
            argv = base + ["--save_interval", "2", "--checkpoint_dir", ck,
                           "--metrics_jsonl",
                           os.path.join(tmp, f"ft_{tag}.jsonl"),
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
                raise AssertionError("ft: truncate_meta@6 left meta.json "
                                     "whole")
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
        shutil.rmtree(ck)
        return {"children": children, "arrays": n_arrays, "want": want,
                "seconds": time.perf_counter() - t0}

    join_chain = _background(kill_chain)
    last[0] = time.perf_counter()

    try:
        # -- a NaN rolls back ------------------------------------------------
        calls = {"n": 0}
        original = Trainer.train_step

        def counted(self, state, batch, *args, **kwargs):
            calls["n"] += 1
            return original(self, state, batch, *args, **kwargs)

        # At 2 of the 12 layers: nothing here is held to the straight run.
        nan_base = list(base)
        nan_base[1] = _cut_yaml(tmp, "small_model.yaml", "ftnan",
                                num_layers=2)
        nan_cfg = cli.resolve_configs(
            cli.build_parser().parse_args(nan_base))[0]
        Trainer.train_step = counted
        try:
            run = _cli_in_process("ft", nan_base + [
                "--save_interval", "2", "--guard_interval", "1",
                "--inject_fault", "nan_loss@6",
                "--flight_recorder_steps", "64",
                *ft_dir("nan")])
        finally:
            Trainer.train_step = original
        rollbacks = _jsonl(os.path.join(tmp, "ft_nan.jsonl"), "rollback")
        report = json.load(open(os.path.join(tmp, "ft_nan",
                                             "crash_report.json")))
        n_eval = _jsonl(os.path.join(tmp, "ft_nan.jsonl"), "eval")[-1][
            "eval_batches"]
        want = _micro_launches(nan_cfg, calls["n"] * accum, n_eval * accum,
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
        log("ft", f"nan_loss@6: one rollback to step 6, {calls['n']} steps "
                  f"run, exit 0; crash_report.json holds "
                  f"{len(report['records'])} records ending in the rollback" + lap("nan_rollback"))

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
            raise AssertionError(f"ft: drained run launches "
                                 f"{run['launches']}, want {want}")
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
            raise AssertionError(f"ft: resumed run launches "
                                 f"{run['launches']}, want {want}")
        _add_launches(ft_launches, run["launches"])
        _state_equal("ft", os.path.join(pre, "step_00000008"), straight)
        if losses("pre") != ref:
            raise AssertionError(f"ft: drained + resumed losses "
                                 f"{losses('pre')}")
        shutil.rmtree(pre)
        log("ft", "preemption notice at launch: drained after step 1, exit "
                  "143 with a complete step-1 checkpoint; resumed to step 8 "
                  "bitwise" + lap("notice"))

        # -- MoE router telemetry ---------------------------------------------
        router = []

        def keep_router(self, state, batch, *args, **kwargs):
            state, m = original(self, state, batch, *args, **kwargs)
            if "telemetry" in m:
                router.append({k: v.detach().float().cpu()
                               for k, v in m["telemetry"]["router"].items()})
            return state, m

        moe_argv = ["--config", _cut_yaml(tmp, "moe_small.yaml", "l2",
                                          num_layers=2),
                    "--moe_impl", "dropless", "--max_steps", "2",
                    "--telemetry_interval", "1", "--log_interval", "1",
                    "--eval_batches", "1", "--no_auto_resume", *ft_dir("moe")]
        Trainer.train_step = keep_router
        try:
            run = _cli_in_process("ft", moe_argv)
        finally:
            Trainer.train_step = original
        moe_cfg = cli.resolve_configs(
            cli.build_parser().parse_args(moe_argv))[0]
        want = _micro_launches(moe_cfg, 2 * accum, accum, segmented=False)
        sums = torch.stack([r["load"].sum(dim=-1) for r in router])
        if (run["launches"] != want or len(router) != 2
                or (sums - 1.0).abs().max() > 1e-6
                or any(r["drop_frac"].abs().max() != 0 for r in router)
                or any((r["dropless"] != 1).any() for r in router)
                or router[0]["load"].shape != (moe_cfg.num_layers,
                                               moe_cfg.num_experts)):
            raise AssertionError(f"ft: MoE telemetry launches "
                                 f"{run['launches']} want {want}, load sums "
                                 f"{sums}")
        _add_launches(ft_launches, run["launches"])
        shutil.rmtree(os.path.join(tmp, "ft_moe"), ignore_errors=True)
        rec["moe"] = {"load_sum_max_err": float((sums - 1.0).abs().max()),
                      "max_group_frac": [float(r["max_group_frac"].max())
                                         for r in router]}
        log("ft", f"MoE telemetry, 2 steps: load fractions sum to 1 within "
                  f"{rec['moe']['load_sum_max_err']:.1e} on every layer, "
                  f"drop_frac 0; launches {want['gmm']} gmm, "
                  f"{want['tgmm']} tgmm" + lap("moe"))

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
                    "--nan_scan", "--resume_from", path,
                    *ft_dir(f"scan_{tag}")])
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
        log("ft", f"--nan_scan: the planted inf found at layer 5, site attn; "
                  f"the clean checkpoint has none; one forward a layer; "
                  f"{timer['s'][0]:.3f} / {timer['s'][1]:.3f} s on {card}"
            + lap("nan_scan"))
    except BaseException:
        # The chain's process ends before this phase fails.
        try:
            join_chain()
        except BaseException:
            pass
        raise

    # -- the chain's end -------------------------------------------------
    chain = join_chain()
    children = chain["children"]
    _add_launches(ft_launches, children["p4"]["launches"])
    rec["section_s"]["kills"] = chain["seconds"]
    rec["restart"] = {tag: _restart_split(children[tag], os.path.join(
        tmp, f"ft_{tag}.jsonl")) for tag in ("p2", "p3", "p4")}
    log("ft", f"kill_in_save@4 -> 137, kill@5 -> 137 (resumed at 2), "
              f"truncate_meta@6 -> skipped (resumed at 4 twice): the losses "
              f"of steps 1-8 and {chain['arrays']} step-8 state arrays "
              f"bitwise the straight run's; the last run's launches "
              f"{ {k: v for k, v in chain['want'].items() if v} } "
              f"[{chain['seconds']:.1f} s, beside the sections above]")
    for tag, sp in rec["restart"].items():
        log("ft", f"restart {tag}: spawn to first step {sp['total_s']:.2f} s"
                  f" = interpreter {sp['interpreter_s']:.2f} + imports "
                  f"(torch {sp['torch_import_s']:.2f}, the port "
                  f"{sp['port_import_s']:.2f}) + CUDA init "
                  f"{sp['cuda_init_s']:.2f}"
                  f" + kernel load {sp['kernel_load_s']:.3f} + restore "
                  f"{sp['restore_s']:.2f} + first step "
                  f"{sp['first_step_s']:.2f} + other {sp['other_s']:.2f} on "
                  f"{card} (beside this process's runs)")
    last[0] = time.perf_counter()

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

    gp = [g for g in _jsonl(os.path.join(tmp, "a.jsonl"), "goodput")
          if g.get("final")][0]
    rec["cli_goodput"] = gp
    log("ft", "the cli phase's straight run, goodput: " + ", ".join(
        f"{k[:-5]} {gp[k]:.3f}" for k in sorted(gp) if k.endswith("_frac"))
        + f" of {gp['total_seconds']:.2f} s on {card}")
    rec["launches"] = ft_launches
    results["ft"] = rec
    return rec


def _plant_nan(layer: int, row: int) -> None:
    """Make every training forward of this process put a NaN into row
    ``row`` of layer ``layer``'s input (a non-finite activation in those
    rows only)."""
    from tpu_trainer_torch.models.gpt import GPT

    block = GPT._train_block

    def planted(self, x, p, step):
        n = getattr(self, "_planted_calls", 0)
        self._planted_calls = n + 1
        if n % self.config.num_layers == layer:
            x = x.clone()
            x[row, 0, 0] = float("nan")
        return block(self, x, p, step)
    GPT._train_block = planted


def _state_digests(state) -> dict:
    """This rank's slices of every checkpoint array, by key: ``[(starts,
    shape, dtype, sha256)]`` (what a two-phase save would write)."""
    import hashlib

    import numpy as np

    out = {}
    for rec in state.shard_records():
        out[rec["key"]] = [
            (list(starts), list(arr.shape), str(arr.dtype),
             hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest())
            for starts, arr in rec["shards"]]
    return out


def _dist_child(mode: str, argv: list, out: str, fault_rank=None,
                group=None, offsets_fault_rank=None, extra=None) -> None:
    """One rank (or the one process) of the dist phase, in a fresh process:
    ``group`` (``(backend, file store, rank, world)``, else none) joined
    first, as a launcher would (the CLI keeps a group that exists), launch
    counts zeroed, ``train_<mode>.main(argv)``; each
    ``Trainer.init_state`` / restore is measured at rest (the bytes of the
    masters and moments, ``torch.cuda.memory_allocated()``), each
    ``Trainer.train_step`` timed up to a synchronize. ``fault_rank``
    plants a fault: that rank's gradient shard scaled by 1.5 before the
    update of step 1. The first capacity-MoE layer call's routing, queue
    positions and keep mask (layer 0 of step 1) are kept;
    ``offsets_fault_rank`` plants a fault: that rank's queue positions
    ignore the earlier ranks' tokens. ``extra`` (world-rest, elastic and
    expert phases): ``argv`` appended to this rank's flags, ``plant``
    (``[layer, row]``: ``_plant_nan``), ``digests`` (the saves write
    nothing: each records the state's ``_state_digests``), ``moe_calls``
    (the capacity layer calls whose drop fraction is kept, the first
    step's layers; default 1); every telemetry record and ``nan_scan``
    report of this rank is kept, and each step's ``collectives.calls``
    (and under a stage axis its ``Trainer.pipeline_stats``: bytes sent, the
    seconds waited on receives, the most microbatches in flight);
    ``window_delta`` plants a fault: the pipeline's simulated window
    changed by that much. Written to ``out`` (a rank's own file)."""
    extra = extra or {}
    argv = list(argv) + list(extra.get("argv", []))
    if extra.get("plant"):
        _plant_nan(*extra["plant"])
    from tpu_trainer_torch.parallel import pipeline as pipeline_lib

    if extra.get("window_delta"):
        # A planted fault: the 1F1B window off the JAX simulation's.
        sim = pipeline_lib.window
        pipeline_lib.window = (lambda *a, d=extra["window_delta"]:
                               sim(*a) + d)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import importlib

    from tpu_trainer_torch.parallel import mesh as mesh_lib
    from tpu_trainer_torch.training.trainer import Trainer
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    entry = importlib.import_module(f"tpu_trainer_torch.training.train_{mode}")
    if group is not None:
        backend, store, rank, world = group
        mesh_lib.initialize_distributed(
            num_processes=world, process_id=rank, backend=backend,
            init_method=f"file://{store}", device="cuda")
    seen = {"step_ms": [], "rest": [], "telemetry": [], "nan": [],
            "digests": [], "step_calls": [], "pipeline": []}

    def at_rest(state):
        torch.cuda.synchronize()
        moments = [t for m in list(state.opt_state.mu.values())
                   + list(state.opt_state.nu.values())
                   for t in (m.tensors() if hasattr(m, "tensors") else (m,))]
        trees = {"params": state.params.values(), "moments": moments,
                 "experts": [t for n, t in state.params.items()
                             if "experts_" in n]}
        seen["rest"].append({k: sum(t.numel() * t.element_size() for t in v)
                             for k, v in trees.items()})
        seen["rest"][-1]["host"] = sum(t.numel() * t.element_size()
                                       for t in moments if not t.is_cuda)
        seen["rest"][-1]["allocated"] = torch.cuda.memory_allocated()
        return state

    init, restore = Trainer.init_state, ckpt_lib.restore_checkpoint
    step = Trainer.train_step

    def timed(self, state, batch, *args, **kwargs):
        if fault_rank == self.process_index and state.step == 1:
            apply = self.optimizer.apply

            def scaled(grads, *a, **k):
                return apply({n: g * 1.5 for n, g in grads.items()}, *a, **k)
            self.optimizer.apply = scaled
        from tpu_trainer_torch.parallel import collectives

        before = dict(collectives.calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = step(self, state, batch, *args, **kwargs)
        torch.cuda.synchronize()
        seen["step_ms"].append(1e3 * (time.perf_counter() - t0))
        seen["step_calls"].append({
            k: v - before.get(k, 0) for k, v in collectives.calls.items()
            if v != before.get(k, 0)})
        if self.schedule is not None:
            seen["pipeline"].append(dataclasses.asdict(
                self.pipeline_stats))
        if "telemetry" in result[1]:
            from tpu_trainer_torch.utils import telemetry

            seen["telemetry"].append(telemetry.flatten_scalars(
                result[1]["telemetry"]))
        return result

    scan = Trainer.nan_scan

    def scanned(self, state, batch):
        report = scan(self, state, batch)
        seen["nan"].append(report)
        return report

    Trainer.nan_scan = scanned
    if extra.get("digests"):
        def digest(checkpoint_dir, state, **kwargs):
            seen["digests"].append({"step": int(state.step),
                                    "arrays": _state_digests(state)})
            return "(digests only)"
        ckpt_lib.save_checkpoint = digest
        ckpt_lib.AsyncSaver.save = lambda self, *a, **k: digest(*a, **k)
    Trainer.init_state = lambda self, *a, **k: at_rest(init(self, *a, **k))
    ckpt_lib.restore_checkpoint = lambda *a, **k: (
        lambda sm: (at_rest(sm[0]), sm[1]))(restore(*a, **k))
    Trainer.train_step = timed
    from tpu_trainer_torch.models import moe

    first = []
    _record_positions(first, extra.get("moe_calls", 1))
    offsets = moe.rank_offsets
    moe.rank_offsets = lambda counts, rank, *layout: (
        counts[0] * 0 if rank == offsets_fault_rank
        else offsets(counts, rank, *layout))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    rc = entry.main(argv)
    torch.cuda.synchronize()
    import torch.distributed as dist

    from tpu_trainer_torch.parallel import collectives

    seen.update(rc=rc, rank=mesh_lib.process_index(),
                collectives=dict(collectives.calls),
                backend=dist.get_backend() if dist.is_initialized() else None,
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches={k: c.launches for k, c in counters.items()},
                moe_first={k: v.tolist() if hasattr(v, "tolist") else v
                           for k, v in first[0].items()} if first else None,
                moe_drop=[float(1.0 - c["keep"].mean()) for c in first])
    with open(out, "w") as f:
        json.dump(seen, f)


def _dist_spawn(tmp: str, tag: str, mode: str, argv: list, world: int, *,
                backend: str = "gloo", fault_rank=None,
                offsets_fault_rank=None, extra=None) -> list:
    """``world`` ranks of ``_dist_child`` (one process without a group
    when ``world`` is 0), started together; each rank's record, in rank
    order. Ranks rendezvous through a file store in ``tmp`` and share
    ``cuda:0`` (over gloo unless ``backend`` says otherwise); every
    collective is bounded (``COORDINATOR_TIMEOUT_S``). ``extra`` maps a
    rank to its ``_dist_child`` extras (key None: every rank)."""
    procs = []
    store = os.path.join(tmp, f"store_{tag}")
    extra = extra or {}
    ctx = _rank_context()
    import chip_smoke      # the target by this module's name, not __main__'s

    for r in range(max(world, 1)):
        out = os.path.join(tmp, f"dist_{tag}_{r}.json")
        env = dict(os.environ, COORDINATOR_TIMEOUT_S="120", LOCAL_RANK="0")
        group = (backend, store, r, world) if world else None
        mine = {**extra.get(None, {}), **extra.get(r, {})}
        proc = ctx.Process(target=chip_smoke._rank_main, args=(
            env, out, (mode, argv, out, fault_rank, group,
                       offsets_fault_rank, mine)))
        proc.start()
        procs.append((out, _Rank(proc)))
    return procs


@functools.lru_cache(maxsize=None)
def _rank_context():
    """The ``forkserver`` context that starts the ranks of ``_dist_spawn``:
    its server imports torch and the port once (it touches no CUDA), and
    every rank forks from it, a fresh process that skips the imports (up
    to ~15 s each when a group's ranks start together on the host's 8
    cores; the ft phase's restarts, whose cost it measures, stay whole
    interpreters). A script that runs phases with ranks must keep its own
    top level under ``if __name__ == "__main__"``: each rank imports the
    main script."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([
        "chip_smoke", "torch.distributed",
        "tpu_trainer_torch.training.train_ddp",
        "tpu_trainer_torch.training.train_fsdp"])
    return ctx


def _rank_main(env: dict, out: str, args: tuple) -> None:
    """A rank of ``_dist_spawn`` in its forked process: the caller's
    environment, its output to ``out``'s ``.stdout`` / ``.stderr`` files (files, not
    pipes: a rank blocked on a full pipe would stall its peers'
    collectives while another run is joined), then ``_dist_child``."""
    os.environ.update(env)
    for fd, suffix in ((1, ".stdout"), (2, ".stderr")):
        f = os.open(out + suffix, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                    0o644)
        os.dup2(f, fd)
        os.close(f)
    sys.stdout = open(1, "w", buffering=1, closefd=False)
    sys.stderr = open(2, "w", buffering=1, closefd=False)
    _dist_child(*args)


class _Rank:
    """A ``multiprocessing.Process`` with the part of ``subprocess.Popen``
    that the phases use: ``wait``, ``poll``, ``kill``, ``returncode``."""

    def __init__(self, proc):
        self.proc = proc

    @property
    def returncode(self):
        return self.proc.exitcode

    def poll(self):
        return self.proc.exitcode

    def wait(self, timeout=None):
        self.proc.join(timeout)
        if self.proc.exitcode is None:
            raise subprocess.TimeoutExpired(f"rank {self.proc.pid}",
                                            timeout)
        return self.proc.exitcode

    def kill(self):
        self.proc.kill()


def _dist_join_all(spawned: list, timeout: int = 300) -> dict:
    """``{tag: each rank's record}`` of every ``(tag, procs)`` spawned
    together; a run that fails or outlives ``timeout`` fails the phase,
    and every process still running is killed."""
    recs = {}
    deadline = time.monotonic() + timeout
    try:
        for tag, procs in spawned:
            recs[tag] = []
            for out, p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
                with open(out + ".stdout") as f:
                    for ln in f.read().splitlines():
                        log("dist", f"  {tag} | {ln}")
                if p.returncode != 0:
                    with open(out + ".stderr") as f:
                        err = f.read()
                    raise AssertionError(f"dist: {tag} exited "
                                         f"{p.returncode}: {err[-3000:]}")
                with open(out) as f:
                    recs[tag].append(json.load(f))
    finally:
        for _, procs in spawned:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return recs


def _background(fn):
    """``fn()`` started on a thread; the returned function waits for it
    and gives its result or raises its exception."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised by the join below
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if "error" in box:
            raise box["error"]
        return box["value"]
    return join


def _dist_state(path: str) -> dict:
    """A step dir's global arrays (``state.npz`` or stitched shards)."""
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    return ckpt_lib._state_arrays(path, ckpt_lib.load_meta(path))


def _dist_params(path: str) -> dict:
    """A one-process step dir's ``params/*`` arrays alone (the npz members
    that are read; the moments stay on disk)."""
    import numpy as np

    with np.load(os.path.join(path, "state.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith("params/")}


def _dist_equal(what: str, got: dict, want: dict, keys=None) -> int:
    import numpy as np

    keys = sorted(keys or want)
    differ = [k for k in keys if not np.array_equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"dist: {what}: {len(differ)} of {len(keys)} "
                             f"arrays differ, e.g. {differ[:4]}")
    return len(keys)


def _dist_close(what: str, got: dict, want: dict, keys, rtol: float
                ) -> float:
    """The worst of ``max |got - want| / max |want|`` over ``keys``; it
    must be at most ``rtol``."""
    import numpy as np

    worst, at = -1.0, None
    for k in keys:
        w = np.asarray(want[k])
        err = float(np.max(np.abs(np.asarray(got[k]) - w)))
        rel = err / max(float(np.max(np.abs(w))), 1e-30)
        if rel > worst:
            worst, at = rel, k
    if worst > rtol:
        raise AssertionError(f"dist: {what}: worst relative difference "
                             f"{worst:.3e} (at {at}) above {rtol:.0e}")
    return worst


# ZeRO at world 2 against one process at accumulation 2. The gradient
# sums are the world-1 accumulation (two operands), but the global norm
# adds the shards' squares in another order: on the H100 it comes out an
# ulp off at steps 0 and 1, which moves the clip coefficient and every
# moment by an ulp, and by step 2 the bf16 run has drifted (this phase
# on medium_model.yaml's 24 layers, 3 steps: losses bitwise, the step-2
# grad norm 7.835e-05 off, the final moments up to ~2e-02 of their
# largest value).
# The bounds sit above those; a moment whose two rank halves are swapped
# is off by its own size and must fail (the control in ``phase_dist``).
DIST_NORM_RTOL = 2e-4
DIST_STATE_RTOL = 5e-2
# MoE at world 2 against one process at the same global micro-batch: a
# rank computes half the rows (other GEMM shapes, another reduction order
# of the loss and the aux means), so the losses agree to f32 and bf16
# rounding, not bitwise. The state does not stay within DIST_STATE_RTOL:
# a GEMM of another shape rounds a router logit another way, a token at a
# near tie goes to another expert, and its whole contribution moves (to
# an expert's weights, to its embedding row). On the H100 (moe_small's
# width at 2 layers, 3 steps; step 1's layer-0 routing bitwise, the
# capacity losses within 4.3e-07): the worst element 0.160 (capacity) and
# 0.164 (dropless) of its leaf's largest value, the worst leaf's relative
# L2 7.40e-02 and 4.52e-02. So the MoE state is held on each leaf's
# relative L2, DIST_MOE_STATE_L2; one moment's halves swapped is off by
# more than its own norm and must fail it.
DIST_LOSS_RTOL = 1e-3
DIST_MOE_STATE_L2 = 0.15


def _state_rel(got, want, keys):
    """Per leaf: max |got - want| / max |want| and the relative L2 (f32
    arithmetic: the bounds sit at 1e-2 and above)."""
    import numpy as np

    out = {}
    for k in keys:
        w = np.asarray(want[k], dtype=np.float32).reshape(-1)
        d = np.asarray(got[k], dtype=np.float32).reshape(-1) - w
        out[k] = (float(np.abs(d).max() / max(np.abs(w).max(), 1e-30)),
                  float(np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)))
    return out


def _moe2_yamls(tmp: str) -> dict:
    """moe_small cut to 2 layers, dropout 0 and capacity factor 0.5, for
    each router: the capacity router drops at every layer, so the queue
    offsets across ranks decide which tokens."""
    return {impl: _cut_yaml(tmp, "moe_small.yaml", f"moe2_{impl}",
                            dropout=0.0, attention_dropout=0.0, num_layers=2,
                            expert_capacity_factor=0.5, moe_impl=impl)
            for impl in ("capacity", "dropless")}


def phase_expert(results: dict, tmp: str) -> dict:
    """The expert phase alone (``_dist_expert``), with its own one-process
    runs of both routers (in the whole script it runs inside the dist
    phase, against that phase's MoE group's): for iterating on it and
    for ``scripts/torch_kernel_mutations.py``."""
    argv, want, check_launches = _dist_tools(tmp)
    yamls = _moe2_yamls(tmp)
    spawned = [(f"{impl}1", _dist_spawn(tmp, f"{impl}1", "ddp",
                                        argv(f"{impl}1", yaml, 3, 4, 1), 0))
               for impl, yaml in yamls.items()]
    recs = _dist_join_all(spawned)
    states = {impl: _dist_state(os.path.join(tmp, f"ck_{impl}1",
                                             "step_00000003"))
              for impl in yamls}
    out = results["expert"] = _dist_expert(
        tmp, argv, yamls, states, recs, want, check_launches, {},
        nvidia_smi_line())
    return out


def _dist_moe(tmp, argv, want, check_launches, launches, card,
              then=None) -> dict:
    """Group 3 of the dist phase: MoE across processes, both routers, on
    moe_small's width cut to 2 layers and capacity factor 0.5, 3 steps of
    a global micro-batch of 4 x 1024 (accumulation 1): one process and
    world 1 over NCCL (losses and final params bitwise), DDP and
    FULL_SHARD (no remat, as the yaml says: the backward regathers the
    expert weights) at world 2, a rank batch 2. Each world-2 run against
    one process: losses within ``DIST_LOSS_RTOL``, every final master
    and moment within ``DIST_MOE_STATE_L2`` relative L2 (a control with
    one moment's halves swapped must fail it), launches exact, one
    ``moe_counts`` all-gather a layer a forward. Capacity: layer 0's keep
    mask of step 1 (the ranks' concatenated) bitwise the plain loop's on
    the concatenated routing and, where that routing equals one
    process's, bitwise one process's;
    a planted fault (rank 1's queue offsets 0) must fail that check. The
    expert phase (``_dist_expert``) starts as soon as these runs end, on
    their one-process runs."""
    t_moe = t0 = time.perf_counter()
    runs, spawned = {}, []
    yamls = _moe2_yamls(tmp)
    for impl, yaml in yamls.items():
        a1 = argv(f"{impl}1", yaml, 3, 4, 1)
        runs[f"{impl}1"] = ("ddp", a1)
        runs[f"{impl}_nccl"] = ("ddp", argv(f"{impl}_nccl", yaml, 3, 4, 1))
        runs[f"{impl}_ddp"] = ("ddp", argv(f"{impl}_ddp", yaml, 3, 2, 1))
        runs[f"{impl}_z3"] = ("fsdp", argv(f"{impl}_z3", yaml, 3, 2, 1,
                                            "--sharding", "FULL_SHARD"))
        spawned += [(f"{impl}1", _dist_spawn(tmp, f"{impl}1", "ddp", a1, 0)),
                    (f"{impl}_nccl", _dist_spawn(
                        tmp, f"{impl}_nccl", "ddp", runs[f"{impl}_nccl"][1],
                        1, backend="nccl"))]
        spawned += [(t, _dist_spawn(tmp, t, runs[t][0], runs[t][1], 2))
                    for t in (f"{impl}_ddp", f"{impl}_z3")]
    runs["moe_fault"] = ("ddp", argv("moe_fault", yamls["capacity"], 1, 2,
                                     1))
    spawned.append(("moe_fault", _dist_spawn(tmp, "moe_fault", "ddp",
                                             runs["moe_fault"][1], 2,
                                             offsets_fault_rank=1)))
    recs = _dist_join_all(spawned)
    group_s = time.perf_counter() - t0
    # The expert phase's runs take the card while this group is held.
    expert = _expert_spawn(tmp, argv, yamls)
    try:
        out = _dist_moe_checks(tmp, runs, recs, yamls, want, check_launches,
                               launches, card, group_s)
        out["expert"] = _dist_expert(
            tmp, argv, yamls, out.pop("one_states"), recs, want,
            check_launches, launches, card, started=expert, then=then)
    except BaseException:
        _kill_spawned(expert[3])
        raise
    for tag, (_, a) in runs.items():
        shutil.rmtree(a[a.index("--checkpoint_dir") + 1], ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_moe
    log("dist", f"MoE group: 9 runs sharing the card in {group_s:.1f} s; "
                f"world 1 over NCCL: losses and final params bitwise one "
                f"process (both routers); "
                f"rank 1's zeroed queue offsets rejected")
    return out


def _dist_moe_checks(tmp, runs, recs, yamls, want, check_launches, launches,
                     card, group_s) -> dict:
    """``_dist_moe``'s checks of its runs; returns its record, with the
    one-process final states under ``one_states``."""
    import numpy as np

    from tpu_trainer_torch.parallel.sharding import fsdp_dim
    from tpu_trainer_torch.training import cli

    def train(tag):
        return _jsonl(os.path.join(tmp, f"{tag}.jsonl"), "train")

    # Every final state is read at once, on threads.
    reading = {tag: _background(lambda tag=tag: _dist_state(os.path.join(
        tmp, f"ck_{tag}", "step_00000003"))) for tag in runs
        if tag != "moe_fault" and not tag.endswith("_nccl")}

    def state(tag):
        return reading[tag]()

    out = {"group_s": group_s}
    for tag, (mode, a) in runs.items():
        cfg = cli.resolve_configs(cli.build_parser(mode).parse_args(a),
                                  mode)[0]
        steps = 1 if tag == "moe_fault" else 3
        check_launches(tag, recs[tag], want(mode, a, steps, 1))
        remat = 2 if cfg.gradient_checkpointing else 1
        calls = cfg.num_layers * (remat * steps + 1)
        for r in recs[tag]:
            _add_launches(launches, r["launches"])
            got = r["collectives"].get("moe_counts", 0)
            if got != (calls if len(recs[tag]) > 1 else 0):
                raise AssertionError(f"dist: {tag} rank {r['rank']}: "
                                     f"{got} moe_counts all-gathers, want "
                                     f"{calls}")

    def keep_check(tag):
        """The ranks' concatenated layer-0 keep mask against the plain
        loop on their concatenated routing; returns (routing, keep)."""
        first = [r["moe_first"] for r in recs[tag]]
        gate = np.concatenate([np.asarray(f["gate_idx"]) for f in first])
        keep = np.concatenate([np.asarray(f["keep"]) for f in first])
        pos = np.concatenate([np.asarray(f["pos"]) for f in first])
        want_pos, want_keep = _capacity_plain(gate, first[0]["capacity"])
        if not (np.array_equal(pos, want_pos)
                and np.array_equal(keep, want_keep)):
            raise AssertionError(
                f"dist: {tag}: layer-0 keep mask differs from the plain "
                f"loop's in {int((keep != want_keep).sum())} of "
                f"{keep.size} token-choices")
        return gate, keep

    state_rel = _state_rel

    failures = []
    for impl in ("capacity", "dropless"):
        one = train(f"{impl}1")
        if [r["loss"] for r in train(f"{impl}_nccl")] != [
                r["loss"] for r in one]:
            raise AssertionError(f"dist: {impl} world 1 over NCCL: losses "
                                 f"differ from one process")
        ref = state(f"{impl}1")
        nccl = _dist_params(os.path.join(tmp, f"ck_{impl}_nccl",
                                         "step_00000003"))
        n = _dist_equal(f"{impl} world 1 over NCCL", nccl, ref, list(nccl))
        keys = [k for k in ref if "/" in k]
        res = {"nccl_param_arrays": n}
        for strategy in ("ddp", "z3"):
            tag = f"{impl}_{strategy}"
            got = [r["loss"] for r in train(tag)]
            w = [r["loss"] for r in one]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, w))
            final = state(tag)
            leaves = state_rel(final, ref, keys)
            worst = max(leaves, key=lambda k: leaves[k][0])
            worst_l2 = max(leaves, key=lambda k: leaves[k][1])
            r0 = recs[tag][0]
            res[strategy] = {
                "losses": got, "world1_losses": w, "loss_worst_rtol": rel,
                "state_worst": [worst, leaves[worst][0]],
                "state_worst_l2": [worst_l2, leaves[worst_l2][1]],
                "step_ms": [r["step_ms"] for r in recs[tag]],
                "peak_gb": [r["peak_bytes"] / 1e9 for r in recs[tag]],
                "moe_counts": r0["collectives"].get("moe_counts", 0)}
            if len(got) != len(w) or rel > DIST_LOSS_RTOL:
                failures.append(f"{tag}: losses {got} vs one process's {w} "
                                f"(worst rtol {rel:.3e}, bound "
                                f"{DIST_LOSS_RTOL:.0e})")
            if leaves[worst_l2][1] > DIST_MOE_STATE_L2:
                failures.append(f"{tag}: final state's worst relative L2 "
                                f"{leaves[worst_l2][1]:.3e} at {worst_l2} "
                                f"above {DIST_MOE_STATE_L2}")
            if strategy == "ddp":
                ddp_final = final
            else:
                between = state_rel(final, ddp_final, keys)
                res[strategy]["vs_ddp_worst"] = max(
                    v[0] for v in between.values())
            if impl == "capacity":
                keep_check(f"{impl}1")
                gate, keep = keep_check(tag)
                first1 = recs[f"{impl}1"][0]["moe_first"]
                same_routing = np.array_equal(
                    gate, np.asarray(first1["gate_idx"]))
                if same_routing and not np.array_equal(
                        keep, np.asarray(first1["keep"])):
                    failures.append(f"{tag}: layer-0 keep mask of step 1 "
                                    f"differs from one process's")
                res[strategy].update(
                    drop_frac_layer0=float(1.0 - keep.mean()),
                    routing_equal_one_process=bool(same_routing),
                    routing_differs=int((gate != np.asarray(
                        first1["gate_idx"])).sum()))
            if strategy == "ddp" and impl == "capacity":
                key = max((k for k in keys if "/mu/" in k),
                          key=lambda k: ref[k].size)
                d = fsdp_dim(ref[key].shape, 2)
                swapped = {key: np.concatenate(
                    np.split(final[key], 2, axis=d)[::-1], axis=d)}
                ctrl = state_rel(swapped, ref, [key])[key][1]
                if ctrl <= DIST_MOE_STATE_L2:
                    raise AssertionError(f"dist: the check passed a planted "
                                         f"fault: {key}'s halves swapped "
                                         f"(relative L2 {ctrl:.3e})")
            log("dist", f"MoE {impl} {strategy} world 2 (moe_small width, 2 "
                        f"layers, capacity factor 0.5): losses "
                        + " ".join(f"{x:.6f}" for x in got)
                        + " vs one process "
                        + " ".join(f"{x:.6f}" for x in w)
                        + f" (worst rtol {rel:.2e}); final state worst "
                        f"{leaves[worst][0]:.2e} of its leaf's largest "
                        f"value ({worst}), worst relative L2 "
                        f"{leaves[worst_l2][1]:.2e} ({worst_l2}; bound "
                        f"{DIST_MOE_STATE_L2})"
                        + (f", {res[strategy]['vs_ddp_worst']:.2e} off DDP's"
                           if strategy == "z3" else "") + "; "
                        f"{res[strategy]['moe_counts']} moe_counts "
                        f"all-gathers a rank"
                        + (f"; layer-0 keep mask of step 1 bitwise the plain"
                           f" loop's (drop_frac "
                           f"{res[strategy]['drop_frac_layer0']:.4f}), "
                           f"routing {res[strategy]['routing_differs']} "
                           f"choices off one process's"
                           if impl == "capacity" else "")
                        + f"; step ms rank 0 "
                        f"{[round(x, 1) for x in res[strategy]['step_ms'][0]]}"
                        f" ({card})")
        out[impl] = res
    if failures:
        raise AssertionError("dist: MoE: " + "; ".join(failures))
    _must_reject("dist: rank 1's queue offsets 0",
                 lambda: keep_check("moe_fault"))
    out["one_states"] = {impl: state(f"{impl}1") for impl in yamls}
    return out


def _expert_launches(cfg, rows: int, train_micro: int, eval_micro: int,
                     sp: int, tp: int) -> dict:
    """A rank's launches under the sequence and tensor axes
    (``_mesh_launches``) with the dropless MoE's grouped matmuls on its
    local experts: 3 gmm a layer a forward, 3 more and 3 tgmm a layer
    backward (an expert axis changes no count)."""
    out = _mesh_launches(cfg, rows, train_micro, eval_micro, sp, tp)
    if cfg.num_experts > 0 and cfg.moe_impl == "dropless":
        L = cfg.num_layers
        out.update(gmm=3 * L * (2 * train_micro + eval_micro),
                   tgmm=3 * L * train_micro)
    return out


# The expert phase's runs: (yaml, steps, rows a data shard, mesh flags,
# ranks, the rank whose per-row queue offsets are zeroed or None).
def _expert_runs(yamls) -> dict:
    return {
        "ep_a": (yamls["capacity"], 3, 2, ["--mesh_data", "2",
                                           "--mesh_expert", "4"], 8, None),
        "ep_b": (yamls["dropless"], 3, 4, ["--mesh_expert", "2",
                                           "--mesh_tensor", "2",
                                           "--mesh_sequence", "2"], 8, None),
        "ep_seq": (yamls["capacity"], 1, 4, ["--mesh_sequence", "2"], 2,
                   None),
        "ep_seq_fault": (yamls["capacity"], 1, 4, ["--mesh_sequence", "2"],
                         2, 1),
    }


def _expert_spawn(tmp, argv, yamls):
    """Start the expert phase's runs (``_dist_expert``) together; returns
    ``(t0, runs, argvs, spawned)``. The sequence runs' saves write
    nothing (``digests``): only their first step's routing is read."""
    runs = _expert_runs(yamls)
    args = {tag: argv(tag, yaml, steps, rows, 1, *extra)
            for tag, (yaml, steps, rows, extra, _, _) in runs.items()}
    t0 = time.perf_counter()
    spawned = [(tag, _dist_spawn(
        tmp, tag, "ddp", args[tag], w, offsets_fault_rank=fault,
        extra={None: {"moe_calls": 2, "digests": tag.startswith("ep_seq")}}))
        for tag, (_, _, _, _, w, fault) in runs.items()]
    return t0, runs, args, spawned


def _kill_spawned(spawned) -> None:
    for _, procs in spawned:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _dist_expert(tmp, argv, yamls, one_states, one_recs, want,
                 check_launches, launches, card, started=None,
                 then=None) -> dict:
    """The expert phase, after the dist phase's MoE group, whose
    one-process runs (moe_small's width at 2 layers, capacity factor 0.5,
    dropout 0, a global micro-batch of 4 x 1024, 3 steps) it is held
    against; every rank a process of its own sharing the card over gloo
    (``_dist_spawn``):

    - run A, the mesh ``configs/moe_small.yaml`` documents: ``train_ddp
      --mesh_data 2 --mesh_expert 4``, 8 ranks, the capacity router
      (``auto``: einsum), a data shard 2 rows;
    - run B, the composed axes: the dropless router at expert 2 x tensor
      2 x sequence 2, 8 ranks (the ring through the flash kernels, gmm and
      tgmm on each rank's two experts);
    - the capacity router under sequence 2 (2 ranks, 1 step), and the same
      with rank 1's per-row queue offsets zeroed (a planted fault).

    Each run against one process: launches exact on every rank; losses
    within ``DIST_LOSS_RTOL``; every final master and moment within
    ``DIST_MOE_STATE_L2`` relative L2 (one moment's halves swapped must
    fail it). Capacity runs: the first step's layer-0 keep mask of the
    global micro-batch (the ranks' tokens put back in global order)
    bitwise the plain loop's on that routing, and where the routing equals
    one process's, one process's; the planted fault must fail that check.
    Printed: routing equality, drop_frac by layer, a rank's expert
    parameter bytes against one process's, its collectives' calls and
    bytes a step, its step ms and peak. ``started``: the runs'
    ``_expert_spawn``, when the caller started them earlier (the dist
    phase starts them as soon as its MoE group's runs end, and holds that
    group meanwhile); ``then``: called as the runs end, before their
    checks (the whole script starts the pipeline and mesh-ranks runs
    there)."""
    import numpy as np

    from tpu_trainer_torch.parallel.sharding import fsdp_dim
    from tpu_trainer_torch.training import cli

    t0, runs, args, spawned = started or _expert_spawn(tmp, argv, yamls)
    L = 2
    recs = _dist_join_all(spawned)
    group_s = time.perf_counter() - t0
    if then is not None:
        then()
    reading = {tag: _background(lambda tag=tag: _dist_state(os.path.join(
        tmp, f"ck_{tag}", "step_00000003"))) for tag in ("ep_a", "ep_b")}

    def train(tag):
        return _jsonl(os.path.join(tmp, f"{tag}.jsonl"), "train")

    for tag, (_, steps, rows, extra, w, _) in runs.items():
        cfg = cli.resolve_configs(cli.build_parser("ddp").parse_args(
            args[tag]), "ddp")[0]
        sp = 2 if "--mesh_sequence" in extra else 1
        tp = 2 if "--mesh_tensor" in extra else 1
        expect = (want("ddp", args[tag], steps, 1) if sp * tp == 1
                  else _expert_launches(cfg, rows, steps, 1, sp, tp))
        check_launches(tag, recs[tag], expect)
        if not tag.endswith("fault"):
            for r in recs[tag]:
                _add_launches(launches, r["launches"])

    def global_first(tag, sp, dp):
        """The first capacity call's routing, positions and keep mask of
        the global micro-batch, from one rank a (data shard, sequence
        rank): the ranks' tokens put back in ``row * S + col`` order."""
        ranks = recs[tag]
        per = len(ranks) // (dp * sp)      # tensor x expert replicas
        parts = {}
        for key in ("gate_idx", "pos", "keep"):
            shards = []
            for d in range(dp):
                cols = [np.asarray(ranks[(d * sp + j) * per]["moe_first"][
                    key]) for j in range(sp)]
                k = cols[0].shape[-1]
                rows = 4 // dp
                shards.append(np.concatenate(
                    [c.reshape(rows, -1, k) for c in cols], axis=1))
            parts[key] = np.concatenate(shards).reshape(-1, k)
        return parts, ranks[0]["moe_first"]["capacity"]

    def keep_check(tag, sp, dp):
        got, cap = global_first(tag, sp, dp)
        want_pos, want_keep = _capacity_plain(got["gate_idx"], cap)
        if not (np.array_equal(got["pos"], want_pos)
                and np.array_equal(got["keep"], want_keep)):
            raise AssertionError(
                f"expert: {tag}: layer-0 keep mask differs from the plain "
                f"loop's in {int((got['keep'] != want_keep).sum())} of "
                f"{want_keep.size} token-choices")
        return got

    one_first = one_recs["capacity1"][0]["moe_first"]
    one_train = {impl: [r["loss"] for r in train(f"{impl}1")]
                 for impl in yamls}
    out, failures = {"group_s": group_s}, []
    for tag, impl, sp, dp in (("ep_a", "capacity", 1, 2),
                              ("ep_b", "dropless", 2, 1),
                              ("ep_seq", "capacity", 2, 1)):
        ranks = recs[tag]
        got = [r["loss"] for r in train(tag)]
        w = one_train[impl][:len(got)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, w))
        if rel > DIST_LOSS_RTOL:
            failures.append(f"{tag}: losses {got} vs one process's {w} "
                            f"(worst rtol {rel:.3e})")
        res = {"losses": got, "world1_losses": w, "loss_worst_rtol": rel,
               "step_ms": [r["step_ms"] for r in ranks],
               "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
               "step_calls": ranks[0]["step_calls"]}
        if tag != "ep_seq":
            final, ref = reading[tag](), one_states[impl]
            keys = [k for k in ref if "/" in k]
            leaves = _state_rel(final, ref, keys)
            worst = max(leaves, key=lambda k: leaves[k][1])
            res["state_worst_l2"] = [worst, leaves[worst][1]]
            if leaves[worst][1] > DIST_MOE_STATE_L2:
                failures.append(f"{tag}: final state's worst relative L2 "
                                f"{leaves[worst][1]:.3e} at {worst}")
            key = max((k for k in keys if "/mu/" in k),
                      key=lambda k: ref[k].size)
            d = fsdp_dim(ref[key].shape, 2)
            swapped = {key: np.concatenate(
                np.split(final[key], 2, axis=d)[::-1], axis=d)}
            ctrl = _state_rel(swapped, ref, [key])[key][1]
            if ctrl <= DIST_MOE_STATE_L2:
                raise AssertionError(f"expert: the check passed a planted "
                                     f"fault: {key}'s halves swapped "
                                     f"(relative L2 {ctrl:.3e})")
            one_rest = one_recs[f"{impl}1"][0]["rest"][0]
            res["expert_bytes_ratio"] = [
                r["rest"][0]["experts"] / one_rest["experts"] for r in ranks]
            del final
        if impl == "capacity":
            g = keep_check(tag, sp, dp)
            same = np.array_equal(g["gate_idx"],
                                  np.asarray(one_first["gate_idx"]))
            if same and not np.array_equal(g["keep"],
                                           np.asarray(one_first["keep"])):
                failures.append(f"{tag}: layer-0 keep mask differs from "
                                f"one process's")
            per = len(ranks) // (dp * sp)
            distinct = ranks[::per]
            res.update(routing_equal_one_process=bool(same),
                       routing_differs=int((g["gate_idx"] != np.asarray(
                           one_first["gate_idx"])).sum()),
                       drop_frac_by_layer=[
                           float(np.mean([r["moe_drop"][i]
                                          for r in distinct]))
                           for i in range(L)])
        out[tag] = res
        calls = res["step_calls"][-1]
        wire = sum(v for k, v in calls.items() if k.endswith("_bytes"))
        log("dist", f"expert {tag} ({impl}, {len(ranks)} ranks, args "
                    f"{' '.join(runs[tag][3])}): losses "
                    + " ".join(f"{x:.6f}" for x in got) + " vs one process "
                    + " ".join(f"{x:.6f}" for x in w)
                    + f" (worst rtol {rel:.2e})"
                    + (f"; final state worst relative L2 "
                       f"{res['state_worst_l2'][1]:.2e} "
                       f"({res['state_worst_l2'][0]}; bound "
                       f"{DIST_MOE_STATE_L2}); a rank's expert parameters "
                       f"{res['expert_bytes_ratio'][0]:.3f} of one "
                       f"process's" if "state_worst_l2" in res else "")
                    + (f"; layer-0 keep mask bitwise the plain loop's, "
                       f"routing {res['routing_differs']} choices off one "
                       f"process's, drop_frac by layer "
                       + " ".join(f"{x:.4f}"
                                  for x in res["drop_frac_by_layer"])
                       if impl == "capacity" else "")
                    + f"; rank 0's last step: "
                    + ", ".join(f"{k} {v}" for k, v in sorted(calls.items())
                                if not k.endswith("_bytes"))
                    + f" calls, {wire / 1e6:.1f} MB"
                    + f"; step ms rank 0 "
                    f"{[round(x, 1) for x in res['step_ms'][0]]}, peak "
                    f"{max(res['peak_gb']):.2f} GB a rank ({card})")
    if failures:
        raise AssertionError("expert: " + "; ".join(failures))
    _must_reject("expert: rank 1's per-row queue offsets 0 under sequence",
                 lambda: keep_check("ep_seq_fault", 2, 1))
    for tag in runs:
        shutil.rmtree(os.path.join(tmp, f"ck_{tag}"), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log("dist", f"expert phase: 4 runs (20 ranks) sharing the card in "
                f"{group_s:.1f} s, checks {out['seconds'] - group_s:.1f} s; "
                f"rank 1's zeroed per-row offsets under sequence rejected")
    return out


def _dist_offload(ranks, a_off, full, m1, same_curve, check_launches,
                  want, launches, card) -> dict:
    """``train_fsdp --sharding FULL_SHARD --cpu_offload`` at world 2 on
    medium_model.yaml (2 layers): losses bitwise one process's and grad
    norms within ``DIST_NORM_RTOL`` (``same_curve`` against m1); each
    rank's final masters and moments (digests of its slices) bitwise the
    on-card FULL_SHARD run's, which is held to one process within
    ``DIST_STATE_RTOL`` with the swapped-halves control; launches exact;
    at rest a rank's moments all in host memory. Prints a rank's device
    and host bytes at rest."""
    import hashlib

    import numpy as np

    check_launches("m2_off", ranks, want("fsdp", a_off, 3, 1))
    for r in ranks:
        _add_launches(launches, r["launches"])
    worst = same_curve("m2_off", "m1", DIST_NORM_RTOL)
    n = 0
    for r in ranks:
        digests = r["digests"][-1]
        if digests["step"] != 3:
            raise AssertionError(f"dist: m2_off digested step "
                                 f"{digests['step']}")
        for key, shards in digests["arrays"].items():
            if "/" not in key:
                continue
            for starts, shape, dtype, sha in shards:
                sl = tuple(slice(a, a + b) for a, b in zip(starts, shape))
                mine = np.ascontiguousarray(full[key][sl]).astype(dtype)
                if hashlib.sha256(mine.tobytes()).hexdigest() != sha:
                    raise AssertionError(f"dist: m2_off rank {r['rank']}: "
                                         f"{key}{starts} differs from the "
                                         f"on-card FULL_SHARD run's")
                n += 1
    rest = [r["rest"][0] for r in ranks]
    if any(x["host"] != x["moments"] for x in rest):
        raise AssertionError(f"dist: m2_off: moments not all in host "
                             f"memory at rest: {rest}")
    log("dist", f"FULL_SHARD --cpu_offload world 2 (medium_model.yaml at 2 "
                f"layers): losses within rtol {worst['loss']:.2e} and grad "
                f"norms {worst['grad_norm']:.3e} of world 1, {n} final "
                f"slices bitwise the on-card FULL_SHARD run's; at rest "
                f"rank 0 holds {rest[0]['allocated'] / 1e9:.3f} GB on the "
                f"card and {rest[0]['host'] / 1e9:.3f} GB of moments in "
                f"pinned host memory (rank 1 "
                f"{rest[1]['allocated'] / 1e9:.3f} / "
                f"{rest[1]['host'] / 1e9:.3f} GB); step ms rank 0 "
                f"{[round(x, 1) for x in ranks[0]['step_ms']]}, peak "
                f"{[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB "
                f"({card})")
    return {"worst_rtol": worst, "slices_bitwise": n, "rest_bytes": rest,
            "step_ms": [r["step_ms"] for r in ranks],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks]}


def _dist_tools(tmp: str):
    """``(argv, want, check_launches)`` of the dist and expert phases:
    ``argv(tag, config, steps, bs, accum, *extra)`` a CLI run writing its
    checkpoints and JSONL in ``tmp``; ``want(mode, a, micro, eval_micro)``
    the launches of ``micro`` training and ``eval_micro`` eval
    micro-batches of ``a`` (ZeRO-3's backward regathers the weights and
    runs no block's forward again unless the config asks for remat);
    ``check_launches(tag, recs, expect)`` every rank's launches equal."""
    from tpu_trainer_torch.training import cli

    common = ["--log_interval", "1", "--eval_interval", "0",
              "--eval_batches", "1", "--keep_last_n", "0",
              "--no_auto_resume"]

    def argv(tag, config, steps, bs, accum, *extra):
        return (["--config", config, "--max_steps", str(steps),
                 "--batch_size", str(bs), "--grad_accum", str(accum),
                 "--save_interval", "0",
                 "--checkpoint_dir", os.path.join(tmp, f"ck_{tag}"),
                 "--metrics_jsonl", os.path.join(tmp, f"{tag}.jsonl")]
                + common + list(extra))

    def want(mode, a, micro, eval_micro):
        cfg = cli.resolve_configs(cli.build_parser(mode).parse_args(a),
                                  mode)[0]
        return _micro_launches(cfg, micro, eval_micro, segmented=False)

    def check_launches(tag, recs, expect):
        for r in recs:
            if r["launches"] != expect:
                raise AssertionError(f"dist: {tag} rank {r['rank']} "
                                     f"launches {r['launches']}, want "
                                     f"{expect}")
    return argv, want, check_launches


# Pipeline runs against one process (run A, 1F1B at stage 4, dropout 0)
# and against each other (run B, three schedules at stage 2, dropout 0.1,
# the same masks): bf16, so not bitwise (another summation order of every
# gradient over the microbatches; 1F1B's head is the vocabulary-sharded
# plain product where one process runs the fused head + CE kernel).
# Run A: losses within DIST_LOSS_RTOL, every final master and moment
# within PIPE_STATE_L2 relative L2 of one process's (a moment with its
# two halves swapped is off by more than its own norm and must fail it).
# Run B: within 2x run A's readings (the bf16 error of one pipelined pass
# against one process), since the schedules draw the same masks.
PIPE_STATE_L2 = 0.15


def _mesh_flag(argv, axis: str) -> int:
    """The size a CLI argv gives mesh axis ``axis`` (1 when it names
    none)."""
    flag = f"--mesh_{axis}"
    return int(argv[argv.index(flag) + 1]) if flag in argv else 1


def _pipe_launches(cfg, stages: int, stage: int, steps: int,
                   eval_batches: int = 1, tensor: int = 1) -> dict:
    """A stage rank's launches over ``steps`` pipelined steps and
    ``eval_batches`` eval batches: a forward of each of its layers a
    microbatch (twice under remat), in training and in each eval batch
    (the forward alone in the schedule's microbatches), the fused
    backward a layer a microbatch; the head + CE kernel on the last
    stage: GPipe's head a step (1F1B's vocabulary slices are plain
    products) and the eval's whole-batch head, unless a tensor axis
    (``tensor`` above 1) takes the vocab-sharded head (``_tp_loss``)."""
    from tpu_trainer_torch.ops import flash
    from tpu_trainer_torch.parallel import pipeline as pp

    M = pp.num_microbatches(cfg, stages)
    Ls = cfg.num_layers // stages
    fwd = 2 if cfg.gradient_checkpointing else 1
    fused = flash.backward_impl(cfg.max_seq_len, False) == "fused"
    last = stage == stages - 1
    gpipe = cfg.pipeline_schedule == "gpipe"
    return {"flash_forward": Ls * M * (fwd * steps + eval_batches),
            "flash_backward": Ls * M * steps if fused else 0,
            "flash_backward_dkv": 0 if fused else Ls * M * steps,
            "flash_backward_dq": 0 if fused else Ls * M * steps,
            "head_ce": ((steps if gpipe else 0) + eval_batches)
            if last and tensor == 1 else 0,
            "gmm": 0, "tgmm": 0}


def _pipe_spawn(tmp: str, argv) -> dict:
    """Start the pipeline phase's runs together; ``{tag: (argv, world,
    procs)}`` and ``"t0"``, when they started."""
    from tpu_trainer_torch.parallel import pipeline as pp

    a12 = _cut_yaml(tmp, "small_model.yaml", "pp12", dropout=0.0,
                    attention_dropout=0.0, pipeline_schedule="1f1b")
    b4 = {k: _cut_yaml(tmp, "small_model.yaml", f"pp4{k}", num_layers=4,
                       pipeline_schedule=k) for k in pp.SCHEDULES}
    micro = ["--pipeline_microbatches", "8"]
    runs = {"pp_one": (argv("pp_one", a12, 3, 8, 1), 0, None),
            "pp_a": (argv("pp_a", a12, 3, 8, 1, "--mesh_stage", "4",
                          *micro), 4, None),
            "pp_w": (argv("pp_w", b4["1f1b"], 3, 8, 1, "--mesh_stage", "2",
                          *micro), 2, {None: {"window_delta": -1}}),
            "pp_tp": (argv("pp_tp", a12, 3, 8, 1, "--mesh_tensor", "2",
                           "--mesh_stage", "2", *micro), 4, None)}
    for k, yaml in b4.items():
        runs[f"pp_b_{k}"] = (argv(f"pp_b_{k}", yaml, 3, 8, 1, "--mesh_stage",
                                  "2", *micro), 2, None)
    t0 = time.perf_counter()
    out = {tag: (a, w, _dist_spawn(tmp, tag, "ddp", a, w, extra=e))
           for tag, (a, w, e) in runs.items()}
    out["t0"] = t0
    return out


def phase_pipeline(results: dict, tmp: str, started=None, then=None
                   ) -> dict:
    """Pipeline parallelism on the card (``train_ddp --mesh_stage``), every
    rank a process of its own sharing ``cuda:0`` over gloo
    (``_dist_spawn``), all runs started together:

    - run A, the full model: ``small_model.yaml`` at all 12 layers,
      dropout 0, batch 8 x 1024, ``--mesh_stage 4 --pipeline_microbatches
      8``, 1F1B, 3 steps, against one process on the same batch: losses
      within ``DIST_LOSS_RTOL``, every final master and moment within
      ``PIPE_STATE_L2`` relative L2 (one moment's halves swapped must
      fail it), every rank's launches the schedule's
      (``_pipe_launches``);
    - run B, the schedules: GPipe, 1F1B and interleaved (v 2) at stage 2,
      4 layers, M 8, batch 8 x 1024, dropout 0.1 (the same masks per
      global layer and microbatch in all three), 3 steps: losses and
      final states of 1F1B and interleaved against GPipe's within 2x run
      A's readings against one process (its worst loss rtol and leaf
      L2); each rank's peak memory under GPipe and 1F1B;
    - run pp_tp, the pipeline under the tensor axis: run A's model and
      batch at ``--mesh_tensor 2 --mesh_stage 2 --pipeline_microbatches
      8``, 1F1B, 3 steps, held as run A against one process, every rank's
      launches the schedule's (no head + CE under tensor); a rank's
      parameter bytes at rest against one process's, its step ms, and its
      ``pp_send`` and ``tp_*`` bytes a step;
    - a planted fault: the 1F1B window one below the simulation's (W 2
      where it gives 3 at S 2, M 8): the run must be refused.

    Printed: a rank's step ms, ``pp_send`` bytes a step, the seconds it
    waited on receives a step, the most microbatches it held in flight
    and its peak. Ranks time-slicing one card measure no multi-GPU
    speed. ``started``: the runs' ``_pipe_spawn``, when the caller
    started them earlier (the whole script starts them as the dist
    phase's expert runs end, beside those runs' checks, which read
    states on the host); ``then``: called as the runs end, before the
    checks (the whole script starts the mesh-ranks phase's runs
    there)."""
    import numpy as np

    from tpu_trainer_torch.models.gpt import GPT
    from tpu_trainer_torch.parallel import pipeline as pp
    from tpu_trainer_torch.parallel.sharding import fsdp_dim, leaf_specs
    from tpu_trainer_torch.training import cli

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    argv, _, _ = _dist_tools(tmp)
    spawned = dict(started or _pipe_spawn(tmp, argv))
    t_runs = spawned.pop("t0")
    try:
        planted = _pipe_planted(tmp, spawned.pop("pp_w"))
    except BaseException:
        _kill_spawned([(tag, procs) for tag, (_, _, procs)
                       in spawned.items()])
        raise
    recs = _dist_join_all([(tag, procs) for tag, (_, _, procs)
                           in spawned.items()])
    runs_s = time.perf_counter() - t_runs
    if then is not None:
        then()
    t_checks = time.perf_counter()
    # Every final state read at once, each once.
    reading = {tag: _background(lambda tag=tag: _dist_state(os.path.join(
        tmp, f"ck_{tag}", "step_00000003"))) for tag in spawned}
    states = {}
    launches: dict = {}
    out = {"card": card, "runs_seconds": runs_s, "planted": planted}

    def train(tag):
        return [r["loss"] for r in _jsonl(os.path.join(tmp, f"{tag}.jsonl"),
                                          "train")]

    def state(tag):
        if tag not in states:
            states[tag] = reading.pop(tag)()
        return states[tag]

    for tag, (a, world, _) in spawned.items():
        cfg = cli.resolve_configs(cli.build_parser("ddp").parse_args(a),
                                  "ddp")[0]
        for r in recs[tag]:
            if world:
                stages = _mesh_flag(a, "stage")
                want = _pipe_launches(cfg, stages, r["rank"] % stages, 3,
                                      tensor=_mesh_flag(a, "tensor"))
            else:
                want = _micro_launches(cfg, 3, 1, segmented=False)
            if r["launches"] != want:
                raise AssertionError(f"pipeline: {tag} rank {r['rank']} "
                                     f"launches {r['launches']}, want "
                                     f"{want}")
            _add_launches(launches, r["launches"])

    def held(what, got_tag, want_tag, loss_bound, l2_bound):
        """Losses and the final state of ``got_tag`` against
        ``want_tag``'s, within ``loss_bound`` (relative) and ``l2_bound``
        (each leaf's relative L2); returns the worst of each."""
        got, ref = train(got_tag), train(want_tag)
        worst_loss = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        if len(got) != len(ref) or worst_loss > loss_bound:
            raise AssertionError(f"pipeline: {what}: losses {got} vs "
                                 f"{ref} (bound {loss_bound:.3e})")
        g, w = state(got_tag), state(want_tag)
        keys = [k for k in w if "/" in k]
        rel = _state_rel(g, w, keys)
        at = max(keys, key=lambda k: rel[k][1])
        if rel[at][1] > l2_bound:
            raise AssertionError(f"pipeline: {what}: {at}'s relative L2 "
                                 f"{rel[at][1]:.3e} above {l2_bound:.3e}")
        # The control: one moment with its halves swapped must fail.
        key = max((k for k in keys if "/mu/" in k), key=lambda k: w[k].size)
        d = fsdp_dim(w[key].shape, 2)
        swapped = {key: np.concatenate(np.split(g[key], 2, axis=d)[::-1],
                                       axis=d)}
        ctl = _state_rel(swapped, w, [key])[key][1]
        if ctl <= l2_bound:
            raise AssertionError(f"pipeline: {what}: the swapped-halves "
                                 f"control passed ({ctl:.3e})")
        return {"loss_rtol": worst_loss, "worst_l2": rel[at][1],
                "worst_leaf": at, "control_l2": ctl}

    def rank_line(r):
        steps = r["pipeline"]
        sent = [c.get("pp_send_bytes", 0) for c in r["step_calls"]]
        return {"rank": r["rank"], "step_ms": r["step_ms"],
                "pp_send_bytes": sent,
                "wait_s": [x["wait_s"] for x in steps],
                "in_flight": max((x["in_flight"] for x in steps), default=0),
                "peak_gb": r["peak_bytes"] / 1e9,
                "collectives": r["step_calls"][-1] if r["step_calls"]
                else {}}

    a = held("run A (12 layers, stage 4, 1F1B) vs one process", "pp_a",
             "pp_one", DIST_LOSS_RTOL, PIPE_STATE_L2)
    a["ranks"] = [rank_line(r) for r in recs["pp_a"]]
    a["one_process_step_ms"] = recs["pp_one"][0]["step_ms"]
    a["one_process_peak_gb"] = recs["pp_one"][0]["peak_bytes"] / 1e9
    out["run_a"] = a
    for r in a["ranks"]:
        log("pipeline", f"run A rank {r['rank']}: step ms "
                        f"{[round(x, 1) for x in r['step_ms']]}, pp_send "
                        f"{[round(x / 1e6, 2) for x in r['pp_send_bytes']]}"
                        f" MB a step, receive wait "
                        f"{[round(x, 3) for x in r['wait_s']]} s, in flight "
                        f"{r['in_flight']} (W {pp.window(4, 8)}), peak "
                        f"{r['peak_gb']:.2f} GB ({card})")
    log("pipeline", f"run A vs one process (step ms "
                    f"{[round(x, 1) for x in a['one_process_step_ms']]}, "
                    f"peak {a['one_process_peak_gb']:.2f} GB): losses "
                    f"within rtol {a['loss_rtol']:.3e} (bound "
                    f"{DIST_LOSS_RTOL:.0e}), worst leaf L2 "
                    f"{a['worst_l2']:.3e} at {a['worst_leaf']} (bound "
                    f"{PIPE_STATE_L2}; swapped halves {a['control_l2']:.3e}"
                    f" rejected)")
    tp = held("run pp_tp (12 layers, tensor 2 x stage 2, 1F1B) vs one "
              "process", "pp_tp", "pp_one", DIST_LOSS_RTOL, PIPE_STATE_L2)
    one_bytes = recs["pp_one"][0]["rest"][0]["params"]
    shapes = {n: tuple(p.shape) for n, p in GPT(cli.resolve_configs(
        cli.build_parser("ddp").parse_args(spawned["pp_one"][0]), "ddp")[0],
        device="meta").named_parameters()}
    specs = leaf_specs(shapes, "replicated", 1, 2, 1, 2)
    tp_rest = 4 * sum(math.prod(sp.tp_shape) for sp in specs.values())
    tp["ranks"] = []
    for r in recs["pp_tp"]:
        line = rank_line(r)
        line["params_bytes_at_rest"] = r["rest"][0]["params"]
        line["tp_bytes"] = [sum(v for k, v in c.items()
                                if k.startswith("tp_") and k.endswith("_bytes"))
                            for c in r["step_calls"]]
        if line["params_bytes_at_rest"] != tp_rest:
            raise AssertionError(f"pipeline: pp_tp rank {r['rank']}: "
                                 f"parameters at rest "
                                 f"{line['params_bytes_at_rest']} bytes, "
                                 f"want {tp_rest}")
        tp["ranks"].append(line)
        log("pipeline", f"run pp_tp rank {r['rank']} (tensor "
                        f"{r['rank'] // 2}, stage {r['rank'] % 2}): step ms "
                        f"{[round(x, 1) for x in line['step_ms']]}, params "
                        f"at rest {line['params_bytes_at_rest'] / 1e6:.1f} "
                        f"MB of one process's {one_bytes / 1e6:.1f} MB "
                        f"({line['params_bytes_at_rest'] / one_bytes:.4f}), "
                        f"pp_send "
                        f"{[round(x / 1e6, 2) for x in line['pp_send_bytes']]}"
                        f" MB and tp_* "
                        f"{[round(x / 1e6, 2) for x in line['tp_bytes']]} MB"
                        f" a step, receive wait "
                        f"{[round(x, 3) for x in line['wait_s']]} s, peak "
                        f"{line['peak_gb']:.2f} GB ({card})")
    log("pipeline", f"run pp_tp vs one process: losses within rtol "
                    f"{tp['loss_rtol']:.3e} (bound {DIST_LOSS_RTOL:.0e}), "
                    f"worst leaf L2 {tp['worst_l2']:.3e} at "
                    f"{tp['worst_leaf']} (bound {PIPE_STATE_L2}; swapped "
                    f"halves {tp['control_l2']:.3e} rejected)")
    out["run_pp_tp"] = tp
    b = {}
    bounds = (2 * a["loss_rtol"], 2 * a["worst_l2"])
    for k in ("1f1b", "interleaved"):
        b[k] = held(f"run B {k} vs GPipe", f"pp_b_{k}", "pp_b_gpipe",
                    *bounds)
        log("pipeline", f"run B {k} vs GPipe (stage 2, 4 layers, M 8, "
                        f"dropout 0.1): losses within rtol "
                        f"{b[k]['loss_rtol']:.3e}, worst leaf L2 "
                        f"{b[k]['worst_l2']:.3e} at {b[k]['worst_leaf']} "
                        f"(bounds 2x run A's: {bounds[0]:.3e}, "
                        f"{bounds[1]:.3e}; swapped halves "
                        f"{b[k]['control_l2']:.3e} rejected)")
    for k in pp.SCHEDULES:
        b.setdefault(k, {})["ranks"] = [rank_line(r)
                                        for r in recs[f"pp_b_{k}"]]
        peaks = [round(r["peak_gb"], 2) for r in b[k]["ranks"]]
        flight = [r["in_flight"] for r in b[k]["ranks"]]
        log("pipeline", f"run B {k}: rank peaks {peaks} GB, most in "
                        f"flight {flight}, step ms rank 0 "
                        f"{[round(x, 1) for x in b[k]['ranks'][0]['step_ms']]}"
                        f" ({card})")
    out["run_b"] = b
    log("pipeline", f"planted window W 2 (simulation 3 at S 2, M 8): "
                    f"refused ({planted['message']})")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    out["checks_seconds"] = time.perf_counter() - t_checks
    log("pipeline", f"runs {runs_s:.1f} s (from their start), checks "
                    f"{out['checks_seconds']:.1f} s, phase "
                    f"{out['seconds']:.1f} s")
    results["pipeline"] = out
    return out


def _pipe_planted(tmp: str, spawned) -> dict:
    """Join the planted run: every rank must exit non-zero, refusing the
    table (``pipeline.check_schedule``: a window below the in-flight
    count)."""
    _, _, procs = spawned
    msgs = []
    for out, p in procs:
        p.wait(timeout=300)
        with open(out + ".stderr") as f:
            err = f.read()
        if p.returncode == 0 or "in flight" not in err:
            raise AssertionError(f"pipeline: the planted window was not "
                                 f"refused (rc {p.returncode}): "
                                 f"{err[-2000:]}")
        msgs.append([ln for ln in err.splitlines() if "in flight" in ln][-1])
    return {"message": msgs[0].strip()[-160:]}


def phase_dist(results: dict, tmp: str, then=None) -> dict:
    """The reference's two trainers across processes on the one card. Each
    rank is a fresh process that joins its group (``RANK`` / ``WORLD_SIZE``
    given, a file rendezvous) and then calls the CLI; two ranks share
    ``cuda:0`` over gloo, every CUDA tensor staged through pinned host
    memory (NCCL refuses two ranks on one GPU). Runs that do not depend on
    each other are started together. ``small_model.yaml`` runs at 2 of its
    12 layers and ``medium_model.yaml`` at 2 of its 24 (the whole run's
    time limit):

    - world 1 over NCCL: ``small_model.yaml`` through ``train_ddp`` (4
      steps, batch 8) in an NCCL process group at rank 0 of 1: losses and
      the final state bitwise the run without a process group;
    - DDP at world 2: ``small_model.yaml`` with dropout 0, a rank batch 4,
      accumulation 1, 4 steps, against one process with batch 4 and
      accumulation 2 (the same rows a micro-batch): losses, grad norms
      and the final masters and moments bitwise; launches exact on each
      rank; a planted fault (rank 1's gradients scaled at step 1) must be
      rejected by the same loss check;
    - ZeRO-3 and ZeRO-2 at world 2: ``medium_model.yaml`` (2 of its 24
      layers, dropout 0) through ``train_fsdp --sharding FULL_SHARD`` and
      ``SHARD_GRAD_OP``, a rank batch 4, accumulation 1, 3 steps, against
      one process at batch 4 x 2: losses bitwise, grad norms within
      ``DIST_NORM_RTOL`` and every final master and moment within
      ``DIST_STATE_RTOL`` (the global norm sums the shards in another
      order; a control with one moment's rank halves swapped must fail
      it), and the two strategies' final states bitwise each other's; at
      rest a rank's
      masters + moments (``memory_allocated``) at most 0.55 x one
      process's under FULL_SHARD, its moments' bytes at most 0.55 x under
      SHARD_GRAD_OP; each rank's step ms and peak;
    - the checkpoint across world sizes: ``small_model.yaml`` (dropout
      0.1, no remat: the backward regathers the saved weights) through
      ``train_fsdp --sharding FULL_SHARD`` at world 2, 4 steps with a
      two-phase save at step 2 (``shard_world: 2``); the step-2 directory
      alone resumed at world 2 to step 4 must equal the straight run's
      step 4 bitwise (params, moments, generator), and restored at world
      1 here its state must be the stitched shards bitwise;
    - MoE, both routers, after the two groups above (``_dist_moe``).

    Two ranks time-slicing one card measure no multi-GPU speed. ``then``:
    called as the expert runs end (``_dist_expert``)."""
    import numpy as np

    from tpu_trainer_torch.parallel.sharding import fsdp_dim
    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import Trainer
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    # small_model.yaml at 2 of its 12 layers and medium_model.yaml at 2 of
    # its 24 (the whole run's time limit), their widths whole.
    small = _cut_yaml(tmp, "small_model.yaml", "l2", num_layers=2)
    small0 = _cut_yaml(tmp, "small_model.yaml", "nodrop", dropout=0.0,
                       attention_dropout=0.0, num_layers=2)
    medium0 = _cut_yaml(tmp, "medium_model.yaml", "nodrop", dropout=0.0,
                        attention_dropout=0.0, num_layers=2)
    argv, want, check_launches = _dist_tools(tmp)

    def train(tag):
        return _jsonl(os.path.join(tmp, f"{tag}.jsonl"), "train")

    launches = {}
    out = {"card": card}

    # Two groups of runs share the card; only the resume needs an earlier
    # run (the straight checkpoint run's step 2). Group 1: world 1 over
    # NCCL, the same run without a process group, the DDP and ZeRO
    # one-process baselines and the checkpoint's straight FULL_SHARD run
    # (small_model.yaml, world 2). Group 2: DDP at world 2, the planted
    # fault, ZeRO-3 and ZeRO-2 at world 2 and the resume.
    a_nccl = argv("nccl", small, 4, 8, 1)
    a_plain = argv("plain", small, 4, 8, 1)
    a_base = argv("ddp1", small0, 4, 4, 2)
    a_m1 = argv("m1", medium0, 3, 4, 2)
    a_ck = argv("ck", small, 4, 4, 1, "--sharding", "FULL_SHARD")
    a_ck[a_ck.index("--save_interval") + 1] = "2"
    t0 = time.perf_counter()
    spawned = [("nccl", _dist_spawn(tmp, "nccl", "ddp", a_nccl, 1,
                                    backend="nccl")),
               ("plain", _dist_spawn(tmp, "plain", "ddp", a_plain, 0)),
               ("ddp1", _dist_spawn(tmp, "ddp1", "ddp", a_base, 0)),
               ("m1", _dist_spawn(tmp, "m1", "fsdp", a_m1, 0)),
               ("ck", _dist_spawn(tmp, "ck", "fsdp", a_ck, 2))]
    recs = _dist_join_all(spawned)
    group1_s = time.perf_counter() - t0
    if [recs[t][0]["backend"] for t in ("nccl", "plain")] != ["nccl", None]:
        raise AssertionError(f"dist: process groups "
                             f"{[recs[t][0]['backend'] for t in recs]}")
    for tag, a in (("nccl", a_nccl), ("plain", a_plain)):
        check_launches(tag, recs[tag], want("ddp", a, 4, 1))
    check_launches("ddp1", recs["ddp1"], want("ddp", a_base, 8, 2))
    m1 = recs["m1"][0]
    check_launches("m1", [m1], want("fsdp", a_m1, 6, 2))
    straight = recs["ck"]
    check_launches("ck", straight, want("fsdp", a_ck, 4, 1))
    for r in straight:
        _add_launches(launches, r["launches"])
    if [r["loss"] for r in train("nccl")] != [r["loss"] for r in
                                              train("plain")]:
        raise AssertionError("dist: world 1 over NCCL: losses differ from "
                             "the run without a process group")

    ck_dir = os.path.join(tmp, "ck_ck")
    step2 = os.path.join(ck_dir, "step_00000002")
    meta = ckpt_lib.load_meta(step2)
    if (meta.get("format"), meta.get("shard_world")) != ("host_shards", 2):
        raise AssertionError(f"dist: step 2's meta {meta.get('format')} / "
                             f"{meta.get('shard_world')}")
    resumed_dir = os.path.join(tmp, "ck_resumed")
    os.makedirs(resumed_dir)
    shutil.copytree(step2, os.path.join(resumed_dir, "step_00000002"))
    a_res = list(a_ck)
    a_res[a_res.index("--checkpoint_dir") + 1] = resumed_dir
    a_res[a_res.index("--metrics_jsonl") + 1] = os.path.join(tmp,
                                                             "res.jsonl")
    a_res.remove("--no_auto_resume")
    a_ddp = argv("ddp2", small0, 4, 4, 1)
    a_fault = argv("fault", small0, 3, 4, 1)
    a_zero = {strategy: argv(f"m2_{strategy}", medium0, 3, 4, 1,
                             "--sharding", strategy)
              for strategy in ("FULL_SHARD", "SHARD_GRAD_OP")}
    # Group 1's final states load while group 2 runs.
    load_group1 = _background(lambda: {
        tag: _dist_state(os.path.join(tmp, f"ck_{tag}", f"step_{step:08d}"))
        for tag, step in (("nccl", 4), ("plain", 4), ("ddp1", 4),
                          ("m1", 3))})
    t0 = time.perf_counter()
    spawned = [("ddp2", _dist_spawn(tmp, "ddp2", "ddp", a_ddp, 2)),
               ("fault", _dist_spawn(tmp, "fault", "ddp", a_fault, 2,
                                     fault_rank=1)),
               ("resumed", _dist_spawn(tmp, "resumed", "fsdp", a_res, 2))]
    spawned += [(f"m2_{k}", _dist_spawn(tmp, f"m2_{k}", "fsdp", a, 2))
                for k, a in a_zero.items()]
    # ZeRO-3 with the moments in pinned host memory (--cpu_offload): the
    # same run as m2_FULL_SHARD, its final state digested, not written.
    a_off = argv("m2_off", medium0, 3, 4, 1, "--sharding", "FULL_SHARD",
                 "--cpu_offload")
    spawned.append(("m2_off", _dist_spawn(tmp, "m2_off", "fsdp", a_off, 2,
                                          extra={None: {"digests": True}})))
    recs = _dist_join_all(spawned)
    group2_s = time.perf_counter() - t0
    loaded = load_group1()
    n = _dist_equal("world 1 over NCCL", loaded.pop("nccl"),
                    loaded.pop("plain"))
    log("dist", f"world 1 over NCCL: 4 losses and {n} state arrays bitwise "
                f"the run without a process group (group 1, five runs "
                f"sharing the card: {group1_s:.1f} s)")
    out["nccl"] = {"state_arrays": n}

    # -- DDP at world 2 and the planted fault.
    ddp = recs["ddp2"]
    if [r["backend"] for r in ddp] != ["gloo", "gloo"]:
        raise AssertionError(f"dist: ddp2 backends {ddp}")
    check_launches("ddp2", ddp, want("ddp", a_ddp, 4, 1))
    for r in ddp:
        _add_launches(launches, r["launches"])

    def same_curve(tag, base, norm_rtol=0.0):
        """Losses (bitwise) and grad norms (within ``norm_rtol``) of run
        ``tag`` against ``base``'s; the worst relative difference of
        each."""
        got, ref = train(tag), train(base)
        worst = {}
        for key, rtol in (("loss", 0.0), ("grad_norm", norm_rtol)):
            g = [r[key] for r in got]
            w = [r[key] for r in ref][:len(g)]
            worst[key] = max(abs(a - b) / abs(b) for a, b in zip(g, w))
            if len(g) != len(w) or worst[key] > rtol:
                raise AssertionError(
                    f"dist: {tag}: {key} {g} vs world 1's {w} (worst rtol "
                    f"{worst[key]:.3e}, bound {rtol:.0e})")
        return worst

    same_curve("ddp2", "ddp1")
    want_state = loaded.pop("ddp1")
    got_state = _dist_state(os.path.join(tmp, "ck_ddp2", "step_00000004"))
    n = _dist_equal("DDP world 2 vs world 1 accum 2", got_state, want_state,
                    [k for k in want_state if "/" in k])
    del want_state, got_state
    wire = ddp[0]["collectives"]
    log("dist", f"DDP world 2: rank 0 put "
                f"{wire.get('reduce_scatter_bytes', 0) / 1e9:.2f} GB on the "
                f"wire in {wire.get('reduce_scatter', 0)} reduce-scatters "
                f"and {wire.get('all_gather_bytes', 0) / 1e9:.2f} GB in "
                f"{wire.get('all_gather', 0)} all-gathers over 4 steps")
    log("dist", f"DDP world 2: losses, grad norms and {n} final arrays "
                f"bitwise world 1 at accumulation 2; a rank's step ms "
                f"{[round(x, 1) for x in ddp[0]['step_ms']]}, peak "
                f"{ddp[0]['peak_bytes'] / 1e9:.2f} GB ({card}; group 2, "
                f"five runs sharing the card: {group2_s:.1f} s)")
    _must_reject("dist: rank 1's gradients scaled",
                 lambda: same_curve("fault", "ddp1"))
    out["ddp"] = {"state_arrays": n, "step_ms": [r["step_ms"] for r in ddp],
                  "peak_gb": [r["peak_bytes"] / 1e9 for r in ddp]}

    # -- ZeRO-3 and ZeRO-2 at world 2 on medium_model.yaml.
    t0 = time.perf_counter()
    readers = {k: _background(lambda k=k: _dist_state(
        os.path.join(tmp, f"ck_m2_{k}", "step_00000003"))) for k in a_zero}
    zero_states = {k: join() for k, join in readers.items()}
    m1_state = loaded["m1"]
    state_keys = [k for k in m1_state if "/" in k]
    zero = {}
    for strategy, a in a_zero.items():
        tag = f"m2_{strategy}"
        ranks = recs[tag]
        check_launches(tag, ranks, want("fsdp", a, 3, 1))
        for r in ranks:
            _add_launches(launches, r["launches"])
        worst = same_curve(tag, "m1", DIST_NORM_RTOL)
        rest1 = m1["rest"][0]
        ratios = {}
        for r in ranks:
            rest = r["rest"][0]
            ratios[r["rank"]] = {
                "allocated": rest["allocated"] / rest1["allocated"],
                "moments": rest["moments"] / rest1["moments"],
                "params": rest["params"] / rest1["params"]}
        key = "allocated" if strategy == "FULL_SHARD" else "moments"
        if any(v[key] > 0.55 for v in ratios.values()):
            raise AssertionError(f"dist: {tag}: at-rest {key} ratio "
                                 f"{ratios} above 0.55 of one process")
        zero[strategy] = {
            "losses": [r["loss"] for r in train(tag)],
            "world1_losses": [r["loss"] for r in train("m1")],
            "worst_rtol": worst, "rest_ratio": ratios,
            "rest_bytes": [r["rest"][0] for r in ranks],
            "world1_rest_bytes": rest1,
            "step_ms": [r["step_ms"] for r in ranks],
            "peak_gb": [r["peak_bytes"] / 1e9 for r in ranks],
            "world1_peak_gb": m1["peak_bytes"] / 1e9,
            "collectives": [r["collectives"] for r in ranks]}
        wire = ranks[0]["collectives"]
        log("dist", f"{strategy} world 2 (medium_model.yaml at 2 layers): "
                    f"losses "
                    f"within rtol {worst['loss']:.2e} and grad norms "
                    f"{worst['grad_norm']:.3e} of world 1; at rest a rank "
                    f"holds {ratios[0]['allocated']:.3f} of one process's "
                    f"allocation ({ratios[0]['moments']:.3f} of its "
                    f"moments); step ms rank 0 "
                    f"{[round(x, 1) for x in ranks[0]['step_ms']]}, peak "
                    f"{[round(r['peak_bytes'] / 1e9, 2) for r in ranks]} GB "
                    f"(world 1 {m1['peak_bytes'] / 1e9:.2f} GB); "
                    f"rank 0 put {wire.get('all_gather_bytes', 0) / 1e9:.2f} "
                    f"GB on the wire in {wire.get('all_gather', 0)} "
                    f"all-gathers and "
                    f"{wire.get('reduce_scatter_bytes', 0) / 1e9:.2f} GB in "
                    f"{wire.get('reduce_scatter', 0)} reduce-scatters over "
                    f"the run (3 steps and the eval) ({card})")
    # The final masters and moments: ZeRO-3 (gathers, the reduce-scatter
    # in the backward) against ZeRO-2 (whole masters) bitwise, the same
    # sums in the same order; ZeRO-3 against one process within
    # DIST_STATE_RTOL, and a control, one moment with its two rank halves
    # swapped, must fail that bound.
    full = zero_states["FULL_SHARD"]
    zero["offload"] = _dist_offload(recs["m2_off"], a_off, full, m1,
                                    same_curve, check_launches, want,
                                    launches, card)
    n = _dist_equal("FULL_SHARD vs SHARD_GRAD_OP final state", full,
                    zero_states["SHARD_GRAD_OP"], state_keys)
    state_rtol = _dist_close("FULL_SHARD final state vs world 1's", full,
                             m1_state, state_keys, DIST_STATE_RTOL)
    key = max((k for k in state_keys if "/mu/" in k),
              key=lambda k: m1_state[k].size)
    d = fsdp_dim(m1_state[key].shape, 2)
    swapped = {key: np.concatenate(np.split(full[key], 2, axis=d)[::-1],
                                   axis=d)}
    _must_reject(f"dist: {key}'s halves swapped", lambda: _dist_close(
        "control", swapped, m1_state, [key], DIST_STATE_RTOL))
    del zero_states, full, swapped, m1_state, loaded
    for v in zero.values():
        v["state_worst_rtol"] = state_rtol
    log("dist", f"ZeRO final state: FULL_SHARD's {n} masters and moments "
                f"bitwise SHARD_GRAD_OP's, within {state_rtol:.3e} of their "
                f"largest value of one process's (bound "
                f"{DIST_STATE_RTOL:.0e}; swapped halves rejected); states "
                f"read and held in {time.perf_counter() - t0:.1f} s")
    out["zero"] = zero

    # -- the checkpoint across world sizes.
    resumed = recs["resumed"]
    check_launches("resumed", resumed, want("fsdp", a_res, 2, 1))
    for r in resumed:
        _add_launches(launches, r["launches"])
    n = _dist_equal("world-2 resume from step 2", _dist_state(
        os.path.join(resumed_dir, "step_00000004")),
        _dist_state(os.path.join(ck_dir, "step_00000004")))
    cfg, tc, par, _ = cli.resolve_configs(
        cli.build_parser("fsdp").parse_args(a_ck), "fsdp")
    trainer = Trainer(cfg, tc, par, device="cuda")
    restored, _ = ckpt_lib.restore_checkpoint(step2, trainer)
    m = _dist_equal("world-1 restore of the world-2 directory",
                    restored.state_dict(), _dist_state(step2))
    del restored, trainer
    torch.cuda.empty_cache()
    ck_zero3 = straight[0]["collectives"]
    log("dist", f"checkpoint: step 2 saved at world 2 (two-phase, "
                f"shard_world 2), resumed at world 2 to step 4 with {n} "
                f"arrays bitwise the straight run, restored at world 1 "
                f"with {m} arrays bitwise the stitched shards; the "
                f"straight ZeRO-3 run without remat kept "
                f"{ck_zero3.get('regather_saved', 0)} saved weights as "
                f"regather recipes, rank peak "
                f"{[round(r['peak_bytes'] / 1e9, 2) for r in straight]} GB")
    out["checkpoint"] = {"arrays": n, "regather_saved":
                         ck_zero3.get("regather_saved", 0),
                         "peak_gb": [r["peak_bytes"] / 1e9
                                     for r in straight]}
    # Groups 1 and 2's checkpoints are read: free the disk for group 3.
    for name in os.listdir(tmp):
        if name.startswith("ck_"):
            shutil.rmtree(os.path.join(tmp, name))
    out["moe"] = _dist_moe(tmp, argv, want, check_launches, launches, card,
                           then)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("dist", f"phase {out['seconds']:.1f} s")
    results["dist"] = out
    return out


# World-rest phase: the telemetry record at world 2 against one process
# at the same global batch, in f32 with TF32 off. The ranks' sums of
# squares, maxima and mean router probabilities add in another order than
# one process's reductions, and a rank's GEMMs run half the rows (the CPU
# tests hold the same at 1e-5 on the tiny model).
WORLD_REST_TEL_RTOL = 1e-4


def phase_world_rest(results: dict, tmp: str) -> dict:
    """The rest of world > 1 training on the card, ranks sharing
    ``cuda:0`` over gloo as in the dist phase (``_dist_spawn``), on
    ``small_model.yaml`` (2 of its 12 layers, dropout 0, the clip off):

    - int8 Adam moments under ``SHARD_GRAD_OP`` at world 2 (a rank batch
      4, 3 steps) against one process at accumulation 2: the final packs,
      masters and f32 moments bitwise (the embedding's and q/k/v/o's
      slices cut a 256-block: the straddling block's scale is the
      group's); a control with one int8 code flipped must fail; the
      world-2 checkpoint restored at world 1 here, bitwise the stitched
      shards;
    - the preemption vote: the same run with a SIGTERM to rank 1 alone at
      step 1 (``--preempt_vote_interval 1``): both ranks save
      ``"preempt"`` at step 2 and exit 143; resumed at world 2, step 3
      bitwise the straight run's;
    - one telemetry step (``FULL_SHARD``, f32, 2 steps) at world 2
      against one process at the same global batch: the same keys on
      both ranks, every value within ``WORLD_REST_TEL_RTOL``; the
      telemetry collectives a step;
    - ``--nan_scan`` with a NaN planted in rank 1's first row at layer
      1's input (one process: the same row of the global batch): both
      ranks name layer 1's attention, as one process does.

    Every run is launched as a user would (the CLI) and reads its launch
    counts, which the ``kernels`` line adds; the runs that hold no
    checkpoint check digest their final state instead of writing it."""
    from tpu_trainer_torch.training import cli
    from tpu_trainer_torch.training.trainer import Trainer
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    small0 = _cut_yaml(tmp, "small_model.yaml", "wr", dropout=0.0,
                       attention_dropout=0.0, grad_clip=1e9, num_layers=2)
    common = ["--log_interval", "1", "--eval_interval", "0",
              "--eval_batches", "1", "--keep_last_n", "0",
              "--no_auto_resume"]

    def argv(tag, steps, bs, accum, *extra):
        return (["--config", small0, "--max_steps", str(steps),
                 "--batch_size", str(bs), "--grad_accum", str(accum),
                 "--save_interval", "0",
                 "--checkpoint_dir", os.path.join(tmp, f"ck_{tag}"),
                 "--metrics_jsonl", os.path.join(tmp, f"{tag}.jsonl")]
                + common + list(extra))

    def want(a, micro, eval_micro):
        cfg = cli.resolve_configs(cli.build_parser("fsdp").parse_args(a),
                                  "fsdp")[0]
        w = _micro_launches(cfg, micro, eval_micro, segmented=False)
        if "fp32" in a:
            # The head + CE kernel takes bf16 only; f32 runs the chunked
            # loss (ops/loss.py).
            w["head_ce"] = 0
        return w

    launches = {}

    def check_launches(tag, recs, expect):
        for r in recs:
            if r["launches"] != expect:
                raise AssertionError(f"world-rest: {tag} rank {r['rank']} "
                                     f"launches {r['launches']}, want "
                                     f"{expect}")
            _add_launches(launches, r["launches"])

    q = ["--sharding", "SHARD_GRAD_OP", "--optimizer_state_dtype", "int8",
         "--preempt_vote_interval", "1"]
    f32 = ["--sharding", "FULL_SHARD", "--mixed_precision", "fp32"]
    a = {"q1": argv("q1", 3, 4, 2, *q), "q2": argv("q2", 3, 4, 1, *q),
         "qcut": argv("qcut", 3, 4, 1, *q),
         "t1": argv("t1", 2, 4, 1, *f32, "--telemetry_interval", "2"),
         "t2": argv("t2", 2, 2, 1, *f32, "--telemetry_interval", "2"),
         "n1": argv("n1", 1, 4, 1, *f32, "--nan_scan"),
         "n2": argv("n2", 1, 2, 1, *f32, "--nan_scan")}
    digest = {None: {"digests": True}}
    t0 = time.perf_counter()
    spawned = [
        ("q1", _dist_spawn(tmp, "q1", "fsdp", a["q1"], 0)),
        ("q2", _dist_spawn(tmp, "q2", "fsdp", a["q2"], 2)),
        ("qcut", _dist_spawn(tmp, "qcut", "fsdp", a["qcut"], 2, extra={
            1: {"argv": ["--inject_fault", "sigterm@1"]}})),
        ("t1", _dist_spawn(tmp, "t1", "fsdp", a["t1"], 0, extra=digest)),
        ("t2", _dist_spawn(tmp, "t2", "fsdp", a["t2"], 2, extra=digest)),
        ("n1", _dist_spawn(tmp, "n1", "fsdp", a["n1"], 0,
                           extra={None: {"plant": [1, 2]}})),
        ("n2", _dist_spawn(tmp, "n2", "fsdp", a["n2"], 2,
                           extra={1: {"plant": [1, 0]}}))]
    recs = _dist_join_all(spawned)
    group1_s = time.perf_counter() - t0
    for tag in ("q1", "q2", "t1", "t2", "n1", "n2"):
        if any(r["rc"] != 0 for r in recs[tag]):
            raise AssertionError(f"world-rest: {tag} exit codes "
                                 f"{[r['rc'] for r in recs[tag]]}")
    if [r["backend"] for r in recs["q2"]] != ["gloo", "gloo"]:
        raise AssertionError(f"world-rest: q2 backends "
                             f"{[r['backend'] for r in recs['q2']]}")
    # Eval runs a batch as the step's micro-batches: 2 for q1.
    check_launches("q1", recs["q1"], want(a["q1"], 6, 2))
    check_launches("q2", recs["q2"], want(a["q2"], 3, 1))
    check_launches("t1", recs["t1"], want(a["t1"], 2, 1))
    check_launches("t2", recs["t2"], want(a["t2"], 2, 1))
    check_launches("n1", recs["n1"], want(a["n1"], 0, 1))
    check_launches("n2", recs["n2"], want(a["n2"], 0, 1))
    out = {"card": card, "group_seconds": group1_s}

    # -- the preemption vote: resume the cut run at world 2.
    cut = recs["qcut"]
    if [r["rc"] for r in cut] != [143, 143]:
        raise AssertionError(f"world-rest: SIGTERM to rank 1: exit codes "
                             f"{[r['rc'] for r in cut]}, want 143 on both")
    cut_dir = os.path.join(tmp, "ck_qcut")
    saved = [st for st, _ in ckpt_lib.list_checkpoints(cut_dir)]
    meta = ckpt_lib.load_meta(os.path.join(cut_dir, "step_00000002"))
    if saved != [2] or meta.get("shard_world") != 2:
        raise AssertionError(f"world-rest: SIGTERM to rank 1 saved {saved} "
                             f"(shard_world {meta.get('shard_world')})")
    for r in cut:
        _add_launches(launches, r["launches"])
    a_res = list(a["qcut"])
    a_res.remove("--no_auto_resume")
    a_res[a_res.index("--metrics_jsonl") + 1] = os.path.join(tmp,
                                                             "qres.jsonl")
    t0 = time.perf_counter()
    res = _dist_join_all([("qres", _dist_spawn(tmp, "qres", "fsdp", a_res,
                                               2))])["qres"]
    resume_s = time.perf_counter() - t0
    check_launches("qres", res, want(a_res, 1, 1))
    q2_state = _dist_state(os.path.join(tmp, "ck_q2", "step_00000003"))
    n_res = _dist_equal("SIGTERM to rank 1, resumed at world 2, vs the "
                        "straight run", _dist_state(
                            os.path.join(cut_dir, "step_00000003")),
                        q2_state)
    log("world-rest", f"SIGTERM to rank 1 at step 1: both ranks saved "
                      f"'preempt' at step 2 and exited 143; resumed at "
                      f"world 2, step 3's {n_res} arrays bitwise the "
                      f"straight run's (resume {resume_s:.1f} s)")
    out["vote"] = {"arrays": n_res, "resume_seconds": resume_s}

    # -- int8 moments on shards against one process.
    q1_state = _dist_state(os.path.join(tmp, "ck_q1", "step_00000003"))
    keys = [k for k in q1_state if "/" in k]
    packs = [k[:-len("/q")] for k in keys if k.endswith("/q")]
    n = _dist_equal("int8 SHARD_GRAD_OP world 2 vs world 1", q2_state,
                    q1_state, keys)
    emb = "opt_state/nu/embed_tokens/embedding"
    flipped = dict(q2_state)
    flipped[f"{emb}/q"] = q2_state[f"{emb}/q"].copy()
    flipped[f"{emb}/q"].flat[383] ^= 1     # the block 256..512 both hold
    _must_reject("world-rest: one int8 code flipped", lambda: _dist_equal(
        "control", flipped, q1_state, [f"{emb}/q"]))
    del flipped
    cfg, tc, par, _ = cli.resolve_configs(
        cli.build_parser("fsdp").parse_args(a["q1"]), "fsdp")
    trainer = Trainer(cfg, tc, par, device="cuda")
    restored, _ = ckpt_lib.restore_checkpoint(
        os.path.join(tmp, "ck_q2", "step_00000003"), trainer)
    m = _dist_equal("world-1 restore of the int8 world-2 checkpoint",
                    restored.state_dict(), q2_state, keys)
    del restored, trainer, q1_state, q2_state
    torch.cuda.empty_cache()
    wire = recs["q2"][0]["collectives"]
    log("world-rest", f"int8 moments, SHARD_GRAD_OP world 2: {n} arrays "
                      f"({len(packs)} int8 packs) bitwise one process at "
                      f"accumulation 2 (a flipped code rejected); the "
                      f"world-2 checkpoint restored at world 1 with {m} "
                      f"arrays bitwise; rank 0 ran "
                      f"{wire.get('quant_absmax', 0)} block-max "
                      f"all-gathers ({wire.get('quant_absmax_bytes', 0) / 1e6:.2f}"
                      f" MB) over 3 steps; step ms rank 0 "
                      f"{[round(x, 1) for x in recs['q2'][0]['step_ms']]}, "
                      f"one process "
                      f"{[round(x, 1) for x in recs['q1'][0]['step_ms']]} "
                      f"({card}; {group1_s:.1f} s for the group's 11 "
                      f"processes sharing the card)")
    out["int8"] = {"arrays": n, "packs": len(packs), "restored": m,
                   "quant_absmax": wire.get("quant_absmax", 0),
                   "step_ms": [r["step_ms"] for r in recs["q2"]],
                   "world1_step_ms": recs["q1"][0]["step_ms"]}

    # -- one telemetry step against one process.
    want_tel, = recs["t1"][0]["telemetry"]
    worst, at = 0.0, None
    for r in recs["t2"]:
        got, = r["telemetry"]
        if sorted(got) != sorted(want_tel):
            raise AssertionError(f"world-rest: rank {r['rank']}'s telemetry "
                                 f"keys differ: "
                                 f"{sorted(set(got) ^ set(want_tel))[:6]}")
        for k, v in want_tel.items():
            rel = abs(got[k] - v) / max(abs(v), 1e-6)
            if rel > worst:
                worst, at = rel, k
    if worst > WORLD_REST_TEL_RTOL:
        raise AssertionError(f"world-rest: telemetry {at}: relative "
                             f"difference {worst:.3e} above "
                             f"{WORLD_REST_TEL_RTOL:.0e}")
    if recs["t2"][0]["telemetry"] != recs["t2"][1]["telemetry"]:
        raise AssertionError("world-rest: the ranks' telemetry records "
                             "differ")
    tel_wire = recs["t2"][0]["collectives"]
    log("world-rest", f"telemetry step, FULL_SHARD world 2 (f32): "
                      f"{len(want_tel)} scalars on both ranks within "
                      f"{worst:.3e} of one process's (bound "
                      f"{WORLD_REST_TEL_RTOL:.0e}, at {at}); "
                      f"{tel_wire.get('telemetry', 0)} stat all-gather"
                      f"(s) of {tel_wire.get('telemetry_bytes', 0)} bytes "
                      f"a rank; step ms rank 0 "
                      f"{[round(x, 1) for x in recs['t2'][0]['step_ms']]} "
                      f"(the second the telemetry step)")
    out["telemetry"] = {"scalars": len(want_tel), "worst_rtol": worst,
                        "collectives": tel_wire,
                        "step_ms": [r["step_ms"] for r in recs["t2"]]}

    # -- nan_scan with a NaN in rank 1's rows.
    want_nan = recs["n1"][0]["nan"][0]
    if want_nan["first_nan"] != {"site": "attn", "layer": 1}:
        raise AssertionError(f"world-rest: one process's nan_scan names "
                             f"{want_nan['first_nan']}")
    for r in recs["n2"]:
        got = r["nan"][0]
        if (got["first_nan"], got["sites"]) != (want_nan["first_nan"],
                                                want_nan["sites"]):
            raise AssertionError(f"world-rest: rank {r['rank']}'s nan_scan "
                                 f"names {got['first_nan']} "
                                 f"({got['sites']}), one process "
                                 f"{want_nan['first_nan']}")
    log("world-rest", f"nan_scan, NaN in rank 1's rows at layer 1: both "
                      f"ranks name {want_nan['first_nan']} and the same "
                      f"{len(want_nan['sites'])} non-finite sites as one "
                      f"process")
    out["nan_scan"] = {"first_nan": want_nan["first_nan"],
                       "sites": len(want_nan["sites"])}
    for name in os.listdir(tmp):
        if name.startswith("ck_"):
            shutil.rmtree(os.path.join(tmp, name))
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    log("world-rest", f"phase {out['seconds']:.1f} s")
    results["world-rest"] = out
    return out


def _blame_every_stale(sup, children, started):
    """A planted fault: a supervisor that blames every stale host, not
    only the earliest flatline."""
    from tpu_trainer_torch.utils import flight_recorder as flight_lib

    now, deaths = time.time(), []
    for c in children:
        beat = flight_lib.read_heartbeat(sup._hb_dir(), c.host)
        if beat is not None and now - beat["unix"] > sup.heartbeat_timeout_s:
            deaths.append({"host": c.host, "cause": "heartbeat_timeout"})
    return deaths


def _flatline_blame(check) -> list:
    """The deaths ``check(supervisor, children, started)`` finds in a
    heartbeat dir where host 1 went silent first and host 0's beats went
    stale after it (it waits in a collective with host 1): must be host 1
    alone."""
    from tpu_trainer_torch.training import elastic

    d = tempfile.mkdtemp(prefix="chip_smoke_blame_")
    try:
        sup = elastic.Supervisor([], num_processes=2, run_dir=d, env={},
                                 heartbeat_timeout_s=5.0)
        hb = sup._hb_dir()
        os.makedirs(hb)
        now = time.time()
        for host, age in ((0, 20.0), (1, 30.0)):
            with open(os.path.join(hb, f"heartbeat_host{host:05d}.jsonl"),
                      "w") as f:
                f.write(json.dumps({"kind": "heartbeat", "host": host,
                                    "step": 9 - host, "unix": now - age})
                        + "\n")

        class Child:
            def __init__(self, host):
                self.host = host

            def poll(self):
                return None
        deaths = check(sup, [Child(0), Child(1)], now - 60)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if [x["host"] for x in deaths] != [1]:
        raise AssertionError(f"elastic: blamed {deaths}, want host 1 alone")
    return deaths


def _resumed_step(log_path: str) -> int:
    with open(log_path) as f:
        m = re.search(r"resumed from \S+ at step (\d+)", f.read())
    if m is None:
        raise AssertionError(f"elastic: {log_path} did not resume")
    return int(m.group(1))


def phase_elastic(results: dict, tmp: str) -> dict:
    """The elastic supervisor as a user launches it: ``python -m
    tpu_trainer_torch.training.elastic --num_processes 2 --allow_grow``
    over ``train_ddp`` on ``small_model.yaml``'s width (768) at 2 of its
    12 layers, a rank batch 4, 12 steps, synchronous saves every 4; its
    two ranks share ``cuda:0`` over gloo (more ranks than cards:
    ``parallel/mesh.shares_card``), the shrunk world-1 attempt runs over
    NCCL. The chain: ``kill_host@5`` (rank 1 dies) shrinks the run to
    world 1, which resumes from the committed step-4 checkpoint;
    ``return_host@6`` grants a host back and the supervisor drains the
    world-1 attempt (its SIGTERM checkpoint) and grows to world 2, which
    finishes. Checked in ``supervisor.jsonl``: the death (host 1,
    ``exit:137``), the recovery (2 -> 1, ``recovery_seconds``), the grow
    (1 -> 2, ``grow_seconds``, nothing rolled back), the summary (1
    restart, 1 grow, world 2, exit 0); every step's loss logged and
    finite; the final step-12 state bitwise a replay of the same segments
    without the supervisor (world 1 from the step-4 checkpoint to the
    drain step, in this process, then world 2 to step 12), each segment
    at the global batch of its world. Then a second run for
    ``hang_host@3`` with ``--max_restarts 0``: exactly one death, host 1,
    ``heartbeat_timeout``, its last beat at step 3. A planted fault, a
    supervisor that blames every stale host instead of the earliest
    flatline, must be rejected. Prints the recovery and grow times with
    the card's name and power limit."""
    from tpu_trainer_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    yaml = _cut_yaml(tmp, "small_model.yaml", "el", num_layers=2)
    _flatline_blame(lambda sup, ch, t: sup._check_deaths(ch, t))
    _must_reject("elastic: a supervisor that blames every stale host",
                 lambda: _flatline_blame(_blame_every_stale))

    def supervise(tag, sup_args, trainer_args):
        run_dir = os.path.join(tmp, f"el_{tag}")
        cmd = ([sys.executable, "-m", "tpu_trainer_torch.training.elastic",
                "--num_processes", "2", "--run_dir", run_dir,
                "--startup_grace_s", "300", "--coordinator_timeout_s", "120",
                "--term_grace_s", "2", "--death_settle_s", "0.5"]
               + sup_args + ["--", "--config", yaml, "--batch_size", "4",
                             "--grad_accum", "1", "--eval_interval", "0",
                             "--keep_last_n", "0",
                             "--checkpoint_dir",
                             os.path.join(run_dir, "ckpt")] + trainer_args)
        so = open(os.path.join(tmp, f"el_{tag}.out"), "w")
        return run_dir, so, subprocess.Popen(cmd, cwd=ROOT, stdout=so,
                                             stderr=subprocess.STDOUT)

    def finish(tag, so, proc, rc_want, timeout):
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            so.close()
        with open(os.path.join(tmp, f"el_{tag}.out")) as f:
            text = f.read()
        for ln in text.splitlines():
            if ln.startswith("elastic |"):
                log("elastic", f"  {tag} | {ln}")
        if rc != rc_want:
            raise AssertionError(f"elastic: {tag} supervisor exited {rc}, "
                                 f"want {rc_want}: {text[-3000:]}")

    t0 = time.perf_counter()
    run_dir, so, proc = supervise(
        "chain", ["--allow_grow", "--grow_probe_interval_s", "0.2",
                  "--heartbeat_timeout_s", "60", "--max_restarts", "2"],
        ["--max_steps", "12", "--save_interval", "4", "--log_interval", "1",
         "--no_async_checkpointing",
         "--inject_fault", "kill_host@5,return_host@6"])
    finish("chain", so, proc, 0, 400)
    chain_s = time.perf_counter() - t0
    ledger = os.path.join(run_dir, "supervisor.jsonl")
    deaths = _jsonl(ledger, "host_death")
    recs = _jsonl(ledger, "recovery")
    grows = _jsonl(ledger, "world_grow")
    summary = _jsonl(ledger, "elastic_summary")
    if [(d["host"], d["cause"]) for d in deaths] != [(1, "exit:137")]:
        raise AssertionError(f"elastic: deaths {deaths}")
    if len(recs) != 1 or (recs[0]["world_before"],
                          recs[0]["world_after"]) != (2, 1):
        raise AssertionError(f"elastic: recoveries {recs}")
    if len(grows) != 1 or (grows[0]["world_before"],
                           grows[0]["world_after"],
                           grows[0]["rolled_back_steps"]) != (1, 2, 0):
        raise AssertionError(f"elastic: grows {grows}")
    if not summary or (summary[-1]["restarts"], summary[-1]["grows"],
                       summary[-1]["final_world"],
                       summary[-1]["exit_code"]) != (1, 1, 2, 0):
        raise AssertionError(f"elastic: summary {summary}")
    losses = {}
    for path in sorted(os.path.join(run_dir, n) for n in os.listdir(run_dir)
                       if n.startswith("host") and n.endswith(".log")):
        with open(path) as f:
            for m in re.finditer(r"step\s+(\d+) \| loss ([0-9.eE+-]+|nan)",
                                 f.read()):
                losses[int(m.group(1))] = float(m.group(2))
    if set(range(12)) - set(losses) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"elastic: logged losses {losses}")
    s1 = _resumed_step(os.path.join(run_dir, "host0_attempt1.log"))
    s2 = _resumed_step(os.path.join(run_dir, "host0_attempt2.log"))
    if s1 != 4 or not 6 < s2 < 12:
        raise AssertionError(f"elastic: resumed at steps {s1} and {s2}")
    final = os.path.join(run_dir, "ckpt", "step_00000012")
    if ckpt_lib.load_meta(final).get("shard_world") != 2:
        raise AssertionError("elastic: step 12 not saved at world 2")

    # The replay: world 1 from the step-4 checkpoint to s2 here, then
    # world 2 to step 12; meanwhile the hang run.
    rep = os.path.join(tmp, "el_replay")
    os.makedirs(rep)
    shutil.copytree(os.path.join(run_dir, "ckpt", "step_00000004"),
                    os.path.join(rep, "step_00000004"))
    a_rep = ["--config", yaml, "--batch_size", "4", "--grad_accum", "1",
             "--eval_interval", "0", "--keep_last_n", "0",
             "--log_interval", "1", "--checkpoint_dir", rep,
             "--save_interval", "4", "--no_async_checkpointing",
             "--max_steps", "12"]
    hang_dir, hso, hproc = supervise(
        "hang", ["--heartbeat_timeout_s", "10", "--max_restarts", "0"],
        ["--max_steps", "100000", "--save_interval", "100000",
         "--log_interval", "1000", "--inject_fault", "hang_host@3"])
    launches = {}
    # The world-1 segment stops as the drained attempt did (a SIGTERM at
    # the top of step s2 - 1, its checkpoint at s2), so its schedule is
    # the 12-step run's.
    one = _cli_in_process("elastic", a_rep + [
        "--inject_fault", f"sigterm@{s2 - 1}"], rc_want=143)
    _add_launches(launches, one["launches"])
    two = _dist_join_all([("replay", _dist_spawn(
        tmp, "replay", "ddp", a_rep, 2))])["replay"]
    for r in two:
        if r["rc"] != 0:
            raise AssertionError(f"elastic: replay rank {r['rank']} exited "
                                 f"{r['rc']}")
        _add_launches(launches, r["launches"])
    n = _dist_equal("the elastic chain's step 12 vs the replay",
                    _dist_state(final),
                    _dist_state(os.path.join(rep, "step_00000012")))
    finish("hang", hso, hproc, 1, 300)
    hdeaths = _jsonl(os.path.join(hang_dir, "supervisor.jsonl"),
                     "host_death")
    if [(d["host"], d["cause"], d.get("step_last_beat"))
            for d in hdeaths] != [(1, "heartbeat_timeout", 3)]:
        raise AssertionError(f"elastic: hang run deaths {hdeaths}")
    rec_s, grow_s = recs[0]["recovery_seconds"], grows[0]["grow_seconds"]
    log("elastic", f"kill_host@5 -> world 1 resumed at step {s1} "
                   f"(recovery {rec_s:.2f} s, {recs[0]['rolled_back_steps']} "
                   f"step(s) rolled back), return_host@6 -> world 2 resumed "
                   f"at step {s2} (grow {grow_s:.2f} s, 0 rolled back); "
                   f"every step's loss finite; step 12's {n} arrays bitwise "
                   f"the replay of the same segments; chain "
                   f"{chain_s:.1f} s; hang_host@3 caught by the heartbeat "
                   f"timeout (host 1, last beat step 3); a supervisor "
                   f"blaming every stale host rejected ({card})")
    for name in os.listdir(tmp):
        if name.startswith("el_"):
            shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
    out = {"card": card, "recovery_seconds": rec_s, "grow_seconds": grow_s,
           "resumed_at": [s1, s2], "chain_seconds": chain_s,
           "arrays_bitwise": n, "launches": launches,
           "losses": [losses[k] for k in sorted(losses)],
           "seconds": time.perf_counter() - t_phase}
    log("elastic", f"phase {out['seconds']:.1f} s")
    results["elastic"] = out
    return out


def _beside_child(tmp: str, out: str) -> None:
    """The world-rest and elastic phases, one after the other, in this
    fresh process (the kernels come from the card phase's build
    directory), in directory ``tmp``; their records and seconds are
    written to ``out``. They share the host's cores with ft and are
    bound by them, so running two of them at once saves little (on an
    H100 80GB HBM3 at 700 W, elastic beside mesh-ranks ran 149.5 s, 119.4
    s alone), and world-rest's ranks and mesh-ranks' together beside ft
    ran that card out of memory; mesh-ranks runs last, its ranks beside
    the pipeline phase's checks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"phase_seconds": {}}
    for name, fn in (("world-rest", phase_world_rest),
                     ("elastic", phase_elastic)):
        t = time.perf_counter()
        fn(results, tmp)
        results["phase_seconds"][name] = time.perf_counter() - t
    with open(out, "w") as f:
        json.dump(results, f)


def _beside(tmp: str):
    """``_beside_child`` started in a process of its own (a session of its
    own, so that the ranks and supervisors it starts stop with it), to run
    beside the ft phase, which keeps one or two processes on the card and
    the host. Returns ``join(kill=False)``, which waits for it (or kills
    it), prints its log and returns its results."""
    import signal

    d = os.path.join(tmp, "beside")
    os.makedirs(d)
    out, log_path = os.path.join(d, "results.json"), os.path.join(d, "log")
    code = f"import chip_smoke; chip_smoke._beside_child({d!r}, {out!r})"
    with open(log_path, "w") as so:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=so, stderr=subprocess.STDOUT,
                                start_new_session=True)

    def join(kill: bool = False):
        try:
            rc = None if kill else proc.wait(timeout=900)
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            with open(log_path) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()
        if kill:
            return None
        if rc != 0:
            raise AssertionError(f"world-rest / elastic: their process "
                                 f"exited {rc}")
        with open(out) as f:
            return json.load(f)
    return join


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
    secs = results["phase_seconds"] = {}

    def run(name, fn, *a, **k):
        """``fn(results, *a, **k)``, its seconds kept under ``name``."""
        t = time.perf_counter()
        out = fn(results, *a, **k)
        secs[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
        return out

    run("card", phase_card)
    main_row = run("kernel", phase_kernel)
    run("reference", phase_reference)
    launches, engine = run("engine", phase_engine, kv_int8=False)
    run("profile", profile_engine, engine)
    del engine
    run("int8", phase_engine, kv_int8=True)
    spec = run("spec", phase_spec)
    kvs = run("kv-store", phase_kv_store)
    fleet = run("fleet", phase_fleet)
    tpd = run("tp-decode", phase_tp_decode)
    train_k = run("train-kernel", phase_train_kernel)
    mask = run("mask", phase_mask)
    split = run("train-split", phase_train_split)
    run("mesh", phase_mesh)
    grouped = run("gmm", phase_gmm)
    run("train-reference", phase_train_reference)
    run("train-grads", phase_train_grads)
    train_launches = run("train", phase_train)
    packed_launches = run("train-packed", phase_train_packed)
    run("moe-grads", phase_train_grads, moe=True)
    moe_launches = run("train-moe", phase_train_moe)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        run("cli", phase_cli, tmp)
        run("infer", phase_infer, tmp)
        run("remat", phase_remat, tmp)
        run("offload", phase_offload, tmp)
        run("moe-remat", phase_moe_remat, tmp)
        mc = run("moe-capacity", phase_moe_capacity, tmp)
        # The world-rest and elastic phases run in a process of their own
        # beside ft (the whole run's time limit); dist after them.
        join_beside = _beside(tmp)
        try:
            ft = run("ft", phase_ft, tmp)
        except BaseException:
            join_beside(kill=True)
            raise
        beside = join_beside()
        rest = results["world-rest"] = beside["world-rest"]
        el = results["elastic"] = beside["elastic"]
        secs.update(beside["phase_seconds"])
        # The pipeline phase's runs start as dist's expert runs end, the
        # mesh-ranks phase's as the pipeline's end (each beside the
        # earlier runs' checks, which read states on the host).
        later = {}
        try:
            dist = run("dist", phase_dist, tmp, then=lambda: later.update(
                pipeline=_pipe_spawn(tmp, _dist_tools(tmp)[0])))
        except BaseException:
            _kill_spawned([(t, v[2]) for t, v in
                           later.get("pipeline", {}).items() if t != "t0"])
            raise
        try:
            pipe = run("pipeline", phase_pipeline, tmp,
                       started=later.get("pipeline"),
                       then=lambda: later.update(
                           mesh=_mesh_ranks_spawn(tmp)))
        except BaseException:
            _kill_spawned(later.get("mesh", {}).get("spawned", []))
            raise
        mr = run("mesh-ranks", phase_mesh_ranks, tmp,
                 started=later.get("mesh"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["expert"] = dist["moe"]["expert"]
    log("done", "phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + " (world-rest and elastic beside ft; the pipeline runs beside "
        "dist's expert checks, the mesh-ranks runs beside the pipeline's "
        "checks); of dist, "
        f"expert {results['expert']['seconds']:.1f}")

    max_err = max(results["kernel_max_abs_err"],
                  results["engine"]["live_step_max_abs_err"],
                  results["int8"]["live_step_max_abs_err"],
                  spec["max_abs_err"], tpd["kernel"]["window_max_abs_err"])
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

    # The moe-capacity, ft, dist (expert included), world-rest, elastic
    # and mesh-ranks phases' paths launch the training kernels too
    # (mesh-ranks and expert: the ring's chunks under sequence, a rank's
    # head slice of attention under tensor; expert: gmm and tgmm on a
    # rank's experts): each row counts its main path's launches plus theirs
    # (and flash_decode's the moe-capacity engine's and the spec and
    # kv-store phases' engines and draft models', the fleet phase's
    # in-process replicas and worker processes, and the tp-decode phase's
    # sharded engines and worker: tp launches a layer a decode step).
    ftl = dict(ft["launches"])
    _add_launches(ftl, dist["launches"])
    _add_launches(ftl, pipe["launches"])
    _add_launches(ftl, rest["launches"])
    _add_launches(ftl, el["launches"])
    _add_launches(ftl, mr["launches"])
    _add_launches(ftl, mc["launches"])
    launches += (mc["engine"]["launches"] + spec["launches"]
                 + kvs["launches"] + fleet["launches"] + tpd["launches"])
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
