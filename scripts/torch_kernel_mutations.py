#!/usr/bin/env python3
"""Mutation checks of the port's hand-written CUDA kernels, its
collectives, its pipeline and its serving fleet, on the card.

For each named mutation: copy the port (``tpu_trainer_torch/``,
``configs/`` and ``chip_smoke.py``) into a temporary directory, plant one
fault into a source there, and run the ``chip_smoke.py`` phase that must
catch it.
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
- ``bwd_prep_ignores_dlse``: the backwards' pre-pass (``bwd_prep_kernel``)
  leaves the lse cotangent out of delta; phase ``mesh`` must fail.
- ``bwd_prep_ignores_dlse_ring``: the same fault, which the training runs
  under a ``sequence`` axis meet through the ring's recombination; phase
  ``mesh_ranks`` must fail on their losses or final state.
- ``gmm_tail_rows_unwritten``: gmm leaves the rows past its last group
  (``offsets[E]``) unwritten instead of zero; only an expert rank's
  dropless layer has such rows (the other ranks' experts' token-choices
  sort after its own); phase ``gmm`` must fail (its local-experts case,
  on NaN-filled memory: the expert phase's end-to-end run did not catch
  it, its buffers holding zeros there).
- ``sum_skips_last_rank``: the collectives' rank-order sum
  (``parallel/collectives.py::_ordered_sum``) leaves out the last rank's
  part; phase ``dist`` must fail.
- ``pp_stage_sum_skipped``: under a stage axis the trainer leaves the
  replicated leaves' partial gradients (the tied embedding's lookup on
  stage 0, its head on the last stage or on every rank's vocabulary
  slice, the final norm) unsummed over the stage group; phase
  ``pipeline`` must fail.
- ``pp_head_partial_cotangent``: the 1F1B head hands the last stage its
  own vocabulary slice's cotangent instead of the sum over the stage
  group; phase ``pipeline`` must fail.
- ``fleet_mirror_drops_token``: ``RemoteReplica``'s mirror drops the last
  token of every step delta; phase ``fleet`` must fail (run B against
  the in-process fleet).
- ``fleet_resubmit_stale_cursor``: a worker restarts a resubmitted
  request's delta cursor at 0 instead of its generated count, so a
  failed-over request's mirror is sent its tokens again; phase ``fleet``
  must fail (run C). (The request's prefill cursors, status and slot that
  a failover also resets are overwritten by the survivor's admission, so
  a fault there would change nothing.)
- ``fleet_resubmit_wrong_seed``: a request that crosses the wire with
  tokens already generated (a failover's resubmit) samples under another
  seed; phase ``fleet`` must fail (run C's sampled rows, each draw held to
  the f32 model's scores under the sampler's own noise).
- ``fleet_router_ignores_affinity``: the router sends a request with a
  full prompt block to the least-loaded replica instead of its
  rendezvous; phase ``fleet`` must fail (run A's prefix groups split).
- ``decode_ignores_kv_head_base``: flash-decode reads kv head ``ikv`` of
  the pool instead of ``kv_head_base + ikv``, so a tensor-parallel shard
  of a replicated pool reads the first kv head; phase ``tp_decode`` must
  fail.
- ``tp_shards_reversed``: ``paged_attention_sharded`` concatenates the
  shards' head slices in reverse order; phase ``tp_decode`` must fail.
- ``tp_pool_write_shard0_only``: a sharded replica's attention writes
  the new K/V to shard 0's pools only; phase ``tp_decode`` must fail.
- ``tp_read_block_shard0``: a sharded replica's ``read_block`` returns
  shard 0's kv heads alone; phase ``tp_decode`` must fail (its blocks'
  ``KVB1`` frames against one device's).

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
    "bwd_prep_ignores_dlse": (
        "tpu_trainer_torch/csrc/flash_attn.cu",
        "if (dlse != nullptr && sp < s) acc -= dlse[bh * s + sp];",
        "if (dlse != nullptr && sp < 0) acc -= dlse[bh * s + sp];",
        "mesh"),
    "bwd_prep_ignores_dlse_ring": (
        "tpu_trainer_torch/csrc/flash_attn.cu",
        "if (dlse != nullptr && sp < s) acc -= dlse[bh * s + sp];",
        "if (dlse != nullptr && sp < 0) acc -= dlse[bh * s + sp];",
        "mesh_ranks"),
    "gmm_tail_rows_unwritten": (
        "tpu_trainer_torch/csrc/grouped_matmul.cu",
        "if (m_end > used) {",
        "if (m_end < 0) {",
        "gmm"),
    "sum_skips_last_rank": (
        "tpu_trainer_torch/parallel/collectives.py",
        "for i in range(1, parts.shape[0]):",
        "for i in range(1, parts.shape[0] - 1):",
        "dist"),
    "pp_stage_sum_skipped": (
        "tpu_trainer_torch/training/trainer.py",
        "if topo.stage_size > 1 and spec.stage_dim is None:",
        "if False and spec.stage_dim is None:",
        "pipeline"),
    "pp_head_partial_cotangent": (
        "tpu_trainer_torch/models/gpt.py",
        "dxn = self.mesh.stage.all_reduce_sum(gs[0].contiguous(),",
        "dxn = (lambda t, kind: t)(gs[0].contiguous(),",
        "pipeline"),
    "fleet_mirror_drops_token": (
        "tpu_trainer_torch/serving/remote.py",
        'req.generated.extend(d["gen"])',
        'req.generated.extend(d["gen"][:-1])',
        "fleet"),
    "fleet_resubmit_stale_cursor": (
        "tpu_trainer_torch/serving/worker.py",
        "self._sent[req.rid] = len(req.generated)",
        "self._sent[req.rid] = 0",
        "fleet"),
    "fleet_resubmit_wrong_seed": (
        "tpu_trainer_torch/serving/remote.py",
        'sampling=SamplingParams(**d["sampling"]),',
        'sampling=SamplingParams(**dict(d["sampling"], seed=d["sampling"]'
        '["seed"] + bool(d.get("generated")))),',
        "fleet"),
    "fleet_router_ignores_affinity": (
        "tpu_trainer_torch/serving/frontend.py",
        "target = self._rendezvous(key, live)",
        "target = min(live, key=self._load)",
        "fleet"),
    "decode_ignores_kv_head_base": (
        "tpu_trainer_torch/csrc/flash_decode.cu",
        "const int pkv = kv_head_base + ikv;",
        "const int pkv = ikv;",
        "tp_decode"),
    "tp_shards_reversed": (
        "tpu_trainer_torch/ops/flash.py",
        "    return torch.cat(outs, dim=1)",
        "    return torch.cat(outs[::-1], dim=1)",
        "tp_decode"),
    "tp_pool_write_shard0_only": (
        "tpu_trainer_torch/models/gpt.py",
        "for i, sh in enumerate(shards):\n            lo = i * kvl",
        "for i, sh in enumerate(shards[:1]):\n            lo = i * kvl",
        "tp_decode"),
    "tp_read_block_shard0": (
        "tpu_trainer_torch/serving/engine.py",
        "torch.cat([p[:, block_id].cpu() for p in parts], dim=2)",
        "torch.cat([p[:, block_id].cpu() for p in parts[:1]], dim=2)",
        "tp_decode"),
}


def run(name: str, timeout: float = 600.0) -> bool:
    """Plants mutation ``name`` in a copy and runs its phase; True when the
    phase failed (the fault was caught)."""
    src, text, mutated, phase = MUTATIONS[name]
    with tempfile.TemporaryDirectory(prefix=f"mutation-{name}-") as tmp:
        shutil.copytree(ROOT / "tpu_trainer_torch",
                        Path(tmp) / "tpu_trainer_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copytree(ROOT / "configs", Path(tmp) / "configs")
        shutil.copy2(ROOT / "chip_smoke.py", tmp)
        path = Path(tmp) / src
        code = path.read_text()
        if code.count(text) != 1:
            raise RuntimeError(f"{name}: the text to mutate occurs "
                               f"{code.count(text)} times in {src}")
        path.write_text(code.replace(text, mutated))
        # A phase that takes a working directory gets a fresh one.
        program = ("import inspect, tempfile, torch, chip_smoke as cs\n"
                   "torch.backends.cuda.matmul.allow_tf32 = False\n"
                   "r = {}\ncs.phase_card(r)\n"
                   f"fn = cs.phase_{phase}\n"
                   "n = sum(p.kind == p.POSITIONAL_OR_KEYWORD for p in "
                   "inspect.signature(fn).parameters.values())\n"
                   "fn(r, *([tempfile.mkdtemp()] if n > 1 else []))\n")
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
