"""The port's package boundary.

``tpu_trainer_torch`` must run where JAX is not installed: importing it
loads neither JAX, Flax nor the JAX package (whose ``__init__`` loads
Flax), no module of the port imports them, and its entry points never
drop to the CPU unless the caller asks for it.
"""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import tpu_trainer_torch

PKG = pathlib.Path(tpu_trainer_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpu_trainer")
# Every module of the port, so the subprocess imports all of them.
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("tpu_trainer_torch.serving.engine",
                "tpu_trainer_torch.training.trainer",
                "tpu_trainer_torch.ops.head_ce",
                "tpu_trainer_torch.ops.loss",
                "tpu_trainer_torch.ops.grouped_matmul",
                "tpu_trainer_torch.models.moe",
                "tpu_trainer_torch.data.dummy",
                "tpu_trainer_torch.data.packing",
                "tpu_trainer_torch.data.text",
                "tpu_trainer_torch.data.device_prefetch",
                "tpu_trainer_torch.native",
                "tpu_trainer_torch.training.cli",
                "tpu_trainer_torch.training.train_ddp",
                "tpu_trainer_torch.training.train_fsdp",
                "tpu_trainer_torch.training.elastic",
                "tpu_trainer_torch.utils.checkpoint",
                "tpu_trainer_torch.eval.infer",
                "tpu_trainer_torch.utils.faults",
                "tpu_trainer_torch.utils.flight_recorder",
                "tpu_trainer_torch.utils.preemption",
                "tpu_trainer_torch.utils.telemetry",
                "tpu_trainer_torch.utils.profiling",
                "tpu_trainer_torch.utils.guards",
                "tpu_trainer_torch.data.mixture",
                "tpu_trainer_torch.obs",
                "tpu_trainer_torch.obs.metrics",
                "tpu_trainer_torch.obs.http",
                "tpu_trainer_torch.tools",
                "tpu_trainer_torch.tools.analyze",
                "tpu_trainer_torch.serving.frontend",
                "tpu_trainer_torch.serving.remote",
                "tpu_trainer_torch.serving.worker",
                "tpu_trainer_torch.serving.tracing",
                "tpu_trainer_torch.serving.sharding",
                "tpu_trainer_torch.parallel.comms_model",
                "tpu_trainer_torch.parallel.planner",
                "tpu_trainer_torch.tools.plan",
                "tpu_trainer_torch.data.tinystories",
                "tpu_trainer_torch.data.openwebtext"):
        assert mod in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_started_worker_imports_no_jax(tmp_path):
    """A worker process started by the supervisor, after it built its
    engine and served a request, has imported no JAX, Flax or JAX-package
    module (``PYTHONPROFILEIMPORTTIME`` lists every import in its log).
    It runs the TCP transport and the shard-streaming launch (the weights
    as a 2-way ``export_param_shards`` export it stitches back)."""
    import shutil
    import tempfile

    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.models.weights import init_params
    from tpu_trainer_torch.serving import (Request, ServingFrontend,
                                           WorkerSupervisor)

    cfg = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=32, dtype="float32",
                    param_dtype="float32")
    run_dir = tempfile.mkdtemp(prefix="ttb-")
    sup = WorkerSupervisor(
        init_params(cfg, 0, device="cpu"), cfg,
        engine_kwargs={"device": "cpu", "block_size": 8, "max_batch": 2},
        run_dir=run_dir, tcp=True, param_shard_world=2, launch_prefix=[
            "env", "PYTHONPROFILEIMPORTTIME=1", "OMP_NUM_THREADS=1"])
    try:
        fe = ServingFrontend(None, cfg, replicas=1, time_mode="steps",
                             replica_factory=sup)
        fin = fe.run([Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2)])
        assert len(fin) == 1 and len(fin[0].generated) == 2
        assert len(sup.param_shard_bytes) == 2
        assert max(sup.param_shard_bytes) < sup.param_bytes_full
        sup.close()
        with open(f"{run_dir}/worker0.log") as f:
            log = f.read()
    finally:
        sup.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    mods = [line.rsplit("|", 1)[1].strip() for line in log.splitlines()
            if line.startswith("import time:") and "|" in line]
    assert "tpu_trainer_torch.serving.engine" in mods
    assert [m for m in mods if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert bad == []


def test_engine_without_cuda_or_cpu_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.serving.engine import ServingEngine

    cfg = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=32, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine({}, cfg)


def test_trainer_without_cuda_or_cpu_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from tpu_trainer_torch.models.config import GPTConfig
    from tpu_trainer_torch.training.trainer import Trainer

    cfg = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1,
                    num_heads=2, max_seq_len=32, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)


@pytest.mark.parametrize("module,fn", [
    ("tpu_trainer_torch.ops.flash", "flash_forward"),
    ("tpu_trainer_torch.ops.flash", "flash_backward"),
    ("tpu_trainer_torch.ops.flash", "flash_backward_dkv"),
    ("tpu_trainer_torch.ops.flash", "flash_backward_dq"),
    ("tpu_trainer_torch.ops.flash", "keep_mask_cuda"),
])
def test_kernel_wrappers_refuse_cpu_tensors(module, fn):
    """The kernel wrappers never run a plain version themselves: given CPU
    tensors they raise (the CPU path is the dispatch's, not theirs)."""
    import importlib

    wrapper = getattr(importlib.import_module(module), fn)
    x = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "flash_forward":
            wrapper(x, x, x)
        elif fn in ("flash_backward", "flash_backward_dkv"):
            wrapper(x, x, x, x, torch.zeros((1, 2, 8)), x)
        elif fn == "flash_backward_dq":
            wrapper(x, x, x, x, torch.zeros((1, 2, 8)), torch.zeros((1, 2, 8)))
        else:
            wrapper(1, 2, 8, 0.1, block_q=4, block_k=4, device="cpu")


def test_cli_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from tpu_trainer_torch.serving.engine import _main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _main(["--requests", "1", "--vocab", "64", "--hidden", "16",
               "--layers", "1", "--heads", "2", "--max-seq-len", "32"])
