"""Single-GPU FSDP-flavoured entry point (port of
``tpu_trainer/training/train_fsdp.py``). Run::

    python -m tpu_trainer_torch.training.train_fsdp --config configs/medium_model.yaml \
        [--sharding FULL_SHARD] [--cpu_offload --offload_dtype int8 --offload_budget_gb 0.5]

The JAX fsdp flags and YAML ``fsdp:`` keys; activation checkpointing on
unless ``--no_activation_checkpointing``. At one process every sharding
strategy is the ddp step; ``HYBRID_SHARD`` and ``--mesh_*`` > 1 raise
(ROADMAP Queue 1 item 5).
"""

import sys

from tpu_trainer_torch.training.cli import run_training


def main(argv=None) -> int:
    return run_training(argv, mode="fsdp")


if __name__ == "__main__":
    sys.exit(main())
