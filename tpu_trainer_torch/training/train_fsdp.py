"""FSDP entry point (port of ``tpu_trainer/training/train_fsdp.py``).
Run::

    python -m tpu_trainer_torch.training.train_fsdp --config configs/medium_model.yaml \
        [--sharding FULL_SHARD] [--cpu_offload --offload_dtype int8 --offload_budget_gb 0.5]
    torchrun --nproc_per_node 2 -m tpu_trainer_torch.training.train_fsdp \
        --config configs/medium_model.yaml --sharding SHARD_GRAD_OP

The JAX fsdp flags and YAML ``fsdp:`` keys; activation checkpointing on
unless ``--no_activation_checkpointing``. The default mesh puts every
process on the fsdp axis (``--mesh_data`` / ``--mesh_fsdp`` split it;
``HYBRID_SHARD`` needs both). At one process every sharding strategy is
the ddp step.
"""

import sys

from tpu_trainer_torch.training.cli import run_training


def main(argv=None) -> int:
    return run_training(argv, mode="fsdp")


if __name__ == "__main__":
    sys.exit(main())
