"""DDP training entry point (port of ``tpu_trainer/training/train_ddp.py``).
Run::

    python -m tpu_trainer_torch.training.train_ddp --config configs/small_model.yaml \
        --dataset tinystories --data_path stories.txt --tokenizer byte
    torchrun --nproc_per_node 8 -m tpu_trainer_torch.training.train_ddp \
        --config configs/small_model.yaml

It runs on CUDA unless ``--device cpu`` is passed; without a GPU and
without that flag it raises. Under ``torchrun`` every process is a data
rank (``--mesh_data`` / ``--mesh_fsdp`` split them). ``train_fsdp`` takes
the fsdp flags (the sharding strategy, host offload of the optimizer
state); on one GPU its strategies are this step.
"""

import sys

from tpu_trainer_torch.training.cli import run_training


def main(argv=None) -> int:
    return run_training(argv, mode="ddp")


if __name__ == "__main__":
    sys.exit(main())
