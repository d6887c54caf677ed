"""Multi-GPU training on torch.distributed (port of gatv2_tpu/parallel/):
edge partitioning (partition), the rank mesh (mesh), process-group
start-up (multihost), collectives with gradients (collectives) and the
sharded trainer, step and runner (sharded)."""

from gatv2_tpu_torch.parallel.sharded import (
    ShardedTrainer,
    make_sharded_eval_step,
    make_sharded_multi_epoch_runner,
    make_sharded_train_step,
)

__all__ = [
    "ShardedTrainer",
    "make_sharded_train_step",
    "make_sharded_eval_step",
    "make_sharded_multi_epoch_runner",
]
