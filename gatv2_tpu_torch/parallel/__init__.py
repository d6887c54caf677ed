"""Multi-GPU training on torch.distributed (port of gatv2_tpu/parallel/):
edge partitioning (partition), the rank mesh (mesh), process-group
start-up (multihost), collectives with gradients (collectives) and the
sharded trainer (sharded)."""
