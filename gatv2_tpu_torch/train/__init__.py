"""Full-graph training: optimizers, the Trainer, checkpoints, and the
`python -m gatv2_tpu_torch.train` entry point."""
