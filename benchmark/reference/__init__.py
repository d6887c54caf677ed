"""Plain PyTorch reference of GATv2 training and of the sampled batches:
imports nothing of the measured program."""
