"""Attention ops: segment reductions, the plain PyTorch edge path, and the
SELL layout with its CUDA forward kernel."""
