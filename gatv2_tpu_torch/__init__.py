"""gatv2_tpu_torch — the PyTorch/CUDA port of gatv2_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module: `config`, `data/`,
`ops/`, `models/`, `cli` and `predict` each mirror their gatv2_tpu
counterpart. It imports torch and numpy only, never JAX or gatv2_tpu.

The SELL forward kernel (ops/sell_fwd.py, source csrc/sell_fwd.cu) is built
with nvcc and loaded at its first launch, so importing any module here needs
neither a GPU nor a CUDA toolkit.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); with no CUDA device they raise rather
than fall back.
"""

from gatv2_tpu_torch.config import ModelConfig, TrainConfig

__all__ = ["ModelConfig", "TrainConfig"]
