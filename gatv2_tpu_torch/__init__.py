"""gatv2_tpu_torch — the PyTorch/CUDA port of gatv2_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module: `config`, `data/`,
`ops/`, `models/`, `train/`, `parallel/` (multi-GPU on torch.distributed),
`cli` and `predict` each mirror their gatv2_tpu counterpart. It imports
torch and numpy only, never JAX or gatv2_tpu.

Each CUDA kernel (ops/sell_*.py and ops/pallas_*.py, sources in csrc/) is
built with nvcc and loaded at its first launch, and the native sampler and
parser (utils/native_loader.py) with g++ at first use, so importing any
module here needs neither a GPU nor a compiler.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, `--device cpu`); with no CUDA device they raise rather
than fall back.
"""

from gatv2_tpu_torch.config import ModelConfig, TrainConfig

__all__ = ["ModelConfig", "TrainConfig"]
