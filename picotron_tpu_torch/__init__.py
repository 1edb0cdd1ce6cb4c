"""picotron_tpu_torch: the PyTorch + CUDA port of picotron-tpu for one NVIDIA
H100 (Hopper, sm_90a).

The JAX package `picotron_tpu` stays the reference; this package mirrors
its module names (config, ops/, models/llama, optimizer, train_step,
data, native, utils, train, checkpoint, ckpt_integrity/, resilience/,
telemetry/, generate, serve/, analysis/, tools/) and imports nothing
from it or from jax. The three Pallas flash-attention kernels are
hand-written CUDA in `csrc/flash_attention.cu`, built with nvcc at first
launch (`kernels/build.py`), never at import; the data pipeline's token
packer (`csrc/packer.cpp`) is built there with g++ at its first use.

Entry points run on CUDA unless the caller asks for the CPU (`--device
cpu`, `device="cpu"`, or config `distributed.use_cpu: true`); on the CPU
every kernel's plain PyTorch version runs instead.

Numerics: importing the package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so fp32 products on the card
stay full fp32 (TF32 keeps about three decimal digits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["analysis", "checkpoint", "ckpt_integrity", "config", "data",
           "models", "ops", "optimizer", "resilience", "telemetry", "train",
           "train_step", "utils", "weights"]
