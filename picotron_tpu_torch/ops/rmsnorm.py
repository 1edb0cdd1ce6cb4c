"""RMSNorm with fp32 statistics (port of picotron_tpu/ops/rmsnorm.py).

Variance and normalisation in fp32, the weight multiplied in fp32, the
result cast back to the input dtype. Plain torch ops, as the JAX package
left this op to XLA's fusion.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    variance = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(variance + eps)
    return (weight.float() * normed).to(x.dtype)
