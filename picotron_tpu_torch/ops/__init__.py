"""Numerical ops of the port: RoPE, RMSNorm, attention, losses.

RMSNorm, RoPE outside the kernel and cross-entropy are plain torch ops (the
JAX package left them to XLA). Flash attention is the hand-written CUDA
kernels of `csrc/flash_attention.cu` (`ops.flash_attention`, not re-exported
here so the module name stays importable), built on first launch. The
context-parallel schedules (`ops.ring_attention`, `ops.ulysses`,
`ops.mesh_attention`) call those kernels per block and are likewise
imported by module.
"""

from picotron_tpu_torch.ops.attention import (  # noqa: F401
    repeat_kv, sdpa_attention, sdpa_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.losses import (  # noqa: F401
    IGNORE_INDEX, cross_entropy, cross_entropy_sum_count,
)
from picotron_tpu_torch.ops.rmsnorm import rms_norm  # noqa: F401
from picotron_tpu_torch.ops.rope import apply_rope, rope_tables  # noqa: F401
