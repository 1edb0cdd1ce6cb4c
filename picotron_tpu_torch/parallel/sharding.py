"""Where each parameter's tp shard lies (port of
picotron_tpu/parallel/sharding.py `param_specs`, Megatron's 1D layout),
for the port's [out, in] weights:

- column-parallel q/k/v/gate/up (and the q/k/v biases): dim 0, their
  output features;
- row-parallel o/down: dim 1, their input features;
- the embedding and the untied head: dim 0, the vocab;
- the norms: replicated.

Every rank holds its tp shard of each tensor (`LlamaModel` under a tp
context is built at those shapes); dp, ep and cp replicate the params.
Under sequence parallelism the norms run on a seq shard of the residual
stream, so their grads are partial sums over tp (`sp_partial`), which
the step reduces over tp once, with the data axes (the JAX package's
shard_map inserts the same psum as the transpose of the replicated
weight's use).
"""

from __future__ import annotations

from typing import Optional

import torch

_COLUMN = ("q", "k", "v", "gate", "up", "b_q", "b_k", "b_v")
_ROW = ("o", "down")
_VOCAB = ("embedding", "lm_head")
_NORMS = ("input_norm", "post_norm", "final_norm")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def tp_shard_dim(name: str) -> Optional[int]:
    """The dim of a param (state_dict name) sharded over tp, or None when
    it is replicated."""
    leaf = _leaf(name)
    if leaf in _COLUMN or leaf in _VOCAB:
        return 0
    if leaf in _ROW:
        return 1
    if leaf in _NORMS:
        return None
    raise KeyError(f"no tp placement for param {name!r}")


def sp_partial(name: str) -> bool:
    """True for the params whose grads are partial over tp under sequence
    parallelism (the norms)."""
    return _leaf(name) in _NORMS


def shard(name: str, t: torch.Tensor, tp_rank: int,
          tp_size: int) -> torch.Tensor:
    """This tp rank's shard of a full tensor (a contiguous copy)."""
    dim = tp_shard_dim(name)
    if dim is None or tp_size == 1:
        return t
    if t.shape[dim] % tp_size:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} is not "
                         f"divisible by tp_size {tp_size}")
    return t.chunk(tp_size, dim=dim)[tp_rank].contiguous()


def shard_state_dict(sd: dict, tp_rank: int, tp_size: int) -> dict:
    """{name: full tensor} -> {name: this tp rank's shard}."""
    return {n: shard(n, t, tp_rank, tp_size) for n, t in sd.items()}
