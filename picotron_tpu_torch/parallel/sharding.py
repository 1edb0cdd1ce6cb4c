"""Where each parameter's tp shard lies (port of
picotron_tpu/parallel/sharding.py `param_specs`, Megatron's 1D layout),
for the port's [out, in] weights:

- column-parallel q/k/v/gate/up (and the q/k/v biases): dim 0, their
  output features;
- row-parallel o/down: dim 1, their input features;
- the embedding and the untied head: dim 0, the vocab;
- the norms and the MoE router: replicated;
- the MoE banks ([E, H, F] w_gate/w_up, [E, F, H] w_down, the JAX
  layout): the ffn dim over tp (dim 2 of w_gate/w_up, dim 1 of w_down,
  as the dense MLP's) and the expert dim 0 over ep (`ep_shard_dim`; the
  JAX `P(pp, "ep", None, "tp")` / `P(pp, "ep", "tp", None)`).

Under the "row" tp strategy (`parallel/tp_strategies.py`) a pair's
storage flips (the JAX `param_specs`' "row" re-pointing): q/k/v
(gate/up) shard dim 1, their input features, and o (down) dim 0, their
output features; `tp_flips(cfg)` names the flipped leaves and every
reader of the shard dim takes them (`tp_shard_dim(name, flips)`). The
2d strategy keeps megatron's storage.

Every rank holds its tp shard of each tensor (`LlamaModel` under a tp
context is built at those shapes) and its ep shard of the banks; dp, cp
and (for every other tensor) ep replicate the params. Under sequence
parallelism the norms run on a seq shard of the residual stream, so
their grads are partial sums over tp; the router's are partial over tp
under any tp (`models/llama.py`: the router loss's grad is split over
tp, the gate's is partial like the expert path's). The step reduces
both over tp once, with the data axes (`tp_partial`; the JAX package's
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
_BANKS = ("w_gate", "w_up", "w_down")


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def tp_flips(cfg) -> frozenset:
    """The layer leaves whose tp storage the config's "row" pairs flip."""
    from picotron_tpu_torch.config import resolved_tp_strategy

    spec = resolved_tp_strategy(cfg)
    out = set()
    if spec["qkv"] == "row":
        out |= {"q", "k", "v", "o"}
    if spec["up"] == "row":
        out |= {"gate", "up", "down"}
    return frozenset(out)


def tp_shard_dim(name: str, flips=frozenset()) -> Optional[int]:
    """The dim of a param (state_dict name) sharded over tp, or None when
    it is replicated; a leaf in `flips` (`tp_flips`) has the other dim."""
    leaf = _leaf(name)
    if leaf in flips:
        return 1 if leaf in _COLUMN else 0
    if leaf in _COLUMN or leaf in _VOCAB:
        return 0
    if leaf in _ROW or leaf == "w_down":
        return 1
    if leaf in ("w_gate", "w_up"):
        return 2
    if leaf in _NORMS or leaf == "router":
        return None
    raise KeyError(f"no tp placement for param {name!r}")


def ep_shard_dim(name: str) -> Optional[int]:
    """The dim of a param sharded over ep (the banks' expert dim), or
    None."""
    return 0 if _leaf(name) in _BANKS else None


def tp_partial(name: str, seq_sharded: bool) -> bool:
    """True for the params whose grads are partial over tp: the norms
    when the residual stream is seq-sharded (sequence parallelism, or the
    deferred sync, `seq_sharded`), the MoE router under any tp. The 2d
    and row-first strategies leave none partial
    (`parallel/tp_strategies.py`)."""
    leaf = _leaf(name)
    return leaf == "router" or (seq_sharded and leaf in _NORMS)


def seq_sharded(cfg) -> bool:
    """The config's residual stream is seq-sharded over tp (sequence
    parallelism, or the deferred sync)."""
    d = cfg.distributed
    return d.tp_size > 1 and (d.sequence_parallel or d.tp_sync == "deferred")


def _chunk(name: str, t: torch.Tensor, dim: Optional[int], rank: int,
           size: int, axis: str) -> torch.Tensor:
    if dim is None or size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} is not "
                         f"divisible by {axis}_size {size}")
    return t.chunk(size, dim=dim)[rank].contiguous()


def shard(name: str, t: torch.Tensor, tp_rank: int, tp_size: int,
          ep_rank: int = 0, ep_size: int = 1,
          flips=frozenset()) -> torch.Tensor:
    """This (tp, ep) rank's shard of a full tensor (a contiguous copy)."""
    t = _chunk(name, t, ep_shard_dim(name), ep_rank, ep_size, "ep")
    return _chunk(name, t, tp_shard_dim(name, flips), tp_rank, tp_size,
                  "tp")


def shard_state_dict(sd: dict, tp_rank: int, tp_size: int,
                     ep_rank: int = 0, ep_size: int = 1,
                     flips=frozenset()) -> dict:
    """{name: full tensor} -> {name: this (tp, ep) rank's shard}."""
    return {n: shard(n, t, tp_rank, tp_size, ep_rank, ep_size, flips)
            for n, t in sd.items()}
