"""The collectives of the parallel layouts, each a `torch.distributed`
call on an explicit process group (NCCL on CUDA, gloo on the CPU): the
port's counterpart of the JAX package's named-axis `lax.psum` /
`all_gather` / `psum_scatter`, which XLA schedules there.

`collectives` counts the calls by kind since the last reset (the
trainer reports them per step; `chip_smoke.py` checks that the layouts
launched them). Host-side agreement on the checkpoint group (barriers,
object broadcasts) is not counted: it moves no tensor of the model.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# calls since the last reset, by kind
collectives = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}

# the newer names where this torch has them (the older ones warn there)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_collective_counts() -> None:
    for key in collectives:
        collectives[key] = 0


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns `t`."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` (dim 0 of size group size x inp's) <- every rank's `inp`, in
    group-rank order. `inp` may be this rank's own slice of `out` (the
    in-place form ZeRO-1 uses)."""
    collectives["all_gather"] += 1
    _all_gather(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` <- this rank's dim-0 slice of the sum of every rank's `inp`."""
    collectives["reduce_scatter"] += 1
    _reduce_scatter(out, inp, group=group)
