"""The data-axis seam of the parallel step (port of
picotron_tpu/parallel/api.py `_data_axes_psum` and the reductions of
`_device_grads` and `make_eval_step`).

Either grad engine sums the microbatches' NLL-sum grads into each
rank's fp32 buffers; `GradSync` then reduces them once, after the last
microbatch: under sequence parallelism the norms' partial grads over tp
(`parallel/sharding.sp_partial`), then every grad, the NLL sum and the
valid-token count over the data group, one all-reduce each (the JAX
engine seam, `fused_bwd.py:45-51` of the JAX package). The count is
clamped at 1 after the sum, so shards whose IGNORE_INDEX counts differ
weigh correctly. Under a process group this runs at every size, world 1
included, so that the path is the same one the layouts run.

Context parallelism needs nothing more here: the data group spans cp
(`mesh.DATA_AXES`), each cp rank's grads, NLL sum and count are those of
its slice of the sequence, and their sum over the group is the whole
sequence's; ZeRO-1 shards over the same group. Under tp x cp with
sequence parallelism the SP pair gathers and scatters the cp-local
sequence within the tp group.
"""

from __future__ import annotations

import torch

from picotron_tpu_torch.parallel import comm
from picotron_tpu_torch.parallel.sharding import sp_partial


def reduce_sum_count(total: torch.Tensor, count: torch.Tensor, group):
    """(total, count) summed over `group` in one all-reduce (the count is
    exact in fp32 below 2^24 tokens per step)."""
    both = comm.all_reduce(torch.stack([total.float(), count.float()]),
                           group)
    return both[0], both[1].round().to(count.dtype)


class GradSync:
    """The seam: `sync(grads, nll_total, count)` -> the reduced (nll_total,
    count), the buffers `grads` ({param: buffer}) reduced in place."""

    def __init__(self, par, model: torch.nn.Module, sequence_parallel: bool):
        self.par = par
        self.sp_params = ([p for n, p in model.named_parameters()
                           if sp_partial(n)]
                          if sequence_parallel and par.tp_size > 1 else [])

    def __call__(self, grads: dict, nll_total: torch.Tensor,
                 count: torch.Tensor):
        for p in self.sp_params:
            comm.all_reduce(grads[p], self.par.tp_group)
        for buf in grads.values():
            comm.all_reduce(buf, self.par.data_group)
        return reduce_sum_count(nll_total, count, self.par.data_group)


def grad_seam(par, sequence_parallel: bool):
    """model -> its `GradSync` over `par`, made once per model (again for
    another model); None without a layout."""
    made: dict = {}

    def seam(model):
        if par is None:
            return None
        if made.get("model") is not model:
            made.update(model=model,
                        sync=GradSync(par, model, sequence_parallel))
        return made["sync"]

    return seam
