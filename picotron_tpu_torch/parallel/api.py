"""The data-axis seam of the parallel step (port of
picotron_tpu/parallel/api.py `_data_axes_psum` and the reductions of
`_device_grads` and `make_eval_step`).

Either grad engine sums the microbatches' NLL-sum grads into each
rank's fp32 buffers; `GradSync` then reduces them once, after the last
microbatch: the grads partial over tp (`parallel/sharding.tp_partial`:
the norms' under sequence parallelism, the MoE router's under any tp)
over tp, then every grad, the NLL sum and the valid-token count over
the data group, one all-reduce each (the JAX engine seam,
`fused_bwd.py:45-51` of the JAX package). The MoE expert banks, sharded
over ep, sum over their bank group (dp, cp) instead: each rank's bank
grads already hold every ep peer's tokens through the dispatch
all-to-all (the JAX `_data_axes_psum`, `api.py:243-262` there). An
MoE model's token-weighted drop sum rides the NLL sum's all-reduce. The
count is clamped at 1 after the sum, so shards whose IGNORE_INDEX counts
differ weigh correctly. Under a process group this runs at every size, world 1
included, so that the path is the same one the layouts run.

On a multi-slice layout whose dp carries a slice granule
(`parallel/hier_reduce.use_hier_dp`) the data-axis sum of the grads is
the hierarchical schedule instead (`hier_reduce.hier_sum_`: one flat
fp32 buffer per set of axes, (dp, ep, cp) for every tensor but the
banks, (dp, cp) for the banks, as the JAX `_data_axes_psum`): a
reduce-scatter inside the slice, one shard per slice across it, an
all-gather back. The NLL sum and the count stay one flat all-reduce.

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
from picotron_tpu_torch.parallel.hier_reduce import hier_sum_
from picotron_tpu_torch.parallel.sharding import ep_shard_dim, tp_partial


def reduce_sum_count(total: torch.Tensor, count: torch.Tensor, group,
                     *more: torch.Tensor):
    """(total, count, *more) summed over `group` in one all-reduce (the
    count is exact in fp32 below 2^24 tokens per step)."""
    both = comm.all_reduce(torch.stack([total.float(), count.float(),
                                        *(m.float() for m in more)]), group)
    return (both[0], both[1].round().to(count.dtype), *both[2:])


class GradSync:
    """The seam: `sync(grads, nll_total, count, *more)` -> the reduced
    (nll_total, count, *more), the buffers `grads` ({param: buffer})
    reduced in place."""

    def __init__(self, par, model: torch.nn.Module, seq_sharded: bool):
        self.par = par
        named = list(model.named_parameters())
        self.tp_params = ([p for n, p in named
                           if tp_partial(n, seq_sharded)]
                          if par.tp_size > 1 else [])
        self.banks = {p for n, p in named if ep_shard_dim(n) is not None}
        # the hierarchical reduction when the layout made its cohorts
        self.hier = par.dp_granule[0] > 1

    def __call__(self, grads: dict, nll_total: torch.Tensor,
                 count: torch.Tensor, *more: torch.Tensor):
        for p in self.tp_params:
            comm.all_reduce(grads[p], self.par.tp_group)
        if self.hier:
            hier_sum_([b for p, b in grads.items() if p not in self.banks],
                      ("dp", "ep", "cp"), self.par)
            hier_sum_([b for p, b in grads.items() if p in self.banks],
                      ("dp", "cp"), self.par)
        else:
            for p, buf in grads.items():
                comm.all_reduce(buf, self.par.bank_group if p in self.banks
                                else self.par.data_group)
        return reduce_sum_count(nll_total, count, self.par.data_group, *more)


def moe_extras(dropw: torch.Tensor, count: torch.Tensor, cfg) -> dict:
    """{"moe_drop_frac"}: the token-weighted drop sum (summed over the
    microbatches of count * sum over the layers of the drop fraction)
    over count * L, the token-weighted mean per-layer share of the
    assignments the capacity dropped (the JAX `_normalize_extras`). `cfg`
    is the model config; `count` the clamped global token count."""
    return {"moe_drop_frac": dropw / (count * cfg.num_hidden_layers)}


def finish_grads(cfg, grads: dict, nll_total: torch.Tensor,
                 count: torch.Tensor, more: list, reduce=None,
                 extras=None):
    """A grad engine's last part: the seam (`reduce`, a `GradSync`) over
    the grads, the NLL sum, the count and `more` (an MoE model's drop sum,
    else empty), the count clamped at 1, `extras` (a dict, when given)
    filled with `moe_extras`, and (mean loss, 1 / token count). `cfg` is
    the model config."""
    if reduce is not None:
        nll_total, count, *more = reduce(grads, nll_total, count, *more)
    count = count.clamp(min=1)
    if more and extras is not None:
        extras.update(moe_extras(more[0], count, cfg))
    return nll_total / count, torch.reciprocal(count.float())


def grad_seam(par, seq_sharded: bool):
    """model -> its `GradSync` over `par`, made once per model (again for
    another model); None without a layout. `seq_sharded`: the residual
    stream is seq-sharded over tp (`sharding.seq_sharded`)."""
    made: dict = {}

    def seam(model):
        if par is None:
            return None
        if made.get("model") is not model:
            made.update(model=model,
                        sync=GradSync(par, model, seq_sharded))
        return made["sync"]

    return seam
