"""Single-device training and eval steps (port of picotron_tpu/train_step.py
and the single-device branch of picotron_tpu/parallel/api.py
`make_train_step` / `make_eval_step`): gradient accumulation over
microbatches, token-mean grads, one AdamW step.

Two grad engines, resolved as the JAX package resolves them
(`resolved_grad_engine`): "ad" runs autograd per microbatch, under the
config's remat policy (`models/llama.py` `remat_layer`); "fused" is the
manual backward of `parallel/fused_bwd.py`, which accumulates each
layer's weight grads inside the GEMMs and reads per-step bf16 copies of
the weights. "auto" takes "fused" when gradient accumulation is on and
the config is eligible (remat "dots_attn"). Either engine sums the
microbatches' NLL-sum grads into the optimizer's fp32 grad buffers
(`grad_of`: the params' .grad under the resident AdamW; under
optimizer_offload buffers that the bf16 params' post-accumulate-grad
hooks fill) without dividing them, and returns the mean loss and 1 /
the total valid-token count, which rides to the update as `grad_scale`,
as in the JAX package's `_finish_grads`; so uneven IGNORE_INDEX counts
weigh microbatches correctly. `training.ce_chunk_size` streams the
head's CE over vocab chunks. For an MoE model the loss includes the
router loss (`models/llama.loss_sum_count`'s fold) and the step's
metrics gain `moe_drop_frac` (`parallel/api.moe_extras`, the JAX
`_normalize_extras`), which the trainer prints on its log line.

With `resilience.guard_policy != "off"` the step also returns the grads'
global norm (`grad_norm`, optax.global_norm: the buffers' norm times
the scale) and an in-step `nonfinite` flag, as the JAX step does; the
same norm feeds clipping. Under "skip" a non-finite step leaves params,
moments and the AdamW count as they were.

Under a parallel layout (`par`, the rank's `mesh.ParallelEnv`) each rank
runs its tp shards on its dp rows of the batch (its cp slice of their
sequence under context parallelism); the engines' sums then
pass the seam (`parallel/api.GradSync`: one reduction over the data
group after the last microbatch, and the norms' partial grads over tp
under sequence parallelism) before the token count divides, the grad
norm is the whole model's (`optimizer.layout_grad_norm`), and ZeRO-1
shards the optimizer state (`optimizer.py`). The eval loss is summed
over the data group the same way.

Under pipeline parallelism (pp > 1) the model is the rank's stage and
the step's grads come from the pipeline's walk of its schedule table
(`parallel/pp.PipelineGrads`: the spmd engines "1f1b"/"afab", or the mpmd
schedules), an AD engine: `resolved_grad_engine` names the pp_engine, as
the JAX package's. The loss and the token count reach every stage, and
the grad norm sums over the stages, so every stage takes the same
update decision. The eval step walks the forwards alone
(`parallel/pp.PipelineEval`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch.profiler import record_function

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models.llama import (
    LlamaModel, compute_dtype, loss_sum_count,
)
from picotron_tpu_torch.optimizer import (
    AdamW, OffloadAdamW, guard_nonfinite, param_grads,
)
from picotron_tpu_torch.parallel.api import (
    finish_grads, grad_seam, reduce_sum_count,
)
from picotron_tpu_torch.parallel.comm import PPComm
from picotron_tpu_torch.parallel.fused_bwd import (
    ComputeWeights, check_ported, fused_accumulate_grads, fused_bwd_supported,
)
from picotron_tpu_torch.parallel.pp import PipelineEval, PipelineGrads

__all__ = ["TrainState", "accumulate_grads", "guard_nonfinite",
           "init_train_state", "make_eval_step", "make_grads_fn",
           "make_train_step", "resolved_grad_engine"]


@dataclass
class TrainState:
    model: LlamaModel
    optimizer: Union[AdamW, OffloadAdamW]
    step: int = 0


def init_train_state(cfg: Config, model: LlamaModel,
                     par=None) -> TrainState:
    """The model (fp32 params) and its optimizer. Under optimizer_offload
    the params become the master of `OffloadAdamW` (host memory, pinned
    on CUDA) and the model keeps their bf16 compute copy, as the JAX
    package's `_init_offload_state`. `par`: the rank's ParallelEnv, for
    the grad norm (summed over the stages under pp) and ZeRO-1
    (distributed.zero1)."""
    zero1 = cfg.distributed.zero1
    pp = PPComm(par) if par is not None and par.pp_size > 1 else None
    if cfg.training.optimizer_offload:
        opt = OffloadAdamW(model, cfg.training, compute_dtype(model.cfg),
                           par=par, zero1=zero1, pp=pp)
    else:
        opt = AdamW(model, cfg.training, par=par, zero1=zero1, pp=pp)
    return TrainState(model=model, optimizer=opt)


def resolved_grad_engine(cfg: Config) -> str:
    """The grad engine the step runs ('fused'/'ad', or the pipeline
    engine's name), resolving 'auto' as the JAX package does (port of
    picotron_tpu/analysis/collectives.py `resolved_grad_engine`)."""
    if cfg.distributed.pp_size > 1:
        return cfg.distributed.pp_engine
    t = cfg.training
    if (t.grad_engine == "fused"
            or (t.grad_engine == "auto"
                and t.gradient_accumulation_steps > 1
                and fused_bwd_supported(cfg))):
        return "fused"
    return "ad"


def accumulate_grads(model: LlamaModel, batch, remat: Optional[str] = None,
                     ce_chunk_size: int = 0, grads: Optional[dict] = None,
                     reduce=None, extras: Optional[dict] = None):
    """The AD engine. batch: (input_ids, targets), each [n_micro, mbs,
    seq] on the model's device; `remat` a remat policy name or None;
    `grads` the fp32 accumulators, {param: buffer} (the optimizer's
    `grad_of`; the params' .grad when None). Zeroes them, leaves the
    microbatches' summed NLL-sum grads there and returns (mean loss, 1 /
    token count), each a 0-dim fp32 tensor. `reduce` (a `GradSync`) is
    the layout's seam, run once before the division. For an MoE model
    `extras` (a dict, when given) receives `moe_extras`."""
    ids, tgt = batch
    grads = param_grads(model.parameters()) if grads is None else grads
    for buf in grads.values():
        buf.zero_()
    nll_total = torch.zeros((), dtype=torch.float32, device=ids.device)
    count = torch.zeros((), dtype=torch.int64, device=ids.device)
    more = ([torch.zeros((), dtype=torch.float32, device=ids.device)]
            if model.cfg.num_experts else [])
    for i in range(ids.shape[0]):
        total, c, ex = loss_sum_count(model, ids[i], tgt[i], remat,
                                      ce_chunk_size)
        total.backward()
        nll_total += total.detach()
        count += c
        if more:
            more[0] += ex["moe_drop_weighted"]
    return finish_grads(model.cfg, grads, nll_total, count, more, reduce,
                        extras)


def make_grads_fn(cfg: Config, par=None):
    """(model, batch, grads=None, extras=None) -> (mean loss, 1 / token
    count), the summed grads left in `grads` (as `accumulate_grads`; MoE
    extras in `extras`), by the config's
    resolved engine. The fused engine's bf16 weight copies are made for
    the model it first sees (again for another model) and refreshed from
    the masters on every call; over bf16 params they are the params.
    Under a layout (`par`) the sums pass the seam (`GradSync`) before the
    division; under pp > 1 it is the pipeline's `PipelineGrads`."""
    t = cfg.training
    if cfg.distributed.pp_size > 1:
        return PipelineGrads(cfg, par)
    seam = grad_seam(par, cfg.distributed.sequence_parallel)
    if resolved_grad_engine(cfg) != "fused":
        remat = t.remat_policy if t.remat else None
        return lambda model, batch, grads=None, extras=None: \
            accumulate_grads(model, batch, remat, t.ce_chunk_size, grads,
                             seam(model), extras)
    check_ported(cfg)
    weights = None

    def fused(model: LlamaModel, batch, grads: Optional[dict] = None,
              extras: Optional[dict] = None):
        nonlocal weights
        if weights is None or weights.model is not model:
            weights = ComputeWeights(model)
        weights.refresh()
        return fused_accumulate_grads(model, weights, batch, t.ce_chunk_size,
                                      grads=grads, reduce=seam(model),
                                      extras=extras)

    return fused


def make_train_step(cfg: Config, par=None):
    """(state, batch) -> metrics: {"loss"} plus, with guards on,
    {"grad_norm", "nonfinite"}, and for an MoE model {"moe_drop_frac"},
    each a 0-dim fp32 tensor on the device
    (nothing here syncs the host, except the count under "skip"). `par`:
    the rank's ParallelEnv under a layout, whose batch is this rank's
    rows.

    `poison=True` poisons this call's grads and loss (NaN added to each
    summed grad buffer and to the loss, after the engine and before the
    norm): the chaos harness's `nan_grad` event, the counterpart of the
    JAX `make_train_step(..., inject_nan=True)`, which needs a second
    program where an eager step needs only the argument. The poison then
    takes the path of a real non-finite step: the in-step `nonfinite`
    flag, the guard, and under "skip" the update's `ok` flag (the AdamW
    kernel writes nothing). It lands after either grad engine, and under
    pp on every stage's grads after the walk."""
    grads_fn = make_grads_fn(cfg, par)
    guards_on = cfg.resilience.guard_policy != "off"
    guard_skip = cfg.resilience.guard_policy == "skip"
    # the pipeline's walk names the step in its watchdog beats
    piped = isinstance(grads_fn, PipelineGrads)

    def train_step(state: TrainState, batch, poison: bool = False) -> dict:
        opt = state.optimizer
        kw = {"step": state.step + 1} if piped else {}
        extras: dict = {}
        loss, scale = grads_fn(state.model, batch, opt.grad_of,
                               extras=extras, **kw)
        if poison:
            nan = float("nan")
            for buf in opt.grad_of.values():
                buf.add_(nan)
            loss = loss + nan
        metrics = {"loss": loss}
        gnorm = ok = None
        if guards_on:
            # One global norm covers every grad: any NaN/Inf poisons it,
            # so non-finite detection is one scalar check.
            with record_function("train_step.grad_norm"):
                gnorm = opt.grad_norm()
            shown = gnorm * scale
            finite = torch.isfinite(loss) & torch.isfinite(shown)
            metrics["grad_norm"] = shown
            metrics["nonfinite"] = 1.0 - finite.float()
            if guard_skip:
                ok = finite
        opt.step(scale, grad_norm=gnorm, ok=ok)
        state.step += 1
        metrics.update(extras)
        return metrics

    if piped:
        train_step.pipeline = grads_fn  # its last walk's stats
    return train_step


def make_eval_step(cfg: Config, par=None):
    """(model, batch) -> token-mean loss over the batch's microbatches, a
    0-dim fp32 tensor: forward only under no_grad (no graph, no grads), the
    validation half of the train step (under a layout, summed over the
    data group before the division; under pp > 1 the pipeline's forward
    walk, `PipelineEval`)."""
    if cfg.distributed.pp_size > 1:
        return PipelineEval(cfg, par)
    chunk = cfg.training.ce_chunk_size

    @torch.no_grad()
    def eval_step(model: LlamaModel, batch) -> torch.Tensor:
        ids, tgt = batch
        total = torch.zeros((), dtype=torch.float32, device=ids.device)
        count = torch.zeros((), dtype=torch.int64, device=ids.device)
        for i in range(ids.shape[0]):
            t, c, _ = loss_sum_count(model, ids[i], tgt[i],
                                     ce_chunk_size=chunk)
            total += t
            count += c
        if par is not None:
            total, count = reduce_sum_count(total, count, par.data_group)
        return total / count.clamp(min=1)

    return eval_step
