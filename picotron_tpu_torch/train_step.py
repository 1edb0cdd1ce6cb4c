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
head's CE over vocab chunks.

With `resilience.guard_policy != "off"` the step also returns the grads'
global norm (`grad_norm`, optax.global_norm: the buffers' norm times
the scale) and an in-step `nonfinite` flag, as the JAX step does; the
same norm feeds clipping. Under "skip" a non-finite step leaves params,
moments and the AdamW count as they were.
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
    AdamW, OffloadAdamW, global_norm, guard_nonfinite, param_grads,
)
from picotron_tpu_torch.parallel.fused_bwd import (
    ComputeWeights, check_ported, fused_accumulate_grads, fused_bwd_supported,
)

__all__ = ["TrainState", "accumulate_grads", "guard_nonfinite",
           "init_train_state", "make_eval_step", "make_grads_fn",
           "make_train_step", "resolved_grad_engine"]


@dataclass
class TrainState:
    model: LlamaModel
    optimizer: Union[AdamW, OffloadAdamW]
    step: int = 0


def init_train_state(cfg: Config, model: LlamaModel) -> TrainState:
    """The model (fp32 params) and its optimizer. Under optimizer_offload
    the params become the master of `OffloadAdamW` (host memory, pinned
    on CUDA) and the model keeps their bf16 compute copy, as the JAX
    package's `_init_offload_state`."""
    if cfg.training.optimizer_offload:
        opt = OffloadAdamW(model, cfg.training, compute_dtype(model.cfg))
    else:
        opt = AdamW(model, cfg.training)
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
                     ce_chunk_size: int = 0, grads: Optional[dict] = None):
    """The AD engine. batch: (input_ids, targets), each [n_micro, mbs,
    seq] on the model's device; `remat` a remat policy name or None;
    `grads` the fp32 accumulators, {param: buffer} (the optimizer's
    `grad_of`; the params' .grad when None). Zeroes them, leaves the
    microbatches' summed NLL-sum grads there and returns (mean loss, 1 /
    token count), each a 0-dim fp32 tensor."""
    ids, tgt = batch
    grads = param_grads(model.parameters()) if grads is None else grads
    for buf in grads.values():
        buf.zero_()
    nll_total = torch.zeros((), dtype=torch.float32, device=ids.device)
    count = torch.zeros((), dtype=torch.int64, device=ids.device)
    for i in range(ids.shape[0]):
        total, c, _ = loss_sum_count(model, ids[i], tgt[i], remat,
                                     ce_chunk_size)
        total.backward()
        nll_total += total.detach()
        count += c
    count = count.clamp(min=1)
    return nll_total / count, torch.reciprocal(count.float())


def make_grads_fn(cfg: Config):
    """(model, batch, grads=None) -> (mean loss, 1 / token count), the
    summed grads left in `grads` (as `accumulate_grads`), by the config's
    resolved engine. The fused engine's bf16 weight copies are made for
    the model it first sees (again for another model) and refreshed from
    the masters on every call; over bf16 params they are the params."""
    t = cfg.training
    if resolved_grad_engine(cfg) != "fused":
        remat = t.remat_policy if t.remat else None
        return lambda model, batch, grads=None: accumulate_grads(
            model, batch, remat, t.ce_chunk_size, grads)
    check_ported(cfg)
    weights = None

    def fused(model: LlamaModel, batch, grads: Optional[dict] = None):
        nonlocal weights
        if weights is None or weights.model is not model:
            weights = ComputeWeights(model)
        weights.refresh()
        return fused_accumulate_grads(model, weights, batch, t.ce_chunk_size,
                                      grads=grads)

    return fused


def make_train_step(cfg: Config):
    """(state, batch) -> metrics: {"loss"} plus, with guards on,
    {"grad_norm", "nonfinite"}, each a 0-dim fp32 tensor on the device
    (nothing here syncs the host, except the count under "skip")."""
    grads_fn = make_grads_fn(cfg)
    guards_on = cfg.resilience.guard_policy != "off"
    guard_skip = cfg.resilience.guard_policy == "skip"

    def train_step(state: TrainState, batch) -> dict:
        opt = state.optimizer
        loss, scale = grads_fn(state.model, batch, opt.grad_of)
        metrics = {"loss": loss}
        gnorm = ok = None
        if guards_on:
            # One global norm covers every grad: any NaN/Inf poisons it,
            # so non-finite detection is one scalar check.
            with record_function("train_step.grad_norm"):
                gnorm = global_norm(opt.grads)
            shown = gnorm * scale
            finite = torch.isfinite(loss) & torch.isfinite(shown)
            metrics["grad_norm"] = shown
            metrics["nonfinite"] = 1.0 - finite.float()
            if guard_skip:
                ok = finite
        opt.step(scale, grad_norm=gnorm, ok=ok)
        state.step += 1
        return metrics

    return train_step


def make_eval_step(cfg: Config):
    """(model, batch) -> token-mean loss over the batch's microbatches, a
    0-dim fp32 tensor: forward only under no_grad (no graph, no grads), the
    validation half of the train step."""
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
        return total / count.clamp(min=1)

    return eval_step
