"""Single-device training and eval steps (port of picotron_tpu/train_step.py
and the single-device branch of picotron_tpu/parallel/api.py
`make_train_step` / `make_eval_step`): gradient accumulation over
microbatches, token-mean grads, one AdamW step.

Two grad engines, resolved as the JAX package resolves them
(`resolved_grad_engine`): "ad" runs autograd per microbatch, under the
config's remat policy (`models/llama.py` `remat_layer`), and its backward
passes sum into the params' fp32 .grad; "fused" is the manual backward of
`parallel/fused_bwd.py`, which accumulates each layer's weight grads into
.grad inside the GEMMs and reads per-step bf16 copies of the weights.
"auto" takes "fused" when gradient accumulation is on and the config is
eligible (remat "dots_attn"). Either way the sum of per-microbatch NLL
sums and the grads are divided once by the total valid-token count, so
uneven IGNORE_INDEX counts weigh microbatches correctly;
`training.ce_chunk_size` streams the head's CE over vocab chunks.

With `resilience.guard_policy != "off"` the step also returns the grads'
global norm (`grad_norm`, optax.global_norm) and an in-step `nonfinite`
flag, as the JAX step does; the same norm feeds clipping. Under "skip" a
non-finite step leaves params, moments and the AdamW count as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import record_function

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models.llama import LlamaModel, loss_sum_count
from picotron_tpu_torch.optimizer import (
    AdamW, global_norm, guard_nonfinite, make_optimizer,
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
    optimizer: AdamW
    step: int = 0


def init_train_state(cfg: Config, model: LlamaModel) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               cfg.training))


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
                     ce_chunk_size: int = 0):
    """The AD engine. batch: (input_ids, targets), each [n_micro, mbs,
    seq] on the model's device; `remat` a remat policy name or None.
    Leaves token-mean fp32 grads in p.grad; returns the mean loss (a 0-dim
    fp32 tensor)."""
    ids, tgt = batch
    for p in model.parameters():
        p.grad = None
    nll_total = torch.zeros((), dtype=torch.float32, device=ids.device)
    count = torch.zeros((), dtype=torch.int64, device=ids.device)
    for i in range(ids.shape[0]):
        total, c, _ = loss_sum_count(model, ids[i], tgt[i], remat,
                                     ce_chunk_size)
        total.backward()
        nll_total += total.detach()
        count += c
    count = count.clamp(min=1)
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(count)
    return nll_total / count


def make_grads_fn(cfg: Config):
    """(model, batch) -> mean loss, leaving token-mean fp32 grads in
    p.grad, by the config's resolved engine. The fused engine's bf16
    weight copies are made for the model it first sees (again for another
    model) and refreshed from the masters on every call."""
    t = cfg.training
    if resolved_grad_engine(cfg) != "fused":
        remat = t.remat_policy if t.remat else None
        return lambda model, batch: accumulate_grads(model, batch, remat,
                                                     t.ce_chunk_size)
    check_ported(cfg)
    weights = None

    def fused(model: LlamaModel, batch):
        nonlocal weights
        if weights is None or weights.model is not model:
            weights = ComputeWeights(model)
        weights.refresh()
        return fused_accumulate_grads(model, weights, batch, t.ce_chunk_size)

    return fused


def make_train_step(cfg: Config):
    """(state, batch) -> metrics: {"loss"} plus, with guards on,
    {"grad_norm", "nonfinite"}, each a 0-dim fp32 tensor on the device
    (nothing here syncs the host, except the count under "skip")."""
    grads_fn = make_grads_fn(cfg)
    guards_on = cfg.resilience.guard_policy != "off"
    guard_skip = cfg.resilience.guard_policy == "skip"

    def train_step(state: TrainState, batch) -> dict:
        loss = grads_fn(state.model, batch)
        metrics = {"loss": loss}
        gnorm = ok = None
        if guards_on:
            # One global norm covers every grad: any NaN/Inf poisons it,
            # so non-finite detection is one scalar check.
            with record_function("train_step.grad_norm"):
                gnorm = global_norm([p.grad for p in
                                     state.model.parameters()
                                     if p.grad is not None])
            finite = torch.isfinite(loss) & torch.isfinite(gnorm)
            metrics["grad_norm"] = gnorm
            metrics["nonfinite"] = 1.0 - finite.float()
            if guard_skip:
                ok = finite
        state.optimizer.step(grad_norm=gnorm, ok=ok)
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
