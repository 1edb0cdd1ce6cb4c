"""Single-device training and eval steps (port of picotron_tpu/train_step.py
and the single-device branch of picotron_tpu/parallel/api.py
`make_train_step` / `make_eval_step`): gradient accumulation over
microbatches, token-mean grads, one AdamW step.

The JAX `lax.scan` over microbatches becomes a Python loop whose backward
passes sum into the params' fp32 .grad; the sum of per-microbatch NLL sums
and the grads are divided once by the total valid-token count, so uneven
IGNORE_INDEX counts weigh microbatches correctly.

With `resilience.guard_policy != "off"` the step also returns the grads'
global norm (`grad_norm`, optax.global_norm) and an in-step `nonfinite`
flag, as the JAX step does; the same norm feeds clipping. Under "skip" a
non-finite step leaves params, moments and the AdamW count as they were.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models.llama import LlamaModel, loss_sum_count
from picotron_tpu_torch.optimizer import (
    AdamW, global_norm, guard_nonfinite, make_optimizer,
)

__all__ = ["TrainState", "accumulate_grads", "guard_nonfinite",
           "init_train_state", "make_eval_step", "make_train_step"]


@dataclass
class TrainState:
    model: LlamaModel
    optimizer: AdamW
    step: int = 0


def init_train_state(cfg: Config, model: LlamaModel) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               cfg.training))


def accumulate_grads(model: LlamaModel, batch):
    """batch: (input_ids, targets), each [n_micro, mbs, seq] on the model's
    device. Leaves token-mean fp32 grads in p.grad; returns the mean loss
    (a 0-dim fp32 tensor)."""
    ids, tgt = batch
    for p in model.parameters():
        p.grad = None
    nll_total = torch.zeros((), dtype=torch.float32, device=ids.device)
    count = torch.zeros((), dtype=torch.int64, device=ids.device)
    for i in range(ids.shape[0]):
        total, c, _ = loss_sum_count(model, ids[i], tgt[i])
        total.backward()
        nll_total += total.detach()
        count += c
    count = count.clamp(min=1)
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(count)
    return nll_total / count


def make_train_step(cfg: Config):
    """(state, batch) -> metrics: {"loss"} plus, with guards on,
    {"grad_norm", "nonfinite"}, each a 0-dim fp32 tensor on the device
    (nothing here syncs the host, except the count under "skip")."""
    guards_on = cfg.resilience.guard_policy != "off"
    guard_skip = cfg.resilience.guard_policy == "skip"

    def train_step(state: TrainState, batch) -> dict:
        loss = accumulate_grads(state.model, batch)
        metrics = {"loss": loss}
        gnorm = ok = None
        if guards_on:
            # One global norm covers every grad: any NaN/Inf poisons it,
            # so non-finite detection is one scalar check.
            gnorm = global_norm([p.grad for p in state.model.parameters()
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

    @torch.no_grad()
    def eval_step(model: LlamaModel, batch) -> torch.Tensor:
        ids, tgt = batch
        total = torch.zeros((), dtype=torch.float32, device=ids.device)
        count = torch.zeros((), dtype=torch.int64, device=ids.device)
        for i in range(ids.shape[0]):
            t, c, _ = loss_sum_count(model, ids[i], tgt[i])
            total += t
            count += c
        return total / count.clamp(min=1)

    return eval_step
