"""Single-device training step (port of picotron_tpu/train_step.py):
gradient accumulation over microbatches, token-mean grads, one AdamW step.

The JAX `lax.scan` over microbatches becomes a Python loop whose backward
passes sum into the params' fp32 .grad; the sum of per-microbatch NLL sums
and the grads are divided once by the total valid-token count, so uneven
IGNORE_INDEX counts weigh microbatches correctly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models.llama import LlamaModel, loss_sum_count
from picotron_tpu_torch.optimizer import AdamW, make_optimizer


@dataclass
class TrainState:
    model: LlamaModel
    optimizer: AdamW
    step: int = 0


def init_train_state(cfg: Config, model: LlamaModel) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               cfg.training))


def guard_nonfinite(ok: torch.Tensor, new_tensors, old_tensors) -> None:
    """The divergence guard's 'skip' half: where `ok` (a scalar bool: loss
    and grad norm finite) is False, copy each old tensor back over its new
    one in place, discarding a poisoned update."""
    for n, o in zip(new_tensors, old_tensors):
        n.copy_(torch.where(ok, n, o))


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
    """(state, batch) -> loss: accumulate grads, one optimizer step."""

    def train_step(state: TrainState, batch) -> torch.Tensor:
        loss = accumulate_grads(state.model, batch)
        state.optimizer.step()
        state.step += 1
        return loss

    return train_step
