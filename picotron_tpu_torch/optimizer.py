"""AdamW over fp32 master params (port of picotron_tpu/optimizer.py).

`make_optimizer` applies the JAX package's optax chain step for step:

    clip_by_global_norm (when grad_clip_norm > 0)
    -> scale_by_adam with fp32 moments (optax.adamw), or
       scale_by_adam_low_moments: fp32 math, both moments stored in bf16
    -> add_decayed_weights on every param (no mask)
    -> scale by -lr, lr evaluated at the step count BEFORE the increment
       (so with warmup the first update uses lr = 0), then p += update.

Plain torch ops, as the JAX package left AdamW to XLA. The moments are
updated in place. Clipping selects with `torch.where` on a norm the step
passes in (optax's `select`), so it costs no host sync; the divergence
guard's `skip` suppresses a non-finite update per tensor in place
(`guard_nonfinite`). The host-offloaded optimizer (optimizer_offload) is
not in this slice.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from picotron_tpu_torch.config import TrainingConfig


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1.0 - c / steps) + end
    return f


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    def f(count: int) -> float:
        c = min(count, steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / steps))
        return init * ((1.0 - alpha) * decay + alpha)
    return f


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: the fp32 L2 norm over every tensor, as a 0-dim
    tensor, in two fused reductions (one norm per tensor by
    `torch._foreach_norm`, then the norm of those norms) and no host
    sync. A NaN or Inf anywhere makes it non-finite."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def guard_nonfinite(ok: torch.Tensor, new_tensors, old_tensors) -> None:
    """The divergence guard's 'skip' half: where `ok` (a 0-dim bool: loss
    and grad norm finite) is False, copy each old tensor back over its new
    one in place, discarding a poisoned update."""
    for n, o in zip(new_tensors, old_tensors):
        n.copy_(torch.where(ok, n, o))


def make_lr(t: TrainingConfig) -> Union[float, Callable[[int], float]]:
    """A float, or a function of the optimizer step count (optax's
    schedules: warmup via join_schedules, then cosine/linear/constant)."""
    if t.lr_schedule == "constant" and t.lr_warmup_steps == 0:
        return t.learning_rate
    peak, floor = t.learning_rate, t.learning_rate * t.lr_min_ratio
    decay_steps = max(1, t.total_train_steps - t.lr_warmup_steps)
    if t.lr_schedule == "cosine":
        decay = _cosine(peak, decay_steps, t.lr_min_ratio)
    elif t.lr_schedule == "linear":
        decay = _linear(peak, floor, decay_steps)
    else:
        decay = lambda count: peak  # noqa: E731
    if t.lr_warmup_steps == 0:
        return decay
    warm = _linear(0.0, peak, t.lr_warmup_steps)
    boundary = t.lr_warmup_steps
    return lambda count: (warm(count) if count < boundary
                          else decay(count - boundary))


class AdamW(torch.optim.Optimizer):
    """The optax chain above as a torch optimizer. `step()` reads p.grad
    (the token-mean fp32 grads of `train_step.accumulate_grads`)."""

    def __init__(self, params, t: TrainingConfig):
        super().__init__(params, {})
        self.t = t
        self.lr = make_lr(t)
        self.low_moments = t.adam_moments_dtype == "bfloat16"
        self.moments_dtype = (torch.bfloat16 if self.low_moments
                              else torch.float32)
        self.count = 0  # optimizer steps taken (optax's state.count)

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def moments(self, p: torch.Tensor) -> dict:
        """p's AdamW state {"mu", "nu"} in the moments dtype, made as zeros
        on first use (optax's init)."""
        st = self.state[p]
        if not st:
            st["mu"] = torch.zeros_like(p, dtype=self.moments_dtype)
            st["nu"] = torch.zeros_like(p, dtype=self.moments_dtype)
        return st

    @torch.no_grad()
    def step(self, closure=None, grad_norm: Optional[torch.Tensor] = None,
             ok: Optional[torch.Tensor] = None):
        """One update from p.grad. `grad_norm`: the grads' global norm when
        the caller has it (else computed here when clipping needs it).
        `ok`: a 0-dim bool; when given and False, params, moments and the
        count keep their old values (the guard's skip policy; reading `ok`
        for the count syncs the host once)."""
        t = self.t
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        clip = t.grad_clip_norm > 0
        if clip:
            if grad_norm is None:
                grad_norm = global_norm([p.grad for p in params])
            # optax.clip_by_global_norm: select, not a host branch
            trigger = grad_norm < t.grad_clip_norm
        lr = self.lr_at(self.count)
        count = self.count + 1
        b1, b2, eps, wd = t.adam_beta1, t.adam_beta2, t.adam_eps, t.weight_decay
        # bias corrections in fp32 (optax computes decay ** count there)
        cnt = torch.tensor(float(count), dtype=torch.float32)
        c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** cnt)
        c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** cnt)
        for p in params:
            st = self.moments(p)
            g = p.grad
            if clip:
                g = torch.where(trigger, g, (g / grad_norm) * t.grad_clip_norm)
            old = ((p.clone(), st["mu"].clone(), st["nu"].clone())
                   if ok is not None else None)
            g = g.float()
            if self.low_moments:
                mu = b1 * st["mu"].float() + (1 - b1) * g
                nu = b2 * st["nu"].float() + (1 - b2) * (g * g)
                st["mu"].copy_(mu)
                st["nu"].copy_(nu)
            else:  # optax.scale_by_adam's update_moment order
                mu = st["mu"].mul_(b1).add_((1 - b1) * g)
                nu = st["nu"].mul_(b2).add_((1 - b2) * (g * g))
            upd = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            upd = upd + wd * p
            p.add_(upd * -lr)
            if old is not None:
                guard_nonfinite(ok, (p, st["mu"], st["nu"]), old)
        self.count = count if ok is None or bool(ok) else self.count


def make_optimizer(params, t: TrainingConfig) -> AdamW:
    if t.optimizer_offload:
        raise NotImplementedError(
            "training.optimizer_offload is not ported yet (ROADMAP Queue 1 "
            "item 4, offload half)")
    return AdamW(params, t)
