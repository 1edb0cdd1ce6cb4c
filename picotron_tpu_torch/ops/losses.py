"""Cross-entropy (port of picotron_tpu/ops/losses.py): fp32 upcast of the
logits and an IGNORE_INDEX mask, returned as the (sum, count) reduction
pieces so microbatches and shards can be summed before one division."""

from __future__ import annotations

import torch

IGNORE_INDEX = -100


def cross_entropy_sum_count(logits: torch.Tensor, targets: torch.Tensor):
    """(sum of per-token NLL, number of non-ignored tokens).

    logits: [..., vocab] (any float dtype; upcast to fp32)
    targets: [...] int labels, IGNORE_INDEX entries excluded."""
    logits = logits.float()
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, safe[..., None]).squeeze(-1)
    nll = torch.where(valid, logz - label_logit, torch.zeros_like(logz))
    return nll.sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy over the non-ignored tokens."""
    total, count = cross_entropy_sum_count(logits, targets)
    return total / count.clamp(min=1)
