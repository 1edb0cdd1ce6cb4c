"""Cross-entropy (port of picotron_tpu/ops/losses.py): fp32 upcast of the
logits and an IGNORE_INDEX mask, returned as the (sum, count) reduction
pieces so microbatches and shards can be summed before one division.

`chunked_cross_entropy_sum_count` is the streaming form of the LM head's
loss (port of picotron_tpu/parallel/tp.py `vocab_parallel_ce_sum_count`
-> `_chunked_local_stats` at tp 1): the head matmul runs over vocab chunks
with a running (max, sumexp, label) merge, so the [tokens, vocab] logits
never exist, neither in the forward nor as a saved residual: the backward
recomputes each chunk's logits from the saved hidden and head.
"""

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


def _chunk_logits(hidden, head, off, chunk):
    """fp32 logits of one vocab chunk: hidden [N, H] against head rows
    [off, off + chunk), the head cast to the hidden's dtype (the JAX
    `hidden @ wc.astype(hidden.dtype)`)."""
    w = head[off:off + chunk].to(hidden.dtype)
    return (hidden @ w.t()).float()


class _ChunkedCE(torch.autograd.Function):
    """NLL sum over vocab chunks. Saves hidden, head and the [N] fp32 logz;
    the backward rebuilds each chunk's softmax from them."""

    @staticmethod
    def forward(ctx, hidden, head, safe, valid, chunk):
        n = hidden.shape[0]
        m = torch.full((n,), float("-inf"), device=hidden.device)
        se = torch.zeros(n, device=hidden.device)
        label = torch.zeros(n, device=hidden.device)
        for off in range(0, head.shape[0], chunk):
            logits = _chunk_logits(hidden, head, off, chunk)
            # the max is a shift constant: no gradient flows through it
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # m = -inf on the first chunk scales the zero se by exp(-inf) = 0
            se = (se * torch.exp(m - m_new)
                  + torch.exp(logits - m_new[:, None]).sum(dim=-1))
            rc = safe - off
            ok = (rc >= 0) & (rc < chunk)
            lab = torch.gather(logits, 1, rc.clamp(0, chunk - 1)[:, None])
            label = label + lab.squeeze(1) * ok.float()
            m = m_new
        logz = m + torch.log(se)
        nll = torch.where(valid, logz - label, torch.zeros_like(logz))
        ctx.save_for_backward(hidden, head, safe, valid, logz)
        ctx.chunk = chunk
        return nll.sum()

    @staticmethod
    def backward(ctx, g):
        hidden, head, safe, valid, logz = ctx.saved_tensors
        chunk = ctx.chunk
        scale = valid.float() * g
        dhidden = torch.zeros(hidden.shape, dtype=torch.float32,
                              device=hidden.device)
        dhead = torch.empty_like(head)
        for off in range(0, head.shape[0], chunk):
            # d nll / d logits = softmax - onehot(label), on valid rows
            p = torch.exp(_chunk_logits(hidden, head, off, chunk)
                          - logz[:, None])
            rc = safe - off
            ok = (rc >= 0) & (rc < chunk)
            p.scatter_add_(1, rc.clamp(0, chunk - 1)[:, None],
                           -ok.float()[:, None])
            dlogits = (p * scale[:, None]).to(hidden.dtype)
            w = head[off:off + chunk].to(hidden.dtype)
            dhidden += (dlogits @ w).float()
            dhead[off:off + chunk] = (dlogits.t() @ hidden).to(head.dtype)
        return dhidden.to(hidden.dtype), dhead, None, None, None


def chunked_cross_entropy_sum_count(hidden: torch.Tensor, head: torch.Tensor,
                                    targets: torch.Tensor, chunk_size: int):
    """(sum of per-token NLL, number of non-ignored tokens) of
    `hidden @ head.T` without the full logits: hidden [..., H] (compute
    dtype), head [V, H] (any float dtype, cast per chunk), targets [...];
    `chunk_size` must divide V. Matches `cross_entropy_sum_count` on the
    full logits to fp32 round-off."""
    vocab = head.shape[0]
    if chunk_size <= 0 or vocab % chunk_size:
        raise ValueError(f"chunk_size {chunk_size} must be positive and "
                         f"divide the vocab ({vocab})")
    valid = (targets != IGNORE_INDEX).reshape(-1)
    safe = torch.where(valid, targets.reshape(-1), 0).long()
    total = _ChunkedCE.apply(hidden.reshape(-1, hidden.shape[-1]), head,
                             safe, valid, chunk_size)
    return total, valid.sum()
