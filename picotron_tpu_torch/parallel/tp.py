"""Megatron tensor parallelism over a tp process group (port of
picotron_tpu/parallel/tp.py and the tp/SP hooks of
picotron_tpu/parallel/api.py `make_parallel_ctx`).

Each rank holds its shard of the weights (`parallel/sharding.py`):
column-parallel q/k/v/gate/up produce this rank's heads or ffn columns,
row-parallel o/down produce partial sums. The JAX package writes only the
forward collectives and lets shard_map transpose them; here each
collective that needs a transpose is a `torch.autograd.Function`:

- Megatron's f (`_CopyToTP`): identity forward, all-reduce of the grad
  backward, at every column-parallel entry;
- g (`_ReduceFromTP`): all-reduce forward, identity backward, at every
  row-parallel exit;
- under sequence parallelism (the residual stream seq-sharded [B, S/tp,
  H] between blocks), f is `_GatherSeq` (all-gather over the sequence,
  reduce-scatter backward) and g `_ScatterSeq` (reduce-scatter,
  all-gather backward): `sp_gather_seq` / `sp_scatter_seq` (:74, :79).
  `TPContext.f_transpose` / `g_transpose` are the same transposes for
  the fused engine's manual backward.

`vocab_parallel_embed` (:36) masks out-of-shard ids and reduces (or
reduce-scatters the sequence under SP); `vocab_parallel_ce_sum_count`
(:85) takes the softmax statistics of this rank's vocab shard (whole, or
in chunks, `_chunked_local_stats` :142) and merges them with one max
all-reduce and one sum all-reduce, so the gathered [B, S, V] logits never
exist; `gather_logits` (:219) assembles the full-vocab logits for eval.
`TPContext` holds a rank's tp group and the hooks that depend on the
layout (the tp side of the JAX `ParallelCtx`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.parallel import comm


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    return comm.all_reduce(out, group)


def gather_dim1(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, s, ...] -> [B, n*s, ...]: every rank's x along dim 1, in
    group-rank order."""
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    comm.all_gather_into(out, x, group)
    out = out.reshape((n,) + x.shape).movedim(0, 1)
    return out.reshape((x.shape[0], n * x.shape[1]) + x.shape[2:])


def scatter_dim1(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[B, S, ...] -> [B, S/n, ...]: this rank's slice of dim 1 of the sum
    of every rank's x."""
    b, s = x.shape[:2]
    parts = x.reshape((b, n, s // n) + x.shape[2:]).movedim(1, 0)
    parts = parts.contiguous().reshape((n * b, s // n) + x.shape[2:])
    out = parts.new_empty((b, s // n) + x.shape[2:])
    comm.reduce_scatter_into(out, parts, group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return gather_dim1(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim1(g, ctx.group, ctx.n), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return scatter_dim1(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return gather_dim1(g, ctx.group, ctx.n), None, None


class _SplitOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


@dataclass(frozen=True)
class TPContext:
    """The tp hooks of one rank: its tp group, its coordinate and the
    group's size, and whether the residual stream is seq-sharded."""

    group: object
    rank: int
    size: int
    sequence_parallel: bool = False

    # -- Megatron's f and g, and their transposes ---------------------------

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Column-parallel entry: identity (SP: all-gather the sequence);
        backward all-reduce (SP: reduce-scatter)."""
        if self.sequence_parallel:
            return _GatherSeq.apply(x, self.group, self.size)
        return _CopyToTP.apply(x, self.group)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel exit: all-reduce (SP: reduce-scatter the
        sequence); backward identity (SP: all-gather)."""
        if self.sequence_parallel:
            return _ScatterSeq.apply(x, self.group, self.size)
        return _ReduceFromTP.apply(x, self.group)

    def f_transpose(self, dx: torch.Tensor) -> torch.Tensor:
        """The grad through f, for a manual backward."""
        if self.sequence_parallel:
            return scatter_dim1(dx, self.group, self.size)
        return _all_reduce(dx, self.group)

    def g_transpose(self, dy: torch.Tensor) -> torch.Tensor:
        """The grad through g, for a manual backward."""
        if self.sequence_parallel:
            return gather_dim1(dy, self.group, self.size)
        return dy

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        """A value computed alike on every tp rank from the gathered
        tokens (the MoE router loss) entering each rank's loss: identity
        forward, its grad divided by tp backward, so that the router's
        grads, partial over tp like the expert path's, sum over tp to
        the whole (the transpose of the JAX `moe_aux_sync` pmean)."""
        return _SplitOverTP.apply(t, self.size)

    def head_ce(self, x, head_shard, targets, chunk_size: int = 0):
        """(NLL sum, valid count) of x against the vocab-sharded head; x
        is the final-norm output (seq-sharded under SP: f gathers it)."""
        return vocab_parallel_ce_sum_count(self.f(x), head_shard, targets,
                                           self, chunk_size)


def tp_context(par, sequence_parallel: bool = False):
    """The TPContext of a rank (`mesh.ParallelEnv`), or None without tp
    (no layout, or tp 1: the model is then the single-device one)."""
    if par is None or par.tp_size == 1:
        return None
    return TPContext(par.tp_group, par.tp_rank, par.tp_size,
                     sequence_parallel)


def _shard_rows(ids: torch.Tensor, vshard: int, tp: TPContext):
    """(row in this rank's shard, clamped; whether the id is in it)."""
    rel = ids - tp.rank * vshard
    ok = (rel >= 0) & (rel < vshard)
    return rel.clamp(0, vshard - 1), ok


def vocab_parallel_embed(w_shard: torch.Tensor, ids: torch.Tensor,
                         tp: TPContext) -> torch.Tensor:
    """Embedding rows with the vocab sharded over tp: w_shard [V/tp, H],
    ids [B, S] (the same on every tp rank). Out-of-shard ids contribute
    zero and the sum over tp assembles each row, [B, S, H]; under SP the
    sum is a reduce-scatter handing each rank its [B, S/tp, H] slice."""
    rel, ok = _shard_rows(ids, w_shard.shape[0], tp)
    x = w_shard[rel] * ok[..., None].to(w_shard.dtype)
    return tp.g(x)


def vocab_parallel_embed_grad(acc: torch.Tensor, ids: torch.Tensor,
                              dy: torch.Tensor, tp: TPContext) -> None:
    """The transpose of `vocab_parallel_embed` for a manual backward: add
    the grad of its output `dy` (seq-sharded under SP) into this rank's
    embedding-shard accumulator `acc` [V/tp, H]."""
    dy = tp.g_transpose(dy).to(acc.dtype)
    rel, ok = _shard_rows(ids, acc.shape[0], tp)
    acc.index_put_((rel,), dy * ok[..., None].to(acc.dtype), accumulate=True)


def _local_logits(hidden, head, off=0, n=None):
    w = head if n is None else head[off:off + n]
    return F.linear(hidden, w.to(hidden.dtype)).float()


class _ChunkedLocalStats(torch.autograd.Function):
    """This shard's (max, sumexp, label logit) per token over vocab chunks
    of its head rows, never holding the [N, V/tp] logits: the forward
    merges a running max; the backward rebuilds each chunk's logits from
    the saved hidden and head. The max is a shift constant and takes no
    gradient (the JAX stop_gradient)."""

    @staticmethod
    def forward(ctx, hidden, head, rel, chunk):
        n, vshard = hidden.shape[0], head.shape[0]
        m = torch.full((n,), float("-inf"), device=hidden.device)
        se = torch.zeros(n, device=hidden.device)
        label = torch.zeros(n, device=hidden.device)
        for off in range(0, vshard, chunk):
            logits = _local_logits(hidden, head, off, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            se = (se * torch.exp(m - m_new)
                  + torch.exp(logits - m_new[:, None]).sum(dim=-1))
            rc = rel - off
            ok = (rc >= 0) & (rc < chunk)
            lab = torch.gather(logits, 1, rc.clamp(0, chunk - 1)[:, None])
            label = label + lab.squeeze(1) * ok.float()
            m = m_new
        ctx.save_for_backward(hidden, head, rel, m)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(m)
        return m, se, label

    @staticmethod
    def backward(ctx, _dm, dse, dlabel):
        hidden, head, rel, m = ctx.saved_tensors
        chunk = ctx.chunk
        dhidden = torch.zeros(hidden.shape, dtype=torch.float32,
                              device=hidden.device)
        dhead = torch.empty_like(head)
        for off in range(0, head.shape[0], chunk):
            # d se / d logit = exp(logit - m); d label / d logit = onehot
            p = (torch.exp(_local_logits(hidden, head, off, chunk)
                           - m[:, None]) * dse[:, None])
            rc = rel - off
            ok = (rc >= 0) & (rc < chunk)
            p.scatter_add_(1, rc.clamp(0, chunk - 1)[:, None],
                           (dlabel * ok.float())[:, None])
            dlogits = p.to(hidden.dtype)
            w = head[off:off + chunk].to(hidden.dtype)
            dhidden += (dlogits @ w).float()
            dhead[off:off + chunk] = (dlogits.t() @ hidden).to(head.dtype)
        return dhidden.to(hidden.dtype), dhead, None, None


def vocab_parallel_ce_sum_count(hidden: torch.Tensor, head_shard: torch.Tensor,
                                targets: torch.Tensor, tp: TPContext,
                                chunk_size: int = 0):
    """(sum of per-token NLL, valid-token count) against a vocab-sharded
    head: hidden [B, S, H] (the same on every tp rank), head_shard [V/tp,
    H], targets [B, S] with IGNORE_INDEX allowed. Both outputs are the
    same on every tp rank. `chunk_size` (dividing V/tp, smaller than it)
    streams the local logits over vocab chunks."""
    vshard = head_shard.shape[0]
    valid = targets != IGNORE_INDEX
    rel = torch.where(valid, targets, 0) - tp.rank * vshard
    if chunk_size and chunk_size < vshard and vshard % chunk_size == 0:
        h2 = hidden.reshape(-1, hidden.shape[-1])
        m_loc, se_loc, lab_loc = (t.reshape(targets.shape) for t in
                                  _ChunkedLocalStats.apply(
                                      h2, head_shard, rel.reshape(-1).long(),
                                      chunk_size))
    else:
        logits = _local_logits(hidden, head_shard)
        m_loc = logits.amax(dim=-1).detach()
        se_loc = torch.exp(logits - m_loc[..., None]).sum(dim=-1)
        ok = (rel >= 0) & (rel < vshard)
        lab_loc = (torch.gather(logits, -1,
                                rel.clamp(0, vshard - 1)[..., None].long())
                   .squeeze(-1) * ok.float())
    # merge: the max over tp (a shift constant), then one sum over tp of
    # both the rescaled sumexp and the label logit
    m = comm.all_reduce(m_loc.detach().clone(), tp.group, dist.ReduceOp.MAX)
    se, label = _ReduceFromTP.apply(
        torch.stack([se_loc * torch.exp(m_loc - m), lab_loc]),
        tp.group).unbind(0)
    logz = m + torch.log(se)
    nll = torch.where(valid, logz - label, torch.zeros_like(logz))
    return nll.sum(), valid.sum()


def gather_logits(logits: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """[..., V/tp] vocab-sharded logits -> [..., V] (eval; no grad)."""
    x = logits.detach().contiguous()
    out = x.new_empty((tp.size * x.shape[0],) + x.shape[1:])
    comm.all_gather_into(out, x, tp.group)
    return torch.cat(out.chunk(tp.size, dim=0), dim=-1)
