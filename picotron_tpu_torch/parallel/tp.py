"""Megatron tensor parallelism over a tp process group (port of
picotron_tpu/parallel/tp.py and the tp/SP hooks of
picotron_tpu/parallel/api.py `make_parallel_ctx`).

Each rank holds its shard of the weights (`parallel/sharding.py`):
column-parallel q/k/v/gate/up produce this rank's heads or ffn columns,
row-parallel o/down produce partial sums. The JAX package writes only the
forward collectives and lets shard_map transpose them; here each
collective that needs a transpose is one of the differentiable pairs of
the rank's tp communicator (`parallel/comm.GroupComm`, `TPContext.comm`):

- Megatron's f (`copy`): identity forward, all-reduce of the grad
  backward, at every column-parallel entry;
- g (`reduce`): all-reduce forward, identity backward, at every
  row-parallel exit;
- under sequence parallelism (the residual stream seq-sharded [B, S/tp,
  H] between blocks), f is `gather` over the sequence (reduce-scatter
  backward) and g `scatter` (reduce-scatter, all-gather backward);
- under the deferred sync (`distributed.tp_sync="deferred"`, the JAX
  `tp_strategy_hooks`' deferred set) the residual stream is seq-sharded
  as under SP, but the gather moves before the norm (`pre`, at each
  block's entry, and `head_in` before the head), f is the identity both
  ways, and g the sequence reduce-scatter. The norms then run on the
  whole sequence from a partial grad, so their grads are partial over tp
  as under SP (`parallel/sharding.tp_partial`).

`TPContext.f_transpose`, `g_transpose`, `pre_transpose` and
`head_in_transpose` are the same transposes for the fused engine's
manual backward. The 2d and row-first strategies' hooks live in
`parallel/tp_strategies.py` (`TPContext.strategy`).

`vocab_parallel_embed` masks out-of-shard ids and reduces (or
reduce-scatters the sequence under SP and deferred sync);
`vocab_parallel_ce_sum_count` takes the softmax statistics of this
rank's vocab shard (whole, or in chunks, `_ChunkedLocalStats`) and
merges them with one max all-reduce and one sum all-reduce, so the
gathered [B, S, V] logits never exist; `gather_logits` assembles the
full-vocab logits for eval. `TPContext` holds a rank's tp communicator
and the hooks that depend on the layout (the tp side of the JAX
`ParallelCtx`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.nn.functional as F

from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.parallel import comm


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
    """The tp hooks of one rank: its tp group (a process group, or a
    `comm.GroupComm` of its own, such as a thread world's), its
    coordinate and the group's size, whether the residual stream is
    seq-sharded by sequence parallelism (`sequence_parallel`) or by the
    deferred sync (`deferred`), and the 2d/row-first hooks
    (`parallel.tp_strategies.TPStrategy`, None under megatron)."""

    group: object
    rank: int
    size: int
    sequence_parallel: bool = False
    deferred: bool = False
    strategy: object = None
    comm: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.comm is None:
            object.__setattr__(self, "comm", self.group if isinstance(
                self.group, comm.GroupComm) else comm.GroupComm(
                    self.group, self.size, self.rank))

    @property
    def seq_sharded(self) -> bool:
        """The residual stream between blocks is [B, S/tp, H]."""
        return self.sequence_parallel or self.deferred

    # -- Megatron's f and g, and their transposes ---------------------------

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Column-parallel entry: identity, backward all-reduce (SP:
        all-gather the sequence, backward reduce-scatter; deferred: the
        identity both ways, the gather having moved to `pre`)."""
        if self.deferred:
            return x
        if self.sequence_parallel:
            return self.comm.gather(x, 1)
        return self.comm.copy(x)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel exit: all-reduce, backward identity (SP and
        deferred: reduce-scatter the sequence, backward all-gather)."""
        if self.seq_sharded:
            return self.comm.scatter(x, 1)
        return self.comm.reduce(x)

    def pre(self, x: torch.Tensor) -> torch.Tensor:
        """The block entry before the norm: deferred sync's hoisted
        sequence all-gather (backward reduce-scatter); else identity."""
        return self.comm.gather(x, 1) if self.deferred else x

    def head_in(self, x: torch.Tensor) -> torch.Tensor:
        """The head's entry: f, or under deferred sync the sequence
        gather (the JAX `head_in` hook)."""
        return self.comm.gather(x, 1) if self.deferred else self.f(x)

    def f_transpose(self, dx: torch.Tensor) -> torch.Tensor:
        """The grad through f, for a manual backward."""
        if self.deferred:
            return dx
        if self.sequence_parallel:
            return self.comm.reduce_scatter(dx, 1)
        return self.comm.all_reduce(dx.contiguous().clone())

    def g_transpose(self, dy: torch.Tensor) -> torch.Tensor:
        """The grad through g, for a manual backward."""
        if self.seq_sharded:
            return self.comm.all_gather(dy, 1)
        return dy

    def pre_transpose(self, dx: torch.Tensor) -> torch.Tensor:
        """The grad through `pre`, for a manual backward."""
        return self.comm.reduce_scatter(dx, 1) if self.deferred else dx

    def head_in_transpose(self, dx: torch.Tensor) -> torch.Tensor:
        """The grad through `head_in`, for a manual backward."""
        if self.deferred:
            return self.comm.reduce_scatter(dx, 1)
        return self.f_transpose(dx)

    def head_in_raw(self, x: torch.Tensor) -> torch.Tensor:
        """`head_in`'s forward outside autograd (a manual backward takes
        `head_in_transpose`)."""
        if self.deferred or self.sequence_parallel:
            return self.comm.all_gather(x, 1)
        return x

    def replicated(self, t: torch.Tensor) -> torch.Tensor:
        """A value computed alike on every tp rank from the gathered
        tokens (the MoE router loss) entering each rank's loss: identity
        forward, its grad divided by tp backward, so that the router's
        grads, partial over tp like the expert path's, sum over tp to
        the whole (the transpose of the JAX `moe_aux_sync` pmean)."""
        return _SplitOverTP.apply(t, self.size)

    def head_ce(self, x, head_shard, targets, chunk_size: int = 0):
        """(NLL sum, valid count) of x against the vocab-sharded head; x
        is the final-norm output (seq-sharded under SP and deferred sync:
        `head_in` gathers it)."""
        return vocab_parallel_ce_sum_count(self.head_in(x), head_shard,
                                           targets, self, chunk_size)


def tp_context(par, sequence_parallel: bool = False, cfg=None):
    """The TPContext of a rank (`mesh.ParallelEnv`), or None without tp
    (no layout, or tp 1: the model is then the single-device one). With
    the config (`cfg`), its tp strategy and sync mode
    (`parallel/tp_strategies.py`)."""
    if par is None or par.tp_size == 1:
        return None
    if cfg is None:
        return TPContext(par.tp_group, par.tp_rank, par.tp_size,
                         sequence_parallel)
    from picotron_tpu_torch.parallel.tp_strategies import strategy_for

    return TPContext(par.tp_group, par.tp_rank, par.tp_size,
                     sequence_parallel,
                     deferred=cfg.distributed.tp_sync == "deferred",
                     strategy=strategy_for(cfg, par))


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
    m = tp.comm.all_reduce(m_loc.detach().clone(), dist.ReduceOp.MAX)
    se, label = tp.comm.reduce(
        torch.stack([se_loc * torch.exp(m_loc - m), lab_loc])).unbind(0)
    logz = m + torch.log(se)
    nll = torch.where(valid, logz - label, torch.zeros_like(logz))
    return nll.sum(), valid.sum()


def gather_logits(logits: torch.Tensor, tp: TPContext) -> torch.Tensor:
    """[..., V/tp] vocab-sharded logits -> [..., V] (eval; no grad)."""
    return tp.comm.all_gather(logits.detach(), -1)
