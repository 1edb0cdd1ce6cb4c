"""The collectives of the parallel layouts, each a `torch.distributed`
call on an explicit process group (NCCL on CUDA, gloo on the CPU): the
port's counterpart of the JAX package's named-axis `lax.psum` /
`all_gather` / `psum_scatter`, which XLA schedules there.

`collectives` counts the calls by kind since the last reset (the
trainer reports them per step; `chip_smoke.py` checks that the layouts
launched them). Host-side agreement on the checkpoint group (barriers,
object broadcasts) is not counted: it moves no tensor of the model.

The context-parallel schedules (`ops/ring_attention.py`,
`ops/ulysses.py`, `ops/mesh_attention.py`) reach their exchanges through
a communicator, the counterpart of the JAX package's named `axis`
argument: `CPComm` here, on the rank's cp process group, or any object
with the same `size`, `index`, `hop`, `all_to_all` and `all_gather`
(`chip_smoke.py`'s thread world drives the same schedule code through
one that hands tensors between threads). A communicator speaks in cp
indices (0..cp-1); `CPComm` maps them to global ranks:

- `hop` (`lax.ppermute`): one `dist.batch_isend_irecv` per hop that
  carries every tensor of the hop, counted once as "send_recv";
- `all_to_all` (`lax.all_to_all(..., tiled=True)`, optionally over row
  subgroups, `axis_index_groups`): `dist.all_to_all_single` with the
  split axis moved to dim 0, counted as "all_to_all";
- `all_gather` (dim 0, the positions' gather where a layout is not
  static): counted as "all_gather".

The pipeline's walk (`parallel/pp.py`) reaches its exchanges the same
way: `PPComm` on the rank's pp group, or the thread world's
communicator, with the same `exchange` and `all_reduce`. A pipeline
communicator speaks in stage indices (0..pp-1). `exchange(sends, recvs)`
is `hop` for the two directions of a tick: every send and receive that
the schedule table places at one tick boundary (activations to later
stages, cotangents to earlier ones) goes in one
`dist.batch_isend_irecv`, counted once as "send_recv", which is the JAX
package's pair of `ppermute`s per tick. Both sides of every exchange are
derived from the same table, so each send meets its receive in the same
batch and no rank blocks on a peer that is itself blocked sending.

Expert parallelism (`ops/moe.py`) reaches its exchange through `EPComm`
on the rank's ep group, or the thread world's: `size`, `index` and
`all_to_all(x)`, x [ep, ...] with chunk j sent to ep index j (the JAX
`lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=False)`), one
`dist.all_to_all_single` counted as "all_to_all", differentiable (its
transpose is the same exchange). The MoE router statistics' mean over
the data group is `GroupMean.mean` (one all-reduce each way, counted as
"all_reduce"; the JAX `lax.pmean`, whose transpose is again a mean).

Tensor parallelism (`parallel/tp.py`, `parallel/tp_strategies.py`)
reaches its collectives through `GroupComm`, one per group (the tp
group, and under the 2d strategy its ty and tx subgroups): the raw
`all_reduce`, `all_gather` and `reduce_scatter` along any dim, and the
differentiable pairs the layouts are made of, each named by its forward
and its backward:

    copy          identity          all-reduce      (Megatron's f)
    reduce        all-reduce        identity        (Megatron's g)
    gather        all-gather        reduce-scatter  (SP's f)
    scatter       reduce-scatter    all-gather      (SP's g)
    gather_slice  all-gather        own slice       (a gather of a shard
                                                     whose consumers run
                                                     alike on every rank)
    slice_reduce  own slice         all-gather      (row-first's entry)

The differentiable pairs call the raw methods, so a communicator that
overrides only those (`chip_smoke.py`'s thread world) runs the same
layouts. `all_reduce`, `all_gather_into`, `reduce_scatter_into`,
`all_to_all_into` and `send_recv` hand the call to `group` itself when it
is not a process group but an object with the method of that name
(`all_reduce_into`, ..., `send_recv_into`), so that the data-axis seam
(`parallel/api.py`) runs over a thread world's groups as well, and so
that `analysis/trace.py`'s recording groups see every collective of a
step, `CPComm`'s, `EPComm`'s and `PPComm`'s included.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from picotron_tpu_torch.ops.mesh_attention import mesh_groups

# calls since the last reset, by kind
collectives = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
               "send_recv": 0, "all_to_all": 0}

# the newer names where this torch has them (the older ones warn there)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def reset_collective_counts() -> None:
    for key in collectives:
        collectives[key] = 0


def _delegate(group, method: str):
    """`group`'s own method `method` when `group` is a communicator object
    rather than a process group (None, the default group, included)."""
    if group is None or isinstance(group, dist.ProcessGroup):
        return None
    return getattr(group, method, None)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns `t`."""
    collectives["all_reduce"] += 1
    own = _delegate(group, "all_reduce_into")
    if own is not None:
        own(t, op)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` (dim 0 of size group size x inp's) <- every rank's `inp`, in
    group-rank order. `inp` may be this rank's own slice of `out` (the
    in-place form ZeRO-1 uses)."""
    collectives["all_gather"] += 1
    own = _delegate(group, "all_gather_into")
    if own is not None:
        own(out, inp)
        return
    _all_gather(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` <- this rank's dim-0 slice of the sum of every rank's `inp`."""
    collectives["reduce_scatter"] += 1
    own = _delegate(group, "reduce_scatter_into")
    if own is not None:
        own(out, inp)
        return
    _reduce_scatter(out, inp, group=group)


def all_to_all_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` <- chunk j of dim 0 of `inp` sent to group rank j, chunk j of
    `out` received from group rank j (`dist.all_to_all_single`). Not
    counted: the callers count their exchange once."""
    own = _delegate(group, "all_to_all_into")
    if own is not None:
        own(out, inp)
        return
    dist.all_to_all_single(out, inp, group=group)


def send_recv(sends, recvs, group) -> None:
    """One batch of point-to-point transfers over `group`: each (global
    rank, tensor) of `sends` sent, each (global rank, buffer) of `recvs`
    filled, every request waited on. Not counted: the callers count
    their batch once."""
    own = _delegate(group, "send_recv_into")
    if own is not None:
        own(sends, recvs)
        return
    ops = [dist.P2POp(dist.isend, t, r, group) for r, t in sends]
    ops += [dist.P2POp(dist.irecv, t, r, group) for r, t in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def gather_along(x: torch.Tensor, dim: int, n: int,
                 gather_into) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in rank order, through
    `gather_into(out, inp)` (a dim-0 all-gather)."""
    dim = dim % x.dim()
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    gather_into(out, x)
    out = out.reshape((n,) + x.shape).movedim(0, dim)
    return out.reshape(x.shape[:dim] + (n * x.shape[dim],)
                       + x.shape[dim + 1:])


def scatter_along(x: torch.Tensor, dim: int, n: int,
                  scatter_into) -> torch.Tensor:
    """This rank's slice along `dim` of the sum of every rank's x, through
    `scatter_into(out, inp)` (a dim-0 reduce-scatter)."""
    dim = dim % x.dim()
    size = x.shape[dim]
    out_shape = x.shape[:dim] + (size // n,) + x.shape[dim + 1:]
    parts = x.reshape(x.shape[:dim] + (n, size // n) + x.shape[dim + 1:])
    parts = parts.movedim(dim, 0).contiguous()
    parts = parts.reshape((n * out_shape[0],) + out_shape[1:])
    out = parts.new_empty(out_shape)
    scatter_into(out, parts)
    return out


def own_slice(x: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    """Slice `index` of n along `dim` (a contiguous copy)."""
    c = x.shape[dim] // n
    return x.narrow(dim, index * c, c).contiguous()


class GroupComm:
    """The collectives of one rank over one process group of `size` ranks,
    in which it is `index` (module docstring: the raw methods and the
    differentiable pairs)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    # -- raw (not differentiable) -------------------------------------------

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """t summed in place over the group; returns t."""
        return all_reduce(t, self.group, op)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather_along(x, dim, self.size, lambda out, inp:
                            all_gather_into(out, inp, self.group))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return scatter_along(x, dim, self.size, lambda out, inp:
                             reduce_scatter_into(out, inp, self.group))

    # -- differentiable -----------------------------------------------------

    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return _Reduce.apply(x, self)

    def gather(self, x, dim: int):
        return _Gather.apply(x, self, dim)

    def scatter(self, x, dim: int):
        return _Scatter.apply(x, self, dim)

    def gather_slice(self, x, dim: int):
        return _GatherSlice.apply(x, self, dim)

    def slice_reduce(self, x, dim: int):
        return _SliceReduce.apply(x, self, dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


class _GatherSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        return own_slice(g, ctx.dim, c.size, c.index), None, None


class _SliceReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return own_slice(x, dim, comm.size, comm.index)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


def split_chunks(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """[..., H, ...] (H at `dim`) -> [n, ..., H/n, ...] contiguous: chunk j
    of dim `dim` at index j, the send buffer of a tiled all-to-all."""
    shape = x.shape
    parts = x.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:])
    return parts.movedim(dim, 0).contiguous()


def concat_chunks(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """[n, ..., C, ...] -> [..., n*C, ...]: the n chunks concatenated
    along `dim` in index order, the receive side of a tiled all-to-all."""
    n, rest = parts.shape[0], parts.shape[1:]
    out = parts.movedim(0, dim)
    return out.reshape(rest[:dim] + (n * rest[dim],) + rest[dim + 1:])


class CPComm:
    """The cp exchanges of one rank over its process groups (`par`, a
    `mesh.ParallelEnv` with cp > 1): the ring over its cp group and, under
    the mesh cp flavor, its row group."""

    def __init__(self, par):
        self.size = par.cp_size
        self.index = par.cp_rank
        self.ranks = par.cp_ranks
        self.group = par.cp_group
        self.row_group = par.cp_row_group
        cp_x, cp_y = par.cp_mesh
        self.row = tuple(mesh_groups(cp_x, cp_y)[0][self.index // cp_y])

    def _group(self, members) -> object:
        members = tuple(members)
        if len(members) == self.size:
            return self.group
        if members == self.row and self.row_group is not None:
            return self.row_group
        raise ValueError(f"cp index {self.index}: no process group for cp "
                         f"indices {members} (the cp group, or the row "
                         f"{self.row})")

    def hop(self, tensors, dst: int, src: int) -> list:
        """Send each tensor to cp index `dst` and receive a tensor of the
        same shape and dtype from cp index `src`, in one batch."""
        collectives["send_recv"] += 1
        sends = [(self.ranks[dst], t.contiguous()) for t in tensors]
        out = [torch.empty_like(t) for _, t in sends]
        send_recv(sends, [(self.ranks[src], r) for r in out], self.group)
        return out

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int,
                   members) -> torch.Tensor:
        """Tiled all-to-all among the cp indices `members` (this rank's
        row, or every cp index): chunk j of `split_dim` goes to members[j],
        and the chunks received concatenate along `concat_dim` in member
        order."""
        group = self._group(members)
        collectives["all_to_all"] += 1
        send = split_chunks(x, split_dim, len(members))
        recv = torch.empty_like(send)
        all_to_all_into(recv, send, group)
        return concat_chunks(recv, concat_dim)

    def all_gather(self, x: torch.Tensor, members) -> torch.Tensor:
        """Every member's x concatenated along dim 0, in member order."""
        x = x.contiguous()
        out = x.new_empty((len(members) * x.shape[0],) + x.shape[1:])
        all_gather_into(out, x, self._group(members))
        return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    collectives["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    all_to_all_into(out, x, group)
    return out


class EPComm:
    """The ep exchange of one rank over its ep group (`par`, a
    `mesh.ParallelEnv` with ep > 1)."""

    def __init__(self, par):
        self.size = par.ep_size
        self.index = par.ep_rank
        self.group = par.ep_group

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x [size, ...]: chunk j goes to ep index j; chunk j of the
        result came from ep index j. Differentiable."""
        return _AllToAll.apply(x, self.group)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return all_reduce(x.detach().clone(), group) / n

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group) / ctx.n, \
            None, None


class GroupMean:
    """The mean of a tensor over a process group of `size` ranks,
    differentiable (each rank's grad is the mean of the ranks'
    cotangents, so that a layout's grads sum to the single device's)."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return _MeanOver.apply(t, self.group, self.size)


class PPComm:
    """The pipeline exchanges of one rank over its process groups (`par`,
    a `mesh.ParallelEnv` with pp > 1): the boundary tensors of a tick with
    the same (dp, ep, cp, tp) coordinates on the other stages, the sums
    over the stages, and under tied embeddings the sum of the embedding's
    grads over the first and the last stage."""

    def __init__(self, par):
        self.size = par.pp_size
        self.index = par.pp_rank
        self.ranks = par.pp_ranks
        self.group = par.pp_group
        self.ends_group = par.pp_ends_group
        self.device = par.device

    def exchange(self, sends, recvs) -> list:
        """Send each (stage, tensor) of `sends` and receive one tensor per
        (stage, shape, dtype) of `recvs`, all in one batch; the received
        tensors in `recvs` order. Between two stages the sends and the
        receives pair up in list order, so both sides must list them in
        the same order. Nothing to move: no call."""
        if not sends and not recvs:
            return []
        collectives["send_recv"] += 1
        out = [torch.empty(shape, dtype=dtype, device=self.device)
               for _, shape, dtype in recvs]
        send_recv([(self.ranks[s], t.contiguous()) for s, t in sends],
                  [(self.ranks[s], r) for (s, _, _), r in zip(recvs, out)],
                  self.group)
        return out

    def all_reduce(self, t: torch.Tensor, ends: bool = False) -> torch.Tensor:
        """`t` summed in place over the stages (`ends`: over the first
        and the last stage only); returns `t`."""
        return all_reduce(t, self.ends_group if ends else self.group)
