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


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns `t`."""
    collectives["all_reduce"] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` (dim 0 of size group size x inp's) <- every rank's `inp`, in
    group-rank order. `inp` may be this rank's own slice of `out` (the
    in-place form ZeRO-1 uses)."""
    collectives["all_gather"] += 1
    _all_gather(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """`out` <- this rank's dim-0 slice of the sum of every rank's `inp`."""
    collectives["reduce_scatter"] += 1
    _reduce_scatter(out, inp, group=group)


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
        ops, out = [], []
        for t in tensors:
            t = t.contiguous()
            r = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self.ranks[dst], self.group))
            ops.append(dist.P2POp(dist.irecv, r, self.ranks[src], self.group))
            out.append(r)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
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
        dist.all_to_all_single(recv, send, group=group)
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
    dist.all_to_all_single(out, x, group=group)
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
        ops, out = [], []
        for stage, t in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self.ranks[stage], self.group))
        for stage, shape, dtype in recvs:
            r = torch.empty(shape, dtype=dtype, device=self.device)
            ops.append(dist.P2POp(dist.irecv, r, self.ranks[stage],
                                  self.group))
            out.append(r)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_reduce(self, t: torch.Tensor, ends: bool = False) -> torch.Tensor:
        """`t` summed in place over the stages (`ends`: over the first
        and the last stage only); returns `t`."""
        return all_reduce(t, self.ends_group if ends else self.group)
