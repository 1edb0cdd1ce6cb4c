"""The hierarchical dp gradient reduction across a slice cut (port of
picotron_tpu/parallel/hier_reduce.py).

A multi-slice layout (`distributed.slices` > 1) joins groups of devices
over a network far slower than the links inside a group. The JAX package
names TPU slices joined over DCN; on H100s under torchrun the slice is a
node: its GPUs are joined by NVLink, the nodes by the network between
them. The rank grid has dp outermost (`mesh.AXES`) and the slices split
dp first (`mesh._split_axes_over_dcn`), so the slice granule of dp is
its OUTER factor, g_dp, and a slice of dp a contiguous block of ranks:
dp index = outer * inner + i with inner = dp_size // g_dp.

When dp carries a granule and is declared to cross the cut
(`use_hier_dp`), the data axes' sum of the grads (`parallel/api.
GradSync`, the seam both grad engines and the pipeline's walks exit
through) becomes, over one flat fp32 buffer per set of axes:

    pad to a multiple of m (the per-slice width of the data axes)
    reduce-scatter over ep, then cp, then the intra-slice dp cohort
                                              — inside the slice
    all-reduce over the cross-slice dp cohort — one shard per slice
    all-gather back in the reverse order      — inside the slice
    strip the padding

so the cut carries 1/m of the gradient bytes instead of all of them. The
sums are the flat all-reduce's in another association order: equal on
integer-valued grads, within fp32 reassociation on others. With m <= 1
it is the flat all-reduce. Each leg is counted in `comm.collectives`
under its kind.

The cohorts (`_dp_groups`, over dp indices): the intra-slice ones are
the contiguous runs [o * inner, (o + 1) * inner), the cross-slice ones
pair equal offsets across the granules (one member per slice);
`mesh.init_parallel` makes them process groups beside the data group.
"""

from __future__ import annotations

import math

import torch

from picotron_tpu_torch.config import Config, parse_dcn_axes
from picotron_tpu_torch.parallel import comm


def dp_granule(cfg: Config) -> tuple:
    """(g_dp, inner): the slice granule dp carries and the per-slice dp
    width (dp_size == g_dp * inner)."""
    from picotron_tpu_torch.mesh import _split_axes_over_dcn

    d = cfg.distributed
    if d.slices <= 1:
        return 1, d.dp_size
    grid = (d.dp_size, d.pp_size, d.ep_size, d.cp_size, d.tp_size)
    dcn_shape, per_slice = _split_axes_over_dcn(grid, d.slices)
    return dcn_shape[0], per_slice[0]


def use_hier_dp(cfg: Config) -> bool:
    """`distributed.hier_dp_reduce` resolved: hierarchical iff the knob
    allows it and dp both is declared to cross the cut (`dcn_axes`) and
    carries a slice granule ("auto" and "on" agree here; "on" refuses at
    validation when the layout cannot qualify)."""
    d = cfg.distributed
    if d.hier_dp_reduce == "off" or d.slices <= 1:
        return False
    if "dp" not in parse_dcn_axes(d.dcn_axes):
        return False
    g_dp, _ = dp_granule(cfg)
    return g_dp > 1


def _dp_groups(g_dp: int, inner: int) -> tuple:
    """(intra-slice, cross-slice) cohorts of dp indices."""
    intra = [[o * inner + i for i in range(inner)] for o in range(g_dp)]
    cross = [[o * inner + i for o in range(g_dp)] for i in range(inner)]
    return intra, cross


def _scatter(v: torch.Tensor, n: int, group) -> torch.Tensor:
    out = v.new_empty(v.numel() // n)
    comm.reduce_scatter_into(out, v, group)
    return out


def _gather(v: torch.Tensor, n: int, group) -> torch.Tensor:
    out = v.new_empty(n * v.numel())
    comm.all_gather_into(out, v, group)
    return out


def hier_axes_psum(x: torch.Tensor, axes: tuple, par) -> torch.Tensor:
    """The sum of x over the data axes `axes` ("dp" among them) of `par`
    (a `mesh.ParallelEnv` on a hierarchical layout), as the module
    docstring's schedule: a new tensor of x's shape (x itself, summed in
    place, when there is no intra-slice width)."""
    g_dp, inner = par.dp_granule
    sizes = par.sizes
    intra_axes = [a for a in axes if a != "dp" and sizes[a] > 1]
    m = inner * math.prod(sizes[a] for a in intra_axes)
    if m <= 1:
        # no intra-slice width to scatter over: the flat sum is the
        # shard-per-slice leg
        return comm.all_reduce(x, par.dp_cross_group)
    groups = {"ep": par.ep_group, "cp": par.cp_group}
    size = x.numel()
    v = x.reshape(-1)
    pad = (-size) % m
    if pad:
        # zero padding is exact under summation; sliced off below
        v = torch.cat([v, v.new_zeros(pad)])
    for a in intra_axes:
        v = _scatter(v, sizes[a], groups[a])
    if inner > 1:
        v = _scatter(v, inner, par.dp_intra_group)
    comm.all_reduce(v, par.dp_cross_group)
    if inner > 1:
        v = _gather(v, inner, par.dp_intra_group)
    for a in reversed(intra_axes):
        v = _gather(v, sizes[a], groups[a])
    return v[:size].reshape(x.shape)


def hier_sum_(tensors: list, axes: tuple, par) -> None:
    """The tensors summed in place over the data axes `axes` by
    `hier_axes_psum`, as one flat fp32 buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = hier_axes_psum(flat, axes, par)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n
