"""The rank grid of the port (port of picotron_tpu/mesh.py).

The JAX package names a device mesh over the axes ("dp", "pp", "ep",
"cp", "tp"), tp fastest-varying, and reduces over named axes. Here each
process is one rank of that grid, with `torch.distributed` groups for the
collectives it needs:

- the tp group: the ranks that differ only in their tp coordinate (the
  Megatron f/g collectives, the vocab-parallel embedding and CE);
- the data group: the ranks that differ only in (dp, ep, cp), the axes
  the JAX package's `_data_axes_psum` reduces the grads over (and ZeRO-1
  shards the optimizer state over);
- the cp group: the ranks that differ only in cp (the context-parallel
  exchanges: the ring's hops, Ulysses' all-to-alls), with `cp_ranks`,
  its global ranks in cp order, from which the ring neighbours
  (`cp_next`, `cp_prev`) are named; under the mesh cp flavor
  (cp = cp_x x cp_y) also the row groups, cp_y contiguous cp indices each,
  row-major, index i = x * cp_y + y, as the JAX package's
  `ops/mesh_attention.mesh_groups` (the column rings need no group of
  their own: their hops are point to point);
- the pp group: the ranks that differ only in pp (the pipeline's
  boundary exchanges, `parallel.comm.PPComm`, and the sums of the loss,
  the token count and the grad norm over the stages), with `pp_ranks`,
  its global ranks in stage order, from which the stage neighbours
  (`pp_next`, `pp_prev`; None past either end) are named; for a model
  with tied embeddings also the ends group, the first and the last
  stage, which both hold the embedding and sum its grads. pp is not a
  data axis: each stage's data group and tp group are its own, and ZeRO-1
  shards a stage's state over its data group;
- the ep group: the ranks that differ only in ep (the MoE dispatch's
  all-to-all pair, `parallel.comm.EPComm`), and the bank group: the
  ranks that differ only in (dp, cp), over which the expert banks,
  sharded over ep, reduce their grads and ZeRO-1 shards their moments
  (the JAX `_data_axes_psum` leaves ep out for a tensor sharded over
  it); at ep 1 neither exists and the bank group is the data group;
- under the 2d tp strategy (tp = tp_x x tp_y,
  `parallel/tp_strategies.tp_subgroups`), the ty groups (the tp_y
  contiguous tp indices of one ix) and the tx groups (the tp_x strided
  tp indices of one iy), over the global ranks of each tp group;
- on a multi-slice layout whose dp carries a slice granule
  (`parallel/hier_reduce.use_hier_dp`), the hierarchical reduction's dp
  cohorts: the intra-slice ones (the `inner` contiguous dp indices of one
  slice) and the cross-slice ones (one dp index per slice at the same
  offset). The slices split the outermost axes first
  (`_split_axes_over_dcn`: dp, then pp), and dp is outermost in the rank
  grid, so a slice of dp is a contiguous block of ranks: under torchrun
  that block is a node (NVLink inside it, the network between nodes);
- a gloo group over every rank for the checkpoint's host-side agreement
  (barriers and the step every rank restores), used by nothing else, so
  that a save's commit thread never interleaves with the step's
  collectives.

Launch contract: torchrun's environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`), or a process group the
caller has already initialized. The backend is NCCL for a CUDA device
(each rank on `cuda:LOCAL_RANK`) and gloo for the CPU; a missing or
failing NCCL raises and never becomes gloo. Without either, the run is
one process with no group (`init_parallel` returns None), and its layout
must then be one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from picotron_tpu_torch.config import (
    resolved_cp_flavor, resolved_cp_mesh, resolved_tp_mesh,
    resolved_tp_strategy,
)
from picotron_tpu_torch.ops.mesh_attention import mesh_groups

# outermost to innermost, as the JAX package's AXES
AXES = ("dp", "pp", "ep", "cp", "tp")
# the axes the grads are summed over (and ZeRO-1 shards over)
DATA_AXES = ("dp", "ep", "cp")
# the data axes of the expert banks, which are sharded over ep
BANK_AXES = ("dp", "cp")
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


def layout_sizes(cfg) -> dict:
    """{axis: size} of the config's layout, in AXES order."""
    d = cfg.distributed
    return {"dp": d.dp_size, "pp": d.pp_size, "ep": d.ep_size,
            "cp": d.cp_size, "tp": d.tp_size}


def rank_coords(rank: int, sizes: dict) -> dict:
    """{axis: coordinate} of a rank: the row-major index over AXES, tp
    fastest (the JAX grid `reshape(devices, (dp, pp, ep, cp, tp))`)."""
    shape = tuple(sizes[a] for a in AXES)
    return dict(zip(AXES, (int(c) for c in np.unravel_index(rank, shape))))


def group_ranks(sizes: dict, axes) -> list:
    """The rank lists of the groups that vary over `axes` (the other
    coordinates fixed), each sorted, so a rank's place in its list is its
    coordinate over `axes` (row-major)."""
    shape = tuple(sizes[a] for a in AXES)
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    keep = [i for i, a in enumerate(AXES) if a not in axes]
    moved = np.moveaxis(grid, keep, list(range(len(keep))))
    n = int(np.prod([sizes[a] for a in axes]))
    return [sorted(int(r) for r in row) for row in moved.reshape(-1, n)]


@dataclass
class ParallelEnv:
    """This rank's place in the layout and its process groups."""

    sizes: dict
    rank: int
    world_size: int
    device: torch.device
    backend: str
    tp_group: object = field(repr=False)
    data_group: object = field(repr=False)
    host_group: object = field(repr=False)
    coords: dict = field(default_factory=dict)
    cp_group: object = field(default=None, repr=False)
    # the global ranks of this rank's cp group, in cp order
    cp_ranks: tuple = ()
    # (cp_x, cp_y) of the mesh cp flavor, and this rank's row group
    # (None when cp_y is 1 or the whole cp group)
    cp_mesh: tuple = (1, 1)
    cp_row_group: object = field(default=None, repr=False)
    pp_group: object = field(default=None, repr=False)
    # the global ranks of this rank's pp group, in stage order
    pp_ranks: tuple = ()
    # the first and last stage of this rank's pp group (tied embeddings
    # under pp > 1; None otherwise, and on the middle stages)
    pp_ends_group: object = field(default=None, repr=False)
    # the ep group, and the bank group (the data group at ep 1)
    ep_group: object = field(default=None, repr=False)
    bank_group: object = field(default=None, repr=False)
    # (tp_x, tp_y) of the 2d tp strategy ((tp, 1) otherwise), and this
    # rank's ty and tx subgroups (None for a group of one)
    tp_mesh: tuple = (1, 1)
    tp_ty_group: object = field(default=None, repr=False)
    tp_tx_group: object = field(default=None, repr=False)
    # the hierarchical dp reduction: (g_dp, inner) of the slice layout,
    # and this rank's intra-slice and cross-slice dp cohorts (None
    # without it)
    dp_granule: tuple = (1, 1)
    dp_intra_group: object = field(default=None, repr=False)
    dp_cross_group: object = field(default=None, repr=False)

    @property
    def tp_size(self) -> int:
        return self.sizes["tp"]

    @property
    def tp_rank(self) -> int:
        return self.coords["tp"]

    @property
    def data_size(self) -> int:
        return self.sizes["dp"] * self.sizes["ep"] * self.sizes["cp"]

    @property
    def data_rank(self) -> int:
        c, s = self.coords, self.sizes
        return (c["dp"] * s["ep"] + c["ep"]) * s["cp"] + c["cp"]

    @property
    def ep_size(self) -> int:
        return self.sizes["ep"]

    @property
    def ep_rank(self) -> int:
        return self.coords["ep"]

    @property
    def bank_size(self) -> int:
        return self.sizes["dp"] * self.sizes["cp"]

    @property
    def bank_rank(self) -> int:
        """This rank's index in its bank group (dp-major, as in the data
        group)."""
        return self.coords["dp"] * self.sizes["cp"] + self.coords["cp"]

    @property
    def cp_size(self) -> int:
        return self.sizes["cp"]

    @property
    def cp_rank(self) -> int:
        return self.coords["cp"]

    @property
    def cp_next(self) -> int:
        """The global rank of the next cp index on the ring."""
        return self.cp_ranks[(self.cp_rank + 1) % self.cp_size]

    @property
    def cp_prev(self) -> int:
        """The global rank of the previous cp index on the ring."""
        return self.cp_ranks[(self.cp_rank - 1) % self.cp_size]

    @property
    def pp_size(self) -> int:
        return self.sizes["pp"]

    @property
    def pp_rank(self) -> int:
        return self.coords["pp"]

    @property
    def pp_next(self) -> Optional[int]:
        """The global rank of the next stage (None on the last)."""
        s = self.pp_rank + 1
        return self.pp_ranks[s] if s < self.pp_size else None

    @property
    def pp_prev(self) -> Optional[int]:
        """The global rank of the previous stage (None on the first)."""
        s = self.pp_rank - 1
        return self.pp_ranks[s] if s >= 0 else None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rank_at(self, **coords) -> int:
        """The rank at this rank's coordinates with `coords` replaced."""
        c = {**self.coords, **coords}
        shape = tuple(self.sizes[a] for a in AXES)
        return int(np.ravel_multi_index(tuple(c[a] for a in AXES), shape))


def launcher_contract(env=None) -> Optional[tuple]:
    """torchrun's (rank, world size, local rank), or None when no
    torchrun variable is set; a partial set raises ValueError."""
    env = os.environ if env is None else env
    present = [n for n in _TORCHRUN_VARS if env.get(n)]
    if not present:
        return None
    missing = [n for n in _TORCHRUN_VARS if not env.get(n)]
    if missing:
        raise ValueError(f"partial torchrun environment: {present} set but "
                         f"{missing} missing; launch with torchrun or set "
                         "none of them")
    return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])


def check_world(cfg, world_size: int) -> None:
    """Raise ValueError unless the world is the layout's dp*pp*ep*cp*tp
    (picotron_tpu/train.py's check)."""
    sizes = layout_sizes(cfg)
    want = int(np.prod(list(sizes.values())))
    if world_size != want:
        raise ValueError(
            f"world size {world_size} != dp*pp*ep*cp*tp = {want} "
            f"({sizes}); launch with torchrun --nproc_per_node {want} (or "
            f"change the layout)")


def _split_axes_over_dcn(shape: tuple, n_slices: int) -> tuple:
    """(dcn_shape, per_slice_shape) of the (dp, pp, ep, cp, tp) shape over
    `n_slices` slices: the slices are absorbed by the outermost axes
    first (dp, then pp); ep, cp and tp never cross a slice (port of the
    JAX function of this name, its error included)."""
    import math

    n_dcn_tolerant_axes = 2  # dp, pp only — never ep/cp/tp over DCN
    dcn = [1] * len(shape)
    per_slice = list(shape)
    rem = n_slices
    for i in range(n_dcn_tolerant_axes):
        g = math.gcd(per_slice[i], rem)
        dcn[i] = g
        per_slice[i] //= g
        rem //= g
        if rem == 1:
            break
    if rem != 1:
        raise ValueError(
            f"cannot distribute {n_slices} DCN slices over mesh axes "
            f"{dict(zip(AXES, shape))}: the slice count must divide the "
            f"product of the DCN-tolerant axis sizes (dp * pp = "
            f"{shape[0] * shape[1]}) — ep/cp/tp collectives must stay on "
            f"ICI. Rebalance the layout so dp*pp absorbs the slice count.")
    return tuple(dcn), tuple(per_slice)


def _tp_mesh(cfg) -> tuple:
    """(tp_x, tp_y) of the config's 2d tp strategy; (tp, 1) otherwise."""
    tp = cfg.distributed.tp_size
    if tp > 1 and "2d" in resolved_tp_strategy(cfg).values():
        return tuple(resolved_tp_mesh(cfg))
    return (tp, 1)


def tp_subgroup_ranks(sizes: dict, tp_x: int, tp_y: int) -> tuple:
    """(ty lists, tx lists) of global ranks: each tp group's
    `tp_strategies.tp_subgroups`."""
    from picotron_tpu_torch.parallel.tp_strategies import tp_subgroups

    ty, tx = tp_subgroups(tp_x, tp_y)
    lists = group_ranks(sizes, ("tp",))
    return ([[g[i] for i in sub] for g in lists for sub in ty],
            [[g[i] for i in sub] for g in lists for sub in tx])


def dp_cohort_ranks(sizes: dict, g_dp: int, inner: int) -> tuple:
    """(intra-slice lists, cross-slice lists) of global ranks: each dp
    group's `hier_reduce._dp_groups`."""
    from picotron_tpu_torch.parallel.hier_reduce import _dp_groups

    intra, cross = _dp_groups(g_dp, inner)
    lists = group_ranks(sizes, ("dp",))
    return ([[g[i] for i in sub] for g in lists for sub in intra],
            [[g[i] for i in sub] for g in lists for sub in cross])


def cp_row_ranks(cp_ranks, cp_x: int, cp_y: int) -> list:
    """The row groups of one cp group under the mesh cp flavor (the cp
    indices of `mesh_attention.mesh_groups`'s rows), as global ranks."""
    return [[cp_ranks[i] for i in row] for row in mesh_groups(cp_x, cp_y)[0]]


def _cp_mesh(cfg) -> tuple:
    """(cp_x, cp_y) of the config's mesh cp flavor; (cp, 1) otherwise (the
    ring's own factorization: no rows)."""
    cp = cfg.distributed.cp_size
    if resolved_cp_flavor(cfg) == "mesh":
        return tuple(resolved_cp_mesh(cfg))
    return (cp, 1)


# the roles of a layout's groups, in the order every rank makes them
GROUP_ROLES = ("tp", "data", "cp", "cp_row", "pp", "pp_ends", "ep", "bank",
               "tp_ty", "tp_tx", "dp_intra", "dp_cross")


def _granule(cfg) -> tuple:
    """(g_dp, inner) of the hierarchical dp reduction; (1, dp) without it."""
    from picotron_tpu_torch.parallel.hier_reduce import dp_granule, use_hier_dp

    return (dp_granule(cfg) if use_hier_dp(cfg)
            else (1, cfg.distributed.dp_size))


def layout_partitions(cfg) -> dict:
    """{role: partition} for each of GROUP_ROLES: the rank lists of the
    layout's groups of that role (module docstring), or None where the
    layout has none. A role whose groups are another's shares that list
    object (the bank groups are the data groups at ep 1, the ends groups
    the pp groups at pp 2, a tp subgroup of the whole tp width the tp
    groups), and so shares its process group. A rank may lie in no group
    of a role (the middle stages in the ends groups)."""
    sizes = layout_sizes(cfg)
    cp_x, cp_y = _cp_mesh(cfg)
    tp_x, tp_y = _tp_mesh(cfg)
    g_dp, inner = _granule(cfg)
    p = dict.fromkeys(GROUP_ROLES)
    p["tp"] = group_ranks(sizes, ("tp",))
    p["data"] = p["bank"] = group_ranks(sizes, DATA_AXES)
    cp_lists = group_ranks(sizes, ("cp",))
    if sizes["cp"] > 1:
        p["cp"] = cp_lists
    if 1 < cp_y < sizes["cp"]:
        p["cp_row"] = [r for g in cp_lists
                       for r in cp_row_ranks(g, cp_x, cp_y)]
    if sizes["pp"] > 1:
        p["pp"] = group_ranks(sizes, ("pp",))
        if cfg.model.tie_word_embeddings:
            p["pp_ends"] = (p["pp"] if sizes["pp"] == 2
                            else [[g[0], g[-1]] for g in p["pp"]])
    if sizes["ep"] > 1:
        p["ep"] = group_ranks(sizes, ("ep",))
        p["bank"] = group_ranks(sizes, BANK_AXES)
    if tp_y > 1 and tp_x > 1:
        p["tp_ty"], p["tp_tx"] = tp_subgroup_ranks(sizes, tp_x, tp_y)
    elif tp_y > 1:
        p["tp_ty"] = p["tp"]
    elif tp_x > 1:
        p["tp_tx"] = p["tp"]
    if g_dp > 1:
        intra, cross = dp_cohort_ranks(sizes, g_dp, inner)
        if inner > 1:
            p["dp_intra"] = intra
        p["dp_cross"] = cross
    return p


def parallel_env(cfg, rank: int, device: torch.device, backend: str,
                 groups: dict, host_group=None) -> ParallelEnv:
    """Rank `rank`'s ParallelEnv over `groups` ({role: this rank's group
    of that role, or None}: process groups, or any objects with their
    methods, such as `analysis/trace.py`'s recording groups)."""
    sizes = layout_sizes(cfg)
    ring = lambda axis: next(tuple(g) for g in  # noqa: E731
                             group_ranks(sizes, (axis,)) if rank in g)
    return ParallelEnv(
        sizes=sizes, rank=rank, world_size=int(np.prod(list(sizes.values()))),
        device=device, backend=backend, tp_group=groups["tp"],
        data_group=groups["data"], host_group=host_group,
        coords=rank_coords(rank, sizes), cp_group=groups["cp"],
        cp_ranks=ring("cp"), cp_mesh=_cp_mesh(cfg),
        cp_row_group=groups["cp_row"], pp_group=groups["pp"],
        pp_ranks=ring("pp"), pp_ends_group=groups["pp_ends"],
        ep_group=groups["ep"], bank_group=groups["bank"],
        tp_mesh=_tp_mesh(cfg), tp_ty_group=groups["tp_ty"],
        tp_tx_group=groups["tp_tx"], dp_granule=_granule(cfg),
        dp_intra_group=groups["dp_intra"], dp_cross_group=groups["dp_cross"])


_ENVS: dict = {}


def init_parallel(cfg, device: torch.device) -> Optional[ParallelEnv]:
    """This rank's ParallelEnv: from an initialized default process group,
    else from torchrun's environment (initializing the group: NCCL for a
    CUDA `device`, on cuda:LOCAL_RANK, gloo for the CPU); None when there
    is neither, which requires a one-device layout. The groups of one
    layout (`layout_partitions`) are made once per process (every rank
    makes them in the same order) and reused."""
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    else:
        contract = launcher_contract()
        if contract is None:
            check_world(cfg, 1)
            return None
        rank, world, local = contract
        check_world(cfg, world)
        if device.type == "cuda":
            if not dist.is_nccl_available():
                raise RuntimeError(
                    "a CUDA run needs the NCCL backend, which this torch "
                    "lacks; pass --device cpu for a gloo run on the CPU")
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", rank=rank, world_size=world)
        elif device.type == "cpu":
            dist.init_process_group("gloo", rank=rank, world_size=world)
        else:
            raise ValueError(f"no process-group backend for {device}")
    world, rank = dist.get_world_size(), dist.get_rank()
    check_world(cfg, world)
    backend = dist.get_backend()
    if device.type == "cuda":
        if backend != "nccl":
            raise RuntimeError(f"a CUDA run needs an NCCL process group, "
                               f"got {backend!r}")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    parts = layout_partitions(cfg)
    key = (repr(parts), _cp_mesh(cfg), _tp_mesh(cfg), _granule(cfg), world,
           backend, str(device))
    if key not in _ENVS:
        made, groups = {}, {}
        for role in GROUP_ROLES:
            part = parts[role]
            if part is None:
                groups[role] = None
                continue
            if id(part) not in made:
                made[id(part)], _ = dist.new_subgroups_by_enumeration(part)
            groups[role] = made[id(part)]
            if role == "pp":
                # NCCL: a batched send/recv that is a group's first call
                # must involve every rank of the group, which a pipeline
                # tick does not; one all-reduce sets the communicator up
                dist.all_reduce(  # shardcheck: ok (set-up, not a step)
                    torch.zeros(1, device=device), group=groups["pp"])
        # the checkpoint's own group: its commit thread's agreement must
        # not interleave with the step's collectives on another group
        host_group = dist.new_group(backend="gloo")
        _ENVS[key] = parallel_env(cfg, rank, device, backend, groups,
                                  host_group)
    return _ENVS[key]


def shutdown() -> None:
    """Destroy the default process group and forget the layouts' groups."""
    _ENVS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
