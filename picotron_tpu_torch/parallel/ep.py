"""The MoE side of a rank's layout (the ep half of the JAX package's
`ParallelCtx`: `moe_ep_axis` and `moe_stat_axes`,
picotron_tpu/parallel/api.py:225-235).

`EPContext` holds the ep communicator (`comm`: `parallel.comm.EPComm`
on the rank's ep group, or the thread world's of `chip_smoke.py`; None
at ep 1), over which `ops/moe.moe_mlp` exchanges its slot buffers, and
the router statistics' communicator (`stats`: a mean over the data
group, `comm.GroupMean`, when `model.router_aux_global` is on and the
group has more than one rank; None keeps per-device statistics, as the
single device has). A model without a context runs its MoE layers as
the single device does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from picotron_tpu_torch.parallel.comm import EPComm, GroupMean


@dataclass(frozen=True)
class EPContext:
    comm: object = None
    stats: object = None

    @property
    def size(self) -> int:
        return 1 if self.comm is None else self.comm.size

    @property
    def index(self) -> int:
        return 0 if self.comm is None else self.comm.index


def ep_context(par, cfg) -> Optional[EPContext]:
    """The EPContext of a rank (`mesh.ParallelEnv`) of an MoE config, or
    None when there is nothing to exchange or average: a dense model, no
    layout, or ep 1 with per-device (or one-rank) statistics."""
    if par is None or not cfg.model.num_experts:
        return None
    comm = EPComm(par) if par.ep_size > 1 else None
    stats = (GroupMean(par.data_group, par.data_size)
             if cfg.model.router_aux_global and par.data_size > 1 else None)
    if comm is None and stats is None:
        return None
    return EPContext(comm, stats)
