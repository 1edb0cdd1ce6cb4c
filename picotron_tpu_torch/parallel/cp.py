"""Context parallelism's per-rank context (the cp side of the JAX
package's `ParallelCtx`: picotron_tpu/parallel/api.py:61-84 for the
positions, :103-170 for the attention dispatch,
picotron_tpu/parallel/fused_bwd.py:125-240 for the fused engine's).

`CPContext` holds a rank's communicator (`comm.CPComm` on its cp process
groups, or the thread world's of `chip_smoke.py`), the schedule
(`flavor`: "ring", "ulysses" or "mesh", `config.resolved_cp_flavor`),
the mesh factorization and the layout: every cp index's global token
positions (`layout_from_config`: the loader's zigzag chunks (r, 2cp-1-r),
or r * S_local + arange when contiguous). At cp 1 there is no context
and the model keeps its static-causal path (positions None).

`CPContext.attention(attn_impl, rope)` gives the schedule as (pre, fwd,
bwd), the single source both grad engines run:

- ring and mesh: `pre` rotates q and k at this rank's positions
  (`apply_rope` on tables gathered once), so the blocks travel
  pre-rotated; `fwd`/`bwd` are the schedule and its backward from the
  saved (out, lse) over flash blocks (`flash_attention` /
  `flash_attention_bwd_from_saved`), or the plain ones
  (`sdpa_attention`) for attn_impl "reference";
- Ulysses: no `pre`; the flash kernels rotate at the gathered positions
  (None after `seq_sort`: the static-causal path), whatever attn_impl,
  as the JAX fused engine's Ulysses branch does.

The AD engine applies `pre` as ordinary autograd ops and the schedule
through `ScheduleFunction` (its backward is `bwd`); the fused engine
calls `fwd` and `bwd` itself and takes the rotation's transpose by
autograd over `pre`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.config import Config, resolved_cp_flavor
from picotron_tpu_torch.data import cp_sequence_permutation
from picotron_tpu_torch.ops.attention import (
    sdpa_attention, sdpa_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.mesh_attention import (
    mesh_attention, mesh_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.ring_attention import (
    CPLayout, ring_attention, ring_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.rope import apply_rope
from picotron_tpu_torch.ops.ulysses import (
    ulysses_attention, ulysses_attention_bwd_from_saved,
    ulysses_static_layout,
)
from picotron_tpu_torch.parallel.comm import CPComm

FLASH_IMPLS = ("auto", "flash", "ring", "ulysses", "mesh")


def layout_from_config(cfg: Config) -> CPLayout:
    """Every cp index's global positions under the config's cp_layout
    (the loader's permutation, `data.cp_sequence_permutation`, cut into
    the cp slices)."""
    d, s = cfg.distributed, cfg.training.seq_length
    perm = cp_sequence_permutation(cfg)
    full = np.arange(s) if perm is None else perm
    return CPLayout(full.reshape(d.cp_size, s // d.cp_size))


@dataclass
class CPContext:
    """One rank's context parallelism: its communicator, the schedule,
    the mesh factorization ((cp, 1) but for the mesh flavor) and the
    layout."""

    comm: object
    flavor: str
    layout: CPLayout
    cp_mesh: tuple = (1, 1)
    _tables: dict = field(default_factory=dict, repr=False)

    @property
    def index(self) -> int:
        return self.comm.index

    def positions(self, device) -> torch.Tensor:
        """This rank's global positions [S_local], int32 on `device`."""
        return self.layout.on(device)[self.index]

    def rope_at(self, x: torch.Tensor, rope) -> torch.Tensor:
        """x [B, S_local, H, D] rotated at this rank's positions (the
        tables gathered once per table and device, so no host sync)."""
        cos, sin = rope
        key = (cos.data_ptr(), str(cos.device))
        if key not in self._tables:
            idx = self.positions(cos.device).long()
            self._tables[key] = (cos[idx], sin[idx])
        return apply_rope(x, *self._tables[key])

    def attention(self, attn_impl: str, rope):
        """(pre, fwd, bwd) of the schedule (module docstring): pre(q, k)
        -> the schedule's q, k (None: unrotated in, rotated inside);
        fwd(q, k, v) -> (out, lse); bwd(q, k, v, out, lse, dout) -> (dq,
        dk, dv) in fwd's domains."""
        comm, layout = self.comm, self.layout
        if self.flavor == "ulysses":
            full, seq_sort = ulysses_static_layout(layout.full())
            kw = dict(rope=rope, seq_sort=seq_sort, full_positions=full,
                      positions_static=True)
            fwd = partial(ulysses_attention, comm=comm,
                          attn_fn=flash_attention, return_lse=True, **kw)
            bwd = partial(ulysses_attention_bwd_from_saved, comm=comm,
                          attn_bwd=flash_attention_bwd_from_saved, **kw)
            return None, fwd, bwd
        use_flash = attn_impl in FLASH_IMPLS
        block = partial(flash_attention if use_flash else sdpa_attention,
                        return_lse=True)
        block_bwd = (flash_attention_bwd_from_saved if use_flash
                     else sdpa_attention_bwd_from_saved)
        if self.flavor == "mesh":
            extra = {"cp_mesh": self.cp_mesh}
            schedule, schedule_bwd = (mesh_attention,
                                      mesh_attention_bwd_from_saved)
        elif self.flavor == "ring":
            extra = {}
            schedule, schedule_bwd = (ring_attention,
                                      ring_attention_bwd_from_saved)
        else:
            raise ValueError(f"unknown cp flavor {self.flavor!r}")
        fwd = partial(schedule, comm=comm, layout=layout, attn_block=block,
                      return_lse=True, **extra)
        bwd = partial(schedule_bwd, comm=comm, layout=layout,
                      block_bwd=block_bwd, **extra)

        def pre(q, k):
            return self.rope_at(q, rope), self.rope_at(k, rope)

        return pre, fwd, bwd


def cp_context(par, cfg: Config) -> Optional[CPContext]:
    """The CPContext of a rank (`mesh.ParallelEnv`), or None without
    context parallelism (no layout, or cp 1)."""
    if par is None or par.cp_size == 1:
        return None
    return CPContext(CPComm(par), resolved_cp_flavor(cfg),
                     layout_from_config(cfg), par.cp_mesh)
