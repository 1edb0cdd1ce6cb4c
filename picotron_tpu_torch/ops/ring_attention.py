"""Ring attention: causal attention over the cp ranks, each holding one
sequence shard (port of picotron_tpu/ops/ring_attention.py).

K/V blocks rotate around the cp ring while each rank attends its local
queries to the visiting block, merging the partial results with the
online-softmax LSE update (`_merge`). The exchanges go through a
communicator (`parallel/comm.CPComm`, or any object with its methods),
the counterpart of the JAX `axis`: one `hop` per ring step carries K and
V together.

Positions are explicit and come from a `CPLayout`: every cp index's
global token positions, on the host. A visiting block's positions are a
pure function of the layout and of the cp index the block came from
((my - t) mod n after t hops), so nothing but K/V travels (JAX sends the
position vector around with its block; the origin's row of the layout is
the same vector), and the whole-block causal skip is decided on the
host, with no device-to-host copy per hop: a block entirely in the
causal future (min kv position > max q position) skips its kernel. The
skip is exact: a fully masked block contributes (out = 0, lse = -inf) and
zero grads, which is what the skip feeds the merge (and what the JAX
`lax.cond`'s skip branch returns). Under the zigzag layout every block is
partly visible and nothing is skipped; under the contiguous one rank r
runs r + 1 of its n blocks. Where the caller has only its own positions
(a device tensor), `gathered_layout` makes the layout with one
all-gather and one copy to the host per call.

`ring_attention_bwd_from_saved` is the backward from the forward's saved
(out, lse): a second forward ring whose per-block grads, normalised by
the globally merged LSE, are each block's exact additive share; dq
accumulates locally, and each block's dk/dv accumulate in fp32 and
travel with it, a final hop bringing them home.

Gradients. `ScheduleFunction` is the autograd node of every cp schedule
(ring, Ulysses, mesh): its forward runs the schedule with
`return_lse=True` and saves (q, k, v, out, lse); its backward runs the
schedule's `*_bwd_from_saved`. So the exchanges need no autograd of their
own, and the AD and fused grad engines run the same two functions per
schedule. The JAX AD path instead transposes the forward ring through
`_merge` (`ppermute`'s transpose is the inverse ring); it computes the
same sums in another order, so the two agree to fp32 round-off, not bit
for bit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from picotron_tpu_torch.ops.attention import sdpa_attention


class CPLayout:
    """Every cp index's global token positions, [cp, S_local] int64 on the
    host, with an int32 device copy per device made once."""

    def __init__(self, positions):
        self.positions = np.asarray(positions, dtype=np.int64)
        if self.positions.ndim != 2:
            raise ValueError(f"a cp layout is [cp, S_local], got shape "
                             f"{self.positions.shape}")
        self._on, self._rows = {}, {}

    @classmethod
    def contiguous(cls, n: int, s_local: int) -> "CPLayout":
        """cp index r holds positions [r * S_local, (r + 1) * S_local)."""
        return cls(np.arange(n * s_local).reshape(n, s_local))

    def full(self) -> np.ndarray:
        """[S]: the positions of the sequence gathered in cp order."""
        return self.positions.reshape(-1)

    def rows(self, cp_y: int) -> "CPLayout":
        """The row-domain layout of the mesh schedule: row x holds the
        positions of cp indices x * cp_y .. x * cp_y + cp_y - 1, in order
        (made once per cp_y)."""
        if cp_y not in self._rows:
            n, s = self.positions.shape
            self._rows[cp_y] = CPLayout(
                self.positions.reshape(n // cp_y, cp_y * s))
        return self._rows[cp_y]

    def on(self, device) -> torch.Tensor:
        """[cp, S_local] int32 on `device` (one copy per device: a copy
        from pageable host memory waits for the stream)."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.positions, dtype=torch.int32,
                                            device=device)
        return self._on[key]

    def fully_masked(self, q_index: int, kv_index: int) -> bool:
        """Whether every key of block `kv_index` is in the causal future
        of every query of block `q_index`."""
        return bool(self.positions[kv_index].min()
                    > self.positions[q_index].max())


def gathered_layout(comm, q_positions: torch.Tensor) -> CPLayout:
    """The layout from each cp rank's own positions [S_local]: one
    all-gather over the cp group and one copy to the host."""
    full = comm.all_gather(q_positions.reshape(-1), range(comm.size))
    # one host read per layout that is not static (the trainer's
    # layouts are: parallel/cp.layout_from_config)
    host = full.cpu()  # shardcheck: ok (see above)
    return CPLayout(host.numpy().reshape(comm.size, -1))


def resolve_layout(comm, s_local: int, layout: Optional[CPLayout],
                   q_positions: Optional[torch.Tensor]) -> CPLayout:
    """`layout` when given (static), else the gathered one of
    `q_positions`, else the contiguous layout."""
    if layout is not None:
        if layout.positions.shape != (comm.size, s_local):
            raise ValueError(f"cp layout {layout.positions.shape} does not "
                             f"match cp {comm.size} x S_local {s_local}")
        return layout
    if q_positions is not None:
        return gathered_layout(comm, q_positions)
    return CPLayout.contiguous(comm.size, s_local)


def _merge(out_acc, lse_acc, out_blk, lse_blk):
    """Online-softmax merge of two partial attention results: out [B, S,
    H, D] fp32, lse [B, H, S] fp32 (-inf where no key was attended). The
    result stays the normalised attention over every block merged so
    far."""
    m = torch.maximum(lse_acc, lse_blk)
    # fully masked rows (m = -inf): exp(-inf - -inf) would be NaN
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w_acc = torch.exp(lse_acc - m_safe)
    w_blk = torch.exp(lse_blk - m_safe)
    denom = w_acc + w_blk
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    wa = (w_acc / denom_safe).transpose(1, 2)[..., None]
    wb = (w_blk / denom_safe).transpose(1, 2)[..., None]
    out = out_acc * wa + out_blk * wb
    lse = m_safe + torch.log(denom_safe)
    lse = torch.where(denom == 0.0, torch.full_like(lse, float("-inf")), lse)
    return out, lse


def _skipped(b, s, h, d, device):
    """A fully masked block's exact contribution: (out = 0, lse = -inf)."""
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=device),
            torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                       device=device))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   comm, *, layout: Optional[CPLayout] = None,
                   q_positions: Optional[torch.Tensor] = None,
                   attn_block=None, return_lse: bool = False):
    """Causal ring attention over the communicator's cp ranks.

      q:    [B, S_local, Hq, D]  (already RoPE-rotated, as k)
      k, v: [B, S_local, Hkv, D] (Hkv <= Hq, GQA unexpanded)

    layout: every cp index's positions (static); else `q_positions`, this
        rank's [S_local] (gathered), else the contiguous layout.
    attn_block: blockwise attention with the signature of
        `sdpa_attention(..., return_lse=True)` (the default; the flash
        kernels slot in here).
    return_lse: also return the globally merged log-sum-exp [B, Hq,
        S_local] fp32, the save of `ring_attention_bwd_from_saved`.

    Returns [B, S_local, Hq, D] in q.dtype (and the merged lse)."""
    n, my = comm.size, comm.index
    b, s_local, h, d = q.shape
    layout = resolve_layout(comm, s_local, layout, q_positions)
    if attn_block is None:
        attn_block = partial(sdpa_attention, return_lse=True)
    pos = layout.on(q.device)
    out_acc, lse_acc = _skipped(b, s_local, h, d, q.device)
    for step in range(n):
        # after `step` hops this rank holds the block of cp index src
        src = (my - step) % n
        if layout.fully_masked(my, src):
            ob, lb = _skipped(b, s_local, h, d, q.device)
        else:
            ob, lb = attn_block(q, k, v, causal=True, q_positions=pos[my],
                                kv_positions=pos[src])
        out_acc, lse_acc = _merge(out_acc, lse_acc, ob.float(), lb.float())
        if step != n - 1:
            # each hop carries the block the next step reads: a ring
            k, v = comm.hop(  # shardcheck: ok (see above)
                [k, v], (my + 1) % n, (my - 1) % n)
    out = out_acc.to(q.dtype)
    return (out, lse_acc) if return_lse else out


def ring_attention_bwd_from_saved(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, comm, *,
    layout: Optional[CPLayout] = None,
    q_positions: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None, block_bwd=None,
):
    """(dq, dk, dv) for the causal K/V ring from the forward's saved (out,
    lse [B, Hq, S_local], the `return_lse` form): a second forward ring.
    Each visiting block's grads by `block_bwd` (the signature of
    `flash_attention_bwd_from_saved`, the default) against the global
    (out, lse, dout) are its additive share; dq accumulates here in fp32,
    each block's dk/dv accumulate in fp32 and travel with it, and one last
    hop delivers them home (n hops in all: the identity). Fully masked
    blocks skip their kernel (their share is exactly zero). q/k arrive in
    the form the forward consumed (pre-rotated)."""
    from picotron_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_from_saved,
    )

    n, my = comm.size, comm.index
    layout = resolve_layout(comm, q.shape[1], layout, q_positions)
    if block_bwd is None:
        block_bwd = flash_attention_bwd_from_saved
    pos = layout.on(q.device)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    nxt, prv = (my + 1) % n, (my - 1) % n
    for step in range(n):
        src = (my - step) % n
        if not layout.fully_masked(my, src):
            dq_b, dk_b, dv_b = block_bwd(
                q, k, v, out, lse, dout, causal=True, q_positions=pos[my],
                kv_positions=pos[src], sm_scale=sm_scale)
            dq_acc += dq_b.float()
            dk_acc += dk_b.float()
            dv_acc += dv_b.float()
        if step != n - 1:
            k, v, dk_acc, dv_acc = comm.hop(  # shardcheck: ok (ring)
                [k, v, dk_acc, dv_acc], nxt, prv)
    # after n-1 hops this rank holds block my+1's grads: one more hop
    # brings every block's dk/dv home
    dk_acc, dv_acc = comm.hop([dk_acc, dv_acc], nxt, prv)
    return dq_acc.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class ScheduleFunction(torch.autograd.Function):
    """The autograd node of a cp schedule: `fwd(q, k, v) -> (out, lse)`
    forward, saving (q, k, v, out, lse); `bwd(q, k, v, out, lse, dout) ->
    (dq, dk, dv)` backward (the schedule's `*_bwd_from_saved`). The lse
    gets no cotangent: the model reads only out."""

    @staticmethod
    def forward(ctx, q, k, v, fwd, bwd):
        out, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.bwd = bwd
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = ctx.bwd(*ctx.saved_tensors, dout)
        return dq, dk, dv, None, None
