"""Mesh attention: 2D context parallelism, cp = cp_x x cp_y (port of
picotron_tpu/ops/mesh_attention.py).

The third cp schedule, after the K/V ring (ops/ring_attention.py) and
Ulysses (ops/ulysses.py). Per attention call:

1. a Ulysses head scatter within each row of cp_y contiguous cp indices
   (row-major, cp index i = x * cp_y + y; the row groups of
   `mesh.ParallelEnv`): q/k/v [B, S/cp, H, D] -> [B, S/cp_x, H/cp_y, D],
   each rank holding its row's sequence block on a head subset;
2. a K/V ring over the cp_x rows: row blocks hop to the corresponding
   rank of the next row (the column ring), merged by the ring's
   online-softmax update, with the same host-side whole-block skip
   (a visiting row block's positions are the layout's row of the row it
   came from);
3. the output's reverse all-to-all home.

The degenerate factorizations are exact: at cp_y = 1 the all-to-all pair
is skipped and the schedule is the ring's, at cp_x = 1 there are no ring
hops (Ulysses' schedule). `mesh_attention_bwd_from_saved` saves the
ROW-domain lse [B, Hq/cp_y, S_row] and runs the backward ring of the
ring schedule inside the same all-to-all pair. q/k arrive pre-rotated,
as for the ring.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from picotron_tpu_torch.ops.attention import sdpa_attention
from picotron_tpu_torch.ops.ring_attention import (
    CPLayout, _merge, _skipped, resolve_layout,
)


def mesh_groups(cp_x: int, cp_y: int):
    """(row_groups, ring_perm) of the row-major cp_x x cp_y factorization
    (the JAX `mesh_groups`): the cp indices of each row, and the (src,
    dst) pairs of the column ring."""
    row_groups = [[x * cp_y + y for y in range(cp_y)] for x in range(cp_x)]
    ring_perm = [(x * cp_y + y, ((x + 1) % cp_x) * cp_y + y)
                 for x in range(cp_x) for y in range(cp_y)]
    return row_groups, ring_perm


def _check(comm, cp_x: int, cp_y: int) -> None:
    if cp_x * cp_y != comm.size:
        raise ValueError(f"cp_mesh {cp_x}x{cp_y} does not factor the cp "
                         f"size {comm.size} (config.validate should have "
                         "caught this)")


def _row_inputs(tensors, comm, cp_y: int, row):
    """Scatter `tensors` into the row domain (none at cp_y = 1)."""
    if cp_y == 1:
        return tuple(tensors)
    return tuple(comm.all_to_all(t, 2, 1, row) for t in tensors)


def _coords(comm, cp_x: int, cp_y: int):
    """(x, row cp indices, next and previous rank on the column ring)."""
    rows, ring = mesh_groups(cp_x, cp_y)
    x = comm.index // cp_y
    nxt = dict(ring)[comm.index]
    prv = {dst: src for src, dst in ring}[comm.index]
    return x, tuple(rows[x]), nxt, prv


def mesh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   comm, *, cp_mesh: tuple,
                   layout: Optional[CPLayout] = None,
                   q_positions: Optional[torch.Tensor] = None,
                   attn_block=None, return_lse: bool = False):
    """Causal 2D-mesh attention over the communicator's cp ranks; shapes
    and `layout`/`q_positions`/`attn_block` as `ring_attention` (q/k
    pre-rotated). cp_mesh: the static (cp_x, cp_y), Hq and Hkv divisible
    by cp_y. return_lse: also return the merged lse [B, Hq/cp_y, S_row]
    fp32 in the row domain.

    Returns [B, S_local, Hq, D] in q.dtype (and the row-domain lse)."""
    cp_x, cp_y = cp_mesh
    _check(comm, cp_x, cp_y)
    layout = resolve_layout(comm, q.shape[1], layout, q_positions)
    if attn_block is None:
        attn_block = partial(sdpa_attention, return_lse=True)
    x, row, nxt, prv = _coords(comm, cp_x, cp_y)
    rows = layout.rows(cp_y)
    pos = rows.on(q.device)
    qh, kh, vh = _row_inputs((q, k, v), comm, cp_y, row)
    b, s_row, h, d = qh.shape
    out_acc, lse_acc = _skipped(b, s_row, h, d, q.device)
    for step in range(cp_x):
        src = (x - step) % cp_x
        if rows.fully_masked(x, src):
            ob, lb = _skipped(b, s_row, h, d, q.device)
        else:
            ob, lb = attn_block(qh, kh, vh, causal=True, q_positions=pos[x],
                                kv_positions=pos[src])
        out_acc, lse_acc = _merge(out_acc, lse_acc, ob.float(), lb.float())
        if step != cp_x - 1:
            kh, vh = comm.hop([kh, vh], nxt, prv)  # shardcheck: ok (ring)
    out = out_acc.to(q.dtype)
    if cp_y > 1:
        out = comm.all_to_all(out, 1, 2, row)
    return (out, lse_acc) if return_lse else out


def mesh_attention_bwd_from_saved(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, comm, *, cp_mesh: tuple,
    layout: Optional[CPLayout] = None,
    q_positions: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None, block_bwd=None,
):
    """(dq, dk, dv) for 2D-mesh attention from the forward's saved (out,
    lse): q/k/v/out/dout (outer domain) scatter to the row domain, a
    second forward ring over cp_x runs `block_bwd` per visiting row block
    against the saved row-domain lse (dq accumulating here, each row
    block's dk/dv travelling with it, a last hop bringing them home), and
    the reverse all-to-all returns the three grads."""
    from picotron_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_from_saved,
    )

    cp_x, cp_y = cp_mesh
    _check(comm, cp_x, cp_y)
    layout = resolve_layout(comm, q.shape[1], layout, q_positions)
    if block_bwd is None:
        block_bwd = flash_attention_bwd_from_saved
    x, row, nxt, prv = _coords(comm, cp_x, cp_y)
    rows = layout.rows(cp_y)
    pos = rows.on(q.device)
    qh, kh, vh, oh, doh = _row_inputs((q, k, v, out, dout), comm, cp_y, row)
    dq_acc = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
    dk_acc = torch.zeros(kh.shape, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros(vh.shape, dtype=torch.float32, device=q.device)
    for step in range(cp_x):
        src = (x - step) % cp_x
        if not rows.fully_masked(x, src):
            dq_b, dk_b, dv_b = block_bwd(
                qh, kh, vh, oh, lse, doh, causal=True, q_positions=pos[x],
                kv_positions=pos[src], sm_scale=sm_scale)
            dq_acc += dq_b.float()
            dk_acc += dk_b.float()
            dv_acc += dv_b.float()
        if step != cp_x - 1:
            kh, vh, dk_acc, dv_acc = comm.hop(  # shardcheck: ok (ring)
                [kh, vh, dk_acc, dv_acc], nxt, prv)
    if cp_x > 1:
        dk_acc, dv_acc = comm.hop([dk_acc, dv_acc], nxt, prv)
    grads = (dq_acc.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype))
    if cp_y > 1:
        grads = tuple(comm.all_to_all(g, 1, 2, row) for g in grads)
    return grads
