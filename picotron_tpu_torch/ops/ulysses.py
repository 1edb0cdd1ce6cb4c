"""Ulysses (DeepSpeed-style) all-to-all sequence parallelism (port of
picotron_tpu/ops/ulysses.py).

The second cp schedule, beside the K/V ring (ops/ring_attention.py): one
all-to-all pair per attention call trades the sequence shard for a head
shard,

    q/k/v [B, S/cp, H, D]  --all_to_all-->  [B, S, H/cp, D]

so each rank runs ordinary full-sequence attention (the flash kernels,
RoPE fused) over its head subset, and the output rides the reverse
all-to-all home. Local head counts (q and kv, after tp) must divide by
cp; config.validate enforces it.

The layout is static: `ulysses_static_layout` gives the gathered
sequence's positions (the loader's permutation, arange when contiguous)
and `seq_sort`, the argsort that restores a monotone sequence under
zigzag, so the inner call's positions are None and the kernels take
their static-causal path, as in the JAX package. Where only a rank's own
positions are known, they are all-gathered.

`ulysses_attention_bwd_from_saved`: the forward (`return_lse=True`) saves
the INNER-domain lse [B, H/cp, S] (head-sharded, sorted), and the
backward replays the same all-to-all pair in both directions around the
flash backward from the saved statistics; the forward kernel never
re-runs.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def ulysses_static_layout(full_positions: np.ndarray):
    """(full_positions, seq_sort) for the gathered sequence: the positions
    as given (the loader's layout permutation) and the static argsort
    restoring a monotone sequence, None when it already is (the JAX
    `ulysses_static_layout`, from the layout's positions in cp order)."""
    full = np.asarray(full_positions)
    monotone = np.array_equal(full, np.arange(full.shape[0]))
    return full, (None if monotone else np.argsort(full))


_INDEX: dict = {}


def _on_device(arr, device) -> torch.Tensor:
    """A static host index array as an int64 tensor on `device`, made once
    (a copy from pageable host memory waits for the stream)."""
    arr = np.asarray(arr)
    key = (arr.tobytes(), arr.shape, str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.as_tensor(arr, dtype=torch.int64, device=device)
    return _INDEX[key]


def _members(comm):
    return range(comm.size)


def _scatter_heads(x: torch.Tensor, comm) -> torch.Tensor:
    """[B, S_local, H, D] -> [B, S, H/cp, D]: heads split over the cp
    ranks, the sequence shards concatenated in cp order."""
    return comm.all_to_all(x, 2, 1, _members(comm))


def _gather_heads(x: torch.Tensor, comm) -> torch.Tensor:
    """Inverse of _scatter_heads: [B, S, H/cp, D] -> [B, S_local, H, D]."""
    return comm.all_to_all(x, 1, 2, _members(comm))


def _inner_positions(s_local: int, comm, q_positions, seq_sort,
                     full_positions, positions_static: bool, device):
    """(pos_arg, inv) of the inner full-sequence attention: the gathered
    (and seq_sort-ed) positions, or None where they are statically
    0..S-1, so the kernels' static-causal path runs; `inv` the static
    un-sort (None without a sort)."""
    if full_positions is not None:
        pos_full = _on_device(full_positions, device)
    else:
        if q_positions is None:
            q_positions = comm.index * s_local + torch.arange(
                s_local, device=device)
        pos_full = comm.all_gather(q_positions.reshape(-1).long(),
                                   _members(comm))
    inv = None
    if seq_sort is not None:
        inv = _on_device(np.argsort(np.asarray(seq_sort)), device)
        pos_full = pos_full[_on_device(seq_sort, device)]
    pos_arg = pos_full
    if full_positions is not None and positions_static:
        fp = np.asarray(full_positions)
        if seq_sort is not None:
            fp = fp[np.asarray(seq_sort)]
        if np.array_equal(fp, np.arange(fp.shape[0])):
            pos_arg = None
    return pos_arg, inv


def _sorted(xs, seq_sort, device):
    if seq_sort is None:
        return xs
    idx = _on_device(seq_sort, device)
    return tuple(x[:, idx] for x in xs)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm, *,
    attn_fn: Callable, q_positions: Optional[torch.Tensor] = None,
    rope=None, seq_sort=None, full_positions=None,
    positions_static: bool = False, return_lse: bool = False,
):
    """Full-sequence attention over seq-sharded q/k/v [B, S_local, H, D]
    (q/k unrotated: `rope` is fused into `attn_fn`, which has
    `flash_attention`'s signature).

    seq_sort: optional static [S] permutation sorting the gathered
    sequence by position (two static gathers restore a monotone sequence
    under zigzag). full_positions: optional static [S] positions of the
    gathered sequence (skips the positions' all-gather);
    positions_static declares it a host constant, so a monotone result
    passes None. return_lse: also return the inner lse [B, H/cp, S] fp32
    in the inner (head-sharded, sorted) domain."""
    pos_arg, inv = _inner_positions(q.shape[1], comm, q_positions, seq_sort,
                                    full_positions, positions_static,
                                    q.device)
    qh, kh, vh = _sorted(tuple(_scatter_heads(x, comm) for x in (q, k, v)),
                         seq_sort, q.device)
    kwargs = {} if rope is None else {"rope": rope}
    out, lse = attn_fn(qh, kh, vh, causal=True, q_positions=pos_arg,
                       kv_positions=pos_arg, return_lse=True, **kwargs)
    if inv is not None:
        out = out[:, inv]
    out = _gather_heads(out, comm)
    return (out, lse) if return_lse else out


def ulysses_attention_bwd_from_saved(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, comm, *,
    q_positions: Optional[torch.Tensor] = None,
    attn_bwd: Optional[Callable] = None, rope=None, seq_sort=None,
    full_positions=None, positions_static: bool = False,
    sm_scale: Optional[float] = None,
):
    """(dq, dk, dv) for Ulysses attention from the forward's saved (out,
    lse): q/k/v/out/dout (outer domain) scatter to the inner domain,
    `attn_bwd` (`flash_attention_bwd_from_saved`'s signature, the
    default) runs there against the saved inner lse, and the grads ride
    the reverse all-to-all home. seq_sort/full_positions/positions_static
    must be the forward call's."""
    from picotron_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_from_saved,
    )

    if attn_bwd is None:
        attn_bwd = flash_attention_bwd_from_saved
    pos_arg, inv = _inner_positions(q.shape[1], comm, q_positions, seq_sort,
                                    full_positions, positions_static,
                                    q.device)
    qh, kh, vh, oh, doh = _sorted(
        tuple(_scatter_heads(x, comm) for x in (q, k, v, out, dout)),
        seq_sort, q.device)
    kwargs = {} if rope is None else {"rope": rope}
    dqh, dkh, dvh = attn_bwd(qh, kh, vh, oh, lse, doh, causal=True,
                             q_positions=pos_arg, kv_positions=pos_arg,
                             sm_scale=sm_scale, **kwargs)
    if inv is not None:
        dqh, dkh, dvh = (x[:, inv] for x in (dqh, dkh, dvh))
    return (_gather_heads(dqh, comm), _gather_heads(dkh, comm),
            _gather_heads(dvh, comm))
