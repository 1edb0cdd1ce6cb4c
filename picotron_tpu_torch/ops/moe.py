"""Mixture-of-experts layer: top-k router, capacity-bounded dispatch and
expert parallelism (port of picotron_tpu/ops/moe.py).

The design is the JAX package's:

- Static shapes (GShard-style capacity): every expert runs exactly `cap`
  token slots per device; an assignment past its expert's capacity is
  dropped from the expert path (its gate contributes 0) and an unused
  slot computes on zeros. No shape depends on the data, and nothing here
  reads a value on the host.
- Routing (Mixtral): an fp32 softmax over the router logits, the top k
  of it, the k gates renormalised to sum to 1. Slots are assigned in
  token-major order by one exclusive cumsum over the [N*k, E] one-hot of
  the chosen experts.
- Dispatch scatters each kept assignment into its [E, cap, H] slot by
  `index_add_` at the flat index e * cap + slot; a dropped one is
  clamped to slot cap - 1 at zero weight (the JAX `jnp.where(keep, slot,
  cap - 1)`), so duplicate indices only ever add exact zeros and the
  scatter is deterministic whatever order the device adds in. A boolean
  select would need `nonzero`, a host sync and a data-dependent shape.
- Expert parallelism: the banks hold E/ep experts per rank; an
  all-to-all over the ep group (`ep`, a communicator: `size`, `index`
  and a differentiable `all_to_all`, `parallel/comm.EPComm` or the
  thread world's of `chip_smoke.py`) regroups [ep, E/ep, cap, H] so each
  rank runs its experts over every peer's slots, and a second one brings
  the outputs home.
- Top-k ties: `lax.top_k` puts the lower index first among equal values;
  `torch.topk` promises no order, so the top k are the first k of a
  stable descending sort.

The expert products are three batched matmuls (`torch.bmm`), as the JAX
package's are three einsums outside any kernel.

Recompute contract (the JAX docstring's): every op is a deterministic
function of (x, weights), so re-running the block on the same inputs
gives bit-identical routing and slots; remat and the fused grad engine
recompute the block from its input instead of saving the dispatch
buffers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class Routing(NamedTuple):
    """Per-token routing decisions (leading dim N = flattened tokens)."""

    expert_idx: torch.Tensor  # [N, k] int64: chosen expert per assignment
    gate: torch.Tensor        # [N, k] fp32: combine weight
    slot: torch.Tensor        # [N, k] int64: slot in the expert's buffer;
    #                           >= capacity means dropped
    aux_loss: torch.Tensor    # [] fp32: load-balancing loss (unweighted)
    z_loss: torch.Tensor      # [] fp32: router z-loss (unweighted)


def top_k_stable(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest of each row, the lower index
    first among equal values (`lax.top_k`'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(logits: torch.Tensor, k: int, stats=None) -> Routing:
    """Top-k routing with slots assigned in token order. logits: [N, E]
    router outputs (taken in fp32). The caller drops assignments whose
    slot lands past its capacity.

    `stats` (an object with a differentiable `mean(t)` over a group of
    ranks, or None) makes the balance loss's f and P and the z-loss's
    token mean those of the group's whole batch (the JAX `stat_axes`
    pmean): equal shards make the mean of the means the global mean. The
    three statistics ride one call.

    Balance loss (Switch / Mixtral): E * sum_e f_e * P_e, f_e the share of
    assignments routed to e, P_e the mean router probability. z-loss
    (ST-MoE): mean(logsumexp(logits)^2). Both unweighted."""
    n, e = logits.shape
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)                           # [N, E]
    top_p, top_i = top_k_stable(probs, k)                           # [N, k]
    gate = top_p / top_p.sum(dim=-1, keepdim=True)

    # slot of (token t, choice j): how many earlier assignments (token-
    # major order) went to the same expert; an exclusive cumsum
    flat_e = top_i.reshape(-1)                                      # [N*k]
    onehot = F.one_hot(flat_e, e)                                   # [N*k, E]
    prior = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.gather(prior, 1, flat_e[:, None])[:, 0].reshape(n, k)

    f = F.one_hot(top_i, e).float().mean(dim=(0, 1))                # [E]
    p = probs.mean(dim=0)                                           # [E]
    z = torch.logsumexp(logits, dim=-1)
    zz = (z * z).mean()
    if stats is not None:
        f, p, zz = stats.mean(torch.cat([f, p, zz[None]])).split([e, e, 1])
        zz = zz[0]
    aux = e * (f * p).sum()
    return Routing(top_i, gate, slot, aux, zz)


def swiglu_experts(slots: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor,
                   act=F.silu) -> torch.Tensor:
    """The gated MLP over expert slots: slots [E_local, C, H], banks
    [E_local, H, F] / [E_local, F, H] cast to the slots' dtype (the JAX
    `_swiglu_experts`; `act` is `models.llama.mlp_act`'s)."""
    dt = slots.dtype
    g = torch.bmm(slots, w_gate.to(dt))
    u = torch.bmm(slots, w_up.to(dt))
    return torch.bmm(act(g) * u, w_down.to(dt))


def capacity(capacity_factor: float, top_k: int, n: int, e: int) -> int:
    """Slots per expert per device: int(cf * k * N / E) + 1, padded up to
    a multiple of 8 (the JAX package's rule, in its float order)."""
    cap = int(capacity_factor * top_k * n / e) + 1
    return -(-cap // 8) * 8


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, num_experts: int,
            top_k: int, capacity_factor: float = 1.25, act=F.silu,
            ep=None, router_aux_coef: float = 0.0,
            router_z_coef: float = 0.0, stats=None,
            logits: Optional[torch.Tensor] = None):
    """MoE feed-forward. x [B, S, H]; router_w [H, E]; banks [E_local, H,
    F] / [E_local, F, H] (E_local = E / ep.size under expert parallelism).

    Returns (out [B, S, H], partial over tp like the dense down
    projection; aux [], the pre-weighted router loss aux_coef * balance +
    z_coef * z; drop_frac [], the share of assignments the capacity
    dropped). `ep`: the ep communicator (None: no expert parallelism);
    `stats`: route_topk's; `logits`: the router logits [N, E] fp32 when
    the caller has them (a remat segment that saved them), else x's."""
    b, s, h = x.shape
    n = b * s
    e = num_experts
    n_ep = 1 if ep is None else ep.size
    e_local = w_gate.shape[0]
    if e_local * n_ep != e:
        raise ValueError(f"expert banks of {e_local} x ep {n_ep} != "
                         f"num_experts {e}")
    cap = capacity(capacity_factor, top_k, n, e)

    flat = x.reshape(n, h)
    if logits is None:
        logits = flat.float() @ router_w.float()                    # [N, E]
    r = route_topk(logits, top_k, stats)
    aux = router_aux_coef * r.aux_loss + router_z_coef * r.z_loss

    # dispatch: each kept assignment into its slot; dropped ones at slot
    # cap - 1 with weight 0
    keep = r.slot < cap                                             # [N, k]
    drop_frac = 1.0 - keep.float().mean()
    eidx = r.expert_idx.reshape(-1)
    sidx = torch.where(keep, r.slot, cap - 1).reshape(-1)
    kflat = keep.reshape(-1)
    where = eidx * cap + sidx                                       # [N*k]
    tok = torch.arange(n * top_k, device=x.device) // top_k
    src = flat[tok] * kflat[:, None].to(x.dtype)
    buf = x.new_zeros(e * cap, h).index_add(0, where, src)

    if n_ep > 1:
        # [E, cap, H] -> [ep, E_local, cap, H]; after the exchange chunk j
        # holds peer j's slots of this rank's experts
        buf = ep.all_to_all(buf.reshape(n_ep, e_local, cap, h))
        buf = buf.movedim(0, 1).reshape(e_local, n_ep * cap, h)
    else:
        buf = buf.reshape(e, cap, h)

    out_slots = swiglu_experts(buf, w_gate, w_up, w_down, act)

    if n_ep > 1:
        out_slots = out_slots.reshape(e_local, n_ep, cap, h).movedim(1, 0)
        out_slots = ep.all_to_all(out_slots.contiguous())

    # combine: each assignment's slot weighted by its gate, summed over
    # the k choices of its token
    picked = out_slots.reshape(e * cap, h)[where]                   # [N*k, H]
    w = (r.gate.reshape(-1) * kflat).to(x.dtype)[:, None]
    out = (picked * w).reshape(n, top_k, h).sum(dim=1)
    return out.reshape(b, s, h), aux, drop_frac
