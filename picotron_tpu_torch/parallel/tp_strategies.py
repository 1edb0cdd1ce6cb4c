"""Per-layer-class tp strategies and the deferred activation sync (port
of picotron_tpu/parallel/tp_strategies.py).

`distributed.tp_strategy` names a preset ("megatron", "row", "2d") or a
per-class spec ("qkv=2d,o=2d"); `config.resolved_tp_strategy` resolves
it to {qkv, o, up, down, head} -> {col, row, 2d}. The attention pair
(qkv, o) and the MLP pair (up, down) each run one of three schedules:

- **megatron** (col/row): Megatron's f/g pair (`parallel/tp.py`); no
  hook, the block code is the one without strategies, op for op.
- **2d**: tp factors into tp_x x tp_y, rank r = ix * tp_y + iy
  (`tp_subgroups`: the ty groups are contiguous, tp_y ranks of one ix;
  the tx groups strided, tp_x ranks of one iy). The column matmuls run
  as megatron's (1/tp of the features) and an all-gather within the ty
  group assembles the 1/tp_x feature block, so attention runs on
  heads/tp_x, alike on the tp_y ranks of a ty group. The row matmuls
  all-gather the weight's rows within the ty group, contract the whole
  1/tp_x feature block, and the exit sum runs over the tx group only
  (tp_x ranks instead of tp). The storage is megatron's.
- **row-first** ("row"): q/k/v (up/gate) contract this rank's 1/tp slab
  of the features against input-sharded weights and all-reduce the
  projections, so attention runs whole on every rank; o (down) is
  column-parallel and the block exits through a feature all-gather. The
  storage flips: q/k/v/gate/up shard their input features, o/down their
  output features (`parallel/sharding.tp_shard_dim`).

The deferred sync (`tp_sync="deferred"`, megatron only) is
`TPContext(deferred=True)`: the exit is a sequence reduce-scatter, its
gather moves to the next block's entry before the norm (`pre`) and to
the head (`head_in`), and the residual stream stays seq-sharded.

The JAX package gets the backward of each hook from shard_map's
transposes, in which a value that every rank computes alike carries one
partial cotangent per copy. The port's convention is Megatron's: every
rank holds the whole grad of a value it holds whole. So a collective's
backward here is the transpose under that convention, each one of the
differentiable pairs of `parallel/comm.GroupComm`:

    hook          forward                           backward
    2d qkv        copy (f), column matmul,          own slice, then f's
                  gather_slice over ty              all-reduce over tp
    2d o          gather_slice of the weight rows   own slice of the
                  over ty, matmul, reduce over tx   weight grad; identity
    2d mlp        copy, gate/up, act, gather_slice  as 2d qkv and o
                  of act*up and of down's rows over
                  ty, matmul, reduce over tx
    row qkv/up    slice_reduce (own feature slab),  all-gather of the slab
                  row matmul, reduce over tp        grads (= zero padding
                                                    + all-reduce); identity
    row o/down    copy, column matmul,              own slice; all-reduce
                  gather_slice over tp              of the input's grad

Which grads come out partial over tp follows: under 2d and row-first
none (every norm's input grad passes an all-reduce before the norm),
under the deferred sync the norms' (as under SP). The fused engine's
manual backward (`parallel/fused_bwd.py`) takes the same transposes
explicitly, with the raw collectives.
"""

from __future__ import annotations

from typing import Optional

import torch.nn.functional as F

from picotron_tpu_torch.config import (
    Config, resolved_tp_mesh, resolved_tp_strategy,
)
from picotron_tpu_torch.parallel.comm import GroupComm


def tp_subgroups(tp_x: int, tp_y: int):
    """(ty_groups, tx_groups) of tp indices for the iy-minor layout r =
    ix * tp_y + iy: tp_x ty groups of tp_y contiguous indices (fixed ix;
    the feature and weight all-gathers) and tp_y tx groups of tp_x
    strided indices (fixed iy; the shrunken exit sum)."""
    ty_groups = [[ix * tp_y + iy for iy in range(tp_y)]
                 for ix in range(tp_x)]
    tx_groups = [[ix * tp_y + iy for ix in range(tp_x)]
                 for iy in range(tp_y)]
    return ty_groups, tx_groups


def uses_strategy_hooks(cfg: Config) -> bool:
    """True when the config installs any non-megatron hook (a strategy or
    the deferred sync)."""
    d = cfg.distributed
    return d.tp_size > 1 and (d.tp_strategy != "megatron"
                              or d.tp_sync == "deferred")


def pair_kinds(cfg: Config) -> tuple:
    """(attention pair, MLP pair) -> "megatron", "2d" or "row"."""
    spec = resolved_tp_strategy(cfg)

    def kind(entry):
        return "megatron" if spec[entry] == "col" else spec[entry]

    return kind("qkv"), kind("up")


class TPStrategy:
    """The 2d / row-first hooks of one rank: `attn` and `mlp` are the two
    pairs' kinds ("megatron", "2d" or "row"), `comm` the tp
    communicator, `ty` and `tx` the 2d subgroups' (None without 2d, or
    for a group of one)."""

    def __init__(self, attn: str, mlp: str, comm, ty=None, tx=None):
        self.attn, self.mlp = attn, mlp
        self.comm, self.ty, self.tx = comm, ty, tx

    def hooked(self, pair: str) -> bool:
        return getattr(self, pair) != "megatron"

    # -- 2d helpers (a group of one is no collective) ------------------------

    def ty_gather_slice(self, x, dim: int):
        return x if self.ty is None else self.ty.gather_slice(x, dim)

    def tx_reduce(self, x):
        return x if self.tx is None else self.tx.reduce(x)

    # -- the hooks -----------------------------------------------------------

    def qkv_mm(self, h, wq, wk, wv, d: int):
        """[B, S, H] -> q, k, v [B, S, heads, D] (2d: the ty block's
        heads; row: every head)."""
        b, s, _ = h.shape
        if self.attn == "2d":
            hh = self.comm.copy(h)
            q, k, v = (self.ty_gather_slice(F.linear(hh, w), -1)
                       for w in (wq, wk, wv))
        else:
            hs = self.comm.slice_reduce(h, -1)
            q, k, v = (self.comm.reduce(F.linear(hs, w))
                       for w in (wq, wk, wv))
        return (q.reshape(b, s, -1, d), k.reshape(b, s, -1, d),
                v.reshape(b, s, -1, d))

    def o_mm(self, outf, wo):
        """The attention output [B, S, heads * D] -> the block's output
        [B, S, H], exit collective included."""
        if self.attn == "2d":
            return self.tx_reduce(F.linear(outf,
                                           self.ty_gather_slice(wo, 1)))
        return self.comm.gather_slice(F.linear(self.comm.copy(outf), wo), -1)

    def gate_up(self, h, wg, wu):
        """The MLP's entry: gate, up [B, S, I / tp] (2d) or [B, S, I]
        (row)."""
        if self.mlp == "2d":
            hh = self.comm.copy(h)
            return F.linear(hh, wg), F.linear(hh, wu)
        hs = self.comm.slice_reduce(h, -1)
        return (self.comm.reduce(F.linear(hs, wg)),
                self.comm.reduce(F.linear(hs, wu)))

    def act_down(self, gate, up, wd, act):
        """act(gate) * up -> the down projection, exit collective
        included."""
        m = act(gate) * up
        if self.mlp == "2d":
            return self.tx_reduce(F.linear(self.ty_gather_slice(m, -1),
                                           self.ty_gather_slice(wd, 1)))
        return self.comm.gather_slice(F.linear(self.comm.copy(m), wd), -1)

    def mlp_mm(self, h, wg, wu, wd, act):
        """The whole MLP after the entry norm (the JAX `mlp_mm` hook)."""
        return self.act_down(*self.gate_up(h, wg, wu), wd, act)


def strategy_for(cfg: Config, par) -> Optional[TPStrategy]:
    """The rank's TPStrategy (`par`, a `mesh.ParallelEnv` with tp > 1),
    or None when both pairs run megatron."""
    attn, mlp = pair_kinds(cfg)
    if attn == mlp == "megatron":
        return None
    comm = GroupComm(par.tp_group, par.tp_size, par.tp_rank)
    ty = tx = None
    if "2d" in (attn, mlp):
        tp_x, tp_y = resolved_tp_mesh(cfg)
        r = par.tp_rank
        if tp_y > 1:
            ty = GroupComm(par.tp_ty_group, tp_y, r % tp_y)
        if tp_x > 1:
            tx = GroupComm(par.tp_tx_group, tp_x, r // tp_y)
    return TPStrategy(attn, mlp, comm, ty, tx)


def tp_strategy_hooks(cfg: Config, tp) -> dict:
    """The JAX `tp_strategy_hooks`' overrides as the port installs them
    on a rank's `TPContext` (`tp`): the names of the JAX `ParallelCtx`
    hooks, each with the port's callable (the deferred set: `pre`, `f`,
    `g`, `embed_lookup`, `head_in`, `seq_shard` and the split head CE the
    pipeline would use, None as in JAX; a strategy: `qkv_mm`, `o_mm`,
    `mlp_mm` of the hooked pairs and `embed_lookup`); {} under megatron
    with the sync exit."""
    from picotron_tpu_torch.parallel.tp import vocab_parallel_embed

    if not uses_strategy_hooks(cfg):
        return {}

    def embed(w, ids):
        return vocab_parallel_embed(w, ids, tp)

    if cfg.distributed.tp_sync == "deferred":
        return dict(pre=tp.pre, f=tp.f, g=tp.g, embed_lookup=embed,
                    head_in=tp.head_in, seq_shard=tp.size,
                    head_ce_local=None, head_ce_merge=None)
    s = tp.strategy
    hooks = {}
    if s.hooked("attn"):
        hooks.update(qkv_mm=s.qkv_mm, o_mm=s.o_mm)
    if s.hooked("mlp"):
        hooks["mlp_mm"] = s.mlp_mm
    if hooks:
        hooks["embed_lookup"] = embed
    return hooks


def forward_collectives(cfg: Config) -> dict:
    """{kind: calls} over the tp groups of one dense forward of the whole
    model per rank: the layers' (`collectives_per_layer`), the
    embedding's exit (an all-reduce, or the sequence reduce-scatter when
    the stream is seq-sharded), the head's entry (the sequence all-gather
    then) and the vocab-parallel CE's two all-reduces (max, then the
    sums)."""
    d = cfg.distributed
    seq = d.sequence_parallel or d.tp_sync == "deferred"
    out = {k: v * cfg.model.num_hidden_layers
           for k, v in collectives_per_layer(cfg).items()}
    out["reduce_scatter" if seq else "all_reduce"] += 1
    if seq:
        out["all_gather"] += 1
    out["all_reduce"] += 2
    return out


def collectives_per_layer(cfg: Config) -> dict:
    """{kind: calls} the forward of one dense layer makes per rank under
    the config's tp schedule (the JAX docstring's promise; a group of
    one makes no call). The backward's are the transposes' (module
    docstring)."""
    attn, mlp = pair_kinds(cfg)
    out = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    tp_x, tp_y = (resolved_tp_mesh(cfg) if "2d" in (attn, mlp)
                  else (cfg.distributed.tp_size, 1))
    deferred = cfg.distributed.tp_sync == "deferred"
    seq = cfg.distributed.sequence_parallel or deferred
    for kind, n_entry in ((attn, 3), (mlp, 2)):
        if kind == "megatron" and seq:
            # SP's f (or the deferred pre) gathers, g reduce-scatters
            out["all_gather"] += 1
            out["reduce_scatter"] += 1
        elif kind == "megatron":
            out["all_reduce"] += 1
        elif kind == "2d":
            # the entry's gathers (q/k/v, or the activation) and the
            # weight's, then the tx exit sum
            if tp_y > 1:
                out["all_gather"] += (3 if n_entry == 3 else 1) + 1
            if tp_x > 1:
                out["all_reduce"] += 1
        else:
            out["all_reduce"] += n_entry
            out["all_gather"] += 1
    return out
