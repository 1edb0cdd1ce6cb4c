"""Fused-accumulation grad engine: a manual backward over the decoder
layers that adds each layer's weight grads straight into the fp32 grads
(port of picotron_tpu/parallel/fused_bwd.py, single device).

Why it exists: under gradient accumulation autograd gives every
microbatch a fresh grad per parameter, which `.grad` then adds in a second
whole-model fp32 pass, and each use of an fp32 master re-casts it to bf16.
Here the weight grads are taken inside the GEMM into `p.grad` (on CUDA
`torch.addmm(..., out_dtype=torch.float32, out=p.grad)`; on the CPU the
plain form, dW in the compute dtype then `add_(dW.float())`, which is the
JAX engine's and autograd's rounding point), and the matmuls read
`ComputeWeights`, bf16 copies of the masters refreshed once per step.

The forward runs under `torch.no_grad()` and keeps per layer what the
"dots_attn" remat policy keeps: the layer input x, q, k, v, the attention
out and its lse. The backward walks the layers in reverse: it recomputes
the o-projection and the MLP, takes the norm and activation transposes
from `torch.autograd.grad` over the recomputed elementwise pieces (the
counterpart of the JAX engine's segment `jax.vjp`s, so activation
functions cannot diverge from the AD engine), the dX products as explicit
matmuls against the compute weights, and reaches attention only through
`flash_attention_bwd_from_saved` (the dq and dk/dv kernels; the forward
kernel runs once per layer, never again in the backward). Embedding,
final-norm, head, norm and bias grads are added as the JAX engine adds
its non-layer leaves.

The accumulators are the optimizer's fp32 grad buffers (`grads`,
{param: buffer}: the params' .grad, or under optimizer_offload, whose
params are the bf16 compute copy, buffers of their own), left undivided:
the 1 / token count rides to the update. Over bf16 params
`ComputeWeights` are the params themselves, with no second copy.

Under tp (the model's `TPContext`) the forward runs the model's hooks (f
before the column-parallel products, g after the row-parallel ones, the
vocab-parallel lookup and CE), and the manual backward takes their
transposes: the grad of a g output through `g_transpose` (identity;
under sequence parallelism an all-gather of the sequence) before the
row-parallel dX and dW products, and the partial dX of the
column-parallel products through `f_transpose` (an all-reduce; under SP
a reduce-scatter) before the norm's transpose. The residual stream and
the saved layer inputs stay seq-sharded under SP, the saved q/k/v/out
are this rank's heads over the whole sequence, as under the AD engine.
The accumulators are reduced over the data group once, at the seam
(`parallel/api.GradSync`, the `reduce` argument).

Under context parallelism (the model's `CPContext`) the attention is the
context's schedule from the saved statistics (`CPContext.attention`,
the JAX `_attn_paths`' cp branches): the ring's and the mesh's globally
merged (row-domain for the mesh) lse, or Ulysses' inner-domain lse, saved
by the forward and consumed by the schedule's `*_bwd_from_saved`, so the
forward kernel never re-runs. Ring and mesh rotate q and k before the
schedule; the rotation's transpose is taken by autograd over the
rotation, as for the plain "reference" attention. The residual stream,
the saved layer inputs and q/k/v/out are the rank's cp slice of the
sequence; every other transpose is per token.

MoE (the JAX engine's MoE branch, `fused_bwd.py:292-417` there): the
forward runs `models/llama._moe_block` and sums its aux over the layers;
the loss folds in aux[0] * count as `loss_sum_count` does. In the
backward the block is one segment over `post_norm` and the four MoE
weights (router, w_gate, w_up, w_down), recomputed from the recomputed
a = x + o-proj (routing bit for bit: `ops/moe.py`'s recompute contract)
and differentiated by `torch.autograd.grad` with the cotangents (dy,
1.0 on the fold aux[0] * count), so the router loss's grads flow as the
AD engine's do, through the block's own f/g, ep exchanges and
statistics' mean. Its weight grads come from the fp32 masters' casts,
as under the AD engine; `ComputeWeights` holds the attention matmuls and
the head for an MoE layer.

The tp strategies (`parallel/tp_strategies.py`; the JAX engine's
segment VJPs over the same hooks, `fused_bwd.py:113-122, 313-330,
374-408` there): the forward runs the strategy's hooks on the compute
weights, and the backward takes each hook's transpose explicitly, with
the raw collectives (so that every rank calls its own, as a thread
world's ranks must):

- the deferred sync: the megatron half with f's transpose the identity
  and g's an all-gather of the sequence, and `pre`'s transpose (a
  reduce-scatter of the sequence) after each norm's;
- 2d: the subgroup gathers' transpose is the own slice (of the head
  block's dq/dk/dv, of the gathered weight's grad, of the activation's),
  the tx sum's the identity, f's the all-reduce over tp; the o
  transpose reads the weight rows gathered over ty again. An MLP pair
  under 2d needs no collective beyond f's: its own slices are the
  megatron products;
- row-first: the feature slab's transpose is the all-gather of the slab
  grads (zero padding plus the all-reduce, in one), the entry sums' the
  identity, the exit gather's the own slice, and the column-parallel
  o/down input's the all-reduce over tp.

The head enters through `TPContext.head_in` outside autograd, and its
transpose (`head_in_transpose`) follows the CE's grad: nothing of the
backward runs autograd through a collective whose transpose
communicates.

Eligibility is the JAX package's (`fused_bwd_supported`: one pipeline
stage under remat "dots_attn"); every branch of it is ported: flash
(`attn_impl` "auto"/"flash"), the plain "reference" attention and the
three cp schedules (ring, Ulysses, mesh), over dp, cp, ep, MoE,
Megatron tp with or without SP, the deferred sync and the 2d and
row-first strategies.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from picotron_tpu_torch.config import Config
from picotron_tpu_torch.models.llama import (
    LlamaModel, _entry, _exit, _hooked, _moe_block, _pre, compute_dtype,
    embed, mlp_act,
)
from picotron_tpu_torch.ops.attention import (
    sdpa_attention, sdpa_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_from_saved,
)
from picotron_tpu_torch.ops.losses import (
    chunked_cross_entropy_sum_count, cross_entropy_sum_count,
)
from picotron_tpu_torch.ops.rmsnorm import rms_norm
from picotron_tpu_torch.ops.rope import apply_rope
from picotron_tpu_torch.optimizer import param_grads
from picotron_tpu_torch.parallel.api import finish_grads
from picotron_tpu_torch.parallel.comm import own_slice
from picotron_tpu_torch.parallel.tp import (
    vocab_parallel_ce_sum_count, vocab_parallel_embed_grad,
)

_MATMULS = ("q", "k", "v", "o", "gate", "up", "down")
_ATTN = ("q", "k", "v", "o")
_MOE = ("post_norm", "router", "w_gate", "w_up", "w_down")


def fused_bwd_supported(cfg: Config) -> bool:
    """The JAX package's eligibility: one pipeline stage under remat with
    the "dots_attn" policy, whose save set the manual backward is derived
    from."""
    d, t = cfg.distributed, cfg.training
    return (d.pp_size == 1
            and t.remat and t.remat_policy == "dots_attn")


class ComputeWeights:
    """The matmul weights in the compute dtype, read by the engine: one
    copy per layer weight and the head, refreshed from the fp32 masters by
    one `torch._foreach_copy_` at the start of every step (so a restore or
    a rollback cannot leave them stale; a cast is deterministic, so this
    equals casting at each use bit for bit). Where the params already are
    in the compute dtype (fp32 compute, or the bf16 compute copy of
    optimizer_offload) they are the params themselves, with no refresh."""

    def __init__(self, model: LlamaModel):
        self.model = model
        dt = compute_dtype(model.cfg)
        self.names = _ATTN if model.cfg.num_experts else _MATMULS
        self.masters = [getattr(lp, name).detach() for lp in model.layers
                        for name in self.names]
        self.masters.append(model.head_weight().detach())
        self.copies = (self.masters if all(p.dtype == dt for p in self.masters)
                       else [torch.empty_like(p, dtype=dt)
                             for p in self.masters])

    def refresh(self) -> None:
        if self.copies is not self.masters:
            torch._foreach_copy_(self.copies, self.masters)

    def layer(self, i: int) -> dict:
        n = len(self.names)
        return dict(zip(self.names, self.copies[i * n:(i + 1) * n]))

    @property
    def head(self) -> torch.Tensor:
        return self.copies[-1]


def accumulate_weight_grad(acc: torch.Tensor, dy: torch.Tensor,
                           x: torch.Tensor, plain: bool = False) -> None:
    """acc [out, in] fp32 += dy^T x over the flattened leading dims. CUDA
    takes the product into acc inside the GEMM (fp32 accumulation, no
    rounding of dW); the CPU (or `plain=True`) computes dW in the compute
    dtype and adds it in fp32. Any other device raises."""
    dy2 = dy.reshape(-1, dy.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    if acc.is_cuda and not plain:
        if x2.dtype == acc.dtype:
            acc.addmm_(dy2.t(), x2)
        else:
            torch.addmm(acc, dy2.t(), x2, out_dtype=acc.dtype, out=acc)
    elif acc.is_cuda or acc.device.type == "cpu":
        acc.add_((dy2.t() @ x2).to(acc.dtype))
    else:
        raise RuntimeError(f"fused grad engine: no path for {acc.device}")


def _attn_paths(model: LlamaModel):
    """(attn_fwd, attn_bwd) for the model's attention impl:
    attn_fwd(q, k, v) -> (out, lse), q/k unrotated [B, S, H, D];
    attn_bwd(q, k, v, out, lse, dout) -> (dq, dk, dv) in the same
    domains."""
    cfg = model.cfg
    rope = (model.rope_cos, model.rope_sin)
    if model.cp is not None:
        pre, fwd, bwd = model.cp.attention(cfg.attn_impl, rope)
        if pre is None:
            return fwd, bwd
        return (lambda q, k, v: fwd(*pre(q, k), v),
                _through_pre(pre, bwd))
    if cfg.attn_impl in ("auto", "flash"):
        def attn_fwd(q, k, v):
            return flash_attention(q, k, v, causal=True, rope=rope,
                                   return_lse=True)

        def attn_bwd(q, k, v, out, lse, dout):
            return flash_attention_bwd_from_saved(q, k, v, out, lse, dout,
                                                  causal=True, rope=rope)

        return attn_fwd, attn_bwd

    def rotated(q, k):
        return apply_rope(q, *rope), apply_rope(k, *rope)

    def attn_fwd(q, k, v):
        qr, kr = rotated(q, k)
        return sdpa_attention(qr, kr, v, causal=True, return_lse=True)

    return attn_fwd, _through_pre(rotated, partial(
        sdpa_attention_bwd_from_saved, causal=True))


def _through_pre(pre, bwd):
    """attn_bwd over unrotated q/k of `bwd`, which takes q/k as `pre`
    makes them: the rotation's transpose by autograd over the rotation."""
    def attn_bwd(q, k, v, out, lse, dout):
        with torch.enable_grad():
            q_, k_ = q.detach().requires_grad_(), k.detach().requires_grad_()
            qr, kr = pre(q_, k_)
        dqr, dkr, dv = bwd(qr.detach(), kr.detach(), v, out, lse, dout)
        dq, dk = torch.autograd.grad((qr, kr), (q_, k_), (dqr, dkr))
        return dq, dk, dv

    return attn_bwd


def _entry_t(dh, lp):
    return dh if lp.tp is None else lp.tp.f_transpose(dh)


def _exit_t(dy, lp):
    return dy if lp.tp is None else lp.tp.g_transpose(dy)


def _pre_t(dx, lp):
    return dx if lp.tp is None else lp.tp.pre_transpose(dx)


def _kind(lp, pair: str) -> str:
    """The layer's kind of `pair` ("megatron", "2d", "row")."""
    return getattr(lp.tp.strategy, pair) if _hooked(lp.tp, pair) \
        else "megatron"


def _ty_slice(t, lp):
    """The own slice of a ty-gathered feature block (2d; the whole of it
    over a ty group of one)."""
    ty = lp.tp.strategy.ty
    return t if ty is None else own_slice(t, -1, ty.size, ty.index)


def _tp_slice(t, lp):
    """The rank's 1/tp slice of the features (row-first)."""
    c = lp.tp.strategy.comm
    return own_slice(t, -1, c.size, c.index)


def _qkv_fwd(h, lp, w, d):
    """q/k/v of the norm output h, through f or the strategy's hook."""
    if _hooked(lp.tp, "attn"):
        return lp.tp.strategy.qkv_mm(h, w["q"], w["k"], w["v"], d)
    return _qkv(_entry(h, lp), lp, w, d)


def _o_fwd(outf, lp, w):
    """The o-projection with the block exit."""
    if _hooked(lp.tp, "attn"):
        return lp.tp.strategy.o_mm(outf, w["o"])
    return _exit(F.linear(outf, w["o"]), lp)


def _qkv(h, lp, w, d):
    """q/k/v of the (already entered) h."""
    b, s, _ = h.shape
    q, k, v = F.linear(h, w["q"]), F.linear(h, w["k"]), F.linear(h, w["v"])
    if lp.b_q is not None:
        q = q + lp.b_q.to(h.dtype)
        k = k + lp.b_k.to(h.dtype)
        v = v + lp.b_v.to(h.dtype)
    return (q.reshape(b, s, -1, d), k.reshape(b, s, -1, d),
            v.reshape(b, s, -1, d))


def _flat(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def _with_grad(t):
    return t.detach().requires_grad_()


@torch.no_grad()
def forward_saved(model: LlamaModel, weights: ComputeWeights,
                  ids: torch.Tensor, attn_fwd=None,
                  aux: Optional[list] = None):
    """The engine's forward through the compute weights: (the last layer's
    output, per layer (x, q, k, v, out, lse), the "dots_attn" set). For
    an MoE model the aux [2] summed over the layers is appended to `aux`
    (a list, when given)."""
    cfg = model.cfg
    eps, hd, act = cfg.rms_norm_eps, cfg.head_dim, mlp_act(cfg)
    attn_fwd = attn_fwd or _attn_paths(model)[0]
    saved = []
    aux_sum = None
    x = embed(model, ids)
    for i, lp in enumerate(model.layers):
        w = weights.layer(i)
        q, k, v = _qkv_fwd(rms_norm(_pre(x, lp), lp.input_norm, eps), lp, w,
                           hd)
        out, lse = attn_fwd(q, k, v)
        a = x + _o_fwd(_flat(out), lp, w)
        saved.append((x, q, k, v, out, lse))
        if lp.moe:
            mo, a_l = _moe_block(a, lp, cfg)
            aux_sum = a_l if aux_sum is None else aux_sum + a_l
            x = a + mo
            continue
        h = rms_norm(_pre(a, lp), lp.post_norm, eps)
        if _hooked(lp.tp, "mlp"):
            s = lp.tp.strategy
            x = a + s.act_down(*s.gate_up(h, w["gate"], w["up"]), w["down"],
                               act)
            continue
        h = _entry(h, lp)
        m = act(F.linear(h, w["gate"])) * F.linear(h, w["up"])
        x = a + _exit(F.linear(m, w["down"]), lp)
    if aux is not None and aux_sum is not None:
        aux.append(aux_sum)
    return x, saved


def _norm_grads(x, norm, lp, eps):
    """(x's `pre` output under autograd, its norm output): the leaf and
    the graph a norm's transpose is taken over."""
    with torch.no_grad():
        xin = _pre(x, lp)
    with torch.enable_grad():
        x_ = _with_grad(xin)
        return x_, rms_norm(x_, norm, eps)


def _mlp_grads(a, dy, lp, w, cfg, acc, plain):
    """The dense MLP half, y = a + down(act(gate) * up) with gate/up from
    norm(pre(a)): adds its weight and norm grads into `acc` and returns
    d a (the residual's dy included)."""
    a_, h2 = _norm_grads(a, lp.post_norm, lp, cfg.rms_norm_eps)
    # 2d takes the megatron products: the tx sum's transpose is the
    # identity, and its ty gathers' the own slices, which are this rank's
    # own activation and weight columns
    row = _kind(lp, "mlp") == "row"
    with torch.no_grad():
        if row:
            h2d = _tp_slice(h2.detach(), lp)
            comm = lp.tp.strategy.comm
            gate0 = comm.all_reduce(F.linear(h2d, w["gate"]))
            up0 = comm.all_reduce(F.linear(h2d, w["up"]))
        else:
            h2d = _entry(h2.detach(), lp)
            gate0, up0 = F.linear(h2d, w["gate"]), F.linear(h2d, w["up"])
    with torch.enable_grad():
        gate, up = _with_grad(gate0), _with_grad(up0)
        m = mlp_act(cfg)(gate) * up
    if row:
        # the exit gather's transpose is the own slice; the column
        # product's input grad sums over tp
        dyg = _tp_slice(dy, lp)
        dm = comm.all_reduce(dyg @ w["down"])
    else:
        dyg = _exit_t(dy, lp)
        dm = dyg @ w["down"]
    accumulate_weight_grad(acc[lp.down], dyg, m.detach(), plain)
    d_gate, d_up = torch.autograd.grad(m, (gate, up), dm)
    # sums in autograd's order (the later consumer's grad first), so
    # the bf16 roundings are the AD engine's
    dh2 = d_up @ w["up"] + d_gate @ w["gate"]
    dh2 = comm.all_gather(dh2, -1) if row else _entry_t(dh2, lp)
    accumulate_weight_grad(acc[lp.gate], d_gate, h2d, plain)
    accumulate_weight_grad(acc[lp.up], d_up, h2d, plain)
    da, d_post = torch.autograd.grad(h2, (a_, lp.post_norm), dh2)
    acc[lp.post_norm].add_(d_post)
    return dy + _pre_t(da, lp)


def _moe_segment_grads(a, dy, count_f, lp, cfg, acc):
    """The MoE half as one segment: `_moe_block` recomputed from a under
    autograd, differentiated with cotangent dy on its output and 1 on
    its router loss's fold aux[0] * count; adds the grads of post_norm
    and the MoE weights into `acc` and returns the block's d a (without
    the residual's dy)."""
    ws = [getattr(lp, name) for name in _MOE]
    with torch.enable_grad():
        a_ = _with_grad(a)
        mo, aux = _moe_block(a_, lp, cfg)
        fold = aux[0] * count_f
    da, *dws = torch.autograd.grad((mo, fold), (a_, *ws),
                                   (dy, torch.ones_like(fold)))
    for p, g in zip(ws, dws):
        acc[p].add_(g.to(acc[p].dtype))
    return da


def fused_micro_grads(model: LlamaModel, weights: ComputeWeights,
                      ids: torch.Tensor, tgt: torch.Tensor, acc: dict,
                      ce_chunk_size: int = 0, plain: bool = False,
                      extras: Optional[dict] = None):
    """One microbatch: adds its NLL-sum grads into every param's fp32
    accumulator `acc[p]` and returns (nll_sum, valid_count); for an MoE
    model the NLL sum holds the router loss's fold and `extras` (when
    given) gains the token-weighted drop sum, "moe_drop_weighted", as
    `loss_sum_count`'s. `plain=True` takes the weight grads by the plain
    form on CUDA too (the comparison of the two forms on the card; never
    the main path)."""
    cfg = model.cfg
    eps = cfg.rms_norm_eps
    attn_fwd, attn_bwd = _attn_paths(model)
    auxes: list = []
    x, saved = forward_saved(model, weights, ids, attn_fwd, auxes)
    aux_sum = auxes[0] if auxes else None

    # ---------------- head + CE ----------------
    head = model.head_weight()
    tp = model.tp
    with torch.enable_grad():
        x_l, head_w = _with_grad(x), _with_grad(weights.head)
        h = rms_norm(x_l, model.final_norm, eps)
    if tp is not None:
        # the head's entry outside autograd, its transpose by hand
        with torch.no_grad():
            hin = tp.head_in_raw(h.detach())
        with torch.enable_grad():
            hin = _with_grad(hin)
            total, count = vocab_parallel_ce_sum_count(hin, head_w, tgt, tp,
                                                       ce_chunk_size)
        dhin, d_head = torch.autograd.grad(total, (hin, head_w))
        dy, d_final = torch.autograd.grad(
            h, (x_l, model.final_norm), tp.head_in_transpose(dhin))
    else:
        with torch.enable_grad():
            if ce_chunk_size:
                total, count = chunked_cross_entropy_sum_count(
                    h, head_w, tgt, ce_chunk_size)
            else:
                total, count = cross_entropy_sum_count(F.linear(h, head_w),
                                                       tgt)
        dy, d_final, d_head = torch.autograd.grad(
            total, (x_l, model.final_norm, head_w))
    acc[model.final_norm].add_(d_final)
    acc[head].add_(d_head.to(acc[head].dtype))
    total = total.detach()
    if aux_sum is not None:
        # the loss_sum_count fold: the reported total is nll + aux * count,
        # and each layer's segment takes cotangent 1 on its aux * count
        count_f = count.float()
        total = total + aux_sum[0] * count_f
        if extras is not None:
            extras["moe_drop_weighted"] = aux_sum[1] * count_f

    # ---------------- backward, layer by layer in reverse ----------------
    for i in reversed(range(len(model.layers))):
        lp, w = model.layers[i], weights.layer(i)
        x, q, k, v, out, lse = saved.pop()
        kind = _kind(lp, "attn")
        with torch.no_grad():
            outf = _flat(out)
            a = x + _o_fwd(outf, lp, w)
        if lp.moe:
            da = dy + _moe_segment_grads(a, dy, count_f, lp, cfg, acc)
        else:
            da = _mlp_grads(a, dy, lp, w, cfg, acc, plain)
        # o-projection, then attention from the saved (out, lse)
        if kind == "2d":
            # the tx sum's transpose is the identity; the weight rows
            # gathered over ty again, the weight grad's own slice
            s = lp.tp.strategy
            wo = w["o"] if s.ty is None else s.ty.all_gather(w["o"], 1)
            dout = (da @ wo).reshape(out.shape)
            accumulate_weight_grad(acc[lp.o], da, _ty_slice(outf, lp), plain)
        elif kind == "row":
            dag = _tp_slice(da, lp)
            dout = lp.tp.strategy.comm.all_reduce(
                dag @ w["o"]).reshape(out.shape)
            accumulate_weight_grad(acc[lp.o], dag, outf, plain)
        else:
            dag = _exit_t(da, lp)
            dout = (dag @ w["o"]).reshape(out.shape)
            accumulate_weight_grad(acc[lp.o], dag, outf, plain)
        dq, dk, dv = attn_bwd(q, k, v, out, lse, dout)
        dq, dk, dv = _flat(dq), _flat(dk), _flat(dv)
        # qkv half: q/k/v = norm(pre(x)) @ W (+ b)
        x_, h1 = _norm_grads(x, lp.input_norm, lp, eps)
        if kind == "2d":
            # the ty gathers' transpose: the own slice, after which the
            # products are megatron's
            dq, dk, dv = (_ty_slice(t, lp) for t in (dq, dk, dv))
        with torch.no_grad():
            h1d = (_tp_slice(h1.detach(), lp) if kind == "row" else
                   _entry(h1.detach(), lp))
        dh1 = dv @ w["v"] + dk @ w["k"] + dq @ w["q"]
        dh1 = (lp.tp.strategy.comm.all_gather(dh1, -1) if kind == "row"
               else _entry_t(dh1, lp))
        for name, g in (("q", dq), ("k", dk), ("v", dv)):
            accumulate_weight_grad(acc[getattr(lp, name)], g, h1d, plain)
            bias = getattr(lp, "b_" + name)
            if bias is not None:
                acc[bias].add_(g.sum(dim=(0, 1)).to(acc[bias].dtype))
        dx, d_in = torch.autograd.grad(h1, (x_, lp.input_norm), dh1)
        acc[lp.input_norm].add_(d_in)
        dy = da + _pre_t(dx, lp)
        del x, q, k, v, out, lse

    # ---------------- embedding ----------------
    emb = acc[model.embedding]
    if model.tp is not None:
        vocab_parallel_embed_grad(emb, ids, dy, model.tp)
    else:
        emb.index_put_((ids,), dy.to(emb.dtype), accumulate=True)
    return total.detach(), count


def fused_accumulate_grads(model: LlamaModel, weights: ComputeWeights,
                           batch, ce_chunk_size: int = 0,
                           plain: bool = False, grads: Optional[dict] = None,
                           reduce=None, extras: Optional[dict] = None):
    """The fused engine's counterpart of `train_step.accumulate_grads`:
    zeroes the fp32 accumulators `grads` ({param: buffer}; the params'
    .grad when None), sums the microbatches' NLL-sum grads into them,
    passes the layout's seam (`reduce`, a `GradSync`) and returns (mean
    loss, 1 / token count); an MoE model's `moe_extras` go into `extras`.
    `weights` must have been refreshed for this step."""
    ids, tgt = batch
    grads = param_grads(model.parameters()) if grads is None else grads
    for buf in grads.values():
        buf.zero_()
    nll_total = torch.zeros((), dtype=torch.float32, device=ids.device)
    count = torch.zeros((), dtype=torch.int64, device=ids.device)
    more = ([torch.zeros((), dtype=torch.float32, device=ids.device)]
            if model.cfg.num_experts else [])
    for i in range(ids.shape[0]):
        ex: dict = {}
        total, c = fused_micro_grads(model, weights, ids[i], tgt[i], grads,
                                     ce_chunk_size, plain, ex)
        nll_total += total
        count += c
        if more:
            more[0] += ex["moe_drop_weighted"]
    return finish_grads(model.cfg, grads, nll_total, count, more, reduce,
                        extras)
