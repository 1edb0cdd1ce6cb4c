"""Llama-family decoder-only model as an `nn.Module` (port of
picotron_tpu/models/llama.py).

Embedding -> N x (RMSNorm -> qkv (+ optional Qwen2 bias) -> attention with
RoPE -> o-proj -> residual -> RMSNorm -> gated MLP -> residual) -> final
RMSNorm -> untied or tied LM head. The functions below keep the JAX names
(`embed`, `qkv_proj`, `_attention_block`, `_mlp_block`, `decoder_layer`,
`final_hidden`, `logits_from_hidden`, `forward`, `loss_sum_count`).

Params are fp32 masters and are cast to the compute dtype where used (the
JAX `.astype(dt)`), so autograd gives fp32 grads. Under optimizer_offload
they are the bf16 compute copy (the master lives in the optimizer), the
casts do nothing and the grads are bf16, as in the JAX package. Matmul weights use the
PyTorch [out_features, in_features] layout (`F.linear`); `weights.py`
converts to and from the JAX [in, out] stacked-layer pytree.

Tensor parallelism (port of the tp/SP hooks of `ParallelCtx` /
`make_parallel_ctx`): a model built with a `parallel.tp.TPContext` holds
this rank's shards (`parallel/sharding.py`: Hq/tp q heads and Hkv/tp kv
heads, I/tp ffn columns, V/tp vocab rows) and calls the context's hooks
where the JAX model calls ctx.f / ctx.g: f at the entry of qkv_proj and
_gate_up (column-parallel), g at the exit of _o_proj and _act_down
(row-parallel), the vocab-parallel lookup in `embed` and the
vocab-parallel CE in `loss_sum_count`. Under sequence parallelism the
residual stream between them is [B, S/tp, H]. Without a context (tp 1)
the model is the single-device one, op for op.

The tp strategies and the deferred sync (port of the JAX `ParallelCtx`
hooks `pre`, `qkv_mm`, `o_mm`, `mlp_mm` and `head_in`;
`parallel/tp_strategies.py`): the context's `pre` runs on each block's
input before its norm (the deferred sync's hoisted gather; identity
otherwise), a hooked attention pair (2d or row-first) replaces
`qkv_proj`'s matmuls and `_o_proj` with the strategy's `qkv_mm` and
`o_mm`, a hooked MLP pair replaces `_gate_up` and `_act_down` with its
`gate_up` and `act_down` (the JAX `mlp_mm` split at the activation, so
that every remat policy cuts it where it cuts the megatron MLP), and
the head enters through `head_in`. Under "row" a pair's weights are
stored with the other dim sharded (q/k/v/gate/up [out, in/tp], o/down
[out/tp, in]). With no strategy and the sync exit, the block is the one
above, op for op.

Mixture of experts (port of the JAX `_moe_block`, :401-425 there): with
`num_experts` > 0 each layer's MLP is `ops/moe.moe_mlp` over the router
[H, E] and the expert banks w_gate/w_up [E_local, H, F/tp] and w_down
[E_local, F/tp, H] (the JAX [in, out] layout; E_local = E/ep under an
`parallel.ep.EPContext`, whose communicators carry the ep all-to-all and
the router statistics' mean over the data group). The block enters
through f and leaves through g like the dense MLP (the banks' ffn dim is
sharded over tp). An MoE layer returns (x, aux [2]): the pre-weighted
router loss and the capacity drop fraction; `run_layers` sums them over
the layers and `loss_sum_count` folds `aux[0] * count` into the NLL sum
(so the token mean is CE + router loss) and returns the token-weighted
drop sum as extras["moe_drop_weighted"]. Under tp the router loss,
computed alike on every tp rank, enters the loss through
`TPContext.replicated` (its grad split over tp), so that the router's
grads are partial over tp, as the expert path's are, and the step sums
them over tp (`parallel/sharding.tp_partial`).

Context parallelism (port of `make_parallel_ctx`'s cp positions and
attention dispatch, picotron_tpu/parallel/api.py:61-170): a model built
with a `parallel.cp.CPContext` reads its cp index's slice of the
(permuted) sequence, [B, S/cp], and runs attention through the
context's schedule (`CPContext.attention`): ring and mesh rotate q and k
at the rank's global positions before the schedule (the blocks travel
pre-rotated), Ulysses rotates inside the flash kernels at the gathered
positions, and the schedule's autograd node (`ScheduleFunction`) runs its
backward from the saved (out, lse). Everything else is per token and
needs no change; the grads, the NLL sum and the count are summed over
the data group, which spans cp (`parallel/api.GradSync`). Without a
context (cp 1) the positions stay None: the static-causal path, op for
op the model without context parallelism. Under sequence parallelism
the residual stream is [B, S/(cp tp), H] and f gathers the cp-local
sequence.

Pipeline stages (port of `pp_layer_placement` and the stage slicing of
the JAX package's `parallel/pp.py` and `parallel/mpmd.py`): a model built
with a `Stage` holds one pipeline rank's share, as the original picotron
does: its decoder layers, named by their global layer index (so that a
stage's state dict says which layers it holds), the embedding on the
first stage only, the final norm and the head on the last (a tied
embedding on both ends, whose grads `parallel/pp.py` sums). Stage k of pp
holds the contiguous L // pp layers, plus one on the first L % pp stages
(`pp_layer_placement`'s rule); the JAX package pads its stacked layers
with identity layers under an uneven split, the port holds no pad layers.
Under the interleaved schedule a rank holds `interleave` chunks, virtual
stage j on rank j % pp (`stage_layers`). The walk of `parallel/pp.py`
runs a stage's pieces: `embed`, `run_layers` over a chunk, and
`head_sum_count`, which scores only on the last stage: every tp rank of a
stage takes the same branch, so tp/SP collectives inside it are safe
(the JAX `lax.cond` constraint, `parallel/pp.py:104-137` there, does not
arise).

Remat (port of `remat_policy_for` / `run_layers` under `ctx.remat`): each
policy cuts the layer into `torch.utils.checkpoint` segments (non-reentrant)
so that what one layer keeps for its backward is the JAX policy's saved
set. The flash kernels are bound through ctypes, out of the dispatcher's
sight, so no op-level selective policy can name their outputs: the
attention core stays outside the segments (its autograd node saves q, k, v,
out and lse) except under "full". A segment keeps its inputs; a matmul
outside a segment keeps its input. Per layer ("q" is the kernel's
sm_scale-folded q, the others the named JAX tensors; x is the layer input):

    policy       saved per layer                               count
    (no remat)   everything autograd saves                     -
    full         x                                             1
    dots_attn    x, q, k, v, attn_out, attn_lse                6
    dots_lean    + mlp_gate, mlp_up                            8
    dots         + attn_proj_out                               9
    dots_norms   + norm_out (input norm and post norm)         11
    MoE layers:
    full         x                                             1
    dots_attn,   x, q, k, v, attn_out, attn_lse                6
     dots_lean
    dots         + attn_proj_out, router logits                8
    dots_norms   + norm_out (input norm and post norm)         10

Everything else is recomputed in the backward: the norms, the residual
sum, the activation, the tp collectives inside a segment, and under
"dots_attn" the o-projection and the MLP's gate/up products ("full"
re-runs the whole layer, the forward kernel included). Autograd saves a
matmul's input before it multiplies, and a segment's recompute stops
once its last saved tensor is rebuilt, so the matmuls a segment
recomputes are those before its last one: two of q/k/v under every
policy but "full" and "dots_norms", and mlp_gate under "dots" and
"dots_lean" (JAX recomputes none of these; the saved sets are equal).
The MoE block's expert products have a batch dim (the expert), so no
JAX policy saves them ("dots" saves only dots without batch dims, the
router product among them; "dots_lean" names mlp_gate/mlp_up, which the
MoE block does not produce): under every policy the dispatch, the
experts and the combine are recomputed in the backward from the block's
input, and the routing with them, bit for bit (`ops/moe.py`'s recompute
contract). Under "dots" and "dots_norms" the router logits are saved (a
segment makes them, the next reads them); "dots" recomputes the post
norm in both segments, so under tp the block's f runs twice there.
"dots_offload" keeps "dots"' saved set (both tables) with every saved
activation parked in pinned host memory between the passes and the lse
on the device (`models/act_offload.py`): the same segments under a
saved-tensor hook pair, so its numbers are "dots"' bit for bit. Under
tp the saved q/k/v/out are this rank's heads; under sequence
parallelism x (and "dots"' attn_proj_out) is the seq shard, and
"dots_norms" keeps the gathered norm output that the column-parallel
products read (autograd saves a matmul's input).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from picotron_tpu_torch.config import ModelConfig
from picotron_tpu_torch.models.act_offload import ActivationParker, parker_of
from picotron_tpu_torch.ops.attention import sdpa_attention
from picotron_tpu_torch.ops.flash_attention import flash_attention
from picotron_tpu_torch.ops.losses import (
    chunked_cross_entropy_sum_count, cross_entropy_sum_count,
)
from picotron_tpu_torch.ops.moe import moe_mlp
from picotron_tpu_torch.ops.rmsnorm import rms_norm
from picotron_tpu_torch.ops.ring_attention import ScheduleFunction
from picotron_tpu_torch.ops.rope import apply_rope, rope_tables
from picotron_tpu_torch.parallel.cp import CPContext
from picotron_tpu_torch.parallel.ep import EPContext
from picotron_tpu_torch.parallel.tp import (
    TPContext, gather_logits, vocab_parallel_embed,
)


def model_rope_tables(cfg: ModelConfig, max_len=None, device=None):
    """RoPE tables for a model config, honouring cfg.rope_scaling."""
    return rope_tables(max_len or cfg.max_position_embeddings, cfg.head_dim,
                       cfg.rope_theta, rope_scaling=cfg.rope_scaling_dict,
                       device=device)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """Activation/compute dtype (params stay fp32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ModelConfig,
                    cp: Optional[CPContext] = None) -> None:
    """Raise for a context-parallel schedule without its cp context (the
    JAX `make_parallel_ctx`'s check)."""
    if cfg.attn_impl in ("ring", "ulysses", "mesh") and cp is None:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} is a context-parallel schedule: "
            "it needs cp_size > 1 and the model built with its cp context "
            "(parallel.cp.cp_context)")


def mlp_act(cfg: ModelConfig):
    """SwiGLU (silu), exact-erf GeGLU ("gelu") or tanh GeGLU ("gelu_tanh")."""
    if cfg.hidden_act == "silu":
        return F.silu
    approx = "tanh" if cfg.hidden_act == "gelu_tanh" else "none"
    return lambda x: F.gelu(x, approximate=approx)


def _tp_size(tp: Optional[TPContext]) -> int:
    return 1 if tp is None else tp.size


def _hooked(tp: Optional[TPContext], pair: str) -> bool:
    """The tp strategy replaces the matmuls of `pair` ("attn", "mlp")."""
    return tp is not None and tp.strategy is not None and \
        tp.strategy.hooked(pair)


def _row(tp: Optional[TPContext], pair: str) -> bool:
    return _hooked(tp, pair) and getattr(tp.strategy, pair) == "row"


def pp_layer_placement(num_layers: int, pp: int):
    """(padded size, slots): the JAX package's stacked layer axis, padded
    to pp * ceil(L / pp), and each real layer's slot in it (stage k's
    L // pp layers, plus one on the first L % pp stages, fill the leading
    slots of its ceil(L / pp)); port of the JAX function of this name."""
    per = -(-num_layers // pp)
    counts = [num_layers // pp + (1 if k < num_layers % pp else 0)
              for k in range(pp)]
    slots = [s for k in range(pp) for s in range(k * per, k * per + counts[k])]
    return per * pp, slots


def stage_layers(num_layers: int, pp: int, interleave: int = 1) -> list:
    """The global layer indices of each virtual stage j < pp * interleave
    (run by pipeline rank j % pp): the real layers among the padded
    slots [j * n, (j + 1) * n) with n = padded / (pp * interleave), as
    the JAX package's `_stage_blocks` cuts its padded stack. At
    interleave 1, stage k's contiguous layers."""
    padded, slots = pp_layer_placement(num_layers, pp)
    chunks = pp * interleave
    if padded % chunks:
        raise ValueError(f"interleave {interleave} does not divide the "
                         f"per-stage slot count {padded // pp} (pp {pp})")
    n = padded // chunks
    return [[i for i, s in enumerate(slots) if j * n <= s < (j + 1) * n]
            for j in range(chunks)]


@dataclass(frozen=True)
class Stage:
    """Pipeline rank `index` of `size`: its virtual stages' layers
    (`chunks`, one list of global layer indices per virtual stage j =
    index + k * size), whether it holds the embedding (`first`) and the
    final norm and head (`last`)."""

    index: int
    size: int
    chunks: tuple

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.size - 1

    @property
    def layers(self) -> list:
        return sorted(i for c in self.chunks for i in c)


def pipeline_stage(num_layers: int, pp: int, index: int,
                   interleave: int = 1) -> Stage:
    """Rank `index`'s Stage of a pp-stage pipeline."""
    blocks = stage_layers(num_layers, pp, interleave)
    return Stage(index=index, size=pp,
                 chunks=tuple(tuple(b) for b in blocks[index::pp]))


class LayerStack(nn.ModuleList):
    """The decoder layers a model holds, in order, each registered under
    its global layer index (so "layers.5.q" is layer 5 on whichever stage
    holds it); indexing and iteration are by position."""

    def __init__(self, layers: dict):
        super().__init__()
        for i, lp in layers.items():
            self.add_module(str(i), lp)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]

    def at(self, layer: int) -> nn.Module:
        """The layer of global index `layer`."""
        return self._modules[str(layer)]


class DecoderLayer(nn.Module):
    """One decoder layer's parameters ([out, in] matmul weights; the MoE
    router and banks in the JAX [in, out] layout): this tp rank's shards
    under a tp context (`tp`, kept on the layer for the hooks, as the cp
    context `cp` for the attention and the ep context `ep` for the MoE
    block), its E/ep experts under expert parallelism."""

    def __init__(self, cfg: ModelConfig, device=None,
                 tp: Optional[TPContext] = None,
                 cp: Optional[CPContext] = None,
                 ep: Optional[EPContext] = None):
        super().__init__()
        n = _tp_size(tp)
        h, d = cfg.hidden_size, cfg.head_dim
        # a "row" pair shards its input features (q/k/v, gate/up) and
        # the o/down outputs; otherwise the output features (q/k/v,
        # gate/up) and the o/down inputs
        ra, rm = _row(tp, "attn"), _row(tp, "mlp")
        ha, hm = (h // n if ra else h), (h // n if rm else h)
        q_out = cfg.num_attention_heads // (1 if ra else n) * d
        kv_out = cfg.num_key_value_heads // (1 if ra else n) * d
        i = cfg.intermediate_size // (1 if rm else n)
        self.tp = tp
        self.cp = cp
        self.ep = ep
        self.moe = bool(cfg.num_experts)

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device,
                                            dtype=torch.float32))

        self.input_norm = p(h)
        self.q, self.k, self.v = p(q_out, ha), p(kv_out, ha), p(kv_out, ha)
        self.o = p(ha, q_out)
        self.post_norm = p(h)
        if cfg.attention_bias:
            self.b_q, self.b_k, self.b_v = p(q_out), p(kv_out), p(kv_out)
        else:
            self.b_q = self.b_k = self.b_v = None
        if self.moe:
            e = cfg.num_experts
            e_local = e // (1 if ep is None else ep.size)
            f = cfg.expert_ffn_size // n
            self.router = p(h, e)
            self.w_gate, self.w_up = p(e_local, h, f), p(e_local, h, f)
            self.w_down = p(e_local, f, h)
        else:
            self.gate, self.up = p(i, hm), p(i, hm)
            self.down = p(hm, i)


class LlamaModel(nn.Module):
    """The model, whole, or this rank's tp shards of it under a tp context
    (`tp`; None: one device), reading its cp slice of the sequence under
    a cp context (`cp`; None: cp 1), holding its E/ep experts and
    exchanging slots and averaging router statistics under an ep context
    (`ep`; None: as one device), holding one pipeline rank's share under
    a `stage` (None: every layer, the embedding and the head). A part the
    stage does not hold is None."""

    def __init__(self, cfg: ModelConfig, device=None,
                 tp: Optional[TPContext] = None,
                 cp: Optional[CPContext] = None,
                 stage: Optional[Stage] = None,
                 ep: Optional[EPContext] = None):
        super().__init__()
        check_supported(cfg, cp)
        self.cfg = cfg
        self.tp = tp
        self.cp = cp
        self.ep = ep
        self.stage = stage
        first = stage is None or stage.first
        last = stage is None or stage.last
        layers = (range(cfg.num_hidden_layers) if stage is None
                  else stage.layers)
        h, v = cfg.hidden_size, cfg.vocab_size // _tp_size(tp)

        def p(*shape):
            return nn.Parameter(torch.empty(*shape, device=device))

        tied = cfg.tie_word_embeddings
        self.embedding = p(v, h) if first or (last and tied) else None
        self.layers = LayerStack(
            {i: DecoderLayer(cfg, device, tp, cp, ep) for i in layers})
        self.final_norm = p(h) if last else None
        self.lm_head = p(v, h) if last and not tied else None
        cos, sin = model_rope_tables(cfg, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def head_weight(self) -> torch.Tensor:
        """[V, H]: the separate lm_head, or the tied embedding."""
        return self.lm_head if self.lm_head is not None else self.embedding

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return forward(self, input_ids)


@torch.no_grad()
def init_params(model: LlamaModel, generator: torch.Generator,
                embedding_generator: Optional[torch.Generator] = None,
                bank_generator: Optional[torch.Generator] = None
                ) -> LlamaModel:
    """Initialise in place with the JAX package's distributions: linear
    weights ~ U(+-sqrt(1/fan_in)), embedding ~ N(0, 1), norms = 1, biases
    = 0. The numbers differ from jax.random's; tests transplant weights
    with `weights.params_from_jax` instead of re-initialising. Under tp
    each rank draws its own shards (the caller seeds `generator` per tp
    rank, so that the shards differ); a pipeline stage draws only the
    parts it holds (the caller seeds it per stage as well). The embedding
    is drawn from `embedding_generator` when given: a tied embedding's
    two copies, on the first and the last stage, must draw alike. The
    MoE banks are drawn from `bank_generator` when given (under ep each
    rank's experts are its own, where every other tensor draws alike)."""

    n = _tp_size(model.tp)
    cfg = model.cfg
    # each linear's whole fan-in, whichever dim its tp shard splits
    fan_ins = {"o": cfg.num_attention_heads * cfg.head_dim,
               "down": cfg.intermediate_size}

    def uniform(w, fan_in, gen=None):
        bound = (1.0 / fan_in) ** 0.5
        w.uniform_(-bound, bound, generator=gen or generator)

    if model.embedding is not None:
        model.embedding.normal_(0.0, 1.0,
                                generator=embedding_generator or generator)
    for lp in model.layers:
        names = ("q", "k", "v", "o") + (() if lp.moe else
                                        ("gate", "up", "down"))
        for name in names:
            uniform(getattr(lp, name), fan_ins.get(name, cfg.hidden_size))
        if lp.moe:
            uniform(lp.router, lp.router.shape[0])
            for name in ("w_gate", "w_up", "w_down"):
                w = getattr(lp, name)
                uniform(w, w.shape[1] * (n if name == "w_down" else 1),
                        bank_generator)
        lp.input_norm.fill_(1.0)
        lp.post_norm.fill_(1.0)
        for b in (lp.b_q, lp.b_k, lp.b_v):
            if b is not None:
                b.zero_()
    if model.final_norm is not None:
        model.final_norm.fill_(1.0)
    if model.lm_head is not None:
        uniform(model.lm_head, model.lm_head.shape[1])
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def embed(model: LlamaModel, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding -> [B, S, H] in compute dtype (under tp the
    vocab-parallel lookup; [B, S/tp, H] under SP)."""
    if model.tp is not None:
        x = vocab_parallel_embed(model.embedding, input_ids, model.tp)
    else:
        x = model.embedding[input_ids]
    return x.to(compute_dtype(model.cfg))


def _entry(h: torch.Tensor, lp: DecoderLayer) -> torch.Tensor:
    """The column-parallel entry (tp's f; identity without tp)."""
    return h if lp.tp is None else lp.tp.f(h)


def _exit(y: torch.Tensor, lp: DecoderLayer) -> torch.Tensor:
    """The row-parallel exit (tp's g; identity without tp)."""
    return y if lp.tp is None else lp.tp.g(y)


def _pre(x: torch.Tensor, lp: DecoderLayer) -> torch.Tensor:
    """The block entry before the norm (the deferred sync's sequence
    gather; identity otherwise)."""
    return x if lp.tp is None else lp.tp.pre(x)


def qkv_proj(h: torch.Tensor, lp: DecoderLayer, d: int):
    """q/k/v projections (+ optional bias) -> [B,S,Hq,D], [B,S,Hkv,D] x2
    (this rank's heads under tp; h enters through f, or through the tp
    strategy's `qkv_mm`)."""
    if _hooked(lp.tp, "attn"):
        dt = h.dtype
        return lp.tp.strategy.qkv_mm(h, lp.q.to(dt), lp.k.to(dt),
                                     lp.v.to(dt), d)
    h = _entry(h, lp)
    dt = h.dtype
    b, s, _ = h.shape
    q = F.linear(h, lp.q.to(dt))
    k = F.linear(h, lp.k.to(dt))
    v = F.linear(h, lp.v.to(dt))
    if lp.b_q is not None:
        q = q + lp.b_q.to(dt)
        k = k + lp.b_k.to(dt)
        v = v + lp.b_v.to(dt)
    return (q.reshape(b, s, -1, d), k.reshape(b, s, -1, d),
            v.reshape(b, s, -1, d))


def _attention(q, k, v, cfg: ModelConfig, rope,
               cp: Optional[CPContext] = None):
    """The attention impl: under a cp context (`cp`) its schedule
    (pre-rotation, then the schedule's autograd node); else by
    cfg.attn_impl: "auto"/"flash" -> the flash kernels with RoPE fused and
    positions None (static causal); "reference" -> apply_rope +
    sdpa_attention."""
    if cp is not None:
        pre, fwd, bwd = cp.attention(cfg.attn_impl, rope)
        if pre is not None:
            q, k = pre(q, k)
        return ScheduleFunction.apply(q, k, v, fwd, bwd)
    if cfg.attn_impl in ("auto", "flash"):
        return flash_attention(q, k, v, causal=True, rope=rope)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)
    return sdpa_attention(q, k, v, causal=True)


def _attention_block(x, lp: DecoderLayer, cfg: ModelConfig, rope):
    """RMSNorm -> qkv -> attention (RoPE inside) -> o-proj."""
    q, k, v = _qkv_block(x, lp, cfg)
    return _o_proj(_attention(q, k, v, cfg, rope, lp.cp), lp)


def _qkv_block(x, lp: DecoderLayer, cfg: ModelConfig):
    h = rms_norm(_pre(x, lp), lp.input_norm, cfg.rms_norm_eps)
    return qkv_proj(h, lp, cfg.head_dim)


def _o_proj(out, lp: DecoderLayer):
    """[B, S, Hq, D] attention output -> o-projection [B, S, H]."""
    b, s = out.shape[:2]
    if _hooked(lp.tp, "attn"):
        return lp.tp.strategy.o_mm(out.reshape(b, s, -1),
                                   lp.o.to(out.dtype))
    return _exit(F.linear(out.reshape(b, s, -1), lp.o.to(out.dtype)), lp)


def _gate_up(h, lp: DecoderLayer):
    dt = h.dtype
    if _hooked(lp.tp, "mlp"):
        return lp.tp.strategy.gate_up(h, lp.gate.to(dt), lp.up.to(dt))
    h = _entry(h, lp)
    return F.linear(h, lp.gate.to(dt)), F.linear(h, lp.up.to(dt))


def _act_down(gate, up, lp: DecoderLayer, cfg: ModelConfig):
    if _hooked(lp.tp, "mlp"):
        return lp.tp.strategy.act_down(gate, up, lp.down.to(gate.dtype),
                                       mlp_act(cfg))
    return _exit(F.linear(mlp_act(cfg)(gate) * up, lp.down.to(gate.dtype)),
                 lp)


def _post_norm(x, lp: DecoderLayer, cfg: ModelConfig):
    """The MLP's entry norm, after `pre`."""
    return rms_norm(_pre(x, lp), lp.post_norm, cfg.rms_norm_eps)


def _mlp_block(x, lp: DecoderLayer, cfg: ModelConfig):
    """RMSNorm -> gated MLP."""
    return _act_down(*_gate_up(_post_norm(x, lp, cfg), lp), lp, cfg)


def _moe_entry(x, lp: DecoderLayer, cfg: ModelConfig):
    """RMSNorm -> the column-parallel entry: the MoE block's tokens."""
    return _entry(_post_norm(x, lp, cfg), lp)


def router_logits(h, lp: DecoderLayer) -> torch.Tensor:
    """[N, E] fp32 router logits of the entered tokens h [B, S, H]."""
    return h.reshape(-1, h.shape[-1]).float() @ lp.router.float()


def _moe_tokens(h, lp: DecoderLayer, cfg: ModelConfig, logits=None):
    """The MoE block over entered tokens h (routing from `logits` when
    given) -> (out through the row-parallel exit, aux [2])."""
    ep = lp.ep
    out, aux, drop = moe_mlp(
        h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
        num_experts=cfg.num_experts, top_k=cfg.num_experts_per_token,
        capacity_factor=cfg.capacity_factor, act=mlp_act(cfg),
        ep=None if ep is None else ep.comm,
        router_aux_coef=cfg.router_aux_coef,
        router_z_coef=cfg.router_z_coef,
        stats=None if ep is None else ep.stats, logits=logits)
    if lp.tp is not None:
        aux = lp.tp.replicated(aux)
    return _exit(out, lp), torch.stack([aux, drop])


def _moe_block(x, lp: DecoderLayer, cfg: ModelConfig):
    """RMSNorm -> top-k routed expert bank -> (out, aux [2]): the
    pre-weighted router loss and the capacity drop fraction."""
    return _moe_tokens(_moe_entry(x, lp, cfg), lp, cfg)


def decoder_layer(x, lp: DecoderLayer, cfg: ModelConfig, rope):
    """The layer over x: x, and for an MoE layer (x, aux [2])."""
    x = x + _attention_block(x, lp, cfg, rope)
    if lp.moe:
        mo, aux = _moe_block(x, lp, cfg)
        return x + mo, aux
    return x + _mlp_block(x, lp, cfg)


# the remat segments: each returns what crosses its boundary


def _after_attention(x, out, lp, cfg):
    """o-proj -> residual -> MLP (or MoE) -> residual ("dots_attn")."""
    a = x + _o_proj(out, lp)
    if lp.moe:
        mo, aux = _moe_block(a, lp, cfg)
        return a + mo, aux
    return a + _mlp_block(a, lp, cfg)


def _res_router(x, o, lp, cfg):
    return router_logits(_moe_entry(x + o, lp, cfg), lp)


def _res_moe(x, o, logits, lp, cfg):
    a = x + o
    mo, aux = _moe_tokens(_moe_entry(a, lp, cfg), lp, cfg, logits)
    return a + mo, aux


def _res_norm(x, o, lp, cfg):
    a = x + o
    return a, _post_norm(a, lp, cfg)


def _res_norm_gate_up(x, o, lp, cfg):
    a, h = _res_norm(x, o, lp, cfg)
    return (a, *_gate_up(h, lp))


def _o_res_norm_gate_up(x, out, lp, cfg):
    return _res_norm_gate_up(x, _o_proj(out, lp), lp, cfg)


def _segment(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def remat_layer(x, lp: DecoderLayer, cfg: ModelConfig, rope, policy: str,
                parker: Optional[ActivationParker] = None):
    """`decoder_layer` with `policy`'s saved set (module docstring);
    "dots_offload" parks "dots"' saved set through `parker`, the model's
    (`run_layers` passes `act_offload.parker_of(model)`, whose pinned pool
    outlives the call)."""
    if policy == "dots_offload":
        if parker is None:
            raise ValueError('remat_policy "dots_offload" needs the '
                             "model's ActivationParker (act_offload."
                             "parker_of)")
        with parker.layer():
            return remat_layer(x, lp, cfg, rope, "dots", parker)
    if policy == "full":
        return _segment(decoder_layer, x, lp, cfg, rope)
    if policy == "dots_norms":
        h = _segment(rms_norm, _pre(x, lp), lp.input_norm, cfg.rms_norm_eps)
        q, k, v = qkv_proj(h, lp, cfg.head_dim)
    else:
        q, k, v = _segment(_qkv_block, x, lp, cfg)
    with parker.keep_lse() if parker is not None else nullcontext():
        out = _attention(q, k, v, cfg, rope, lp.cp)
    if policy == "dots_attn" or (lp.moe and policy == "dots_lean"):
        return _segment(_after_attention, x, out, lp, cfg)
    if lp.moe and policy == "dots":
        o = _segment(_o_proj, out, lp)
        logits = _segment(_res_router, x, o, lp, cfg)
        return _segment(_res_moe, x, o, logits, lp, cfg)
    if lp.moe and policy == "dots_norms":
        o = _segment(_o_proj, out, lp)
        a, h = _segment(_res_norm, x, o, lp, cfg)
        h = _entry(h, lp)
        logits = _segment(router_logits, h, lp)
        mo, aux = _segment(_moe_tokens, h, lp, cfg, logits)
        return a + mo, aux
    if policy == "dots_lean":
        a, gate, up = _segment(_o_res_norm_gate_up, x, out, lp, cfg)
    elif policy == "dots":
        o = _segment(_o_proj, out, lp)
        a, gate, up = _segment(_res_norm_gate_up, x, o, lp, cfg)
    elif policy == "dots_norms":
        o = _segment(_o_proj, out, lp)
        a, h = _segment(_res_norm, x, o, lp, cfg)
        gate, up = _gate_up(h, lp)
    else:
        raise ValueError(f"unknown remat_policy {policy!r}")
    return a + _segment(_act_down, gate, up, lp, cfg)


def run_layers(model: LlamaModel, x: torch.Tensor,
               remat: Optional[str] = None, layers=None):
    """The decoder layers over x (`layers`, the modules of one pipeline
    chunk; default every layer the model holds); `remat` is a remat
    policy name, or None for none. Returns (x, aux): for an MoE model
    aux [2] summed over the layers (the pre-weighted router loss, the
    drop fraction), else None."""
    rope = (model.rope_cos, model.rope_sin)
    aux = None
    parker = (parker_of(model, x.device) if remat == "dots_offload"
              else None)
    with parker.forward() if parker is not None else nullcontext():
        for lp in (model.layers if layers is None else layers):
            if remat is None:
                x = decoder_layer(x, lp, model.cfg, rope)
            else:
                x = remat_layer(x, lp, model.cfg, rope, remat, parker)
            if lp.moe:
                x, a = x
                aux = a if aux is None else aux + a
    return x, aux


def final_hidden(model: LlamaModel, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, model.final_norm, model.cfg.rms_norm_eps)


def logits_from_hidden(model: LlamaModel, x: torch.Tensor) -> torch.Tensor:
    """Full-vocab logits; under tp the sharded head's, gathered (eval)."""
    if model.tp is None:
        return F.linear(x, model.head_weight().to(x.dtype))
    x = model.tp.head_in(x)
    return gather_logits(F.linear(x, model.head_weight().to(x.dtype)),
                         model.tp)


def forward(model: LlamaModel, input_ids: torch.Tensor) -> torch.Tensor:
    """input_ids [B, S] -> logits [B, S, V]."""
    x, _ = run_layers(model, embed(model, input_ids))
    return logits_from_hidden(model, final_hidden(model, x))


def loss_sum_count(model: LlamaModel, input_ids: torch.Tensor,
                   targets: torch.Tensor, remat: Optional[str] = None,
                   ce_chunk_size: int = 0):
    """(sum of per-token NLL, valid-token count, extras) — the reduction
    pieces, summed over microbatches before one division. For an MoE
    model the router loss is folded in as NLL sum + aux * count, so the
    token mean is CE + router loss, and extras is {"moe_drop_weighted":
    drop fraction summed over the layers * count}; {} for dense models.
    `remat`: a remat policy name or None; `ce_chunk_size` > 0 streams the
    head's CE over vocab chunks (training.ce_chunk_size). Under tp both
    are the vocab-parallel CE's, the same on every tp rank."""
    x, aux = run_layers(model, embed(model, input_ids), remat)
    total, count = head_sum_count(model, x, targets, ce_chunk_size)
    if aux is None:
        return total, count, {}
    return (total + aux[0] * count, count,
            {"moe_drop_weighted": aux[1].detach() * count})


def head_sum_count(model: LlamaModel, x: torch.Tensor,
                   targets: torch.Tensor, ce_chunk_size: int = 0):
    """(sum of per-token NLL, valid-token count) of the last layer's
    output x: the final norm, then the head's CE (vocab-parallel under
    tp, in vocab chunks with `ce_chunk_size`)."""
    x = final_hidden(model, x)
    if model.tp is not None:
        total, count = model.tp.head_ce(x, model.head_weight(), targets,
                                        ce_chunk_size)
    elif ce_chunk_size:
        total, count = chunked_cross_entropy_sum_count(
            x, model.head_weight(), targets, ce_chunk_size)
    else:
        total, count = cross_entropy_sum_count(logits_from_hidden(model, x),
                                               targets)
    return total, count


def loss_fn(model: LlamaModel, input_ids: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy."""
    total, count, _ = loss_sum_count(model, input_ids, targets)
    return total / count.clamp(min=1)
