"""Pipeline parallelism: one walk of a schedule table per rank (port of
picotron_tpu/parallel/pp.py, and the executor half of
picotron_tpu/parallel/mpmd.py).

The JAX package has two executors: `spmd`, a lockstep `lax.scan` over
ticks with one `ppermute` each way per tick, and `mpmd`, per-stage
programs driven by a host-side table of `TickOp`s. In PyTorch one rank
per stage runs its own ops in order, so both are one thing here: a walk
of a table (`walk`), fed the spmd engines' tables (`engine_table`) or
the mpmd ones (`parallel/mpmd.build_schedule`).

- "1f1b" (`pp.py:305-340` there): forward of microbatch m at stage s on
  tick m + s, backward on tick m + 2(pp-1) - s; n + 2(pp-1) ticks
  (`pp_1f1b_ticks`).
- "afab": the forwards over n + pp - 1 ticks, then the backwards in
  reverse, as differentiating the JAX scan orders them.

The walk keeps each in-flight microbatch's autograd graph, under the
config's remat policy (`models/llama.remat_layer`), from its F to its B,
the original picotron's way (the JAX 1f1b recomputes the stage under
`jax.vjp` from a ring of saved inputs instead). Its B is
`torch.autograd.backward` on the stage output with the received
cotangent. Within a tick a rank runs a B whose F ran on an earlier tick
before its F, and a B of this tick's F after it: at stage 0, B of
microbatch m and F of m + 2(pp-1) share a tick, and the B going first
keeps the graphs in flight within `pp_1f1b_ring_slots` (the JAX tick
loads the backward input before the forward stores, `pp.py:336-341`
there); on the last stage B of m follows F of m on the same tick. After
each tick the rank posts, in one batch, every send and receive that the
table places at that boundary (`comm.PPComm.exchange`), both sides
derived from the same table, so that 1f1b's crossing activation and
cotangent cannot deadlock.

Each stage's graph is its own: the boundary tensors cross as detached
tensors, so a stage's backward never waits on another stage, and tp, SP
and cp collectives inside a stage run on all of its ranks in the same
order. Under sequence parallelism the boundary tensor is the rank's
sequence shard, exchanged with the same tp coordinate of the next stage
(`_boundary_axes`, `pp.py:97` there).

After the walk: the tied embedding's grads summed over the first and the
last stage (the only parameter two stages hold), the data-group seam
(`parallel/api.GradSync`, which also completes SP's partial norm grads
inside a stage: the JAX `sync_sp_partial_grads`), then the loss sum and
token count summed over the stages, so that every stage, and rank 0 (a
first-stage rank) that logs, holds them (the JAX psum over pp,
`pp.py:440-442` there). The JAX `sync_pp_replicated_grads` has nothing
left to do: every other replicated parameter lives on one stage. The
grad norm sums its squares over the stages
(`optimizer.layout_grad_norm`), so every stage clips, and takes the
guard's skip or apply decision, alike.

Mixture of experts (the JAX `stage_fn`'s contribution, `pp.py:209-220`
there): each stage adds its own layers' router loss as aux[0] * count
of the microbatch to its share of the NLL sum, which the sum over the
stages assembles, and its drop sum aux[1] * count rides the same sums.
A stage's B then differentiates its boundary output with the received
cotangent and its fold with 1. The port holds no pad layers, so the
JAX `layer_is_real` mask has nothing to mask.

The walk beats the watchdog with the live (stage, tick, op, mb) before
each op (`_run_schedule`, `mpmd.py:667-760` there). On a walk of an mpmd
table (`pipeline.executor == "mpmd"`) it then fires the `schedule_tick`
chaos point with the same coordinates, so `sigterm@S#T` or `hang@S~X#T`
lands mid-schedule; the spmd engines have no ticks in the JAX package
and their walks do not fire it. A SIGTERM mid-walk only sets the
preemption handler's flag, so the walk drains to the step boundary and a
checkpoint then holds whole steps only. With a span tracer installed
(telemetry/flightdeck, `logging.trace_dir`) each op is synced and
recorded as one span `stage{j}/tick{t}/{op}/mb{mb}` on the lane
`TID_PP_BASE + rank`: the sync is an opt-in perturbation of the traced
run, as in the JAX package, and the untraced walk adds none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from picotron_tpu_torch.models.llama import (
    compute_dtype, embed, head_sum_count, run_layers,
)
from picotron_tpu_torch.ops.losses import IGNORE_INDEX
from picotron_tpu_torch.optimizer import param_grads
from picotron_tpu_torch.parallel.api import (
    grad_seam, moe_extras, reduce_sum_count,
)
from picotron_tpu_torch.parallel.comm import PPComm
from picotron_tpu_torch.parallel.mpmd import (
    ScheduleBufferError, TickOp, build_schedule, check_stage_slice_placement,
    lint_schedule,
)
from picotron_tpu_torch.parallel.sharding import seq_sharded
from picotron_tpu_torch.resilience import chaos, watchdog
from picotron_tpu_torch.telemetry import bus as telemetry_bus
from picotron_tpu_torch.telemetry.flightdeck.tracer import TID_PP_BASE


def pp_1f1b_ticks(n_micro: int, pp: int) -> int:
    """Tick count of the 1F1B table: n_micro + 2(pp-1)."""
    return n_micro + 2 * (pp - 1)


def pp_1f1b_ring_slots(n_micro: int, pp: int) -> int:
    """The most graphs in flight on a 1F1B stage (the JAX boundary-input
    ring's size): min(n_micro, 2(pp-1)), at least 1."""
    return max(1, min(n_micro, 2 * (pp - 1)))


def _tick_order(ops: list) -> list:
    """Sorted by (tick, group); within one (tick, group) a B whose F ran
    on an earlier tick first, then the F, then a B of this tick's F."""
    f_tick = {(o.mb, o.vstage): o.tick for o in ops if o.op == "F"}

    def key(o):
        if o.op == "F":
            rank = 1
        else:
            rank = 2 if f_tick.get((o.mb, o.vstage)) == o.tick else 0
        return (o.tick, o.group, rank)

    return sorted(ops, key=key)


def engine_table(engine: str, n_micro: int, pp: int) -> list:
    """The spmd executor's engines as tables (virtual stage = stage):
    "1f1b" (F(m, s) at tick m + s, B at m + 2(pp-1) - s) or "afab" (the
    forwards over n + pp - 1 ticks, then the backwards in reverse)."""
    if engine not in ("1f1b", "afab"):
        raise ValueError(f"pp_engine must be '1f1b' or 'afab', got "
                         f"{engine!r}")
    ops = forward_table(n_micro, pp, pp)
    last = n_micro + pp - 2  # the last forward tick
    for m in range(n_micro):
        for s in range(pp):
            tick = (m + 2 * (pp - 1) - s if engine == "1f1b"
                    else last + 1 + last - (m + s))
            ops.append(TickOp(tick=tick, group=s, op="B", mb=m, vstage=s))
    ops = _tick_order(ops)
    problems = lint_schedule(ops, n_micro, pp,
                             kind="gpipe" if engine == "afab" else "1f1b")
    if problems:
        raise ScheduleBufferError("; ".join(problems))
    return ops


def forward_table(n_micro: int, pp: int, n_vstages: int) -> list:
    """The forwards alone over `n_vstages` virtual stages (j on rank
    j % pp): F(m, j) at tick m + j (the eval step's walk)."""
    return _tick_order([TickOp(tick=m + j, group=j % pp, op="F", mb=m,
                               vstage=j)
                        for m in range(n_micro) for j in range(n_vstages)])


def schedule_table(cfg) -> list:
    """The table of the config's executor: its pp_engine's under "spmd",
    else `pipeline.schedule`'s (`mpmd.build_schedule`, which lints it)."""
    d, pl = cfg.distributed, cfg.pipeline
    n = cfg.training.gradient_accumulation_steps
    if pl.executor == "spmd":
        return engine_table(d.pp_engine, n, d.pp_size)
    return _tick_order(build_schedule(pl.schedule, n, d.pp_size,
                                      pl.interleave))


@dataclass
class WalkStats:
    """What one rank's walk saw: the most graphs it held at once, the
    tick boundaries at which it sent or received (its exchanges), and on
    the last stage each microbatch's (NLL sum, token count)."""

    max_in_flight: int = 0
    exchanges: int = 0
    mb_losses: dict = field(default_factory=dict)


def _messages(table: list, pp: int) -> dict:
    """{tick: [(src group, dst group, buffer, vstage, mb)]}: the boundary
    tensors each op of the tick sends, in table order ("x" an activation
    into vstage, "g" a cotangent into vstage)."""
    V = max(o.vstage for o in table) + 1
    out: dict = {}
    for o in table:
        j = o.vstage
        if o.op == "F" and j < V - 1:
            out.setdefault(o.tick, []).append(
                (o.group, (j + 1) % pp, "x", j + 1, o.mb))
        elif o.op == "B" and j > 0:
            out.setdefault(o.tick, []).append(
                (o.group, (j - 1) % pp, "g", j - 1, o.mb))
    return out


def walk(table: list, index: int, stage, comm, step: Optional[int] = None,
         forward_only: bool = False, ticks: bool = False) -> WalkStats:
    """Rank `index`'s walk of `table` (ops in `_tick_order`, over
    `comm.size` pipeline ranks): its ops, tick by tick, each followed by
    one exchange of the tick's boundary tensors. `stage` runs the ops:
    `forward(vstage, mb, x)` -> (graph, y to send or None) and
    `backward(vstage, mb, graph, g)` -> the input's cotangent or None;
    `boundary()` -> (shape, dtype) of a boundary tensor. The walk keeps
    each graph from its F to its B (none when `forward_only`). `ticks`:
    fire the `schedule_tick` chaos point before each op (a walk of an
    mpmd table with a step number). Raises `ScheduleBufferError` naming
    the buffers the table left live."""
    tel = telemetry_bus.active()
    tracer = getattr(tel, "tracer", None) if tel is not None else None
    pp = comm.size
    stats = WalkStats()
    messages = _messages(table, pp)
    shape, dtype = stage.boundary()
    xbuf: dict = {}      # (vstage, mb) -> inbound activation
    gbuf: dict = {}      # (vstage, mb) -> inbound cotangent
    graphs: dict = {}    # (vstage, mb) -> the graph of its F
    mine: dict = {}
    for o in table:
        if o.group == index:
            mine.setdefault(o.tick, []).append(o)
    n_ticks = max(o.tick for o in table) + 1
    for t in range(n_ticks):
        outbox: dict = {}
        for o in mine.get(t, ()):
            j, mb = o.vstage, o.mb
            watchdog.touch(f"pp_schedule stage={j} tick={t} op={o.op} "
                           f"mb={mb}", step)
            if ticks and step is not None:
                chaos.fire("schedule_tick", step=step, tick=t, stage=j,
                           op=o.op, mb=mb)
            t0 = time.perf_counter() if tracer is not None else 0.0
            if o.op == "F":
                graph, y = stage.forward(j, mb, xbuf.pop((j, mb), None))
                if y is not None:
                    outbox[("x", j + 1, mb)] = y
                if not forward_only:
                    graphs[(j, mb)] = graph
                    stats.max_in_flight = max(stats.max_in_flight,
                                              len(graphs))
            elif o.op == "B":
                g = stage.backward(j, mb, graphs.pop((j, mb)),
                                   gbuf.pop((j, mb), None))
                if g is not None:
                    outbox[("g", j - 1, mb)] = g
            else:
                raise ValueError(f"op {o.op!r} has no walk op (the zb "
                                 f"split is a table only)")
            if tracer is not None:
                if torch.cuda.is_initialized():
                    # the span ends when the device does (tracer only)
                    torch.cuda.synchronize()  # shardcheck: ok
                tracer.complete(f"stage{j}/tick{t}/{o.op}/mb{mb}",
                                tid=TID_PP_BASE + index,
                                dur_s=time.perf_counter() - t0, stage=j,
                                tick=t, op=o.op, mb=mb, step=step)
        sends, recvs, keys = [], [], []
        for src, dst, buf, j, mb in messages.get(t, ()):
            if src == index:
                sends.append((dst, outbox[(buf, j, mb)]))
            elif dst == index:
                recvs.append((src, shape, dtype))
                keys.append((buf, j, mb))
        if sends or recvs:
            stats.exchanges += 1
        # one exchange per tick boundary: the table's order
        for (buf, j, mb), r in zip(keys, comm.exchange(  # shardcheck: ok
                sends, recvs)):
            (xbuf if buf == "x" else gbuf)[(j, mb)] = r
    leftover = ([f"activation (vstage={j}, mb={m})" for j, m in sorted(xbuf)]
                + [f"cotangent (vstage={j}, mb={m})" for j, m in sorted(gbuf)]
                + [f"saved graph (vstage={j}, mb={m})"
                   for j, m in sorted(graphs)])
    if leftover:
        raise ScheduleBufferError(
            f"pipeline rank {index}'s walk left {len(leftover)} live "
            f"boundary buffer(s) — the table dispatched ops that produced "
            f"tensors no later op consumed (a truncated or "
            f"dependency-broken table): {'; '.join(leftover)}")
    return stats


class StageRunner:
    """The ops of one rank's stage model (`models/llama.LlamaModel` built
    with its `Stage`) on one step's batch (ids, targets [n_micro, mbs,
    s]): virtual stage j runs `model.stage.chunks` in order. F of the
    first virtual stage embeds its microbatch, F of the last scores it
    (`head_sum_count`) and keeps the NLL sum and count; B runs
    `torch.autograd.backward` from the kept graph. For an MoE model every
    F adds its layers' router-loss fold to the NLL sum and their drop sum
    to `dropw`."""

    def __init__(self, model, batch, remat: Optional[str] = None,
                 ce_chunk_size: int = 0):
        self.model = model
        self.ids, self.tgt = batch
        self.remat = remat
        self.chunk = ce_chunk_size
        st = model.stage
        self.V = st.size * len(st.chunks)
        self.layers = {st.index + k * st.size: [model.layers.at(i)
                                                for i in c]
                       for k, c in enumerate(st.chunks)}
        dev = self.ids.device
        self.nll = torch.zeros((), dtype=torch.float32, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.dropw = torch.zeros((), dtype=torch.float32, device=dev)
        self.mb_losses: dict = {}

    def boundary(self) -> tuple:
        m = self.model
        s = self.ids.shape[-1]
        tp = m.tp
        if tp is not None and tp.seq_sharded:
            s //= tp.size
        return ((self.ids.shape[1], s, m.cfg.hidden_size),
                compute_dtype(m.cfg))

    def forward(self, j: int, mb: int, x):
        if j == 0:
            x_in = None
            x = embed(self.model, self.ids[mb])
        else:
            x_in = x.requires_grad_(torch.is_grad_enabled())
        y, aux = run_layers(self.model, x, self.remat, self.layers[j])
        fold = None
        if aux is not None:
            count = (self.tgt[mb] != IGNORE_INDEX).sum().float()
            fold = aux[0] * count
            self.dropw += aux[1].detach() * count
            self.nll += fold.detach()
        if j < self.V - 1:
            return (x_in, y, fold), y.detach()
        total, count = head_sum_count(self.model, y, self.tgt[mb],
                                      self.chunk)
        self.nll += total.detach()
        self.count += count
        self.mb_losses[mb] = (total.detach(), count)
        return (x_in, total if fold is None else total + fold, None), None

    def backward(self, j: int, mb: int, graph, g):
        x_in, out, fold = graph
        if j == self.V - 1:
            out.backward()
        elif fold is None:
            torch.autograd.backward(out, g)
        else:
            torch.autograd.backward([out, fold], [g, torch.ones_like(fold)])
        return None if x_in is None else x_in.grad


class PipelineGrads:
    """The pipeline's grad function: `(model, batch, grads=None, step=None,
    extras=None)` -> (mean loss, 1 / token count), the summed grads left
    in `grads` (as `train_step.accumulate_grads`; an MoE model's
    `moe_extras` in `extras`), on every stage. `par`: the rank's
    ParallelEnv (None in a thread world, where `comm` is given and there
    is no data group); `stats` is the last walk's `WalkStats`. `runner`
    makes each step's stage ops, as `StageRunner` does (a harness may
    pass a subclass that wraps them)."""

    def __init__(self, cfg, par=None, comm=None, table=None,
                 runner=StageRunner):
        t = cfg.training
        self.cfg = cfg
        self.comm = comm if comm is not None else PPComm(par)
        self.table = table if table is not None else schedule_table(cfg)
        # the schedule_tick chaos point fires on the mpmd tables' walks
        self.ticks = cfg.pipeline.executor == "mpmd"
        if self.ticks:
            # the JAX make_mpmd_train_step's guard of a pp slice cut
            check_stage_slice_placement(cfg)
        self.remat = t.remat_policy if t.remat else None
        self.runner = runner
        self.stats = WalkStats()
        self.seam = grad_seam(par, seq_sharded(cfg))

    def __call__(self, model, batch, grads: Optional[dict] = None,
                 step: Optional[int] = None, extras: Optional[dict] = None):
        grads = param_grads(model.parameters()) if grads is None else grads
        for buf in grads.values():
            buf.zero_()
        runner = self.runner(model, batch, self.remat,
                             self.cfg.training.ce_chunk_size)
        self.stats = walk(self.table, self.comm.index, runner, self.comm,
                          step, ticks=self.ticks)
        self.stats.mb_losses = runner.mb_losses
        st = model.stage
        if model.cfg.tie_word_embeddings and (st.first or st.last):
            self.comm.all_reduce(grads[model.embedding], ends=True)
        moe = bool(model.cfg.num_experts)
        nll, count = runner.nll, runner.count
        more = [runner.dropw] if moe else []
        sync = self.seam(model)
        if sync is not None:
            nll, count, *more = sync(grads, nll, count, *more)
        nll, count, *more = sum_over_stages(nll, count, self.comm, *more)
        count = count.clamp(min=1)
        if more and extras is not None:
            extras.update(moe_extras(more[0], count, model.cfg))
        return nll / count, torch.reciprocal(count.float())


def sum_over_stages(nll: torch.Tensor, count: torch.Tensor, comm,
                    *more: torch.Tensor):
    """(nll, count, *more) summed over the stages in one all-reduce (the
    count is nonzero on the last stage only)."""
    both = comm.all_reduce(torch.stack([nll.float(), count.float(),
                                        *(m.float() for m in more)]))
    return (both[0], both[1].round().to(count.dtype), *both[2:])


class PipelineEval:
    """The pipeline's eval step: `(model, batch)` -> token-mean loss, the
    forwards alone (the afab table's forward half) under no_grad, summed
    over the data group and the stages."""

    def __init__(self, cfg, par=None, comm=None):
        self.cfg = cfg
        self.par = par
        self.comm = comm if comm is not None else PPComm(par)
        pp = cfg.distributed.pp_size
        self.table = forward_table(cfg.training.gradient_accumulation_steps,
                                   pp, pp * cfg.pipeline.interleave)

    @torch.no_grad()
    def __call__(self, model, batch) -> torch.Tensor:
        runner = StageRunner(model, batch,
                             ce_chunk_size=self.cfg.training.ce_chunk_size)
        walk(self.table, self.comm.index, runner, self.comm,
             forward_only=True)
        nll, count = runner.nll, runner.count
        if self.par is not None:
            nll, count = reduce_sum_count(nll, count, self.par.data_group)
        nll, count = sum_over_stages(nll, count, self.comm)
        return nll / count.clamp(min=1)
